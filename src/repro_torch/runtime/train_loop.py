"""Fault-tolerant training loop — the port of
``repro/runtime/train_loop.py``.

* checkpoint/restart — async sharded checkpoints every ``ckpt_every``
  steps and at the last; ``resume=True`` picks up the latest COMMITTED
  step (the data pipeline is counter-based, so resume is exact: it is
  fast-forwarded to that step).
* failure handling — a step that raises ``RuntimeError`` (CUDA errors
  and ``torch.OutOfMemoryError`` are ``RuntimeError``\\ s) is retried from
  the last checkpoint up to ``max_restarts`` times. AdamW updates the
  parameters and moments in place, so a step that raised may have left
  them half updated: with no checkpoint yet the error is raised (the JAX
  loop retries on its untouched arrays).
* straggler accounting — per-step wall-time EWMA; steps slower than
  ``straggler_factor``× the EWMA are logged and counted.

A step is timed from before the call to after the card has finished it
(``torch.cuda.synchronize`` on the loss's device): an unsynchronised host
clock would time the launches, not the step."""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from ..checkpoint import CheckpointManager

__all__ = ["TrainLoopConfig", "run_train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None      # None: a fresh temporary directory
    log_every: int = 10
    max_restarts: int = 3
    straggler_factor: float = 2.0
    resume: bool = True


def _finish(loss) -> float:
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    return float(loss)


def run_train_loop(step_fn: Callable, params, opt_state,
                   batches: Iterable, loop_cfg: TrainLoopConfig,
                   to_device: Callable = lambda b: b,
                   log: Callable = print) -> Dict[str, Any]:
    """Drive ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, loss, metrics)`` with checkpoint/restart and straggler
    accounting. Returns the final state and the run's metrics
    (``step_s``: each completed step's seconds)."""
    mgr = CheckpointManager(loop_cfg.ckpt_dir
                            or tempfile.mkdtemp(prefix="repro_ckpt_"))
    start = 0
    if loop_cfg.resume:
        latest = mgr.latest_step()
        if latest is not None:
            params, opt_state = mgr.restore(latest, (params, opt_state))
            start = latest
            log(f"[train] resumed from step {latest}")

    ewma = None
    stragglers = 0
    restarts = 0
    losses, step_s = [], []
    it = iter(batches)
    # fast-forward the deterministic pipeline on resume
    for _ in range(start):
        next(it)

    step = start
    while step < loop_cfg.total_steps:
        batch = to_device(next(it))
        t0 = time.perf_counter()
        try:
            params, opt_state, loss, metrics = step_fn(
                params, opt_state, batch, step)
            loss = _finish(loss)
        except RuntimeError as e:
            restarts += 1
            mgr.wait()
            latest = mgr.latest_step()
            if restarts > loop_cfg.max_restarts or latest is None:
                raise
            log(f"[train] step {step} failed ({e!r}); restart #{restarts} "
                f"from checkpoint {latest}")
            params, opt_state = mgr.restore(latest, (params, opt_state))
            step = latest
            it = iter(batches)
            for _ in range(step):
                next(it)
            continue

        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > loop_cfg.straggler_factor * ewma and step > start + 3:
            stragglers += 1
            log(f"[train] straggler step {step}: {dt:.2f}s vs EWMA "
                f"{ewma:.2f}s")
        losses.append(loss)
        step_s.append(dt)
        step += 1
        if step % loop_cfg.log_every == 0:
            log(f"[train] step {step} loss {loss:.4f} "
                f"({dt * 1e3:.0f} ms/step)")
        if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.total_steps:
            mgr.save(step, (params, opt_state))

    mgr.wait()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "stragglers": stragglers, "restarts": restarts,
            "final_step": step, "step_s": step_s}
