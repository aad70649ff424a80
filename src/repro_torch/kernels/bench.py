"""Per-kernel microbenchmarks through the public ``ops`` entry points —
the port's twin of ``benchmarks/kernels_bench.py``: block GEMM, flash
attention, RMSNorm and trsm, each beside its oracle in ``ref``.

    PYTHONPATH=src python -m repro_torch.kernels.bench

Runs on the card, each call timed between synchronizes; ``run(...,
device="cpu")`` runs the plain versions on the host instead, and its
numbers are host timings of PyTorch's CPU kernels, not of the card.
Prints one ``name,us_per_call,derived`` row per kernel."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import resolve_device
from . import ops, ref

__all__ = ["run"]


def _timed(fn, dev, reps: int = 3) -> float:
    """Mean seconds per call after one warm-up call."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def _row(rows, name, sec, derived):
    rows.append({"name": name, "us_per_call": sec * 1e6,
                 "derived": derived})
    print(f"{name},{sec * 1e6:.1f},{derived}", flush=True)


def run(full: bool = False, device="cuda", check=None):
    """The four kernels at the sizes of ``benchmarks/kernels_bench.py``
    (``s`` = 512 with ``full``, else 256), f32; returns the rows. With
    ``check``, each op's output is also handed to ``check(name, out,
    plain)`` beside its plain version's on the same inputs."""
    dev = resolve_device(device)

    def held(name, out, plain):
        if check is not None:
            check(name, out, plain())
    rng = np.random.default_rng(0)
    s = 512 if full else 256

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    rows = []
    a, b = t(rng.standard_normal((s, s))), t(rng.standard_normal((s, s)))
    held("block_gemm", ops.block_gemm(a, b), lambda: ref.gemm_ref(a, b))
    dt = _timed(lambda: ops.block_gemm(a, b), dev)
    dtr = _timed(lambda: ref.gemm_ref(a, b), dev)
    _row(rows, "kernel/block_gemm", dt, f"ref_us={dtr * 1e6:.0f} n={s}")

    q = t(rng.standard_normal((1, s, 4, 64)))
    held("flash_attention", ops.flash_attention(q, q, q),
         lambda: ref.flash_attention_ref(q, q, q))
    dt = _timed(lambda: ops.flash_attention(q, q, q), dev)
    dtr = _timed(lambda: ref.flash_attention_ref(q, q, q), dev)
    _row(rows, "kernel/flash_attention", dt, f"ref_us={dtr * 1e6:.0f} s={s}")

    x = t(rng.standard_normal((s, 1024)))
    sc = torch.ones(1024, device=dev)
    held("rmsnorm", ops.rmsnorm(x, sc), lambda: ref.rmsnorm_ref(x, sc))
    dt = _timed(lambda: ops.rmsnorm(x, sc), dev)
    _row(rows, "kernel/rmsnorm", dt, f"rows={s}")

    u = t(np.triu(rng.standard_normal((64, 64))) + 4 * np.eye(64))
    bm = t(rng.standard_normal((s, 64)))
    held("trsm", ops.trsm(bm, u), lambda: ref.trsm_ref(bm, u))
    dt = _timed(lambda: ops.trsm(bm, u), dev)
    _row(rows, "kernel/trsm", dt, f"m={s} k=64")
    return rows


if __name__ == "__main__":
    run(full=True)
