"""Run one cell: set-up, the measured window, the check, the metrics.

Set-up makes each value set's matrix from the seed, analyzes its
structure (``PSelInvEngine.analyze``), prepares its values on the host
(``engine.prepare_values``), and runs the first solve, which captures
the shape class's CUDA graph, and two more. The window then drives
``engine.solve`` on those prepared values through the cell's driver,
each call timed from dispatch to its synchronised output. A lane l of a
batched call solves 2^l·A: its values are the prepared set's with D⁻¹
scaled by 2^-l, bit for bit what ``prepare_values(2^l·A)`` gives, and
its inverse is A⁻¹·2^-l.

The loop holds one output at a time, as a closed-loop client does: a
call's output is dropped before the next call. The check keeps two: the
last call's, on the card, and that of one call drawn from the seed
before the window, copied to the host as it comes with the window's
clock stopped, so that neither the copy's time nor its memory is the
port's. Once the window has closed and the peak memory is read, the
port's state is freed and the check compares both, every lane, with the
dense inverse (:mod:`.reference`).
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import random
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import matrices, peaks, reference, structure
from .cells import Bench
from .trace import TraceSummary, read_trace

__all__ = ["Run", "run_cell", "result", "GAP_CHECK"]

#: the one number the check compares, with the limit from the config
GAP_CHECK = "rel_gap"
WINDOW = "bench.window"


@dataclass
class Run:
    """What one run measured; the metric readers read it. Times in
    seconds by the host's clock; ``nan`` or ``None`` where not
    measured."""
    cell: str
    workload: dict
    config: dict
    traced: bool
    device_kind: str
    lanes: int
    setup_s: float = math.nan
    analyze_s: float = math.nan
    prepare_s: float = math.nan
    first_solve_s: float = math.nan
    matrices_s: float = math.nan
    call_s: List[float] = field(default_factory=list)
    dispatch_s: List[float] = field(default_factory=list)
    #: the calls [first, last) inside the profiled window; the calls
    #: before ``profile_start`` ran with no profiler attached
    traced_calls: Tuple[int, int] = (0, 0)
    profile_start: int = 0
    window_s: float = math.nan
    peak_bytes: Optional[int] = None
    trace: Optional[TraceSummary] = None
    flops: int = 0
    least_bytes: int = 0
    peaks: Optional[dict] = None
    gap: float = math.inf
    judged: int = 0
    failed: int = 0

    @property
    def calls(self) -> int:
        return len(self.call_s)

    @property
    def inversions(self) -> int:
        return self.calls * self.lanes

    @property
    def traced_inversions(self) -> int:
        return (self.traced_calls[1] - self.traced_calls[0]) * self.lanes


def _lanes(v, B: int):
    """A value set as a call's input: rank 5 for one lane; for B lanes,
    rank 6 with lane l holding D⁻¹·2^-l."""
    if B == 1:
        return v
    return type(v)(torch.stack([v.Lh] * B),
                   torch.stack([v.Dinv * 2.0 ** -l for l in range(B)]))


def run_cell(bench: Bench, cell: str, *, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             solve_dtype: Optional[torch.dtype] = None) -> Run:
    """One run of ``cell``. ``t_start`` is the process's start on
    ``time.perf_counter``; ``solve_dtype`` overrides the precision the
    configuration states (the control runs the port's f32 path)."""
    from repro_torch.core.engine import Grid, PlanOptions, PSelInvEngine

    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    drive = bench.driver(wl["driver"]).drive
    B, V = int(wl["batch"]), int(wl["value_sets"])
    dtype = getattr(torch, cfg["dtype"])
    solve_dtype = solve_dtype or dtype
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    clock = time.perf_counter
    run = Run(cell=cell, workload=wl, config=cfg, traced=trace,
              device_kind=(torch.cuda.get_device_name(device) if cuda
                           else "cpu"), lanes=B)

    seed = int(seed) % (1 << 64)
    t = clock()
    mats = [matrices.make_matrix(cfg["generator"], cfg["params"],
                                 np.random.SeedSequence([seed, s]))
            for s in range(V)]
    if mats[0].shape[0] != cfg["n"]:
        raise ValueError(f"config {cfg['name']!r}: the generator gives "
                         f"n={mats[0].shape[0]}, the file says {cfg['n']}")
    run.matrices_s = clock() - t

    t = clock()
    eng = PSelInvEngine.analyze(mats[0], b=cfg["b"],
                                grid=Grid(*cfg["process_grid"]),
                                options=PlanOptions(**cfg["options"]),
                                device=device)
    sync()
    run.analyze_s = clock() - t
    values, t = [], clock()
    for A in mats:
        values.append(eng.prepare_values(A, dtype=dtype))
    sync()
    run.prepare_s = clock() - t
    values = [_lanes(v, B) for v in values]
    peak0 = torch.cuda.max_memory_allocated(device) if cuda else None
    t = clock()
    out = eng.solve(values[0], dtype=solve_dtype)
    sync()
    run.first_solve_s = clock() - t
    del out
    t = clock()
    for _ in range(2):
        eng.solve(values[0], dtype=solve_dtype)
        sync()
    warm_call_s = (clock() - t) / 2

    # the profiled calls close a traced run's window: once attached, the
    # profiler slows every later graph launch several times over
    traced = int(wl["trace_calls"]) if trace else 0
    untraced_s = (max(seconds - 2 * (traced + 1) * warm_call_s,
                      0.5 * seconds) if trace else seconds)
    # the sampled call, drawn from the seed among the calls the untraced
    # window is sure to make
    sample_at = random.Random(seed).randrange(
        max(1, int(0.9 * untraced_s / warm_call_s)))
    #: the window's first dispatch and last synchronised end, the time
    #: its clock stood still, and the outputs kept for the check, each as
    #: (call index, output)
    kept: Dict[str, object] = {"paused": 0.0}

    def labelled(name):
        return (torch.profiler.record_function(name) if trace
                else contextlib.nullcontext())

    def solve():
        i = run.calls
        kept.pop("last", None)
        # a copy of the sampled output that another call follows is no
        # part of the window
        kept["paused"] += kept.pop("copy_s", 0.0)
        t0 = clock()
        with labelled("bench.solve"):
            out = eng.solve(values[i % V], dtype=solve_dtype)
        t1 = clock()
        with labelled("bench.sync"):
            sync()
        t2 = clock()
        if not run.call_s:
            run.setup_s = t0 - t_start
            kept["start"] = t0
        run.call_s.append(t2 - t0)
        run.dispatch_s.append(t1 - t0)
        kept["end"] = t2
        kept["last"] = (i, out)
        if i == sample_at:
            kept["sample"] = (i, out.to("cpu"))
            kept["copy_s"] = clock() - t2

    prof = None
    if trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        drive(solve, wl, seconds=untraced_s)
        run.profile_start = run.calls
        # one call under the profiler's warm-up, discarded; the active
        # step is the traced window and ends with the context
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            drive(solve, wl, calls=1)
            prof.step()
            first = run.calls
            with record_function(WINDOW):
                drive(solve, wl, calls=traced)
            run.traced_calls = (first, run.calls)
    else:
        drive(solve, wl, seconds=seconds)
    run.window_s = kept["end"] - kept["start"] - kept["paused"]

    if cuda:
        run.peak_bytes = max(peak0, torch.cuda.max_memory_allocated(device))
    samples = dict(kept[k] for k in ("sample", "last") if k in kept)
    kept.clear()
    del values, eng
    PSelInvEngine.clear_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    st = structure.block_structure(mats[0], cfg["b"])
    run.flops = structure.inversion_flops(st)
    run.least_bytes = structure.inversion_bytes(
        st, torch.finfo(dtype).bits // 8)
    run.peaks = peaks.peak_for(run.device_kind)
    _judge(run, samples, mats, st, cfg, V, device)
    if prof is not None:
        run.trace = _summarize(prof)
    return run


def _judge(run: Run, samples: dict, mats, st, cfg, V: int, device) -> None:
    """Compare every lane of each sampled call with the reference."""
    limit = float(cfg["checks"][GAP_CHECK])
    grid = tuple(cfg["process_grid"])
    gaps = []
    for s in sorted({i % V for i in samples}):
        ref = reference.dense_inverse_blocks(mats[s], st, device)
        for i, out in samples.items():
            if i % V != s:
                continue
            lanes = out if run.lanes > 1 else out[None]
            for lane in range(run.lanes):
                try:
                    got = reference.selected_from_shards(
                        lanes[lane], st, grid).to(ref.device)
                    gap = reference.worst_gap(got, ref * 2.0 ** -lane)
                except (IndexError, RuntimeError):   # a malformed output
                    gap = math.inf
                gaps.append(gap)
        del ref
    run.judged = len(gaps)
    run.failed = sum(not g <= limit for g in gaps)
    run.gap = max(gaps) if gaps else math.inf


def _summarize(prof) -> Optional[TraceSummary]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_trace(path, WINDOW)
    finally:
        os.unlink(path)


def result(bench: Bench, run: Run) -> dict:
    """The run's result line: ``correct``, ``attempted``, ``failed``, the
    cell's metrics that its readers found, ``device``, ``breakdown`` when
    traced, and last the compared numbers with their limits."""
    limit = float(run.config["checks"][GAP_CHECK])
    metrics = {}
    for m in bench.metrics(run.cell, run.traced):
        reader = bench.metric(m["name"])
        if reader.UNIT != m["unit"] or reader.BETTER != m["better"]:
            raise ValueError(f"metric {m['name']!r}: its reader declares "
                             f"{reader.UNIT!r}/{reader.BETTER!r}, "
                             f"BENCHMARK.json {m['unit']!r}/{m['better']!r}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device_kind != "cpu" else "cpu",
              "kind": run.device_kind, "count": 1,
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": run.judged > 0 and run.failed == 0,
           "attempted": run.inversions, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        top = sorted(run.trace.by_name.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(run.trace.idle_by_host.items(),
                      key=lambda x: -x[1])[:10]
        out["breakdown"] = {"device_ops": [[k[:120], v] for k, v in top],
                            "idle_gaps": [[k[:120], v] for k, v in gaps]}
    # JSON has no infinity: a gap that is not finite prints as the
    # largest double
    gap = run.gap if math.isfinite(run.gap) else np.finfo(np.float64).max
    out["checks"] = {GAP_CHECK: {"value": gap, "limit": limit}}
    return out
