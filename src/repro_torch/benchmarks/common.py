"""Shared benchmark utilities — the port's copy of
``benchmarks/common.py``, plus :func:`timed_cuda`. Output files go to
``build/bench_out/`` at the root of the checkout."""
from __future__ import annotations

import os
import re
import time

import torch

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, os.pardir, os.pardir, "build", "bench_out")

#: every csv_row lands here so ``run.py --json`` can persist the session
RESULTS: list = []


def ensure_out() -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.normpath(OUT_DIR)


def timed(fn, *args, reps: int = 3, best: bool = False, **kw):
    """Warm up once, then time ``reps`` calls on the host clock.
    ``best=True`` returns the fastest rep instead of the mean (for
    ratios, where one descheduled rep must not flip the verdict)."""
    fn(*args, **kw)
    ts = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        ts.append(time.perf_counter() - t0)
    return out, (min(ts) if best else sum(ts) / reps)


def timed_cuda(fn, device, *, reps: int = 3, best: bool = False):
    """:func:`timed` for work on ``device``: on the card each call is
    timed between CUDA events recorded after a synchronize (the device's
    time for the call, or the host's launch time where that is slower);
    on the CPU by the host clock. Returns (last output, seconds)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return timed(fn, reps=reps, best=best)
    fn()
    ts = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize(dev)
        ts.append(s.elapsed_time(e) / 1e3)
    return out, (min(ts) if best else sum(ts) / reps)


def csv_row(name: str, us_per_call: float, derived: str = "") -> str:
    line = f"{name},{us_per_call:.1f},{derived}"
    RESULTS.append({"name": name, "us_per_call": float(us_per_call),
                    "derived": derived})
    print(line, flush=True)
    return line


_ROW_NAME = re.compile(r"^[\w./-]+$")


def reemit_child_rows(stdout: str) -> None:
    """Re-record ``name,us,derived`` rows printed by a child bench
    process through :func:`csv_row` (so --json captures them). Only
    lines whose name field looks like a bench id are recorded; other
    lines pass through verbatim. The twin of the JAX helper, kept for a
    bench that runs its measurement in a child process printing rows:
    no bench of the port does yet (``treecomm_bench`` and the examples
    return their results through ``comm.p2p.spawn``)."""
    for line in stdout.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and _ROW_NAME.match(parts[0]):
            try:
                us = float(parts[1])
            except ValueError:
                print(line, flush=True)
                continue
            csv_row(parts[0], us, parts[2])
        elif line.strip():
            print(line, flush=True)
