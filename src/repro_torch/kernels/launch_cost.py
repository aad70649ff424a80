"""Host cost of the ``trsm`` and ``rmsnorm`` wrappers, step by step, on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.launch_cost [--calls N]

For each wrapper, at a small shape (where the host, not the kernel, sets
the pace of back-to-back calls), it times ``N`` back-to-back runs of
each step the wrapper takes — the output allocation, the alignment test,
the stream query, the device guard, the plan, the ctypes call with the
arguments the wrapper passes, and the whole call — on the host clock,
with a synchronize before and after each loop, and prints one
``name,us_per_call`` row per step. The ctypes step launches the kernel
(so its count, but not ``launches``, moves); it is timed alone so that
the rest of the call is what the other steps add. Needs a CUDA device."""
from __future__ import annotations

import argparse
import time

import torch

from . import rmsnorm as rk
from . import trsm as tk

__all__ = ["run"]


def _per_call_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _recorded_args(mod, call):
    """The arguments ``call`` hands to ``mod``'s bound C entry."""
    fn = mod._kernel()
    seen = []

    def record(*a):
        seen.append(a)
        return fn(*a)
    mod._fn = record
    try:
        call()
    finally:
        mod._fn = fn
    torch.cuda.synchronize()
    return fn, seen[-1]


def _steps(mod, name, x, out, call, plan, calls):
    dev = x.device
    idx = dev.index
    fn, args = _recorded_args(mod, call)

    def guard():
        with torch.cuda.device(dev):
            pass
    steps = {
        "empty_like": lambda: torch.empty_like(x),
        "alignment_test": lambda: (x.data_ptr() % 16 == 0
                                   and out.data_ptr() % 16 == 0),
        "stream_query": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "current_device": torch.cuda.current_device,
        "device_guard": guard,
        "plan": plan,
        "ctypes_call": lambda: fn(*args),
        "whole_call": call,
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:        # for comparison only; the wrappers keep
        steps["raw_stream_query"] = lambda: raw(idx)    # the public API
    rows = []
    for step, fn_ in steps.items():
        us = _per_call_us(fn_, calls)
        rows.append(dict(name=f"{name}/{step}", us_per_call=us))
        print(f"{name}/{step},{us:.3f}", flush=True)
    return rows


def run(calls: int = 10000, device="cuda"):
    """The rows of both wrappers; ``device`` must be a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("launch_cost times the wrappers on the card: "
                           "it needs a CUDA device")
    g = torch.Generator(device=dev).manual_seed(0)
    k = 32
    u = (torch.randn(k, k, device=dev, generator=g, dtype=torch.float64)
         .triu() / k ** 0.5 + 2 * torch.eye(k, device=dev,
                                           dtype=torch.float64))
    b = torch.randn(32, k, device=dev, generator=g, dtype=torch.float64)
    rows = _steps(tk, "trsm 32x32 float64", b, torch.empty_like(b),
                  lambda: tk.trsm(b, u), lambda: tk.plan(32, k, b.dtype),
                  calls)
    x = torch.randn(8, 1024, device=dev, generator=g).to(torch.bfloat16)
    s = torch.randn(1024, device=dev, generator=g).to(torch.bfloat16)
    rows += _steps(rk, "rmsnorm 8x1024 bfloat16", x, torch.empty_like(x),
                   lambda: rk.rmsnorm(x, s), lambda: rk.plan(8, 1024, x.dtype),
                   calls)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10000)
    run(ap.parse_args().calls)
