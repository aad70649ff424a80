"""Reduce a profiler trace of the window to device time by kernel class,
busy time and idle gaps.

``kernel_class`` is a frozen copy of the classifier of ``trace_device``'s
callers in ``chip_smoke.py`` (``_solve_class``, ``_CUBLAS``) at commit
738e407. The trace is the Chrome-trace file that ``torch.profiler``
exports (``traceEvents``, times in µs): the device's kernels, copies and
fills (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) on the host's
time base, and the host's ranges and runtime calls.

A replay is the device operations that one ``cudaGraphLaunch`` started
(the same ``correlation`` id), from the first one's start to the last
one's end; where the trace has no graph launch, each ``bench.solve``
range starts the next call's operations. The gaps inside replays are
the program's own; those between them are the host's dispatch and, in
a traced run, the profiler's cost on each launch.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["GEMM_CLASS", "CUBLAS_CLASS", "PRODUCT_CLASSES", "kernel_class",
           "TraceSummary", "summarize", "read_trace"]

_CUBLAS = ("gemm", "Gemm", "cutlass", "xmma", "sm90", "nvjet", "cublas")
GEMM_CLASS = "block_gemm (hand-written)"
CUBLAS_CLASS = "cuBLAS (scomp einsum)"
#: the classes whose kernels are matrix products
PRODUCT_CLASSES = (GEMM_CLASS, CUBLAS_CLASS)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def kernel_class(name: str) -> str:
    if "block_gemm_kernel" in name:
        return GEMM_CLASS
    if any(x in name for x in _CUBLAS):
        return CUBLAS_CLASS
    if "ndex" in name or "catter" in name or "ather" in name:
        return "gather / scatter / index_add"
    if "emcpy" in name or "emset" in name:
        return "memcpy / memset"
    return "elementwise (where, sub, transpose copies, zeros)"


@dataclass
class TraceSummary:
    """The traced window: its length, the device's busy time (the union of
    its operations' intervals), the replays' spans and busy time inside
    them, device time by class and by operation name, and idle time by
    what the host was doing (seconds)."""
    window_s: float
    busy_s: float
    replay_span_s: float = 0.0
    replay_busy_s: float = 0.0
    by_class: Dict[str, float] = field(default_factory=dict)
    by_name: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(t: float, host: List[dict]) -> str:
    """What the host was doing at ``t``: the innermost benchmark range
    and the innermost operation or runtime call covering it."""
    rng, op = None, None
    for ev in host:
        if ev["ts"] > t:
            break
        if t >= ev["ts"] + ev["dur"]:
            continue
        if ev["cat"] == "user_annotation":
            if rng is None or ev["dur"] < rng["dur"]:
                rng = ev
        elif op is None or ev["dur"] < op["dur"]:
            op = ev
    parts = [e["name"] for e in (rng, op) if e is not None]
    return ": ".join(parts) if parts else "outside every range"


def _replays(events: List[dict], w0: float,
             w1: float) -> Dict[object, List[Tuple[float, float]]]:
    """The device operations of the window, as intervals grouped by the
    replay that ran them."""
    def inside(e):
        return w0 <= float(e["ts"]) and float(e["ts"]) + float(
            e.get("dur", 0)) <= w1

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS and inside(e)]
    launches = {corr(e) for e in events if e.get("ph") == "X"
                and e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaGraphLaunch")
                and inside(e)} - {None}
    groups: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
    if launches:
        for e in dev:
            if corr(e) in launches:
                groups[corr(e)].append(
                    (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
        return groups
    starts = sorted(float(e["ts"]) for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name") == "bench.solve" and inside(e))
    for e in dev:
        k = bisect.bisect_right(starts, float(e["ts"]))
        if k:
            groups[k].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    return groups


def summarize(events: List[dict], window: str) -> Optional[TraceSummary]:
    """The summary of the user range named ``window`` in ``events`` (a
    Chrome trace's ``traceEvents``), or None when the trace has no such
    range or no device operation inside it."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == window]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if t > s:
            dev.append((s, t, e.get("name", "")))
    if not dev:
        return None
    span, inside = 0.0, 0.0
    for ops in _replays(events, w0, w1).values():
        span += max(t for _, t in ops) - min(s for s, _ in ops)
        inside += sum(t - s for s, t in _merge(ops))
    by_class: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_class[kernel_class(name)] += (t - s) * 1e-6
        by_name[name] += (t - s) * 1e-6
    busy = _merge([(s, t) for s, t, _ in dev])
    host = sorted(({"ts": float(e["ts"]), "dur": float(e.get("dur", 0)),
                    "cat": e["cat"], "name": e.get("name", "")}
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in _HOST_CATS
                   and w0 <= float(e["ts"]) + float(e.get("dur", 0))
                   and float(e["ts"]) <= w1),
                  key=lambda e: e["ts"])
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t > s:
            idle[_host_label(0.5 * (s + t), host)] += (t - s) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6,
                        busy_s=sum(t - s for s, t in busy) * 1e-6,
                        replay_span_s=span * 1e-6,
                        replay_busy_s=inside * 1e-6,
                        by_class=dict(by_class), by_name=dict(by_name),
                        idle_by_host=dict(idle))


def read_trace(path, window: str) -> Optional[TraceSummary]:
    """:func:`summarize` over the Chrome-trace file at ``path``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return summarize(events, window)
