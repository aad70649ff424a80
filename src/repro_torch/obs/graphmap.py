"""Device time of a captured sweep by phase and round, from a profiler
trace of its replays.

Inside a CUDA-graph replay no host code runs, so no host span can label
the kernels it launches. The program knows, while it captures, which
graph node belongs to which phase and round of the overlapped sweep
(``exec_ir.mark``, read in ``capture.capture``): each captured graph
keeps a :class:`PhaseMap`, its device nodes (kernels, copies and fills)
in order, each with its phase, its round, its kind and its function
name, and each round's permute payload bytes. The maps stay in a small
table here, keyed by the graph id (:func:`register`, :func:`lookup`),
so that they outlive their session: a trace is often read after the
engine that captured it is gone.

:func:`attribute` reads a Chrome trace of ``torch.profiler`` (its
``traceEvents``): it groups each replay's device operations by the
``cudaGraphLaunch`` that started them (the same ``correlation`` id), and
names the graph each launch ran by the ``graph.replay graph=<id>`` range
the runner opens around it (:mod:`.trace`). A replay is attributed only
where its operations, in the order they started, have the map's count
and the map's function names in the map's order (a copy or fill node
may run as a CUDA kernel named after it, ``memcpy32_post``); any other
replay is counted and left unattributed. Device operations that the runner's
``graph.copy_in`` and ``graph.clone`` ranges launched are the copies;
the rest is ``other``.

The phases: ``arena.init`` (the arena's zeros and the diagonal seeds,
round -1), ``gemm`` (the Û gather, its mask and the level product),
``update.cols``, ``update.diag_sum``, ``update.diag_write``,
``lanes.local``, ``lanes.gather``, ``lanes.permute``, ``lanes.land`` and
``arena.finish`` (the extraction copy; with the trailing boundary's
compute ops it has round ``nrounds``). Nodes before the first mark are
``unmarked``. A node is a *product* when it runs a matrix product: the
hand-written block GEMM or a cuBLAS GEMM (the diagonal sum's einsum).
"""
from __future__ import annotations

import bisect
import ctypes
import json
import os
import re
import tempfile
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Node", "PhaseMap", "register", "lookup", "demangle",
           "is_product", "attribute", "split", "lanes", "trace_of",
           "PHASES", "COPY_RANGES"]

#: every phase a mark names, in the order a round runs them
PHASES = ("arena.init", "gemm", "update.cols", "update.diag_sum",
          "update.diag_write", "lanes.local", "lanes.gather",
          "lanes.permute", "lanes.land", "arena.finish")
#: the runner's ranges whose device operations are the copies
COPY_RANGES = ("graph.copy_in", "graph.clone")
_REPLAY = re.compile(r"graph\.replay graph=(\d+)$")
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}
_PRODUCT_MARKS = ("block_gemm_kernel", "gemm", "Gemm", "cutlass", "xmma",
                  "nvjet", "cublas")
#: maps kept, newest last
MAX_MAPS = 64


def is_product(name: str) -> bool:
    """A kernel of a matrix product, by its function name."""
    return any(m in name for m in _PRODUCT_MARKS)


@dataclass(frozen=True)
class Node:
    """One device node of a captured graph, in the graph's order."""
    phase: str
    round: int
    kind: str          #: ``kernel``, ``memcpy`` or ``memset``
    name: str          #: a kernel's demangled function name, else ""

    @property
    def product(self) -> bool:
        return self.kind == "kernel" and is_product(self.name)


@dataclass
class PhaseMap:
    """The phase map of one captured graph: its device ``nodes`` in
    order, or None where the graph is not one chain (nothing is then
    attributed); ``permute_bytes`` — each round's permute payload, the
    bytes all ranks send."""
    gid: int
    nodes: Optional[Tuple[Node, ...]]
    permute_bytes: Dict[int, int] = field(default_factory=dict)

    @property
    def chain(self) -> bool:
        return self.nodes is not None


_MAPS: "OrderedDict[int, PhaseMap]" = OrderedDict()


def register(pm: PhaseMap) -> PhaseMap:
    """Keep ``pm`` under its graph id; the oldest of more than
    :data:`MAX_MAPS` maps goes."""
    _MAPS[pm.gid] = pm
    _MAPS.move_to_end(pm.gid)
    while len(_MAPS) > MAX_MAPS:
        _MAPS.popitem(last=False)
    return pm


def lookup(gid: int) -> Optional[PhaseMap]:
    return _MAPS.get(gid)


_demangler = None


def demangle(name: str) -> str:
    """A mangled C++ symbol as the profiler's trace prints it (the C++
    ABI's demangler, which the profiler also uses); anything else as
    given."""
    global _demangler
    if _demangler is None:
        cxx = ctypes.CDLL("libstdc++.so.6")
        fn = cxx.__cxa_demangle
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
        free = ctypes.CDLL(None).free
        free.argtypes = [ctypes.c_void_p]
        _demangler = (fn, free)
    fn, free = _demangler
    status = ctypes.c_int(0)
    ptr = fn(name.encode(), None, None, ctypes.byref(status))
    if not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode() if status.value == 0 else name
    finally:
        free(ptr)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def trace_of(prof) -> dict:
    """The Chrome trace of a finished ``torch.profiler.profile``, as the
    dict its exporter writes (``traceEvents`` and the rest)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def _window(events: List[dict], window: Optional[str]):
    if window is None:
        return -float("inf"), float("inf")
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == window):
            t0 = float(e["ts"])
            return t0, t0 + float(e.get("dur", 0))
    return None


class _Ranges:
    """The runner's ranges on each host thread, by start time: they
    follow one another, none inside another."""

    def __init__(self, events: List[dict], keep):
        by: Dict[tuple, list] = defaultdict(list)
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and keep(e.get("name", ""))):
                t0 = float(e["ts"])
                by[(e.get("pid"), e.get("tid"))].append(
                    (t0, t0 + float(e.get("dur", 0)), e["name"]))
        self.by = {k: sorted(v) for k, v in by.items()}
        self.starts = {k: [r[0] for r in v] for k, v in self.by.items()}

    def around(self, e: dict) -> Optional[str]:
        """The name of the range around the host event ``e`` on its
        thread."""
        key = (e.get("pid"), e.get("tid"))
        rs = self.by.get(key)
        if not rs:
            return None
        t = float(e["ts"])
        i = bisect.bisect_right(self.starts[key], t) - 1
        if i >= 0 and t <= rs[i][1]:
            return rs[i][2]
        return None


def _match(events: Iterable[dict], window: Optional[str] = None,
           graph: Optional[int] = None):
    """The device operations that overlap the window, split into the
    replays attributed (each with its map, its operations sorted by
    start), the replays left unattributed, the copies and the rest; and
    each operation's time inside the window (µs, by ``id``). A replay is
    one whose launch lies in the window."""
    events = list(events)
    w = _window(events, window)
    if w is None:
        return None
    w0, w1 = w

    def inside(e):
        t = float(e["ts"])
        return w0 <= t and t + float(e.get("dur", 0)) <= w1

    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS and float(e["ts"]) < w1
           and float(e["ts"]) + float(e.get("dur", 0)) > w0]
    # an operation's time in the window, as the trace summary counts it
    clipped = {id(e): float(e.get("dur", 0))
               - max(0.0, w0 - float(e["ts"]))
               - max(0.0, float(e["ts"]) + float(e.get("dur", 0)) - w1)
               for e in dev}
    host = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                     "cuda_driver")
                and _corr(e) is not None):
            host[_corr(e)] = e
    launches = {c: e for c, e in host.items()
                if e.get("name", "").startswith("cudaGraphLaunch")
                and inside(e)}
    ranges = _Ranges(events, lambda n: n in COPY_RANGES
                     or n.startswith("graph.replay"))
    groups: Dict[object, List[dict]] = defaultdict(list)
    copies, rest = [], []
    for e in dev:
        c = _corr(e)
        if c in launches:
            groups[c].append(e)
        elif c in host and ranges.around(host[c]) in COPY_RANGES:
            copies.append(e)
        else:
            rest.append(e)
    matched, unmatched = [], []
    for c, ops in groups.items():
        ops.sort(key=lambda e: float(e["ts"]))
        gid = graph
        if gid is None:
            m = _REPLAY.match(ranges.around(launches[c]) or "")
            gid = int(m.group(1)) if m else None
        pm = lookup(gid) if gid is not None else None
        if (pm is not None and pm.chain and len(pm.nodes) == len(ops)
                and all(map(_fits, pm.nodes, ops))):
            matched.append((pm, ops))
        else:
            unmatched.append(ops)
    return matched, unmatched, copies, rest, clipped


def _fits(node: Node, e: dict) -> bool:
    """The trace's operation ``e`` is what ``node`` runs: the same
    kernel, or a copy or fill — which a replay may run as a CUDA
    kernel of its own (``memcpy32_post``)."""
    kind, name = _DEVICE_CATS[e["cat"]], e.get("name", "")
    if node.kind == "kernel":
        return kind == "kernel" and name == node.name
    return kind == node.kind or (kind == "kernel" and node.kind in name)


def attribute(events: Iterable[dict], window: Optional[str] = None, *,
              graph: Optional[int] = None) -> Optional[dict]:
    """Device seconds of the replays in a Chrome trace's ``events``, by
    phase and by round of the sweep, products split from the rest — of
    the user range named ``window`` alone when given. ``graph`` names
    the graph of every launch where the trace carries no
    ``graph.replay`` ranges (a trace of device activity only).

    Returns None where no replay matched its map, else a dict:
    ``replays`` (attributed) and ``unmatched`` (replays left out, whose
    seconds are ``unattributed``); ``phase`` and ``round``, each entry
    ``{"product": s, "rest": s}`` summed over the attributed replays;
    ``copy`` (under ``graph.copy_in`` / ``graph.clone``), ``other`` (any
    other device operation of the window); ``permute_bytes`` (round →
    one replay's permute payload) and ``graphs`` (graph id → replays).
    An operation counts for its time inside the window, as the
    benchmark's trace summary counts it."""
    got = _match(events, window, graph)
    if got is None:
        return None
    matched, unmatched, copies, rest, clipped = got
    if not matched:
        return None

    def _dur(e):
        return clipped[id(e)]

    # sums in the trace's µs, each turned into seconds once
    phase: Dict[str, Dict[str, float]] = {}
    rnd: Dict[int, Dict[str, float]] = {}
    graphs: Dict[int, int] = defaultdict(int)
    pbytes: Dict[int, int] = {}
    for pm, ops in matched:
        graphs[pm.gid] += 1
        pbytes.update(pm.permute_bytes)
        for node, e in zip(pm.nodes, ops):
            part = "product" if node.product else "rest"
            for table, k in ((phase, node.phase), (rnd, node.round)):
                slot = table.setdefault(k, {"product": 0.0, "rest": 0.0})
                slot[part] += _dur(e)

    def seconds(table):
        return {k: {p: us * 1e-6 for p, us in v.items()}
                for k, v in sorted(table.items())}

    return {"replays": len(matched), "unmatched": len(unmatched),
            "unattributed": 1e-6 * sum(_dur(e) for ops in unmatched
                                       for e in ops),
            "phase": seconds(phase), "round": seconds(rnd),
            "copy": 1e-6 * sum(_dur(e) for e in copies),
            "other": 1e-6 * sum(_dur(e) for e in rest),
            "permute_bytes": dict(sorted(pbytes.items())),
            "graphs": dict(graphs)}


def split(got: Optional[dict]) -> Optional[Dict[str, float]]:
    """The device seconds of an :func:`attribute` result: the matrix
    products, and the rest in the groups the roadmap's work on the sweep
    targets — ``lanes`` (``lanes.*``), ``operands`` (``gemm``: the Û
    gather and mask), ``updates`` (``update.*``), ``arena``
    (``arena.*``), ``copy`` (the runner's copy-in and clone) — and
    ``other``. Summed over the attributed replays; None where ``got`` is
    None."""
    if got is None:
        return None
    ph = got["phase"]

    def rest(prefix):
        return sum(v["rest"] for k, v in ph.items() if k.startswith(prefix))

    return {"products": sum(v["product"] for v in ph.values()),
            "lanes": rest("lanes."), "operands": rest("gemm"),
            "updates": rest("update."), "arena": rest("arena."),
            "copy": got["copy"], "other": got["other"]}


def lanes(events: Iterable[dict], pid: int, window: Optional[str] = None,
          *, graph: Optional[int] = None) -> List[dict]:
    """Two trace lanes of the attributed replays on the trace's own
    clock, as Chrome-trace events of process ``pid``: tid 0 one event a
    run of nodes of one phase, tid 1 one event a round (its permute
    payload bytes in ``args``), each from its first operation's start to
    its last one's end."""
    got = _match(events, window, graph)
    if got is None:
        return []
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "sweep graph (device time)"}},
           {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "phases"}},
           {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
            "args": {"name": "rounds"}}]
    for pm, ops in got[0]:
        for tid, label in ((0, lambda n: (n.phase, n.round)),
                           (1, lambda n: n.round)):
            run: List[Tuple[Node, dict]] = []
            for node, e in list(zip(pm.nodes, ops)) + [(None, None)]:
                if run and (node is None or label(node) != label(run[0][0])):
                    first, last = run[0][1], run[-1][1]
                    t0 = float(first["ts"])
                    t1 = float(last["ts"]) + float(last.get("dur", 0))
                    n0 = run[0][0]
                    args = {"round": n0.round, "ops": len(run),
                            "device_us": sum(float(x.get("dur", 0))
                                             for _, x in run)}
                    if tid == 1:
                        args["permute_bytes"] = pm.permute_bytes.get(
                            n0.round, 0)
                    out.append({"ph": "X", "cat": "sweep",
                                "name": (n0.phase if tid == 0
                                         else f"round {n0.round}"),
                                "ts": t0, "dur": t1 - t0, "pid": pid,
                                "tid": tid, "args": args})
                    run = []
                if node is not None:
                    run.append((node, e))
    return out
