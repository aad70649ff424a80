"""CUDA-graph capture of a session's sweep — the port's counterpart of
the JAX engine's jit compile (``repro/core/engine.py`` ``jitted``).

:func:`capture` records one shape class of a sweep — (batched, B,
dtype) — as a ``torch.cuda.CUDAGraph`` over static value buffers, and
returns a :class:`GraphRunner`: a replay copies the caller's values into
the static buffers, replays every kernel of the sweep with one launch
from the host, and returns a copy of the static A⁻¹ buffer (the next
replay overwrites it). Nothing here runs on the CPU; the engine keeps
its eager sweep there.

Before capture the sweep runs once eagerly on a side stream: it builds
and loads the hand-written kernels (nvcc, ctypes), sets their
shared-memory attributes and sets up cuBLAS on first use, none of which
may happen inside a capture. The wrappers launch on
``torch.cuda.current_stream()`` at every call, so under capture their
kernels land on the capture stream. The capture is thread-local: other
threads may use the card meanwhile. A failed capture or replay raises;
nothing falls back to the eager sweep.

:func:`kernel_census` reads the kernel nodes of a captured graph
through the CUDA driver (``cuGraphGetNodes`` …, ``cuFuncGetName``): what
one replay launches, counted without running it. The permutes the sweep
runs while it is captured are recorded (:mod:`.exec_ir`, from host lists
only: nothing synchronizes inside the capture) — what every replay
executes, which ``engine.lint_compiled`` holds to the plan.

Each phase mark of the sweep (``exec_ir.mark``) reads the capture's
node frontier (``cuStreamGetCaptureInfo``); after the capture the
graph's chain of nodes is walked from its root, and every device node
(kernel, copy, fill) takes the phase and round of the last mark before
it: the runner's :class:`~repro_torch.obs.graphmap.PhaseMap`,
kept under the runner's graph id in :mod:`repro_torch.obs.graphmap`. The
marks add no node. A replay runs inside the spans ``graph.copy_in``,
``graph.replay`` (with the graph id) and ``graph.clone``, which a
recording profiler sees as ranges (:mod:`repro_torch.obs.trace`)."""
from __future__ import annotations

import collections
import ctypes
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..kernels import block_gemm as _block_gemm
from ..obs import graphmap
from ..obs.trace import TRACER
from . import exec_ir

__all__ = ["GraphRunner", "ReplayGate", "capture", "kernel_census",
           "pool_bytes"]

#: ``CUgraphNodeType`` of the device nodes: kernel, copy, fill
_DEVICE_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}
_KERNEL_NODE = 0
_driver = None
#: each captured graph's id, which names it in a profiler's trace
_GRAPH_IDS = itertools.count(1)


def _libcuda():
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for name in ("cuGraphGetNodes", "cuGraphNodeGetType",
                     "cuGraphKernelNodeGetParams_v2", "cuFuncGetName",
                     "cuGraphGetEdges", "cuStreamGetCaptureInfo_v2"):
            getattr(lib, name).restype = ctypes.c_int
        _driver = lib
    return _driver


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def _nodes(raw: ctypes.c_void_p) -> List[int]:
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    return [int(x or 0) for x in nodes[:n.value]]


def _node_kind(node: int) -> int:
    kind = ctypes.c_int(-1)
    _check(_libcuda().cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)),
           "cuGraphNodeGetType")
    return kind.value


def _kernel_name(node: int) -> str:
    """The mangled name of a kernel node's function."""
    cu = _libcuda()
    # CUDA_KERNEL_NODE_PARAMS_v2 opens with the CUfunction; the rest of
    # the struct is read into the buffer and ignored
    params = (ctypes.c_char * 256)()
    _check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
           "cuGraphKernelNodeGetParams")
    func = ctypes.c_void_p.from_buffer(params).value
    name = ctypes.c_char_p()
    _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)),
           "cuFuncGetName")
    return (name.value or b"").decode()


def kernel_census(graph: "torch.cuda.CUDAGraph") -> collections.Counter:
    """The kernel nodes of a captured graph (kept with
    ``keep_graph=True``), counted by the mangled name of their
    function."""
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    return collections.Counter(_kernel_name(node) for node in _nodes(raw)
                               if _node_kind(node) == _KERNEL_NODE)


def _frontier(stream: ctypes.c_void_p) -> Tuple[int, ...]:
    """The nodes the capture on ``stream`` would hang its next node on."""
    cu = _libcuda()
    status, cid = ctypes.c_int(0), ctypes.c_uint64(0)
    graph = ctypes.c_void_p()
    deps = ctypes.POINTER(ctypes.c_void_p)()
    n = ctypes.c_size_t(0)
    _check(cu.cuStreamGetCaptureInfo_v2(
        stream, ctypes.byref(status), ctypes.byref(cid),
        ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n)),
        "cuStreamGetCaptureInfo")
    return tuple(int(deps[i] or 0) for i in range(n.value))


def _edges(raw: ctypes.c_void_p) -> List[Tuple[int, int]]:
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetEdges(raw, None, None, ctypes.byref(n)),
           "cuGraphGetEdges")
    src = (ctypes.c_void_p * n.value)()
    dst = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetEdges(raw, src, dst, ctypes.byref(n)),
           "cuGraphGetEdges")
    return [(int(a or 0), int(b or 0))
            for a, b in zip(src[:n.value], dst[:n.value])]


def chain_order(nodes: List[int],
                edges: List[Tuple[int, int]]) -> Optional[List[int]]:
    """The nodes in order when the edges make them one chain, else
    None."""
    nxt: Dict[int, int] = {}
    heads = set(nodes)
    for a, b in edges:
        if a in nxt or b not in heads:
            return None         # a fork, or a join
        nxt[a] = b
        heads.discard(b)
    if len(heads) != 1 or len(nxt) != len(nodes) - 1:
        return None
    order = [heads.pop()]
    while order[-1] in nxt:
        order.append(nxt[order[-1]])
    return order if len(order) == len(nodes) else None


def _phase_map(graph: "torch.cuda.CUDAGraph", gid: int,
               marks: List[Tuple[Tuple[int, ...], str, int]],
               ops: List[exec_ir.ExecutedOp]) -> graphmap.PhaseMap:
    """The graph's device nodes in order, each with the phase and round
    of the last mark before it (``marks``: each mark's frontier, phase
    and round), and each round's permute bytes from the capture's
    record."""
    pbytes: Dict[int, int] = {}
    for op in ops:
        if op.op == "collective-permute" and op.where.startswith("round "):
            t = int(op.where.split()[1])
            pbytes[t] = pbytes.get(t, 0) + op.nbytes * len(op.pairs or ())
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    order = chain_order(_nodes(raw), _edges(raw))
    if order is None:
        return graphmap.PhaseMap(gid, None, pbytes)
    names: Dict[str, str] = {}

    def device_node(node: int):
        kind = _DEVICE_NODES.get(_node_kind(node))
        if kind != "kernel":
            return kind, ""
        mangled = _kernel_name(node)
        if mangled not in names:
            names[mangled] = graphmap.demangle(mangled)
        return kind, names[mangled]

    return graphmap.PhaseMap(gid, label_chain(order, marks, device_node),
                             pbytes)


def label_chain(order: List[int],
                marks: List[Tuple[Tuple[int, ...], str, int]],
                device_node) -> Optional[Tuple[graphmap.Node, ...]]:
    """The device nodes of a chain in order, each with the phase and
    round of the last mark whose frontier lies before it; None where a
    mark saw more than one frontier node (no chain). ``device_node(node)``
    gives a node's kind (None for a node that is no device work) and
    name."""
    if any(len(f) > 1 for f, _, _ in marks):
        return None
    after: Dict[int, Tuple[str, int]] = {}
    label = ("unmarked", -1)
    for front, phase, t in marks:
        if front:
            after[front[0]] = (phase, t)
        else:                   # before the graph's first node
            label = (phase, t)
    nodes = []
    for node in order:
        kind, name = device_node(node)
        if kind is not None:
            nodes.append(graphmap.Node(label[0], label[1], kind, name))
        label = after.get(node, label)
    return tuple(nodes)


def pool_bytes(pool, device) -> int:
    """Bytes the caching allocator holds for one graph memory pool."""
    return sum(int(seg["total_size"])
               for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == tuple(pool))


class ReplayGate:
    """Serializes the replays of the graphs that share one memory pool
    (their temporaries overlap): ``lock`` for the host, and ``done``, the
    last replay's copy-out event, for the device — a replay on another
    stream waits for it."""

    def __init__(self, lock: threading.RLock):
        self.lock = lock
        self.done: Optional[torch.cuda.Event] = None


@dataclass(eq=False)
class GraphRunner:
    """One captured shape class: the graph, its static inputs ``Lh`` and
    ``Dinv`` and output ``out``, and what the capture measured —
    ``warmup_ms`` and ``capture_ms`` (host clock, each ending in a
    synchronize), the graph's kernel nodes by function name
    (``kernels``), the block-GEMM wrapper's launches recorded into it
    (``gemm_launches``) and their plans (``gemm_plans``), the permutes
    recorded while it was captured (``ops``, :mod:`.exec_ir`), the graph's
    id ``gid`` and its phase map (``phases``; None where the sweep marked
    no phase). ``sweep`` is the captured sweep: it holds the device
    tables whose addresses the graph's kernels read, so they live as
    long as the runner."""
    graph: "torch.cuda.CUDAGraph"
    sweep: Callable
    Lh: torch.Tensor
    Dinv: torch.Tensor
    out: torch.Tensor
    batched: bool
    gate: ReplayGate
    warmup_ms: float
    capture_ms: float
    kernels: collections.Counter
    gemm_launches: int
    gemm_plans: collections.Counter
    ops: list = None
    replays: int = 0
    gid: int = 0
    phases: Optional[graphmap.PhaseMap] = None

    @property
    def graph_kernels(self) -> int:
        return sum(self.kernels.values())

    @property
    def gemm_nodes(self) -> int:
        return sum(c for k, c in self.kernels.items()
                   if "block_gemm_kernel" in k)

    @property
    def static_bytes(self) -> int:
        return 2 * self.Lh.numel() * self.Lh.element_size()

    def __call__(self, Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        """A⁻¹ of the values, by one replay. A batched class of B lanes
        takes up to B matrices; the lanes past them are zeroed."""
        n = Lh.shape[0] if self.batched else 1
        with self.gate.lock:
            stream = torch.cuda.current_stream(self.Lh.device)
            if self.gate.done is not None:
                # the previous replay may sit on another stream
                stream.wait_event(self.gate.done)
            with TRACER.span("graph.copy_in"):
                if self.batched and n < self.Lh.shape[0]:
                    self.Lh[:n].copy_(Lh)
                    self.Dinv[:n].copy_(Dinv)
                    self.Lh[n:].zero_()
                    self.Dinv[n:].zero_()
                else:
                    self.Lh.copy_(Lh)
                    self.Dinv.copy_(Dinv)
            with TRACER.span("graph.replay", graph=self.gid):
                self.graph.replay()
            with TRACER.span("graph.clone"):
                out = (self.out[:n] if self.batched else self.out).clone()
            self.gate.done = torch.cuda.Event()
            self.gate.done.record(stream)
            self.replays += 1
        return out


def _reserve(nbytes: int, device) -> None:
    """Allocate ``nbytes`` and a margin as one block, and free it."""
    torch.empty(int(nbytes * 1.05) + (64 << 20), dtype=torch.uint8,
                device=device)


def capture(sweep: Callable, shape: Tuple[int, ...], dtype: torch.dtype,
            device: torch.device, pool, gate: ReplayGate,
            batched: bool) -> GraphRunner:
    """Warm ``sweep`` up on a side stream, then capture it over static
    zero-filled ``shape`` buffers into the memory ``pool``, whose graphs
    replay through ``gate``. The warm-up's peak sizes the pool's block
    for the capture; measuring it resets the device's peak-memory
    statistics."""
    Lh = torch.zeros(shape, dtype=dtype, device=device)
    Dinv = torch.zeros(shape, dtype=dtype, device=device)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        sweep(Lh, Dinv)
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    warmup_ms = (time.perf_counter() - t0) * 1e3
    need = torch.cuda.max_memory_allocated(device) - base

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    launches0 = _block_gemm.launches
    plans0 = collections.Counter(_block_gemm.plans)
    marks: List[Tuple[Tuple[int, ...], str, int]] = []
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"), \
            exec_ir.record() as rec:
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream)
        rec.marker = lambda phase, t: marks.append(
            (_frontier(stream), phase, t))
        # one block of the warm-up's peak, freed at once: the capture's
        # allocations carve it up and merge back into it. Without it each
        # new size opens a segment of its own (FEM: 12 GB of segments for
        # the sweep's ~4.4 GB)
        _reserve(need, device)
        out = sweep(Lh, Dinv)
    t_end = time.perf_counter()
    gemm_launches = _block_gemm.launches - launches0
    gemm_plans = collections.Counter(_block_gemm.plans) - plans0
    kernels = kernel_census(graph)
    gid = next(_GRAPH_IDS)
    phases = (graphmap.register(_phase_map(graph, gid, marks, rec.ops))
              if marks else None)
    t1 = time.perf_counter()
    graph.instantiate()
    torch.cuda.synchronize(device)
    capture_ms = ((t_end - t0) + (time.perf_counter() - t1)) * 1e3
    return GraphRunner(graph=graph, sweep=sweep, Lh=Lh, Dinv=Dinv, out=out,
                       batched=batched, gate=gate, warmup_ms=warmup_ms,
                       capture_ms=capture_ms, kernels=kernels,
                       gemm_launches=gemm_launches, gemm_plans=gemm_plans,
                       ops=rec.ops, gid=gid, phases=phases)
