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
one replay launches, counted without running it."""
from __future__ import annotations

import collections
import ctypes
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..kernels import block_gemm as _block_gemm

__all__ = ["GraphRunner", "ReplayGate", "capture", "kernel_census",
           "pool_bytes"]

#: ``CUgraphNodeType`` of a kernel node
_KERNEL_NODE = 0
_driver = None


def _libcuda():
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for name in ("cuGraphGetNodes", "cuGraphNodeGetType",
                     "cuGraphKernelNodeGetParams_v2", "cuFuncGetName"):
            getattr(lib, name).restype = ctypes.c_int
        _driver = lib
    return _driver


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def kernel_census(graph: "torch.cuda.CUDAGraph") -> collections.Counter:
    """The kernel nodes of a captured graph (kept with
    ``keep_graph=True``), counted by the mangled name of their
    function."""
    cu = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names: collections.Counter = collections.Counter()
    kind = ctypes.c_int(-1)
    # CUDA_KERNEL_NODE_PARAMS_v2 opens with the CUfunction; the rest of
    # the struct is read into the buffer and ignored
    params = (ctypes.c_char * 256)()
    name = ctypes.c_char_p()
    for node in nodes:
        node = ctypes.c_void_p(node)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        _check(cu.cuGraphKernelNodeGetParams_v2(node, params),
               "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p.from_buffer(params).value
        _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)),
               "cuFuncGetName")
        names[(name.value or b"").decode()] += 1
    return names


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
    (``gemm_launches``) and their plans (``gemm_plans``). ``sweep`` is
    the captured sweep: it holds the device tables whose addresses the
    graph's kernels read, so they live as long as the runner."""
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
    replays: int = 0

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
            if self.batched and n < self.Lh.shape[0]:
                self.Lh[:n].copy_(Lh)
                self.Dinv[:n].copy_(Dinv)
                self.Lh[n:].zero_()
                self.Dinv[n:].zero_()
            else:
                self.Lh.copy_(Lh)
                self.Dinv.copy_(Dinv)
            self.graph.replay()
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
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
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
    t1 = time.perf_counter()
    graph.instantiate()
    torch.cuda.synchronize(device)
    capture_ms = ((t_end - t0) + (time.perf_counter() - t1)) * 1e3
    return GraphRunner(graph=graph, sweep=sweep, Lh=Lh, Dinv=Dinv, out=out,
                       batched=batched, gate=gate, warmup_ms=warmup_ms,
                       capture_ms=capture_ms, kernels=kernels,
                       gemm_launches=gemm_launches, gemm_plans=gemm_plans)
