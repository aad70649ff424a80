"""The records of one executed sweep — the port's counterpart of
``repro/core/hlo_ir.py``.

The JAX package checks its communication in the program XLA compiles: it
parses the jaxpr, the StableHLO and the optimized HLO into collective ops
(``hlo_ir.CollectiveOp``) and holds them to the plan
(``hlo_verify.py``). The port compiles no program text — its sweeps are
Python loops that launch kernels, or CUDA graphs captured from those
loops — so its verifier reads what the loops *execute* instead. Two
layers of records:

* **executed permutes** — while :func:`record` is active, every executor
  reports each permute it runs, as one :class:`ExecutedOp` (the twin of
  ``hlo_ir.CollectiveOp``): the overlapped executor's coalesced permute
  a round (``pselinv_dist._permute_lanes``, and ``_rank_permute`` between
  rank processes), the level-serial executor's tree rounds
  (``pselinv_dist._move``, non-local phases only; the ranked
  ``make_sweep_ranked`` too), the stream's comm slot a step
  (``pselinv_dist._ship_slot``). The records are made from host lists
  kept at upload, so recording reads nothing back from the card and may
  run inside a CUDA-graph capture. ``comm.p2p.all_gather`` and
  ``reduce_scatter`` report themselves as collectives — stray ones, on a
  hot path whose design is point-to-point rounds. With no recorder
  active a hook costs one ``None`` test a round.
* **phase marks** — the overlapped executor calls :func:`mark` where
  each phase of the sweep starts (``arena.init``, a compute op, a lane
  move, ``arena.finish``), with its round. A record whose ``marker`` is
  set passes each mark on: ``capture.capture`` reads the capture's node
  frontier there, which maps the graph's nodes to phases and rounds
  (:mod:`repro_torch.obs.graphmap`). Without a marker a mark costs the
  same ``None`` test.
* **the op layer** — :func:`ops_layer`, a ``TorchDispatchMode`` active
  for one eager sweep, sees every ATen op the sweep dispatches and notes
  an f64 value narrowed to a smaller float (``_to_copy``, ``copy_``
  across dtypes), a host transfer (``_local_scalar_dense``, a copy
  between the card and the host) and the c10d collectives the dispatcher
  shows. It is never entered inside a capture. The pinned-memory staging
  of ``comm.p2p`` (the ranked sweep's transport on the card, by design)
  runs under :func:`staging` and is noted as staged bytes, which the
  verifier checks against ``p2p.LOG`` instead of flagging them.

:func:`from_send_log` turns the ranks' ``comm.p2p.LOG`` entries
(``(round, src, dst, nbytes)``) into the same :class:`ExecutedOp` records,
so one checker reads a single-process sweep and a multi-process one.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch

__all__ = ["DTYPE_BYTES", "ExecutedOp", "HostNote", "Record", "record",
           "active", "mark", "ops_layer", "staging", "from_send_log",
           "dtype_name"]

#: bytes of an element, by the HLO dtype names the JAX records use
DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8,
               "s32": 4, "s16": 2, "s8": 1, "u8": 1, "pred": 1}
_NAMES = {torch.float64: "f64", torch.float32: "f32",
          torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
          torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}
_BY_SIZE = {8: "f64", 4: "f32", 2: "bf16"}


def dtype_name(dtype: torch.dtype) -> str:
    """The HLO name of a torch dtype (``torch.float64`` → ``"f64"``)."""
    return _NAMES.get(dtype, str(dtype).replace("torch.", ""))


@dataclass(frozen=True)
class ExecutedOp:
    """One communication op a sweep executed: ``op`` in the HLO dash
    vocabulary (``collective-permute``, ``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``), its (src, dst) rank ``pairs``
    (permutes only), one rank's payload ``dims`` and ``dtype``, ``where``
    it belongs in the plan (the plan label ``hlo_verify`` uses: ``round
    t``, ``level L phase[i]``, ``comm slot s``), the ``executor`` that ran
    it (``overlap``, ``exec``, ``stream``, ``ranked``, or ``p2p`` for a
    collective), and the stream ``step`` (or the send log's round
    number) it ran at."""
    op: str
    pairs: Optional[Tuple[Tuple[int, int], ...]]
    dims: Tuple[int, ...]
    dtype: str
    where: str
    executor: str
    step: Optional[int] = None

    @property
    def nbytes(self) -> int:
        """One rank's payload bytes."""
        return math.prod(self.dims) * DTYPE_BYTES.get(self.dtype, 8)


@dataclass(frozen=True)
class HostNote:
    """One finding of the op layer: ``kind`` is ``precision-loss``,
    ``host-transfer``, ``stray-collective`` or ``staged`` (a transfer of
    ``comm.p2p``'s staging, exempt and counted in ``nbytes``); ``op`` the
    ATen or c10d op, ``detail`` what it did."""
    kind: str
    op: str
    detail: str
    nbytes: int = 0


@dataclass
class Record:
    """What one recorded sweep executed: its communication ops, in
    order, and — when the op layer ran — its notes and the number of ops
    it dispatched. ``marker``, when set, receives each phase mark
    ``(phase, round)`` of the sweep (:func:`mark`)."""
    ops: List[ExecutedOp] = field(default_factory=list)
    notes: List[HostNote] = field(default_factory=list)
    dispatched: Optional[int] = None
    marker: Optional[Callable[[str, int], None]] = None

    def permute(self, where: str, executor: str,
                pairs: Iterable[Tuple[int, int]], dims: Sequence[int],
                dtype: torch.dtype, step: Optional[int] = None) -> None:
        self.ops.append(ExecutedOp(
            op="collective-permute",
            pairs=tuple((int(s), int(d)) for s, d in pairs),
            dims=tuple(int(x) for x in dims), dtype=dtype_name(dtype),
            where=where, executor=executor, step=step))

    def collective(self, op: str, x: torch.Tensor) -> None:
        self.ops.append(ExecutedOp(
            op=op, pairs=None, dims=tuple(x.shape),
            dtype=dtype_name(x.dtype), where="", executor="p2p"))

    def permutes(self) -> List[ExecutedOp]:
        return [op for op in self.ops if op.op == "collective-permute"]


_tls = threading.local()


def active() -> Optional[Record]:
    """This thread's active record, or None."""
    return getattr(_tls, "rec", None)


def mark(phase: str, t: int) -> None:
    """The sweep's next device work belongs to ``phase`` of round ``t``:
    passed to the active record's ``marker``; nothing without one."""
    rec = getattr(_tls, "rec", None)
    if rec is not None and rec.marker is not None:
        rec.marker(phase, t)


@contextmanager
def record(rec: Optional[Record] = None):
    """Record every permute (and stray collective) the executors run in
    this thread until the block ends; yields the :class:`Record`."""
    rec = Record() if rec is None else rec
    prev = getattr(_tls, "rec", None)
    _tls.rec = rec
    try:
        yield rec
    finally:
        _tls.rec = prev


@contextmanager
def staging():
    """Mark the copies inside the block as ``comm.p2p``'s staging of a
    payload through pinned host memory: the op layer counts them as
    staged bytes, not as host transfers."""
    prev = getattr(_tls, "staging", False)
    _tls.staging = True
    try:
        yield
    finally:
        _tls.staging = prev


# c10d ops the dispatcher shows: point-to-point ones are the permutes'
# transport; every other one is a collective, named in the HLO vocabulary
_P2P = {"send", "recv_", "recv_any_source_"}
_C10D_NAMES = {"allgather": "all-gather", "allreduce": "all-reduce",
               "reduce_scatter": "reduce-scatter", "alltoall": "all-to-all"}
_NARROW = {torch.float32, torch.bfloat16, torch.float16}


def _c10d_name(op: str) -> str:
    base = op.strip("_")
    for key, name in _C10D_NAMES.items():
        if key in base:
            return name
    return base


def _host_side(a: torch.device, b: torch.device) -> bool:
    """A copy between the card and the host."""
    return {a.type, b.type} == {"cpu", "cuda"}


class _OpLayer(torch.utils._python_dispatch.TorchDispatchMode):
    """The op layer: notes precision loss, host transfers and c10d
    collectives among the ops one eager sweep dispatches."""

    def __init__(self, rec: Record):
        super().__init__()
        self.rec = rec

    def _note(self, kind, op, detail, nbytes=0):
        self.rec.notes.append(HostNote(kind, op, detail, nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.rec.dispatched += 1
        name = str(func)                     # e.g. "aten._to_copy.default"
        ns, _, rest = name.partition(".")
        op = rest.split(".")[0]
        if ns == "c10d":
            if op not in _P2P and op != "barrier":
                self._note("stray-collective", name,
                           f"{_c10d_name(op)} ({op})")
        elif op == "_local_scalar_dense":
            self._note("host-transfer", name, "a value read to the host")
        elif op in ("_to_copy", "copy_"):
            if op == "_to_copy":
                src = args[0]
                dst_dtype = kwargs.get("dtype") or src.dtype
                dst_dev = kwargs.get("device") or src.device
            else:
                dst, src = args[0], args[1]
                dst_dtype, dst_dev = dst.dtype, dst.device
            if isinstance(src, torch.Tensor):
                if src.dtype == torch.float64 and dst_dtype in _NARROW:
                    self._note("precision-loss", name,
                               f"f64 -> {dtype_name(dst_dtype)} of "
                               f"{tuple(src.shape)}")
                if _host_side(src.device, torch.device(dst_dev)):
                    nbytes = src.numel() * src.element_size()
                    if getattr(_tls, "staging", False):
                        self._note("staged", name, "p2p staging", nbytes)
                    else:
                        self._note("host-transfer", name,
                                   f"{src.device} -> {dst_dev} of "
                                   f"{tuple(src.shape)}", nbytes)
        return func(*args, **kwargs)


@contextmanager
def ops_layer(rec: Optional[Record] = None):
    """The op layer over the block — one eager sweep: every dispatched
    op counted in ``rec.dispatched`` and classified into ``rec.notes``.
    Refused inside a CUDA-graph capture (a dispatch mode there would run
    Python per captured op and could synchronize)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the op layer runs on an eager sweep, never "
                           "inside a CUDA-graph capture")
    rec = active() if rec is None else rec
    if rec is None:
        raise RuntimeError("ops_layer needs a record: use it inside "
                           "record()")
    rec.dispatched = rec.dispatched or 0
    with _OpLayer(rec):
        yield rec


def from_send_log(entries: Iterable[Tuple[int, int, int, int]],
                  rounds: Sequence[str], *,
                  itemsize: int = 8) -> List[ExecutedOp]:
    """The executed permutes of a multi-process sweep, from its ranks'
    send logs (``comm.p2p.LOG.entries``: ``(round, src, dst, nbytes)``,
    each message logged by its sender and by its receiver; duplicates
    merge): one :class:`ExecutedOp` a round and payload size, its pairs
    the union over the ranks, its payload ``nbytes // itemsize``
    elements of the type of that size. ``rounds`` names the plan entry of
    each log round in order (every rank numbers a round alike); a round
    past it is labelled by its number and matches no plan entry."""
    by_round: Dict[int, Dict[int, set]] = {}
    for r, s, d, n in entries:
        by_round.setdefault(int(r), {}).setdefault(int(n), set()).add(
            (int(s), int(d)))
    dtype = _BY_SIZE.get(itemsize, "f64")
    ops = []
    for r in sorted(by_round):
        where = rounds[r] if r < len(rounds) else f"log round {r}"
        for n, pairs in sorted(by_round[r].items()):
            # a size that is no whole number of elements stays in bytes
            whole = n % itemsize == 0
            ops.append(ExecutedOp(
                op="collective-permute", pairs=tuple(sorted(pairs)),
                dims=(n // itemsize if whole else n,),
                dtype=dtype if whole else "u8", where=where,
                executor="ranked", step=r))
    return ops
