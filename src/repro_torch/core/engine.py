"""PSelInvEngine — the analyze / prepare / solve session API of the
PyTorch port (counterpart of ``repro/core/engine.py``).

    engine = PSelInvEngine.analyze(A_or_structure, b=8, grid=Grid(4, 2))
    out = engine.solve(A)                  # value-only hot path

``analyze`` performs symbolic analysis → CommPlan IR → the executor's
schedule → PlanLint → per-rank index tables uploaded to the session's
device **once**, and caches the session keyed on (block-structure hash,
supernode width, grid, :class:`PlanOptions`, device). ``solve`` moves
values only: the host numeric factorization (when given a matrix), one
host→device copy of the value shards, and the sweep — no table copy and
no read-back inside it. On the card each shape class of a solve —
(batched, B, dtype) — is captured once as a CUDA graph
(:mod:`.capture`; the counterpart of the JAX engine's one compile per
class) and every later solve of the class is one replay; on the CPU the
sweep runs eagerly. The options pick the executor, as in the JAX
engine: the overlapped round schedule by default,
``PlanOptions(overlap=False)`` the level-serial sweep,
``PlanOptions(stream=True)`` the uniform round stream.
``round_schedule``/``simulate`` give the α-β model's view of the
session's schedule, ``profile_rounds`` a measured per-round replay.

All ``P = pr·pc`` ranks of the grid run on the one device as a leading
rank axis of every tensor (see ``pselinv_dist``); a batch of B
same-structure matrices is one more axis in front (``(B, P, nbr, nbc, b,
b)``), sharing the tables. ``bucket=True`` pads a batch to the next power
of two, as the JAX engine does for its compiled-program population.

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain versions of the kernels
on the host (the tests do)."""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (ClassVar, Dict, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..kernels import block_gemm as _block_gemm
from ..obs.registry import REGISTRY
from ..obs.trace import TRACER
from .capture import GraphRunner, ReplayGate, capture, pool_bytes
from .device import resolve_device
from .plan import PlanOptions, peak_arena_blocks, ppermute_round_count
from .pselinv_dist import (ExecTables, PSelInvProgram, StreamSweepTables,
                           SweepTables, analyze_structure, build_program,
                           make_sweep, make_sweep_overlapped,
                           make_sweep_stream, pad_nb, prepare_values,
                           moved_blocks, prepare_values_many,
                           upload_exec_tables, upload_stream_tables,
                           upload_tables, validate_uniform_widths)
from .schedule import BYTES_PER_ELT, Grid2D
from .stream import COMP_GEMM, stream_shifts_per_round, stream_wire_bytes
from .supernodal_lu import LUFactors, get_backend
from .symbolic import BlockStructure

__all__ = ["Grid", "PlanOptions", "PSelInvEngine", "SolveValues",
           "structure_key", "stack_values", "bucket_size",
           "values_from_numpy", "lu_from_numpy", "resolve_device"]

#: the session API's name for the 2-D process grid
Grid = Grid2D


class SolveValues(NamedTuple):
    """One matrix's numeric payload in shard layout: ``Lh`` and ``Dinv``
    shaped (P, nbr, nbc, b, b) — or (B, P, nbr, nbc, b, b) with a
    leading batch axis — as tensors on the session's device."""
    Lh: torch.Tensor
    Dinv: torch.Tensor


def values_from_numpy(Lh, Dinv, device="cuda",
                      dtype: torch.dtype | None = None) -> SolveValues:
    """The JAX package's value shards (numpy, ``(…, P, nbr, nbc, b, b)``)
    as the port's tensors on ``device`` — so both packages solve the same
    inputs. ``dtype=None`` keeps the arrays' own precision."""
    dev = resolve_device(device)

    def conv(x):
        t = torch.as_tensor(np.ascontiguousarray(x))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return SolveValues(conv(Lh), conv(Dinv))


def lu_from_numpy(lu, backend: str = "cuda", device=None,
                  dtype: torch.dtype | None = None) -> LUFactors:
    """The JAX package's ``LUFactors`` (numpy blocks, or anything with the
    same ``bs``/``Ldiag``/``Udiag``/``L``/``U`` fields) as the port's, with
    every block a backend array — so ``selinv`` of both packages runs on
    identical factors."""
    be = get_backend(backend, device, dtype)
    blocks = {name: {key: be.asarray(np.asarray(val))
                     for key, val in getattr(lu, name).items()}
              for name in ("Ldiag", "Udiag", "L", "U")}
    return LUFactors(bs=lu.bs, backend=backend,
                     device=getattr(be, "device", None),
                     dtype=getattr(be, "dtype", None), **blocks)


def stack_values(values: Sequence[SolveValues]) -> SolveValues:
    """Stack per-matrix :class:`SolveValues` along a new leading batch
    axis (same structure, many matrices)."""
    return SolveValues(torch.stack([v.Lh for v in values]),
                       torch.stack([v.Dinv for v in values]))


def structure_key(bs: BlockStructure) -> str:
    """Content hash of a block structure — the value-independent part of
    the engine cache key (the same sha1 as the JAX engine's)."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(bs.offsets, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(bs.parent, dtype=np.int64).tobytes())
    for s in bs.struct:
        h.update(np.ascontiguousarray(s, dtype=np.int64).tobytes())
        h.update(b"|")
    return h.hexdigest()


def bucket_size(B: int) -> int:
    """The padded batch bucket for B matrices: the next power of two."""
    if B < 1:
        raise ValueError(f"batch size must be >= 1, got {B}")
    return 1 << (B - 1).bit_length()


def _approx_nbytes(obj, _seen=None, _depth=0) -> int:
    """Approximate resident bytes of a program/table object: the sum of
    every reachable numpy array's ``nbytes`` (dataclasses, dicts, lists,
    tuples walked; shared arrays counted once)."""
    if _seen is None:
        _seen = set()
    if _depth > 16 or id(obj) in _seen:
        return 0
    if isinstance(obj, np.ndarray):
        _seen.add(id(obj))
        return int(obj.nbytes)
    if isinstance(obj, (str, bytes, int, float, bool, complex,
                        type(None))):
        return 0
    _seen.add(id(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_approx_nbytes(getattr(obj, f.name), _seen, _depth + 1)
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(_approx_nbytes(v, _seen, _depth + 1)
                   for v in obj.values())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_approx_nbytes(v, _seen, _depth + 1) for v in obj)
    return 0


def _is_matrix(x) -> bool:
    """A numeric matrix (dense 2-D array or scipy sparse) as opposed to
    prepared value shards."""
    import scipy.sparse as sp
    if sp.issparse(x):
        return True
    return isinstance(x, np.ndarray) and x.ndim == 2


@dataclass
class PSelInvEngine:
    """One selected-inversion session: structure + grid + options bound
    to device tables. Construct through :meth:`analyze`."""
    bs: BlockStructure
    b: int
    nb: int
    grid: Grid2D
    options: PlanOptions
    program: PSelInvProgram
    device: torch.device
    tables: Union[SweepTables, ExecTables, StreamSweepTables]
    key: Tuple = ()
    #: runner builds, one for each shape class (batched, B, dtype) the
    #: session has solved: on the card each is a CUDA-graph capture, on
    #: the CPU an eager sweep closure. The twin of the JAX engine's trace
    #: counter (its "solve does not retrace" handle), kept under its name
    #: so the serving layer ports line for line: flat on a warm class.
    trace_count: int = 0
    solve_calls: int = 0
    _fns: Dict[Tuple, object] = field(default_factory=dict, repr=False)
    _compile_metrics: Dict[Tuple, Dict[str, object]] = \
        field(default_factory=dict, repr=False)
    _jit_lock: threading.RLock = field(default_factory=threading.RLock,
                                       repr=False)
    _pool: object = field(default=None, repr=False)
    _gate: Optional[ReplayGate] = field(default=None, repr=False)
    _table_bytes: Optional[int] = field(default=None, repr=False)
    _overlap_tables: Optional[SweepTables] = field(default=None,
                                                   repr=False)
    _round_schedule: object = field(default=None, repr=False)
    _last_solve_us: Optional[float] = field(default=None, repr=False)
    _last_prepare_us: Optional[float] = field(default=None, repr=False)

    # ---- the structure cache (class-level, all sessions) --------------
    _cache: ClassVar["OrderedDict[Tuple, PSelInvEngine]"] = OrderedDict()
    _cache_lock: ClassVar[threading.Lock] = threading.Lock()
    #: LRU eviction bounds, as in the JAX engine: session count and the
    #: summed per-engine table footprint (host tables + device tables)
    cache_max: ClassVar[int] = 16
    cache_max_bytes: ClassVar[int] = 1 << 30
    cache_hits: ClassVar[int] = 0
    cache_misses: ClassVar[int] = 0
    cache_evictions: ClassVar[int] = 0

    @classmethod
    def analyze(cls, structure_or_A, b: int, grid: Grid2D,
                options: PlanOptions = PlanOptions(), *,
                device="cuda", verify: str | None = None,
                verify_compiled: str | None = None) -> "PSelInvEngine":
        """Symbolic analysis → CommPlan → schedule → PlanLint → device
        tables, **once per structure and device**. Accepts a matrix
        (symbolically factorized here) or a ready
        :class:`BlockStructure`; returns the cached engine when an
        identical (structure, b, grid, options, device) session exists.
        ``verify`` overrides ``options.verify`` (the PlanLint mode);
        ``verify_compiled`` must stay ``"off"`` (HloLint is not ported).

        The options pick the executor whose tables are uploaded: the
        overlapped round schedule (default), the level-serial sweep
        (``overlap=False``) or the uniform round stream
        (``stream=True``); ``stream=True`` with ``overlap=False`` raises
        ``ValueError``, as in the JAX engine."""
        dev = resolve_device(device)
        if verify is not None:
            options = dataclasses.replace(options, verify=verify)
        if verify_compiled is not None:
            options = dataclasses.replace(options,
                                          verify_compiled=verify_compiled)
        with TRACER.span("engine.analyze", b=b,
                         grid=f"{grid.pr}x{grid.pc}") as sp:
            if isinstance(structure_or_A, BlockStructure):
                bs = structure_or_A
                validate_uniform_widths(bs, b)
                nb = pad_nb(bs.nsuper, grid.pr, grid.pc)
            else:
                with TRACER.span("analyze.symbolic"):
                    bs, nb = analyze_structure(structure_or_A, b,
                                               grid.pr, grid.pc)
            sp.set(nb=nb)

            key = (structure_key(bs), b, grid, options, str(dev))
            with cls._cache_lock:
                hit = cls._cache.get(key)
                if hit is not None:
                    cls.cache_hits += 1
                    cls._cache.move_to_end(key)  # LRU: a hit stays warm
                    sp.set(cache="hit")
                    return hit
                cls.cache_misses += 1
            sp.set(cache="miss")

            program = build_program(bs, nb, b, grid.pr, grid.pc,
                                    options=options)
            with TRACER.span("analyze.upload"):
                upload = (upload_stream_tables if options.stream
                          else upload_tables if options.overlap
                          else upload_exec_tables)
                tables = upload(program, dev)
            engine = cls(bs=bs, b=b, nb=nb, grid=grid, options=options,
                         program=program, device=dev, tables=tables,
                         key=key)
        with cls._cache_lock:
            # somebody may have raced us past the miss above; keep the
            # first published session so `analyze` stays idempotent
            engine = cls._cache.setdefault(key, engine)
            cls._cache.move_to_end(key)
            cls._evict_locked()
        return engine

    @classmethod
    def _evict_locked(cls) -> None:
        """LRU eviction under ``_cache_lock``: pop the front while the
        session count exceeds ``cache_max`` or the summed table bytes
        exceed ``cache_max_bytes`` — keeping at least the most recent
        session so one over-budget structure still solves."""
        def over():
            if len(cls._cache) > cls.cache_max:
                return True
            return sum(e.table_bytes()
                       for e in cls._cache.values()) > cls.cache_max_bytes
        while len(cls._cache) > 1 and over():
            cls._cache.popitem(last=False)
            cls.cache_evictions += 1

    @classmethod
    def cache_bytes(cls) -> int:
        with cls._cache_lock:
            return sum(e.table_bytes() for e in cls._cache.values())

    @classmethod
    def clear_cache(cls) -> None:
        with cls._cache_lock:
            cls._cache.clear()
            cls.cache_hits = cls.cache_misses = 0
            cls.cache_evictions = 0

    # ---- the sweep -----------------------------------------------------
    def sweep(self, batched: bool = False):
        """The session's eager sweep (per its :class:`PlanOptions`
        executor) over its device tables — what a runner captures, and
        what ``profile_rounds`` and per-launch counts run. Single-matrix
        signature: (Lh, Dinv) each (P, nbr, nbc, b, b); batched: (B, P,
        nbr, nbc, b, b)."""
        if self.options.stream:
            mk = make_sweep_stream
        elif self.options.overlap:
            mk = make_sweep_overlapped
        else:
            mk = make_sweep
        return mk(self.program, self.tables, batched=batched)

    # ---- one runner per shape class (batched, B, dtype) ---------------
    def _class_shape(self, batched: bool, B: int) -> Tuple[int, ...]:
        return ((int(B),) if batched else ()) + (
            self.grid.size, self.nb // self.grid.pr,
            self.nb // self.grid.pc, self.b, self.b)

    def _build_runner(self, batched: bool, B: int, dtype: torch.dtype):
        """A fresh runner for one shape class. On the card: the sweep
        captured as a CUDA graph into the session's one graph memory pool
        (every graph of the session replays through one gate, so their
        shared temporaries never meet). On the CPU: the eager sweep, a
        short batch padded with zero lanes."""
        sweep = self.sweep(batched)
        if self.device.type == "cuda":
            with self._jit_lock:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                    self._gate = ReplayGate(self._jit_lock)
                with TRACER.span("engine.capture", batched=batched, B=B):
                    return capture(sweep, self._class_shape(batched, B),
                                   dtype, self.device, self._pool,
                                   self._gate, batched)

        def run(Lh, Dinv):
            n = Lh.shape[0] if batched else 1
            if n < B:
                pad = Lh.new_zeros((B - n,) + tuple(Lh.shape[1:]))
                return sweep(torch.cat([Lh, pad]),
                             torch.cat([Dinv, pad]))[:n]
            return sweep(Lh, Dinv)
        return run

    def _runner(self, batched: bool, B: int, dtype: torch.dtype):
        """The shape class's runner, built (and counted in
        ``trace_count``) on its first use, under the session's lock:
        cached sessions are shared, so one builder per class."""
        key = (batched, int(B) if batched else 1, dtype)
        with self._jit_lock:
            fn = self._fns.get(key)
            if fn is None:
                fn = self._build_runner(*key)
                self._fns[key] = fn
                self.trace_count += 1
        return fn

    def jitted(self, batched: bool = False):
        """The session's sweep as one callable ``fn(Lh, Dinv)``: the
        inputs' (B, dtype) picks the shape class, whose runner is built
        on first use (one ``trace_count``) and reused after — on the card
        a replay of the class's CUDA graph. Single-matrix signature:
        (Lh, Dinv) each (P, nbr, nbc, b, b); batched: (B, P, nbr, nbc, b,
        b), the tables shared by every lane."""
        def fn(Lh, Dinv):
            return self._runner(batched, Lh.shape[0] if batched else 1,
                                Lh.dtype)(Lh, Dinv)
        return fn

    def aot_compile(self, batch_size: int = 1,
                    dtype: torch.dtype = torch.float32, *,
                    batched: bool = True):
        """A fresh runner for one exact shape class, *uncounted* (the
        ``trace_count`` handle never moves) and not kept by the session:
        on the card the sweep captured as a CUDA graph over its own
        static buffers, on the CPU the eager sweep. The counterpart of
        the JAX engine's AOT-compiled executable, with one difference: a
        CUDA graph cannot be serialized — it lives in this process, on
        this device — so the serving layer's disk cache
        (:mod:`repro_torch.serve.progcache`) persists the analyzed
        program and captures anew after a restart."""
        return self._build_runner(batched, int(batch_size) if batched
                                  else 1, dtype)

    def overlap_tables(self) -> SweepTables:
        """The overlapped schedule's device tables, which the profiling
        replay runs: the session's own for an overlapped session,
        uploaded once on first use for a stream session (its tables were
        lowered from that schedule)."""
        if self.program.overlap_plan is None:
            raise ValueError(
                "profile_rounds needs an overlapped schedule — analyze "
                "with PlanOptions(overlap=True) (default) or stream=True")
        if isinstance(self.tables, SweepTables):
            return self.tables
        if self._overlap_tables is None:
            self._overlap_tables = upload_tables(self.program, self.device)
        return self._overlap_tables

    # ---- the value-only hot path --------------------------------------
    def prepare_values(self, A, dtype: torch.dtype | None = None
                       ) -> SolveValues:
        """Numeric host factorization of one matrix against the cached
        structure → shards on the session's device (f64 unless
        ``dtype``). No symbolic work."""
        t0 = time.perf_counter()
        with TRACER.span("engine.prepare_values"):
            Lh, Dinv = prepare_values(A, self.bs, self.nb, self.b,
                                      self.grid.pr, self.grid.pc)
            out = values_from_numpy(Lh, Dinv, self.device, dtype)
        self._last_prepare_us = (time.perf_counter() - t0) * 1e6
        return out

    def prepare_values_many(self, mats: Sequence,
                            dtype: torch.dtype | None = None
                            ) -> SolveValues:
        """Batched numeric host factorization of B same-structure
        matrices → stacked (B, P, nbr, nbc, b, b) shards on the device,
        in one structure-driven pass."""
        t0 = time.perf_counter()
        with TRACER.span("engine.prepare_values_many", B=len(mats)):
            Lh, Dinv = prepare_values_many(mats, self.bs, self.nb,
                                           self.b, self.grid.pr,
                                           self.grid.pc)
            out = values_from_numpy(Lh, Dinv, self.device, dtype)
        self._last_prepare_us = (time.perf_counter() - t0) * 1e6
        return out

    def _as_tensor(self, x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=dtype or x.dtype)

    def solve(self, values, dtype: torch.dtype | None = torch.float32, *,
              bucket: bool = False) -> torch.Tensor:
        """Selected inversion of one matrix — or a whole batch.

        ``values`` is a matrix (numeric-factorized here against the
        cached structure), a :class:`SolveValues`, or a plain
        ``(Lh, Dinv)`` pair of tensors or numpy arrays. Rank 5 ((P, nbr,
        nbc, b, b)) solves one matrix; rank 6 ((B, P, nbr, nbc, b, b))
        solves B same-structure matrices through one sweep. Returns the
        A⁻¹ shards in the same layout, as a tensor on the session's
        device. ``dtype`` casts the values (f32 default, as the JAX
        engine); ``None`` keeps their own dtype.

        ``bucket=True`` pads a batched solve up to the next power-of-2
        bucket (:func:`bucket_size`) with zero-valued lanes and slices
        the real results back out, so batches of 3 and 4 share one class.

        The solve runs through its shape class's runner (:meth:`jitted`):
        on the card one replay of the class's CUDA graph, captured on the
        class's first solve; on the CPU the eager sweep. The result is a
        tensor of its own, which no later solve overwrites."""
        if _is_matrix(values):
            values = self.prepare_values(values)
        Lh, Dinv = (self._as_tensor(v, dtype) for v in values)
        if Lh.ndim not in (5, 6):
            raise ValueError(
                f"values must be rank 5 (single) or rank 6 (leading "
                f"batch axis), got shape {tuple(Lh.shape)}")
        batched = Lh.ndim == 6
        B = Lh.shape[0] if batched else 1
        self.solve_calls += 1
        t0 = time.perf_counter()
        with TRACER.span("engine.solve", B=B):
            out = self._runner(batched, bucket_size(B) if batched and bucket
                               else B, Lh.dtype)(Lh, Dinv)
        # dispatch wall, not device wall: the caller synchronizes
        self._last_solve_us = (time.perf_counter() - t0) * 1e6
        return out

    def solve_many(self, mats: Sequence,
                   dtype: torch.dtype | None = torch.float32, *,
                   bucket: bool = False,
                   batched_prep: bool = True) -> torch.Tensor:
        """Numeric-factorize each same-structure matrix, stack along the
        batch axis, and run ONE batched solve. ``batched_prep`` routes
        the host factorization through :meth:`prepare_values_many`;
        ``bucket`` pads the batch to its power-of-2 bucket."""
        if batched_prep and len(mats) > 1:
            vals = self.prepare_values_many(mats)
        else:
            vals = stack_values([self.prepare_values(A) for A in mats])
        return self.solve(vals, dtype=dtype, bucket=bucket)

    def table_bytes(self) -> int:
        """Approximate resident bytes of this session's tables: the host
        program's numpy arrays plus the device tables."""
        if self._table_bytes is None:
            self._table_bytes = (_approx_nbytes(self.program)
                                 + self.tables.nbytes)
        return self._table_bytes

    def gemm_ops(self) -> int:
        """Level-GEMM compute ops per solve — one kernel launch each: a
        level each for the level-serial sweep, the GEMM compute slots of
        the stream, the GEMM ops of the overlapped schedule."""
        if self.options.stream:
            return int((self.program.stream_tables.comp_kind
                        == COMP_GEMM).sum())
        if not self.options.overlap:
            return len(self.program.exec_plan.levels)
        return sum(1 for ops in self.program.overlap_plan.compute_at
                   for op in ops if op.kind == "gemm")

    # ---- plan introspection and the measured replay ----------------------
    def round_schedule(self):
        """The cached program's executed
        :class:`~.simulator.RoundSchedule` (built once, then reused)."""
        if self._round_schedule is None:
            from .simulator import round_schedule_of
            self._round_schedule = round_schedule_of(self.program)
        return self._round_schedule

    def simulate(self, model=None):
        """α-β model timing of the session's schedule
        (:func:`~.simulator.simulate_schedule` on :meth:`round_schedule`;
        the default :class:`~.simulator.NetworkModel` is a Cray XC30, so
        these are the model's times, not the card's)."""
        from .simulator import simulate_schedule
        return simulate_schedule(self.round_schedule(), model)

    def profile_rounds(self, values, *, chunk: int = 1, reps: int = 3,
                       dtype: torch.dtype = torch.float32, model=None):
        """Measured per-round timeline of this session's overlapped
        schedule: the sweep re-run as per-round segments, each fenced
        with ``torch.cuda.synchronize()`` on the card, joined against the
        plan's wire tables — residuals against the α-β model, the
        per-rank inbound skew, and fitted α/β. Returns a
        :class:`~repro_torch.obs.rounds.RoundProfile`; see
        :func:`repro_torch.obs.rounds.profile_rounds` for the knobs;
        ``dtype`` casts the values (f32 default, as the JAX engine). The
        replay runs the fused sweep's own code, so its A⁻¹ is the
        solve's in the same dtype, bit for bit."""
        from ..obs.rounds import profile_rounds
        return profile_rounds(self, values, chunk=chunk, reps=reps,
                              dtype=dtype, model=model)

    # ---- what the sweep moves, and the compile surface ----------------
    def moved(self) -> Tuple[int, float]:
        """(rounds, bytes) the session's sweep moves between ranks, read
        off its device tables (:func:`~.pselinv_dist.moved_blocks`)
        and priced at ``BYTES_PER_ELT`` an element like the plan's other
        byte figures (an f32 solve moves half)."""
        rounds, blocks = moved_blocks(self.tables)
        return rounds, float(blocks) * self.b * self.b * BYTES_PER_ELT

    def compile_stats(self, batched: bool = False,
                      dtype: torch.dtype = torch.float32,
                      batch_size: int = 1) -> Dict[str, object]:
        """Build metrics of one shape class's runner, measured once and
        cached: ``warmup_ms`` (the eager sweep run before capture) and
        ``capture_ms`` (the capture and the graph's instantiation), both
        host clock ending in a synchronize; ``graph_kernels`` (kernel
        nodes one replay launches) and ``graph_gemm_nodes`` (those of the
        hand-written block GEMM), from the driver's view of the graph;
        ``comm_rounds`` and ``moved_bytes`` (:meth:`moved`). On the CPU
        nothing is captured and the four capture figures are None. The
        class's own runner is read when the session has one, else a
        fresh uncounted one is built (``trace_count`` never moves).

        The JAX engine's ``jaxpr_lines``, ``hlo_bytes`` and
        ``collective_bytes`` have no twin here — there is no traced or
        lowered program text, and the port's collectives are the moves
        ``moved_bytes`` counts — so each is None."""
        key = (batched, int(batch_size) if batched else 1, dtype)
        with self._jit_lock:
            m = self._compile_metrics.get(key)
            if m is not None:
                return m
            r = self._fns.get(key)
            if r is None:
                r = self._build_runner(*key)
            rounds, moved = self.moved()
            cap = isinstance(r, GraphRunner)
            m = {"warmup_ms": r.warmup_ms if cap else None,
                 "capture_ms": r.capture_ms if cap else None,
                 "graph_kernels": r.graph_kernels if cap else None,
                 "graph_gemm_nodes": r.gemm_nodes if cap else None,
                 "comm_rounds": rounds, "moved_bytes": moved,
                 "jaxpr_lines": None, "hlo_bytes": None,
                 "collective_bytes": None}
            self._compile_metrics[key] = m
        return m

    def graph_bytes(self) -> int:
        """Device bytes the session's graphs hold: its graph memory pool
        (temporaries and outputs of every capture) and the static inputs
        of its kept runners; 0 on the CPU."""
        if self._pool is None:
            return 0
        with self._jit_lock:
            static = sum(r.static_bytes for r in self._fns.values())
            return pool_bytes(self._pool, self.device) + static

    def stats(self, compile: bool = False) -> Dict[str, float]:
        """Static schedule metrics of the cached program (ppermute round
        count, peak per-rank arena blocks), cache health, the solve
        counter, the last solve-dispatch and value-prep walls (µs) and
        the GEMM ops per solve. ``moved_bytes`` is what the port's sweep
        moves between ranks per solve (:meth:`moved`).

        Launch counts: ``gemm_launches`` is the process-wide count of the
        block-GEMM wrapper's launches from Python — eager sweeps, the
        warm-up before each capture and the launches a capture records
        — which a replay does not move; ``graph_replays`` counts this
        session's replays, each of which runs every kernel of its graph
        once. ``graph_bytes`` is :meth:`graph_bytes`.

        Stream sessions add ``stream_wire_bytes`` — the bytes the JAX
        stream program's gated permutes ship (every pair of an active
        slot at its full width), kept for parity with the JAX engine and
        not what this port moves — and the mean gated comm slots per
        round (``stream_shifts_per_round``). ``compile=True`` merges
        :meth:`compile_stats` of the f32 single-matrix class, as the JAX
        engine does. Every scalar is published to ``REGISTRY`` under
        ``selinv_engine_*``."""
        ex = (self.program.overlap_plan if self.options.overlap
              else self.program.exec_plan)
        cls = type(self)
        with self._jit_lock:
            replays = sum(r.replays for r in self._fns.values()
                          if isinstance(r, GraphRunner))
        out = {"ppermute_rounds": ppermute_round_count(ex),
               "peak_arena_blocks": peak_arena_blocks(ex),
               "table_bytes": self.table_bytes(),
               "cache_engines": len(cls._cache),
               "cache_hits": cls.cache_hits,
               "cache_misses": cls.cache_misses,
               "cache_evictions": cls.cache_evictions,
               "solve_calls": self.solve_calls,
               "last_solve_us": self._last_solve_us,
               "prepare_us": self._last_prepare_us,
               "gemm_ops_per_solve": self.gemm_ops(),
               "gemm_launches": _block_gemm.launches,
               "graph_replays": replays,
               "graph_bytes": self.graph_bytes(),
               "moved_bytes": self.moved()[1]}
        if self.options.stream:
            st = self.program.stream_tables
            out["stream_wire_bytes"] = stream_wire_bytes(st, self.b)
            out["stream_shifts_per_round"] = stream_shifts_per_round(st)
        if compile:
            out.update(self.compile_stats())
        for k, v in out.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                REGISTRY.gauge(f"selinv_engine_{k}",
                               "engine.stats() gauge").set(v)
        return out
