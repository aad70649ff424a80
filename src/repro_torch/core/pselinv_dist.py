"""Distributed PSelInv on one card — the port of
``repro/core/pselinv_dist.py``'s executors to PyTorch.

The JAX package runs the selected-inversion sweep as one SPMD program
under ``shard_map`` over ``P = pr·pc`` devices. Here every rank is a
*virtual* rank on one device: the per-rank state is one leading ``P``
axis of a single tensor, and a batch of same-structure matrices is one
more axis in front of it (``(B, P, …)``). ``run_distributed`` runs the
overlapped sweep the other way: each rank a process of a
``torch.distributed`` group, holding only its own arena.

  host plan   ``build_program``   CommPlan → level-serial tables, or the
                                  overlapped round schedule (and its
                                  stream lowering) → PlanLint (copies of
                                  the JAX host code)
  upload      ``upload_exec_tables`` / ``upload_tables`` /
              ``upload_stream_tables``  the executor's per-rank index
                                  tables, bounds-checked once, on the
                                  device
  device      ``make_sweep``      level-serial: per elimination-tree
                                  level, tree rounds one after another
              ``make_sweep_overlapped``  table-driven gather / permute /
                                  scatter over a flat ``(B, P, arena, b,
                                  b)`` block arena
              ``make_sweep_stream``  the same rounds from uniform,
                                  round-stacked tables and gated comm
                                  slots
              ``make_sweep_segments``  the overlapped sweep cut at round
                                  boundaries, for ``obs.rounds``
              ``make_sweep_unrolled``  the legacy per-supernode sweep
                                  (``build_program_unrolled``,
                                  ``upload_unrolled_tables``): whole
                                  buffers broadcast and reduced round by
                                  round, one GEMM launch a supernode
  ranks       ``run_distributed`` the overlapped sweep (``rank_tables``,
                                  ``make_sweep_overlapped_ranked``) or the
                                  level-serial one (``rank_exec_tables``,
                                  ``make_sweep_ranked``) or the unrolled
                                  one (``make_sweep_unrolled_ranked``) by
                                  ``pr·pc`` rank processes, its permutes
                                  as ``comm.p2p`` messages

Every executor reports the permutes it runs to an active
:mod:`.exec_ir` record (the executed-communication verifier,
:mod:`.exec_verify`), from host lists kept at upload.

Every executor runs each level's (the unrolled one: each supernode's)
masked GEMM in the hand-written block-GEMM kernel
(``ops.pselinv_round_gemm``). The unrolled sweep reports nothing to the
recorder: the verifier's corpus is the IR executors.

What the SPMD primitives become:

* ``jnp.take(table, axis_index)`` — the whole ``(P, …)`` table, applied
  by advanced indexing; per-rank arena addresses are pre-flattened to
  ``rank·arena_blocks + slot`` so one ``index_select`` serves all ranks.
* ``lax.ppermute(payload, perm)`` — ``moved[:, dst] = payload[:, src]``
  over the rank axis; ranks that receive nothing get zeros, as in JAX.
* ``vmap`` over the batch — the leading ``B`` axis, tables shared.
* ``mode="promise_in_bounds"`` — every table is checked against its
  target's extent once, at upload; the sweep then indexes freely.
* ``.at[…].set`` with duplicate indices — correct only because duplicates
  land in the trash block; the arena uploads assert that, per rank and
  per round, every repeated scatter index is the trash slot.
* ``.at[…].add`` — ``index_add_``; the duplicate entries add exact zeros.
* the level-serial sweep's trash blocks — a round moves only its real
  (src, dst) pairs, so ranks that receive nothing write nothing, and its
  buffers carry no trash block.
* ``lax.cond`` on a stream comm slot's gate — the gate is known at
  upload, so an inactive slot launches nothing.

Symmetric matrices (as the paper's implementation): Û(K,I) = L̂(I,K)ᵀ and
A⁻¹(K,J) = A⁻¹(J,K)ᵀ — both identities hold blockwise for unpivoted LU.
"""
from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm.p2p import ppermute
from ..kernels.ops import pselinv_round_gemm
from ..obs.registry import REGISTRY
from ..obs.trace import TRACER
from . import exec_ir
from .plan import (CommPlan, ExecPlan, OverlappedExec, PlanOptions,
                   build_plan, compile_exec, merge_round_lists,
                   schedule_overlapped, schedule_stream)
from .schedule import Grid2D
from .selinv import normalize_factors
from .stream import COMP_KIND_ID, COMP_NOOP, StreamTables
from .supernodal_lu import factorize
from .symbolic import BlockStructure, symbolic_factorize
from .trees import CommTree, TreeKind, build_tree, stable_hash

__all__ = ["PSelInvProgram", "build_program", "SweepTables",
           "ExecTables", "StreamSweepTables", "upload_tables",
           "upload_exec_tables", "upload_stream_tables", "make_sweep",
           "make_sweep_overlapped", "make_sweep_stream",
           "make_sweep_segments", "rank_tables",
           "make_sweep_overlapped_ranked", "rank_exec_tables",
           "make_sweep_ranked", "CommSlot", "RankRound",
           "build_program_unrolled", "UnrolledTables", "UnrolledIter",
           "upload_unrolled_tables", "make_sweep_unrolled",
           "make_sweep_unrolled_ranked", "unrolled_moved",
           "check_grid_devices", "prepare_step", "COMPUTE_PHASES",
           "prepare_inputs", "run_distributed",
           "validate_uniform_widths", "pad_nb", "analyze_structure",
           "check_values_pattern", "prepare_values", "prepare_values_many",
           "moved_blocks",
           "gather_blocks"]


@dataclass
class PSelInvProgram:
    """A compiled sweep: grid geometry, the CommPlan and its executable
    tables (the overlapped round stream on the main path)."""
    nb: int
    b: int
    pr: int
    pc: int
    kind: TreeKind
    bs: BlockStructure
    plan: Optional[CommPlan] = None
    exec_plan: Optional[ExecPlan] = None
    overlap_plan: Optional[OverlappedExec] = None
    stream_tables: Optional[StreamTables] = None
    iters: Optional[List["_IterSchedule"]] = None

    @property
    def nbr(self) -> int:
        return self.nb // self.pr

    @property
    def nbc(self) -> int:
        return self.nb // self.pc


# ---------------------------------------------------------------------------
# host plan: CommPlan -> schedule -> PlanLint
# ---------------------------------------------------------------------------

def build_program(bs: BlockStructure, nb: int, b: int, pr: int, pc: int,
                  kind: TreeKind = TreeKind.SHIFTED,
                  overlap: bool = False,
                  coalesce_max: int = 8,
                  window: int | None = None,
                  stream: bool = False, *,
                  options: PlanOptions | None = None,
                  verify: str = "error",
                  verify_compiled: str = "off") -> PSelInvProgram:
    """Build the CommPlan IR and compile it to executable tables — the
    host code of ``repro/core/pselinv_dist.py:build_program``, same
    arguments, same tables. ``options`` overrides the loose kwargs.

    ``verify`` runs PlanLint (``core/verify.py``) over every artifact
    just compiled (``"error"`` raises, ``"warn"`` warns, ``"off"``
    skips). ``verify_compiled`` runs the executed-communication verifier
    (``core/exec_verify.py``, the role of the JAX package's HloLint) in
    the same three modes: the program's own sweep runs once on ``meta``
    tensors (no card, no arithmetic) under the recorder and the op
    layer, and its permutes are held to the tables just built. Default
    ``"off"``, as in the JAX package: the pass runs the whole sweep's
    Python once."""
    if options is not None:
        kind, overlap = options.kind, options.overlap
        coalesce_max, window = options.coalesce_max, options.window
        stream = options.stream
        verify = options.verify
        verify_compiled = options.verify_compiled
    if stream and not overlap:
        raise ValueError(
            "stream=True lowers the overlapped round stream — it "
            "requires overlap=True")
    if nb % pr or nb % pc:
        raise ValueError(f"nb={nb} not divisible by grid {pr}x{pc}")
    with TRACER.span("plan.build", nb=nb):
        plan = build_plan(bs, Grid2D(pr, pc), kind, nb=nb)
    ov = st = None
    with TRACER.span("plan.schedule", stream=stream, overlap=overlap):
        if stream:
            ov, st = schedule_stream(plan, coalesce_max=coalesce_max,
                                     window=window, options=options)
        elif overlap:
            ov = schedule_overlapped(plan, coalesce_max=coalesce_max,
                                     window=window, options=options)
        prog = PSelInvProgram(
            nb=nb, b=b, pr=pr, pc=pc, kind=kind, bs=bs, plan=plan,
            exec_plan=None if overlap else compile_exec(plan),
            overlap_plan=ov, stream_tables=st)
    if verify != "off":
        from .verify import enforce_verification, verify_program
        with TRACER.span("plan.verify", mode=verify):
            enforce_verification(
                verify_program(prog), mode=verify,
                where=f"build_program(nb={nb}, grid={pr}x{pc}, "
                      f"stream={stream}, overlap={overlap})")
    if verify_compiled != "off":
        from .exec_verify import lint_program
        from .verify import enforce_verification
        with TRACER.span("plan.verify_compiled", mode=verify_compiled):
            enforce_verification(
                lint_program(prog), mode=verify_compiled,
                where=f"executed sweep of build_program(nb={nb}, "
                      f"grid={pr}x{pc}, stream={stream}, "
                      f"overlap={overlap})")
    return prog


# ---------------------------------------------------------------------------
# device tables: uploaded once per session, bounds-checked once
# ---------------------------------------------------------------------------

@dataclass
class LevelTables:
    """One elimination-tree level's compute tables for all P ranks; the
    masks are bool, applied by selects. On the arena executors
    (overlapped and stream) ``ut`` holds the flattened arena addresses
    ``rank·arena_blocks + slot`` of the level's Û lanes and
    ``base_p``/``base_s`` the arena offsets of the shared partial and S
    regions; the level-serial sweep keeps Û, the partials and S in
    buffers of their own and uses neither."""
    nk: int
    cm: torch.Tensor          # (P, nk, nbc) struct mask
    kcs: torch.Tensor         # (nk,) K // pc
    w: torch.Tensor           # (P, nbr, nk) column-write mask
    krs: torch.Tensor         # (nk,) K // pr
    rm: torch.Tensor          # (P, nk) diagonal row mask
    dslot: torch.Tensor       # (nk,) flat A⁻¹ slot of (K, K)
    dslot_c: torch.Tensor     # (nk,) the same, clamped below n_ainv
    droot: torch.Tensor       # (P, nk) this rank owns (K, K)
    ut: Optional[torch.Tensor] = None    # (P·nk·nbc,) flat arena addresses
    base_p: int = 0
    base_s: int = 0


@dataclass
class LaneTables:
    """One set of lanes of a round (the owner-local moves, or the
    permute) for all P ranks, flattened to ``P·width`` lanes: gather
    addresses into the arena (``ga``) and the input L̂ shard (``gl``),
    each masked in bounds where the other buffer is taken; the L̂
    select ``lh``; the scatter addresses ``sc``; the receiver-transpose
    and accumulate masks ``tm``/``am``; for the overlapped permute the
    (src, dst) rank pairs, as tensors and as the host list ``perm``, and
    its plan label ``where``; for the stream's comm slots one
    :class:`CommSlot` per active slot."""
    width: int
    ga: torch.Tensor
    gl: torch.Tensor
    lh: torch.Tensor
    mixed: bool
    sc: torch.Tensor
    tm: torch.Tensor
    any_t: bool
    am: Optional[torch.Tensor] = None
    src: Optional[torch.Tensor] = None
    dst: Optional[torch.Tensor] = None
    slots: List["CommSlot"] = field(default_factory=list)
    perm: Optional[List[Tuple[int, int]]] = None
    where: str = ""


@dataclass
class CommSlot:
    """One active comm slot of a stream step: slot ``si`` ships the
    leading ``width`` lanes from ``src`` to ``dst`` for the pairs of its
    static perm whose receiver keeps this slot's arrival at the step
    (``recv_slot``); ``pairs`` is that host list, which the recorder
    reads."""
    si: int
    width: int
    pairs: List[Tuple[int, int]]
    src: torch.Tensor
    dst: torch.Tensor


@dataclass
class SweepTables:
    """Every table the overlapped sweep reads, on one device."""
    device: torch.device
    P: int
    N: int
    arena_blocks: int
    dset_slot: torch.Tensor   # (m,) structless-supernode diagonal slots
    dset_m: torch.Tensor      # (P, m) this rank owns it
    levels: List[LevelTables]
    local: List[Optional[LaneTables]]
    comm: List[Optional[LaneTables]]
    compute_at: List[List[Tuple[str, int]]]
    nbytes: int = 0


@dataclass
class PhaseRounds:
    """One phase of a level-serial level (xfer-in, column broadcast, row
    reduction, …): its rounds' (sender address, receiver address) pairs,
    flattened over the rank axis as ``src·len(source) + gather slot`` and
    ``dst·len(target) + scatter slot``, uploaded as one ``(2, pairs)``
    tensor — the counterpart of the JAX sweep's fused ``(R, P, 2)`` slot
    table. ``pairs[i]`` are round i's views into it; ``perm[i]`` its
    (src, dst) rank pairs as a host list (None in an owner-local phase),
    which the recorder reads; ``name`` the phase's plan label (``level L
    bcast``)."""
    table: torch.Tensor
    pairs: List[Tuple[torch.Tensor, torch.Tensor]]
    name: str = ""
    perm: List[Optional[List[Tuple[int, int]]]] = field(
        default_factory=list)
    src_len: int = 0
    dst_len: int = 0


@dataclass
class ExecLevelTables:
    """One level of the level-serial sweep: its masks and its seven
    phases of rounds."""
    masks: LevelTables
    xfer_in_local: PhaseRounds
    xfer_in: PhaseRounds
    bcast: PhaseRounds
    reduce: PhaseRounds
    xfer_out_local: PhaseRounds
    xfer_out: PhaseRounds
    diag_reduce: PhaseRounds


@dataclass
class ExecTables:
    """Every table the level-serial sweep reads, on one device."""
    device: torch.device
    P: int
    N: int
    dset_slot: torch.Tensor
    dset_m: torch.Tensor
    levels: List[ExecLevelTables]
    nbytes: int = 0


@dataclass
class StreamSweepTables:
    """Every table the stream sweep reads, on one device: the round-
    stacked lane tables as ``(steps, P·W)`` tensors (``local[t]`` and
    ``comm[t]`` are views of row t, None where every lane of the step
    lands in the trash block), the level-stacked compute tables padded to
    NK (``levels_padded[L]`` are views of level L; ``levels[L]`` the same
    tables cut to the level's own nk), and each step's compute slots
    decoded from ``comp_kind``/``comp_level``."""
    device: torch.device
    P: int
    N: int
    arena_blocks: int
    dset_slot: torch.Tensor
    dset_m: torch.Tensor
    levels: List[LevelTables]
    levels_padded: List[LevelTables]
    local: List[Optional[LaneTables]]
    comm: List[Optional[LaneTables]]
    compute_at: List[List[Tuple[str, int]]]
    nbytes: int = 0


def _in_bounds(name: str, a: np.ndarray, hi: int) -> None:
    """The one-time bounds check that replaces ``promise_in_bounds``."""
    a = np.asarray(a)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
        raise ValueError(f"table {name} indexes outside [0, {hi}): "
                         f"range [{int(a.min())}, {int(a.max())}]")


def _dupes_are_trash(name: str, t: int, scatter: np.ndarray,
                     trash: int) -> None:
    """Per rank, every scatter index that repeats within one round must
    be the trash slot: an overwrite scatter with two writers to one real
    slot has no defined winner on the card."""
    for p, row in enumerate(np.asarray(scatter)):
        vals, counts = np.unique(row, return_counts=True)
        bad = vals[(counts > 1) & (vals != trash)]
        if bad.size:
            raise ValueError(
                f"round {t}: rank {p} scatters {name} lanes twice into "
                f"arena slots {bad.tolist()} — only the trash slot "
                f"{trash} may repeat")


def _uploader(dev):
    def up(x, dtype=torch.int64):
        if dev.type == "meta":        # shapes only: nothing is copied
            return torch.empty(np.shape(x), dtype=dtype, device=dev)
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)
    return up


def _count_bytes(tabs, objs) -> None:
    """``tabs.nbytes``: every distinct tensor reachable from ``objs``
    (views of one upload count as the upload's size once)."""
    seen = set()
    tabs.nbytes = 0

    def add(v):
        if isinstance(v, torch.Tensor):
            base = v if v._base is None else v._base
            if id(base) not in seen:
                seen.add(id(base))
                tabs.nbytes += base.numel() * base.element_size()
        elif isinstance(v, (list, tuple)):
            for x in v:
                add(x)
        elif isinstance(v, CommSlot):
            for x in vars(v).values():
                add(x)

    for obj in objs:
        for v in vars(obj).values():
            add(v)


def _check_level(name: str, lv, nbr: int, nbc: int, slot_hi: int) -> None:
    _in_bounds(f"{name} kcs", lv.kcs, nbc)
    _in_bounds(f"{name} krs", lv.krs, nbr)
    _in_bounds(f"{name} diag_slot", lv.diag_slot, slot_hi)


def _level_masks(lv, pr: int, pc: int, N: int, up) -> dict:
    """The per-rank masks of one level's tables (a ``LevelExec``, an
    ``OverlapLevel``) — or of every level at once from the stream's
    level-stacked tables, which carry the same fields behind a leading
    level axis."""
    rank = np.arange(pr * pc)
    r_of, c_of = rank // pc, rank % pc
    w = (np.take(np.asarray(lv.col_write_row), r_of, axis=-3)
         * np.take(np.asarray(lv.col_write_col), c_of, axis=-2)[..., None])
    return dict(
        cm=up(np.take(np.asarray(lv.cmask), c_of, axis=-3) != 0,
              torch.bool),
        kcs=up(lv.kcs), w=up(np.swapaxes(w, -1, -2) != 0, torch.bool),
        krs=up(lv.krs),
        rm=up(np.take(np.asarray(lv.diag_rowmask), r_of, axis=-2) != 0,
              torch.bool),
        dslot=up(lv.diag_slot),
        dslot_c=up(np.minimum(lv.diag_slot, N - 1)),
        droot=up(np.asarray(lv.diag_root)[..., None, :] == rank[:, None],
                 torch.bool))


def _lane_stack(name: str, g, s, tmask, glh, addm, A: int, N: int,
                trash: int, up, t0: int = 0) -> List[Optional[LaneTables]]:
    """Lane tables stacked over rounds, ``(rounds, P, W)``, uploaded once
    as ``(rounds, P·W)`` tensors of flattened per-rank addresses; returns
    one :class:`LaneTables` of row views per round (None where every lane
    of the round scatters into the trash block). ``t0`` numbers the first
    round in error messages."""
    g = np.asarray(g, np.int64)
    s = np.asarray(s, np.int64)
    glh = np.asarray(glh, bool)
    tmask = np.asarray(tmask, bool)
    steps, P, W = g.shape
    # arena gathers stay below the arena, L̂ gathers below the shard
    _in_bounds(f"{name}.gather[arena]", np.where(glh, 0, g), A)
    _in_bounds(f"{name}.gather[lh]", np.where(glh, g, 0), N)
    _in_bounds(f"{name}.scatter", s, A)
    for t in range(steps):
        _dupes_are_trash(name, t0 + t, s[t], trash)
    rank = np.arange(P, dtype=np.int64)[None, :, None]

    def rows(x, dtype=torch.int64):
        return up(np.asarray(x).reshape(steps, P * W), dtype)

    GA = rows(rank * A + np.where(glh, 0, g))
    GL = rows(rank * N + np.where(glh, g, 0))
    LH, SC, TM = rows(glh, torch.bool), rows(rank * A + s), rows(
        tmask, torch.bool)
    AM = None if addm is None else rows(np.asarray(addm) != 0, torch.bool)
    out: List[Optional[LaneTables]] = []
    for t in range(steps):
        if not (s[t] != trash).any():
            out.append(None)
            continue
        out.append(LaneTables(
            width=W, ga=GA[t], gl=GL[t], lh=LH[t], mixed=bool(glh[t].any()),
            sc=SC[t], tm=TM[t], any_t=bool(tmask[t].any()),
            am=None if AM is None else AM[t]))
    return out


def _lanes(t: int, name: str, g, s, tmask, glh, addm, perm, A: int,
           N: int, trash: int, P: int, up) -> Optional[LaneTables]:
    """One overlapped round's lanes (at the round's own width), and for
    the permute its (src, dst) rank pairs."""
    g, s, tmask, glh = (np.asarray(x)[None] for x in (g, s, tmask, glh))
    addm = None if addm is None else np.asarray(addm)[None]
    lt = _lane_stack(name, g, s, tmask, glh, addm, A, N, trash, up,
                     t0=t)[0]
    if perm is not None and lt is not None:
        src = np.array([p[0] for p in perm], np.int64)
        dst = np.array([p[1] for p in perm], np.int64)
        _in_bounds(f"{name}.perm", np.concatenate([src, dst]), P)
        if len(set(dst.tolist())) != len(dst):
            raise ValueError(f"round {t}: a rank receives twice")
        lt.src, lt.dst = up(src), up(dst)
        lt.perm = [(int(a), int(b)) for a, b in perm]
        lt.where = f"round {t}"
    return lt


def upload_tables(prog: PSelInvProgram, device) -> SweepTables:
    """Lower the overlapped schedule's per-rank tables to device tensors
    — once per session. Checks every index against the extent it
    addresses and that duplicate scatter indices are trash only, so the
    sweep can index without further checks. Stream programs carry the
    overlapped schedule they were lowered from; its tables serve their
    profiling replay."""
    ov = prog.overlap_plan
    if ov is None:
        raise ValueError("build_program(..., overlap=True) first")
    dev = torch.device(device)
    P, N, A, trash = ov.pr * ov.pc, ov.n_ainv, ov.arena_blocks, ov.trash
    nbr, nbc = ov.nbr, ov.nbc
    rank = np.arange(P)
    up = _uploader(dev)

    _in_bounds("diag_set_slot", ov.diag_set_slot, N)
    levels = []
    for li, lv in enumerate(ov.levels):
        nk = len(lv.Ks)
        _in_bounds(f"level {li} u_gather", lv.u_gather, A)
        _check_level(f"level {li}", lv, nbr, nbc, A)
        _in_bounds(f"level {li} partial", [lv.base_p, lv.base_p
                                           + nk * nbr - 1], A)
        _in_bounds(f"level {li} S", [lv.base_s, lv.base_s + nk - 1], A)
        levels.append(LevelTables(
            nk=nk, base_p=int(lv.base_p), base_s=int(lv.base_s),
            ut=up((rank[:, None] * A
                   + np.asarray(lv.u_gather, np.int64)).reshape(-1)),
            **_level_masks(lv, ov.pr, ov.pc, N, up)))
    local: List[Optional[LaneTables]] = []
    comm: List[Optional[LaneTables]] = []
    for t, rnd in enumerate(ov.rounds):
        local.append(_lanes(t, "local", rnd.lgather, rnd.lscatter,
                            rnd.ltmask, rnd.lglh, None, None, A, N,
                            trash, P, up) if rnd.lwidth else None)
        comm.append(_lanes(t, "permute", rnd.gather, rnd.scatter,
                           rnd.tmask, rnd.glh, rnd.addm, rnd.perm, A, N,
                           trash, P, up) if rnd.perm else None)
    tabs = SweepTables(
        device=dev, P=P, N=N, arena_blocks=A,
        dset_slot=up(ov.diag_set_slot),
        dset_m=up(np.asarray(ov.diag_set_root)[None, :] == rank[:, None],
                  torch.bool),
        levels=levels, local=local, comm=comm,
        compute_at=[[(op.kind, op.level) for op in ops]
                    for ops in ov.compute_at])
    _count_bytes(tabs, [tabs, *levels,
                        *[x for x in local + comm if x is not None]])
    return tabs


def _phase(name: str, rounds, local: bool, src_len: int, dst_len: int,
           trash: int, P: int, up) -> PhaseRounds:
    """Lower one level-serial phase (a list of ``CommRound`` or, with
    ``local``, ``LocalRound``) to its pair addresses. Only the round's
    real pairs move — a receiver's scatter slot is checked to lie below
    the trash block, and a rank that receives nothing must point at the
    trash — so the buffers need no trash block of their own."""
    gs, ss, cuts, perms = [], [], [0], []
    for i, rnd in enumerate(rounds):
        slots = np.asarray(rnd.slots, np.int64)
        if slots.shape != (P, 2):
            raise ValueError(f"{name} round {i}: slot table of shape "
                             f"{slots.shape}, expected {(P, 2)}")
        if local:
            src = dst = np.nonzero(slots[:, 1] != trash)[0]
        else:
            src = np.array([p[0] for p in rnd.perm], np.int64)
            dst = np.array([p[1] for p in rnd.perm], np.int64)
            _in_bounds(f"{name} round {i} perm",
                       np.concatenate([src, dst]), P)
            if (len(set(dst.tolist())) != len(dst)
                    or len(set(src.tolist())) != len(src)):
                raise ValueError(f"{name} round {i}: a rank sends or "
                                 "receives twice")
            idle = np.setdiff1d(np.arange(P), dst)
            if (slots[idle, 1] != trash).any():
                raise ValueError(f"{name} round {i}: a rank that receives "
                                 "nothing scatters outside the trash slot")
        _in_bounds(f"{name} round {i} gather", slots[src, 0], src_len)
        _in_bounds(f"{name} round {i} scatter", slots[dst, 1], dst_len)
        gs.append(src * src_len + slots[src, 0])
        ss.append(dst * dst_len + slots[dst, 1])
        cuts.append(cuts[-1] + len(src))
        perms.append(None if local else
                     [(int(a), int(b)) for a, b in rnd.perm])
    table = up(np.stack([np.concatenate(gs), np.concatenate(ss)])
               if gs else np.zeros((2, 0), np.int64))
    return PhaseRounds(table=table, pairs=[
        (table[0, lo:hi], table[1, lo:hi])
        for lo, hi in zip(cuts, cuts[1:])], name=name, perm=perms,
        src_len=src_len, dst_len=dst_len)


def upload_exec_tables(prog: PSelInvProgram, device) -> ExecTables:
    """Lower the level-serial :class:`~.plan.ExecPlan` to device tensors
    — once per session, every slot checked against the buffer it
    addresses: Û (nk·nbc blocks a rank), the partials (nk·nbr), S (nk)
    and A⁻¹ (nbr·nbc); a buffer's trash slot is its length."""
    ex = prog.exec_plan
    if ex is None:
        raise ValueError("build_program(..., overlap=False) first")
    dev = torch.device(device)
    P, nbr, nbc = ex.pr * ex.pc, ex.nbr, ex.nbc
    N = nbr * nbc
    rank = np.arange(P)
    up = _uploader(dev)

    _in_bounds("diag_set_slot", ex.diag_set_slot, N)
    levels = []
    for li, lv in enumerate(ex.levels):
        nk = len(lv.Ks)
        lu, lp = nk * nbc, nk * nbr
        name = f"level {li}"
        _check_level(name, lv, nbr, nbc, N)
        levels.append(ExecLevelTables(
            masks=LevelTables(nk=nk, **_level_masks(lv, ex.pr, ex.pc, N,
                                                     up)),
            xfer_in_local=_phase(f"{name} xfer_in_local", lv.xfer_in_local,
                                 True, N, lu, lu, P, up),
            xfer_in=_phase(f"{name} xfer_in", lv.xfer_in, False, N, lu,
                           lu, P, up),
            bcast=_phase(f"{name} bcast", lv.bcast, False, lu, lu, lu, P,
                         up),
            reduce=_phase(f"{name} reduce", lv.reduce, False, lp, lp, lp,
                          P, up),
            xfer_out_local=_phase(f"{name} xfer_out_local",
                                  lv.xfer_out_local, True, N, N, N, P, up),
            xfer_out=_phase(f"{name} xfer_out", lv.xfer_out, False, N, N,
                            N, P, up),
            diag_reduce=_phase(f"{name} diag_reduce", lv.diag_reduce,
                               False, nk, nk, nk, P, up)))
    tabs = ExecTables(
        device=dev, P=P, N=N, dset_slot=up(ex.diag_set_slot),
        dset_m=up(np.asarray(ex.diag_set_root)[None, :] == rank[:, None],
                  torch.bool),
        levels=levels)
    _count_bytes(tabs, [tabs, *levels, *[lt.masks for lt in levels]])
    return tabs


def upload_stream_tables(prog: PSelInvProgram,
                         device) -> StreamSweepTables:
    """Lower the uniform round stream (:class:`~.stream.StreamTables`) to
    device tensors — once per session: the round-stacked lane tables,
    the level-stacked NK-padded compute tables, and each step's active
    comm slots with the pairs whose receiver keeps that slot's arrival
    (``recv_slot``). ``slot_active`` is known here, so an inactive slot
    gets no entry and launches nothing, and an active one ships only the
    pairs that land (:class:`CommSlot`) — where the JAX program's gated
    permute ships every pair of the slot's perm. Every index is checked
    against the extent it addresses; repeated scatter indices must be
    trash."""
    st = prog.stream_tables
    if st is None:
        raise ValueError(
            "build_program(..., options=PlanOptions(stream=True)) first")
    dev = torch.device(device)
    P, N, A, trash = st.pr * st.pc, st.n_ainv, st.arena_blocks, st.trash
    nbr, nbc, NK, nlev = st.nbr, st.nbc, st.NK, st.nlev
    rank = np.arange(P)
    up = _uploader(dev)

    _in_bounds("diag_set_slot", st.diag_set_slot, N)
    _in_bounds("u_gather", st.u_gather, A)
    _check_level("levels", st, nbr, nbc, A)
    if nlev:
        _in_bounds("partial", [st.base_p, st.base_p + NK * nbr - 1], A)
        _in_bounds("S", [st.base_s, st.base_s + NK - 1], A)
    masks = _level_masks(st, st.pr, st.pc, N, up)
    UT = up(rank[None, :, None] * A + np.asarray(st.u_gather, np.int64))
    padded, levels = [], []
    for L in range(nlev):
        nk = len(st.level_Ks[L])
        padded.append(LevelTables(
            nk=NK, ut=UT[L].reshape(-1), base_p=int(st.base_p),
            base_s=int(st.base_s), **{k: v[L] for k, v in masks.items()}))
        levels.append(LevelTables(
            nk=nk, ut=UT[L, :, :nk * nbc].reshape(-1),
            base_p=int(st.base_p), base_s=int(st.base_s),
            cm=masks["cm"][L, :, :nk], kcs=masks["kcs"][L, :nk],
            w=masks["w"][L, :, :, :nk], krs=masks["krs"][L, :nk],
            rm=masks["rm"][L, :, :nk], dslot=masks["dslot"][L, :nk],
            dslot_c=masks["dslot_c"][L, :nk],
            droot=masks["droot"][L, :, :nk]))

    local = _lane_stack("local", st.lgather, st.lscatter, st.ltmask,
                        st.lglh, None, A, N, trash, up)
    comm = _lane_stack("permute", st.gather, st.scatter, st.tmask, st.glh,
                       st.addm, A, N, trash, up)
    # one upload for every slot's (src, dst) index runs
    parts, owner = [], []
    for t, ln in enumerate(comm):
        if ln is None:
            continue
        for si in np.nonzero(st.slot_active[t])[0]:
            w = int(st.slot_width[si])
            pairs = [(int(s_), int(d)) for s_, d in st.slot_perm[si]
                     if st.recv_slot[t, d] == si]
            _in_bounds(f"round {t} slot {si} perm", np.ravel(pairs), P)
            if not 0 < w <= st.W:
                raise ValueError(f"slot {si} width {w} outside (0, "
                                 f"{st.W}]")
            if pairs:
                parts.append(np.array(pairs, np.int64).T)
                owner.append((ln, int(si), w, pairs))
    if owner:
        flat = up(np.concatenate(parts, axis=1))
        at = 0
        for ln, si, w, pairs in owner:
            n = len(pairs)
            ln.slots.append(CommSlot(
                si=si, width=w, pairs=pairs, src=flat[0, at:at + n],
                dst=flat[1, at:at + n]))
            at += n
    names = {i: k for k, i in COMP_KIND_ID.items()}
    _in_bounds("comp_kind", st.comp_kind, len(COMP_KIND_ID) + 1)
    _in_bounds("comp_level", st.comp_level, max(nlev, 1))
    compute_at = [[(names[int(k)], int(li))
                   for k, li in zip(st.comp_kind[t], st.comp_level[t])
                   if int(k) != COMP_NOOP] for t in range(st.steps)]
    tabs = StreamSweepTables(
        device=dev, P=P, N=N, arena_blocks=A,
        dset_slot=up(st.diag_set_slot),
        dset_m=up(np.asarray(st.diag_set_root)[None, :] == rank[:, None],
                  torch.bool),
        levels=levels, levels_padded=padded, local=local, comm=comm,
        compute_at=compute_at)
    _count_bytes(tabs, [tabs, *levels, *padded,
                        *[x for x in local + comm if x is not None]])
    return tabs


def moved_blocks(tables) -> Tuple[int, int]:
    """(rounds, blocks) a sweep over ``tables`` moves between ranks, read
    off the uploaded tables — what the port's executors ship, not what
    the plan or the JAX program would: the overlapped sweep moves every
    (src, dst) pair of a round at the round's lane width; the
    level-serial sweep one block per real pair of each comm phase's
    rounds (owner-local moves excluded); the stream, per active comm
    slot, only the pairs whose receiver keeps that slot, at the slot's
    width. A round counts when it moves a block."""
    rounds = blocks = 0
    if isinstance(tables, ExecTables):
        for lv in tables.levels:
            for ph in (lv.xfer_in, lv.bcast, lv.reduce, lv.xfer_out,
                       lv.diag_reduce):
                for g, _ in ph.pairs:
                    rounds += g.numel() > 0
                    blocks += g.numel()
        return rounds, blocks
    stream = isinstance(tables, StreamSweepTables)
    for ln in tables.comm:
        if ln is None:
            continue
        n = (sum(len(cs.pairs) * cs.width for cs in ln.slots) if stream
             else ln.src.numel() * ln.width)
        rounds += n > 0
        blocks += n
    return rounds, blocks


# ---------------------------------------------------------------------------
# the compute phases, shared by the three executors
# ---------------------------------------------------------------------------

# Ports of ``repro/core/pselinv_dist.py`` ``_phase_gemm/_write/_scomp/
# _diagw`` (:395-447) and of the level-serial sweep's inline copies of
# them (:324-375): one definition, fed the arena's regions by the
# overlapped and stream executors and the level's own buffers by the
# level-serial one. ``Ainv`` is a (B, P, nbr, nbc, b, b) view; writes go
# in place (slice assignment and ``index_add_`` where JAX used
# ``dynamic_update_slice`` and ``.at[].add``): the buffers are private to
# one sweep call, so nothing else observes the update.

def _write_cols(Ainv, partial, lv: LevelTables):
    """A⁻¹(C, K) column write for every K of the level: masked delta +
    scatter-add — same-level K's write disjoint (rank, slot) pairs, so
    duplicate ``kcs`` entries add zeros."""
    old = Ainv.index_select(3, lv.kcs)                 # (B, P, nbr, nk, b, b)
    new = -partial.transpose(2, 3)
    delta = torch.where(lv.w[None, :, :, :, None, None], new - old, 0.0)
    Ainv.index_add_(3, lv.kcs, delta)


def _diag_sum(Ainv, U, lv: LevelTables):
    """Diagonal partial sum S(K) = Σ_I A⁻¹(K, I) · L̂(I, K), masked to row
    K%pr. The einsum runs once per batch item so every item sees the same
    shapes — and the same summation order — at any batch size."""
    B = Ainv.shape[0]
    cm = lv.cm[None, :, :, :, None, None]
    Uh_m = torch.where(cm, U, 0.0)
    Arow = torch.where(cm, Ainv.index_select(2, lv.krs), 0.0)
    S = torch.stack([torch.einsum("pkjab,pkjcb->pkac", Arow[i], Uh_m[i])
                     for i in range(B)])
    return torch.where(lv.rm[None, :, :, None, None], S, 0.0)


def _write_diag(buf, Dinv, S, lv: LevelTables):
    """Diagonal write A⁻¹(K,K) = D⁻¹ − Sᵀ at the owner (``buf`` and
    ``Dinv`` are (B, P, slots, b, b); padded rows carry a trash slot, no
    owner, and a clamped D⁻¹ gather)."""
    newd = Dinv.index_select(2, lv.dslot_c) - S.transpose(-1, -2)
    cur = buf.index_select(2, lv.dslot)
    buf.index_add_(2, lv.dslot, torch.where(
        lv.droot[None, :, :, None, None], newd - cur, 0.0))


def _compute(kind: str, lv: LevelTables, N: int, arena, flat, Dinv,
             nbr: int, nbc: int, b: int):
    """One compute op at a round boundary on the arena executors: the
    level GEMM (in the hand-written kernel, written straight into the
    shared partial region), the column write, the diagonal sum into the
    S region, or the diagonal write."""
    B, P = arena.shape[:2]
    Ainv = arena[:, :, :N].view(B, P, nbr, nbc, b, b)
    partial = arena[:, :, lv.base_p:lv.base_p + lv.nk * nbr].view(
        B, P, lv.nk, nbr, b, b)
    if kind == "gemm":
        U = flat.index_select(1, lv.ut).view(B, P, lv.nk, nbc, b, b)
        pselinv_round_gemm(Ainv, U, lv.cm, out=partial)
    elif kind == "write":
        _write_cols(Ainv, partial, lv)
    elif kind == "scomp":
        U = flat.index_select(1, lv.ut).view(B, P, lv.nk, nbc, b, b)
        arena[:, :, lv.base_s:lv.base_s + lv.nk] = _diag_sum(Ainv, U, lv)
    else:                       # "diagw"
        _write_diag(arena, Dinv, arena[:, :, lv.base_s:lv.base_s + lv.nk],
                    lv)


def _values(Lh, Dinv, shape, device, batched: bool):
    """The value shards as (B, *shape) tensors, checked against the
    tables' device — and, for f32 on the card, against TF32: the diagonal
    einsum goes to cuBLAS, where TF32 would keep ~3 digits."""
    if not batched:
        Lh, Dinv = Lh[None], Dinv[None]
    if Lh.shape[1:] != shape or Dinv.shape != Lh.shape:
        raise ValueError(f"value shards must be (B, *{shape}), got "
                         f"{tuple(Lh.shape)} and {tuple(Dinv.shape)}")
    if Lh.device != device or Dinv.device != device:
        raise ValueError(f"values on {Lh.device}, tables on {device}")
    if (Lh.dtype == torch.float32 and Lh.device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "a float32 sweep needs full-precision matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (the "
            "PyTorch default)")
    return Lh, Dinv


def _seed_diag(buf, Dinv, tabs) -> None:
    """Structless supernodes (leaves without fill + grid padding) get
    A⁻¹(K,K) = D⁻¹ up front, at the owner."""
    if tabs.dset_slot.numel():
        buf.index_add_(2, tabs.dset_slot, torch.where(
            tabs.dset_m[None, :, :, None, None],
            Dinv.index_select(2, tabs.dset_slot), 0.0))


# ---------------------------------------------------------------------------
# the level-serial sweep: one level at a time, tree rounds in order
# ---------------------------------------------------------------------------

def _move(ph: PhaseRounds, i: int, dst, src=None, transpose: bool = False,
          add: bool = False) -> None:
    """Round ``i`` of a phase: a gather at the senders, the permute, and
    a scatter (``add``: an accumulate) at the receivers, on ``(B, P·len,
    b, b)`` views. A comm round reports itself to an active record: its
    host pairs, and one rank's payload — its share of the gathered
    blocks."""
    g, s = ph.pairs[i]
    blk = (dst if src is None else src).index_select(1, g)
    if transpose:
        blk = blk.transpose(-1, -2)
    rec = exec_ir.active()
    if rec is not None and ph.perm[i]:
        B, n = blk.shape[:2]
        rec.permute(f"{ph.name}[{i}]", "exec", ph.perm[i],
                    (B, n // len(ph.perm[i])) + tuple(blk.shape[2:]),
                    blk.dtype)
    if add:
        blk = blk + dst.index_select(1, s)
    dst.index_copy_(1, s, blk)


def _rounds(ph: PhaseRounds, dst, src=None, transpose: bool = False,
            add: bool = False) -> None:
    """One phase's rounds, in order (:func:`_move`). With ``src=None`` a
    round gathers from ``dst`` as the earlier rounds left it: tree nodes
    forward what they received, so the rounds of a phase are never
    fused."""
    for i in range(len(ph.pairs)):
        _move(ph, i, dst, src, transpose, add)


def make_sweep(prog: PSelInvProgram, tables: ExecTables,
               batched: bool = False):
    """The level-serial sweep (the paper's algorithm, and the baseline
    the overlapped schedule is measured against) over ``tables`` (from
    :func:`upload_exec_tables`): per elimination-tree level, xfer-in and
    the column broadcast build the level's Û stack, one masked level GEMM
    runs in the hand-written kernel, the row reduction sums the partials
    onto the owners, then the column write, xfer-out, and the diagonal
    sum, reduction and write. Same calling convention as
    :func:`make_sweep_overlapped`."""
    ex = prog.exec_plan
    if ex is None:
        raise ValueError("build_program(..., overlap=False) first")
    b, P, N = prog.b, tables.P, tables.N
    nbr, nbc = ex.nbr, ex.nbc
    shape = (P, nbr, nbc, b, b)

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh, Dinv, shape, tables.device, batched)
        B = Lh.shape[0]
        lh_flat = Lh.reshape(B, P * N, b, b)
        Dinv_f = Dinv.reshape(B, P, N, b, b)
        ainv = Lh.new_zeros((B, P, N, b, b))
        aflat = ainv.view(B, P * N, b, b)
        Ainv = ainv.view(B, P, nbr, nbc, b, b)
        _seed_diag(ainv, Dinv_f, tables)
        for lt in tables.levels:
            lv, nk = lt.masks, lt.masks.nk
            # (a) xfer-in and (b) the column broadcast build Û
            uh = Lh.new_zeros((B, P, nk * nbc, b, b))
            uflat = uh.view(B, P * nk * nbc, b, b)
            _rounds(lt.xfer_in_local, uflat, lh_flat, transpose=True)
            _rounds(lt.xfer_in, uflat, lh_flat, transpose=True)
            _rounds(lt.bcast, uflat)
            U = uh.view(B, P, nk, nbc, b, b)
            # (1) one masked level GEMM, (c) the row reduction
            part = Lh.new_empty((B, P, nk * nbr, b, b))
            partial = part.view(B, P, nk, nbr, b, b)
            pselinv_round_gemm(Ainv, U, lv.cm, out=partial)
            _rounds(lt.reduce, part.view(B, P * nk * nbr, b, b), add=True)
            _write_cols(Ainv, partial, lv)
            # (f) xfer-out: A⁻¹(K,J) = A⁻¹(J,K)ᵀ
            _rounds(lt.xfer_out_local, aflat, transpose=True)
            _rounds(lt.xfer_out, aflat, transpose=True)
            # (2, 3) the diagonal
            S = _diag_sum(Ainv, U, lv)
            _rounds(lt.diag_reduce, S.view(B, P * nk, b, b), add=True)
            _write_diag(ainv, Dinv_f, S, lv)
        out = ainv.view(B, *shape)
        return out if batched else out[0]

    return sweep


# ---------------------------------------------------------------------------
# the overlapped sweep on a (B, P, arena, b, b) block arena
# ---------------------------------------------------------------------------

def _gather_lanes(flat, lh_flat, ln: LaneTables):
    """Per-lane select between the arena and the resident input L̂ shard
    (no arena copy of L̂ exists); both gathers are masked in bounds at
    upload, and ``mixed`` skips the L̂ gather where no lane takes it."""
    blks = flat.index_select(1, ln.ga)
    if not ln.mixed:
        return blks
    blks_l = lh_flat.index_select(1, ln.gl)
    return torch.where(ln.lh[None, :, None, None], blks_l, blks)


def _transpose_lanes(blks, ln: LaneTables):
    if not ln.any_t:
        return blks
    return torch.where(ln.tm[None, :, None, None],
                       blks.transpose(-1, -2), blks)


def _local_lanes(flat, lh_flat, ln: Optional[LaneTables]) -> None:
    """The owner-local lane moves; non-participating lanes land in the
    trash block."""
    if ln is not None:
        blks = _transpose_lanes(_gather_lanes(flat, lh_flat, ln), ln)
        flat.index_copy_(1, ln.sc, blks)


def _land(flat, moved, ln: LaneTables) -> None:
    """The receivers' side of a permute: the transpose mask, then
    ``moved + cur`` where the lane accumulates, ``moved`` elsewhere."""
    moved = _transpose_lanes(moved, ln)
    cur = flat.index_select(1, ln.sc)
    flat.index_copy_(1, ln.sc, torch.where(
        ln.am[None, :, None, None], moved + cur, moved))


def _permute_lanes(payload, ln: LaneTables):
    """The permute over the rank axis: ``moved[:, dst] = payload[:,
    src]``; ranks that receive nothing get zeros, as in JAX. Reports
    itself to an active record (one rank's payload: ``(B, width, b,
    b)``)."""
    rec = exec_ir.active()
    if rec is not None:
        rec.permute(ln.where, "overlap", ln.perm,
                    payload.shape[:1] + payload.shape[2:], payload.dtype)
    moved = torch.zeros_like(payload)
    moved.index_copy_(1, ln.dst, payload.index_select(1, ln.src))
    return moved


#: the phase of each compute kind, as :func:`exec_ir.mark` names it
COMPUTE_PHASES = {"gemm": "gemm", "write": "update.cols",
                  "scomp": "update.diag_sum", "diagw": "update.diag_write"}


def _computes(tabs: SweepTables, t: int, arena, flat, Dinv, nbr, nbc, b):
    """The compute ops pinned at boundary ``t``, each marked as its
    phase."""
    for kind, li in tabs.compute_at[t]:
        exec_ir.mark(COMPUTE_PHASES[kind], t)
        _compute(kind, tabs.levels[li], tabs.N, arena, flat, Dinv, nbr,
                 nbc, b)


def _round(tabs: SweepTables, t: int, arena, flat, lh_flat, Dinv,
           nbr, nbc, b, permute=None):
    """One executed round: the boundary's pinned compute ops, the
    owner-local lane moves, then round ``t``'s coalesced multi-lane
    permute with per-lane gather/scatter/accumulate/transpose tables —
    over the rank axis (:func:`_permute_lanes`), or (``permute``) between
    rank processes. Each phase is marked (:func:`exec_ir.mark`) where it
    starts."""
    _computes(tabs, t, arena, flat, Dinv, nbr, nbc, b)
    if tabs.local[t] is not None:
        exec_ir.mark("lanes.local", t)
        _local_lanes(flat, lh_flat, tabs.local[t])
    ln = tabs.comm[t]
    if ln is not None:
        B, P = arena.shape[:2]
        exec_ir.mark("lanes.gather", t)
        payload = _gather_lanes(flat, lh_flat, ln).view(
            B, P, ln.width, b, b)
        exec_ir.mark("lanes.permute", t)
        moved = (permute or _permute_lanes)(payload, ln)
        exec_ir.mark("lanes.land", t)
        _land(flat, moved.view(B, P * ln.width, b, b), ln)


def _init_arena(tabs, Dinv, b: int):
    """A fresh (B, P, arena, b, b) arena with the structless-supernode
    diagonal seeds (phase ``arena.init``, round -1)."""
    exec_ir.mark("arena.init", -1)
    B, P = Dinv.shape[:2]
    arena = torch.zeros((B, P, tabs.arena_blocks, b, b), dtype=Dinv.dtype,
                        device=Dinv.device)
    _seed_diag(arena, Dinv, tabs)
    return arena


def _finish(tabs: SweepTables, arena, Dinv, nbr, nbc, b):
    """The trailing boundary's compute (round ``len(tabs.comm)``), and
    A⁻¹ out of the arena (phase ``arena.finish``, the same round)."""
    B, P = arena.shape[:2]
    flat = arena.view(B, P * tabs.arena_blocks, b, b)
    t = len(tabs.comm)
    _computes(tabs, t, arena, flat, Dinv, nbr, nbc, b)
    exec_ir.mark("arena.finish", t)
    return arena[:, :, :tabs.N].reshape(B, P, nbr, nbc, b, b).clone(
        memory_format=torch.contiguous_format)


def make_sweep_overlapped(prog: PSelInvProgram, tables: SweepTables,
                          batched: bool = False):
    """The cross-level overlapped sweep over ``tables`` (from
    :func:`upload_tables`). The returned ``sweep(Lh, Dinv)`` takes the
    value shards ``(P, nbr, nbc, b, b)`` — or ``(B, P, nbr, nbc, b, b)``
    with ``batched=True`` — on the tables' device and returns the A⁻¹
    shards in the same layout. No table moves and no value is read back
    to the host inside the sweep."""
    ov = prog.overlap_plan
    b, P, N, A = prog.b, tables.P, tables.N, tables.arena_blocks
    nbr, nbc = ov.nbr, ov.nbc
    shape = (P, nbr, nbc, b, b)

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh, Dinv, shape, tables.device, batched)
        B = Lh.shape[0]
        lh_flat = Lh.reshape(B, P * N, b, b)
        Dinv_f = Dinv.reshape(B, P, N, b, b)
        arena = _init_arena(tables, Dinv_f, b)
        flat = arena.view(B, P * A, b, b)
        for t in range(len(tables.comm)):
            _round(tables, t, arena, flat, lh_flat, Dinv_f, nbr, nbc, b)
        out = _finish(tables, arena, Dinv_f, nbr, nbc, b)
        return out if batched else out[0]

    return sweep


def make_sweep_segments(prog: PSelInvProgram, tables: SweepTables,
                        boundaries: Optional[Sequence[int]] = None):
    """The overlapped sweep cut at round boundaries, for the profiling
    replay (``obs.rounds``): the same ``_init_arena``/``_round``/
    ``_finish`` code as :func:`make_sweep_overlapped`, so running the
    segments in order reproduces the fused sweep bit for bit.

    Returns ``(init, steps, final)`` for one matrix (value shards
    ``(P, nbr, nbc, b, b)`` on the tables' device):

    * ``init(Lh, Dinv) -> arena`` — a fresh ``(1, P, arena_blocks, b,
      b)`` arena with the structless-supernode diagonal seeds;
    * ``steps[i](arena, Lh, Dinv) -> arena`` — executed rounds
      ``boundaries[i] .. boundaries[i+1])``, in place on the arena;
    * ``final(arena, Lh, Dinv) -> Ainv`` — the trailing boundary's
      compute and the A⁻¹ shards.

    ``boundaries`` defaults to ``range(nrounds + 1)`` — one step per
    executed round; a coarser strictly increasing cut list from 0 to
    nrounds gives level-chunk segments."""
    ov = prog.overlap_plan
    if ov is None:
        raise ValueError("build_program(..., overlap=True) first")
    b, P, N, A = prog.b, tables.P, tables.N, tables.arena_blocks
    nbr, nbc = ov.nbr, ov.nbc
    nrounds = len(ov.rounds)
    shape = (P, nbr, nbc, b, b)
    if boundaries is None:
        boundaries = list(range(nrounds + 1))
    else:
        boundaries = [int(x) for x in boundaries]
        if (not boundaries or boundaries[0] != 0
                or boundaries[-1] != nrounds
                or any(a >= b_ for a, b_ in zip(boundaries,
                                                boundaries[1:]))):
            raise ValueError(
                f"boundaries must be a strictly increasing cut list from "
                f"0 to {nrounds}, got {boundaries!r}")

    def _ctx(Lh, Dinv):
        Lh, Dinv = _values(Lh, Dinv, shape, tables.device, False)
        return Lh.reshape(1, P * N, b, b), Dinv.reshape(1, P, N, b, b)

    def init(Lh, Dinv):
        return _init_arena(tables, _ctx(Lh, Dinv)[1], b)

    def _make_step(lo: int, hi: int):
        def step(arena, Lh, Dinv):
            lh_flat, Dinv_f = _ctx(Lh, Dinv)
            flat = arena.view(1, P * A, b, b)
            for t in range(lo, hi):
                _round(tables, t, arena, flat, lh_flat, Dinv_f, nbr, nbc,
                       b)
            return arena
        return step

    steps = [_make_step(lo, hi)
             for lo, hi in zip(boundaries, boundaries[1:])]

    def final(arena, Lh, Dinv):
        return _finish(tables, arena, _ctx(Lh, Dinv)[1], nbr, nbc, b)[0]

    return init, steps, final


# ---------------------------------------------------------------------------
# the overlapped sweep over rank processes
# ---------------------------------------------------------------------------

def rank_tables(tables: SweepTables, rank: int, device) -> SweepTables:
    """Rank ``rank``'s view of the overlapped sweep's tables
    (:func:`upload_tables`' product, best uploaded to the host): row
    ``rank`` of every ``(P, …)`` table — the lanes, the level masks that
    ``_compute`` reads, the structless-diagonal owners — with the arena
    and L̂ addresses made relative to the rank's own arena and shard (the
    ``rank·arena_blocks`` and ``rank·N`` offsets of :func:`_lane_stack`
    and :func:`upload_tables` taken off), copied to ``device``. Each
    permute keeps its (src, dst) rank pairs as the host list ``perm``,
    from which a rank reads its send (to ``dst``) and receive (from
    ``src``). Built from the very tables the single-process sweep reads,
    so the two can never read different tables; ``P`` is 1."""
    P, A, N = tables.P, tables.arena_blocks, tables.N
    if not 0 <= rank < P:
        raise ValueError(f"rank {rank} outside a grid of {P}")
    dev = torch.device(device)

    def mine(x):                 # row `rank`, leading axis kept
        return x[rank:rank + 1].to(dev, copy=True)

    def shared(x):
        return x.to(dev, copy=True)

    def lanes(ln: Optional[LaneTables]) -> Optional[LaneTables]:
        if ln is None:
            return None
        W = ln.width

        def row(x, off=0):
            r = x.view(P, W)[rank]
            return r - off if off else r

        lh, tm = row(ln.lh), row(ln.tm)
        return LaneTables(
            width=W, ga=shared(row(ln.ga, rank * A)),
            gl=shared(row(ln.gl, rank * N)), lh=shared(lh),
            mixed=bool(lh.any()), sc=shared(row(ln.sc, rank * A)),
            tm=shared(tm), any_t=bool(tm.any()),
            am=None if ln.am is None else shared(row(ln.am)),
            perm=ln.perm, where=ln.where)

    levels = [LevelTables(
        nk=lv.nk, cm=mine(lv.cm), kcs=shared(lv.kcs), w=mine(lv.w),
        krs=shared(lv.krs), rm=mine(lv.rm), dslot=shared(lv.dslot),
        dslot_c=shared(lv.dslot_c), droot=mine(lv.droot),
        ut=shared(lv.ut.view(P, -1)[rank] - rank * A),
        base_p=lv.base_p, base_s=lv.base_s) for lv in tables.levels]
    local = [lanes(ln) for ln in tables.local]
    comm = [lanes(ln) for ln in tables.comm]
    tabs = SweepTables(
        device=dev, P=1, N=N, arena_blocks=A,
        dset_slot=shared(tables.dset_slot), dset_m=mine(tables.dset_m),
        levels=levels, local=local, comm=comm,
        compute_at=tables.compute_at)
    _count_bytes(tabs, [tabs, *levels,
                        *[x for x in local + comm if x is not None]])
    return tabs


def _rank_permute(rank: int, group):
    """The permute of a rank process: its payload to its ``dst`` and its
    arrival from its ``src``, as one :func:`~..comm.p2p.ppermute`; a rank
    that receives nothing lands zeros, as over the rank axis. Reports the
    round to an active record as :func:`_permute_lanes` does."""
    def permute(payload, ln: LaneTables):
        rec = exec_ir.active()
        if rec is not None:
            rec.permute(ln.where, "ranked", ln.perm,
                        payload.shape[:1] + payload.shape[2:],
                        payload.dtype)
        moved = ppermute(payload, ln.perm, group)
        if any(d == rank for _, d in ln.perm):
            return moved
        return torch.zeros_like(payload)
    return permute


def make_sweep_overlapped_ranked(prog: PSelInvProgram, tables: SweepTables,
                                 rank: int, group=None):
    """The overlapped sweep as rank ``rank`` of a ``pr·pc``-process group
    runs it, over its own view of the tables (:func:`rank_tables`). Each
    round follows :func:`_round`: the boundary's compute ops, the
    owner-local lanes, the lane gather of this rank's payload, one
    :func:`~..comm.p2p.ppermute` of it between the rank processes, and the
    landing at the receiver. Only this rank's ``(1, 1, arena, b, b)``
    arena is held; the level GEMM runs in the hand-written kernel at Z=1
    (``ops.pselinv_round_gemm``). The returned ``sweep(Lh, Dinv)`` takes
    the rank's value shards ``(nbr, nbc, b, b)`` on the tables' device
    and returns its A⁻¹ shard in the same layout. Nothing is read back to
    the host inside the sweep except the staged payloads of a CUDA
    run."""
    import torch.distributed as dist

    ov = prog.overlap_plan
    if ov is None:
        raise ValueError("build_program(..., overlap=True) first")
    if tables.P != 1:
        raise ValueError("the ranked sweep reads one rank's tables — "
                         "rank_tables(upload_tables(...), rank, device)")
    if dist.get_rank(group) != rank or (
            dist.get_world_size(group) != prog.pr * prog.pc):
        raise ValueError(
            f"rank {rank} of a {prog.pr}x{prog.pc} grid, but this process "
            f"is rank {dist.get_rank(group)} of "
            f"{dist.get_world_size(group)}")
    b, N, A = prog.b, tables.N, tables.arena_blocks
    nbr, nbc = ov.nbr, ov.nbc
    permute = _rank_permute(rank, group)

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh[None], Dinv[None], (1, nbr, nbc, b, b),
                           tables.device, False)
        lh_flat = Lh.reshape(1, N, b, b)
        Dinv_f = Dinv.reshape(1, 1, N, b, b)
        arena = _init_arena(tables, Dinv_f, b)
        flat = arena.view(1, A, b, b)
        for t in range(len(tables.comm)):
            _round(tables, t, arena, flat, lh_flat, Dinv_f, nbr, nbc, b,
                   permute)
        return _finish(tables, arena, Dinv_f, nbr, nbc, b)[0, 0]

    return sweep


# ---------------------------------------------------------------------------
# the level-serial sweep over rank processes
# ---------------------------------------------------------------------------

@dataclass
class RankRound:
    """One round of a level-serial phase as one rank runs it: the
    round's (src, dst) pairs (``perm``; None in an owner-local phase) and
    this rank's source slot when it sends (``gather``) and destination
    slot when it receives (``scatter``) — both None when the round does
    not touch it."""
    perm: Optional[List[Tuple[int, int]]]
    gather: Optional[int]
    scatter: Optional[int]


@dataclass
class RankPhase:
    """One rank's view of a :class:`PhaseRounds`."""
    name: str
    rounds: List[RankRound]


def rank_exec_tables(tables: ExecTables, rank: int, device) -> ExecTables:
    """Rank ``rank``'s view of the level-serial sweep's tables
    (:func:`upload_exec_tables`' product, best uploaded to the host),
    built as :func:`rank_tables` is: row ``rank`` of every ``(P, …)``
    mask the compute phases read and of the structless-diagonal owners,
    copied to ``device``; and for every round of every phase its host
    ``perm`` and this rank's gather and scatter slot, read off the
    uploaded ``src·len + slot`` addresses — so the ranked and the
    single-process sweep cannot read different tables. ``P`` is 1."""
    P, N = tables.P, tables.N
    if not 0 <= rank < P:
        raise ValueError(f"rank {rank} outside a grid of {P}")
    dev = torch.device(device)

    def mine(x):
        return x[rank:rank + 1].to(dev, copy=True)

    def shared(x):
        return x.to(dev, copy=True)

    def phase(ph: PhaseRounds) -> RankPhase:
        rounds = []
        for (g, s), perm in zip(ph.pairs, ph.perm):
            src = {a // ph.src_len: a % ph.src_len for a in g.tolist()}
            dst = {a // ph.dst_len: a % ph.dst_len for a in s.tolist()}
            rounds.append(RankRound(perm=perm, gather=src.get(rank),
                                    scatter=dst.get(rank)))
        return RankPhase(name=ph.name, rounds=rounds)

    levels = []
    for lt in tables.levels:
        lv = lt.masks
        levels.append(ExecLevelTables(
            masks=LevelTables(
                nk=lv.nk, cm=mine(lv.cm), kcs=shared(lv.kcs), w=mine(lv.w),
                krs=shared(lv.krs), rm=mine(lv.rm), dslot=shared(lv.dslot),
                dslot_c=shared(lv.dslot_c), droot=mine(lv.droot)),
            **{name: phase(getattr(lt, name)) for name in (
                "xfer_in_local", "xfer_in", "bcast", "reduce",
                "xfer_out_local", "xfer_out", "diag_reduce")}))
    tabs = ExecTables(device=dev, P=1, N=N,
                      dset_slot=shared(tables.dset_slot),
                      dset_m=mine(tables.dset_m), levels=levels)
    _count_bytes(tabs, [tabs, *[lt.masks for lt in levels]])
    return tabs


def _rank_rounds(ph: RankPhase, dst, src, transpose: bool, add: bool,
                 rank: int, hole, group) -> None:
    """One phase's rounds at one rank, in order, on ``(1, len, b, b)``
    buffers: an owner-local round moves the rank's own block; a comm
    round gathers the sender's block (transposed where the phase
    transposes), runs one :func:`~..comm.p2p.ppermute` — on every rank,
    so that every rank numbers the round alike — and lands the arrival
    at the receiver (``add``: on top of what is there). ``hole`` is the
    payload of a rank that only receives or sits the round out."""
    rec = exec_ir.active()
    for i, rnd in enumerate(ph.rounds):
        if rnd.perm is not None and not rnd.perm:
            continue
        g, s = rnd.gather, rnd.scatter
        blk = None
        if g is not None:
            blk = (dst if src is None else src)[:, g:g + 1]
            if transpose:
                blk = blk.transpose(-1, -2)
        if rnd.perm is not None:
            if rec is not None:
                rec.permute(f"{ph.name}[{i}]", "ranked", rnd.perm,
                            hole.shape[:1] + hole.shape[2:], hole.dtype)
            blk = ppermute(hole if blk is None else blk, rnd.perm, group)
        if s is None:
            continue
        if src is None and g == s:
            blk = blk.clone()
        if add:
            blk = blk + dst[:, s:s + 1]
        dst[:, s:s + 1].copy_(blk)


def make_sweep_ranked(prog: PSelInvProgram, tables: ExecTables, rank: int,
                      group=None):
    """The level-serial sweep — the paper's algorithm — as rank
    ``rank`` of a ``pr·pc``-process group runs it, over its own view of
    the tables (:func:`rank_exec_tables`). Each level follows
    :func:`make_sweep`: xfer-in and the column broadcast build the
    rank's Û stack, the level GEMM runs in the hand-written kernel at Z=1
    (``ops.pselinv_round_gemm``), the row reduction, the column write,
    xfer-out and the diagonal sum, reduction and write — every
    non-local round a point-to-point message (:func:`_rank_rounds`); tree
    nodes forward what they received, so the rounds of a phase are never
    fused. The returned ``sweep(Lh, Dinv)`` takes the rank's value shards
    ``(nbr, nbc, b, b)`` on the tables' device and returns its A⁻¹ shard
    in the same layout."""
    import torch.distributed as dist

    ex = prog.exec_plan
    if ex is None:
        raise ValueError("build_program(..., overlap=False) first")
    if tables.P != 1:
        raise ValueError("the ranked sweep reads one rank's tables — "
                         "rank_exec_tables(upload_exec_tables(...), rank, "
                         "device)")
    if dist.get_rank(group) != rank or (
            dist.get_world_size(group) != prog.pr * prog.pc):
        raise ValueError(
            f"rank {rank} of a {prog.pr}x{prog.pc} grid, but this process "
            f"is rank {dist.get_rank(group)} of "
            f"{dist.get_world_size(group)}")
    b, N = prog.b, tables.N
    nbr, nbc = ex.nbr, ex.nbc

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh[None], Dinv[None], (1, nbr, nbc, b, b),
                           tables.device, False)
        lh_flat = Lh.reshape(1, N, b, b)
        Dinv_f = Dinv.reshape(1, 1, N, b, b)
        ainv = Lh.new_zeros((1, 1, N, b, b))
        aflat = ainv.view(1, N, b, b)
        Ainv = ainv.view(1, 1, nbr, nbc, b, b)
        hole = Lh.new_zeros((1, 1, b, b))
        _seed_diag(ainv, Dinv_f, tables)

        def run(ph, dst, src=None, transpose=False, add=False):
            _rank_rounds(ph, dst, src, transpose, add, rank, hole, group)

        for lt in tables.levels:
            lv, nk = lt.masks, lt.masks.nk
            uh = Lh.new_zeros((1, 1, nk * nbc, b, b))
            uflat = uh.view(1, nk * nbc, b, b)
            run(lt.xfer_in_local, uflat, lh_flat, transpose=True)
            run(lt.xfer_in, uflat, lh_flat, transpose=True)
            run(lt.bcast, uflat)
            U = uh.view(1, 1, nk, nbc, b, b)
            part = Lh.new_empty((1, 1, nk * nbr, b, b))
            partial = part.view(1, 1, nk, nbr, b, b)
            pselinv_round_gemm(Ainv, U, lv.cm, out=partial)
            run(lt.reduce, part.view(1, nk * nbr, b, b), add=True)
            _write_cols(Ainv, partial, lv)
            run(lt.xfer_out_local, aflat, transpose=True)
            run(lt.xfer_out, aflat, transpose=True)
            S = _diag_sum(Ainv, U, lv)
            run(lt.diag_reduce, S.view(1, nk, b, b), add=True)
            _write_diag(ainv, Dinv_f, S, lv)
        return ainv.view(nbr, nbc, b, b)

    return sweep


# ---------------------------------------------------------------------------
# the stream sweep: the overlapped rounds as uniform, round-stacked tables
# ---------------------------------------------------------------------------

def _ship_slot(payload, moved, cs: CommSlot, t: int) -> None:
    """One active comm slot at step ``t``: the leading ``width`` lanes
    of each sender whose receiver keeps this slot's arrival ship into
    ``moved`` (``(B, P, W, b, b)``). Reports its host pairs to an active
    record."""
    w = cs.width
    rec = exec_ir.active()
    if rec is not None:
        rec.permute(f"comm slot {cs.si}", "stream", cs.pairs,
                    (payload.shape[0], w) + tuple(payload.shape[3:]),
                    payload.dtype, step=t)
    moved[:, :, :w].index_copy_(
        1, cs.dst, payload[:, :, :w].index_select(1, cs.src))


def make_sweep_stream(prog: PSelInvProgram, tables: StreamSweepTables,
                      batched: bool = False, padded: bool = False):
    """The uniform round-stream sweep over ``tables`` (from
    :func:`upload_stream_tables`) — the port of the JAX ``fori_loop``
    body. It runs ``steps = nrounds + 1`` iterations, reading step t's
    table rows by the host integer t (nothing is read back from the
    device). Each iteration (a) runs the boundary's compute slots, in
    dependence order, through the phases the overlapped sweep uses; (b)
    the owner-local lanes; (c) gathers the rank's one outgoing lane stack
    once, then each active comm slot ships the stack's leading
    ``slot_width`` lanes to the receivers that keep its arrival
    (``recv_slot``; :func:`_ship_slot`), and the arrivals land through the
    transpose mask and the ``moved + am·cur`` scatter.

    ``padded=False`` runs each compute slot at its level's own nk (the
    level tables cut on the host); ``padded=True`` at the stream's NK, as
    the JAX stream does — the padded rows carry zero masks and trash
    slots. Both give the overlapped sweep's bits wherever the level GEMM
    and the diagonal einsum sum each output element in an order that
    does not depend on nk. Same calling convention as
    :func:`make_sweep_overlapped`."""
    st = prog.stream_tables
    if st is None:
        raise ValueError(
            "build_program(..., options=PlanOptions(stream=True)) first")
    b, P, N, A = prog.b, tables.P, tables.N, tables.arena_blocks
    nbr, nbc = st.nbr, st.nbc
    shape = (P, nbr, nbc, b, b)
    levels = tables.levels_padded if padded else tables.levels

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh, Dinv, shape, tables.device, batched)
        B = Lh.shape[0]
        lh_flat = Lh.reshape(B, P * N, b, b)
        Dinv_f = Dinv.reshape(B, P, N, b, b)
        arena = _init_arena(tables, Dinv_f, b)
        flat = arena.view(B, P * A, b, b)
        for t in range(st.steps):
            for kind, li in tables.compute_at[t]:
                _compute(kind, levels[li], N, arena, flat, Dinv_f, nbr,
                         nbc, b)
            _local_lanes(flat, lh_flat, tables.local[t])
            ln = tables.comm[t]
            if ln is None:
                continue
            payload = _gather_lanes(flat, lh_flat, ln).view(
                B, P, ln.width, b, b)
            moved = torch.zeros_like(payload)
            for cs in ln.slots:
                _ship_slot(payload, moved, cs, t)
            _land(flat, moved.view(B, P * ln.width, b, b), ln)
        out = arena[:, :, :N].reshape(B, *shape).clone(
            memory_format=torch.contiguous_format)
        return out if batched else out[0]

    return sweep


# ---------------------------------------------------------------------------
# the legacy unrolled sweep: one supernode at a time (the pre-IR executor)
# ---------------------------------------------------------------------------

def _pack_rounds(pairs: List[Tuple[int, int, int]]):
    """Greedy-pack (src, dst, key) transfers into permute rounds with
    unique sources and destinations per round."""
    rounds: List[List[Tuple[int, int, int]]] = []
    for p in pairs:
        for rnd in rounds:
            if all(p[0] != q[0] and p[1] != q[1] for q in rnd):
                rnd.append(p)
                break
        else:
            rounds.append([p])
    return rounds


def _merge_tree_rounds(trees: Sequence[Tuple[CommTree, callable]], op: str):
    """Merge several disjoint-group trees into shared global-id rounds
    (``mapper`` translates tree coordinates to global rank ids) through
    the IR's :func:`~.plan.merge_round_lists`."""
    per_tree = []
    for tree, mapper in trees:
        rounds = tree.bcast_rounds() if op == "bcast" else tree.reduce_rounds()
        per_tree.append([[(mapper(s), mapper(d)) for (s, d) in rnd]
                         for rnd in rounds])
    return merge_round_lists(per_tree, op)


@dataclass
class _IterSchedule:
    K: int
    C: List[int]
    xfer_in_rounds: list          # rounds of (src, dst, I)
    xfer_in_local: List[int]      # I with owner(I,K) == owner(K,I)
    bcast_rounds: list            # merged global-id rounds
    reduce_rounds: list
    xfer_out_rounds: list         # rounds of (src, dst, J)
    xfer_out_local: List[int]
    diag_reduce_rounds: list
    col_mask: np.ndarray          # (NBc, pc) 1.0 where global col in C
    row_mask: np.ndarray          # (NBr, pr)


def build_program_unrolled(bs: BlockStructure, nb: int, b: int, pr: int,
                           pc: int, kind: TreeKind = TreeKind.SHIFTED
                           ) -> PSelInvProgram:
    """The pre-IR per-supernode schedule (one tree per grid column/row per
    supernode, re-derived here rather than read from the CommPlan) — the
    host code of ``repro/core/pselinv_dist.py:build_program_unrolled``,
    same arguments, same ``iters``."""
    if nb % pr or nb % pc:
        raise ValueError(f"nb={nb} not divisible by grid {pr}x{pc}")
    nbr, nbc = nb // pr, nb // pc

    def owner(I: int, J: int) -> int:
        return (I % pr) * pc + (J % pc)

    iters: List[_IterSchedule] = []
    for K in range(nb - 1, -1, -1):
        C = [int(i) for i in bs.struct[K]] if K < bs.nsuper else []
        krow, kcol = K % pr, K % pc

        # (a) xfer-in
        pairs, local = [], []
        for I in C:
            s, d = owner(I, K), owner(K, I)
            (local if s == d else pairs).append(
                I if s == d else (s, d, I))
        xfer_in_rounds = _pack_rounds(pairs)

        # (b) col-bcast: per grid column, tree over participant rows
        rows = sorted({J % pr for J in C})
        recv_rows = [r for r in rows if r != krow]
        bcast_trees = []
        if recv_rows:
            for c in range(pc):
                tag = stable_hash(K, c, 0xB)
                tree = build_tree(kind, krow, recv_rows, tag=tag)
                bcast_trees.append(
                    (tree, (lambda cc: (lambda r: r * pc + cc))(c)))
        bcast_rounds = _merge_tree_rounds(bcast_trees, "bcast")

        # (c) row-reduce: per grid row, tree over participant cols
        cols = sorted({I % pc for I in C} | {kcol})
        recv_cols = [c for c in cols if c != kcol]
        red_trees = []
        if recv_cols:
            for r in range(pr):
                tag = stable_hash(K, r, 0xC)
                tree = build_tree(kind, kcol, recv_cols, tag=tag)
                red_trees.append(
                    (tree, (lambda rr: (lambda c: rr * pc + c))(r)))
        reduce_rounds = _merge_tree_rounds(red_trees, "reduce")

        # (f) xfer-out (transpose to upper)
        pairs, localo = [], []
        for J in C:
            s, d = owner(J, K), owner(K, J)
            (localo if s == d else pairs).append(
                J if s == d else (s, d, J))
        xfer_out_rounds = _pack_rounds(pairs)

        # (g) diagonal reduce within grid row krow
        diag_trees = []
        if recv_cols:
            tag = stable_hash(K, 0xD)
            tree = build_tree(kind, kcol, recv_cols, tag=tag)
            diag_trees.append((tree, lambda c: krow * pc + c))
        diag_reduce_rounds = _merge_tree_rounds(diag_trees, "reduce")

        mask = np.zeros(nb)
        for I in C:
            mask[I] = 1.0
        iters.append(_IterSchedule(
            K=K, C=C, xfer_in_rounds=xfer_in_rounds, xfer_in_local=local,
            bcast_rounds=bcast_rounds, reduce_rounds=reduce_rounds,
            xfer_out_rounds=xfer_out_rounds, xfer_out_local=localo,
            diag_reduce_rounds=diag_reduce_rounds,
            col_mask=mask.reshape(nbc, pc), row_mask=mask.reshape(nbr, pr)))

    return PSelInvProgram(nb=nb, b=b, pr=pr, pc=pc, kind=kind, bs=bs,
                          iters=iters)


def unrolled_moved(prog: PSelInvProgram) -> Tuple[int, int]:
    """(rounds, blocks) the unrolled sweep moves between ranks, read off
    the host schedule: one ``(b, b)`` block a pair of an xfer or diagonal
    round, the whole Û buffer (``nbc`` blocks) a pair of a broadcast
    round and the whole partial (``nbr`` blocks) a pair of a reduction
    round — what each JAX round ships. Owner-local moves are not
    counted."""
    if prog.iters is None:
        raise ValueError("build_program_unrolled() first")
    rounds = blocks = 0
    for it in prog.iters:
        for rnds, width in ((it.xfer_in_rounds, 1),
                            (it.bcast_rounds, prog.nbc),
                            (it.reduce_rounds, prog.nbr),
                            (it.xfer_out_rounds, 1),
                            (it.diag_reduce_rounds, 1)):
            rounds += len(rnds)
            blocks += width * sum(len(r) for r in rnds)
    return rounds, blocks


@dataclass
class UnrolledIter:
    """Supernode K of the unrolled sweep on one device: the owner
    ``root`` of (K, K) and its flat A⁻¹ ``slot``; the nk=1 compute masks
    ``lv`` (None when struct(K) is empty: the owner's A⁻¹(K,K) is D⁻¹);
    the fused xfer-in (flat L̂ gather over ``P·N`` blocks, flat Û scatter
    over ``P·nbc``) and xfer-out (flat A⁻¹ gather of column K, scatter
    into row K) addresses, owner-local moves and every round's pairs in
    one index pair each — every target is written once, so the rounds of
    an xfer phase commute; and each tree round's (src, dst) rank
    tensors for the broadcast, the row reduction and the diagonal
    reduction, which run one after another (tree nodes forward what they
    received)."""
    K: int
    root: int
    slot: int
    lv: Optional[LevelTables]
    xin: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    xout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    bcast: List[Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=list)
    reduce: List[Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=list)
    diag: List[Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=list)


@dataclass
class UnrolledTables:
    """Every table the unrolled sweep reads, on one device."""
    device: torch.device
    P: int
    N: int
    iters: List[UnrolledIter]
    nbytes: int = 0


def _unrolled_levels(prog: PSelInvProgram, ranks: np.ndarray,
                     up) -> List[Optional[LevelTables]]:
    """The nk=1 compute masks of every supernode with a non-empty
    struct, for the ranks ``ranks`` (all P, or one rank process's own),
    stacked over supernodes into one upload a mask: ``cm`` the struct
    columns at each rank's grid column, ``w`` the column-write rows at the
    owners of column K, ``rm`` grid row K%pr, ``droot`` the owner of
    (K, K)."""
    pr, pc, nbc = prog.pr, prog.pc, prog.nbc
    r, c = ranks // pc, ranks % pc
    live = [it for it in prog.iters if it.C]
    if not live:
        return [None] * len(prog.iters)
    K = np.array([it.K for it in live])
    krow, kcol, kr, kc = K % pr, K % pc, K // pr, K // pc
    cm = np.stack([it.col_mask.T[c] > 0 for it in live])[:, :, None, :]
    w = np.stack([(it.row_mask.T[r] > 0) & (c == q)[:, None]
                  for it, q in zip(live, kcol)])[..., None]
    rm = (r[None, :] == krow[:, None])[:, :, None]
    droot = (ranks[None, :] == (krow * pc + kcol)[:, None])[:, :, None]
    cm, w, rm, droot = (up(x, torch.bool) for x in (cm, w, rm, droot))
    idx = up(np.stack([kc, kr, kr * nbc + kc]))[:, :, None]
    out, j = [], 0
    for it in prog.iters:
        if not it.C:
            out.append(None)
            continue
        out.append(LevelTables(
            nk=1, cm=cm[j], kcs=idx[0, j], w=w[j], krs=idx[1, j],
            rm=rm[j], dslot=idx[2, j], dslot_c=idx[2, j], droot=droot[j]))
        j += 1
    return out


def upload_unrolled_tables(prog: PSelInvProgram, device) -> UnrolledTables:
    """Lower the unrolled schedule (:func:`build_program_unrolled`) to
    device tensors — once per session, every address in one upload and
    checked against the buffer it indexes, every scatter target checked
    to be written once."""
    from .device import resolve_device

    if prog.iters is None:
        raise ValueError("build_program_unrolled() first")
    dev = resolve_device(device)
    pr, pc, nbr, nbc = prog.pr, prog.pc, prog.nbr, prog.nbc
    P, N = pr * pc, nbr * nbc
    up = _uploader(dev)
    levels = _unrolled_levels(prog, np.arange(P), up)
    parts: List[np.ndarray] = []

    def add(name, a, hi, unique=False):
        a = np.asarray(a, np.int64).reshape(-1)
        _in_bounds(name, a, hi)
        if unique and len(set(a.tolist())) != a.size:
            raise ValueError(f"{name} writes one target twice")
        parts.append(a)
        return len(parts) - 1

    plan = []
    for it, lv in zip(prog.iters, levels):
        K = it.K
        krow, kcol, kr, kc = K % pr, K % pc, K // pr, K // pc
        e = dict(K=K, root=krow * pc + kcol, slot=kr * nbc + kc, lv=lv)
        if it.C:
            name = f"supernode {K}"
            xin = ([(I, I) for I in it.xfer_in_local]
                   + [(I, d) for rnd in it.xfer_in_rounds for _, d, I in rnd])
            src = [((I % pr) * pc + kcol) * N + (I // pr) * nbc + kc
                   for I, _ in xin]
            dst = [(krow * pc + I % pc) * nbc + I // pc for I, _ in xin]
            e["xin"] = (add(f"{name} xfer_in gather", src, P * N),
                        add(f"{name} xfer_in scatter", dst, P * nbc, True))
            xout = (list(it.xfer_out_local)
                    + [J for rnd in it.xfer_out_rounds for _, _, J in rnd])
            src = [((J % pr) * pc + kcol) * N + (J // pr) * nbc + kc
                   for J in xout]
            dst = [(krow * pc + J % pc) * N + kr * nbc + J // pc
                   for J in xout]
            e["xout"] = (add(f"{name} xfer_out gather", src, P * N),
                         add(f"{name} xfer_out scatter", dst, P * N, True))
            for key, rounds in (("bcast", it.bcast_rounds),
                                ("reduce", it.reduce_rounds),
                                ("diag", it.diag_reduce_rounds)):
                e[key] = [(add(f"{name} {key} src", [s for s, _ in rnd], P),
                           add(f"{name} {key} dst", [d for _, d in rnd], P,
                               True)) for rnd in rounds]
        plan.append(e)
    flat = up(np.concatenate(parts) if parts else np.zeros(0, np.int64))
    cuts = np.cumsum([0] + [len(a) for a in parts])

    def view(i):
        return flat[cuts[i]:cuts[i + 1]]

    iters = []
    for e in plan:
        for key in ("xin", "xout"):
            if key in e:
                e[key] = tuple(view(i) for i in e[key])
        for key in ("bcast", "reduce", "diag"):
            if key in e:
                e[key] = [(view(s), view(d)) for s, d in e[key]]
        iters.append(UnrolledIter(**e))
    tabs = UnrolledTables(device=dev, P=P, N=N, iters=iters)
    _count_bytes(tabs, [tabs, *iters,
                        *[lv for lv in levels if lv is not None]])
    return tabs


def _tree_round(x, src, dst, add: bool) -> None:
    """One tree round over the rank axis of ``x`` (``(B, P, …)``): the
    senders' whole buffers land at the receivers, overwriting (a
    broadcast) or added to what is there (a reduction: receiver + sender,
    the JAX round's order)."""
    moved = x.index_select(1, src)
    if add:
        moved = x.index_select(1, dst) + moved
    x.index_copy_(1, dst, moved)


def make_sweep_unrolled(prog: PSelInvProgram, tables: UnrolledTables):
    """The pre-IR sweep — the paper's per-supernode algorithm, the port
    of the JAX ``make_sweep_unrolled`` — over ``tables`` (from
    :func:`upload_unrolled_tables`), all P ranks as the leading axis: for
    each supernode K from the last, xfer-in builds the Û(K, ·) buffer
    (one gather, transpose and scatter for all its rounds), the column
    broadcast ships each sender's whole Û buffer round by round, one
    masked GEMM runs in the hand-written block-GEMM kernel
    (``ops.pselinv_round_gemm`` at nk=1: Z = P, one launch per
    supernode with a non-empty struct), the row reduction adds each
    sender's whole partial, then the column write, xfer-out and the
    diagonal sum (as :func:`_diag_sum` computes it), its reduction and
    write. Takes one matrix's ``(P, nbr, nbc, b, b)`` shards, as the JAX
    sweep does, and returns its A⁻¹ shards; the kernels see a B=1 axis."""
    if prog.iters is None:
        raise ValueError("use build_program_unrolled()")
    b, P, N = prog.b, tables.P, tables.N
    nbr, nbc = prog.nbr, prog.nbc
    shape = (P, nbr, nbc, b, b)

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh, Dinv, shape, tables.device, False)
        lh_flat = Lh.reshape(1, P * N, b, b)
        Dinv_f = Dinv.reshape(1, P, N, b, b)
        ainv = Lh.new_zeros((1, P, N, b, b))
        aflat = ainv.view(1, P * N, b, b)
        Ainv = ainv.view(1, P, nbr, nbc, b, b)
        for it in tables.iters:
            lv = it.lv
            if lv is None:
                ainv[:, it.root, it.slot] = Dinv_f[:, it.root, it.slot]
                continue
            # (a) xfer-in: Û(K, I) = L̂(I, K)ᵀ at the owner of (K, I)
            uh = Lh.new_zeros((1, P, nbc, b, b))
            g, s = it.xin
            uh.view(1, P * nbc, b, b).index_copy_(
                1, s, lh_flat.index_select(1, g).transpose(-1, -2))
            # (b) the column broadcast of the whole Û buffer
            for src, dst in it.bcast:
                _tree_round(uh, src, dst, add=False)
            # (1) the local GEMM, (c) the row reduction of the partials
            U = uh.view(1, P, 1, nbc, b, b)
            part = pselinv_round_gemm(Ainv, U, lv.cm)
            for src, dst in it.reduce:
                _tree_round(part, src, dst, add=True)
            _write_cols(Ainv, part, lv)
            # (f) xfer-out: A⁻¹(K, J) = A⁻¹(J, K)ᵀ
            g, s = it.xout
            aflat.index_copy_(1, s, aflat.index_select(1, g).transpose(-1, -2))
            # (2, 3) the diagonal
            S = _diag_sum(Ainv, U, lv)
            for src, dst in it.diag:
                _tree_round(S, src, dst, add=True)
            _write_diag(ainv, Dinv_f, S, lv)
        return ainv.view(*shape)

    return sweep


def make_sweep_unrolled_ranked(prog: PSelInvProgram, rank: int,
                               group=None, device="cuda"):
    """The unrolled sweep as rank ``rank`` of a ``pr·pc``-process group
    runs it, on its own ``(nbr, nbc, b, b)`` shards on ``device``. Each
    round of the host schedule is one :func:`~..comm.p2p.ppermute` on
    every rank, of exactly the payload the JAX round ships: one ``(b,
    b)`` block in an xfer or diagonal round, the whole Û buffer in a
    broadcast round, the whole partial in a reduction round (added at
    the receiver). Owner-local moves copy; the local GEMM runs in the
    hand-written kernel at Z=1 and the compute phases are
    :func:`make_sweep_unrolled`'s, so on the CPU a rank's shard is bitwise
    the single-process sweep's."""
    import torch.distributed as dist

    from .device import resolve_device

    if prog.iters is None:
        raise ValueError("use build_program_unrolled()")
    if dist.get_rank(group) != rank or (
            dist.get_world_size(group) != prog.pr * prog.pc):
        raise ValueError(
            f"rank {rank} of a {prog.pr}x{prog.pc} grid, but this process "
            f"is rank {dist.get_rank(group)} of "
            f"{dist.get_world_size(group)}")
    dev = resolve_device(device)
    b, pr, pc, nbr, nbc = prog.b, prog.pr, prog.pc, prog.nbr, prog.nbc
    N = nbr * nbc
    levels = _unrolled_levels(prog, np.array([rank]), _uploader(dev))

    def reduce(x, rounds):
        for rnd in rounds:
            moved = ppermute(x, rnd, group)
            if any(d == rank for _, d in rnd):
                x = x + moved
        return x

    def xfer(kcol, local, rounds, get, out, slot, hole):
        """Owner-local moves, then each round's one block a pair:
        ``out[slot(i)] = get(i)ᵀ`` at the owner of the target."""
        for i in local:
            if (i % pr) * pc + kcol == rank:
                out[slot(i)] = get(i).transpose(-1, -2)
        for rnd in rounds:
            blk = next((get(i) for s, _, i in rnd if s == rank), hole)
            moved = ppermute(blk, [(s, d) for s, d, _ in rnd], group)
            for _, d, i in rnd:
                if d == rank:
                    out[slot(i)] = moved.transpose(-1, -2)

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        Lh, Dinv = _values(Lh[None], Dinv[None], (1, nbr, nbc, b, b), dev,
                           False)
        lh = Lh[0, 0]
        Dinv_f = Dinv.reshape(1, 1, N, b, b)
        ainv = Lh.new_zeros((1, 1, N, b, b))
        Ainv = ainv.view(1, 1, nbr, nbc, b, b)
        a = Ainv[0, 0]
        hole = Lh.new_zeros((b, b))
        for it, lv in zip(prog.iters, levels):
            K = it.K
            krow, kcol, kr, kc = K % pr, K % pc, K // pr, K // pc
            if lv is None:
                if rank == krow * pc + kcol:
                    a[kr, kc] = Dinv[0, 0, kr, kc]
                continue
            uh = Lh.new_zeros((nbc, b, b))
            xfer(kcol, it.xfer_in_local, it.xfer_in_rounds,
                 lambda i: lh[i // pr, kc], uh, lambda i: i // pc, hole)
            for rnd in it.bcast_rounds:
                uh = ppermute(uh, rnd, group)
            U = uh.view(1, 1, 1, nbc, b, b)
            part = reduce(pselinv_round_gemm(Ainv, U, lv.cm),
                          it.reduce_rounds)
            _write_cols(Ainv, part, lv)
            xfer(kcol, it.xfer_out_local, it.xfer_out_rounds,
                 lambda j: a[j // pr, kc], a[kr], lambda j: j // pc, hole)
            S = reduce(_diag_sum(Ainv, U, lv), it.diag_reduce_rounds)
            _write_diag(ainv, Dinv_f, S, lv)
        return a

    return sweep


# ---------------------------------------------------------------------------
# host-side data preparation / gather
# ---------------------------------------------------------------------------

def validate_uniform_widths(bs: BlockStructure, b: int) -> None:
    """The dense-blocked layout requires every supernode at width b —
    one check shared by every structure entry point (matrix or ready
    :class:`BlockStructure`)."""
    if not np.all(bs.widths() == b):
        raise ValueError(
            f"structure has non-uniform supernode widths "
            f"{sorted(set(bs.widths().tolist()))} — the dense-blocked "
            f"layout requires every supernode to have width exactly "
            f"b={b}")


def pad_nb(nsuper: int, pr: int, pc: int) -> int:
    """Pad the supernode count so both grid dims divide it (the one
    padding rule — engine cache keys depend on it being identical for
    every entry point)."""
    nb = nsuper
    while nb % pr or nb % pc:
        nb += 1
    return nb


def analyze_structure(A, b: int, pr: int, pc: int
                      ) -> Tuple[BlockStructure, int]:
    """The value-independent half of :func:`prepare_inputs`: symbolic
    factorization + uniform-width validation + grid padding. Everything
    the engine caches hangs off this (bs, nb) pair."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    # real input validation, not asserts: these guard user-provided
    # matrices and must survive ``python -O``
    if n % b:
        raise ValueError(
            f"matrix size n={n} is not a multiple of the supernode block "
            f"size b={b} — pad the matrix (or pick b dividing n)")
    bs = symbolic_factorize(A, max_supernode=b)
    validate_uniform_widths(bs, b)
    return bs, pad_nb(bs.nsuper, pr, pc)


def check_values_pattern(A, bs: BlockStructure, b: int):
    """Validate one matrix's *pattern* against an analyzed structure.

    The structured factorization only ever visits blocks in
    ``bs.struct``, so a matrix whose pattern escapes the analyzed
    structure would be silently truncated into the selected inverse of a
    *different* matrix — reject it instead (O(nnz) block-coordinate
    check against the symmetric filled pattern). Returns the matrix as
    CSR. Shared by :func:`prepare_values`, the batched
    :func:`prepare_values_many`, and the serving layer's per-request
    admission check (``repro.serve``) — a bad request must be rejectable
    *before* it joins a batch, so its neighbors still solve."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n != int(bs.offsets[-1]):
        raise ValueError(
            f"matrix size n={n} does not match the analyzed structure "
            f"(expected n={int(bs.offsets[-1])}) — re-run analyze for a "
            "different-sized matrix")
    nb0 = bs.nsuper
    present = np.zeros((nb0, nb0), dtype=bool)
    np.fill_diagonal(present, True)
    for K in range(nb0):
        present[np.asarray(bs.struct[K], dtype=np.int64), K] = True
    coo = A.tocoo()
    hi = np.maximum(coo.row // b, coo.col // b)
    lo = np.minimum(coo.row // b, coo.col // b)
    bad = (coo.data != 0) & ~present[hi, lo]
    if bad.any():
        blocks = sorted({(int(i), int(j))
                         for i, j in zip(hi[bad], lo[bad])})[:8]
        raise ValueError(
            f"matrix has {int(bad.sum())} nonzero(s) outside the "
            f"analyzed block structure (e.g. blocks {blocks}) — its "
            "sparsity pattern differs from the analyzed matrix; re-run "
            "analyze for this structure")
    return A


def _shard_blocks(G: np.ndarray, nb: int, b: int, pr: int,
                  pc: int) -> np.ndarray:
    """Dense (…, nb, nb, b, b) block grid → (…, pr*pc, nbr, nbc, b, b)
    device shards for ``in_specs=P("xy")`` (cyclic over both grid dims).
    The one layout rule — :func:`prepare_values`,
    :func:`prepare_values_many` and :func:`gather_blocks` must agree."""
    nbr, nbc = nb // pr, nb // pc
    lead = G.shape[:-4]
    G = G.reshape(lead + (nbr, pr, nbc, pc, b, b))
    perm = tuple(range(len(lead)))
    off = len(lead)
    G = G.transpose(perm + (off + 1, off + 3, off, off + 2,
                            off + 4, off + 5))
    return G.reshape(lead + (pr * pc, nbr, nbc, b, b))


_PREPARE_S = REGISTRY.counter(
    "selinv_prepare_seconds_total",
    "host seconds of the value prepare, by step (factor, layout, upload)",
    ("step",))
_PREPARE_CALLS = REGISTRY.counter(
    "selinv_prepare_calls_total",
    "value prepares (prepare_values and prepare_values_many calls)")


@contextmanager
def prepare_step(step: str):
    """One step of a value prepare — ``factor`` (the pattern check, the
    supernodal LU, L̂ and D⁻¹), ``layout`` (the dense block fill and the
    shard layout) or ``upload`` (the copy to the device): the span
    ``prepare.<step>`` and its host seconds added to
    ``selinv_prepare_seconds_total{step}``, always on."""
    t0 = time.perf_counter()
    try:
        with TRACER.span(f"prepare.{step}"):
            yield
    finally:
        _PREPARE_S.labels(step).inc(time.perf_counter() - t0)


def prepare_values(A, bs: BlockStructure, nb: int, b: int, pr: int,
                   pc: int) -> Tuple[np.ndarray, np.ndarray]:
    """The numeric half of :func:`prepare_inputs`: factorize this
    matrix's *values* on the host against an already-analyzed structure,
    normalize, and lay out the dense-blocked shards (the steps
    ``factor`` and ``layout`` of :func:`prepare_step`).

    Returns (Lh, Dinv) with shape (pr*pc, nbr, nbc, b, b) for
    ``in_specs=P("xy")``. The caller guarantees ``A`` has the sparsity
    structure that produced ``bs`` — this is the engine's analyze-once /
    solve-many hot path, so no symbolic work happens here."""
    import scipy.linalg as sla

    _PREPARE_CALLS.inc()
    nb0 = bs.nsuper
    with prepare_step("factor"):
        A = check_values_pattern(A, bs, b)
        lu = factorize(A, bs=bs, backend="numpy")
        Lhat, _ = normalize_factors(lu)
        dinv = []
        for K in range(nb0):
            linv = sla.solve_triangular(np.asarray(lu.Ldiag[K]), np.eye(b),
                                        lower=True, unit_diagonal=True)
            dinv.append(sla.solve_triangular(np.asarray(lu.Udiag[K]), linv,
                                             lower=False))

    with prepare_step("layout"):
        Lh_g = np.zeros((nb, nb, b, b))
        Dinv_g = np.zeros((nb, nb, b, b))
        for (I, K), blk in Lhat.items():
            Lh_g[I, K] = np.asarray(blk)
        for K in range(nb0):
            Dinv_g[K, K] = dinv[K]
        for K in range(nb0, nb):       # padding supernodes: identity diag
            Dinv_g[K, K] = np.eye(b)
        return (_shard_blocks(Lh_g, nb, b, pr, pc),
                _shard_blocks(Dinv_g, nb, b, pr, pc))


def _batched_lu_nopivot(Akk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Doolittle LU without pivoting over a (B, b, b) block stack —
    the batched twin of ``supernodal_lu.dense_lu_nopivot`` (same
    elimination order, so the factors agree to rounding)."""
    B, b = Akk.shape[0], Akk.shape[1]
    lu = Akk.copy()
    for k in range(b - 1):
        piv = lu[:, k, k]
        lu[:, k + 1:, k] /= piv[:, None]
        lu[:, k + 1:, k + 1:] -= (lu[:, k + 1:, k, None]
                                  * lu[:, None, k, k + 1:])
    L = np.tril(lu, -1) + np.eye(b)
    return L, np.triu(lu)


def prepare_values_many(mats: Sequence, bs: BlockStructure, nb: int,
                        b: int, pr: int, pc: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched host factorization: B same-structure matrices → stacked
    ``(B, pr*pc, nbr, nbc, b, b)`` shards in ONE structure-driven pass.

    Same math as B :func:`prepare_values` calls — right-looking
    supernodal LU over the filled structure, factor normalization,
    diagonal inverses — but the Python loop over supernodes runs once
    with every block stacked ``(B, b, b)``, so the interpreter overhead
    that dominates the single-matrix path (measured ~11 ms/matrix at
    nb=16) amortizes across the batch (~1.3 ms/matrix at B=16). This is
    the serving layer's host-side half of the batching win: without it a
    coalesced batch still pays B sequential GIL-bound factorizations.

    The dense (nb0, nb0) block workspace is the same asymptotic
    footprint as the device layout :func:`prepare_values` already
    emits. Numerics match the single-matrix scipy path to rounding
    (≤1e-12 asserted in tests; observed ~1e-18).

    Raises ``ValueError`` naming the offending batch *index* when any
    matrix's pattern escapes the analyzed structure — callers that need
    per-request isolation (the serving layer) validate each matrix with
    :func:`check_values_pattern` first."""
    if not len(mats):
        raise ValueError("prepare_values_many needs at least one matrix")
    _PREPARE_CALLS.inc()
    B, nb0 = len(mats), bs.nsuper
    eye = np.eye(b)
    with prepare_step("factor"):
        csr = []
        for i, M in enumerate(mats):
            try:
                csr.append(check_values_pattern(M, bs, b))
            except ValueError as e:
                raise ValueError(f"matrix {i} of {len(mats)}: {e}") from e

        # dense (B, nb0, nb0, b, b) block workspace holding the evolving
        # Schur complement; fill lands in blocks the symbolic structure
        # already owns, so reading only struct blocks below is exact
        W = np.stack([np.asarray(M.todense()) for M in csr])
        W = (W.reshape(B, nb0, b, nb0, b).transpose(0, 1, 3, 2, 4)
              .astype(np.float64, copy=True))
        lh_cols, dinv = [], []
        bidx = np.arange(B)
        for K in range(nb0):
            L, U = _batched_lu_nopivot(W[:, K, K])
            C = [int(i) for i in bs.struct[K]]
            if C:
                # L(C,K): X·U = A  ⇔  Uᵀ·Xᵀ = Aᵀ (batched, broadcast
                # over C)
                LCK = np.linalg.solve(
                    U.transpose(0, 2, 1)[:, None],
                    W[:, C, K].transpose(0, 1, 3, 2)).transpose(0, 1, 3, 2)
                UKC = np.linalg.solve(L[:, None], W[:, K, C])   # L·X = A
                W[:, C, K] = LCK
                W[:, K, C] = UKC
                # Schur update over the whole struct(K) × struct(K) clique
                W[np.ix_(bidx, C, C)] -= np.einsum(
                    'bikl,bjlm->bijkm', LCK, UKC)
                # L̂(C,K) = L(C,K)·L(K,K)⁻¹:  X·L = A  ⇔  Lᵀ·Xᵀ = Aᵀ
                lh_cols.append((C, K, np.linalg.solve(
                    L.transpose(0, 2, 1)[:, None],
                    LCK.transpose(0, 1, 3, 2)).transpose(0, 1, 3, 2)))
            linv = np.linalg.solve(L, np.broadcast_to(eye, (B, b, b)))
            dinv.append(np.linalg.solve(U, linv))   # (U_KK)⁻¹(L_KK)⁻¹

    with prepare_step("layout"):
        Lh = np.zeros((B, nb, nb, b, b))
        Dinv = np.zeros((B, nb, nb, b, b))
        for C, K, blk in lh_cols:
            Lh[:, C, K] = blk
        for K in range(nb0):
            Dinv[:, K, K] = dinv[K]
        Dinv[:, range(nb0, nb), range(nb0, nb)] = eye   # padding supernodes
        return (_shard_blocks(Lh, nb, b, pr, pc),
                _shard_blocks(Dinv, nb, b, pr, pc))


def prepare_inputs(A, b: int, pr: int, pc: int):
    """Factorize (host), normalize, and lay out dense-blocked shards.

    Returns (bs, nb, Lh, Dinv), the arrays shaped (pr*pc, nbr, nbc, b,
    b). Back-compat composition of :func:`analyze_structure` and
    :func:`prepare_values`, deprecated as in the JAX package."""
    warnings.warn(
        "prepare_inputs is deprecated: use PSelInvEngine.analyze(...) + "
        "engine.prepare_values(...) (the analyze-once/solve-many split) "
        "or analyze_structure/prepare_values directly",
        DeprecationWarning, stacklevel=2)
    bs, nb = analyze_structure(A, b, pr, pc)
    Lh_s, Dinv_s = prepare_values(A, bs, nb, b, pr, pc)
    return bs, nb, Lh_s, Dinv_s


def check_grid_devices(pr: int, pc: int, group=None) -> None:
    """Raise the canonical diagnostic unless the process group has one
    rank per grid position (a process outside any group is a group of
    one)."""
    import torch.distributed as dist

    have = dist.get_world_size(group) if dist.is_initialized() else 1
    if pr * pc != have:
        raise ValueError(
            f"process grid {pr}x{pc} needs {pr * pc} devices, one rank "
            f"process each, but the process group has {have} — change the "
            f"grid or launch {pr * pc} ranks "
            "(repro_torch.comm.p2p.spawn)")


def _scatter_values(A, prog: PSelInvProgram, group) -> torch.Tensor:
    """Rank 0 prepares the value shards once (the host factorization)
    and sends each rank its own, outside the sweep: (2, nbr, nbc, b, b)
    f64 on the host, L̂ then D⁻¹."""
    import torch.distributed as dist

    from ..comm.p2p import global_rank

    shard = torch.empty((2, prog.nbr, prog.nbc, prog.b, prog.b),
                        dtype=torch.float64)
    parts = None
    if dist.get_rank(group) == 0:
        Lh, Dinv = prepare_values(A, prog.bs, prog.nb, prog.b, prog.pr,
                                  prog.pc)
        parts = list(torch.from_numpy(np.stack([Lh, Dinv], axis=1)))
    dist.scatter(shard, parts, src=global_rank(group, 0), group=group)
    return shard


def run_distributed(A, b: int, pr: int, pc: int,
                    kind: TreeKind = TreeKind.SHIFTED,
                    dtype: torch.dtype = torch.float32,
                    pipelined: bool = True, overlap: bool = True,
                    device="cuda", group=None):
    """End-to-end selected inversion by ``pr·pc`` rank processes — each
    process of ``group`` (the default group when None) calls it with the
    same arguments. Every rank analyzes ``A`` (deterministic); rank 0
    prepares the values once and sends each rank its shards; each rank
    runs the overlapped sweep (:func:`make_sweep_overlapped_ranked`) or,
    with ``overlap=False``, the level-serial one
    (:func:`make_sweep_ranked`) on ``device`` over its own tables, its
    level GEMMs in the hand-written kernel, its rounds as point-to-point
    messages; an
    ``all_gather`` after the sweep hands every rank the full ``(P, nbr,
    nbc, b, b)`` numpy array, so ``gather_blocks(out, prog)`` works as in
    the JAX package. Returns ``(out, prog)``.

    Unlike the JAX package's shim over its engine this entry point is
    not deprecated: the port's engine runs every rank in one process,
    and this is its multi-process path. ``pipelined=False`` runs the
    legacy unrolled sweep (:func:`build_program_unrolled`,
    :func:`make_sweep_unrolled_ranked`: per supernode, every round of
    the JAX schedule one point-to-point message of the JAX round's
    payload) over the ranks, where the JAX package runs it on its mesh
    in one process. ``device="cuda"`` raises on a rank that has no card;
    on a one-card machine every rank shares ``cuda:0``."""
    import torch.distributed as dist

    from .device import resolve_device

    check_grid_devices(pr, pc, group)
    dev = resolve_device(device)
    rank = dist.get_rank(group)
    bs, nb = analyze_structure(A, b, pr, pc)
    prog = (build_program(bs, nb, b, pr, pc, kind=kind, overlap=overlap)
            if pipelined else build_program_unrolled(bs, nb, b, pr, pc,
                                                     kind=kind))
    shard = _scatter_values(A, prog, group)
    if not pipelined:
        sweep = make_sweep_unrolled_ranked(prog, rank, group, dev)
    elif overlap:
        sweep = make_sweep_overlapped_ranked(
            prog, rank_tables(upload_tables(prog, "cpu"), rank, dev), rank,
            group)
    else:
        sweep = make_sweep_ranked(
            prog, rank_exec_tables(upload_exec_tables(prog, "cpu"), rank,
                                   dev), rank, group)
    out = sweep(shard[0].to(dev, dtype), shard[1].to(dev, dtype))
    host = out.cpu()        # the result goes back as numpy
    parts = [torch.empty_like(host) for _ in range(pr * pc)]
    dist.all_gather(parts, host, group=group)
    return torch.stack(parts).numpy(), prog


def gather_blocks(out, prog):
    """Invert the shard layout back to a dense (nb, nb, b, b) block grid.
    Accepts the :class:`PSelInvProgram` or anything carrying one under
    ``.program`` (the engine), and a numpy array or a tensor (returned
    as the same kind) — the geometry is derived, not re-passed."""
    prog = getattr(prog, "program", prog)
    nb, b, pr, pc = prog.nb, prog.b, prog.pr, prog.pc
    nbr, nbc = nb // pr, nb // pc
    g = out.reshape(pr, pc, nbr, nbc, b, b)
    g = (g.permute(2, 0, 3, 1, 4, 5) if isinstance(g, torch.Tensor)
         else g.transpose(2, 0, 3, 1, 4, 5))
    return g.reshape(nb, nb, b, b)
