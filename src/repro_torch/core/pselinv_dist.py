"""Distributed PSelInv on one card — the port of
``repro/core/pselinv_dist.py``'s executors to PyTorch.

The JAX package runs the selected-inversion sweep as one SPMD program
under ``shard_map`` over ``P = pr·pc`` devices. Here every rank is a
*virtual* rank on one device: the per-rank state is one leading ``P``
axis of a single tensor, and a batch of same-structure matrices is one
more axis in front of it (``(B, P, …)``).

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

Every executor runs each level's masked GEMM in the hand-written
block-GEMM kernel (``ops.pselinv_round_gemm``).

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

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import pselinv_round_gemm
from ..obs.trace import TRACER
from .plan import (CommPlan, ExecPlan, OverlappedExec, PlanOptions,
                   build_plan, compile_exec, schedule_overlapped,
                   schedule_stream)
from .schedule import Grid2D
from .selinv import normalize_factors
from .stream import COMP_KIND_ID, COMP_NOOP, StreamTables
from .supernodal_lu import factorize
from .symbolic import BlockStructure, symbolic_factorize
from .trees import TreeKind

__all__ = ["PSelInvProgram", "build_program", "SweepTables",
           "ExecTables", "StreamSweepTables", "upload_tables",
           "upload_exec_tables", "upload_stream_tables", "make_sweep",
           "make_sweep_overlapped", "make_sweep_stream",
           "make_sweep_segments",
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
    skips). ``verify_compiled`` must be ``"off"``: the compiled-artifact
    pass (HloLint) checks XLA programs and has no counterpart here yet."""
    if options is not None:
        kind, overlap = options.kind, options.overlap
        coalesce_max, window = options.coalesce_max, options.window
        stream = options.stream
        verify = options.verify
        verify_compiled = options.verify_compiled
    if verify_compiled != "off":
        raise NotImplementedError(
            f"verify_compiled={verify_compiled!r}: the compiled-program "
            "lint (HloLint) is not ported; use verify_compiled='off'")
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
    (src, dst) rank pairs, and for the stream's comm slots one
    ``(src ranks, dst ranks, slot width)`` triple per active slot, each
    pair kept only where the receiver takes that slot's arrival."""
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
    slots: List[Tuple[torch.Tensor, torch.Tensor, int]] = \
        field(default_factory=list)


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
    table. ``pairs[i]`` are round i's views into it."""
    table: torch.Tensor
    pairs: List[Tuple[torch.Tensor, torch.Tensor]]


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
    gs, ss, cuts = [], [], [0]
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
    table = up(np.stack([np.concatenate(gs), np.concatenate(ss)])
               if gs else np.zeros((2, 0), np.int64))
    return PhaseRounds(table=table, pairs=[
        (table[0, lo:hi], table[1, lo:hi])
        for lo, hi in zip(cuts, cuts[1:])])


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
    gets no entry and launches nothing. Every index is checked against
    the extent it addresses; repeated scatter indices must be trash."""
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
    kept, owner = [], []
    for t, ln in enumerate(comm):
        if ln is None:
            continue
        for si in np.nonzero(st.slot_active[t])[0]:
            w = int(st.slot_width[si])
            pairs = [(s_, d) for (s_, d) in st.slot_perm[si]
                     if st.recv_slot[t, d] == si]
            _in_bounds(f"round {t} slot {si} perm", np.ravel(pairs), P)
            if not 0 < w <= st.W:
                raise ValueError(f"slot {si} width {w} outside (0, "
                                 f"{st.W}]")
            if pairs:
                kept.append(np.array(pairs, np.int64).T)
                owner.append((ln, w))
    if kept:
        pairs_t = up(np.concatenate(kept, axis=1))
        at = 0
        for arr, (ln, w) in zip(kept, owner):
            n = arr.shape[1]
            ln.slots.append((pairs_t[0, at:at + n], pairs_t[1, at:at + n],
                             w))
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
        n = (sum(src.numel() * w for src, _, w in ln.slots) if stream
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

def _rounds(ph: PhaseRounds, dst, src=None, transpose: bool = False,
            add: bool = False) -> None:
    """One phase's rounds, in order — each a gather at the senders, the
    permute, and a scatter (``add``: an accumulate) at the receivers, on
    ``(B, P·len, b, b)`` views. With ``src=None`` a round gathers from
    ``dst`` as the earlier rounds left it: tree nodes forward what they
    received, so the rounds of a phase are never fused."""
    for g, s in ph.pairs:
        blk = (dst if src is None else src).index_select(1, g)
        if transpose:
            blk = blk.transpose(-1, -2)
        if add:
            blk = blk + dst.index_select(1, s)
        dst.index_copy_(1, s, blk)


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


def _round(tabs: SweepTables, t: int, arena, flat, lh_flat, Dinv,
           nbr, nbc, b):
    """One executed round: the boundary's pinned compute ops, the
    owner-local lane moves, then round ``t``'s coalesced multi-lane
    permute with per-lane gather/scatter/accumulate/transpose tables."""
    for kind, li in tabs.compute_at[t]:
        _compute(kind, tabs.levels[li], tabs.N, arena, flat, Dinv, nbr,
                 nbc, b)
    _local_lanes(flat, lh_flat, tabs.local[t])
    ln = tabs.comm[t]
    if ln is not None:
        B, P = arena.shape[:2]
        payload = _gather_lanes(flat, lh_flat, ln).view(
            B, P, ln.width, b, b)
        moved = torch.zeros_like(payload)
        moved.index_copy_(1, ln.dst, payload.index_select(1, ln.src))
        _land(flat, moved.view(B, P * ln.width, b, b), ln)


def _init_arena(tabs, Dinv, b: int):
    """A fresh (B, P, arena, b, b) arena with the structless-supernode
    diagonal seeds."""
    B, P = Dinv.shape[:2]
    arena = torch.zeros((B, P, tabs.arena_blocks, b, b), dtype=Dinv.dtype,
                        device=Dinv.device)
    _seed_diag(arena, Dinv, tabs)
    return arena


def _finish(tabs: SweepTables, arena, Dinv, nbr, nbc, b):
    """The trailing boundary's compute, and A⁻¹ out of the arena."""
    B, P = arena.shape[:2]
    flat = arena.view(B, P * tabs.arena_blocks, b, b)
    for kind, li in tabs.compute_at[len(tabs.comm)]:
        _compute(kind, tabs.levels[li], tabs.N, arena, flat, Dinv, nbr,
                 nbc, b)
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
# the stream sweep: the overlapped rounds as uniform, round-stacked tables
# ---------------------------------------------------------------------------

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
    ``slot_width`` lanes along its static perm, each receiver keeping only
    its ``recv_slot`` arrival, and the arrivals land through the
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
            for src, dst, w in ln.slots:
                moved[:, :, :w].index_copy_(
                    1, dst, payload[:, :, :w].index_select(1, src))
            _land(flat, moved.view(B, P * ln.width, b, b), ln)
        out = arena[:, :, :N].reshape(B, *shape).clone(
            memory_format=torch.contiguous_format)
        return out if batched else out[0]

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


def prepare_values(A, bs: BlockStructure, nb: int, b: int, pr: int,
                   pc: int) -> Tuple[np.ndarray, np.ndarray]:
    """The numeric half of :func:`prepare_inputs`: factorize this
    matrix's *values* on the host against an already-analyzed structure,
    normalize, and lay out the dense-blocked shards.

    Returns (Lh, Dinv) with shape (pr*pc, nbr, nbc, b, b) for
    ``in_specs=P("xy")``. The caller guarantees ``A`` has the sparsity
    structure that produced ``bs`` — this is the engine's analyze-once /
    solve-many hot path, so no symbolic work happens here."""
    import scipy.linalg as sla

    A = check_values_pattern(A, bs, b)
    nb0 = bs.nsuper

    lu = factorize(A, bs=bs)
    Lhat, _ = normalize_factors(lu)

    Lh_g = np.zeros((nb, nb, b, b))
    Dinv_g = np.zeros((nb, nb, b, b))
    for (I, K), blk in Lhat.items():
        Lh_g[I, K] = np.asarray(blk)
    for K in range(nb0):
        linv = sla.solve_triangular(np.asarray(lu.Ldiag[K]), np.eye(b),
                                    lower=True, unit_diagonal=True)
        Dinv_g[K, K] = sla.solve_triangular(np.asarray(lu.Udiag[K]), linv,
                                            lower=False)
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
    csr = []
    for i, M in enumerate(mats):
        try:
            csr.append(check_values_pattern(M, bs, b))
        except ValueError as e:
            raise ValueError(f"matrix {i} of {len(mats)}: {e}") from e
    B, nb0 = len(csr), bs.nsuper
    eye = np.eye(b)

    # dense (B, nb0, nb0, b, b) block workspace holding the evolving
    # Schur complement; fill lands in blocks the symbolic structure
    # already owns, so reading only struct blocks below is exact
    W = np.stack([np.asarray(M.todense()) for M in csr])
    W = (W.reshape(B, nb0, b, nb0, b).transpose(0, 1, 3, 2, 4)
          .astype(np.float64, copy=True))
    Lh = np.zeros((B, nb, nb, b, b))
    Dinv = np.zeros((B, nb, nb, b, b))
    bidx = np.arange(B)
    for K in range(nb0):
        L, U = _batched_lu_nopivot(W[:, K, K])
        C = [int(i) for i in bs.struct[K]]
        if C:
            # L(C,K): X·U = A  ⇔  Uᵀ·Xᵀ = Aᵀ (batched, broadcast over C)
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
            Lh[:, C, K] = np.linalg.solve(
                L.transpose(0, 2, 1)[:, None],
                LCK.transpose(0, 1, 3, 2)).transpose(0, 1, 3, 2)
        linv = np.linalg.solve(L, np.broadcast_to(eye, (B, b, b)))
        Dinv[:, K, K] = np.linalg.solve(U, linv)   # (U_KK)⁻¹(L_KK)⁻¹
    Dinv[:, range(nb0, nb), range(nb0, nb)] = eye   # padding supernodes
    return (_shard_blocks(Lh, nb, b, pr, pc),
            _shard_blocks(Dinv, nb, b, pr, pc))



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
