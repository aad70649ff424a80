"""Stream lowering — the uniform round-stream form of the overlapped
sweep, executable as ONE ``lax.fori_loop`` body.

The overlapped executor (``plan.schedule_overlapped`` +
``pselinv_dist.make_sweep_overlapped``) replays its global
:class:`~.plan.GlobalRound` list by unrolling a Python loop: every round
contributes its own ``lax.ppermute`` (a *static* perm) plus per-round
gather/scatter constants, so jaxpr/HLO size and trace+compile time grow
linearly with the round count — the binding constraint on scaling ``nb``
and grid size. This module lowers a compiled :class:`~.plan.OverlappedExec`
once more, into **uniform-width, round-indexed device tables**
(:class:`StreamTables`): every per-round quantity is stacked on a leading
round axis and padded to the stream-wide maximum width, so a single loop
body driven by ``dynamic_slice`` on the round axis executes the entire
sweep — comm lanes, owner-local copies, and the level GEMM / write /
S-einsum / diagonal phases behind per-round phase flags.

**Permute encoding (the one static-shape obstacle).** ``lax.ppermute``
takes a static perm, but the overlapped stream's perm differs per round.
The encoding here factors each round over the ``(pr, pc)`` **grid
torus**: within one round every device sends to at most one destination
and receives from at most one source (the ppermute constraint), and
each (src, dst) pair has one grid offset
``(dr, dc) = ((dst_r - src_r) mod pr, (dst_c - src_c) mod pc)`` — pure
column-phase traffic is ``(0, dc)`` (at most ``pc - 1`` offsets), pure
row-phase traffic ``(dr, 0)`` (at most ``pr - 1``), and the symmetric
xfer handoffs a few diagonals. Since an offset fully determines ``dst``
from ``src``, *any* union of same-offset pairs is a valid (partial)
permutation: the lowering groups each round's pairs by
(offset, lane width) into **comm slots** — one static perm (the union
of every pair that (offset, width) ever carries across the stream) and
one static width each — and a per-round boolean ``slot_active`` mask
gates each slot's permute behind a ``lax.cond``. The per-round lane
tables still collapse to ``[round, device, lane]``: a device gathers
its one outgoing lane stack, each *active* slot ships the stack's
leading ``width`` lanes along its perm, and each receiver keeps only
the arrival of its one receive slot (``recv_slot``) and scatters it
once — the same gather-snapshot → permute → scatter semantics as the
unrolled round, hence bit-identical (padded lanes scatter into the
trash block exactly like the unrolled executor's coalescing padding; a
slot's spurious deliveries — union-perm sources that did not pack a
lane this round — are discarded by the receive-slot select). A round
therefore pays only the wire bytes of the slots it actually uses,
``Σ len(perm) × width`` blocks (:func:`stream_wire_blocks`, near the
unrolled executor's instead of the flat-ring encoding's
every-shift-every-round ~7–200×), while the program size stays
**independent of the round count** (the tables are data, not code; the
slot dictionary saturates with the grid, not with ``nb``).
``shift_budget`` coarsens the dictionary (power-of-two width classes,
then one slot per offset) when fewer gated permutes are worth some
wire back; ``axis_factored=False`` recovers the PR-5 flat-ring
encoding (one always-active full-ring slot per ``(d - s) mod P``
shift) for A/B comparison. Algorithmic byte accounting is unchanged
(``simulator.round_schedule_from_stream`` derives the timeline from
the real lanes); *executed wire* accounting now has its own pair of
lenses — :func:`stream_wire_bytes` from the gated tables here, and
``simulator.executed_wire_bytes`` re-deriving the active sets from
``recv_slot`` — which must agree (tested).

**Compute encoding.** Round boundary ``t`` fires the compute ops the
dependence scheduler pinned there (``OverlappedExec.compute_at[t]``, in
dependence order). The stream gives every boundary the same fixed number
of compute *slots* (the stream-wide maximum); each slot holds a
(kind, level) pair — kind 0 is a no-op — dispatched through one
``lax.switch`` whose branches dynamic-index **level-stacked** mask/index
tables padded to the widest level ``NK``. Padded supernode rows carry a
zero struct mask (their GEMM/S rows compute exact zeros into the shared
partial/S regions' tail, which only the masked readers ever touch) and
their diagonal lanes target the trash block, so padding is numerically
inert — the executed arithmetic on real rows is the unrolled executor's,
value for value.

The lowering is pure host-side table construction (numpy); the executor
lives in ``pselinv_dist.make_sweep_stream`` and the end-to-end wiring in
``PlanOptions(stream=True)``.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .plan import OverlappedExec, peak_arena_blocks
from .schedule import BYTES_PER_ELT

__all__ = ["COMP_NOOP", "COMP_GEMM", "COMP_WRITE", "COMP_SCOMP",
           "COMP_DIAGW", "COMP_KIND_ID", "StreamTables", "lower_stream",
           "decode_round_lanes", "decode_local_lanes",
           "stream_wire_blocks", "stream_wire_bytes",
           "stream_shifts_per_round", "overlap_wire_blocks"]

#: compute-slot kind ids of the per-boundary phase flags (0 = no-op slot)
COMP_NOOP, COMP_GEMM, COMP_WRITE, COMP_SCOMP, COMP_DIAGW = range(5)
COMP_KIND_ID: Dict[str, int] = {"gemm": COMP_GEMM, "write": COMP_WRITE,
                                "scomp": COMP_SCOMP, "diagw": COMP_DIAGW}


@dataclass
class StreamTables:
    """The uniform round-stream compilation of one overlapped sweep:
    every per-round table of the :class:`~.plan.GlobalRound` list stacked
    on a leading round axis (padded to the stream-wide widths), plus the
    level compute tables stacked on a level axis (padded to ``NK``).

    Geometry mirrors :class:`~.plan.OverlappedExec` (same arena layout,
    same trash block, same shared partial/S regions at ``base_p`` /
    ``base_s`` — asserted identical across levels at lowering time).

    Communication is a static dictionary of **comm slots** (see the
    module docstring): ``slot_perm[si]`` is slot ``si``'s static
    (src, dst) pair list (a valid partial permutation — all pairs share
    one grid offset), ``slot_width[si]`` how many leading lanes of the
    sender stack it ships, ``slot_shift[si]`` its grouping key — the
    grid-torus offset ``(dr, dc)`` when ``axis_factored``, the 1-tuple
    flat ring delta ``(d - s) mod P`` otherwise — ``slot_active`` the
    (steps, S) per-round gate, and ``recv_slot`` the (steps, P) index of
    the one slot each device receives on (-1 = none). Comm lane tables
    are indexed ``[round, device, lane]`` — NOT per slot: within one
    round a device sends on at most one slot and receives on at most one
    (the ppermute constraint), so the sender tables (``gather``/``glh``)
    describe the device's single outgoing lane stack (every active slot
    ships its leading ``slot_width`` lanes — only true destinations keep
    them), and the receiver tables (``scatter``/``addm``/``tmask``)
    describe where the single kept arrival lands. A lane is *real* iff
    its receiver scatter slot is not the trash block.
    ``comp_kind``/``comp_level`` hold each boundary's compute slots in
    dependence order (:data:`COMP_KIND_ID`; 0-filled tails are no-ops).
    ``steps = nrounds + 1`` is the ``fori_loop`` trip count — the final
    iteration runs only the last boundary's compute (its comm tables are
    all-trash no-ops).

    ``lane_edges``/``lmoves``/``level_Ks``/``peak_blocks`` are host-side
    metadata for byte accounting and the replay tests — never shipped to
    the device."""
    nb: int
    pr: int
    pc: int
    n_ainv: int
    arena_blocks: int
    trash: int
    base_p: int
    base_s: int
    nrounds: int
    steps: int
    axis_factored: bool
    slot_shift: Tuple[Tuple[int, ...], ...]
    slot_width: Tuple[int, ...]
    slot_perm: Tuple[Tuple[Tuple[int, int], ...], ...]
    W: int                         # comm lane width (max over rounds)
    LW: int                        # owner-local lane width
    C: int                         # compute slots per boundary
    NK: int                        # widest level's supernode count
    window: int | None
    peak_blocks: int
    diag_set_root: np.ndarray
    diag_set_slot: np.ndarray
    # ---- (steps, P, W) comm lane tables + per-round slot gating -------
    gather: np.ndarray
    scatter: np.ndarray
    addm: np.ndarray
    tmask: np.ndarray
    glh: np.ndarray
    slot_active: np.ndarray        # (steps, S) bool
    recv_slot: np.ndarray          # (steps, P) int32, -1 = none
    # ---- (steps, P, LW) owner-local lane tables -----------------------
    lgather: np.ndarray
    lscatter: np.ndarray
    ltmask: np.ndarray
    lglh: np.ndarray
    # ---- (steps, C) compute phase flags -------------------------------
    comp_kind: np.ndarray
    comp_level: np.ndarray
    # ---- (nlev, ...) level compute tables padded to NK ----------------
    u_gather: np.ndarray           # (nlev, P, NK*nbc), trash-padded
    cmask: np.ndarray              # (nlev, pc, NK, nbc), zero-padded
    kcs: np.ndarray                # (nlev, NK)
    krs: np.ndarray                # (nlev, NK)
    col_write_row: np.ndarray      # (nlev, pr, NK, nbr)
    col_write_col: np.ndarray      # (nlev, pc, NK)
    diag_rowmask: np.ndarray       # (nlev, pr, NK)
    diag_root: np.ndarray          # (nlev, NK), -1-padded (matches no id)
    diag_slot: np.ndarray          # (nlev, NK), trash-padded
    # ---- host-side metadata (accounting / replay tests) ---------------
    level_Ks: List[np.ndarray] = field(default_factory=list)
    lane_edges: List[List[Tuple[int, int, str, int, float]]] = \
        field(default_factory=list)
    lmoves: List[List[Tuple[int, str, int]]] = field(default_factory=list)

    @property
    def nbr(self) -> int:
        return self.nb // self.pr

    @property
    def nbc(self) -> int:
        return self.nb // self.pc

    @property
    def nlev(self) -> int:
        return len(self.level_Ks)

    @property
    def nslots(self) -> int:
        return len(self.slot_perm)

    @property
    def shifts(self) -> Tuple[int, ...]:
        """The flat ring-offset set ``(d - s) mod P`` the slot perms
        cover — the PR-5 encoding's shift vocabulary, kept as derived
        introspection (the executor no longer runs one full-ring permute
        per entry)."""
        P = self.pr * self.pc
        return tuple(sorted({(d - s) % P
                             for perm in self.slot_perm
                             for (s, d) in perm}))


def lower_stream(ov: OverlappedExec, *, axis_factored: bool = True,
                 shift_budget: int | None = None) -> StreamTables:
    """Lower a compiled overlapped round stream into the uniform
    round-indexed device tables of :class:`StreamTables`.

    Pure table construction: the stream replays the *identical* round
    order, lane order, and accumulation order as the unrolled
    :class:`~.plan.GlobalRound` list (the replay property test in
    ``tests/test_stream.py`` proves it round-for-round), so the executed
    f64 output is bit-identical to ``make_sweep_overlapped``'s.

    ``axis_factored`` (default) builds the gated grid-torus slot
    dictionary — slots keyed by (grid offset, exact lane width), active
    only in the rounds that use them. ``shift_budget`` coarsens the
    width keying (exact → power-of-two classes → one slot per offset)
    until the dictionary fits; it cannot go below one slot per distinct
    grid offset. ``axis_factored=False`` recovers the PR-5 flat-ring
    encoding: one always-active full-ring slot per ``(d - s) mod P``
    shift, every device's whole stack shipped on each."""
    P = ov.pr * ov.pc
    pr, pc = ov.pr, ov.pc
    nrounds = len(ov.rounds)
    steps = nrounds + 1
    W = max((rnd.width for rnd in ov.rounds), default=0)
    LW = max((rnd.lwidth for rnd in ov.rounds), default=0)
    C = max((len(ops) for ops in ov.compute_at), default=0)
    trash = ov.trash

    # authoritative per-round pair -> lane count (from the edge lists;
    # the perm pair set and the edge pair set coincide by construction)
    pair_rounds: List[Dict[Tuple[int, int], int]] = []
    for t, rnd in enumerate(ov.rounds):
        cnt: Dict[Tuple[int, int], int] = defaultdict(int)
        for (s, d, _kind, _lv, _nb) in rnd.edges:
            cnt[(s, d)] += 1
        if set(cnt) != set(rnd.perm):
            raise ValueError(
                f"round {t}: edge pairs {sorted(cnt)} disagree with the "
                f"permute pairs {sorted(rnd.perm)}")
        if any(s == d for (s, d) in cnt):
            raise ValueError("overlapped stream contains a self-edge "
                             "(src == dst) — those must be owner-local "
                             "lanes")
        pair_rounds.append(dict(cnt))

    # ---- comm-slot dictionary -----------------------------------------
    slot_shift_l: List[Tuple[int, ...]] = []
    slot_width_l: List[int] = []
    slot_pairs: List[set] = []
    recv_slot = np.full((steps, P), -1, np.int32)
    active: List[set] = [set() for _ in range(steps)]

    if axis_factored:
        def off(s: int, d: int) -> Tuple[int, int]:
            return ((d // pc - s // pc) % pr, (d % pc - s % pc) % pc)

        maxn: Dict[Tuple[int, int], int] = defaultdict(int)
        for cnt in pair_rounds:
            for (s, d), n in cnt.items():
                maxn[off(s, d)] = max(maxn[off(s, d)], n)

        def _pow2(n: int) -> int:
            w = 1
            while w < n:
                w <<= 1
            return w

        # width keying, coarsened until the dictionary fits the budget
        keyings = [lambda o, n: n,
                   lambda o, n: min(_pow2(n), W),
                   lambda o, n: maxn[o]]
        for wf in keyings:
            nkeys = len({(off(s, d), wf(off(s, d), n))
                         for cnt in pair_rounds
                         for (s, d), n in cnt.items()})
            if shift_budget is None or nkeys <= shift_budget:
                break
        else:
            raise ValueError(
                f"shift_budget={shift_budget} is below one comm slot per "
                f"grid offset ({nkeys} offsets) — a slot's perm must stay "
                "single-offset to remain a permutation")

        slot_id: Dict[Tuple, int] = {}
        for t, cnt in enumerate(pair_rounds):
            for (s, d), n in cnt.items():
                key = (off(s, d), wf(off(s, d), n))
                si = slot_id.get(key)
                if si is None:
                    si = slot_id[key] = len(slot_pairs)
                    slot_shift_l.append(key[0])
                    slot_width_l.append(key[1])
                    slot_pairs.append(set())
                slot_pairs[si].add((s, d))
                active[t].add(si)
                if recv_slot[t, d] != -1:
                    raise ValueError(
                        f"round {t}: device {d} receives twice — the "
                        "overlapped round violates the ppermute "
                        "constraint")
                recv_slot[t, d] = si
        slot_perm = tuple(tuple(sorted(ps)) for ps in slot_pairs)
        # same-offset pairs are automatically bijective; keep the cheap
        # guard so a future keying change cannot ship a broken perm
        for perm in slot_perm:
            srcs = [s for s, _ in perm]
            dsts = [d for _, d in perm]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                raise ValueError(f"comm slot perm {perm} is not a "
                                 "permutation")
    else:
        # PR-5 flat-ring encoding: one full-ring slot per used shift,
        # always active (the stream shipped every stack on every shift
        # in every iteration — kept for A/B wire comparison)
        deltas = sorted({(d - s) % P
                         for cnt in pair_rounds for (s, d) in cnt})
        sidx = {dlt: i for i, dlt in enumerate(deltas)}
        slot_shift_l = [(dlt,) for dlt in deltas]
        slot_width_l = [W] * len(deltas)
        slot_perm = tuple(tuple((i, (i + dlt) % P) for i in range(P))
                          for dlt in deltas)
        for t in range(steps):
            active[t] = set(range(len(deltas)))
        for t, cnt in enumerate(pair_rounds):
            for (s, d) in cnt:
                if recv_slot[t, d] != -1:
                    raise ValueError(
                        f"round {t}: device {d} receives twice — the "
                        "overlapped round violates the ppermute "
                        "constraint")
                recv_slot[t, d] = sidx[(d - s) % P]

    S = len(slot_perm)
    slot_active = np.zeros((steps, S), bool)
    for t in range(steps):
        for si in active[t]:
            slot_active[t, si] = True

    gather = np.zeros((steps, P, W), np.int32)
    scatter = np.full((steps, P, W), trash, np.int32)
    addm = np.zeros((steps, P, W), np.float32)
    tmask = np.zeros((steps, P, W), bool)
    glh = np.zeros((steps, P, W), bool)
    lgather = np.zeros((steps, P, LW), np.int32)
    lscatter = np.full((steps, P, LW), trash, np.int32)
    ltmask = np.zeros((steps, P, LW), bool)
    lglh = np.zeros((steps, P, LW), bool)

    for t, rnd in enumerate(ov.rounds):
        for (s, d) in rnd.perm:
            # the ppermute constraint (unique sources / destinations per
            # round) is what makes the collapsed [round, device, lane]
            # layout lossless: one outgoing stack, one receive slot
            w = rnd.width
            gather[t, s, :w] = rnd.gather[s]
            glh[t, s, :w] = rnd.glh[s]
            scatter[t, d, :w] = rnd.scatter[d]
            addm[t, d, :w] = rnd.addm[d]
            tmask[t, d, :w] = rnd.tmask[d]
        if rnd.lwidth:
            lw = rnd.lwidth
            lgather[t, :, :lw] = rnd.lgather
            lscatter[t, :, :lw] = rnd.lscatter
            ltmask[t, :, :lw] = rnd.ltmask
            lglh[t, :, :lw] = rnd.lglh

    comp_kind = np.zeros((steps, max(C, 1)), np.int32)
    comp_level = np.zeros((steps, max(C, 1)), np.int32)
    for t, ops in enumerate(ov.compute_at):
        for j, op in enumerate(ops):
            comp_kind[t, j] = COMP_KIND_ID[op.kind]
            comp_level[t, j] = op.level

    # ---- level compute tables, padded to the widest level -------------
    nlev = len(ov.levels)
    nbr, nbc = ov.nbr, ov.nbc
    NK = max((len(lv.Ks) for lv in ov.levels), default=0)
    if nlev:
        # the shared partial/S regions are one address each across every
        # level (see plan._overlap_items); the stream's static base
        # offsets rely on it
        base_p = ov.levels[0].base_p
        base_s = ov.levels[0].base_s
        if any(lv.base_p != base_p or lv.base_s != base_s
               for lv in ov.levels):
            raise ValueError("overlapped levels disagree on the shared "
                             "partial/S region bases — the stream "
                             "lowering requires the PR-3 single-region "
                             "arena layout")
        if base_s - base_p != NK * nbr or trash - base_s != NK:
            raise ValueError(
                f"shared region extents (partial={base_s - base_p}, "
                f"S={trash - base_s}) do not match the widest level "
                f"(NK={NK}) — padded compute rows would escape them")
    else:
        base_p = base_s = ov.n_ainv

    u_gather = np.full((nlev, P, NK * nbc), trash, np.int32)
    cmask = np.zeros((nlev, ov.pc, NK, nbc))
    kcs = np.zeros((nlev, NK), np.int32)
    krs = np.zeros((nlev, NK), np.int32)
    col_write_row = np.zeros((nlev, ov.pr, NK, nbr))
    col_write_col = np.zeros((nlev, ov.pc, NK))
    diag_rowmask = np.zeros((nlev, ov.pr, NK))
    diag_root = np.full((nlev, NK), -1, np.int32)
    diag_slot = np.full((nlev, NK), trash, np.int32)
    for L, lv in enumerate(ov.levels):
        nk = len(lv.Ks)
        u_gather[L, :, :nk * nbc] = lv.u_gather
        cmask[L, :, :nk] = lv.cmask
        kcs[L, :nk] = lv.kcs
        krs[L, :nk] = lv.krs
        col_write_row[L, :, :nk] = lv.col_write_row
        col_write_col[L, :, :nk] = lv.col_write_col
        diag_rowmask[L, :, :nk] = lv.diag_rowmask
        diag_root[L, :nk] = lv.diag_root
        diag_slot[L, :nk] = lv.diag_slot

    return StreamTables(
        nb=ov.nb, pr=ov.pr, pc=ov.pc, n_ainv=ov.n_ainv,
        arena_blocks=ov.arena_blocks, trash=trash,
        base_p=base_p, base_s=base_s,
        nrounds=nrounds, steps=steps,
        axis_factored=axis_factored,
        slot_shift=tuple(slot_shift_l), slot_width=tuple(slot_width_l),
        slot_perm=slot_perm,
        W=W, LW=LW, C=C, NK=NK, window=ov.window,
        peak_blocks=peak_arena_blocks(ov),
        diag_set_root=ov.diag_set_root, diag_set_slot=ov.diag_set_slot,
        gather=gather, scatter=scatter, addm=addm, tmask=tmask, glh=glh,
        slot_active=slot_active, recv_slot=recv_slot,
        lgather=lgather, lscatter=lscatter, ltmask=ltmask, lglh=lglh,
        comp_kind=comp_kind, comp_level=comp_level,
        u_gather=u_gather, cmask=cmask, kcs=kcs, krs=krs,
        col_write_row=col_write_row, col_write_col=col_write_col,
        diag_rowmask=diag_rowmask, diag_root=diag_root,
        diag_slot=diag_slot,
        level_Ks=[np.asarray(lv.Ks) for lv in ov.levels],
        lane_edges=[list(rnd.edges) for rnd in ov.rounds],
        lmoves=[list(rnd.lmoves) for rnd in ov.rounds])


def decode_round_lanes(st: StreamTables, t: int
                       ) -> List[Tuple[int, int, int, int, float, bool,
                                       bool]]:
    """Reconstruct round ``t``'s *real* comm lanes from the device tables
    alone (no ``lane_edges`` metadata): one
    (src, dst, gather_slot, scatter_slot, addm, transpose, from_lh) tuple
    per lane whose receiver scatter slot is not the trash block: a
    receiver's one arrival comes from its receive slot's perm — the slot
    must be gated *active* this round, ship at least the lanes the
    receiver scatters, and name the receiver in its pair list. The
    replay property test compares this against the overlapped
    :class:`~.plan.GlobalRound` the round was lowered from."""
    P = st.pr * st.pc
    src_of = [dict((d, s) for (s, d) in perm) for perm in st.slot_perm]
    out = []
    for d in range(P):
        si = int(st.recv_slot[t, d])
        if si < 0:
            continue
        if not st.slot_active[t, si]:
            raise ValueError(
                f"round {t}: device {d} receives on slot {si}, which the "
                "gate table marks inactive — the arrival would be zeros")
        if d not in src_of[si]:
            raise ValueError(
                f"round {t}: device {d} receives on slot {si} but is not "
                "a destination of its perm")
        s = src_of[si][d]
        for j in range(st.W):
            ds = int(st.scatter[t, d, j])
            if ds == st.trash:
                continue
            if j >= st.slot_width[si]:
                raise ValueError(
                    f"round {t}: device {d} scatters lane {j} but its "
                    f"receive slot {si} ships only "
                    f"{st.slot_width[si]} lanes")
            out.append((s, d, int(st.gather[t, s, j]), ds,
                        float(st.addm[t, d, j]),
                        bool(st.tmask[t, d, j]),
                        bool(st.glh[t, s, j])))
    return out


# ---------------------------------------------------------------------------
# executed-wire accounting (physical permute traffic, not algorithmic lanes)
# ---------------------------------------------------------------------------

def stream_wire_blocks(st: StreamTables) -> int:
    """Blocks the gated stream physically ships per sweep: every round,
    each *active* comm slot moves ``len(slot_perm) × slot_width`` blocks
    (XLA's collective-permute ships every listed pair's full payload —
    union-perm sources that packed no lane this round ship padding, and
    so do lanes above a pair's real count; both are counted, exactly as
    they cross the wire). The flat-ring lowering prices out to the PR-5
    behavior (every shift, every step, full width) under the same
    formula."""
    counts = np.array([len(p) * w
                       for p, w in zip(st.slot_perm, st.slot_width)],
                      np.int64)
    if not len(counts):
        return 0
    return int((st.slot_active * counts[None, :]).sum())


def stream_wire_bytes(st: StreamTables, b: int) -> float:
    """Executed wire bytes per sweep of the gated stream
    (:func:`stream_wire_blocks` at block width ``b``, in the plan's
    per-element accounting unit)."""
    return float(stream_wire_blocks(st)) * b * b * BYTES_PER_ELT


def stream_shifts_per_round(st: StreamTables) -> float:
    """Mean number of gated permutes the stream executes per comm round
    — the per-round active-slot count (the flat-ring encoding executed
    ``len(shifts)`` every round unconditionally)."""
    if not st.nrounds or not st.nslots:
        return 0.0
    return float(st.slot_active[:st.nrounds].sum(axis=1).mean())


def overlap_wire_blocks(ov: OverlappedExec) -> int:
    """Blocks the *unrolled* overlapped executor physically ships per
    sweep: each round's single static permute moves
    ``len(perm) × width`` blocks (coalesced pairs below the round width
    ship padding lanes — counted, as they cross the wire). The yardstick
    the gated stream's :func:`stream_wire_blocks` is held to in the
    bench."""
    return sum(len(rnd.perm) * rnd.width for rnd in ov.rounds)


def decode_local_lanes(st: StreamTables, t: int
                       ) -> List[Tuple[int, int, int, bool, bool]]:
    """Round ``t``'s real owner-local lanes from the device tables:
    (device, gather_slot, scatter_slot, transpose, from_lh) per non-trash
    scatter."""
    P = st.pr * st.pc
    out = []
    for dev in range(P):
        for j in range(st.LW):
            ds = int(st.lscatter[t, dev, j])
            if ds == st.trash:
                continue
            out.append((dev, int(st.lgather[t, dev, j]), ds,
                        bool(st.ltmask[t, dev, j]),
                        bool(st.lglh[t, dev, j])))
    return out
