"""CommPlan — the single static IR behind every PSelInv schedule consumer.

One layering (host plan → device executor → simulator):

1. ``core/schedule.pselinv_events`` enumerates the *semantic* restricted
   collectives of Algorithm 1 (what must be communicated, by whom).
2. :func:`build_plan` lowers that enumeration ONCE into a
   :class:`CommPlan`: per collective a concrete :class:`~.trees.CommTree`
   (kind/tag-deterministic, in **global rank space**), per-edge byte
   counts, and the elimination-tree level of every supernode — supernodes
   at the same level are independent and get batched into shared rounds
   (the paper's asynchronous pipelining, §3).
3. Consumers:

   * ``core/simulator.volumes`` / ``simulate`` walk ``CommPlan.ops``
     directly — the bytes they account are the bytes of the very trees
     the executor runs, *by construction*;
   * ``core/pselinv_dist.make_sweep`` consumes the :class:`ExecPlan`
     produced by :func:`compile_exec`: dense per-device index tables
     (gather slot, scatter slot, receive mask, ppermute pairs) that
     replace per-pair ``jnp.where`` chains with O(1) table lookups;
   * ``comm/treecomm.batched_rounds`` delegates its round merging to
     :func:`merge_round_lists`.

Adding a new tree kind therefore means: extend ``core/trees.build_tree``
— every consumer (simulator, executor, reusable collectives) picks it up
through :func:`tree_for` with zero schedule drift.

Executor slot layout (uniform supernode width ``b``; ``nb`` padded so
``pr | nb`` and ``pc | nb``): global block (I, J) lives on device
``(I % pr, J % pc)`` at flat local slot ``(I//pr)*nbc + J//pc``; the
level-stacked Û buffer keys slot ``k*nbc + I//pc`` and the partial-product
buffer ``k*nbr + J//pr`` for the level's k-th supernode.

**Overlapped round stream** (:func:`schedule_overlapped`): the level
batching above still barriers between elimination-tree levels, although
only the GEMM→reduce→write→diag chain is actually serialized by data —
a level's xfer-in and col-bcast traffic depends on nothing but the
static L̂ shard and its own tree edges. The overlapped lowering
therefore drops the level barrier entirely: every comm edge, local copy
and compute op of the whole sweep becomes a node of one dependence DAG
(:func:`_overlap_items` documents the exact edge set), which is
list-scheduled into a single global sequence of ppermute rounds over a
flat per-device block **arena** (A⁻¹ | L̂ | compact recycled Û slot
pool | one shared partial region | one shared S region | trash — a
level's stacks are live only between their first fill and their last
reader, so non-overlapping generations alias the same physical slots
and generation-keyed WAR anti-dependences serialize the reuse; see
:func:`_u_pool_layout` / :func:`_overlap_items`). Compute fires at
round boundaries; level L+1's xfer-in rides the same rounds as level
L's reduce and diagonal traffic — the paper's §3 asynchronous
pipelining *across* levels, not just within one.

**Coalescing rule**: within one round, a (src, dst) device pair may
carry up to ``coalesce_max`` blocks as extra lanes of the same permute
(one latency, unique non-trash scatter slots, per-lane accumulate /
transpose flags). Flat-tree roots and the xfer phases send many blocks
between the same pair, so the global round count drops well below the
level-serial path's — same bytes, fewer rounds
(:func:`overlapped_byte_counts` == ``simulator.volumes``, tested).

The level-barrier executor (:func:`compile_exec` + ``make_sweep``)
remains fully supported for A/B comparison — ``run_distributed(...,
overlap=False)`` and ``benchmarks/pselinv_bench.py`` drive it.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .schedule import (BYTES_PER_ELT, CommEvent, ComputeTask, Grid2D,
                       pselinv_events)
from .symbolic import BlockStructure
from .trees import (HYBRID_FLAT_MAX, CommTree, TreeKind, build_tree,
                    cached_tree, stable_hash)

__all__ = [
    "PlanOptions", "PlanOp", "CommPlan", "build_plan", "tree_for",
    "merge_round_lists",
    "pack_edges", "CommRound", "LocalRound", "LevelExec", "ExecPlan",
    "compile_exec", "exec_byte_counts", "etree_levels",
    "GlobalRound", "ComputeOp", "OverlapLevel", "OverlappedExec",
    "schedule_overlapped", "schedule_stream", "overlapped_byte_counts",
    "ppermute_round_count", "peak_arena_blocks",
]


@dataclass(frozen=True)
class PlanOptions:
    """The one knob bundle every schedule consumer reads.

    Collects what used to be scattered keyword arguments (``kind``,
    ``overlap``, ``coalesce_max``, ``window``) across ``build_program``,
    ``run_distributed``, :func:`schedule_overlapped` and the bench into a
    single hashable value — it is part of the
    :class:`~.engine.PSelInvEngine` structure-cache key, so two sessions
    with equal structure but different options compile independently.

    ``kind``: the tree family every restricted collective lowers through
    (:func:`tree_for`). ``overlap``: compile the cross-level overlapped
    round stream (the default executor) instead of the level-serial A/B
    baseline. ``coalesce_max``: max blocks one (src, dst) pair may carry
    as lanes of a single ppermute. ``window``: Û pool liveness window in
    adjacent elimination-tree levels (``None`` = whole sweep resident;
    see :func:`schedule_overlapped`). ``stream``: additionally lower the
    overlapped round stream into the uniform round-indexed device tables
    of ``core/stream.py`` and execute the whole sweep as one
    ``lax.fori_loop`` body (program size independent of the round count
    — the same rounds, replayed from tables instead of unrolled code;
    requires ``overlap=True``).

    ``axis_factored``: encode stream communication over the ``(pr, pc)``
    grid torus instead of the flat device ring — the packer groups
    equal-priority lanes by their grid offset ``(dr, dc)`` so lanes
    sharing an offset land in the same round, and the stream lowering
    emits per-(offset, width) comm *slots* gated by a per-round
    active-slot mask (``core/stream.py``); each round then pays only
    the wire bytes of the slots it actually uses, instead of shipping
    every device's payload on every ring shift of the whole sweep
    (the PR-5 flat-ring behavior, recovered with ``False``).
    ``shift_budget``: optional cap on the stream's comm-slot dictionary
    — exact-width slots are coarsened (power-of-two width classes, then
    one slot per grid offset) until the cap is met, trading wire bytes
    back for fewer gated permutes in the loop body. Requires
    ``axis_factored=True`` (the flat-ring lowering has exactly one slot
    per ring shift already).

    ``verify``: the PlanLint mode applied to every lowered artifact at
    ``build_program`` time (``core/verify.py``): ``"error"`` (default)
    raises :class:`~.verify.PlanVerificationError` on any ERROR-severity
    diagnostic, ``"warn"`` reduces the report to one ``warnings.warn``,
    ``"off"`` skips the static pass.

    ``verify_compiled``: the mode of the executed-communication
    verifier (``core/exec_verify.py``, the role of the JAX package's
    HloLint) at ``build_program`` time: the program's own sweep runs
    once on ``meta`` tensors (no card, no arithmetic; same three modes)
    and the permutes it executes are held to the tables. Default
    ``"off"``: the pass runs the whole sweep's Python once, so it is
    opt-in per session — ``python -m repro_torch.tools.exec_lint``,
    ``python -m repro_torch.tools.plan_lint --compiled`` and the tier-1
    tests run it over every shipped shape, and
    ``PSelInvEngine.lint_compiled`` adds the session's device and its
    captured CUDA graphs."""
    kind: TreeKind = TreeKind.SHIFTED
    overlap: bool = True
    coalesce_max: int = 8
    window: int | None = None
    stream: bool = False
    axis_factored: bool = True
    shift_budget: int | None = None
    verify: str = "error"
    verify_compiled: str = "off"

    def __post_init__(self):
        if self.verify not in ("error", "warn", "off"):
            raise ValueError(
                f"PlanOptions(verify={self.verify!r}) — expected one of "
                "'error', 'warn', 'off'")
        if self.verify_compiled not in ("error", "warn", "off"):
            raise ValueError(
                f"PlanOptions(verify_compiled={self.verify_compiled!r}) "
                "— expected one of 'error', 'warn', 'off'")
        if self.stream and not self.overlap:
            raise ValueError(
                "PlanOptions(stream=True) lowers the *overlapped* round "
                "stream — it requires overlap=True (the level-serial "
                "executor has no global round stream to lower)")
        if self.shift_budget is not None:
            if not self.axis_factored:
                raise ValueError(
                    "PlanOptions(shift_budget=...) coarsens the "
                    "axis-factored slot dictionary — it requires "
                    "axis_factored=True (the flat-ring lowering has one "
                    "slot per ring shift already)")
            if self.shift_budget < 1:
                raise ValueError(
                    f"shift_budget must be >= 1, got {self.shift_budget}")


# ---------------------------------------------------------------------------
# tree construction (the one place a schedule becomes a concrete tree)
# ---------------------------------------------------------------------------

def tree_for(kind: TreeKind, root: int, participants: Sequence[int],
             tag: int) -> CommTree:
    """The canonical collective → tree lowering. FLAT/BINARY trees depend
    only on the participant set (memoized); SHIFTED/HYBRID decorrelate
    concurrent collectives through the tag-seeded rotation. HYBRID is the
    paper's §4.2 per-collective dispatch keyed on participant count: at
    or below :data:`~.trees.HYBRID_FLAT_MAX` participants the collective
    is a flat tree — tag-independent, so it routes through the memoized
    FLAT path instead of rebuilding per tag — and above it the tag-seeded
    shifted-binary tree."""
    receivers = tuple(r for r in participants if r != root)
    if kind is TreeKind.HYBRID and len(receivers) + 1 <= HYBRID_FLAT_MAX:
        kind = TreeKind.FLAT
    if kind in (TreeKind.FLAT, TreeKind.BINARY):
        return cached_tree(kind.value, root, receivers, 0)
    return build_tree(kind, root, receivers, tag=tag)


def merge_round_lists(per_tree: Sequence[List[List[Tuple[int, int]]]],
                      op: str) -> List[List[Tuple[int, int]]]:
    """Merge several *disjoint-group* collectives' per-round (src, dst)
    edge lists into shared rounds: broadcasts left-aligned (roots fire
    first), reductions right-aligned (every root combines on the last
    round). Raises ``ValueError`` naming the colliding pairs if the trees
    are not disjoint within a round — a device may source/sink at most one
    transfer per ``ppermute``."""
    n = max((len(r) for r in per_tree), default=0)
    merged: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for rounds in per_tree:
        shift = 0 if op == "bcast" else n - len(rounds)
        for i, rnd in enumerate(rounds):
            merged[i + shift].extend(rnd)
    for i, rnd in enumerate(merged):
        srcs = [s for s, _ in rnd]
        dsts = [d for _, d in rnd]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            dup_s = sorted({s for s in srcs if srcs.count(s) > 1})
            dup_d = sorted({d for d in dsts if dsts.count(d) > 1})
            bad = [(s, d) for (s, d) in rnd
                   if s in dup_s or d in dup_d]
            raise ValueError(
                f"merged trees are not disjoint in round {i}: pairs {bad} "
                f"reuse sources {dup_s} / destinations {dup_d}")
    return merged


def etree_levels(bs: BlockStructure) -> np.ndarray:
    """Depth of every supernode in the block elimination tree (roots at
    level 0). Supernodes at equal depth are independent in the
    selected-inversion sweep: struct(K) ⊆ ancestors(K), all at strictly
    smaller depth."""
    nsuper = bs.nsuper
    level = np.full(nsuper, -1, dtype=np.int64)
    for K in range(nsuper - 1, -1, -1):
        p = int(bs.parent[K])
        level[K] = 0 if p < 0 else level[p] + 1
    # parent(K) > K, so a reverse scan sees parents first
    return level


# ---------------------------------------------------------------------------
# the IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanOp:
    """One restricted collective with its concrete tree.

    ``exec_only`` marks the symmetric-case bookkeeping transfers
    (``xfer-out`` transpose handoff, ``diag-reduce``) that the executable
    sweep performs but the paper's volume accounting (§4.1) does not
    report — ``volumes``/``simulate`` skip them."""
    kind: str
    supernode: int
    level: int
    root: int
    participants: Tuple[int, ...]
    nbytes: float
    tag: int
    tree: CommTree
    block: int = -1
    consumes: int = -1
    exec_only: bool = False


@dataclass
class CommPlan:
    """The static IR: every collective of one PSelInv pass, plus the
    elimination-tree level structure the executor pipelines over."""
    bs: BlockStructure
    grid: Grid2D
    kind: TreeKind
    nb: int                          # supernode count incl. grid padding
    ops: List[PlanOp]
    tasks: List[ComputeTask]
    level_of: np.ndarray             # (nsuper,)
    sweep_levels: List[List[int]]    # per level: supernodes with work
    diag_only: List[int]             # empty-struct supernodes (+ padding)

    def ops_by_supernode(self) -> Dict[int, List[PlanOp]]:
        out: Dict[int, List[PlanOp]] = defaultdict(list)
        for op in self.ops:
            out[op.supernode].append(op)
        return dict(out)


def build_plan(bs: BlockStructure, grid: Grid2D, kind: TreeKind,
               nb: int | None = None) -> CommPlan:
    """Lower the event enumeration into the CommPlan IR (trees built once,
    here, for every consumer)."""
    nsuper = bs.nsuper
    nb = nsuper if nb is None else int(nb)
    if nb < nsuper:
        raise ValueError(f"nb={nb} < nsuper={nsuper}")
    level = etree_levels(bs)
    w = bs.widths()
    pr, pc = grid.pr, grid.pc

    events, tasks = pselinv_events(bs, grid)
    ops: List[PlanOp] = []
    for ev in events:
        ops.append(PlanOp(
            kind=ev.kind, supernode=ev.supernode,
            level=int(level[ev.supernode]), root=ev.root,
            participants=ev.participants, nbytes=ev.nbytes, tag=ev.tag,
            tree=tree_for(kind, ev.root, ev.participants, ev.tag),
            block=ev.block, consumes=ev.consumes))

    # symmetric-case executor transfers (paper implementation detail:
    # A⁻¹(K,J) = A⁻¹(J,K)ᵀ is materialized by a transpose handoff, and the
    # diagonal correction Σ A⁻¹(K,I)·L̂(I,K) is reduced within row K%pr)
    for K in range(nsuper):
        C = [int(i) for i in bs.struct[K]]
        if not C:
            continue
        wk = float(w[K])
        krow, kcol = K % pr, K % pc
        for J in C:
            src = grid.owner(J, K)
            dst = grid.owner(K, J)
            if src == dst:
                continue
            parts = tuple(sorted({src, dst}))
            tag = (K << 20) ^ (J << 2) ^ 3
            ops.append(PlanOp(
                kind="xfer-out", supernode=K, level=int(level[K]),
                root=src, participants=parts,
                nbytes=float(w[J]) * wk * BYTES_PER_ELT, tag=tag,
                tree=tree_for(TreeKind.FLAT, src, parts, tag),
                block=J, exec_only=True))
        cols = sorted({I % pc for I in C} | {kcol})
        if len(cols) > 1:
            root = grid.owner(K, K)
            parts = tuple(sorted(krow * pc + c for c in cols))
            tag = stable_hash(K, 0xD)
            ops.append(PlanOp(
                kind="diag-reduce", supernode=K, level=int(level[K]),
                root=root, participants=parts,
                nbytes=wk * wk * BYTES_PER_ELT, tag=tag,
                tree=tree_for(kind, root, parts, tag),
                block=K, exec_only=True))

    nlev = int(level.max()) + 1 if nsuper else 0
    sweep_levels: List[List[int]] = [[] for _ in range(nlev)]
    diag_only: List[int] = []
    for K in range(nsuper):
        if len(bs.struct[K]):
            sweep_levels[int(level[K])].append(K)
        else:
            diag_only.append(K)
    diag_only.extend(range(nsuper, nb))
    # within a level, keep reverse elimination order (pure aesthetics —
    # same-level supernodes are independent)
    sweep_levels = [sorted(l, reverse=True) for l in sweep_levels if l]

    return CommPlan(bs=bs, grid=grid, kind=kind, nb=nb, ops=ops,
                    tasks=tasks, level_of=level,
                    sweep_levels=sweep_levels, diag_only=diag_only)


# ---------------------------------------------------------------------------
# executor compilation: ops -> packed rounds -> dense device tables
# ---------------------------------------------------------------------------

# an edge is (src_dev, dst_dev, src_slot, dst_slot, nbytes)
Edge = Tuple[int, int, int, int, float]


def pack_edges(edges: Sequence[Edge]) -> List[List[Edge]]:
    """Greedy-pack edges into ppermute rounds: per round each device
    sources at most one transfer and sinks at most one transfer."""
    rounds: List[List[Edge]] = []
    for e in edges:
        for rnd in rounds:
            if all(e[0] != q[0] and e[1] != q[1] for q in rnd):
                rnd.append(e)
                break
        else:
            rounds.append([e])
    return rounds


@dataclass
class CommRound:
    """One ppermute with per-device gather/scatter tables.

    ``slots[:, 0]`` is the flat gather index a sending device reads
    (don't-care 0 for non-senders — ppermute drops their payload);
    ``slots[:, 1]`` the flat scatter index a receiving device writes.
    Non-receivers point at the buffer's **trash slot** (index = buffer
    length): the executor allocates every writable buffer one block
    larger, so no receive mask and no read-modify-write select is needed
    — a write either lands or falls into the trash block."""
    perm: List[Tuple[int, int]]
    slots: np.ndarray         # (P, 2) int32 — [gather, scatter]
    edges: List[Edge] = field(default_factory=list)


@dataclass
class LocalRound:
    """Owner-local copy (src device == dst device): no communication,
    same gather/scatter table shape as :class:`CommRound`."""
    slots: np.ndarray         # (P, 2) int32


def _round_tables(edges: Sequence[Edge], P: int, trash: int) -> CommRound:
    slots = np.zeros((P, 2), np.int32)
    slots[:, 1] = trash
    perm = []
    for (s, d, ss, ds, _nb) in edges:
        perm.append((s, d))
        slots[s, 0] = ss
        slots[d, 1] = ds
    return CommRound(perm=perm, slots=slots, edges=list(edges))


def _local_rounds(ops: Sequence[Tuple[int, int, int]], P: int, trash: int
                  ) -> List[LocalRound]:
    """Pack (dev, src_slot, dst_slot) copies, one per device per round
    (an owner-local copy is an edge with src device == dst device)."""
    out = []
    for rnd in pack_edges([(dev, dev, ss, ds, 0.0)
                           for (dev, ss, ds) in ops]):
        slots = np.zeros((P, 2), np.int32)
        slots[:, 1] = trash
        for (dev, _d, ss, ds, _nb) in rnd:
            slots[dev, 0] = ss
            slots[dev, 1] = ds
        out.append(LocalRound(slots=slots))
    return out


def _schedule_tree_edges(per_op: Sequence[List[List[Edge]]], align: str,
                         P: int, trash: int) -> List[CommRound]:
    """Earliest-fire list scheduling of several collectives' tree edges
    into shared executable rounds (the asynchronous pipelining: an edge
    fires as soon as (1) its data dependency within its own tree is
    satisfied — for a broadcast the edge that delivered to its source,
    for a reduction every edge combining into its source — and (2) a
    ppermute slot is free, i.e. its source/destination device is not
    already used this round). Rounds are executed as barriers, so firing
    strictly after all dependencies is sufficient for correctness."""
    items: List[Tuple[Edge, List[int]]] = []
    for rounds in per_op:
        base = len(items)
        delivered: Dict[int, int] = {}     # node -> item index that fed it
        into: Dict[int, List[int]] = defaultdict(list)
        flat = [e for rnd in rounds for e in rnd]
        if align == "left":                # broadcast orientation
            for j, e in enumerate(flat):
                delivered[e[1]] = base + j
            for j, e in enumerate(flat):
                dep = delivered.get(e[0])
                items.append((e, [dep] if dep is not None else []))
        else:                              # reduce orientation
            for j, e in enumerate(flat):
                into[e[1]].append(base + j)
            for e in flat:
                items.append((e, list(into.get(e[0], ()))))

    fired = [None] * len(items)
    remaining = list(range(len(items)))
    out: List[CommRound] = []
    while remaining:
        used_s, used_d, this = set(), set(), []
        for i in remaining:
            e, deps = items[i]
            if any(fired[d] is None for d in deps):
                continue
            if e[0] in used_s or e[1] in used_d:
                continue
            this.append(i)
            used_s.add(e[0])
            used_d.add(e[1])
        if not this:
            raise ValueError("cyclic edge dependencies in tree schedule")
        for i in this:
            fired[i] = len(out)
        remaining = [i for i in remaining if fired[i] is None]
        out.append(_round_tables([items[i][0] for i in this], P, trash))
    return out


@dataclass
class LevelExec:
    """Dense tables driving one elimination-tree level of the sweep."""
    Ks: np.ndarray                   # (nk,) supernode ids
    xfer_in_local: List[LocalRound]  # Lh -> Uh (transpose), owner-local
    xfer_in: List[CommRound]         # Lh -> Uh (transpose), p2p
    bcast: List[CommRound]           # Uh -> Uh down grid columns
    cmask: np.ndarray                # (pc, nk, nbc) struct mask
    reduce: List[CommRound]          # partial -> partial along grid rows
    kcs: np.ndarray                  # (nk,) K // pc
    col_write_row: np.ndarray        # (pr, nk, nbr)
    col_write_col: np.ndarray        # (pc, nk)
    xfer_out_local: List[LocalRound]
    xfer_out: List[CommRound]        # Ainv -> Ainv (transpose), p2p
    krs: np.ndarray                  # (nk,) K // pr
    diag_rowmask: np.ndarray         # (pr, nk)
    diag_reduce: List[CommRound]     # S -> S within row K%pr
    diag_root: np.ndarray            # (nk,) owner(K,K) device id
    diag_slot: np.ndarray            # (nk,) flat Ainv slot of (K,K)


@dataclass
class ExecPlan:
    nb: int
    pr: int
    pc: int
    diag_set_root: np.ndarray        # (m,) device ids, empty-struct diag
    diag_set_slot: np.ndarray        # (m,) flat Ainv slots
    levels: List[LevelExec]

    @property
    def nbr(self) -> int:
        return self.nb // self.pr

    @property
    def nbc(self) -> int:
        return self.nb // self.pc


def _level_tables(plan: CommPlan, Ks: Sequence[int]):
    """The per-level dense mask/index tables both executor lowerings
    share (one derivation — `compile_exec` and `_overlap_items` must
    never drift): cmask, col_write_row, col_write_col, diag_rowmask,
    kcs, krs, diag_root, diag_slot."""
    grid, nb = plan.grid, plan.nb
    pr, pc = grid.pr, grid.pc
    nbr, nbc = nb // pr, nb // pc
    nk = len(Ks)
    cmask = np.zeros((pc, nk, nbc))
    cw_row = np.zeros((pr, nk, nbr))
    cw_col = np.zeros((pc, nk))
    d_rowmask = np.zeros((pr, nk))
    for k, K in enumerate(Ks):
        for I in plan.bs.struct[K]:
            I = int(I)
            cmask[I % pc, k, I // pc] = 1.0
            cw_row[I % pr, k, I // pr] = 1.0
        cw_col[K % pc, k] = 1.0
        d_rowmask[K % pr, k] = 1.0
    return dict(
        cmask=cmask, col_write_row=cw_row, col_write_col=cw_col,
        diag_rowmask=d_rowmask,
        kcs=np.array([K // pc for K in Ks], np.int32),
        krs=np.array([K // pr for K in Ks], np.int32),
        diag_root=np.array([grid.owner(K, K) for K in Ks], np.int32),
        diag_slot=np.array([(K // pr) * nbc + K // pc for K in Ks],
                           np.int32))


def compile_exec(plan: CommPlan) -> ExecPlan:
    """Compile the IR into the level-pipelined executable form: every
    collective of a level shares rounds with its independent siblings."""
    grid, nb = plan.grid, plan.nb
    pr, pc, P = grid.pr, grid.pc, grid.size
    if nb % pr or nb % pc:
        raise ValueError(f"nb={nb} not divisible by grid {pr}x{pc}")
    nbr, nbc = nb // pr, nb // pc
    bs = plan.bs
    by_sn = plan.ops_by_supernode()

    droot = np.array([grid.owner(K, K) for K in plan.diag_only],
                     dtype=np.int32)
    dslot = np.array([(K // pr) * nbc + K // pc for K in plan.diag_only],
                     dtype=np.int32)

    levels: List[LevelExec] = []
    for Ks in plan.sweep_levels:
        nk = len(Ks)
        k_of = {K: k for k, K in enumerate(Ks)}
        xi_local: List[Tuple[int, int, int]] = []
        xi_edges: List[Edge] = []
        bcast_ops: List[List[List[Edge]]] = []
        red_ops: List[List[List[Edge]]] = []
        xo_local: List[Tuple[int, int, int]] = []
        xo_edges: List[Edge] = []
        dred_ops: List[List[List[Edge]]] = []
        tabs = _level_tables(plan, Ks)

        for K in Ks:
            k = k_of[K]
            C = [int(i) for i in bs.struct[K]]
            for I in C:
                # owner-local transfers are layout copies, not comm ops
                if grid.owner(I, K) == grid.owner(K, I):
                    xi_local.append((grid.owner(I, K),
                                     (I // pr) * nbc + K // pc,
                                     k * nbc + I // pc))
                    xo_local.append((grid.owner(I, K),
                                     (I // pr) * nbc + K // pc,
                                     (K // pr) * nbc + I // pc))

            for op in by_sn.get(K, ()):
                if op.kind == "xfer":
                    I = op.block
                    dst = [r for r in op.participants if r != op.root][0]
                    xi_edges.append((op.root, dst,
                                     (I // pr) * nbc + K // pc,
                                     k * nbc + I // pc, op.nbytes))
                elif op.kind == "col-bcast":
                    I = op.block
                    slot = k * nbc + I // pc
                    bcast_ops.append(
                        [[(s, d, slot, slot, op.nbytes) for (s, d) in rnd]
                         for rnd in op.tree.bcast_rounds()])
                elif op.kind == "row-reduce":
                    J = op.block
                    slot = k * nbr + J // pr
                    red_ops.append(
                        [[(s, d, slot, slot, op.nbytes) for (s, d) in rnd]
                         for rnd in op.tree.reduce_rounds()])
                elif op.kind == "xfer-out":
                    J = op.block
                    dst = [r for r in op.participants if r != op.root][0]
                    xo_edges.append((op.root, dst,
                                     (J // pr) * nbc + K // pc,
                                     (K // pr) * nbc + J // pc, op.nbytes))
                elif op.kind == "diag-reduce":
                    dred_ops.append(
                        [[(s, d, k, k, op.nbytes) for (s, d) in rnd]
                         for rnd in op.tree.reduce_rounds()])
                elif op.kind == "diag-bcast":
                    pass   # loop-1 normalization is absorbed on the host
                           # (prepare_inputs ships L̂/D⁻¹ pre-normalized)
                else:
                    raise ValueError(
                        f"compile_exec cannot lower op kind {op.kind!r} — "
                        "teach it the new kind or the executed schedule "
                        "silently drifts from the simulated one")

        t_uh = nk * nbc           # trash slot of each writable buffer
        t_pf = nk * nbr
        t_ai = nbr * nbc
        levels.append(LevelExec(
            Ks=np.asarray(Ks, dtype=np.int64),
            xfer_in_local=_local_rounds(xi_local, P, t_uh),
            xfer_in=[_round_tables(r, P, t_uh)
                     for r in pack_edges(xi_edges)],
            bcast=_schedule_tree_edges(bcast_ops, "left", P, t_uh),
            cmask=tabs["cmask"],
            reduce=_schedule_tree_edges(red_ops, "right", P, t_pf),
            kcs=tabs["kcs"],
            col_write_row=tabs["col_write_row"],
            col_write_col=tabs["col_write_col"],
            xfer_out_local=_local_rounds(xo_local, P, t_ai),
            xfer_out=[_round_tables(r, P, t_ai)
                      for r in pack_edges(xo_edges)],
            krs=tabs["krs"],
            diag_rowmask=tabs["diag_rowmask"],
            diag_reduce=_schedule_tree_edges(dred_ops, "right", P, nk),
            diag_root=tabs["diag_root"],
            diag_slot=tabs["diag_slot"]))

    return ExecPlan(nb=nb, pr=pr, pc=pc, diag_set_root=droot,
                    diag_set_slot=dslot, levels=levels)


# ---------------------------------------------------------------------------
# overlapped cross-level lowering: one global round stream + coalescing
# ---------------------------------------------------------------------------

#: phase ordering inside the packing priority (lower fires first when
#: competing for the same ppermute slot)
_PH_XI, _PH_BC, _PH_RED, _PH_XO, _PH_DRED = range(5)


@dataclass
class _Item:
    """One schedulable unit of the overlapped sweep: a comm edge, an
    owner-local copy, or a compute op. ``deps`` are item indices that must
    fire strictly earlier (edges/locals: an earlier round; compute: the
    same or an earlier round boundary)."""
    prio: Tuple[int, int, int]
    deps: List[int] = field(default_factory=list)
    src: int = -1
    dst: int = -1
    gslot: int = 0
    dslot: int = 0
    add: bool = False
    transpose: bool = False
    kind: str = ""                 # op kind for byte accounting
    level: int = -1
    nbytes: float = 0.0
    local: bool = False
    compute: str = ""              # "gemm" | "write" | "scomp" | "diagw"
    from_lh: bool = False          # gather from the input L̂ shard, not
                                   # the arena (xfer-in lanes only)


@dataclass
class GlobalRound:
    """One ppermute of the global overlapped stream. The payload is a
    stack of ``width`` (b, b) blocks: a (src, dst) pair that carries
    several coalesced blocks uses several lanes of the same permute;
    devices with fewer blocks pad (gather lane 0, scatter to trash).

    Per-device tables (all (P, width)): ``gather``/``scatter`` flat arena
    slots, ``addm`` 1.0 where the lane accumulates (reductions) instead of
    overwriting, ``tmask`` True where the receiver transposes the lane
    (the L̂→Û and A⁻¹ symmetric handoffs), ``glh`` True where the sender
    gathers from the resident input L̂ shard instead of the arena (the
    xfer-in lanes; the arena holds no L̂ copy — the lane's gather index
    is then a flat [0, N) L̂ slot). ``lgather``/``lscatter``/``ltmask``/
    ``lglh`` ((P, lwidth)) are owner-local copies executed before the
    permute. ``edges`` keeps (src, dst, kind, level, nbytes) per lane for
    byte accounting and the dependence-property tests."""
    perm: List[Tuple[int, int]]
    width: int
    gather: np.ndarray
    scatter: np.ndarray
    addm: np.ndarray
    tmask: np.ndarray
    edges: List[Tuple[int, int, str, int, float]]
    glh: np.ndarray | None = None
    lwidth: int = 0
    lgather: np.ndarray | None = None
    lscatter: np.ndarray | None = None
    ltmask: np.ndarray | None = None
    lglh: np.ndarray | None = None
    lmoves: List[Tuple[int, str, int]] = field(default_factory=list)


@dataclass(frozen=True)
class ComputeOp:
    """A compute step fired at a round boundary (before that round's
    comm): the level's masked GEMM, the A⁻¹(C,K) column write, the
    diagonal partial-sum S, or the diagonal write."""
    kind: str                      # "gemm" | "write" | "scomp" | "diagw"
    level: int                     # index into OverlappedExec.levels


@dataclass
class OverlapLevel:
    """Per-level compute metadata of the overlapped stream (the masks of
    :class:`LevelExec`) plus the level's arena addressing. ``u_gather``
    replaces the dense Û base offset: the level's Û blocks live in
    compact recycled pool slots (:func:`_u_pool_layout`), and the table
    maps the GEMM's dense (k, j) lane grid back onto them (trash where
    no struct entry exists — the struct mask zeroes those lanes).
    ``base_p``/``base_s`` point into the single *shared* partial / S
    regions every generation aliases; the scheduler's anti-dependences
    keep aliased occupancies disjoint in time."""
    Ks: np.ndarray
    u_gather: np.ndarray           # (P, nk*nbc) arena addresses of Û lanes
    base_p: int                    # partial stack offset (nk*nbr blocks)
    base_s: int                    # diagonal S stack offset (nk blocks)
    cmask: np.ndarray              # (pc, nk, nbc)
    kcs: np.ndarray
    col_write_row: np.ndarray
    col_write_col: np.ndarray
    krs: np.ndarray
    diag_rowmask: np.ndarray
    diag_root: np.ndarray
    diag_slot: np.ndarray


@dataclass
class OverlappedExec:
    """The overlapped compilation: a single global sequence of coalesced
    ppermute rounds spanning every elimination-tree level, plus the
    compute ops pinned to round boundaries (``compute_at[t]`` runs before
    round ``t``; the final entry after the last round). The arena is one
    flat per-device block buffer: [0, n_ainv) A⁻¹, then the compact
    recycled Û slot pool (:func:`_u_pool_layout`), then **one** shared
    partial region and one shared S region that every elimination-tree
    level aliases (their liveness never spans two levels), with the
    shared trash block last. The read-only input L̂ shard is **not**
    copied in: xfer-in lanes gather straight from it through the
    per-lane ``glh``/``lglh`` masks of :class:`GlobalRound`, which
    shaves ``n_ainv`` blocks off the footprint and puts the overlapped
    peak *below* the level-serial executor's. Generations that alias
    the same physical slots are separated in time by the scheduler's
    generation-keyed anti-dependences (see :func:`_overlap_items`), so
    the arena footprint no longer grows with the number of levels."""
    nb: int
    pr: int
    pc: int
    n_ainv: int
    arena_blocks: int              # trash included
    trash: int
    diag_set_root: np.ndarray
    diag_set_slot: np.ndarray
    levels: List[OverlapLevel]
    rounds: List[GlobalRound]
    compute_at: List[List[ComputeOp]]   # len == len(rounds) + 1
    window: int | None = None      # Û pool liveness window (None = whole
                                   # sweep resident, no Û recycling)

    @property
    def nbr(self) -> int:
        return self.nb // self.pr

    @property
    def nbc(self) -> int:
        return self.nb // self.pc


def exec_byte_counts(ex: "ExecPlan | OverlappedExec"
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Per-rank outgoing/incoming bytes by phase kind, summed over the
    *compiled* rounds — the bytes the device program actually moves. The
    equivalence test checks these against ``simulator.volumes`` (same
    plan, independent accounting path). Accepts both the level-serial
    :class:`ExecPlan` and the cross-level :class:`OverlappedExec`."""
    if isinstance(ex, OverlappedExec):
        return overlapped_byte_counts(ex)
    P = ex.pr * ex.pc
    out: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    inc: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))

    def add(kind: str, rounds: List[CommRound]):
        for rnd in rounds:
            for (s, d, _ss, _ds, nb_) in rnd.edges:
                out[kind][s] += nb_
                inc[kind][d] += nb_

    for lv in ex.levels:
        add("xfer", lv.xfer_in)
        add("col-bcast", lv.bcast)
        add("row-reduce", lv.reduce)
        add("xfer-out", lv.xfer_out)
        add("diag-reduce", lv.diag_reduce)
    return dict(out), dict(inc)


def overlapped_byte_counts(ov: OverlappedExec
                           ) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, np.ndarray]]:
    """Per-rank outgoing/incoming bytes by op kind over the overlapped
    global rounds. Coalescing moves the same bytes in fewer rounds, so
    these must equal :func:`exec_byte_counts` of the level-serial path
    and ``simulator.volumes`` (tested)."""
    P = ov.pr * ov.pc
    out: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    inc: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    for rnd in ov.rounds:
        for (s, d, kind, _lv, nb_) in rnd.edges:
            out[kind][s] += nb_
            inc[kind][d] += nb_
    return dict(out), dict(inc)


def ppermute_round_count(ex: "ExecPlan | OverlappedExec") -> int:
    """Number of ``lax.ppermute`` rounds a compiled sweep issues (local
    copy rounds are free and not counted)."""
    if isinstance(ex, OverlappedExec):
        return sum(1 for r in ex.rounds if r.perm)
    return sum(len(lv.xfer_in) + len(lv.bcast) + len(lv.reduce)
               + len(lv.xfer_out) + len(lv.diag_reduce)
               for lv in ex.levels)


def peak_arena_blocks(ex: "ExecPlan | OverlappedExec") -> int:
    """Peak per-device working-buffer footprint of a compiled sweep, in
    (b, b) blocks — the memory axis of the scalability story (the
    symmetric-case PSelInv paper's per-process memory bound).

    Level-serial: A⁻¹ (N + 1 trash) + the input L̂ shard (N, read in
    place) + the largest level's transient Û/partial/S stacks (one
    trash block each, freed at the level barrier). Overlapped: the flat
    arena (A⁻¹ + the compact recycled Û pool + the shared partial/S
    regions + trash, :class:`OverlappedExec`) **plus** the resident
    input L̂ shard — xfer-in lanes gather straight from the input
    through the per-lane ``glh`` masks, so the arena holds no L̂ copy
    and only the input's N blocks count. The read-only D⁻¹ shard
    (N blocks) is input-resident in both paths and excluded, so the two
    numbers compare like for like; before slot recycling the overlapped
    arena dense-stacked *every* level's Û/partial/S and peaked at ~3×
    the serial path at nb=32, compaction brought it to ~1.2×, and
    dropping the arena L̂ copy lands it *below* the serial peak
    (~0.9×, asserted in the bench and tests)."""
    N = ex.nbr * ex.nbc
    if isinstance(ex, OverlappedExec):
        return ex.arena_blocks + N
    lvl = max((len(lv.Ks) * (ex.nbc + ex.nbr + 1) + 3 for lv in ex.levels),
              default=0)
    return 2 * N + 1 + lvl


def _u_pool_layout(plan: CommPlan, window: int | None
                   ) -> Tuple[List[Dict[Tuple[int, int], Tuple[int, int]]],
                              int]:
    """The overlapped arena's Û **slot allocator**: compact, per-column,
    liveness-window recycled.

    The level-serial executor's dense Û indexing (slot ``k*nbc + I//pc``)
    reserves ``nk*nbc`` blocks per level although only struct-present
    (K, I) pairs are ever filled; summed over every level of the sweep
    that dense layout is what blew the overlapped arena to ~3-4× the
    serial peak. Here each level's Û stack gets one compact slot per
    live (K, I) entry instead, allocated **per grid column** (a block
    Û(K, I) only exists on the devices of column ``I % pc``, so the two
    columns' allocators share the same address range — the same arena
    address holds different blocks on different columns, exactly like
    the dense layout's repeated slot numbers, and the dependence keys
    stay (device, slot, generation)).

    Liveness: a level's Û slots are written from its first xfer-in and
    last read by its ``scomp`` — so a slot is *dead* once its tenant
    level's scomp has fired. The allocator hands out fresh addresses
    while a column's pool is under its cap and otherwise **recycles the
    oldest freed slot** (FIFO by tenant level), recording the previous
    tenant's generation so the scheduler can key the WAR anti-dependence
    on that tenant's scomp. ``window=None`` (the default) sets the cap
    to the whole sweep — no Û recycling, which preserves the
    unthrottled prefetch schedule (round counts unchanged) while the
    compaction alone keeps the pool below one level's dense stack.
    ``window=w`` caps each column's pool at the largest total of ``w``
    consecutive levels, i.e. at most ~w adjacent generations live.

    Returns (per level: {(k, I) -> (address, previous-tenant level or
    -1)}, pool size in blocks). Addresses are relative to the pool
    base."""
    from collections import deque

    pc = plan.grid.pc
    bs = plan.bs
    nlev = len(plan.sweep_levels)
    entries: List[Dict[int, List[Tuple[int, int]]]] = []
    for Ks in plan.sweep_levels:
        per_c: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for k, K in enumerate(Ks):
            for I in bs.struct[K]:
                I = int(I)
                per_c[I % pc].append((k, I))
        entries.append({c: sorted(v) for c, v in per_c.items()})

    caps: Dict[int, int] = {}
    for c in range(pc):
        sizes = [len(entries[L].get(c, ())) for L in range(nlev)]
        if window is None:
            caps[c] = sum(sizes)
        else:
            w = max(1, int(window))
            caps[c] = max((sum(sizes[i:i + w])
                           for i in range(max(1, nlev - w + 1))), default=0)

    out: List[Dict[Tuple[int, int], Tuple[int, int]]] = []
    used = {c: 0 for c in range(pc)}
    free_q: Dict[int, deque] = {c: deque() for c in range(pc)}
    for L in range(nlev):
        amap: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for c, ents in entries[L].items():
            for (k, I) in ents:
                if used[c] < caps[c] or not free_q[c]:
                    amap[(k, I)] = (used[c], -1)
                    used[c] += 1
                else:
                    addr, tenant = free_q[c].popleft()
                    amap[(k, I)] = (addr, tenant)
        for c, ents in entries[L].items():     # dead after scomp(L)
            for (k, I) in ents:
                free_q[c].append((amap[(k, I)][0], L))
        out.append(amap)
    return out, max(used.values(), default=0)


def _overlap_items(plan: CommPlan, window: int | None = None
                   ) -> Tuple[List[_Item], List[OverlapLevel],
                              int, int]:
    """Lower the CommPlan into the overlapped item DAG.

    Returns (items, level metadata, n_ainv, arena_blocks).
    Dependence model — RAW *and* WAR hazards on the arena are encoded as
    deps; reductions accumulate through dep-ordered adds:

      xfer-in(L)           — scomp(T) of the previous tenant T of its
                             recycled Û slot (WAR; no deps on fresh
                             slots — the payload only reads the static
                             L̂ shard)
      col-bcast(L) edge    — its in-tree parent edge; tree-root edges the
                             xfer-in item that filled the root's Û slot
                             (generation-keyed, see below)
      gemm(L)              — all xfer-in/col-bcast of L, plus every A⁻¹
                             write of level L-1 (write/xfer-out/diagw;
                             transitively all shallower levels), plus
                             write(L-1) (WAR: the shared partial region's
                             previous generation must be fully read)
      row-reduce(L) edge   — in-tree children edges + gemm(L)
      write(L)             — gemm(L) + all row-reduce(L)
      xfer-out(L)          — write(L)
      scomp(L)             — write(L) + all xfer-out(L) + diagw(L-1)
                             (WAR on the shared S region)
      diag-reduce(L) edge  — in-tree children edges + scomp(L)
      diagw(L)             — scomp(L) + all diag-reduce(L)

    Only the gemm→…→diagw chain serializes across levels; every
    xfer-in/col-bcast round of level L+1 is free to interleave with
    level L's GEMM-side rounds — the paper's §3 asynchronous pipelining
    across elimination-tree levels.

    **Liveness windows / slot recycling.** A level's Û slots are live
    from their fill to the level's scomp, the partial stack from gemm to
    write, the S stack from scomp to diagw. The partial and S stacks of
    different levels therefore *never* overlap in time — the compute
    chain itself separates the generations — so the arena keeps exactly
    **one** shared partial region and one shared S region (sized for the
    largest level), aliased by every generation at zero scheduling cost:
    the WAR deps ``write(L-1)`` / ``diagw(L-1)`` above are already
    implied by the RAW chain and encoded explicitly so the hazard model
    survives refactors. Û slots come from the compact recycled pool of
    :func:`_u_pool_layout`; a recycled slot's fill carries the previous
    tenant's ``scomp`` as an anti-dependence — ``scomp(T)`` dominates
    every reader of tenant T's slots (the broadcast forwards and the
    gemm all precede it by RAW deps), so one dep per slot suffices. The
    peak footprint drops from ~3× the level-serial executor's transient
    peak (O(Σ_L nk_L · nbc) dense-stacked blocks) to ~1.2×
    (:func:`peak_arena_blocks`, regression-guarded in the bench)."""
    grid, nb = plan.grid, plan.nb
    pr, pc = grid.pr, grid.pc
    if nb % pr or nb % pc:
        raise ValueError(f"nb={nb} not divisible by grid {pr}x{pc}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1 (or None)")
    nbr, nbc = nb // pr, nb // pc
    bs = plan.bs
    by_sn = plan.ops_by_supernode()
    N = nbr * nbc

    # ---- arena layout: A⁻¹, then the compact recycled Û pool + one
    # shared partial region + one shared S region (single-generation
    # liveness). No L̂ region: xfer-in lanes gather from the resident
    # input shard directly (``from_lh`` → the executor's glh masks) ----
    u_pool, u_size = _u_pool_layout(plan, window)
    u_base = N
    base_p = u_base + u_size
    base_s = base_p + max((len(Ks) * nbr for Ks in plan.sweep_levels),
                          default=0)
    arena_blocks = base_s + max((len(Ks) for Ks in plan.sweep_levels),
                                default=0) + 1
    trash = arena_blocks - 1

    items: List[_Item] = []
    levels: List[OverlapLevel] = []
    prev_writers: List[int] = []       # A⁻¹-writing items of level L-1
    # last reader of each region per level (generation): recycling keys
    # the anti-dependence on the previous tenant's entry
    write_of: List[int] = []
    scomp_of: List[int] = []
    diagw_of: List[int] = []

    # (device, Û arena slot, generation) -> the xfer-in item that fills
    # it. The device is part of the key: the per-column allocators share
    # one address range, so equal slot numbers on *different* grid
    # columns hold different blocks, and a slot-only key would wire a
    # broadcast's root to the wrong fill. The *generation* (= level) is
    # part of the key because recycling makes slot numbers repeat across
    # levels: a (device, slot)-only lookup could resolve to the previous
    # tenant's fill and ship stale data into a broadcast
    u_filler: Dict[Tuple[int, int, int], int] = {}

    for L, Ks in enumerate(plan.sweep_levels):
        nk = len(Ks)
        k_of = {K: k for k, K in enumerate(Ks)}

        tabs = _level_tables(plan, Ks)

        # this level's Û slots: arena address + WAR dep (the previous
        # tenant's scomp) per (k, I) entry
        def u_slot(k: int, I: int) -> Tuple[int, List[int]]:
            addr, tenant = u_pool[L][(k, I)]
            return (u_base + addr,
                    [scomp_of[tenant]] if tenant >= 0 else [])

        # per-device gather table feeding the level GEMM / S einsum:
        # entry k*nbc + j holds the arena address of Û(K_k, j*pc + c) on
        # a column-c device, or the trash block where no struct entry
        # exists (the struct mask zeroes those lanes before use)
        u_gather = np.full((grid.size, nk * nbc), trash, np.int32)
        for (k, I), (addr, _tenant) in u_pool[L].items():
            for rho in range(pr):
                u_gather[rho * pc + I % pc, k * nbc + I // pc] = \
                    u_base + addr

        xi_bc_ids: List[int] = []
        red_ids: List[int] = []
        xo_ids: List[int] = []
        dred_ids: List[int] = []

        def _add(it: _Item) -> int:
            items.append(it)
            return len(items) - 1

        for K in Ks:
            k = k_of[K]
            C = [int(i) for i in bs.struct[K]]
            for I in C:
                if grid.owner(I, K) == grid.owner(K, I):
                    slot, war = u_slot(k, I)
                    i = _add(_Item(
                        prio=(L, _PH_XI, len(items)), deps=war,
                        local=True,
                        src=grid.owner(I, K), dst=grid.owner(I, K),
                        gslot=(I // pr) * nbc + K // pc, from_lh=True,
                        dslot=slot, transpose=True, kind="xfer-local",
                        level=L))
                    u_filler[(grid.owner(K, I), slot, L)] = i
                    xi_bc_ids.append(i)         # the owner-local fills
        for K in Ks:
            k = k_of[K]
            for op in by_sn.get(K, ()):
                if op.kind == "xfer":
                    I = op.block
                    dst = [r for r in op.participants if r != op.root][0]
                    slot, war = u_slot(k, I)
                    u_filler[(dst, slot, L)] = i = _add(_Item(
                        prio=(L, _PH_XI, len(items)), deps=war,
                        src=op.root, dst=dst,
                        gslot=(I // pr) * nbc + K // pc, from_lh=True,
                        dslot=slot, transpose=True, kind="xfer",
                        level=L, nbytes=op.nbytes))
                    xi_bc_ids.append(i)
                elif op.kind == "col-bcast":
                    I = op.block
                    slot, war = u_slot(k, I)
                    flat = [e for rnd in op.tree.bcast_rounds() for e in rnd]
                    delivered: Dict[int, int] = {}
                    for (s, d) in flat:
                        if s in delivered:
                            deps = [delivered[s]]
                        elif (s, slot, L) in u_filler:
                            deps = [u_filler[(s, slot, L)]]
                        else:
                            deps = list(war)
                        delivered[d] = _add(_Item(
                            prio=(L, _PH_BC, len(items)), deps=deps,
                            src=s, dst=d, gslot=slot, dslot=slot,
                            kind="col-bcast", level=L, nbytes=op.nbytes))
                        xi_bc_ids.append(delivered[d])
                elif op.kind in ("row-reduce", "diag-reduce",
                                 "xfer-out", "diag-bcast"):
                    pass      # lowered below / host-absorbed (diag-bcast)
                else:
                    raise ValueError(
                        f"schedule_overlapped cannot lower {op.kind!r} — "
                        "teach it the new kind or the executed schedule "
                        "silently drifts from the simulated one")

        # WAR on the shared partial region: write(L-1) is its previous
        # generation's last reader (transitively implied by the
        # gemm→write chain, but encoded explicitly so the hazard model
        # survives refactors)
        gemm_id = _add(_Item(prio=(L, _PH_BC, len(items)),
                             deps=xi_bc_ids + prev_writers
                             + ([write_of[L - 1]] if L else []),
                             compute="gemm", level=L))

        for K in Ks:
            k = k_of[K]
            for op in by_sn.get(K, ()):
                if op.kind != "row-reduce":
                    continue
                J = op.block
                slot = base_p + k * nbr + J // pr
                flat = [e for rnd in op.tree.reduce_rounds() for e in rnd]
                ids = [_add(_Item(prio=(L, _PH_RED, len(items)),
                                  src=s, dst=d, gslot=slot, dslot=slot,
                                  add=True, kind="row-reduce", level=L,
                                  nbytes=op.nbytes))
                       for (s, d) in flat]
                into: Dict[int, List[int]] = defaultdict(list)
                for i, (s, d) in zip(ids, flat):
                    into[d].append(i)
                for i, (s, d) in zip(ids, flat):
                    items[i].deps = into.get(s, []) + [gemm_id]
                red_ids.extend(ids)

        write_id = _add(_Item(prio=(L, _PH_RED, len(items)),
                              deps=[gemm_id] + red_ids,
                              compute="write", level=L))

        for K in Ks:
            k = k_of[K]
            C = [int(i) for i in bs.struct[K]]
            for I in C:
                if grid.owner(I, K) == grid.owner(K, I):
                    xo_ids.append(_add(_Item(
                        prio=(L, _PH_XO, len(items)), deps=[write_id],
                        local=True, src=grid.owner(I, K),
                        dst=grid.owner(I, K),
                        gslot=(I // pr) * nbc + K // pc,
                        dslot=(K // pr) * nbc + I // pc,
                        transpose=True, kind="xfer-out-local", level=L)))
            for op in by_sn.get(K, ()):
                if op.kind != "xfer-out":
                    continue
                J = op.block
                dst = [r for r in op.participants if r != op.root][0]
                xo_ids.append(_add(_Item(
                    prio=(L, _PH_XO, len(items)), deps=[write_id],
                    src=op.root, dst=dst,
                    gslot=(J // pr) * nbc + K // pc,
                    dslot=(K // pr) * nbc + J // pc,
                    transpose=True, kind="xfer-out", level=L,
                    nbytes=op.nbytes)))

        # WAR on the shared S region: diagw(L-1) is its previous
        # generation's last reader (also transitively implied; explicit
        # for the same reason)
        scomp_id = _add(_Item(prio=(L, _PH_XO, len(items)),
                              deps=[write_id] + xo_ids
                              + ([diagw_of[L - 1]] if L else []),
                              compute="scomp", level=L))

        for K in Ks:
            k = k_of[K]
            for op in by_sn.get(K, ()):
                if op.kind != "diag-reduce":
                    continue
                slot = base_s + k
                flat = [e for rnd in op.tree.reduce_rounds() for e in rnd]
                ids = [_add(_Item(prio=(L, _PH_DRED, len(items)),
                                  src=s, dst=d, gslot=slot, dslot=slot,
                                  add=True, kind="diag-reduce", level=L,
                                  nbytes=op.nbytes))
                       for (s, d) in flat]
                into = defaultdict(list)
                for i, (s, d) in zip(ids, flat):
                    into[d].append(i)
                for i, (s, d) in zip(ids, flat):
                    items[i].deps = into.get(s, []) + [scomp_id]
                dred_ids.extend(ids)

        diagw_id = _add(_Item(prio=(L, _PH_DRED, len(items)),
                              deps=[scomp_id] + dred_ids,
                              compute="diagw", level=L))

        prev_writers = [write_id, diagw_id] + xo_ids
        write_of.append(write_id)
        scomp_of.append(scomp_id)
        diagw_of.append(diagw_id)
        levels.append(OverlapLevel(
            Ks=np.asarray(Ks, dtype=np.int64),
            u_gather=u_gather, base_p=base_p, base_s=base_s, **tabs))

    return items, levels, N, arena_blocks


def schedule_overlapped(plan: CommPlan, coalesce_max: int = 8,
                        window: int | None = None, *,
                        axis_factored: bool = True,
                        options: PlanOptions | None = None
                        ) -> OverlappedExec:
    """Compile the IR into the cross-level overlapped executable form.
    ``options`` (a :class:`PlanOptions`) overrides the loose
    ``coalesce_max``/``window`` kwargs when given — the engine/session
    path passes the whole bundle through.

    List-schedules the item DAG of :func:`_overlap_items` into one global
    round sequence: an edge fires as soon as its dependences have fired
    in earlier rounds and a ppermute slot is free; compute ops fire at
    the earliest round boundary their inputs allow. Level L+1's xfer-in
    and col-bcast traffic therefore interleaves with level L's reduce /
    xfer-out / diagonal rounds instead of barriering on them.

    Coalescing: within one round a (src, dst) device pair may carry up to
    ``coalesce_max`` blocks as extra payload lanes of the same permute
    (flat trees and the xfer phases send many blocks between the same
    pair), so the global round count drops below the level-serial path's.
    Ready edges are packed lowest-(level, phase) first, which keeps the
    critical path as tight as the serial schedule while later levels'
    traffic fills the idle lanes.

    Arena memory: the partial and S stacks always live in one shared
    region per kind (their liveness never spans two levels), and the Û
    stacks come from the compact recycled slot pool of
    :func:`_u_pool_layout`. ``window`` caps how many adjacent levels' Û
    generations may be live at once — the anti-dependences of
    :func:`_overlap_items` serialize generations that alias a slot, so
    a tighter window trades prefetch depth (and, on this DAG shape,
    ppermute rounds: delayed fills contend with the critical-path tree
    traffic for permute slots) for arena blocks. The default ``None``
    keeps every level's compact Û slots resident, which preserves the
    unthrottled round count while compaction + partial/S recycling + the
    copy-free L̂ gathers hold the peak footprint *below* the
    level-serial executor's (~0.9×; :func:`peak_arena_blocks`, asserted
    ≤1.1× in the bench and strictly below serial in the tests).

    Shift-aware packing (``axis_factored``, the default): equal-priority
    ready edges are grouped by their grid-torus offset
    ``(dr, dc) = ((dst_r - src_r) mod pr, (dst_c - src_c) mod pc)``
    before packing, so lanes that share an offset land in the same round
    whenever the critical-path order allows it. The (level, phase)
    priority still dominates — the critical path is untouched — but the
    per-round *distinct-offset* count shrinks, which is what the
    gated stream lowering (``core/stream.py``) pays wire for."""
    if options is not None:
        coalesce_max, window = options.coalesce_max, options.window
        axis_factored = options.axis_factored
    grid = plan.grid
    P = grid.size
    items, levels, N, arena_blocks = _overlap_items(plan, window=window)
    trash = arena_blocks - 1

    droot = np.array([grid.owner(K, K) for K in plan.diag_only], np.int32)
    dslot = np.array([(K // grid.pr) * (plan.nb // grid.pc) + K // grid.pc
                      for K in plan.diag_only], np.int32)

    n = len(items)
    fired = [None] * n             # edges/locals: round; compute: boundary
    remaining = set(range(n))
    compute_order = [i for i in range(n) if items[i].compute]
    rounds: List[GlobalRound] = []
    compute_at: List[List[ComputeOp]] = [[]]

    def _deps_met(i: int, t: int) -> bool:
        for d in items[i].deps:
            if fired[d] is None:
                return False
            if not items[d].compute and fired[d] >= t:
                return False       # same-round edge: not yet visible
        return True

    t = 0
    while remaining:
        # fire every runnable compute op at boundary t (fixpoint: chained
        # ops like write→scomp may become runnable within one boundary)
        progress = True
        while progress:
            progress = False
            for i in compute_order:
                if i in remaining and _deps_met(i, t):
                    fired[i] = t
                    remaining.discard(i)
                    compute_at[t].append(
                        ComputeOp(items[i].compute, items[i].level))
                    progress = True
        if not remaining:
            break

        if axis_factored:
            # group equal-(level, phase) edges by grid-torus offset: the
            # insertion-order tiebreak moves *behind* the offset so lanes
            # sharing an offset pack into the same round — fewer distinct
            # offsets per round means fewer gated permutes (and fewer
            # executed wire bytes) in the stream lowering
            def _key(i):
                it = items[i]
                L, ph, order = it.prio
                if it.local:
                    return (L, ph, (-1, -1), order)
                dr = (it.dst // grid.pc - it.src // grid.pc) % grid.pr
                dc = (it.dst % grid.pc - it.src % grid.pc) % grid.pc
                return (L, ph, (dr, dc), order)
        else:
            def _key(i):
                return items[i].prio
        ready = sorted((i for i in remaining
                        if not items[i].compute and _deps_met(i, t)),
                       key=_key)
        pair_lanes: Dict[Tuple[int, int], List[int]] = {}
        used_src: set = set()
        used_dst: set = set()
        local_lanes: Dict[int, List[int]] = defaultdict(list)
        for i in ready:
            it = items[i]
            if it.local:
                if len(local_lanes[it.src]) < coalesce_max:
                    local_lanes[it.src].append(i)
                continue
            key = (it.src, it.dst)
            if key in pair_lanes:
                if len(pair_lanes[key]) < coalesce_max:
                    pair_lanes[key].append(i)
            elif it.src not in used_src and it.dst not in used_dst:
                pair_lanes[key] = [i]
                used_src.add(it.src)
                used_dst.add(it.dst)
        if not pair_lanes and not local_lanes:
            raise ValueError(
                f"overlapped scheduler stalled at round {t} with "
                f"{len(remaining)} items left — cyclic dependences")

        width = max((len(v) for v in pair_lanes.values()), default=0)
        gather = np.zeros((P, max(width, 1)), np.int32)
        scatter = np.full((P, max(width, 1)), trash, np.int32)
        addm = np.zeros((P, max(width, 1)), np.float32)
        tmask = np.zeros((P, max(width, 1)), bool)
        glh = np.zeros((P, max(width, 1)), bool)
        edges: List[Tuple[int, int, str, int, float]] = []
        perm = []
        for (s, d), lane_ids in pair_lanes.items():
            perm.append((s, d))
            for j, i in enumerate(lane_ids):
                it = items[i]
                gather[s, j] = it.gslot
                glh[s, j] = it.from_lh
                scatter[d, j] = it.dslot
                addm[d, j] = 1.0 if it.add else 0.0
                tmask[d, j] = it.transpose
                edges.append((s, d, it.kind, it.level, it.nbytes))
                fired[i] = t
                remaining.discard(i)

        lwidth = max((len(v) for v in local_lanes.values()), default=0)
        lg = ls = lt = llh = None
        lmoves: List[Tuple[int, str, int]] = []
        if lwidth:
            lg = np.zeros((P, lwidth), np.int32)
            ls = np.full((P, lwidth), trash, np.int32)
            lt = np.zeros((P, lwidth), bool)
            llh = np.zeros((P, lwidth), bool)
            for dev, lane_ids in local_lanes.items():
                for j, i in enumerate(lane_ids):
                    it = items[i]
                    lg[dev, j] = it.gslot
                    llh[dev, j] = it.from_lh
                    ls[dev, j] = it.dslot
                    lt[dev, j] = it.transpose
                    lmoves.append((dev, it.kind, it.level))
                    fired[i] = t
                    remaining.discard(i)

        # every non-trash write this round is unique per device. Across
        # rounds a slot may host several writers — reductions accumulate,
        # and recycled regions carry one generation per liveness window —
        # but within one round two lanes landing in the same (device,
        # slot) would silently drop a payload
        for dev in range(P):
            w = [x for x in scatter[dev] if x != trash]
            if lwidth:
                w += [x for x in ls[dev] if x != trash]
            if len(set(w)) != len(w):
                raise ValueError(
                    f"overlapped round {t}: device {dev} scatters twice "
                    f"into the same arena slot ({sorted(w)}) — the "
                    "one-writer-per-(device, slot, round) invariant is "
                    "broken")

        rounds.append(GlobalRound(
            perm=perm, width=width,
            gather=gather[:, :max(width, 1)],
            scatter=scatter[:, :max(width, 1)],
            addm=addm[:, :max(width, 1)], tmask=tmask[:, :max(width, 1)],
            glh=glh[:, :max(width, 1)],
            edges=edges, lwidth=lwidth, lgather=lg, lscatter=ls,
            ltmask=lt, lglh=llh, lmoves=lmoves))
        compute_at.append([])
        t += 1

    return OverlappedExec(
        nb=plan.nb, pr=grid.pr, pc=grid.pc, n_ainv=N,
        arena_blocks=arena_blocks, trash=trash,
        diag_set_root=droot, diag_set_slot=dslot,
        levels=levels, rounds=rounds, compute_at=compute_at, window=window)


def schedule_stream(plan: CommPlan, coalesce_max: int = 8,
                    window: int | None = None, *,
                    axis_factored: bool = True,
                    shift_budget: int | None = None,
                    options: PlanOptions | None = None):
    """Compile the IR into the **uniform round-stream** executable form:
    the overlapped lowering of :func:`schedule_overlapped`, lowered once
    more into round-indexed device tables (``core/stream.py``) that a
    single ``lax.fori_loop`` body replays — identical rounds, identical
    lane and accumulation order, program size independent of the round
    count. Returns ``(OverlappedExec, StreamTables)``: the overlapped
    object stays the source of truth for round counts, byte accounting
    and the arena footprint; the tables are what the device executes
    (``pselinv_dist.make_sweep_stream``). ``axis_factored`` /
    ``shift_budget`` select the grid-factored gated-slot comm encoding
    (see :class:`PlanOptions`); the ``options`` bundle overrides both."""
    from .stream import lower_stream
    if options is not None:
        axis_factored = options.axis_factored
        shift_budget = options.shift_budget
    ov = schedule_overlapped(plan, coalesce_max=coalesce_max,
                             window=window, axis_factored=axis_factored,
                             options=options)
    return ov, lower_stream(ov, axis_factored=axis_factored,
                            shift_budget=shift_budget)
