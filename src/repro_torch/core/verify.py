"""PlanLint — the static schedule verifier every lowered artifact passes.

The paper's contribution is a *schedule property*: tree-shaped
asynchronous rounds stay correct only if no processor's in-flight
payloads collide, and stay fast only if no processor's fan-in piles up
(arXiv:1504.04714 §4). The stack lowers three executors from one
CommPlan IR, and the worst bugs so far — (device, slot) dependence keys
silently wiring a stale arena tenant — were exactly the class a static
pass over the lowered tables catches at plan time instead of as f64
mismatches. This module is that pass: a pipeline of checkers over any
lowered artifact (:class:`~.plan.CommPlan`, level-serial
:class:`~.plan.ExecPlan`, overlapped :class:`~.plan.OverlappedExec`
round list, or :class:`~.stream.StreamTables`) emitting typed
:class:`PlanDiagnostic` records instead of scattered asserts.

Checker pipeline (each family owns a stable diagnostic ``code``):

* **race detector** — happens-before over (device, slot, generation)
  keys of the overlapped arena: every col-bcast forward reads a slot
  whose *latest* visible write is its own generation's fill
  (``race/stale-read``); every recycled Û slot's new fill is
  anti-dep-ordered after the previous tenant's last reader, i.e.
  ``scomp(T) boundary <= first fill round of the next tenant``
  (``race/war-overlap``); reduce/xfer-out lanes land inside their
  level's [producer boundary, consumer boundary) liveness window; and
  no two lanes of one round write the same (device, slot)
  (``race/waw-round``).
* **permutation legality** — every ppermute (unrolled rounds, flat-ring
  and gated comm slots) has unique sources and destinations
  (``perm/dup-endpoint``), no self-edges (``perm/self-edge``), edge
  metadata consistent with the perm (``perm/edges-mismatch``), and
  single-grid-offset slot perms under ``axis_factored``
  (``perm/offset-mix``); ``recv_slot``/trash routing is total and
  in-width (``gate/recv-route``, ``gate/lane-overflow``) and the
  ``slot_active`` gate table matches the receive table it guards
  (``gate/active-mismatch`` — the one check
  ``simulator.executed_wire_bytes`` shares through
  :func:`check_stream_gates`).
* **conservation** — per-(kind, rank) wire bytes summed from the
  executor's own tables must equal the CommPlan's tree volumes in wire
  orientation (``conserve/bytes-drift``) — the one-pass unification of
  the scattered executed-equals-simulated cross-checks.
* **overload lint** (paper §4 heuristic, WARN severity) — per-(round,
  device) inbound lane histograms against the coalescing fan-in cap
  (``load/fanin``) and whole-sweep inbound byte imbalance
  (``load/imbalance``).
* **soundness** — CommTree acyclicity/coverage (``dag/cycle``), arena
  addressing bounds (``arena/out-of-bounds``), and shared partial/S
  region generation ordering (``arena/region-order``).

Entry points: :func:`verify_artifact` (one artifact),
:func:`verify_program` (everything a compiled
``pselinv_dist.PSelInvProgram`` carries), and
:func:`enforce_verification`, which applies the
``PlanOptions(verify=...)`` mode — ``"error"`` raises
:class:`PlanVerificationError` on any ERROR diagnostic, ``"warn"``
issues one ``warnings.warn`` summary, ``"off"`` skips the pass
entirely. ``tools/plan_lint.py`` is the CLI over a structure corpus,
and ``tests/test_verify.py`` is the mutation self-test harness that
corrupts lowered tables and asserts each checker fires with the right
code.
"""
from __future__ import annotations

import warnings
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .plan import CommPlan, ExecPlan, OverlappedExec
from .stream import StreamTables

__all__ = ["PlanDiagnostic", "PlanVerificationError", "VERIFY_MODES",
           "verify_artifact", "verify_program", "enforce_verification",
           "check_plan", "check_exec", "check_overlap", "check_stream",
           "check_stream_gates", "lint_report"]

#: the accepted ``PlanOptions(verify=...)`` / ``engine.analyze`` modes
VERIFY_MODES = ("error", "warn", "off")

#: default fan-in lint threshold: inbound lanes one device absorbs in a
#: single round before the overload heuristic warns (the coalescing cap
#: is the natural bound — one pair per receiver per ppermute round, at
#: most ``coalesce_max`` lanes per pair)
FANIN_MAX = 8

#: whole-sweep inbound byte imbalance (max/mean) before the load lint
#: warns — the paper's load-balancing signal, surfaced pre-execution
IMBALANCE_MAX = 4.0


@dataclass(frozen=True)
class PlanDiagnostic:
    """One typed finding of the verifier: a stable ``code`` (checker
    family / defect), ``severity`` ("error" = the lowered program is
    wrong or unsafe; "warn" = legal but suspect, e.g. load skew), a
    human message, the (device, round, slot) location where known
    (-1 = not applicable), and a fix hint."""
    code: str
    severity: str
    message: str
    device: int = -1
    round: int = -1
    slot: int = -1
    hint: str = ""

    def __str__(self) -> str:
        loc = ",".join(f"{k}={v}" for k, v in
                       (("dev", self.device), ("round", self.round),
                        ("slot", self.slot)) if v >= 0)
        s = f"[{self.severity.upper()}] {self.code}"
        if loc:
            s += f" ({loc})"
        s += f": {self.message}"
        if self.hint:
            s += f" — {self.hint}"
        return s


class PlanVerificationError(ValueError):
    """Raised by :func:`enforce_verification` in ``"error"`` mode when a
    lowered artifact carries ERROR-severity diagnostics. Carries the
    full diagnostic list on ``.diagnostics``."""

    def __init__(self, message: str, diagnostics: List[PlanDiagnostic]):
        super().__init__(message)
        self.diagnostics = diagnostics


def _err(code: str, msg: str, **loc) -> PlanDiagnostic:
    return PlanDiagnostic(code=code, severity="error", message=msg, **loc)


def _warn(code: str, msg: str, **loc) -> PlanDiagnostic:
    return PlanDiagnostic(code=code, severity="warn", message=msg, **loc)


# ---------------------------------------------------------------------------
# CommPlan: tree soundness
# ---------------------------------------------------------------------------

def check_plan(plan: CommPlan) -> List[PlanDiagnostic]:
    """Lint the IR itself: every collective's tree is acyclic, reaches
    exactly its participant set from its root, and prices non-negative
    bytes."""
    diags: List[PlanDiagnostic] = []
    for i, op in enumerate(plan.ops):
        try:
            op.tree.validate()
        except ValueError as e:
            diags.append(_err(
                "dag/cycle",
                f"op {i} ({op.kind}, supernode {op.supernode}): tree is "
                f"not a rooted spanning DAG — {e}",
                hint="rebuild the tree via plan.tree_for; a hand-edited "
                     "CommTree must reach every participant exactly once"))
            continue
        if op.tree.root != op.root:
            diags.append(_err(
                "dag/cycle",
                f"op {i} ({op.kind}, supernode {op.supernode}): tree "
                f"root {op.tree.root} != op root {op.root}",
                device=op.root))
        if set(op.tree.ranks) != set(op.participants):
            diags.append(_err(
                "dag/cycle",
                f"op {i} ({op.kind}, supernode {op.supernode}): tree "
                f"ranks {sorted(op.tree.ranks)} != participants "
                f"{sorted(op.participants)}"))
        if op.nbytes < 0:
            diags.append(_err(
                "conserve/bytes-drift",
                f"op {i} ({op.kind}, supernode {op.supernode}): negative "
                f"byte count {op.nbytes}"))
    return diags


# ---------------------------------------------------------------------------
# conservation: executor wire bytes == plan tree volumes
# ---------------------------------------------------------------------------

def _plan_wire_volumes(plan: CommPlan
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]:
    """Per-(kind, rank) wire bytes the IR's trees prescribe, in **wire
    orientation**: broadcast edges flow parent -> child, reduce edges
    child -> parent (``diag-bcast`` is host-absorbed and never moves)."""
    P = plan.grid.size
    out: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    inc: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    for op in plan.ops:
        if op.kind == "diag-bcast":
            continue
        mirrored = op.kind in ("row-reduce", "diag-reduce")
        for parent, kids in op.tree.children:
            for kid in kids:
                s, d = (kid, parent) if mirrored else (parent, kid)
                out[op.kind][s] += op.nbytes
                inc[op.kind][d] += op.nbytes
    return dict(out), dict(inc)


def _check_conservation(edges: Iterable[Tuple[int, int, str, int, float]],
                        plan: CommPlan) -> List[PlanDiagnostic]:
    """Wire bytes the executor tables carry must equal the plan's tree
    volumes per (kind, rank) — the one-pass form of the scattered
    executed-equals-simulated cross-checks."""
    P = plan.grid.size
    out_e: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    inc_e: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    for (s, d, kind, _lv, nb_) in edges:
        out_e[kind][s] += nb_
        inc_e[kind][d] += nb_
    out_p, inc_p = _plan_wire_volumes(plan)
    diags: List[PlanDiagnostic] = []
    z = np.zeros(P)
    for kind in sorted(set(out_e) | set(out_p)):
        for name, got, want in (("outgoing", out_e.get(kind, z),
                                 out_p.get(kind, z)),
                                ("incoming", inc_e.get(kind, z),
                                 inc_p.get(kind, z))):
            bad = np.flatnonzero(~np.isclose(got, want))
            if len(bad):
                r = int(bad[0])
                diags.append(_err(
                    "conserve/bytes-drift",
                    f"{kind}: {name} wire bytes drift from the plan "
                    f"volumes on {len(bad)} rank(s) — rank {r} carries "
                    f"{got[r]:.0f} B, the trees prescribe {want[r]:.0f} B",
                    device=r,
                    hint="an executor table was edited without "
                         "re-lowering, or a lowering dropped/duplicated "
                         "a tree edge"))
    return diags


# ---------------------------------------------------------------------------
# overlapped rounds: structure, races, liveness, load
# ---------------------------------------------------------------------------

def _round_lanes(ov: OverlappedExec):
    """Every lane of the compiled stream, reconstructed from the tables:
    (round, src, dst, gather_slot, scatter_slot, kind, level, nbytes,
    from_lh, local). Lane order inside ``GlobalRound.edges``/``lmoves``
    follows the scheduler's (pair, lane) nesting, so the running lane
    index recovers the table column (the ``_u_write_lanes`` idiom of the
    replay tests). Lanes whose metadata overruns the tables are skipped
    here — :func:`_check_round_structure` reports those."""
    for t, rnd in enumerate(ov.rounds):
        lane_j: Dict[Tuple[int, int], int] = {}
        for (s, d, kind, lv, nb_) in rnd.edges:
            j = lane_j.get((s, d), 0)
            lane_j[(s, d)] = j + 1
            if j >= rnd.gather.shape[1]:
                continue
            yield (t, s, d, int(rnd.gather[s, j]), int(rnd.scatter[d, j]),
                   kind, lv, nb_, bool(rnd.glh[s, j]), False)
        lane_i: Dict[int, int] = {}
        for (dev, kind, lv) in rnd.lmoves:
            j = lane_i.get(dev, 0)
            lane_i[dev] = j + 1
            if rnd.lgather is None or j >= rnd.lgather.shape[1]:
                continue
            yield (t, dev, dev, int(rnd.lgather[dev, j]),
                   int(rnd.lscatter[dev, j]), kind, lv, 0.0,
                   bool(rnd.lglh[dev, j]), True)


def _check_round_structure(ov: OverlappedExec) -> List[PlanDiagnostic]:
    """Permutation legality, in-round write uniqueness, and arena bounds
    of the unrolled round list."""
    diags: List[PlanDiagnostic] = []
    P = ov.pr * ov.pc
    trash = ov.trash
    for t, rnd in enumerate(ov.rounds):
        srcs = [s for s, _ in rnd.perm]
        dsts = [d for _, d in rnd.perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            dup = sorted({x for x in srcs if srcs.count(x) > 1}
                         | {x for x in dsts if dsts.count(x) > 1})
            diags.append(_err(
                "perm/dup-endpoint",
                f"round {t}: perm {sorted(rnd.perm)} books device(s) "
                f"{dup} as source or destination more than once — "
                "ppermute would drop a payload",
                round=t, device=dup[0],
                hint="a device may source and sink at most one transfer "
                     "per ppermute round"))
        for (s, d) in rnd.perm:
            if s == d:
                diags.append(_err(
                    "perm/self-edge",
                    f"round {t}: self-edge {s}->{d} in the perm — "
                    "owner-local copies belong in the local lane tables",
                    round=t, device=s))
        cnt: Dict[Tuple[int, int], int] = defaultdict(int)
        for (s, d, _kind, _lv, _nb) in rnd.edges:
            cnt[(s, d)] += 1
        if set(cnt) != set(rnd.perm):
            diags.append(_err(
                "perm/edges-mismatch",
                f"round {t}: edge metadata pairs {sorted(cnt)} disagree "
                f"with the permute pairs {sorted(rnd.perm)}",
                round=t))
        else:
            over = [(p, n) for p, n in cnt.items() if n > rnd.width]
            if over:
                diags.append(_err(
                    "perm/edges-mismatch",
                    f"round {t}: pair {over[0][0]} carries {over[0][1]} "
                    f"edge records but the round is {rnd.width} lanes "
                    "wide", round=t))
        # one writer per (device, slot) per round — two lanes landing in
        # the same slot inside one round silently drop a payload
        for dev in range(P):
            w = [int(x) for x in rnd.scatter[dev] if x != trash]
            if rnd.lwidth and rnd.lscatter is not None:
                w += [int(x) for x in rnd.lscatter[dev] if x != trash]
            seen = set()
            for x in w:
                if x in seen:
                    diags.append(_err(
                        "race/waw-round",
                        f"round {t}: device {dev} scatters twice into "
                        f"arena slot {x} in one round",
                        round=t, device=dev, slot=x,
                        hint="the one-writer-per-(device, slot, round) "
                             "invariant is broken — a payload is lost"))
                seen.add(x)
            for x in w:
                if not (0 <= x < ov.arena_blocks):
                    diags.append(_err(
                        "arena/out-of-bounds",
                        f"round {t}: device {dev} scatters into slot "
                        f"{x} outside the arena "
                        f"[0, {ov.arena_blocks})",
                        round=t, device=dev, slot=x))
    for (t, s, d, gs, ds, kind, lv, nb_, from_lh, local) in _round_lanes(ov):
        hi = ov.n_ainv if from_lh else ov.arena_blocks
        where = "the L-hat shard" if from_lh else "the arena"
        if not (0 <= gs < hi):
            diags.append(_err(
                "arena/out-of-bounds",
                f"round {t}: device {s} gathers {kind} lane from slot "
                f"{gs} outside {where} [0, {hi})",
                round=t, device=s, slot=gs))
    return diags


def _check_overlap_races(ov: OverlappedExec) -> List[PlanDiagnostic]:
    """The happens-before core: (device, slot, generation) domination
    and anti-dependence over the compiled rounds + compute boundaries.

    Boundary semantics (matches the scheduler): compute pinned at
    boundary ``t`` runs before round ``t``'s comm, so a write in round
    ``r`` is visible to boundary ``t`` iff ``r < t``, and a boundary's
    output is visible to round ``t`` iff ``boundary <= t``."""
    diags: List[PlanDiagnostic] = []
    at: Dict[Tuple[str, int], int] = {}
    at_idx: Dict[Tuple[str, int], int] = {}
    for t, ops in enumerate(ov.compute_at):
        for i, op in enumerate(ops):
            at[(op.kind, op.level)] = t
            at_idx[(op.kind, op.level)] = i
    nlev = len(ov.levels)
    u_lo = ov.n_ainv
    base_p = ov.levels[0].base_p if nlev else ov.n_ainv
    base_s = ov.levels[0].base_s if nlev else ov.n_ainv

    def boundary(kind: str, L: int) -> int | None:
        t = at.get((kind, L))
        if t is None:
            diags.append(_err(
                "race/stale-read",
                f"compute op ({kind}, level {L}) never fires — readers "
                "of its output race an absent producer",
                hint="the compute_at boundary list was corrupted"))
        return t

    lanes = list(_round_lanes(ov))

    # Û-region fills per (device, slot), keyed by generation (= level)
    writes: Dict[Tuple[int, int], Dict[int, List[int]]] = {}
    for (t, s, d, gs, ds, kind, lv, nb_, from_lh, local) in lanes:
        if kind in ("xfer", "col-bcast", "xfer-local") \
                and u_lo <= ds < base_p:
            writes.setdefault((d, ds), {}).setdefault(lv, []).append(t)

    def latest_levels(dev: int, slot: int, before: int):
        """Generations of the latest write into (dev, slot) strictly
        before round ``before`` (empty when never written)."""
        gens = writes.get((dev, slot), {})
        prior = [(r, l) for l, rs in gens.items() for r in rs
                 if r < before]
        if not prior:
            return None, frozenset()
        rmax = max(r for r, _l in prior)
        return rmax, frozenset(l for r, l in prior if r == rmax)

    # (1) every arena read a comm lane performs is dominated by its own
    # generation's fill: col-bcast forwards read the Û region, reduce /
    # xfer-out lanes read regions produced at compute boundaries
    for (t, s, d, gs, ds, kind, lv, nb_, from_lh, local) in lanes:
        if kind == "col-bcast" and not from_lh:
            _r, lv_at = latest_levels(s, gs, t)
            if lv not in lv_at:
                have = (f"generation(s) {sorted(lv_at)}" if lv_at
                        else "no fill at all")
                diags.append(_err(
                    "race/stale-read",
                    f"round {t}: device {s} forwards Û slot {gs} for "
                    f"generation {lv} but the latest visible write is "
                    f"{have} — the broadcast ships a stale tenant",
                    round=t, device=s, slot=gs,
                    hint="dependence keys must be (device, slot, "
                         "generation); a weaker key wires the previous "
                         "tenant's fill"))
        elif kind in ("row-reduce", "diag-reduce"):
            prod = "gemm" if kind == "row-reduce" else "scomp"
            cons = "write" if kind == "row-reduce" else "diagw"
            tp, tc = boundary(prod, lv), boundary(cons, lv)
            if tp is not None and t < tp:
                diags.append(_err(
                    "race/stale-read",
                    f"round {t}: {kind} lane {s}->{d} (level {lv}) fires "
                    f"before its producer {prod}({lv}) at boundary {tp} "
                    "— it ships an unwritten partial",
                    round=t, device=s, slot=gs))
            if tc is not None and t >= tc:
                diags.append(_err(
                    "race/stale-read",
                    f"round {t}: {kind} lane {s}->{d} (level {lv}) "
                    f"arrives at/after its consumer {cons}({lv}) at "
                    f"boundary {tc} — the contribution is lost",
                    round=t, device=d, slot=ds))
        elif kind in ("xfer-out", "xfer-out-local"):
            tw, ts_ = boundary("write", lv), boundary("scomp", lv)
            if tw is not None and t < tw:
                diags.append(_err(
                    "race/stale-read",
                    f"round {t}: xfer-out lane {s}->{d} (level {lv}) "
                    f"fires before write({lv}) at boundary {tw} — it "
                    "ships a stale A⁻¹ block",
                    round=t, device=s, slot=gs))
            if ts_ is not None and t >= ts_:
                diags.append(_err(
                    "race/stale-read",
                    f"round {t}: xfer-out lane {s}->{d} (level {lv}) "
                    f"lands at/after scomp({lv}) at boundary {ts_} — "
                    "the S einsum reads the transpose too early",
                    round=t, device=d, slot=ds))

    # (2) gemm-boundary domination: wherever a generation filled a slot,
    # that generation must still be the latest write when its level's
    # GEMM reads the slot, and every fill must land before the boundary
    for L in range(nlev):
        tg = boundary("gemm", L)
        if tg is None:
            continue
        for (dev, slot), gens in writes.items():
            if L not in gens:
                continue
            late = [r for r in gens[L] if r >= tg]
            if late:
                diags.append(_err(
                    "race/stale-read",
                    f"Û fill of generation {L} into (device {dev}, slot "
                    f"{slot}) lands in round {late[0]}, at/after its "
                    f"gemm boundary {tg} — the GEMM reads an unfilled "
                    "slot", round=late[0], device=dev, slot=slot))
                continue
            _r, lv_at = latest_levels(dev, slot, tg)
            if L not in lv_at:
                diags.append(_err(
                    "race/stale-read",
                    f"at gemm({L}) boundary {tg}, (device {dev}, slot "
                    f"{slot}) holds generation(s) {sorted(lv_at)} "
                    f"instead of {L} — a recycled tenant is visible at "
                    "read time", device=dev, slot=slot))

    # (3) WAR anti-dependence on recycled Û slots: the earlier tenant's
    # last reader (its scomp boundary) must precede the later tenant's
    # first fill round
    for (dev, slot), gens in sorted(writes.items()):
        order = sorted(gens)
        for la, lb in zip(order, order[1:]):
            ts_ = at.get(("scomp", la))
            first = min(gens[lb])
            if ts_ is None or ts_ > first:
                have = "never fires" if ts_ is None else \
                    f"fires at boundary {ts_}"
                diags.append(_err(
                    "race/war-overlap",
                    f"(device {dev}, slot {slot}): generation {lb}'s "
                    f"first fill lands in round {first} but the previous "
                    f"tenant {la}'s last reader scomp({la}) {have} — the "
                    "fill clobbers a live slot",
                    round=first, device=dev, slot=slot,
                    hint="a recycled slot's fill must carry the previous "
                         "tenant's scomp as an anti-dependence"))

    # (4) shared partial/S regions: generation L's occupancy must end
    # before generation L+1's begins (ties legal only reader-first)
    def _ordered(reader: str, writer: str, L: int, region: str):
        tr, tw = at.get((reader, L)), at.get((writer, L + 1))
        if tr is None or tw is None:
            return                      # reported by boundary() already
        ok = tr < tw or (tr == tw
                         and at_idx[(reader, L)] < at_idx[(writer, L + 1)])
        if not ok:
            diags.append(_err(
                "arena/region-order",
                f"shared {region} region: generation {L}'s last reader "
                f"{reader}({L}) at boundary {tr} does not precede "
                f"generation {L + 1}'s writer {writer}({L + 1}) at "
                f"boundary {tw} — aliased occupancies overlap in time",
                hint="compute ops sharing a boundary execute in "
                     "compute_at list order; the reader must be listed "
                     "first"))

    for L in range(nlev - 1):
        _ordered("write", "gemm", L, "partial")
        _ordered("diagw", "scomp", L, "S")

    # region geometry sanity
    if nlev and not (u_lo <= base_p <= base_s < ov.arena_blocks):
        diags.append(_err(
            "arena/out-of-bounds",
            f"arena regions out of order: n_ainv={u_lo}, "
            f"base_p={base_p}, base_s={base_s}, "
            f"arena_blocks={ov.arena_blocks}"))
    return diags


def _check_overlap_load(ov: OverlappedExec, fanin_max: int
                        ) -> List[PlanDiagnostic]:
    """The paper's overload heuristic as a pre-execution lint: WARN when
    one device's per-round inbound fan-in exceeds the coalescing cap, or
    when the whole-sweep inbound bytes skew past
    :data:`IMBALANCE_MAX` x the mean."""
    diags: List[PlanDiagnostic] = []
    P = ov.pr * ov.pc
    inbound = np.zeros(P)
    for t, rnd in enumerate(ov.rounds):
        lanes_in: Dict[int, int] = defaultdict(int)
        for (s, d, _kind, _lv, nb_) in rnd.edges:
            lanes_in[d] += 1
            inbound[d] += nb_
        for d, n in sorted(lanes_in.items()):
            if n > fanin_max:
                diags.append(_warn(
                    "load/fanin",
                    f"round {t}: device {d} absorbs {n} inbound lanes "
                    f"(> fan-in threshold {fanin_max}) — the paper's "
                    "overload heuristic flags this receiver",
                    round=t, device=d,
                    hint="spread the collective's tree or lower "
                         "coalesce_max"))
    mean = float(inbound.mean())
    if mean > 0:
        worst = int(inbound.argmax())
        ratio = float(inbound[worst]) / mean
        if ratio > IMBALANCE_MAX:
            diags.append(_warn(
                "load/imbalance",
                f"device {worst} receives {ratio:.1f}x the mean inbound "
                f"bytes over the sweep ({inbound[worst]:.0f} B vs mean "
                f"{mean:.0f} B)",
                device=worst,
                hint="a different tree kind (HYBRID/SHIFTED) "
                     "decorrelates hot roots"))
    return diags


def check_overlap(ov: OverlappedExec, plan: CommPlan | None = None, *,
                  fanin_max: int = FANIN_MAX) -> List[PlanDiagnostic]:
    """Full checker pipeline over an overlapped round stream: structural
    permutation legality, the (device, slot, generation) race detector,
    shared-region liveness, the load lint, and — when the originating
    ``plan`` is given — byte conservation against the IR's trees."""
    diags = _check_round_structure(ov)
    diags += _check_overlap_races(ov)
    diags += _check_overlap_load(ov, fanin_max)
    if plan is not None:
        diags += _check_conservation(
            (e for rnd in ov.rounds for e in rnd.edges), plan)
    return diags


# ---------------------------------------------------------------------------
# level-serial executor tables
# ---------------------------------------------------------------------------

def check_exec(ex: ExecPlan) -> List[PlanDiagnostic]:
    """Permutation legality of the level-serial executor's packed
    rounds (its phase ordering is barriered, so the race surface is the
    per-round ppermute constraint)."""
    diags: List[PlanDiagnostic] = []
    for L, lv in enumerate(ex.levels):
        phases = (("xfer", lv.xfer_in), ("col-bcast", lv.bcast),
                  ("row-reduce", lv.reduce), ("xfer-out", lv.xfer_out),
                  ("diag-reduce", lv.diag_reduce))
        for kind, rounds in phases:
            for t, rnd in enumerate(rounds):
                srcs = [s for s, _ in rnd.perm]
                dsts = [d for _, d in rnd.perm]
                if len(set(srcs)) != len(srcs) \
                        or len(set(dsts)) != len(dsts):
                    diags.append(_err(
                        "perm/dup-endpoint",
                        f"level {L} {kind} round {t}: perm "
                        f"{sorted(rnd.perm)} reuses a source or "
                        "destination", round=t))
                for (s, d) in rnd.perm:
                    if s == d:
                        diags.append(_err(
                            "perm/self-edge",
                            f"level {L} {kind} round {t}: self-edge "
                            f"{s}->{d}", round=t, device=s))
    return diags


# ---------------------------------------------------------------------------
# stream tables: slot dictionary, gates, routing, bounds
# ---------------------------------------------------------------------------

def check_stream_gates(st: StreamTables) -> List[PlanDiagnostic]:
    """The gate/receive consistency check
    ``simulator.executed_wire_bytes`` prices wire through: the active
    slot set re-derived from ``recv_slot`` must match the
    ``slot_active`` gate table the device program branches on — equal
    under ``axis_factored`` (a slot is active iff it delivers), a
    subset under the always-active flat ring."""
    diags: List[PlanDiagnostic] = []
    nslots = st.nslots
    for t in range(st.steps):
        derived = set()
        for d in range(st.pr * st.pc):
            si = int(st.recv_slot[t, d])
            if si < 0:
                continue
            if si >= nslots:
                diags.append(_err(
                    "gate/recv-route",
                    f"round {t}: device {d} receives on slot {si} but "
                    f"only {nslots} comm slots exist",
                    round=t, device=d, slot=si))
                continue
            derived.add(si)
        gated = {si for si in range(nslots) if st.slot_active[t, si]}
        if st.axis_factored and derived != gated:
            diags.append(_err(
                "gate/active-mismatch",
                f"round {t}: slots with receivers {sorted(derived)} != "
                f"gated active slots {sorted(gated)} — the gate table "
                "drifted from the receive table",
                round=t,
                slot=min(derived ^ gated) if derived ^ gated else -1,
                hint="an inactive slot with a receiver delivers zeros; "
                     "an active slot without receivers ships dead wire"))
        elif not derived <= gated:
            diags.append(_err(
                "gate/active-mismatch",
                f"round {t}: device receives on inactive slot(s) "
                f"{sorted(derived - gated)} — the arrival would be "
                "zeros", round=t, slot=min(derived - gated)))
    return diags


def check_stream(st: StreamTables, plan: CommPlan | None = None
                 ) -> List[PlanDiagnostic]:
    """Full checker pipeline over the gated stream tables: comm-slot
    dictionary legality, gate/receive consistency, scatter routing
    totality, lane-width discipline, arena bounds, and the lane-metadata
    cross-check (plus byte conservation against the plan's trees when
    given)."""
    diags: List[PlanDiagnostic] = []
    P = st.pr * st.pc

    # ---- slot dictionary ------------------------------------------------
    for si, perm in enumerate(st.slot_perm):
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            dup = sorted({x for x in srcs if srcs.count(x) > 1}
                         | {x for x in dsts if dsts.count(x) > 1})
            diags.append(_err(
                "perm/dup-endpoint",
                f"comm slot {si}: perm {sorted(perm)} books device(s) "
                f"{dup} more than once — not a permutation",
                slot=si, device=dup[0],
                hint="a slot perm must have unique sources and unique "
                     "destinations to be a (partial) permutation"))
        for (s, d) in perm:
            if s == d:
                diags.append(_err(
                    "perm/self-edge",
                    f"comm slot {si}: self-edge {s}->{d}",
                    slot=si, device=s))
            if not (0 <= s < P and 0 <= d < P):
                diags.append(_err(
                    "perm/dup-endpoint",
                    f"comm slot {si}: pair ({s}, {d}) outside the "
                    f"device range [0, {P})", slot=si))
        if st.axis_factored and perm:
            offs = {((d // st.pc - s // st.pc) % st.pr,
                     (d % st.pc - s % st.pc) % st.pc) for (s, d) in perm}
            if len(offs) != 1 or offs != {tuple(st.slot_shift[si])}:
                diags.append(_err(
                    "perm/offset-mix",
                    f"comm slot {si}: pairs span grid offsets "
                    f"{sorted(offs)}, declared {tuple(st.slot_shift[si])}"
                    " — a mixed-offset union is not a permutation",
                    slot=si))
        w = st.slot_width[si]
        if not (1 <= w <= max(st.W, 1)):
            diags.append(_err(
                "gate/lane-overflow",
                f"comm slot {si}: width {w} outside [1, {st.W}]",
                slot=si))

    # ---- gates vs receive table ----------------------------------------
    diags += check_stream_gates(st)

    # ---- routing totality + lane-width discipline ----------------------
    src_of = [dict((d, s) for (s, d) in perm) for perm in st.slot_perm]
    for t in range(st.steps):
        for d in range(P):
            lanes = [j for j in range(st.W)
                     if int(st.scatter[t, d, j]) != st.trash]
            si = int(st.recv_slot[t, d])
            if not lanes:
                continue
            if si < 0 or si >= st.nslots:
                diags.append(_err(
                    "gate/recv-route",
                    f"round {t}: device {d} scatters {len(lanes)} "
                    "lane(s) but has no receive slot — the payload "
                    "would be the previous loop carry",
                    round=t, device=d))
                continue
            if d not in src_of[si]:
                diags.append(_err(
                    "gate/recv-route",
                    f"round {t}: device {d} receives on slot {si} but "
                    "is not a destination of its perm",
                    round=t, device=d, slot=si))
                continue
            over = [j for j in lanes if j >= st.slot_width[si]]
            if over:
                diags.append(_err(
                    "gate/lane-overflow",
                    f"round {t}: device {d} scatters lane {over[0]} but "
                    f"its receive slot {si} ships only "
                    f"{st.slot_width[si]} lanes",
                    round=t, device=d, slot=si))

    # ---- arena bounds ---------------------------------------------------
    def _bounds(tab, lh_mask, what):
        bad = (tab < 0) | (tab >= st.arena_blocks)
        bad |= lh_mask & (tab >= st.n_ainv)
        idx = np.argwhere(bad)
        if len(idx):
            t, d = int(idx[0][0]), int(idx[0][1])
            diags.append(_err(
                "arena/out-of-bounds",
                f"{what} table holds {len(idx)} out-of-range "
                f"address(es) — first at round {t}, device {d}",
                round=t, device=d))

    _bounds(st.scatter, np.zeros_like(st.scatter, bool), "scatter")
    _bounds(st.lscatter, np.zeros_like(st.lscatter, bool), "lscatter")
    _bounds(st.gather, st.glh, "gather")
    _bounds(st.lgather, st.lglh, "lgather")
    if st.nlev and ((st.comp_level < 0) | (st.comp_level >= st.nlev)).any():
        diags.append(_err(
            "arena/out-of-bounds",
            f"comp_level indexes outside [0, {st.nlev})"))

    # ---- lane metadata cross-check -------------------------------------
    if st.lane_edges:
        for t in range(min(st.nrounds, len(st.lane_edges))):
            meta: Dict[Tuple[int, int], int] = defaultdict(int)
            for (s, d, _kind, _lv, _nb) in st.lane_edges[t]:
                meta[(s, d)] += 1
            got: Dict[Tuple[int, int], int] = defaultdict(int)
            for d in range(P):
                si = int(st.recv_slot[t, d])
                if si < 0 or si >= st.nslots or d not in src_of[si]:
                    continue
                n = sum(1 for j in range(st.W)
                        if int(st.scatter[t, d, j]) != st.trash)
                if n:
                    got[(src_of[si][d], d)] = n
            if meta != got:
                diags.append(_err(
                    "perm/edges-mismatch",
                    f"round {t}: decoded lane counts {dict(got)} "
                    f"disagree with the lane metadata {dict(meta)}",
                    round=t))

        if plan is not None:
            diags += _check_conservation(
                (e for edges in st.lane_edges for e in edges), plan)
    return diags


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_artifact(obj, plan: CommPlan | None = None, *,
                    fanin_max: int = FANIN_MAX) -> List[PlanDiagnostic]:
    """Run the checker pipeline appropriate to one lowered artifact:
    a :class:`~.plan.CommPlan`, :class:`~.plan.ExecPlan`,
    :class:`~.plan.OverlappedExec`, or :class:`~.stream.StreamTables`.
    Passing the originating ``plan`` alongside an executor artifact adds
    the byte-conservation cross-check."""
    if isinstance(obj, CommPlan):
        return check_plan(obj)
    if isinstance(obj, OverlappedExec):
        return check_overlap(obj, plan, fanin_max=fanin_max)
    if isinstance(obj, StreamTables):
        return check_stream(obj, plan)
    if isinstance(obj, ExecPlan):
        return check_exec(obj)
    raise TypeError(
        f"verify_artifact cannot lint {type(obj).__name__} — expected "
        "CommPlan, ExecPlan, OverlappedExec, or StreamTables")


def verify_program(prog, *, fanin_max: int = FANIN_MAX
                   ) -> List[PlanDiagnostic]:
    """Lint everything a compiled ``pselinv_dist.PSelInvProgram``
    carries: the CommPlan IR plus whichever executor lowerings were
    compiled (level-serial tables, overlapped rounds, stream tables) —
    each cross-checked against the plan where applicable."""
    diags: List[PlanDiagnostic] = []
    plan = getattr(prog, "plan", None)
    if plan is not None:
        diags += check_plan(plan)
    ex = getattr(prog, "exec_plan", None)
    if ex is not None:
        diags += check_exec(ex)
    ov = getattr(prog, "overlap_plan", None)
    if ov is not None:
        diags += check_overlap(ov, plan, fanin_max=fanin_max)
    st = getattr(prog, "stream_tables", None)
    if st is not None:
        # conservation already covered through the overlapped rounds the
        # tables were lowered from — lint structure/gates/routing here
        diags += check_stream(st, None)
    return diags


def lint_report(diags: List[PlanDiagnostic]) -> str:
    """Human-readable multi-line report (errors first)."""
    order = sorted(diags, key=lambda d: (d.severity != "error", d.code))
    nerr = sum(1 for d in diags if d.severity == "error")
    nwarn = len(diags) - nerr
    head = f"PlanLint: {nerr} error(s), {nwarn} warning(s)"
    return "\n".join([head] + [f"  {d}" for d in order])


def enforce_verification(diags: List[PlanDiagnostic], mode: str = "error",
                         where: str = "plan") -> List[PlanDiagnostic]:
    """Apply a ``PlanOptions(verify=...)`` mode to a diagnostic list:
    ``"error"`` raises :class:`PlanVerificationError` when any
    ERROR-severity diagnostic is present (warnings still warn),
    ``"warn"`` downgrades everything to one ``warnings.warn`` summary,
    ``"off"`` is a no-op. Returns the diagnostics for chaining."""
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"verify mode {mode!r} not in {VERIFY_MODES}")
    if mode == "off" or not diags:
        return diags
    errors = [d for d in diags if d.severity == "error"]
    if mode == "error" and errors:
        raise PlanVerificationError(
            f"PlanLint rejected {where}:\n{lint_report(diags)}", diags)
    warnings.warn(f"PlanLint flagged {where}:\n{lint_report(diags)}",
                  stacklevel=2)
    return diags
