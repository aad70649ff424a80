"""Deterministic discrete-event simulator for PSelInv communication — a
copy of ``repro/core/simulator.py`` (pure numpy) for the PyTorch port.

The paper's Edison (Cray XC30) wall-clock experiments are reproduced
with a processor-timeline simulation driven by the CommPlan IR of
`core.plan` — the *same* plan object (same trees, same tags, same
per-edge byte counts) that `core.pselinv_dist` compiles into the
executable sweep, so simulated bytes equal executed bytes by
construction (tested in tests/test_plan.py).

Two modes:

* :func:`volumes` — pure structural accounting of per-rank *outgoing*
  bytes per event kind (no timing). Reproduces Table 1 / Figs 4–7.
* :func:`simulate` — α-β timing with per-rank send/recv serialization, a
  node-hierarchical (intra-node vs inter-node) network, optional per-pair
  bandwidth jitter (run-to-run variance of §4.2), and elimination-tree
  pipelining with data-dependency gating. Reproduces Figs 8–9.

The timing model intentionally captures the three phenomena the paper
isolates: (1) flat-tree root serialization (p−1 sequential sends), (2)
binary-tree internal-node pile-up under concurrent collectives, (3) the
shifted tree smoothing that pile-up.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .plan import (CommPlan, ExecPlan, OverlappedExec, PlanOp, build_plan,
                   peak_arena_blocks)
from .schedule import BYTES_PER_ELT, ComputeTask, Grid2D
from .symbolic import BlockStructure
from .trees import HYBRID_FLAT_MAX, TreeKind, cached_tree

__all__ = ["NetworkModel", "SimResult", "volumes", "volumes_from_plan",
           "volume_stats", "simulate", "RoundSchedule",
           "round_schedule_from_exec", "round_schedule_from_overlap",
           "round_schedule_from_stream",
           "round_schedule_of", "simulate_schedule",
           "executed_wire_bytes"]


@dataclass(frozen=True)
class NetworkModel:
    """Edison-like hierarchical network + compute rates. The defaults
    model a Cray XC30, not a GPU: every time this module gives is the
    α-β model's, never a measured one."""
    gemm_gflops: float = 8.0          # per-core effective DGEMM rate
    alpha_intra: float = 1.0e-6      # latency, same node
    alpha_inter: float = 4.0e-6      # latency, across nodes
    bw_intra: float = 5.0e9          # B/s shared-memory copies
    bw_inter: float = 1.0e9          # B/s effective per-rank across nodes
    cores_per_node: int = 24
    jitter_sigma: float = 0.0        # lognormal σ on inter-node bandwidth
    placement_seed: int = 0

    def node_of(self, rank: int) -> int:
        return rank // self.cores_per_node


@dataclass
class SimResult:
    nranks: int
    total_time: float
    send_bytes: Dict[str, np.ndarray]       # kind -> per-rank outgoing bytes
    recv_bytes: Dict[str, np.ndarray]
    compute_time: np.ndarray                 # per-rank busy seconds
    comm_time: np.ndarray                    # per-rank link-busy seconds
    #: peak per-device working-buffer footprint in (b, b) blocks of the
    #: schedule that was timed (``plan.peak_arena_blocks``; 0 when the
    #: simulation was not built from a compiled schedule)
    peak_arena_blocks: int = 0

    def comm_to_comp_ratio(self) -> float:
        c = float(self.compute_time.sum())
        return float(self.comm_time.sum()) / max(c, 1e-30)


# ---------------------------------------------------------------------------
# structural volume accounting (Table 1, Figs 4-7)
# ---------------------------------------------------------------------------

def volumes_from_plan(plan: CommPlan
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Per-rank outgoing/incoming bytes by op kind, read off the IR's
    trees (``exec_only`` bookkeeping transfers are excluded — §4.1
    reports the four algorithmic collectives)."""
    size = plan.grid.size
    out: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(size))
    inc: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(size))
    for op in plan.ops:
        if op.exec_only:
            continue
        for src, kids in op.tree.children:
            nk = len(kids)
            out[op.kind][src] += nk * op.nbytes
            for k in kids:
                inc[op.kind][k] += op.nbytes
    return dict(out), dict(inc)


def volumes(bs: BlockStructure, grid: Grid2D, kind: TreeKind
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Per-rank outgoing/incoming bytes by event kind.

    For broadcasts a rank's outgoing volume counts every tree edge it
    sources; for reductions the mirrored tree makes the same edge count as
    *incoming* at the combining node (paper §4.1 reports received volume
    for Row-Reduce)."""
    return volumes_from_plan(build_plan(bs, grid, kind))


def _msgs_vector(kind: TreeKind, root: int, receivers: Tuple[int, ...],
                 shift: int, n: int) -> np.ndarray:
    """messages-sent-per-rank vector for one tree, ranks in [0, n)."""
    if kind is TreeKind.HYBRID:
        # resolve to the concrete kind ``build_tree`` would pick at this
        # participant count — building a "hybrid" cached_tree here with
        # tag=0 would yield a shift-0 rotation that disagrees with
        # ``plan.tree_for``'s tag-derived one above the threshold
        kind = (TreeKind.FLAT if len(receivers) + 1 <= HYBRID_FLAT_MAX
                else TreeKind.SHIFTED)
    if kind is TreeKind.SHIFTED:
        from .trees import shifted_binary_tree
        tree = shifted_binary_tree(root, receivers, shift=shift)
    else:
        tree = cached_tree(kind.value, root, receivers, 0)
    v = np.zeros(n)
    for src, kids in tree.children:
        v[src] = len(kids)
    return v


def volumes_fast(bs: BlockStructure, grid: Grid2D, kind: TreeKind
                 ) -> Dict[str, np.ndarray]:
    """Vectorized volume accounting for the two collectives the paper
    tracks (§4.1). Exploits that for a fixed supernode K every col-bcast
    shares one participant-row set (and every row-reduce one
    participant-col set); only the mesh column/row, message size, and the
    shifted-tree rotation vary per event.

    Returns {"col-bcast": per-rank *outgoing* bytes,
             "row-reduce": per-rank *incoming* bytes} — matching the
    quantities of paper Table 1 and Fig. 7. Bit-identical to the
    :func:`volumes` slow path (tested)."""
    from .trees import stable_hash

    pr, pc = grid.pr, grid.pc
    w = bs.widths().astype(np.float64)
    out_cb = np.zeros(grid.size)
    inc_rr = np.zeros(grid.size)

    for K in range(bs.nsuper):
        C = bs.struct[K]
        if len(C) == 0:
            continue
        wk = float(w[K])
        krow, kcol = K % pr, K % pc

        # ---- col-bcast: root (krow, I%pc); receivers rows {J%pr} -------
        rows = np.unique(C % pr)
        recv_rows = tuple(int(r) for r in rows if r != krow)
        if recv_rows:
            nrecv = len(recv_rows)
            cols = (C % pc).astype(np.int64)
            nbytes = w[C] * wk * BYTES_PER_ELT
            if kind is TreeKind.SHIFTED or (
                    kind is TreeKind.HYBRID and nrecv + 1 > HYBRID_FLAT_MAX):
                cache = {}
                for i, I in enumerate(C):
                    root_rank = krow * pc + int(cols[i])
                    tag = (K << 20) ^ (int(I) << 1)
                    s = stable_hash(root_rank, tag) % nrecv
                    if s not in cache:
                        cache[s] = _msgs_vector(TreeKind.SHIFTED, krow,
                                                recv_rows, s, pr)
                    m = cache[s]
                    nz = np.nonzero(m)[0]
                    out_cb[nz * pc + cols[i]] += m[nz] * nbytes[i]
            else:
                # HYBRID below threshold resolves inside _msgs_vector —
                # the one place that mirrors build_tree's rule
                m = _msgs_vector(kind, krow, recv_rows, 0, pr)
                nz = np.nonzero(m)[0]
                for r in nz:
                    np.add.at(out_cb, r * pc + cols, m[r] * nbytes)

        # ---- row-reduce: root (J%pr, kcol); participant cols {I%pc} ----
        cols_u = np.unique(C % pc)
        recv_cols = tuple(int(c) for c in cols_u if c != kcol)
        if recv_cols:
            nrecv = len(recv_cols)
            rows_j = (C % pr).astype(np.int64)
            nbytes = w[C] * wk * BYTES_PER_ELT
            if kind is TreeKind.SHIFTED or (
                    kind is TreeKind.HYBRID and nrecv + 1 > HYBRID_FLAT_MAX):
                cache = {}
                for j, J in enumerate(C):
                    root_rank = int(rows_j[j]) * pc + kcol
                    tag = (K << 20) ^ (int(J) << 1) ^ 1
                    s = stable_hash(root_rank, tag) % nrecv
                    if s not in cache:
                        cache[s] = _msgs_vector(TreeKind.SHIFTED, kcol,
                                                recv_cols, s, pc)
                    m = cache[s]
                    nz = np.nonzero(m)[0]
                    inc_rr[rows_j[j] * pc + nz] += m[nz] * nbytes[j]
            else:
                m = _msgs_vector(kind, kcol, recv_cols, 0, pc)
                nz = np.nonzero(m)[0]
                for ccc in nz:
                    np.add.at(inc_rr, rows_j * pc + ccc, m[ccc] * nbytes)

    return {"col-bcast": out_cb, "row-reduce": inc_rr}


def volume_stats(v: np.ndarray) -> Dict[str, float]:
    active = v
    return {
        "min": float(active.min()),
        "max": float(active.max()),
        "median": float(np.median(active)),
        "mean": float(active.mean()),
        "std": float(active.std()),
    }


# ---------------------------------------------------------------------------
# timing simulation (Figs 8-9)
# ---------------------------------------------------------------------------

class _Net:
    def __init__(self, model: NetworkModel, nranks: int):
        self.m = model
        self.nranks = nranks
        self._jit: Dict[Tuple[int, int], float] = {}
        self._rng = np.random.default_rng(model.placement_seed)
        # sample per node-pair jitter lazily but deterministically
        self._pair_seed = int(self._rng.integers(1 << 31))

    def _jitter(self, na: int, nb: int) -> float:
        if self.m.jitter_sigma <= 0:
            return 1.0
        key = (min(na, nb), max(na, nb))
        if key not in self._jit:
            r = np.random.default_rng(
                (self._pair_seed, key[0], key[1]))
            self._jit[key] = float(
                np.exp(r.normal(0.0, self.m.jitter_sigma)))
        return self._jit[key]

    def edge_cost(self, u: int, v: int, nbytes: float) -> float:
        nu, nv = self.m.node_of(u), self.m.node_of(v)
        if nu == nv:
            return self.m.alpha_intra + nbytes / self.m.bw_intra
        bw = self.m.bw_inter * self._jitter(nu, nv)
        return self.m.alpha_inter + nbytes / bw


def simulate(bs: BlockStructure, grid: Grid2D, kind: TreeKind,
             model: NetworkModel | None = None) -> SimResult:
    model = model or NetworkModel()
    net = _Net(model, grid.size)
    P = grid.size
    flop_rate = model.gemm_gflops * 1e9

    busy = np.zeros(P)          # compute availability per rank
    link_out = np.zeros(P)      # send-port availability
    link_in = np.zeros(P)       # recv-port availability
    comp_acc = np.zeros(P)      # accumulated compute seconds
    comm_acc = np.zeros(P)      # accumulated send-port busy seconds

    send_bytes: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    recv_bytes: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))

    def run_bcast(ev: PlanOp, t_root: float) -> Dict[int, float]:
        """Propagate a broadcast; returns arrival time per rank."""
        tree = ev.tree
        arrive = {ev.root: t_root}
        order = [ev.root]
        kmap = tree.children_map()
        i = 0
        while i < len(order):
            u = order[i]; i += 1
            for c in kmap.get(u, ()):
                start = max(arrive[u], link_out[u], link_in[c])
                dt = net.edge_cost(u, c, ev.nbytes)
                link_out[u] = start + dt
                link_in[c] = start + dt
                comm_acc[u] += dt
                arrive[c] = start + dt
                send_bytes[ev.kind][u] += ev.nbytes
                recv_bytes[ev.kind][c] += ev.nbytes
                order.append(c)
        return arrive

    def run_reduce(ev: PlanOp, ready: Dict[int, float]) -> float:
        """Propagate a reduction (leaves -> root); returns root finish."""
        tree = ev.tree
        kmap = tree.children_map()

        def finish(u: int) -> float:
            t = ready.get(u, 0.0)
            for c in kmap.get(u, ()):
                tc = finish(c)
                start = max(tc, link_out[c], link_in[u])
                dt = net.edge_cost(c, u, ev.nbytes)
                link_out[c] = start + dt
                link_in[u] = start + dt
                comm_acc[c] += dt
                send_bytes[ev.kind][c] += ev.nbytes
                recv_bytes[ev.kind][u] += ev.nbytes
                t = max(t, start + dt)
            return t

        return finish(ev.root)

    # -- group the IR's ops/tasks by supernode ----------------------------
    plan = build_plan(bs, grid, kind)
    tasks = plan.tasks
    ev_by_sn: Dict[int, List[PlanOp]] = defaultdict(list)
    tk_by_sn: Dict[int, List[ComputeTask]] = defaultdict(list)
    for e in plan.ops:
        if not e.exec_only:
            ev_by_sn[e.supernode].append(e)
    for t in tasks:
        tk_by_sn[t.supernode].append(t)

    nb = bs.nsuper

    # -- phase 1 (forward): diag-bcast + trsm -----------------------------
    for K in range(nb):
        for ev in ev_by_sn[K]:
            if ev.kind != "diag-bcast":
                continue
            arr = run_bcast(ev, t_root=busy[ev.root])
            for t in tk_by_sn[K]:
                if t.kind != "trsm":
                    continue
                start = max(arr.get(t.rank, 0.0), busy[t.rank])
                dt = t.flops / flop_rate
                busy[t.rank] = start + dt
                comp_acc[t.rank] += dt

    # -- phase 2 (reverse): xfer, col-bcast, gemm, row-reduce, diag -------
    done = np.zeros(nb)
    for K in range(nb - 1, -1, -1):
        C = [int(i) for i in bs.struct[K]]
        t_dep = max((done[i] for i in C), default=0.0)

        evs = ev_by_sn[K]
        # xfer handoffs first (L̂ -> Û owner); data is L-side, no dep gate
        xfer_done: Dict[int, float] = {}
        for ev in evs:
            if ev.kind != "xfer":
                continue
            dst = [r for r in ev.participants if r != ev.root][0]
            start = max(link_out[ev.root], link_in[dst])
            dt = net.edge_cost(ev.root, dst, ev.nbytes)
            link_out[ev.root] = start + dt
            link_in[dst] = start + dt
            comm_acc[ev.root] += dt
            send_bytes[ev.kind][ev.root] += ev.nbytes
            recv_bytes[ev.kind][dst] += ev.nbytes
            xfer_done[ev.consumes if ev.consumes >= 0 else ev.tag] = start + dt

        # col-bcasts: root holds Û(K,I); GEMMs gate on done[I] (A⁻¹ dep)
        gemm_ready: Dict[int, float] = defaultdict(float)
        gemm_last: Dict[int, float] = defaultdict(float)
        for ev in evs:
            if ev.kind != "col-bcast":
                continue
            arr = run_bcast(ev, t_root=link_in[ev.root])
            dep_I = done[ev.consumes] if ev.consumes >= 0 else 0.0
            for r, t_arr in arr.items():
                gemm_ready[r] = max(gemm_ready[r], t_arr, dep_I)
        for t in tk_by_sn[K]:
            if t.kind != "gemm":
                continue
            start = max(gemm_ready[t.rank], busy[t.rank], t_dep)
            dt = t.flops / flop_rate
            busy[t.rank] = start + dt
            comp_acc[t.rank] += dt
            gemm_last[t.rank] = busy[t.rank]

        # row-reduces: leaf contribution ready after that rank's GEMMs
        t_done = t_dep
        for ev in evs:
            if ev.kind != "row-reduce":
                continue
            ready = {r: max(gemm_last[r], busy[r] * 0.0) for r in ev.participants}
            t_done = max(t_done, run_reduce(ev, ready))

        for t in tk_by_sn[K]:
            if t.kind != "diag":
                continue
            start = max(t_done, busy[t.rank])
            dt = t.flops / flop_rate
            busy[t.rank] = start + dt
            comp_acc[t.rank] += dt
            t_done = max(t_done, busy[t.rank])

        done[K] = t_done

    total = float(max(busy.max(), link_out.max(), link_in.max(),
                      done.max() if nb else 0.0))
    return SimResult(
        nranks=P, total_time=total,
        send_bytes=dict(send_bytes), recv_bytes=dict(recv_bytes),
        compute_time=comp_acc, comm_time=comm_acc)


# ---------------------------------------------------------------------------
# executed-schedule timing: account the *compiled* round stream
# ---------------------------------------------------------------------------

@dataclass
class RoundSchedule:
    """A compiled sweep flattened to its executed timeline: alternating
    ``("comm", [(src, dst, kind, nbytes), ...])`` ppermute rounds (every
    transfer of one round ships in the same barriered permute; coalesced
    lanes of a pair appear as several tuples) and ``("comp", flops)``
    round boundaries (per-rank flops fired between two rounds). Built
    from the same :class:`~.plan.ExecPlan` / :class:`~.plan.OverlappedExec`
    the device program runs, so the time :func:`simulate_schedule` reports
    is the time of the schedule that *executes* — the overlapped stream
    is accounted round for round, not approximated per supernode.
    ``peak_arena_blocks`` carries the compiled schedule's per-device
    peak block footprint (``plan.peak_arena_blocks``) so the serial /
    overlapped comparison covers the memory axis, not just time —
    regression guard for the arena slot recycling."""
    nranks: int
    events: List[Tuple[str, object]]
    peak_arena_blocks: int = 0


def _level_task_flops(plan: CommPlan, Ks, kind: str) -> np.ndarray:
    flops = np.zeros(plan.grid.size)
    sel = set(int(k) for k in Ks)
    for t in plan.tasks:
        if t.kind == kind and t.supernode in sel:
            flops[t.rank] += t.flops
    return flops


def round_schedule_from_exec(ex: ExecPlan, plan: CommPlan) -> RoundSchedule:
    """Flatten the level-serial executor: each level's phases in order,
    with the level GEMM at the bcast→reduce boundary and the diagonal
    update after the diag-reduce (the A/B baseline timeline)."""
    events: List[Tuple[str, object]] = []

    def comm(rounds, kind):
        for rnd in rounds:
            events.append(("comm", [(s, d, kind, nb_)
                                    for (s, d, _ss, _ds, nb_) in rnd.edges]))

    for lv in ex.levels:
        comm(lv.xfer_in, "xfer")
        comm(lv.bcast, "col-bcast")
        events.append(("comp", _level_task_flops(plan, lv.Ks, "gemm")))
        comm(lv.reduce, "row-reduce")
        comm(lv.xfer_out, "xfer-out")
        comm(lv.diag_reduce, "diag-reduce")
        events.append(("comp", _level_task_flops(plan, lv.Ks, "diag")))
    return RoundSchedule(nranks=ex.pr * ex.pc, events=events,
                         peak_arena_blocks=peak_arena_blocks(ex))


def _overlap_event_groups(ov: OverlappedExec, plan: CommPlan
                          ) -> List[List[Tuple[str, object]]]:
    """The overlapped timeline grouped per executed round: entry ``t``
    (for ``t < nrounds``) holds boundary ``t``'s compute events followed
    by round ``t``'s coalesced comm event; the final entry holds the
    trailing boundary compute. Flattening the groups in order IS the
    :func:`round_schedule_from_overlap` event list (one definition) —
    the grouping exists so ``obs.rounds`` can join *measured* per-round
    walls against the α-β cost of exactly the same executed round."""
    groups: List[List[Tuple[str, object]]] = []
    for t in range(len(ov.rounds) + 1):
        g: List[Tuple[str, object]] = []
        for op in ov.compute_at[t]:
            if op.kind in ("gemm", "diagw"):
                kind = "gemm" if op.kind == "gemm" else "diag"
                g.append(("comp", _level_task_flops(
                    plan, ov.levels[op.level].Ks, kind)))
        if t < len(ov.rounds):
            rnd = ov.rounds[t]
            if rnd.perm:
                g.append(("comm", [(s, d, kind, nb_)
                                   for (s, d, kind, _lv, nb_)
                                   in rnd.edges]))
        groups.append(g)
    return groups


def round_schedule_from_overlap(ov: OverlappedExec,
                                plan: CommPlan) -> RoundSchedule:
    """Flatten the overlapped executor: the global coalesced round
    sequence with compute ops at the boundaries the dependence scheduler
    pinned them to (GEMM flops at ``gemm`` boundaries, diagonal flops at
    ``diagw``)."""
    events = [e for g in _overlap_event_groups(ov, plan) for e in g]
    return RoundSchedule(nranks=ov.pr * ov.pc, events=events,
                         peak_arena_blocks=peak_arena_blocks(ov))


def _event_seconds(net: "_Net", flop_rate: float, what: str,
                   payload) -> float:
    """Seconds one timeline event costs under the executed BSP
    semantics — the same charging rule :func:`simulate_schedule`
    applies: a compute boundary completes when its busiest rank does, a
    ppermute round when its slowest pair does (coalesced lanes of one
    pair share the latency and serialize their bytes)."""
    if what == "comp":
        dt = payload / flop_rate
        return float(dt.max()) if len(dt) else 0.0
    pair_bytes: Dict[Tuple[int, int], float] = defaultdict(float)
    for (s, d, _kind, nb_) in payload:
        pair_bytes[(s, d)] += nb_
    return max((net.edge_cost(s, d, nb_)
                for (s, d), nb_ in pair_bytes.items()), default=0.0)


def simulated_round_times(prog_or_engine,
                          model: NetworkModel | None = None) -> np.ndarray:
    """Per-round α-β times of the executed overlapped stream, the
    simulated side of the measured-vs-simulated residual join: entry
    ``t < nrounds`` covers boundary ``t``'s compute plus round ``t``'s
    coalesced permute, entry ``nrounds`` the trailing compute — the same
    cut :func:`~.pselinv_dist.make_sweep_segments` applies to the device
    program, so ``measured[t] - simulated[t]`` is a like-for-like
    residual. Sums to ``simulate_schedule(...).total_time`` of the
    overlapped schedule (tested). Accepts a program or engine; stream
    programs are profiled through the overlapped schedule they were
    lowered from (round-for-round identical, see
    :func:`round_schedule_from_stream`)."""
    prog = getattr(prog_or_engine, "program", prog_or_engine)
    ov = getattr(prog, "overlap_plan", None)
    if ov is None:
        raise ValueError("per-round simulation needs an overlapped "
                         "schedule — build with PlanOptions(overlap=True) "
                         "or PlanOptions(stream=True)")
    model = model or NetworkModel()
    net = _Net(model, ov.pr * ov.pc)
    flop_rate = model.gemm_gflops * 1e9
    return np.array([sum(_event_seconds(net, flop_rate, what, payload)
                         for what, payload in g)
                     for g in _overlap_event_groups(ov, prog.plan)])


def round_schedule_from_stream(st, plan: CommPlan) -> RoundSchedule:
    """Flatten the uniform round-stream tables (``core/stream.py``'s
    :class:`~.stream.StreamTables`) to the executed timeline: real comm
    lanes per round (the stream's padded ring-shift lanes ship garbage
    into the trash block and are not algorithmic traffic — the same
    accounting rule the coalesced overlapped rounds already use for
    their padded lanes) and GEMM/diagonal flops at the boundaries the
    phase flags fire them. The stream replays the overlapped
    :class:`~.plan.GlobalRound` list round-for-round, so this equals
    :func:`round_schedule_from_overlap` of the same plan (tested) —
    derived from the stream's own tables/metadata, not from the object
    it was lowered from, so simulated bytes stay pinned to what
    executes."""
    from .stream import COMP_DIAGW, COMP_GEMM

    events: List[Tuple[str, object]] = []
    for t in range(st.steps):
        for j in range(st.comp_kind.shape[1]):
            k = int(st.comp_kind[t, j])
            if k in (COMP_GEMM, COMP_DIAGW):
                Ks = st.level_Ks[int(st.comp_level[t, j])]
                events.append(("comp", _level_task_flops(
                    plan, Ks, "gemm" if k == COMP_GEMM else "diag")))
        if t < st.nrounds and st.lane_edges[t]:
            events.append(("comm", [(s, d, kind, nb_)
                                    for (s, d, kind, _lv, nb_)
                                    in st.lane_edges[t]]))
    return RoundSchedule(nranks=st.pr * st.pc, events=events,
                         peak_arena_blocks=st.peak_blocks)


def executed_wire_bytes(prog_or_engine) -> float:
    """Physical permute traffic of one compiled sweep, in bytes — what
    the executor's ``ppermute`` ops actually ship, padding included
    (unlike the algorithmic lane bytes of :class:`RoundSchedule`, which
    never counted coalescing padding).

    For the uniform round stream this is the *independent* lens of the
    simulated-equals-executed wire invariant: the per-round active slot
    sets are re-derived from ``recv_slot`` (which devices receive on
    which slot), cross-checked against the ``slot_active`` gate table
    the device program branches on (through PlanLint's
    ``verify.check_stream_gates`` — the one shared implementation), and
    only then priced — so a gate table that drifted from the receive
    table fails loudly instead of producing an agreeing-but-wrong byte
    count. Must equal ``stream.stream_wire_bytes`` of the same tables
    (tested, and asserted against the unrolled overlapped executor's
    wire in the bench). For an unrolled overlapped program it prices
    each round's single static permute (``len(perm) × width``
    blocks)."""
    prog = getattr(prog_or_engine, "program", prog_or_engine)
    b = prog.b
    st = getattr(prog, "stream_tables", None)
    if st is not None:
        from .verify import check_stream_gates
        bad = check_stream_gates(st)
        if bad:
            raise ValueError(
                "stream gate tables drifted from the receive tables:\n"
                + "\n".join(f"  {d}" for d in bad))
        blocks = 0
        for t in range(st.steps):
            gated = {si for si in range(st.nslots)
                     if st.slot_active[t, si]}
            blocks += sum(len(st.slot_perm[si]) * st.slot_width[si]
                          for si in gated)
        return float(blocks) * b * b * BYTES_PER_ELT
    ov = getattr(prog, "overlap_plan", None)
    if ov is not None:
        blocks = sum(len(rnd.perm) * rnd.width for rnd in ov.rounds)
        return float(blocks) * b * b * BYTES_PER_ELT
    raise ValueError(
        "executed wire accounting covers the overlapped and stream "
        "lowerings — compile with PlanOptions(overlap=True) or "
        "PlanOptions(stream=True)")


def round_schedule_of(prog_or_engine) -> RoundSchedule:
    """Flatten a compiled program to its executed timeline, deriving
    everything from the object itself: accepts a
    ``pselinv_dist.PSelInvProgram`` (or anything carrying one under
    ``.program``, e.g. a :class:`~.engine.PSelInvEngine`) and builds the
    :class:`RoundSchedule` from whichever lowering it compiled — no more
    hand-passing the (exec, plan) pair the program already owns."""
    prog = getattr(prog_or_engine, "program", prog_or_engine)
    if getattr(prog, "stream_tables", None) is not None:
        return round_schedule_from_stream(prog.stream_tables, prog.plan)
    if getattr(prog, "overlap_plan", None) is not None:
        return round_schedule_from_overlap(prog.overlap_plan, prog.plan)
    if getattr(prog, "exec_plan", None) is not None:
        return round_schedule_from_exec(prog.exec_plan, prog.plan)
    raise ValueError(
        "program has no compiled IR lowering (exec_plan/overlap_plan) — "
        "build it through build_program()/PSelInvEngine.analyze(), not "
        "the legacy unrolled path")


def simulate_schedule(sched,
                      model: NetworkModel | None = None) -> SimResult:
    """α-β timing of a compiled round stream under the executed BSP
    semantics: a ppermute round completes when its slowest pair does
    (coalesced lanes of one pair share the latency and serialize their
    bytes), a compute boundary when its busiest rank does. Comparing the
    level-serial and the overlapped :class:`RoundSchedule` of one plan
    quantifies the cross-level overlap win under the same network; the
    result also carries the schedule's ``peak_arena_blocks`` so the
    comparison covers per-device memory alongside time.

    ``sched`` may be a ready :class:`RoundSchedule`, or a compiled
    program / engine — anything :func:`round_schedule_of` accepts — in
    which case the timeline is derived here."""
    if not isinstance(sched, RoundSchedule):
        sched = round_schedule_of(sched)
    model = model or NetworkModel()
    P = sched.nranks
    net = _Net(model, P)
    flop_rate = model.gemm_gflops * 1e9

    T = 0.0
    comp_acc = np.zeros(P)
    comm_acc = np.zeros(P)
    send_bytes: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))
    recv_bytes: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(P))

    for what, payload in sched.events:
        if what == "comp":
            dt = payload / flop_rate
            T += float(dt.max()) if len(dt) else 0.0
            comp_acc += dt
            continue
        pair_bytes: Dict[Tuple[int, int], float] = defaultdict(float)
        for (s, d, kind, nb_) in payload:
            pair_bytes[(s, d)] += nb_
            send_bytes[kind][s] += nb_
            recv_bytes[kind][d] += nb_
        round_dt = 0.0
        for (s, d), nb_ in pair_bytes.items():
            dt = net.edge_cost(s, d, nb_)
            comm_acc[s] += dt
            round_dt = max(round_dt, dt)
        T += round_dt
    return SimResult(
        nranks=P, total_time=T,
        send_bytes=dict(send_bytes), recv_bytes=dict(recv_bytes),
        compute_time=comp_acc, comm_time=comm_acc,
        peak_arena_blocks=sched.peak_arena_blocks)
