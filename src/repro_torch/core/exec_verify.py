"""The executed-communication verifier — the port's counterpart of
``repro/core/hlo_verify.py`` (HloLint).

PlanLint (``core/verify.py``) proves the lowered tables sound; this
module checks that what an executor *executes* is exactly what those
tables say: the same (src, dst) pairs round by round, each round once
(each stream slot at its active steps), the same bytes, no stray
collective, no host transfer and no silent narrowing of an f64 value.
The JAX package reads those facts off its compiled program text; the
port reads them off the records of :mod:`.exec_ir` — the permutes the
executors report while a sweep runs (or is captured as a CUDA graph),
the ops one eager sweep dispatches, and the ranks' send logs. Findings
are the same typed :class:`~.verify.PlanDiagnostic` records, under the
same eight codes, letter for letter, so that a JAX diagnostic and a
port diagnostic compare one for one. What each code means here:

* ``hlo/perm-unknown`` — an executed permute whose pair set matches no
  plan round or comm slot (a retargeted or foreign permute), a stream
  slot shipping to a receiver that does not keep its arrival at that
  step, or an uploaded index table that moves other pairs than the host
  list the executors report (:func:`check_tables`);
* ``hlo/perm-missing`` — a plan round, or a landing of a stream comm
  slot, that no executed permute carried (a dropped round);
* ``hlo/loop-trip`` — a round executed more than once, or a stream slot
  executed at a step where ``slot_active`` has it off. This is stricter
  than the JAX check: XLA runs a stream slot's one compiled op under
  trip count ``steps`` and gates it inside the loop, so JAX can only
  compare the trip count; the port's Python loop executes a slot only at
  its active steps, so the step set itself is checked. A captured graph
  whose block-GEMM nodes differ from the plan's GEMM ops is reported
  here too (an execution count that disagrees with the plan);
* ``hlo/bytes-drift`` — an executed permute carrying another lane width
  than the plan packs, or a sweep whose wire blocks differ from
  :func:`expected_wire_blocks` or from
  ``simulator.executed_wire_bytes`` (for the stream: from its landed
  blocks, :func:`port_wire_blocks`); for the ranks, a message size other
  than ``width·b²·itemsize·B``, or a sender's and its receiver's logs that
  disagree;
* ``hlo/stray-collective`` — an all-gather, all-reduce, reduce-scatter
  or all-to-all inside a sweep (``comm.p2p``'s collectives report
  themselves; the op layer sees c10d's);
* ``hlo/host-transfer`` — a value read to the host or a copy between the
  card and the host inside a sweep; ``comm.p2p``'s staging through pinned
  host memory is exempt, and checked instead: the staged bytes must be
  exactly the bytes the rank sent and received;
* ``hlo/precision-loss`` — an f64 value narrowed to a smaller float;
* ``hlo/size-regress`` (WARN) — ``graph_kernels`` or ``dispatched_ops``
  more than :data:`SIZE_REGRESS_RATIO` over a recorded baseline.

The stream's wire differs from the JAX program's. There, each active
slot's gated permute ships every pair of its perm at the slot's width
(``stream.stream_wire_blocks``, which :func:`expected_wire_blocks`
equals), and each receiver keeps only the arrival of the slot
``recv_slot`` names. The port's stream ships only the pairs whose
receiver keeps the arrival: its wire is the landed blocks
(:func:`port_wire_blocks`, ``engine.moved()``), and each executed slot
is held to exactly the pairs that land at its step — a subset of the
slot's perm.

Entry points: :func:`lint_ops` (one record), :func:`lint_program` (the
program's own sweep run once on ``meta`` tensors: shapes and dtypes, no
memory, no arithmetic — an 8×4 grid lints on the CPU in seconds),
:func:`lint_ranked` (the ranks' send logs of a multi-process sweep), and
``PSelInvEngine.lint_compiled`` (the op layer and the permutes of one
eager sweep on the session's device, and the permutes recorded while its
CUDA graph was captured). ``python -m repro_torch.tools.exec_lint`` is
the CLI."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from . import exec_ir
from .exec_ir import ExecutedOp, Record
from .schedule import BYTES_PER_ELT
from .verify import PlanDiagnostic, _err, _warn

__all__ = [
    "HLO_CODES", "SIZE_REGRESS_RATIO", "ExpectedPermute", "LintResult",
    "expected_permutes", "expected_wire_blocks", "port_wire_blocks",
    "stream_landings", "recorded_wire_blocks", "check_collectives",
    "check_tables", "check_hygiene", "load_size_baseline", "check_size",
    "lint_ops", "lint_program", "lint_ranked",
]

#: every diagnostic code this linter can emit, and what it means
HLO_CODES = {
    "hlo/perm-unknown": "compiled collective-permute whose pair set "
                        "matches no plan round or comm slot",
    "hlo/perm-missing": "plan round / comm slot with no compiled "
                        "collective-permute",
    "hlo/loop-trip": "loop-context execution count disagrees with the "
                     "plan trip count",
    "hlo/bytes-drift": "compiled wire bytes drift from the plan tables "
                       "/ executed wire accounting",
    "hlo/stray-collective": "all-gather/all-reduce/reduce-scatter/"
                            "all-to-all on the point-to-point hot path",
    "hlo/host-transfer": "host transfer op on the hot path",
    "hlo/precision-loss": "silent f64 -> f32 convert on the value path",
    "hlo/size-regress": "compiled program size regressed past the "
                        "recorded baseline (WARN)",
}

#: WARN threshold for the program-size regression lint
SIZE_REGRESS_RATIO = 1.5


# ---------------------------------------------------------------------------
# what the plan says the compiled program must contain
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExpectedPermute:
    """One permute the plan demands of the compiled program: its pair
    set, payload width in (b, b) blocks, the loop trip count of its
    lowering context (1 = unrolled), the number of rounds that actually
    activate it (gated stream slots < trip), and a human label."""
    pairs: frozenset
    width: int
    trip: int
    activations: int
    where: str


def expected_permutes(prog) -> List[ExpectedPermute]:
    """The permute dictionary a compiled sweep of ``prog`` must realize,
    derived from whichever executor lowering the program carries (the
    stream's gated slot tables, the overlapped global rounds, or the
    level-serial per-phase rounds)."""
    st = getattr(prog, "stream_tables", None)
    if st is not None:
        out = []
        for si in range(st.nslots):
            perm = st.slot_perm[si]
            if not perm:
                continue
            out.append(ExpectedPermute(
                pairs=frozenset((int(s), int(d)) for s, d in perm),
                width=int(st.slot_width[si]), trip=int(st.steps),
                activations=int(st.slot_active[:, si].sum()),
                where=f"comm slot {si}"))
        return out
    ov = getattr(prog, "overlap_plan", None)
    if ov is not None:
        return [ExpectedPermute(
            pairs=frozenset((int(s), int(d)) for s, d in rnd.perm),
            width=int(rnd.width), trip=1, activations=1,
            where=f"round {t}")
            for t, rnd in enumerate(ov.rounds) if rnd.perm]
    ex = getattr(prog, "exec_plan", None)
    if ex is not None:
        out = []
        for lvl, lv in enumerate(ex.levels):
            for phase in ("xfer_in", "bcast", "reduce", "xfer_out",
                          "diag_reduce"):
                for i, rnd in enumerate(getattr(lv, phase)):
                    if rnd.perm:
                        out.append(ExpectedPermute(
                            pairs=frozenset((int(s), int(d))
                                            for s, d in rnd.perm),
                            width=1, trip=1, activations=1,
                            where=f"level {lvl} {phase}[{i}]"))
        return out
    raise ValueError(
        "expected_permutes needs a program with stream_tables, "
        "overlap_plan or exec_plan")


def expected_wire_blocks(prog) -> int:
    """The plan-table wire yardstick in (b, b) blocks: what every
    compiled sweep of ``prog`` must ship (activations × pairs × width
    summed over the permute dictionary). Equals
    ``stream.stream_wire_blocks`` / ``overlap_wire_blocks`` for those
    lowerings by construction."""
    return sum(e.activations * len(e.pairs) * e.width
               for e in expected_permutes(prog))


def stream_landings(st) -> Dict[tuple, frozenset]:
    """The stream's landings: for each step ``t`` and active slot ``si``
    whose arrivals land (some comm lane of the step scatters outside the
    trash), the pairs of the slot's perm whose receiver keeps that
    slot's arrival (``recv_slot[t, dst] == si``) — what the port's stream
    ships, keyed ``(t, si)``; empty pair sets are left out."""
    lands = (np.asarray(st.scatter) != st.trash).reshape(
        st.steps, -1).any(axis=1)
    out = {}
    for t in np.nonzero(lands)[0]:
        for si in np.nonzero(st.slot_active[t])[0]:
            pairs = frozenset((int(s), int(d)) for s, d in st.slot_perm[si]
                              if st.recv_slot[t, d] == si)
            if pairs:
                out[(int(t), int(si))] = pairs
    return out


def port_wire_blocks(prog) -> int:
    """The wire the port's executor of ``prog`` must ship, in (b, b)
    blocks: :func:`expected_wire_blocks` for the overlapped and the
    level-serial lowerings; for the stream its landed blocks
    (:func:`stream_landings` × slot width), which the JAX yardstick
    exceeds by the arrivals no receiver keeps."""
    st = getattr(prog, "stream_tables", None)
    if st is None:
        return expected_wire_blocks(prog)
    return sum(len(pairs) * int(st.slot_width[si])
               for (_, si), pairs in stream_landings(st).items())


# ---------------------------------------------------------------------------
# conformance + conservation over the executed permutes
# ---------------------------------------------------------------------------

class LintResult(list):
    """The diagnostics of one lint (a list, as the JAX package returns),
    with what the lint saw: ``layers`` (each layer checked, or why it
    is absent), ``wire_blocks`` recorded beside ``expected_blocks``,
    ``ppermute_count``, ``collective_bytes`` (one rank's payload bytes
    over the executed permutes), ``dispatched_ops`` and ``lint_s``."""

    def __init__(self, diags: Iterable[PlanDiagnostic] = (), **info):
        super().__init__(diags)
        self.info: Dict[str, object] = dict(info)

    @property
    def errors(self) -> List[PlanDiagnostic]:
        return [d for d in self if d.severity == "error"]


def _op_width(op: ExecutedOp, b: int, batch: int) -> Optional[int]:
    """Payload width of one executed permute in (b, b) blocks, dividing
    out the block dims and the batch. ``None`` when no dims were
    recorded; -1 when the payload is not a whole number of blocks."""
    if not op.dims:
        return None
    n = math.prod(op.dims)
    denom = batch * b * b
    if n % denom:
        return -1
    return n // denom


def _pool(expected):
    pool: Dict[frozenset, List[ExpectedPermute]] = {}
    for e in expected:
        pool.setdefault(e.pairs, []).append(e)
    return pool


def recorded_wire_blocks(ops: Sequence[ExecutedOp], prog, *,
                         batch: int = 1) -> int:
    """(b, b) blocks the executed permutes shipped: pairs × width summed
    over every execution."""
    total = 0
    for op in ops:
        if op.op == "collective-permute":
            w = _op_width(op, prog.b, batch)
            total += len(op.pairs or ()) * max(w or 0, 0)
    return total


def check_collectives(ops: Sequence[ExecutedOp], prog, *, batch: int = 1,
                      layer: str = "eager") -> List[PlanDiagnostic]:
    """Collective conformance and byte conservation over one record's
    executed permutes. Pair sets match plan entries as in the JAX
    check (an exact (pairs, width) match drains first); an op is first
    offered the plan entry it names (``where``), so a round executed
    again is a repeat of its own entry (``hlo/loop-trip``), not a claim
    on another round's. The stream is checked step by step
    (:func:`_check_stream`)."""
    b = prog.b
    st = getattr(prog, "stream_tables", None)
    if st is not None:
        return _check_stream(ops, st, b, batch, layer)
    diags: List[PlanDiagnostic] = []
    expected = expected_permutes(prog)
    pool = _pool(expected)
    own: Dict[str, ExpectedPermute] = {}        # entries matched by label
    steps: Dict[str, List[Optional[int]]] = {}
    wire = 0
    for op in ops:
        if op.op != "collective-permute":
            continue
        pairs = frozenset(op.pairs or ())
        w = _op_width(op, b, batch)
        exp = own.get(op.where)
        if exp is None or exp.pairs != pairs:
            cands = pool.get(pairs)
            if not cands:
                diags.append(_err(
                    "hlo/perm-unknown",
                    f"{layer} collective-permute ({op.executor} "
                    f"{op.where}) with pairs {sorted(pairs)} matches no "
                    "plan round or comm slot — a retargeted or foreign "
                    "permute", round=-1, slot=-1))
                continue
            mine = [e for e in cands if e.where == op.where]
            exact = [e for e in cands if e.width == w]
            exp = (mine or exact or cands)[0]
            cands.remove(exp)
            if not cands:
                del pool[pairs]
            if exp.where == op.where:
                own[exp.where] = exp
        if w is not None and w != exp.width:
            diags.append(_err(
                "hlo/bytes-drift",
                f"{layer} collective-permute for {exp.where} carries {w} "
                f"block lane(s) ({'non-integral payload' if w < 0 else 'payload'}"
                f" dims {op.dims}) but the plan packs width {exp.width}"))
        steps.setdefault(exp.where, []).append(op.step)
        wire += len(pairs) * (w if w is not None and w > 0 else exp.width)
    for cands in pool.values():
        for e in cands:
            diags.append(_err(
                "hlo/perm-missing",
                f"plan {e.where} (pairs {sorted(e.pairs)}, width "
                f"{e.width}) has no executed collective-permute in the "
                f"{layer} layer — a dropped round/slot"))
    for where, ran in steps.items():
        if len(ran) > 1:
            diags.append(_err(
                "hlo/loop-trip",
                f"{layer} {where} executes x{len(ran)} but the plan "
                "runs it once (trip count 1)"))

    if _census_ok(diags):
        want = expected_wire_blocks(prog)
        if wire != want:
            diags.append(_err(
                "hlo/bytes-drift",
                f"{layer} wire volume is {wire} blocks "
                f"({wire * b * b * BYTES_PER_ELT:.0f} B) but the plan "
                f"tables ship {want} blocks"))
        else:
            ex_bytes = _executed_wire_bytes(prog)
            if ex_bytes is not None and not np.isclose(
                    wire * b * b * BYTES_PER_ELT, ex_bytes):
                diags.append(_err(
                    "hlo/bytes-drift",
                    f"{layer} wire volume "
                    f"{wire * b * b * BYTES_PER_ELT:.0f} B != "
                    f"executed_wire_bytes {ex_bytes:.0f} B"))
    return diags


def _census_ok(diags) -> bool:
    """Conservation is only meaningful when the permute census is
    complete."""
    return not any(d.code in ("hlo/perm-unknown", "hlo/perm-missing",
                              "hlo/loop-trip") for d in diags)


def _check_stream(ops, st, b, batch, layer) -> List[PlanDiagnostic]:
    """The stream's executed slots, step by step: an op must name a slot
    whose perm holds its pairs (else ``hlo/perm-unknown``), run at a step
    where ``slot_active`` has the slot on and only once there (else
    ``hlo/loop-trip``), ship exactly the pairs that land at that step
    (:func:`stream_landings`: a pair more is ``hlo/perm-unknown``, one
    fewer ``hlo/perm-missing``) at the slot's width (else
    ``hlo/bytes-drift``); a landing no op carried is
    ``hlo/perm-missing``, and the wire must be :func:`port_wire_blocks`.
    Stricter than the JAX check, which can only compare a slot's loop
    trip count."""
    diags: List[PlanDiagnostic] = []
    perms = {si: frozenset((int(s), int(d)) for s, d in st.slot_perm[si])
             for si in range(st.nslots)}
    want = stream_landings(st)
    seen = set()
    wire = 0
    for op in ops:
        if op.op != "collective-permute":
            continue
        pairs = frozenset(op.pairs or ())
        named = op.where.rsplit(" ", 1)[-1]
        cands = ([int(named)] if op.where.startswith("comm slot ")
                 and named.isdigit() else list(perms))
        si = next((c for c in cands if pairs <= perms.get(c, frozenset())),
                  None)
        if si is None:
            diags.append(_err(
                "hlo/perm-unknown",
                f"{layer} collective-permute (stream {op.where}, step "
                f"{op.step}) with pairs {sorted(pairs)} matches no comm "
                "slot's perm — a retargeted or foreign permute",
                round=-1 if op.step is None else op.step, slot=-1))
            continue
        t = op.step
        if t is None or not 0 <= t < st.steps or not st.slot_active[t, si] \
                or (t, si) in seen:
            diags.append(_err(
                "hlo/loop-trip",
                f"{layer} comm slot {si} executes at step {t}, where the "
                "plan does not activate it (or a second time)",
                round=-1 if t is None else t, slot=si))
            continue
        seen.add((t, si))
        land = want.get((t, si), frozenset())
        if pairs - land:
            diags.append(_err(
                "hlo/perm-unknown",
                f"{layer} comm slot {si} at step {t} ships to "
                f"{sorted(pairs - land)}, whose receiver does not keep "
                "this slot's arrival", round=t, slot=si))
        if land - pairs:
            diags.append(_err(
                "hlo/perm-missing",
                f"{layer} comm slot {si} at step {t} leaves out the "
                f"landing pairs {sorted(land - pairs)}", round=t, slot=si))
        w = _op_width(op, b, batch)
        width = int(st.slot_width[si])
        if w is not None and w != width:
            diags.append(_err(
                "hlo/bytes-drift",
                f"{layer} comm slot {si} at step {t} carries {w} block "
                f"lane(s) (dims {op.dims}) but the plan packs width "
                f"{width}", round=t, slot=si))
        wire += len(pairs) * (w if w is not None and w > 0 else width)
    for t, si in sorted(set(want) - seen):
        diags.append(_err(
            "hlo/perm-missing",
            f"{layer} comm slot {si} never executes at step {t}, where "
            f"{len(want[(t, si)])} pair(s) land — a dropped round/slot",
            round=t, slot=si))
    if _census_ok(diags):
        need = sum(len(p) * int(st.slot_width[si])
                   for (_, si), p in want.items())
        if wire != need:
            diags.append(_err(
                "hlo/bytes-drift",
                f"{layer} stream wire volume is {wire} blocks but its "
                f"landings hold {need}"))
    return diags


def _executed_wire_bytes(prog) -> Optional[float]:
    """``simulator.executed_wire_bytes`` of an overlapped lowering (the
    level-serial executor has no global round stream to price; the
    stream is held to its landings)."""
    if getattr(prog, "overlap_plan", None) is None:
        return None
    from .simulator import executed_wire_bytes
    return executed_wire_bytes(prog)


def _table_pairs(tables):
    """``(where, host pairs, pairs read off the uploaded index tables)``
    for every comm round of ``tables``, overlapped, level-serial or
    stream: the host lists the executors report, beside what the
    kernels execute with. Reads the tables back to the host, so it runs
    outside any capture and never on ``meta``."""
    from .pselinv_dist import ExecTables, StreamSweepTables
    if isinstance(tables, ExecTables):
        for lv in tables.levels:
            for ph in (lv.xfer_in, lv.bcast, lv.reduce, lv.xfer_out,
                       lv.diag_reduce):
                g_all, s_all = ph.table.tolist() if ph.pairs else ([], [])
                at = 0
                for i, (g, _) in enumerate(ph.pairs):
                    n = g.shape[0]
                    if ph.perm[i]:
                        yield (f"{ph.name}[{i}]", ph.perm[i], [
                            (a // ph.src_len, c // ph.dst_len) for a, c in
                            zip(g_all[at:at + n], s_all[at:at + n])])
                    at += n
        return
    stream = isinstance(tables, StreamSweepTables)
    for t, ln in enumerate(tables.comm):
        if ln is None:
            continue
        if stream:
            for cs in ln.slots:
                yield (f"comm slot {cs.si} at step {t}", cs.pairs,
                       list(zip(cs.src.tolist(), cs.dst.tolist())))
        elif ln.perm:
            yield (ln.where, ln.perm,
                   list(zip(ln.src.tolist(), ln.dst.tolist())))


def check_tables(tables, *, layer: str = "tables"
                 ) -> List[PlanDiagnostic]:
    """Hold the uploaded index tables to the host lists kept beside them
    at upload: the recorder reports the host lists (it may run inside a
    capture, where nothing is read back), the kernels execute the
    tables, so a table that moves another pair than its host list says
    is ``hlo/perm-unknown``. One read-back a round or phase; run it on an
    eager sweep's tables, outside any capture."""
    diags: List[PlanDiagnostic] = []
    for where, host, dev in _table_pairs(tables):
        host, dev = set(map(tuple, host)), set(dev)
        if host != dev:
            diags.append(_err(
                "hlo/perm-unknown",
                f"{layer}: the uploaded index table of {where} moves "
                f"{sorted(dev - host)[:4]} where the host list the "
                f"recorder reports has {sorted(host - dev)[:4]}"))
    return diags


# ---------------------------------------------------------------------------
# hygiene + size regression
# ---------------------------------------------------------------------------

def check_hygiene(rec: Record, *, layer: str = "eager",
                  staged_bytes: Optional[int] = None
                  ) -> List[PlanDiagnostic]:
    """Stray collectives (reported by ``comm.p2p`` or seen by the op
    layer), host transfers and f64 narrowing in one record. Transfers of
    ``comm.p2p``'s staging are exempt; with ``staged_bytes`` (the rank's
    ``p2p.LOG.staged_bytes``) their bytes must add up to it."""
    diags: List[PlanDiagnostic] = []
    for op in rec.ops:
        if op.op != "collective-permute":
            diags.append(_err(
                "hlo/stray-collective",
                f"{layer} {op.op} of {op.dims} {op.dtype} on the hot "
                "path — every collective of this schedule runs as "
                "point-to-point permute rounds"))
    staged = 0
    for note in rec.notes:
        if note.kind == "staged":
            staged += note.nbytes
        elif note.kind == "stray-collective":
            diags.append(_err(
                "hlo/stray-collective",
                f"{layer} {note.op} ({note.detail}) on the hot path"))
        elif note.kind == "host-transfer":
            diags.append(_err(
                "hlo/host-transfer",
                f"{layer} host transfer {note.op}: {note.detail}"))
        elif note.kind == "precision-loss":
            diags.append(_err(
                "hlo/precision-loss",
                f"{layer} silent {note.detail} ({note.op}) on the value "
                "path"))
    if staged_bytes is not None and staged != staged_bytes:
        diags.append(_err(
            "hlo/host-transfer",
            f"{layer} staging copies moved {staged} B but the send log "
            f"counts {staged_bytes} B staged"))
    return diags


def load_size_baseline(path: str = "BENCH_pselinv_torch.json"
                       ) -> Optional[Dict[str, float]]:
    """The recorded size baseline of the nb=16 4×2 f32 single-matrix
    class — ``{"graph_kernels": …, "dispatched_ops": …}`` of its stream
    sweep, from the rows ``selinv/sweep_stream_graph_kernels`` and
    ``…_dispatched_ops`` of the newest entry of the port's bench history
    (``repro_torch.tools.record_bench``) taken on the card. None when the
    file is missing or corrupt or holds no such entry: a CPU entry
    captures no graph, and its op counts are those of the plain
    versions."""
    import json
    import os
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            hist = json.load(f)
        for entry in reversed(hist):
            if entry.get("device") != "cuda":
                continue
            rows = {r.get("name"): r.get("us_per_call")
                    for r in entry.get("benches", [])}
            got = {k: rows.get(f"selinv/sweep_stream_{k}")
                   for k in ("graph_kernels", "dispatched_ops")}
            if all(isinstance(v, (int, float)) and v > 0
                   for v in got.values()):
                return {k: float(v) for k, v in got.items()}
    except (ValueError, KeyError, TypeError, AttributeError, OSError):
        return None                             # corrupt history
    return None


def check_size(metrics: Dict[str, float],
               baseline: Optional[Dict[str, float]], *,
               ratio: float = SIZE_REGRESS_RATIO
               ) -> List[PlanDiagnostic]:
    """WARN when a captured graph's ``graph_kernels`` or a sweep's
    ``dispatched_ops`` regressed more than ``ratio`` × over a recorded
    baseline (:func:`load_size_baseline`). Does nothing without one."""
    if not baseline:
        return []
    diags: List[PlanDiagnostic] = []
    for key in ("graph_kernels", "dispatched_ops"):
        have, want = metrics.get(key), baseline.get(key)
        if have and want and have > ratio * want:
            diags.append(_warn(
                "hlo/size-regress",
                f"{key} = {have:.0f} is {have / want:.2f}x the recorded "
                f"baseline ({want:.0f}) — program size regression"))
    return diags


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_ops(ops, prog, *, batch: int = 1, layer: str = "eager",
             staged_bytes: Optional[int] = None) -> LintResult:
    """The full check of one record (a :class:`~.exec_ir.Record`, or a
    list of :class:`~.exec_ir.ExecutedOp`): conformance, conservation and
    hygiene. ``info`` holds the recorded ``wire_blocks`` beside the
    blocks the port's executor must ship (``expected_blocks``,
    :func:`port_wire_blocks`) and the JAX yardstick
    (``plan_wire_blocks``, :func:`expected_wire_blocks`)."""
    rec = ops if isinstance(ops, Record) else Record(ops=list(ops))
    perms = rec.permutes()
    diags = (check_collectives(rec.ops, prog, batch=batch, layer=layer)
             + check_hygiene(rec, layer=layer, staged_bytes=staged_bytes))
    return LintResult(
        diags, layers={layer: len(perms)},
        wire_blocks=recorded_wire_blocks(perms, prog, batch=batch),
        expected_blocks=port_wire_blocks(prog),
        plan_wire_blocks=expected_wire_blocks(prog),
        ppermute_count=len(perms),
        collective_bytes=sum(op.nbytes for op in perms),
        dispatched_ops=rec.dispatched)


def _sweep_of(prog, device):
    """The program's own executor: its tables uploaded to ``device`` and
    its sweep builder."""
    from .pselinv_dist import (make_sweep, make_sweep_overlapped,
                               make_sweep_stream, upload_exec_tables,
                               upload_stream_tables, upload_tables)
    if getattr(prog, "stream_tables", None) is not None:
        return upload_stream_tables(prog, device), make_sweep_stream
    if getattr(prog, "overlap_plan", None) is not None:
        return upload_tables(prog, device), make_sweep_overlapped
    return upload_exec_tables(prog, device), make_sweep


def lint_program(prog, *, batched: bool = False,
                 dtype: torch.dtype = torch.float32,
                 batch_size: int = 1,
                 baseline: Optional[Dict[str, float]] = None) -> LintResult:
    """Lint a program end to end without a card: its own sweep (per
    whichever executor lowering it carries) runs once over tables and
    values on the ``meta`` device — every op checks its shapes and
    dtypes and computes nothing — under the recorder and the op layer.
    The twin of the JAX lint on an abstract mesh. With a ``baseline``
    (:func:`load_size_baseline`) the sweep's dispatched ops are held to
    it (:func:`check_size`)."""
    dev = torch.device("meta")
    tabs, mk = _sweep_of(prog, dev)
    shape = ((int(batch_size),) if batched else ()) + (
        prog.pr * prog.pc, prog.nbr, prog.nbc, prog.b, prog.b)
    Lh = torch.empty(shape, dtype=dtype, device=dev)
    Dinv = torch.empty(shape, dtype=dtype, device=dev)
    sweep = mk(prog, tabs, batched=batched)
    with exec_ir.record() as rec, exec_ir.ops_layer(rec):
        sweep(Lh, Dinv)
    res = lint_ops(rec, prog, batch=int(batch_size) if batched else 1,
                   layer="meta")
    if baseline:
        res = LintResult(list(res) + check_size(
            {"dispatched_ops": rec.dispatched}, baseline), **res.info)
    return res


def lint_ranked(logs: Sequence, prog, *, batch: int = 1,
                itemsize: int = 8) -> LintResult:
    """Check a multi-process sweep's send logs, one a rank (gathered
    after the sweep, each ``comm.p2p.LOG.snapshot()``: a dict with
    ``rank``, ``entries``, ``rounds`` and ``staged_bytes``): per round,
    the union of the ranks' pairs must be the plan's perm and every
    message ``width·b²·itemsize·batch`` bytes (:func:`check_collectives`
    over :func:`~.exec_ir.from_send_log`); every rank counts the plan's
    rounds; each message is logged alike by its sender and its receiver;
    and, when the payloads were staged through pinned host memory (some
    rank staged bytes: a sweep on the card), each rank staged exactly
    the bytes it sent and received — twice the sent bytes over the ranks
    — else none."""
    expected = expected_permutes(prog)
    parts = [(lg["rank"], lg["entries"], lg["staged_bytes"], lg["rounds"])
             for lg in logs]
    sends, recvs = set(), set()
    entries = []
    for rank, ents, _, _ in parts:
        for r, s, d, n in ents:
            (sends if s == rank else recvs).add((r, s, d, n))
            entries.append((r, s, d, n))
    ops = exec_ir.from_send_log(entries, [e.where for e in expected],
                                itemsize=itemsize)
    diags = check_collectives(ops, prog, batch=batch, layer="ranked")
    if sends != recvs:
        diags.append(_err(
            "hlo/bytes-drift",
            f"ranked: {len(sends - recvs)} message(s) logged by a sender "
            f"and not by its receiver, {len(recvs - sends)} the other way "
            f"(e.g. {sorted(sends ^ recvs)[:4]})"))
    counts = {rounds for _, _, _, rounds in parts}
    if counts != {len(expected)}:
        diags.append(_err(
            "hlo/loop-trip",
            f"ranked: the ranks counted {sorted(counts)} permute rounds; "
            f"the plan has {len(expected)}"))
    staged = any(st_ for _, _, st_, _ in parts)
    sent_total = 0
    for rank, ents, st_, _ in parts:
        moved = sum(n for _, s, d, n in ents if rank in (s, d))
        sent_total += sum(n for _, s, _, n in ents if s == rank)
        if st_ != (moved if staged else 0):
            diags.append(_err(
                "hlo/host-transfer",
                f"ranked: rank {rank} staged {st_} B through host memory; "
                f"it sent and received {moved} B and its payloads "
                f"{'were' if staged else 'were not'} staged"))
    return LintResult(
        diags, layers={"ranked": len(ops)},
        wire_blocks=recorded_wire_blocks(ops, prog, batch=batch),
        expected_blocks=expected_wire_blocks(prog),
        ppermute_count=len(ops), sent_bytes=sent_total,
        staged_bytes=sum(st_ for _, _, st_, _ in parts))
