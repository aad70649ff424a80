"""The executed-communication verifier (``repro_torch.core.exec_ir`` /
``exec_verify``, the role of the JAX package's HloLint) on the CPU.

On a Laplacian, a bushy FEM-like and a DG-like structure at b=8, grids
4×2 and 8×4, every executor lowering (level-serial, overlapped, stream
with ``axis_factored`` on and off):

* the plan's permute dictionary and wire yardstick equal the JAX
  package's (``hlo_verify.expected_permutes`` / ``expected_wire_blocks``
  of its own program);
* the program's own sweep on ``meta`` tensors lints clean, single and
  batched (B=3);
* one mutation per diagnostic code, injected by monkeypatching a port
  helper, fires that code, and ``enforce_verification(mode="error")``
  raises on it;
* the recorded permutes, handed to the JAX package's own
  ``check_collectives`` as ``hlo_ir.CollectiveOp`` records, give the
  port's code set — clean and under the three pair/width mutations;
* the wire triangle: recorded blocks = ``expected_wire_blocks`` =
  ``executed_wire_bytes / (b²·8)`` = ``engine.moved()`` where those
  coincide; the stream ships only the pairs that land, so its recorded
  wire is ``engine.moved()``, below the JAX yardstick;
* an uploaded index table that disagrees with the host list the
  recorder reports is caught;
* ``build_program(verify_compiled=…)``, ``analyze``, ``lint_compiled``,
  ``compile_stats`` and the two CLIs are wired."""
import copy
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

from repro.core import hlo_ir as jhlo_ir
from repro.core import hlo_verify as jhlo
from repro.core import pselinv_dist as jdist
from repro.core.plan import PlanOptions as JOptions
from repro_torch.comm import p2p
from repro_torch.core import exec_ir, exec_verify, sparse
from repro_torch.core import pselinv_dist as pd
from repro_torch.core.engine import Grid, PSelInvEngine
from repro_torch.core.plan import PlanOptions
from repro_torch.core.simulator import executed_wire_bytes
from repro_torch.core.verify import (PlanVerificationError,
                                     enforce_verification)
from repro_torch.tools import exec_lint, plan_lint

LOWERINGS = {
    "exec": dict(overlap=False),
    "overlap": dict(),
    "stream": dict(stream=True),
    "stream_flat": dict(stream=True, axis_factored=False),
}
GRIDS = {"4x2": (4, 2), "8x4": (8, 4)}
CASES = [(m, g, lo) for m in ("lap", "fem", "dg") for g in GRIDS
         for lo in LOWERINGS]


def _matrix(name):
    if name == "lap":
        return sparse.laplacian_2d(16, 8)
    if name == "fem":
        return sparse.make_numeric(sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                                   symmetric_values=True)
    return sparse.make_numeric(sparse.dg_like_matrix(6, 6, 4)[0],
                               symmetric_values=True)


_PROGS = {}


def _progs(m, g, lo):
    """The port's and the JAX package's program of one case."""
    key = (m, g, lo)
    if key not in _PROGS:
        A = sp.csr_matrix(_matrix(m))
        grid = GRIDS[g]
        bs, nb = pd.analyze_structure(A, 8, *grid)
        jbs, jnb = jdist.analyze_structure(A, 8, *grid)
        _PROGS[key] = (
            pd.build_program(bs, nb, 8, *grid,
                             options=PlanOptions(**LOWERINGS[lo])),
            jdist.build_program(jbs, jnb, 8, *grid,
                                options=JOptions(**LOWERINGS[lo])))
    return _PROGS[key]


def _codes(diags):
    return {d.code for d in diags if d.severity == "error"}


@pytest.mark.parametrize("m,g,lo", CASES)
def test_expected_permutes_equal_jax(m, g, lo):
    prog, jprog = _progs(m, g, lo)
    mine = exec_verify.expected_permutes(prog)
    ref = jhlo.expected_permutes(jprog)
    assert [(e.pairs, e.width, e.trip, e.activations, e.where)
            for e in mine] == [(e.pairs, e.width, e.trip, e.activations,
                                e.where) for e in ref]
    assert exec_verify.expected_wire_blocks(prog) == \
        jhlo.expected_wire_blocks(jprog) > 0


@pytest.mark.parametrize("m,g,lo", CASES)
def test_lint_program_clean_on_meta(m, g, lo):
    """The program's own sweep on ``meta`` tensors, single and batched:
    no diagnostic, every planned permute executed, the planned wire, and
    nothing allocated on a real device."""
    prog, _ = _progs(m, g, lo)
    for batched in (False, True):
        res = exec_verify.lint_program(prog, batched=batched, batch_size=3,
                                       dtype=torch.float64)
        assert list(res) == []
        assert res.info["wire_blocks"] == res.info["expected_blocks"] \
            == exec_verify.port_wire_blocks(prog)
        assert res.info["plan_wire_blocks"] == \
            exec_verify.expected_wire_blocks(prog)
        st = prog.stream_tables
        assert res.info["ppermute_count"] == (
            len(exec_verify.stream_landings(st)) if st is not None else
            sum(e.activations for e in exec_verify.expected_permutes(prog)))
        assert res.info["dispatched_ops"] > 0


# ---- mutations, injected by monkeypatching a port helper ----------------

@pytest.fixture
def fresh():
    PSelInvEngine.clear_cache()
    yield
    PSelInvEngine.clear_cache()


@pytest.fixture
def group():
    """A one-rank gloo group in this process, for ``p2p.all_gather``."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _engine(lo="overlap"):
    return PSelInvEngine.analyze(_matrix("lap"), b=8, grid=Grid(4, 2),
                                 options=PlanOptions(**LOWERINGS[lo]),
                                 device="cpu")


def _free_rank(perm, P=8):
    """A rank that receives nothing in ``perm`` and is not its first
    sender."""
    busy = {d for _, d in perm} | {perm[0][0]}
    return next(r for r in range(P) if r not in busy)


def _retarget_lanes(ln):
    bad = copy.copy(ln)
    s0, _ = ln.perm[0]
    bad.perm = [(s0, _free_rank(ln.perm))] + ln.perm[1:]
    bad.src = torch.tensor([s for s, _ in bad.perm], device=ln.src.device)
    bad.dst = torch.tensor([d for _, d in bad.perm], device=ln.dst.device)
    return bad


def _retarget_slot(cs):
    """A stream slot whose first pair ships to a rank that keeps none of
    its arrivals, tables and host pairs alike."""
    bad = copy.copy(cs)
    bad.pairs = [(cs.pairs[0][0], _free_rank(cs.pairs))] + cs.pairs[1:]
    bad.src = torch.tensor([s for s, _ in bad.pairs], device=cs.src.device)
    bad.dst = torch.tensor([d for _, d in bad.pairs], device=cs.dst.device)
    return bad


def _retarget_phase(ph, i):
    """Round ``i`` of a level-serial phase with its first pair's
    receiver moved to a rank that receives nothing, tables and host
    pairs alike."""
    g, s = ph.pairs[i]
    new = _free_rank(ph.perm[i])
    slot = int(s[0]) % ph.dst_len
    s = s.clone()
    s[0] = new * ph.dst_len + slot
    bad = copy.copy(ph)
    bad.pairs = list(ph.pairs)
    bad.pairs[i] = (g, s)
    bad.perm = list(ph.perm)
    bad.perm[i] = [(ph.perm[i][0][0], new)] + ph.perm[i][1:]
    return bad


def _widen_phase(ph, i):
    """Round ``i`` shipping every block twice: two lanes a pair."""
    g, s = ph.pairs[i]
    bad = copy.copy(ph)
    bad.pairs = list(ph.pairs)
    bad.pairs[i] = (torch.cat([g, g]), torch.cat([s, s]))
    return bad


def _target(eng):
    """The plan label the mutations hit: the overlapped session's first
    round with two or more pairs, the level-serial session's first
    bcast round with two or more pairs, or the stream session's first
    (step, slot) that ships two or more pairs."""
    if eng.options.stream:
        return next((t, cs.si) for t, ln in enumerate(eng.tables.comm)
                    if ln is not None for cs in ln.slots
                    if len(cs.pairs) > 1)
    if eng.options.overlap:
        return next(ln.where for ln in eng.tables.comm
                    if ln is not None and len(ln.perm) > 1)
    for lt in eng.tables.levels:
        for i, perm in enumerate(lt.bcast.perm):
            if perm and len(perm) > 1:
                return f"{lt.bcast.name}[{i}]"
    raise AssertionError("no bcast round with two pairs")


def _mutate(monkeypatch, eng, kind):
    """Monkeypatch the executor's permute helper of ``eng`` so that the
    target round suffers ``kind``."""
    where = _target(eng)
    if eng.options.stream:
        real_ship = pd._ship_slot

        def ship(payload, moved, cs, t):
            if (t, cs.si) != where:
                return real_ship(payload, moved, cs, t)
            if kind == "retarget":
                return real_ship(payload, moved, _retarget_slot(cs), t)
            if kind == "drop":
                return None
            if kind == "width":
                bad = copy.copy(cs)
                bad.width = cs.width + (1 if cs.width < payload.shape[2]
                                        else -1)
                assert bad.width > 0
                return real_ship(payload, moved, bad, t)
            raise ValueError(kind)
        monkeypatch.setattr(pd, "_ship_slot", ship)
        return
    if eng.options.overlap:
        real = pd._permute_lanes

        def permute(payload, ln):
            if ln.where != where:
                return real(payload, ln)
            if kind == "retarget":
                return real(payload, _retarget_lanes(ln))
            if kind == "drop":
                return torch.zeros_like(payload)
            if kind == "width":
                wide = torch.cat([payload, payload[:, :, :1]], dim=2)
                return real(wide, ln)[:, :, :ln.width].contiguous()
            if kind == "twice":
                real(payload, ln)
                return real(payload, ln)
            if kind == "stray":
                p2p.all_gather(payload[:, :1].reshape(-1))
            if kind == "precision":
                payload = payload.to(torch.float32).to(payload.dtype)
            if kind == "host":
                payload.sum().item()
            return real(payload, ln)
        monkeypatch.setattr(pd, "_permute_lanes", permute)
        return
    real_move = pd._move

    def move(ph, i, dst, src=None, transpose=False, add=False):
        if f"{ph.name}[{i}]" != where:
            return real_move(ph, i, dst, src, transpose, add)
        if kind == "retarget":
            return real_move(_retarget_phase(ph, i), i, dst, src,
                             transpose, add)
        if kind == "drop":
            return None
        if kind == "width":
            return real_move(_widen_phase(ph, i), i, dst, src, transpose,
                             add)
        raise ValueError(kind)
    monkeypatch.setattr(pd, "_move", move)


MUTATIONS = [  # (mutation, lowering, the code it must fire)
    ("retarget", "overlap", "hlo/perm-unknown"),
    ("retarget", "exec", "hlo/perm-unknown"),
    ("drop", "overlap", "hlo/perm-missing"),
    ("drop", "exec", "hlo/perm-missing"),
    ("stray", "overlap", "hlo/stray-collective"),
    ("precision", "overlap", "hlo/precision-loss"),
    ("width", "overlap", "hlo/bytes-drift"),
    ("width", "exec", "hlo/bytes-drift"),
    ("retarget", "stream", "hlo/perm-unknown"),
    ("drop", "stream", "hlo/perm-missing"),
    ("width", "stream", "hlo/bytes-drift"),
    ("twice", "overlap", "hlo/loop-trip"),
    ("host", "overlap", "hlo/host-transfer"),
]


@pytest.mark.parametrize("kind,lo,code", MUTATIONS)
def test_mutation_fires_its_code(monkeypatch, fresh, group, kind, lo,
                                 code):
    eng = _engine(lo)
    _mutate(monkeypatch, eng, kind)
    res = eng.lint_compiled(dtype=torch.float64)
    assert code in _codes(res)
    if kind == "drop":
        assert _codes(res) == {"hlo/perm-missing"}
    with pytest.raises(PlanVerificationError):
        enforce_verification(res, mode="error")
    with pytest.raises(PlanVerificationError):
        eng.lint_compiled(dtype=torch.float64, verify_compiled="error")


def test_mutation_stream_slot_at_an_inactive_step(monkeypatch, fresh):
    """A stream comm slot also shipped at a step where ``slot_active``
    has it off is ``hlo/loop-trip``; the round-stream's plan labels stay
    matched, so nothing else fires."""
    eng = _engine("stream")
    st = eng.program.stream_tables
    slots = [(t, cs) for t, ln in enumerate(eng.tables.comm)
             if ln is not None for cs in ln.slots]
    t_bad, cs_bad = next((t, cs) for t, _ in slots for _, cs in slots
                         if not st.slot_active[t, cs.si])
    real = pd._ship_slot
    extra = [True]

    def ship(payload, moved, cs, t):
        real(payload, moved, cs, t)
        if t == t_bad and extra:
            extra.pop()
            real(payload, torch.zeros_like(moved), cs_bad, t)
    monkeypatch.setattr(pd, "_ship_slot", ship)
    res = eng.lint_compiled(dtype=torch.float64)
    assert _codes(res) == {"hlo/loop-trip"}
    with pytest.raises(PlanVerificationError):
        enforce_verification(res, mode="error")


@pytest.mark.parametrize("lo", ["overlap", "exec", "stream"])
def test_mutated_device_table_is_caught(fresh, lo):
    """An upload fault that puts a wrong rank into a device index table
    while the host list stays right: the recorded permutes (made from
    the host list) are clean, the table check is not."""
    eng = _engine(lo)
    if lo == "exec":
        ph = next(lt.bcast for lt in eng.tables.levels
                  if any(p and len(p) > 1 for p in lt.bcast.perm))
        i = next(i for i, p in enumerate(ph.perm) if p and len(p) > 1)
        s = ph.pairs[i][1]
        s[0] = _free_rank(ph.perm[i]) * ph.dst_len + int(s[0]) % ph.dst_len
    elif lo == "stream":
        cs = next(cs for ln in eng.tables.comm if ln is not None
                  for cs in ln.slots if len(cs.pairs) > 1)
        cs.dst[0] = _free_rank(cs.pairs)
    else:
        ln = next(ln for ln in eng.tables.comm
                  if ln is not None and len(ln.perm) > 1)
        ln.dst[0] = _free_rank(ln.perm)
    res = eng.lint_compiled(dtype=torch.float64)
    assert _codes(res) == {"hlo/perm-unknown"}
    assert "uploaded index table" in str(res.errors[0])
    assert _codes(exec_verify.check_collectives(
        eng._eager_record(False, 1, torch.float64).ops, eng.program)) \
        == set()


def test_size_regress_warns_past_the_baseline():
    base = {"graph_kernels": 100.0, "dispatched_ops": 1000.0}
    assert exec_verify.check_size({"graph_kernels": 140.0}, base) == []
    assert exec_verify.check_size({"graph_kernels": 151.0}, None) == []
    diags = exec_verify.check_size({"graph_kernels": 151.0,
                                    "dispatched_ops": 2000.0}, base)
    assert [(d.code, d.severity) for d in diags] == \
        [("hlo/size-regress", "warn")] * 2
    assert set(exec_verify.HLO_CODES) == set(jhlo.HLO_CODES)
    assert exec_verify.HLO_CODES == jhlo.HLO_CODES


def test_staging_is_exempt_and_checked():
    """The op layer's staged copies are no host transfer, but their
    bytes must be the send log's staged bytes."""
    rec = exec_ir.Record(notes=[exec_ir.HostNote("staged", "aten.copy_",
                                                 "p2p staging", 512)])
    assert exec_verify.check_hygiene(rec, staged_bytes=512) == []
    assert _codes(exec_verify.check_hygiene(rec, staged_bytes=256)) == \
        {"hlo/host-transfer"}
    x = torch.zeros(4, dtype=torch.float64)
    with exec_ir.record() as rec, exec_ir.ops_layer(rec):
        with exec_ir.staging():
            x.to(torch.float32)
        x.to(torch.float32)
    assert [n.kind for n in rec.notes] == ["precision-loss"] * 2


# ---- agreement with the JAX package's own checker -------------------------

def _jax_ops(ops):
    return [jhlo_ir.CollectiveOp(
        op=op.op, pairs=op.pairs, dims=op.dims, dtype=op.dtype,
        computation="", multiplier=1, line=i)
        for i, op in enumerate(ops)]


@pytest.mark.parametrize("lo", ["overlap", "exec"])
@pytest.mark.parametrize("kind", [None, "retarget", "drop", "width"])
def test_jax_check_collectives_agrees(monkeypatch, fresh, lo, kind):
    eng = _engine(lo)
    if kind is not None:
        _mutate(monkeypatch, eng, kind)
    rec = eng._eager_record(False, 1, torch.float64)
    A = sp.csr_matrix(_matrix("lap"))
    jbs, jnb = jdist.analyze_structure(A, 8, 4, 2)
    jprog = jdist.build_program(jbs, jnb, 8, 4, 2,
                                options=JOptions(**LOWERINGS[lo]))
    mine = _codes(exec_verify.check_collectives(rec.ops, eng.program))
    theirs = _codes(jhlo.check_collectives(_jax_ops(rec.permutes()),
                                           jprog))
    assert mine == theirs
    assert bool(mine) == (kind is not None)


# ---- the wire triangle ----------------------------------------------------

@pytest.mark.parametrize("m", ["lap", "fem", "dg"])
@pytest.mark.parametrize("lo", list(LOWERINGS))
def test_wire_triangle(fresh, m, lo):
    eng = PSelInvEngine.analyze(_matrix(m), b=8, grid=Grid(4, 2),
                                options=PlanOptions(**LOWERINGS[lo]),
                                device="cpu")
    rec = eng._eager_record(False, 1, torch.float64)
    recorded = exec_verify.recorded_wire_blocks(rec.ops, eng.program)
    want = exec_verify.expected_wire_blocks(eng.program)
    assert recorded == exec_verify.port_wire_blocks(eng.program)
    assert sum(len(op.pairs) * op.nbytes for op in rec.permutes()) == \
        recorded * 64 * 8
    moved = eng.moved()[1] / (64 * 8)
    if not lo.startswith("stream"):
        assert recorded == want
    if lo == "exec":                  # one block a real pair
        assert moved == want
        with pytest.raises(ValueError):
            executed_wire_bytes(eng.program)
    else:
        assert executed_wire_bytes(eng.program) / (64 * 8) == want
    if lo == "overlap":
        assert moved == want
    if lo.startswith("stream"):       # JAX's wire ships more than lands
        st = eng.program.stream_tables
        assert moved == recorded < want
        assert eng.stats()["stream_wire_bytes"] == want * 64 * 8
        assert recorded == sum(
            int((st.recv_slot[t][[d for _, d in st.slot_perm[si]]]
                 == si).sum()) * int(st.slot_width[si])
            for t in range(st.steps) for si in np.nonzero(
                st.slot_active[t])[0])


# ---- wiring ---------------------------------------------------------------

def test_build_program_and_analyze_run_the_lint(monkeypatch, fresh):
    A = _matrix("lap")
    bs, nb = pd.analyze_structure(A, 8, 4, 2)
    for mode in ("error", "warn", "off"):
        pd.build_program(bs, nb, 8, 4, 2, options=PlanOptions(
            verify_compiled=mode))
    _mutate(monkeypatch, _engine("overlap"), "retarget")
    PSelInvEngine.clear_cache()
    with pytest.raises(PlanVerificationError, match="executed sweep"):
        pd.build_program(bs, nb, 8, 4, 2,
                         options=PlanOptions(verify_compiled="error"))
    with pytest.warns(UserWarning, match="hlo/perm-unknown"):
        pd.build_program(bs, nb, 8, 4, 2,
                         options=PlanOptions(verify_compiled="warn"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pd.build_program(bs, nb, 8, 4, 2,
                         options=PlanOptions(verify_compiled="off"))
    with pytest.raises(PlanVerificationError):
        PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device="cpu",
                              verify_compiled="error")


@pytest.mark.parametrize("lo", ["overlap", "exec", "stream"])
def test_lint_compiled_and_compile_stats(fresh, lo):
    eng = _engine(lo)
    res = eng.lint_compiled(dtype=torch.float64, verify_compiled="error")
    assert list(res) == []
    assert res is eng.lint_compiled(dtype=torch.float64)
    layers = res.info["layers"]
    assert layers["graph"].startswith("absent")
    assert layers["ops"] > 0 and layers["eager"] == res.info[
        "ppermute_count"]
    batched = eng.lint_compiled(batched=True, batch_size=3)
    assert list(batched) == [] and batched is not res
    cs = eng.compile_stats()
    assert cs["ppermute_count"] == res.info["ppermute_count"] > 0
    assert cs["collective_bytes"] == res.info["collective_bytes"] / 2 > 0
    assert eng.trace_count == 0


def test_clis_exit_zero_clean_and_nonzero_mutated(monkeypatch, fresh,
                                                  capsys):
    assert exec_lint.main([]) == 0
    assert plan_lint.main(["--compiled", "--grid", "8x4", "--nb", "16"]) \
        == 0
    assert "[exec-lint] OK" in capsys.readouterr().out
    _mutate(monkeypatch, _engine("overlap"), "retarget")
    assert exec_lint.main(["--grid", "4x2", "--nb", "16"]) == 1
    assert plan_lint.main(["--compiled", "--grid", "4x2", "--nb", "16"]) \
        == 1
    assert "hlo/perm-unknown" in capsys.readouterr().out
