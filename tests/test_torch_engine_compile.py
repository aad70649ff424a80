"""The port engine's compile surface on the CPU — ``trace_count``,
``jitted``, ``aot_compile``, ``compile_stats``, ``stats(compile=True)``
— the bytes its sweeps move between ranks (``moved_bytes``), and
``profile_rounds``' default dtype. On the CPU every shape class's runner
is the eager sweep; the CUDA-graph cases live in
``tests/test_torch_cuda.py``."""
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import sparse
from repro_torch.core.engine import Grid, PSelInvEngine, stack_values
from repro_torch.core.plan import PlanOptions
from repro_torch.core.simulator import executed_wire_bytes
from repro_torch.obs.rounds import profile_rounds

OPTIONS = {"overlapped": PlanOptions(),
           "level_serial": PlanOptions(overlap=False),
           "stream": PlanOptions(stream=True)}
COMPILE_KEYS = {"warmup_ms", "capture_ms", "graph_kernels",
                "graph_gemm_nodes", "comm_rounds", "moved_bytes",
                "jaxpr_lines", "hlo_bytes", "collective_bytes"}


def _cases():
    fem = sparse.fem3d_like_matrix(4, 4, 4, 2)[0]
    return {
        "lap": sparse.laplacian_2d(16, 8),
        "fem": sparse.make_numeric(fem, symmetric_values=True),
        "dg": sparse.make_numeric(sparse.dg_like_matrix(6, 6, 4)[0],
                                  symmetric_values=True),
    }


def _engine(A, executor="overlapped", **kw):
    return PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                 options=OPTIONS[executor], device="cpu",
                                 **kw)


def test_solve_does_not_rebuild_a_warm_class():
    """The twin of the JAX engine's no-retrace case: the session cache
    returns one engine for one structure, ``trace_count`` is flat after
    the first solve of a class, and a batched class costs one more
    build, then none."""
    A = sparse.laplacian_2d(12, 8)
    PSelInvEngine.clear_cache()
    e1 = _engine(A)
    e2 = _engine(A + sp.identity(A.shape[0]))
    assert e2 is e1 and e2.program is e1.program
    assert PSelInvEngine.cache_hits == 1 and PSelInvEngine.cache_misses == 1
    e3 = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                               options=PlanOptions(window=2), device="cpu")
    assert e3 is not e1 and PSelInvEngine.cache_misses == 2

    v = e1.prepare_values(A)
    out1 = e1.solve(v)
    t0 = e1.trace_count
    assert t0 == 1
    out2 = e1.solve(v)
    assert e1.trace_count == t0, "second solve of one class rebuilt"
    assert out1.shape == out2.shape and torch.equal(out1, out2)

    vb = stack_values([v, v, v])
    e1.solve(vb)
    tb = e1.trace_count
    assert tb == t0 + 1
    e1.solve(vb)
    assert e1.trace_count == tb, "second batched solve rebuilt"
    e1.solve(vb, dtype=torch.float64)                # a new dtype class
    assert e1.trace_count == tb + 1


def test_jitted_runs_the_class_runner():
    """``jitted(batched)`` is one callable over every (B, dtype) class:
    its results are the solve's, and a class it built is the solve's."""
    A = sparse.laplacian_2d(12, 8)
    PSelInvEngine.clear_cache()
    eng = _engine(A)
    v = eng.prepare_values(A, dtype=torch.float64)
    fn = eng.jitted(batched=True)
    vb = stack_values([v, v])
    out = fn(vb.Lh, vb.Dinv)
    assert eng.trace_count == 1
    assert torch.equal(out, eng.solve(vb, dtype=torch.float64))
    assert eng.trace_count == 1
    assert torch.equal(eng.jitted()(v.Lh, v.Dinv), out[0])
    assert eng.trace_count == 2


def test_aot_compile_leaves_trace_count_alone():
    A = sparse.laplacian_2d(12, 8)
    PSelInvEngine.clear_cache()
    eng = _engine(A)
    v = eng.prepare_values(A, dtype=torch.float64)
    vb = stack_values([v, v, v])
    ref = eng.solve(vb, dtype=torch.float64, bucket=True)
    t0 = eng.trace_count
    run = eng.aot_compile(batch_size=4, dtype=torch.float64)
    assert eng.trace_count == t0
    assert torch.equal(run(vb.Lh, vb.Dinv), ref)       # 3 lanes of 4
    single = eng.aot_compile(dtype=torch.float64, batched=False)
    assert torch.equal(single(v.Lh, v.Dinv), ref[0])
    assert eng.trace_count == t0


@pytest.mark.parametrize("executor", list(OPTIONS))
def test_stats_compile_reports_the_capture_surface(executor):
    """``stats(compile=True)`` merges ``compile_stats()`` of the f32
    single-matrix class: on the CPU nothing is captured, so the capture
    figures are None, as are the JAX engine's program-text sizes; the
    moves are counted. A class's metrics are measured once (cached), and
    measuring them builds no counted runner."""
    A = _cases()["fem"]
    PSelInvEngine.clear_cache()
    eng = _engine(A, executor)
    st = eng.stats(compile=True)
    assert COMPILE_KEYS <= set(st)
    for k in ("warmup_ms", "capture_ms", "graph_kernels",
              "graph_gemm_nodes", "jaxpr_lines", "hlo_bytes",
              "collective_bytes"):
        assert st[k] is None, k
    assert st["comm_rounds"] == st["ppermute_rounds"] > 0
    assert st["moved_bytes"] == eng.moved()[1] > 0
    assert st["graph_replays"] == 0 and st["graph_bytes"] == 0
    assert st["gemm_ops_per_solve"] == eng.gemm_ops()
    assert eng.trace_count == 0
    assert eng.compile_stats() is eng.compile_stats()
    cb = eng.compile_stats(batched=True, dtype=torch.float64, batch_size=4)
    assert cb is not eng.compile_stats()
    assert cb is eng.compile_stats(batched=True, dtype=torch.float64,
                                   batch_size=4)
    assert eng.trace_count == 0


@pytest.mark.parametrize("name", ["lap", "fem", "dg"])
def test_moved_bytes_equal_the_executed_wire(name):
    """``moved_bytes`` counts what the port's sweep moves, from its
    upload tables. The overlapped sweep moves every pair of a round at
    the round's lane width: exactly ``executed_wire_bytes``. The
    level-serial sweep moves one block per real pair, which
    ``executed_wire_bytes`` does not price (it raises for that lowering,
    in both packages): its moves equal the bytes of the messages of its
    simulated round schedule. The stream moves, per active slot, only
    the pairs whose receiver keeps the slot: the relation found is that
    it moves exactly the level-serial sweep's blocks — the plan's
    algorithmic message bytes, which its simulated schedule sums — below
    both the overlapped executed wire (padded lanes) and the JAX
    program's ``stream_wire_bytes`` (every pair of an active slot)."""
    A = _cases()[name]
    engs = {ex: _engine(A, ex) for ex in OPTIONS}
    moved = {ex: e.stats()["moved_bytes"] for ex, e in engs.items()}

    def simulated(e):
        return sum(nb for what, msgs in e.round_schedule().events
                   if what == "comm" for (_s, _d, _k, nb) in msgs)

    assert moved["overlapped"] == executed_wire_bytes(engs["overlapped"])
    with pytest.raises(ValueError, match="overlapped and stream"):
        executed_wire_bytes(engs["level_serial"])
    assert moved["level_serial"] == simulated(engs["level_serial"])
    assert moved["stream"] == simulated(engs["stream"]) \
        == moved["level_serial"]
    assert moved["stream"] < executed_wire_bytes(engs["overlapped"])
    assert moved["stream"] < engs["stream"].stats()["stream_wire_bytes"]


def test_profile_rounds_defaults_to_f32():
    """The reference's default: f32 values, f32 A⁻¹ — the f32 solve's
    bits — through the engine method and the module function alike."""
    A = sp.csr_matrix(sparse.laplacian_2d(16, 8))
    PSelInvEngine.clear_cache()
    eng = _engine(A)
    vals = eng.prepare_values(A)
    prof = eng.profile_rounds(vals, reps=1)
    assert prof.ainv.dtype == torch.float32
    assert torch.equal(prof.ainv, eng.solve(vals))     # solve: f32 too
    assert profile_rounds(eng, vals, reps=1).ainv.dtype == torch.float32
    prof64 = eng.profile_rounds(vals, reps=1, dtype=torch.float64)
    assert torch.equal(prof64.ainv, eng.solve(vals, dtype=torch.float64))
