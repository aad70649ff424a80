"""The port's serving layer on the CPU: a twin of each tier-1 case of
``tests/test_serve.py`` — structure-keyed coalescing, batch windows,
failure isolation, timeouts, admission control, the program disk cache
— on ``device="cpu"``, where each shape class's runner is the eager
sweep; the slow 4×2 acceptance run's twin; and one cross-check against
the JAX package's server on the same request stream (one 8-device x64
subprocess), request for request within 1e-12 in f64."""
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import run_sub

from repro_torch.core import sparse
from repro_torch.core.engine import (Grid, PlanOptions, PSelInvEngine,
                                     SolveValues, bucket_size,
                                     stack_values)
from repro_torch.serve import (BatchWindow, ProgramDiskCache, RequestStatus,
                               SelInvServer, ServeConfig, ServeError,
                               ServeMetrics, ServerOverloaded, SolveRequest,
                               StructureBatcher)

TOL = 1e-12


def _req(skey="s", submitted=None, deadline=None):
    r = SolveRequest(skey=skey, matrix=object(), deadline=deadline)
    if submitted is not None:
        r.submitted = submitted
    return r


def _cfg(**kw):
    kw.setdefault("b", 8)
    kw.setdefault("grid", Grid(1, 1))
    return ServeConfig(device="cpu", **kw)


def _solve(eng, M):
    return eng.solve(M, dtype=torch.float64).numpy()


# ---------------------------------------------------------------------
# units: bucket_size, metrics, batcher flush policy
# ---------------------------------------------------------------------

def test_bucket_size_pow2():
    assert [bucket_size(B) for B in (1, 2, 3, 4, 5, 8, 9, 13, 16, 17)] \
        == [1, 2, 4, 4, 8, 8, 16, 16, 16, 32]
    with pytest.raises(ValueError, match="batch size"):
        bucket_size(0)


def test_metrics_snapshot_shape():
    m = ServeMetrics()
    snap = m.snapshot()
    assert snap["submitted"] == snap["solved"] == 0
    assert snap["latency_p50_us"] is None
    assert snap["batch_occupancy_mean"] is None
    m.inc("submitted", 3)
    m.observe_latency(1e-3)
    m.observe_latency(3e-3)
    m.observe_batch(13, 16)
    m.set_queue_depth(7)
    m.set_queue_depth(2)
    snap = m.snapshot()
    assert snap["submitted"] == 3 and snap["batches"] == 1
    assert 1e3 <= snap["latency_p50_us"] <= 3e3
    assert snap["batch_occupancy_mean"] == pytest.approx(13 / 16)
    assert snap["batch_size_hist"] == {13: 1}
    assert snap["batch_bucket_hist"] == {16: 1}
    assert snap["queue_depth"] == 2 and snap["queue_depth_max"] == 7


def test_batcher_max_batch_flushes_immediately():
    b = StructureBatcher(BatchWindow(max_batch=4, max_wait_ms=1e6))
    now = time.monotonic()
    for _ in range(9):
        b.add(_req("s", submitted=now))
    batches, expired = b.pop_ready(now)
    assert [len(x) for x in batches] == [4, 4] and not expired
    assert b.pending() == 1


def test_batcher_max_wait_flushes_partial():
    b = StructureBatcher(BatchWindow(max_batch=16, max_wait_ms=5.0))
    now = time.monotonic()
    b.add(_req("s", submitted=now))
    b.add(_req("t", submitted=now - 0.010))     # window already expired
    batches, _ = b.pop_ready(now)
    assert [len(x) for x in batches] == [1]
    assert batches[0][0].skey == "t"
    assert b.next_due(now) == pytest.approx(now + 0.005, abs=1e-6)
    batches, _ = b.pop_ready(now + 0.006)
    assert [len(x) for x in batches] == [1]
    assert b.pending() == 0


def test_batcher_pressure_flushes_fullest_queue():
    b = StructureBatcher(BatchWindow(max_batch=16, max_wait_ms=1e6,
                                     pressure=8))
    now = time.monotonic()
    for _ in range(7):
        b.add(_req("big", submitted=now))
    for _ in range(3):
        b.add(_req("small", submitted=now))
    batches, _ = b.pop_ready(now)
    assert [len(x) for x in batches] == [7]
    assert batches[0][0].skey == "big"
    assert b.pending() == 3


def test_batcher_expires_overdue_requests():
    b = StructureBatcher(BatchWindow(max_batch=4, max_wait_ms=1e6))
    now = time.monotonic()
    b.add(_req("s", submitted=now, deadline=now - 1.0))
    b.add(_req("s", submitted=now, deadline=now + 60.0))
    batches, expired = b.pop_ready(now, force=True)
    assert len(expired) == 1 and expired[0].deadline < now
    assert [len(x) for x in batches] == [1]


def test_request_future_semantics():
    r = _req()
    assert not r.done()
    with pytest.raises(TimeoutError, match="still queued"):
        r.result(timeout=0.01)
    r._finish(RequestStatus.SOLVED, result=42)
    assert r.done() and r.result() == 42
    r._finish(RequestStatus.FAILED, error=RuntimeError("late"))
    assert r.status is RequestStatus.SOLVED      # first completion wins


# ---------------------------------------------------------------------
# server end-to-end at Grid(1, 1) on the CPU, f64
# ---------------------------------------------------------------------

@pytest.fixture
def g11_server():
    PSelInvEngine.clear_cache()
    srv = SelInvServer(_cfg(dtype=torch.float64, window=BatchWindow(
        max_batch=4, max_wait_ms=1.0)))
    yield srv
    srv.stop()


def test_server_coalesces_and_matches_unbatched(g11_server):
    """Same-structure requests coalesce into one batch whose per-request
    results (host arrays) match the engine's own unbatched solves; a
    second structure lands in its own batch."""
    srv = g11_server
    A = sparse.laplacian_2d(12, 8)
    B = sparse.laplacian_2d(16, 8)
    I_A = sp.identity(A.shape[0])
    reqs = [srv.submit(A + c * I_A) for c in (0.0, 0.5, 1.0)]
    reqs.append(srv.submit(B))
    assert srv.pump(force=True) == 2             # one batch per structure
    eng = srv.engine_for(A)
    for c, r in zip((0.0, 0.5, 1.0), reqs[:3]):
        assert r.status is RequestStatus.SOLVED
        assert isinstance(r.result(), np.ndarray)
        assert abs(r.result() - _solve(eng, A + c * I_A)).max() <= TOL
    assert reqs[3].status is RequestStatus.SOLVED
    st = srv.stats()
    assert st["solved"] == 4 and st["batches"] == 2
    assert len(st["structures"]) == 2
    assert st["batch_size_hist"] == {1: 1, 3: 1}


def test_server_bucket_padding_shares_programs(g11_server):
    """A batch of 3 rides the B=4 runner: the engine builds one runner
    for the bucket, and a later exact-4 batch builds none."""
    srv = g11_server
    A = sparse.laplacian_2d(12, 8)
    I_A = sp.identity(A.shape[0])
    for c in (0.1, 0.2, 0.3):
        srv.submit(A + c * I_A)
    srv.pump(force=True)
    eng = srv.engine_for(A)
    assert eng.trace_count == 1
    st = srv.stats()
    skey = next(iter(st["structures"]))
    assert st["structures"][skey]["buckets_used"] == [4]
    assert st["structures"][skey]["trace_count"] == 1
    assert st["batch_bucket_hist"] == {4: 1}
    for c in (0.4, 0.5, 0.6, 0.7):               # exact bucket, no pad
        srv.submit(A + c * I_A)
    srv.pump(force=True)
    assert eng.trace_count == 1                  # same runner


def test_server_admission_rejects_beyond_max_queue():
    PSelInvEngine.clear_cache()
    srv = SelInvServer(_cfg(max_queue=2, window=BatchWindow(
        max_batch=16, max_wait_ms=1e6)))
    A = sparse.laplacian_2d(12, 8)
    ok = [srv.submit(A) for _ in range(2)]
    rej = srv.submit(A)
    assert rej.status is RequestStatus.REJECTED
    with pytest.raises(ServerOverloaded, match="queue at capacity"):
        rej.result()
    assert srv.stats()["rejected"] == 1
    srv.pump(force=True)                         # admitted ones solve
    assert all(r.status is RequestStatus.SOLVED for r in ok)


def test_server_timeout_while_queued():
    PSelInvEngine.clear_cache()
    srv = SelInvServer(_cfg(window=BatchWindow(max_batch=16,
                                               max_wait_ms=1e6)))
    A = sparse.laplacian_2d(12, 8)
    r = srv.submit(A, timeout_ms=1.0)
    time.sleep(0.01)
    srv.pump()                   # no force: the deadline, not the
    assert r.status is RequestStatus.TIMED_OUT   # window, fired
    with pytest.raises(TimeoutError, match="missed its deadline"):
        r.result()
    assert srv.stats()["timed_out"] == 1


def test_server_background_worker_thread():
    """The background worker drives windows by itself: submits complete
    without any pump() from the caller."""
    PSelInvEngine.clear_cache()
    cfg = _cfg(dtype=torch.float64,
               window=BatchWindow(max_batch=4, max_wait_ms=1.0))
    A = sparse.laplacian_2d(12, 8)
    I_A = sp.identity(A.shape[0])
    with SelInvServer(cfg) as srv:
        reqs = [srv.submit(A + c * I_A) for c in (0.0, 0.5, 1.0, 2.0)]
        outs = [r.result(timeout=60) for r in reqs]
        assert all(r.status is RequestStatus.SOLVED for r in reqs)
        eng = srv.engine_for(A)
        for c, o in zip((0.0, 0.5, 1.0, 2.0), outs):
            assert abs(o - _solve(eng, A + c * I_A)).max() <= TOL
        assert srv.stats()["batches"] >= 1


def test_progcache_roundtrip(tmp_path, monkeypatch):
    """The on-disk program cache: a miss stores the analyzed program and
    builds the runner; a fresh cache instance on the same directory
    loads the program from disk without analyzing; both runners give
    the engine's own batched result bit for bit — without touching
    trace_count."""
    PSelInvEngine.clear_cache()
    A = sparse.laplacian_2d(12, 8)
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(1, 1),
                                options=PlanOptions(), device="cpu")
    v = eng.prepare_values(A)
    vb = stack_values([v, v])
    ref = eng.solve(vb, dtype=torch.float64)
    t0 = eng.trace_count

    cache = ProgramDiskCache(str(tmp_path))
    run = cache.get(eng, 2, torch.float64)
    assert torch.equal(run(vb.Lh, vb.Dinv), ref)
    assert cache.stats() == {"hits": 0, "misses": 1, "stores": 1,
                             "load_errors": 0, "entries": 1}
    assert cache.get(eng, 2, torch.float64) is run    # memory hit

    import repro_torch.core.engine as engine_mod
    import repro_torch.core.pselinv_dist as dist_mod

    def no_analysis(*a, **kw):
        raise AssertionError("the disk hit analyzed the structure")

    monkeypatch.setattr(engine_mod, "build_program", no_analysis)
    monkeypatch.setattr(dist_mod, "build_program", no_analysis)
    cache2 = ProgramDiskCache(str(tmp_path))          # "restart"
    run2 = cache2.get(eng, 2, torch.float64)
    assert torch.equal(run2(vb.Lh, vb.Dinv), ref)
    assert cache2.stats()["hits"] == 1                # disk hit
    assert cache2.stats()["misses"] == 0
    assert eng.trace_count == t0                      # uncounted
    # a different bucket/dtype is its own entry
    assert cache.cache_key(eng, 2, torch.float64) != \
        cache.cache_key(eng, 4, torch.float64)
    assert cache.cache_key(eng, 2, torch.float64) != \
        cache.cache_key(eng, 2, torch.float32)


def test_server_through_progcache(tmp_path):
    """A server configured with the program cache serves through its
    runners and still matches unbatched solves."""
    PSelInvEngine.clear_cache()
    srv = SelInvServer(_cfg(dtype=torch.float64,
                            window=BatchWindow(max_batch=4,
                                               max_wait_ms=1.0),
                            prog_cache=ProgramDiskCache(str(tmp_path))))
    A = sparse.laplacian_2d(12, 8)
    I_A = sp.identity(A.shape[0])
    reqs = [srv.submit(A + c * I_A) for c in (0.0, 1.0, 2.0)]
    srv.pump(force=True)
    eng = srv.engine_for(A)
    assert eng.trace_count == 0          # the cache's runner, uncounted
    for c, r in zip((0.0, 1.0, 2.0), reqs):
        assert r.status is RequestStatus.SOLVED
        assert abs(r.result() - _solve(eng, A + c * I_A)).max() <= TOL
    st = srv.stats()
    assert st["prog_cache"]["misses"] == 1
    assert st["prog_cache"]["stores"] == 1


# ---------------------------------------------------------------------
# failure isolation on a 2x1 grid (f64)
# ---------------------------------------------------------------------

def test_failure_isolation_bad_request_fails_alone():
    """A request whose sparsity pattern escapes its claimed structure
    (a corrupted matrix swapped onto the queued request) fails ALONE:
    its batch neighbors solve bit for bit as the unbatched solves of
    their own prepared values (and within 1e-12 of ``engine.solve`` of
    their matrices), and the server keeps serving the next window."""
    PSelInvEngine.clear_cache()
    srv = SelInvServer(_cfg(grid=Grid(2, 1), dtype=torch.float64,
                            window=BatchWindow(max_batch=4,
                                               max_wait_ms=1.0)))
    A = sparse.laplacian_2d(12, 8)
    I = sp.identity(A.shape[0])
    good = [srv.submit(A + c * I) for c in (0.5, 1.5)]
    bad = srv.submit(A + 1.0 * I)
    E = sp.lil_matrix(A)
    E[0, 95] = E[95, 0] = 1.0
    bad.matrix = sp.csr_matrix(E)

    srv.pump(force=True)
    assert bad.status is RequestStatus.FAILED, bad.status
    with pytest.raises(ServeError, match="outside the analyzed block"):
        bad.result()
    eng = srv.engine_for(A)
    mats = [A + c * I for c in (0.5, 1.5)]
    vals = eng.prepare_values_many(mats)
    for i, (M, r) in enumerate(zip(mats, good)):
        assert r.status is RequestStatus.SOLVED, r.status
        single = eng.solve(SolveValues(vals.Lh[i], vals.Dinv[i]),
                           dtype=torch.float64)
        assert np.array_equal(r.result(), single.numpy())
        assert abs(r.result() - _solve(eng, M)).max() <= TOL
    nxt = srv.submit(A + 3.0 * I)
    srv.pump(force=True)
    assert nxt.status is RequestStatus.SOLVED, nxt.status
    st = srv.stats()
    assert st["failed"] == 1 and st["solved"] == 3, st


# ---------------------------------------------------------------------
# the full acceptance harness on the 4x2 grid (slow)
# ---------------------------------------------------------------------

@pytest.mark.slow
def test_serve_traffic_acceptance_4x2():
    """The full harness on the 4×2 grid with Poisson arrivals: capture
    conformance and ≤1e-12 identity are asserted inside run_traffic;
    coalescing must win over sequential solves."""
    from repro_torch.serve.traffic import run_traffic
    res = run_traffic(n_requests=100, n_structures=2, rate_hz=4000.0,
                      seed=0, b=8, grid=Grid(4, 2), window=BatchWindow(),
                      dtype=torch.float64, device="cpu",
                      check_identity=True, tol=TOL, reps=3)
    assert res["speedup"] >= 1.5, res["speedup"]


# ---------------------------------------------------------------------
# the JAX package's server on the same stream
# ---------------------------------------------------------------------

def test_server_matches_jax_server_request_for_request(tmp_path):
    """The harness's stream (24 requests over 2 structures, a burst) is
    served by the JAX ``SelInvServer`` on 8 host devices (x64) and by
    the port's on the CPU, on Grid(4, 2) in f64 with the same window:
    the same batches form, and every result agrees within 1e-12."""
    from repro_torch.serve.traffic import (_materialize, make_trace,
                                           mixed_structures)
    path = tmp_path / "jax_served.npz"
    run_sub(f"""
        import numpy as np
        import jax.numpy as jnp
        from repro.core.engine import Grid, PSelInvEngine
        from repro.serve import BatchWindow, SelInvServer, ServeConfig
        from repro.serve.traffic import (_materialize, make_trace,
                                         mixed_structures)
        mats = _materialize(make_trace(24, 2, None, 0),
                            mixed_structures(2, 8))
        PSelInvEngine.clear_cache()
        srv = SelInvServer(ServeConfig(
            b=8, grid=Grid(4, 2), dtype=jnp.float64,
            window=BatchWindow(max_batch=4, max_wait_ms=1e6)))
        reqs = [srv.submit(M) for M in mats]
        srv.drain()
        hist = srv.stats()["batch_size_hist"]
        np.savez({str(path)!r}, hist=np.array(sorted(hist.items())),
                 **{{f"r{{i}}": np.asarray(r.result())
                    for i, r in enumerate(reqs)}})
    """, ndev=8, x64=True)
    ref = np.load(path)
    mats = _materialize(make_trace(24, 2, None, 0), mixed_structures(2, 8))
    PSelInvEngine.clear_cache()
    srv = SelInvServer(_cfg(grid=Grid(4, 2), dtype=torch.float64,
                            window=BatchWindow(max_batch=4,
                                               max_wait_ms=1e6)))
    reqs = [srv.submit(M) for M in mats]
    srv.drain()
    st = srv.stats()
    assert np.array_equal(np.array(sorted(st["batch_size_hist"].items())),
                          ref["hist"])
    for i, r in enumerate(reqs):
        got, want = r.result(), ref[f"r{i}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert abs(got - want).max() <= TOL * max(1.0, abs(want).max()), i
