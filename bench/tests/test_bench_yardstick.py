"""The frozen yardstick: the generators and the structure analysis
against the port's at tiny size (here only, never in a run), the
reference against numpy, the operation count against a brute-force
count, the shard reader, the trace reduction and the percentiles."""
import numpy as np
import pytest
import torch

import benchtiny  # noqa: F401  (puts src/ and bench/ on the path)

from pselbench import matrices, reference, stats, structure, trace

TINY = [("fem3d_like", dict(nx=4, ny=4, nz=4, block=3), 24),
        ("fem3d_like", dict(nx=5, ny=4, nz=3, block=3), 12),
        ("dg_like", dict(atoms_x=6, atoms_y=6, block=4), 16)]


def _matrix(gen, params, seed=3):
    return matrices.make_numeric(matrices.GENERATORS[gen](**params)[0],
                                 seed=seed, symmetric_values=True)


@pytest.mark.parametrize("gen,params,b", TINY)
def test_generators_match_the_port(gen, params, b):
    from repro_torch.core import sparse
    port = {"fem3d_like": sparse.fem3d_like_matrix,
            "dg_like": sparse.dg_like_matrix}[gen]
    A, sizes = matrices.GENERATORS[gen](**params)
    P, psizes = port(*params.values())
    assert (A != P).nnz == 0 and np.array_equal(sizes, psizes)
    for sym in (False, True):
        ours = matrices.make_numeric(A, seed=11, symmetric_values=sym)
        theirs = sparse.make_numeric(P, seed=11, symmetric_values=sym)
        assert (ours != theirs).nnz == 0


@pytest.mark.parametrize("gen,params,b", TINY)
def test_structure_matches_the_port(gen, params, b):
    from repro_torch.core.symbolic import symbolic_factorize
    A = _matrix(gen, params)
    ours = structure.block_structure(A, b)
    theirs = symbolic_factorize(A, max_supernode=b)
    assert ours.nsuper == theirs.nsuper
    for a, t in zip(ours.struct, theirs.struct):
        assert np.array_equal(a, t)


def _brute_force_flops(A, st):
    """Run the blocked recurrences on dense blocks and count 2·m·n·k for
    every product: A⁻¹(C, K) = −A⁻¹(C, C)·L̂(C, K), A⁻¹(K, K) = D⁻¹ −
    L̂(C, K)ᵀ·A⁻¹(C, K)."""
    b, nb = st.b, st.nsuper
    ops = 0
    for K in reversed(range(nb)):
        c = len(st.struct[K])
        if c:
            m, n, k = c * b, b, c * b
            ops += 2 * m * n * k          # A⁻¹(C, C) · L̂(C, K)
            ops += 2 * b * b * (c * b)    # L̂(C, K)ᵀ · A⁻¹(C, K)
    return ops


@pytest.mark.parametrize("gen,params,b", TINY)
def test_flop_count_against_brute_force(gen, params, b):
    A = _matrix(gen, params)
    st = structure.block_structure(A, b)
    assert structure.inversion_flops(st) == _brute_force_flops(A, st)
    nsel = len(structure.selected_pairs(st)[0])
    c = sum(len(C) for C in st.struct)
    assert nsel == st.nsuper + 2 * c
    assert structure.inversion_bytes(st) == 8 * b * b * (3 * c + 2 * st.nsuper)


def test_recurrence_counted_is_the_inverse():
    """The recurrences the count prices give A⁻¹'s selected blocks."""
    A = _matrix("fem3d_like", dict(nx=4, ny=4, nz=4, block=3))
    b = 24
    st = structure.block_structure(A, b)
    D = A.toarray()
    nb = st.nsuper
    L = np.linalg.cholesky(D)                      # A = L Lᵀ, SPD
    Lb = L.reshape(nb, b, nb, b).transpose(0, 2, 1, 3)
    Dk = [Lb[K, K] @ Lb[K, K].T for K in range(nb)]
    Lh = {}
    for K in range(nb):
        for I in st.struct[K]:
            Lh[I, K] = Lb[I, K] @ np.linalg.inv(Lb[K, K])
    inv = {}
    for K in reversed(range(nb)):
        C = list(st.struct[K])
        Dinv = np.linalg.inv(Dk[K])
        if not C:
            inv[K, K] = Dinv
            continue
        LC = np.vstack([Lh[I, K] for I in C])
        AC = np.block([[inv[I, J] for J in C] for I in C])
        X = -AC @ LC
        for i, I in enumerate(C):
            inv[I, K] = X[i * b:(i + 1) * b]
            inv[K, I] = inv[I, K].T
        inv[K, K] = Dinv - LC.T @ X
    ref = np.linalg.inv(D).reshape(nb, b, nb, b).transpose(0, 2, 1, 3)
    rs, cs = structure.selected_pairs(st)
    gap = max(np.abs(inv[int(r), int(c)] - ref[r, c]).max()
              for r, c in zip(rs, cs))
    assert gap < 1e-12 * np.abs(ref).max()


def test_reference_against_numpy():
    A = _matrix("dg_like", dict(atoms_x=6, atoms_y=6, block=4))
    st = structure.block_structure(A, 16)
    got = reference.dense_inverse_blocks(A, st, torch.device("cpu"))
    inv = np.linalg.inv(A.toarray())
    nb = st.nsuper
    blocks = inv.reshape(nb, 16, nb, 16).transpose(0, 2, 1, 3)
    rs, cs = structure.selected_pairs(st)
    assert np.allclose(got.numpy(), blocks[rs, cs], rtol=0, atol=1e-14)


@pytest.mark.parametrize("grid", [(2, 2), (4, 2), (1, 3)])
def test_shard_reader(grid):
    """Blocks laid out cyclically over the grid are read back in
    selected order."""
    A = _matrix("fem3d_like", dict(nx=4, ny=4, nz=4, block=3))
    b = 24
    st = structure.block_structure(A, b)
    pr, pc = grid
    nb = st.nsuper
    while nb % pr or nb % pc:
        nb += 1
    G = torch.randn(nb, nb, b, b, dtype=torch.float64)
    shards = torch.empty(pr * pc, nb // pr, nb // pc, b, b,
                         dtype=torch.float64)
    for I in range(nb):
        for J in range(nb):
            shards[(I % pr) * pc + J % pc, I // pr, J // pc] = G[I, J]
    rs, cs = structure.selected_pairs(st)
    got = reference.selected_from_shards(shards, st, grid)
    assert torch.equal(got, G[torch.as_tensor(rs), torch.as_tensor(cs)])


def test_worst_gap():
    ref = 2 * torch.ones(3, 2, 2)
    got = ref.clone()
    got[1, 0, 1] += 0.5
    assert reference.worst_gap(got, ref) == pytest.approx(0.5 / 2)
    got[2, 1, 1] = float("nan")
    assert reference.worst_gap(got, ref) == float("inf")


def test_trace_summary():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.sync",
         "ts": 150, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 100, "dur": 40},
        {"ph": "X", "cat": "kernel", "ts": 90, "dur": 20,
         "name": "void block_gemm_kernel<double, 96>"},
        {"ph": "X", "cat": "kernel", "ts": 130, "dur": 30,
         "name": "sm90_xmma_gemm_f64f64"},
        {"ph": "X", "cat": "kernel", "ts": 150, "dur": 20,
         "name": "indexSelectSmallIndex"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 190, "dur": 30,
         "name": "Memcpy DtoD"},
        {"ph": "X", "cat": "gpu_user_annotation", "ts": 100, "dur": 100,
         "name": "bench.window"},
    ]
    s = trace.summarize(ev, "bench.window")
    assert s.window_s == pytest.approx(100e-6)
    # busy: [100,110] ∪ [130,170] ∪ [190,200]
    assert s.busy_s == pytest.approx(60e-6)
    assert s.by_class[trace.GEMM_CLASS] == pytest.approx(10e-6)
    assert s.by_class[trace.CUBLAS_CLASS] == pytest.approx(30e-6)
    assert s.by_class["gather / scatter / index_add"] == pytest.approx(20e-6)
    assert s.by_class["memcpy / memset"] == pytest.approx(10e-6)
    assert s.idle_by_host == pytest.approx(
        {"bench.window: cudaGraphLaunch": 20e-6, "bench.sync": 20e-6})
    assert trace.summarize(ev, "bench.other") is None


def test_trace_replays():
    """The gaps inside each graph replay, the operations grouped by the
    launch's correlation id; without a graph launch, by the calls'
    ``bench.solve`` ranges."""
    def op(ts, dur, corr=None, cat="kernel"):
        return {"ph": "X", "cat": cat, "ts": ts, "dur": dur,
                "name": "k", "args": {"correlation": corr}}

    window = {"ph": "X", "cat": "user_annotation", "name": "bench.window",
              "ts": 0, "dur": 1000}
    ev = [window,
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 10, "dur": 50, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 500, "dur": 50, "args": {"correlation": 9}},
          op(5, 5, 3, "gpu_memcpy"),            # copy-in: no replay's
          op(100, 50, 7), op(140, 40, 7), op(200, 100, 7),
          op(600, 100, 9), op(710, 90, 9)]
    s = trace.summarize(ev, "bench.window")
    # replay 7: [100, 300], busy 80 + 100; replay 9: [600, 800], 100 + 90
    assert s.replay_span_s == pytest.approx(400e-6)
    assert s.replay_busy_s == pytest.approx(370e-6)
    solve = [{"ph": "X", "cat": "user_annotation", "name": "bench.solve",
              "ts": t, "dur": 20} for t in (0, 500)]
    eager = [window, *solve, op(5, 5), op(100, 50), op(200, 100),
             op(600, 100)]
    s = trace.summarize(eager, "bench.window")
    assert s.replay_span_s == pytest.approx(295e-6 + 100e-6)
    assert s.replay_busy_s == pytest.approx(155e-6 + 100e-6)


def test_make_matrix_is_symmetric():
    A = matrices.make_matrix("fem3d_like", dict(nx=4, ny=4, nz=4, block=3),
                             seed=2 ** 40 + 3)
    assert abs(A - A.T).max() == 0 and A.shape == (192, 192)


def test_percentile():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    assert stats.percentile(xs, 90) == pytest.approx(5.0 + 0.5 * 5.0)
    assert stats.percentile(xs, 50) == 3.5
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_scaled_lanes_are_the_prepare_of_scaled_matrices():
    """A batched lane l's values, D⁻¹·2^-l, are bit for bit the port's
    prepare of 2^l·A."""
    from repro_torch.core.engine import Grid, PSelInvEngine
    A = _matrix("fem3d_like", dict(nx=4, ny=4, nz=4, block=3))
    eng = PSelInvEngine.analyze(A, b=24, grid=Grid(2, 2), device="cpu")
    try:
        v = eng.prepare_values(A)
        for lane in range(1, 4):
            w = eng.prepare_values(A * 2.0 ** lane)
            assert torch.equal(w.Lh, v.Lh)
            assert torch.equal(w.Dinv, v.Dinv * 2.0 ** -lane)
    finally:
        PSelInvEngine.clear_cache()


def _traced_run():
    from pselbench.harness import Run
    run = Run(cell="c", workload={}, config={}, traced=True,
              device_kind="NVIDIA H100 80GB HBM3", lanes=2)
    run.call_s = [0.1 * (i + 1) for i in range(10)]
    run.dispatch_s = [0.001, 0.003, 0.5, 0.5, 0.5]
    run.profile_start, run.traced_calls = 2, (3, 5)
    run.window_s, run.peak_bytes = 2.0, 3 * 2 ** 30
    run.flops, run.least_bytes = 67e9, 1e6
    run.peaks = {"f64_flops": 67e12, "bytes": 3.35e12}
    run.setup_s, run.analyze_s, run.prepare_s = 12.5, 1.25, 7.5
    run.first_solve_s = 0.75
    run.trace = trace.TraceSummary(
        window_s=0.5, busy_s=0.4, replay_span_s=0.45, replay_busy_s=0.4,
        by_class={trace.GEMM_CLASS: 0.3, trace.CUBLAS_CLASS: 0.1,
                  "memcpy / memset": 0.05,
                  "gather / scatter / index_add": 0.15})
    return run


@pytest.mark.parametrize("name,value", [
    ("inv_per_s", 20 / 2.0),
    ("setup_s", 12.5),
    ("analyze_s", 1.25),
    ("prepare_s", 7.5),
    ("first_solve_s", 0.75),
    ("peak_mem_gib", 3.0),
    ("products_roofline", 100 * 1e-3 * 4 / 0.4),
    ("sweep.move_ms", 1e3 * 0.2 / 4),
    ("device.idle_pct", 100 * (1 - 0.4 / 0.45)),
    ("solve.dispatch_ms", 2.0),
])
def test_reader(name, value):
    from pselbench.cells import Bench
    from benchtiny import ROOT
    assert Bench(ROOT).metric(name).read(_traced_run()) == pytest.approx(
        value)
