"""The port's legacy unrolled executor (``build_program_unrolled``,
``make_sweep_unrolled``) on the CPU, against the JAX package's, the
port's overlapped engine and the dense oracle, in f64.

The host schedule is compared in this process, field by field for every
supernode, on two Laplacians under all four tree kinds and a bushy
FEM-like structure. One JAX subprocess (8 host devices, x64) runs the
JAX unrolled sweep (``run_distributed(pipelined=False)``) on the three
matrices and writes its outputs and its prepared value shards; the
port's unrolled sweep on those shards must land within
1e-12·max|A⁻¹| of it and of the port's overlapped engine, its selected
blocks within 1e-9 of ``dense_selinv_oracle``, and it must run one
block-GEMM call per supernode with a non-empty struct."""
import numpy as np
import pytest
import torch

from conftest import run_sub

from repro.core import pselinv_dist as jpd
from repro.core import sparse as jsparse
from repro.core.trees import TreeKind as JKind

from repro_torch.core import pselinv_dist as pd
from repro_torch.core import sparse
from repro_torch.core.engine import Grid, PSelInvEngine
from repro_torch.core.pselinv_dist import (analyze_structure,
                                           build_program_unrolled,
                                           gather_blocks,
                                           make_sweep_unrolled,
                                           unrolled_moved,
                                           upload_unrolled_tables)
from repro_torch.core.selinv import dense_selinv_oracle
from repro_torch.core.trees import TreeKind

TOL = 1e-12
KINDS = ("flat", "binary", "shifted", "hybrid")
FIELDS = ("K", "C", "xfer_in_rounds", "xfer_in_local", "bcast_rounds",
          "reduce_rounds", "xfer_out_rounds", "xfer_out_local",
          "diag_reduce_rounds")


def _matrices(mod):
    return {"lap12": mod.laplacian_2d(12, 8),
            "lap16": mod.laplacian_2d(16, 8),
            "fem": mod.make_numeric(mod.fem3d_like_matrix(4, 4, 4, 2)[0],
                                    symmetric_values=True)}


SCHEDULES = [(m, k) for m in ("lap12", "lap16") for k in KINDS] + [
    ("fem", "shifted")]


@pytest.mark.parametrize("m,k", SCHEDULES)
def test_schedule_equals_jax_field_by_field(m, k):
    A = _matrices(sparse)[m]
    bs, nb = analyze_structure(A, 8, 4, 2)
    jbs, jnb = jpd.analyze_structure(_matrices(jsparse)[m], 8, 4, 2)
    assert nb == jnb
    got = build_program_unrolled(bs, nb, 8, 4, 2, TreeKind(k)).iters
    want = jpd.build_program_unrolled(jbs, jnb, 8, 4, 2, JKind(k)).iters
    assert len(got) == len(want) == nb
    for g, w in zip(got, want):
        for f in FIELDS:
            gv, wv = getattr(g, f), getattr(w, f)
            if isinstance(gv, list):
                gv = [list(map(tuple, r)) if isinstance(r, list) else r
                      for r in gv]
                wv = [list(map(tuple, r)) if isinstance(r, list) else r
                      for r in wv]
            assert gv == wv, (m, k, g.K, f)
        np.testing.assert_array_equal(g.col_mask, w.col_mask)
        np.testing.assert_array_equal(g.row_mask, w.row_mask)


def test_round_and_wire_counts():
    """The Laplacian (16, 8) at b=8 on grid 4×2: 97 rounds and 672
    blocks on the wire (0.34 MB in f64)."""
    bs, nb = analyze_structure(sparse.laplacian_2d(16, 8), 8, 4, 2)
    assert unrolled_moved(build_program_unrolled(bs, nb, 8, 4, 2)) == (97,
                                                                        672)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("unrolled") / "ref.npz"
    run_sub(f"""
        import warnings
        import numpy as np
        import jax.numpy as jnp
        from repro.core import sparse
        from repro.core.pselinv_dist import (analyze_structure,
                                             prepare_values, run_distributed)
        warnings.simplefilter("ignore", DeprecationWarning)
        mats = {{"lap12": sparse.laplacian_2d(12, 8),
                 "lap16": sparse.laplacian_2d(16, 8),
                 "fem": sparse.make_numeric(
                     sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                     symmetric_values=True)}}
        out = {{}}
        for m, A in mats.items():
            o, _ = run_distributed(A, b=8, pr=4, pc=2, dtype=jnp.float64,
                                   pipelined=False)
            bs, nb = analyze_structure(A, 8, 4, 2)
            out[m], (out[m + "_lh"], out[m + "_dinv"]) = (
                np.asarray(o), prepare_values(A, bs, nb, 8, 4, 2))
        np.savez({str(path)!r}, **out)
    """, ndev=8, x64=True)
    return dict(np.load(path))


def _port(m, ref):
    A = _matrices(sparse)[m]
    bs, nb = analyze_structure(A, 8, 4, 2)
    prog = build_program_unrolled(bs, nb, 8, 4, 2)
    sweep = make_sweep_unrolled(prog, upload_unrolled_tables(prog, "cpu"))
    Lh = torch.from_numpy(ref[m + "_lh"])
    Dinv = torch.from_numpy(ref[m + "_dinv"])
    return prog, sweep, sweep(Lh, Dinv)


@pytest.mark.parametrize("m", ["lap12", "lap16", "fem"])
def test_sweep_matches_jax_overlapped_and_oracle(jax_ref, m):
    prog, _, out = _port(m, jax_ref)
    want = jax_ref[m]
    scale = np.abs(want).max()
    assert np.abs(out.numpy() - want).max() <= TOL * scale
    A = _matrices(sparse)[m]
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device="cpu")
    ov = eng.solve(A, dtype=torch.float64)
    assert (out - ov).abs().max().item() <= TOL * scale
    dense = dense_selinv_oracle(A)
    G = gather_blocks(out.numpy(), prog)
    n = A.shape[0]
    for K in range(prog.bs.nsuper):
        for I in [K, *prog.bs.struct[K]]:
            sl = slice(I * 8, I * 8 + 8), slice(K * 8, K * 8 + 8)
            if I * 8 < n:
                assert np.abs(G[I, K] - dense[sl]).max() < 1e-9


def test_one_gemm_per_supernode(jax_ref, monkeypatch):
    calls = []
    real = pd.pselinv_round_gemm

    def counted(Ainv, U, cm, out=None):
        calls.append(tuple(U.shape))
        return real(Ainv, U, cm, out=out)

    monkeypatch.setattr(pd, "pselinv_round_gemm", counted)
    prog, sweep, one = _port("fem", jax_ref)
    live = sum(1 for it in prog.iters if it.C)
    assert len(calls) == live and all(s[:3] == (1, 8, 1) for s in calls)
    # one matrix a call, as the JAX sweep: a stacked batch is refused
    with pytest.raises(ValueError, match="value shards"):
        sweep(one[None], one[None])
    assert len(calls) == live


def test_unrolled_needs_its_program():
    bs, nb = analyze_structure(sparse.laplacian_2d(12, 8), 8, 4, 2)
    prog = pd.build_program(bs, nb, 8, 4, 2, overlap=True)
    with pytest.raises(ValueError, match="build_program_unrolled"):
        upload_unrolled_tables(prog, "cpu")
    with pytest.raises(ValueError, match="build_program_unrolled"):
        make_sweep_unrolled(prog, None)
    with pytest.raises(ValueError, match="not divisible"):
        build_program_unrolled(bs, nb + 1, 8, 4, 2)
