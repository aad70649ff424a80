"""The port's multi-rank sweeps (``run_distributed`` over 8 gloo rank
processes, ``device="cpu"``) against the JAX package's ``run_distributed``
on 8 host devices, the dense oracle and the port's single-process
engine, in f64.

One JAX subprocess (8 host devices, x64) runs ``run_distributed`` on a
Laplacian and on a bushy FEM-like structure (several supernodes per
elimination-tree level), b=8 on grid 4×2, with the flat and the shifted
trees, overlapped and level-serial (``overlap=False``), and writes an
``.npz``. One group of 8 gloo processes runs the port's
``run_distributed`` on the same eight cases; every rank returns the full
result and its send log. The result must be within 1e-12 of JAX's (and,
overlapped, of ``dense_selinv_oracle`` on the selected blocks), and
bitwise equal to the port's single-process ``engine.solve`` of the same
executor (the level GEMM and the diagonal einsum run at P=1 per process,
at P=8 in one; on the CPU both sum each element in one order). The
ranks' sent bytes must total ``executed_wire_bytes`` and
``engine.stats()["moved_bytes"]`` (overlapped), and
``expected_wire_blocks·b²·8`` (level-serial), and their send logs must
hold the plan round by round (``exec_verify.lint_ranked``). The legacy
unrolled sweep (``run_distributed(pipelined=False)``) runs in its own 8
gloo processes on the Laplacian: each rank's result against the
single-process unrolled sweep, its sent bytes against the bytes
reckoned from the rounds."""
import threading
import warnings

import numpy as np
import pytest
import torch

from conftest import run_sub

from repro_torch.comm import p2p
from repro_torch.core import exec_ir, sparse
from repro_torch.core.exec_verify import (expected_wire_blocks, lint_ops,
                                          lint_ranked)
from repro_torch.core.engine import Grid, PSelInvEngine
from repro_torch.core.plan import PlanOptions
from repro_torch.core.pselinv_dist import (build_program, check_grid_devices,
                                           gather_blocks, make_sweep_ranked,
                                           prepare_inputs, rank_exec_tables,
                                           rank_tables, run_distributed,
                                           upload_exec_tables, upload_tables)
from repro_torch.core.selinv import dense_selinv_oracle
from repro_torch.core.simulator import executed_wire_bytes
from repro_torch.core.trees import TreeKind
from repro_torch.kernels import _build

TOL = 1e-12
KINDS = {"flat": TreeKind.FLAT, "shifted": TreeKind.SHIFTED}
CASES = [(m, k) for m in ("lap", "fem") for k in KINDS]


def _matrices():
    return {"lap": sparse.laplacian_2d(12, 8),
            "fem": sparse.make_numeric(sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                                       symmetric_values=True)}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("distref") / "ref.npz"
    run_sub(f"""
        import warnings
        import numpy as np
        import jax.numpy as jnp
        from repro.core import sparse
        from repro.core.trees import TreeKind
        from repro.core.pselinv_dist import run_distributed
        warnings.simplefilter("ignore", DeprecationWarning)
        mats = {{"lap": sparse.laplacian_2d(12, 8),
                 "fem": sparse.make_numeric(
                     sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                     symmetric_values=True)}}
        kinds = {{"flat": TreeKind.FLAT, "shifted": TreeKind.SHIFTED}}
        out = {{}}
        for m, A in mats.items():
            for k, kind in kinds.items():
                for ex, overlap in (("", True), ("_ls", False)):
                    o, _ = run_distributed(A, b=8, pr=4, pc=2, kind=kind,
                                           dtype=jnp.float64,
                                           overlap=overlap)
                    out[m + "_" + k + ex] = np.asarray(o)
        np.savez({str(path)!r}, **out)
    """, ndev=8, x64=True)
    return dict(np.load(path))


def _port_rank(rank):
    """The four cases on this rank, overlapped and level-serial (key
    suffix ``_ls``): its full result, its send log, the rounds it took
    part in, and the error codes of its own recorded permutes against
    the plan."""
    torch.set_num_threads(1)
    mats, res = _matrices(), {}
    for m, k in CASES:
        for ex, overlap in (("", True), ("_ls", False)):
            p2p.LOG.clear()
            with exec_ir.record() as rec:
                out, prog = run_distributed(mats[m], b=8, pr=4, pc=2,
                                            kind=KINDS[k],
                                            dtype=torch.float64,
                                            device="cpu", overlap=overlap)
            moves = [(r, s == rank) for r, s, _, _ in p2p.LOG.entries]
            res[m + "_" + k + ex] = dict(
                out=out, sent=p2p.LOG.sent(), received=p2p.LOG.received(),
                rounds=p2p.LOG.rounds, staged=p2p.LOG.staged_bytes,
                once=len(moves) == len(set(moves)),
                log=p2p.LOG.snapshot(),
                codes=sorted({d.code for d in lint_ops(rec, prog)}))
    return res


@pytest.fixture(scope="module")
def port():
    return p2p.spawn(_port_rank, 8, timeout=400)


def _engine(m, k, overlap=True):
    eng = PSelInvEngine.analyze(_matrices()[m], b=8, grid=Grid(4, 2),
                                options=PlanOptions(kind=KINDS[k],
                                                    overlap=overlap),
                                device="cpu")
    return eng, eng.solve(_matrices()[m], dtype=torch.float64).numpy()


@pytest.mark.parametrize("m,k", CASES)
def test_ranked_solve_matches_jax_and_oracle(jax_ref, port, m, k):
    out = port[0][m + "_" + k]["out"]
    for r in range(1, 8):       # the all_gather hands every rank the same
        np.testing.assert_array_equal(port[r][m + "_" + k]["out"], out)
    assert np.abs(out - jax_ref[m + "_" + k]).max() <= TOL
    eng, _ = _engine(m, k)
    G, ref, b = gather_blocks(out, eng), dense_selinv_oracle(_matrices()[m]), 8
    err = 0.0
    for K in range(eng.bs.nsuper):
        for I in [K] + [int(i) for i in eng.bs.struct[K]]:
            for (r, c) in ((I, K), (K, I)):
                err = max(err, np.abs(G[r, c] - ref[r * b:(r + 1) * b,
                                                    c * b:(c + 1) * b]).max())
    assert err <= TOL


@pytest.mark.parametrize("m,k", CASES)
def test_ranked_solve_equals_single_process(port, m, k):
    _, single = _engine(m, k)
    np.testing.assert_array_equal(port[0][m + "_" + k]["out"], single)


@pytest.mark.parametrize("m,k", CASES)
def test_send_log_totals_the_executed_wire(port, m, k):
    """Every message is logged once by its sender and once by its
    receiver; the senders' bytes total the plan's executed wire and the
    session's moved bytes, in f64; a rank sends and receives at most once
    a round; the ranks all count the same rounds; CPU tensors stage
    nothing."""
    eng, _ = _engine(m, k)
    rows = [port[r][m + "_" + k] for r in range(8)]
    sent = sum(row["sent"][1] for row in rows)
    assert sent == sum(row["received"][1] for row in rows)
    assert sent == executed_wire_bytes(eng.program)
    assert sent == eng.stats()["moved_bytes"]
    assert sum(row["sent"][0] for row in rows) == sum(
        len(rnd.perm) for rnd in eng.program.overlap_plan.rounds)
    assert {row["rounds"] for row in rows} == {eng.moved()[0]}
    assert all(row["once"] and row["staged"] == 0 for row in rows)


@pytest.mark.parametrize("m,k", CASES)
def test_ranked_level_serial_matches_single_process_and_jax(jax_ref, port,
                                                            m, k):
    """The paper's level-serial sweep by 8 rank processes: every rank
    holds the same result, bitwise the single-process level-serial
    engine's and within 1e-12 of the JAX package's
    ``run_distributed(overlap=False)``."""
    key = m + "_" + k + "_ls"
    out = port[0][key]["out"]
    for r in range(1, 8):
        np.testing.assert_array_equal(port[r][key]["out"], out)
    _, single = _engine(m, k, overlap=False)
    np.testing.assert_array_equal(out, single)
    assert np.abs(out - jax_ref[key]).max() <= TOL


@pytest.mark.parametrize("m,k", CASES)
def test_ranked_level_serial_send_log_is_the_plan(port, m, k):
    """The ranks' messages are the plan's wire exactly
    (``expected_wire_blocks·b²·8``, the session's moved bytes), their
    logs hold the plan round by round (``lint_ranked``), and each rank's
    own recorded permutes lint clean."""
    key = m + "_" + k + "_ls"
    eng, _ = _engine(m, k, overlap=False)
    rows = [port[r][key] for r in range(8)]
    sent = sum(row["sent"][1] for row in rows)
    assert sent == sum(row["received"][1] for row in rows)
    assert sent == expected_wire_blocks(eng.program) * 8 * 8 * 8
    assert sent == eng.stats()["moved_bytes"]
    res = lint_ranked([row["log"] for row in rows], eng.program)
    assert list(res) == []
    assert res.info["sent_bytes"] == sent and res.info["staged_bytes"] == 0
    assert all(row["codes"] == [] and row["once"] and row["staged"] == 0
               for row in rows)


def test_lint_ranked_catches_faults_injected_into_a_log(port):
    """A retargeted pair, a dropped round, a resized message and staged
    bytes that do not add up, each injected into the ranks' logs of the
    FEM level-serial solve, fire their codes."""
    eng, _ = _engine("fem", "shifted", overlap=False)
    logs = [port[r]["fem_shifted_ls"]["log"] for r in range(8)]

    def codes(mutated):
        return {d.code for d in lint_ranked(mutated, eng.program)}

    def edit(fn):
        return [dict(lg, entries=[e2 for e in lg["entries"]
                                  for e2 in fn(lg["rank"], e)])
                for lg in logs]

    r0, s0, d0, n0 = logs[0]["entries"][0]
    free = next(r for r in range(8) if r not in (s0, d0) and not any(
        e[0] == r0 and e[2] == r for lg in logs for e in lg["entries"]))

    def retarget(rank, e):
        return [(e[0], e[1], free, e[3])] if e[:3] == (r0, s0, d0) else [e]

    assert {"hlo/perm-unknown", "hlo/perm-missing"} <= codes(
        edit(retarget))
    assert codes(edit(lambda rank, e: [] if e[0] == r0 else [e])) >= {
        "hlo/perm-missing"}
    assert "hlo/bytes-drift" in codes(edit(
        lambda rank, e: [e[:3] + (e[3] * 2,)] if e[0] == r0 else [e]))
    assert codes([dict(lg, staged_bytes=lg["staged_bytes"] + 8)
                  for lg in logs]) == {"hlo/host-transfer"}


def test_rank_tables_are_rows_of_the_uploaded_tables():
    """A rank's view plus its arena and shard offsets gives back row
    ``rank`` of every lane table, and each permute's pairs."""
    A = _matrices()["fem"]
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device="cpu")
    tabs = upload_tables(eng.program, "cpu")
    P, AB, N = tabs.P, tabs.arena_blocks, tabs.N
    for rank in (0, 5):
        mine = rank_tables(tabs, rank, "cpu")
        assert mine.P == 1 and mine.dset_m.shape[0] == 1
        for g, ln in zip(tabs.comm, mine.comm):
            if g is None:
                assert ln is None
                continue
            W = g.width
            assert torch.equal(ln.ga + rank * AB, g.ga.view(P, W)[rank])
            assert torch.equal(ln.gl + rank * N, g.gl.view(P, W)[rank])
            assert torch.equal(ln.sc + rank * AB, g.sc.view(P, W)[rank])
            assert ln.perm == list(zip(g.src.tolist(), g.dst.tolist()))
        for g, lv in zip(tabs.levels, mine.levels):
            assert torch.equal(lv.cm[0], g.cm[rank])
            assert torch.equal(lv.ut + rank * AB, g.ut.view(P, -1)[rank])
    with pytest.raises(ValueError, match="outside a grid"):
        rank_tables(tabs, P, "cpu")


def test_rank_exec_tables_are_rows_of_the_uploaded_tables():
    """A rank's level-serial view: row ``rank`` of every mask, and for
    each round its host pairs and the rank's gather and scatter slot,
    read off the uploaded ``src·len + slot`` addresses."""
    A = _matrices()["fem"]
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device="cpu",
                                options=PlanOptions(overlap=False))
    tabs = upload_exec_tables(eng.program, "cpu")
    for rank in (0, 5):
        mine = rank_exec_tables(tabs, rank, "cpu")
        assert mine.P == 1 and mine.dset_m.shape[0] == 1
        for g, lt in zip(tabs.levels, mine.levels):
            assert torch.equal(lt.masks.cm[0], g.masks.cm[rank])
            assert torch.equal(lt.masks.droot[0], g.masks.droot[rank])
            for name in ("xfer_in", "bcast", "reduce", "xfer_out_local"):
                ph, rp = getattr(g, name), getattr(lt, name)
                assert rp.name == ph.name
                for (gs, ss), perm, rnd in zip(ph.pairs, ph.perm,
                                               rp.rounds):
                    assert rnd.perm == perm
                    src = (gs // ph.src_len).tolist()
                    dst = (ss // ph.dst_len).tolist()
                    assert (rnd.gather is None) == (rank not in src)
                    assert (rnd.scatter is None) == (rank not in dst)
                    if rnd.gather is not None:
                        assert int(gs[src.index(rank)]) == \
                            rank * ph.src_len + rnd.gather
                    if rnd.scatter is not None:
                        assert int(ss[dst.index(rank)]) == \
                            rank * ph.dst_len + rnd.scatter
    with pytest.raises(ValueError, match="outside a grid"):
        rank_exec_tables(tabs, 8, "cpu")
    with pytest.raises(ValueError, match="rank_exec_tables"):
        make_sweep_ranked(eng.program, tabs, 0)


def test_grid_and_input_errors():
    """The reference's diagnostics: a grid that is not one rank per
    process, a size that is not a multiple of b, and the deprecated
    ``prepare_inputs``."""
    A = sparse.laplacian_2d(12, 8)
    with pytest.raises(ValueError, match=r"grid 64x64 needs 4096 devices"):
        check_grid_devices(64, 64)
    with pytest.raises(ValueError, match=r"grid 64x64 needs 4096 devices"):
        run_distributed(A, b=8, pr=64, pc=64, device="cpu")
    with pytest.raises(ValueError, match=r"not a multiple of the supernode"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            prepare_inputs(A, b=7, pr=1, pc=1)
    with pytest.warns(DeprecationWarning, match="prepare_inputs"):
        bs, nb, Lh, Dinv = prepare_inputs(A, b=8, pr=4, pc=2)
    assert Lh.shape == Dinv.shape == (8, nb // 4, nb // 2, 8, 8)


def _unrolled_rank(rank, kw):
    """``run_distributed(**kw)`` on this rank: the full result and what
    this rank sent."""
    torch.set_num_threads(1)
    p2p.LOG.clear()
    out, prog = run_distributed(sparse.laplacian_2d(12, 8), b=8, pr=4, pc=2,
                                dtype=torch.float64, device="cpu", **kw)
    return dict(out=out, sent=p2p.LOG.sent(), rounds=p2p.LOG.rounds)


# the level-serial case (once id "kw0") runs in the ranked level-serial
# tests above; the unrolled case keeps its id, and since the unrolled
# sweep runs over rank processes it is held to the single-process one
@pytest.mark.parametrize("kw", [pytest.param(dict(pipelined=False),
                                             id="kw1")])
def test_other_executors_over_ranks_are_not_ported(kw):
    from repro_torch.core.pselinv_dist import (analyze_structure,
                                               build_program_unrolled,
                                               make_sweep_unrolled,
                                               prepare_values,
                                               unrolled_moved,
                                               upload_unrolled_tables)
    rows = p2p.spawn(_unrolled_rank, 8, kw, timeout=300)
    A = sparse.laplacian_2d(12, 8)
    bs, nb = analyze_structure(A, 8, 4, 2)
    prog = build_program_unrolled(bs, nb, 8, 4, 2)
    Lh, Dinv = prepare_values(A, bs, nb, 8, 4, 2)
    one = make_sweep_unrolled(prog, upload_unrolled_tables(prog, "cpu"))(
        torch.from_numpy(Lh), torch.from_numpy(Dinv)).numpy()
    scale = np.abs(one).max()
    for row in rows:
        if not np.array_equal(row["out"], one):
            d = np.abs(row["out"] - one).max()
            assert d <= TOL * scale, (
                f"ranked unrolled shards differ from the single-process "
                f"sweep by {d:.3e} (the diagonal einsum and the level GEMM "
                "run at P=1 in a rank, at P=8 in one process)")
    rounds, blocks = unrolled_moved(prog)
    assert rounds == 72
    assert {row["rounds"] for row in rows} == {rounds}
    assert sum(row["sent"][1] for row in rows) == blocks * 8 * 8 * 8


def test_ranked_sweep_needs_one_ranks_tables():
    from repro_torch.core.pselinv_dist import (analyze_structure,
                                               make_sweep_overlapped_ranked)
    A = sparse.laplacian_2d(12, 8)
    bs, nb = analyze_structure(A, 8, 4, 2)
    prog = build_program(bs, nb, 8, 4, 2, overlap=True)
    with pytest.raises(ValueError, match="rank_tables"):
        make_sweep_overlapped_ranked(prog, upload_tables(prog, "cpu"), 0)


def test_build_lock_one_compile_for_concurrent_callers(tmp_path,
                                                      monkeypatch):
    """Four callers that find the library missing at once: one compiles
    (a stand-in nvcc that records each run), the others wait on the build
    directory's lock and load its library."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    runs = tmp_path / "runs"
    nvcc = cuda / "nvcc"
    nvcc.write_text(f"""#!/bin/sh
echo run >> {runs}
sleep 0.5
while [ "$1" != "-o" ]; do shift; done
echo lib > "$2"
""")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    got, errs = [], []

    def call():
        try:
            got.append(_build.build(["block_gemm"])["block_gemm"])
        except Exception as e:          # surfaced by the assert below
            errs.append(e)

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errs
    assert runs.read_text().split() == ["run"]
    assert len(set(got)) == 1 and got[0].read_text() == "lib\n"
