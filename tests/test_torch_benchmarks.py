"""The port's benchmark CLI (``repro_torch.benchmarks``) on the CPU.

The paper's Table 1 and Figs 5 and 9 are host models: on one reduced
structure the port's benches must print the JAX benches' rows with
equal derived columns (only the timing field differs). The JAX benches
run as they are, in one subprocess, with the structure generator they
call swapped for the reduced one and their output directory moved to a
temporary one. The selected-inversion bench runs at nb=16 on the CPU
with every carried-over structure assert and every row ``record_bench``
requires; the tree-collective bench runs 8 gloo processes; ``run.py
--json`` writes a session ``record_bench`` records, idempotently per
``--rev``."""
import json
import os

import pytest

from conftest import run_sub

from repro_torch.benchmarks import (common, fig5_heatmap, fig8_scaling,
                                    fig9_ratio, kernels_bench,
                                    pselinv_bench, table1_volume,
                                    treecomm_bench)
from repro_torch.benchmarks import run as bench_run
from repro_torch.core import sparse
from repro_torch.core.trees import TreeKind
from repro_torch.tools import record_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEM_DIMS = (8, 8, 8)
DG_ATOMS = (8, 8, 12)


@pytest.fixture
def rows(monkeypatch, tmp_path):
    """The rows the port's benches record in this test, output files in
    a temporary directory."""
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(common, "RESULTS", [])
    return common.RESULTS


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("jaxbench")
    stdout = run_sub(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from repro.core import sparse
        import benchmarks.common as common
        from benchmarks import fig5_heatmap, fig9_ratio, table1_volume
        common.OUT_DIR = {str(out)!r}
        fem, dg = sparse.fem3d_like_structure, sparse.dg_like_structure

        class Reduced:
            fem3d_like_structure = staticmethod(
                lambda *a: fem(*{FEM_DIMS}, 3))
            dg_like_structure = staticmethod(lambda *a: dg(*{DG_ATOMS}))

        for mod in (table1_volume, fig5_heatmap, fig9_ratio):
            mod.sparse = Reduced
            mod.run()
    """, ndev=1)
    return {line.split(",")[0]: line.split(",", 2)[2]
            for line in stdout.splitlines() if line.count(",") >= 2}


@pytest.mark.parametrize("bench,kw", [
    (table1_volume, dict(dims=FEM_DIMS)),
    (fig5_heatmap, dict(dims=FEM_DIMS)),
    (fig9_ratio, dict(atoms=DG_ATOMS)),
], ids=["table1", "fig5", "fig9"])
def test_host_benches_match_jax(rows, jax_rows, bench, kw):
    bench.run(**kw)
    assert rows
    for r in rows:
        assert r["name"] in jax_rows, r["name"]
        assert r["derived"] == jax_rows[r["name"]], r["name"]


def test_fig8_one_grid_one_tree(rows):
    mats = ({"fem_like": sparse.fem3d_like_structure(6, 6, 6, 3)},
            {"fem_like": 12})
    fig8_scaling.run(seeds=(0,), grids={256: (16, 16)},
                     kinds=(TreeKind.SHIFTED,), mats=mats)
    assert [r["name"] for r in rows] == ["fig8/fem_like/p256/shifted"]
    assert float(rows[0]["derived"].split()[0].split("=")[1][:-1]) > 0


def test_run_json_is_recorded_idempotently(rows, monkeypatch, tmp_path):
    fem = sparse.fem3d_like_structure

    class Reduced:
        fem3d_like_structure = staticmethod(lambda *a: fem(*FEM_DIMS, 3))

    monkeypatch.setattr(table1_volume, "sparse", Reduced)
    session = tmp_path / "session.json"
    bench_run.main(["--only", "table1", "--json", str(session),
                    "--device", "cpu"])
    got = json.loads(session.read_text())
    assert got["device"] == "cpu" and not got["failed"]
    record_bench.validate_rows(got["benches"], where="session")
    hist = tmp_path / "hist.json"
    for _ in range(2):
        record_bench.main(["--session", str(session), "--only", "table1",
                           "--device", "cpu", "--rev", "T1",
                           "--out", str(hist)])
    entries = json.loads(hist.read_text())
    assert [e["rev"] for e in entries] == ["T1"]
    assert entries[0]["card"] == "cpu" and entries[0]["device"] == "cpu"
    record_bench.validate_history(entries)
    with pytest.raises(SystemExit, match="duplicate rev"):
        record_bench.validate_history(entries + entries)
    with pytest.raises(SystemExit, match="missing required rows"):
        record_bench.main(["--session", str(session), "--only", "selinv",
                           "--device", "cpu", "--out", str(hist)])
    with pytest.raises(SystemExit) as exc:
        bench_run.main(["--only", "nope", "--device", "cpu"])
    assert exc.value.code == 2


def test_kernels_bench_on_the_cpu(rows):
    kernels_bench.run(device="cpu")
    assert [r["name"] for r in rows] == [
        "kernel/block_gemm", "kernel/flash_attention", "kernel/rmsnorm",
        "kernel/trsm"]


def test_pselinv_bench_on_the_cpu(rows, monkeypatch):
    """The whole bench at nb=16 on the CPU: every assert it carries over
    holds (it raises otherwise) and every required row is there. The
    served trace is cut to 24 requests, one timed pass each."""
    from repro_torch.serve import traffic

    real = traffic.run_traffic

    def short(**kw):
        return real(**dict(kw, n_requests=24, reps=1))

    monkeypatch.setattr(traffic, "run_traffic", short)
    pselinv_bench.run(device="cpu")
    names = {r["name"] for r in rows}
    assert record_bench.REQUIRED_SELINV <= names, sorted(
        record_bench.REQUIRED_SELINV - names)
    for ex in ("unrolled", "ir", "overlap", "stream"):
        for what in ("capture", "graph_kernels", "dispatched_ops", "eager",
                     "run"):
            assert f"selinv/sweep_{ex}_{what}" in names
    derived = {r["name"]: r["derived"] for r in rows}
    for row in ("engine_batched_speedup", "serve_throughput_rps",
                "trace_overhead_pct"):
        assert "bar=" in derived[f"selinv/{row}"] and "met=" in derived[
            f"selinv/{row}"]
    for row in ("ir_vs_unrolled", "overlap_vs_ir", "stream_vs_overlap"):
        assert derived[f"selinv/sweep_{row}_maxdiff"] == "err=0.00e+00"


def test_treecomm_bench_tree_equals_flat(rows):
    treecomm_bench.run(device="cpu")
    names = [r["name"] for r in rows]
    assert names == ["treecomm/flat_psum", "treecomm/hier_tree",
                     "treecomm/equivalence"]
    assert "send log" in rows[1]["derived"]


def test_reemit_child_rows(rows, capsys):
    common.reemit_child_rows("name,us_per_call,derived\n"
                             "selinv/x,12.5,a=1 b=2\n"
                             "a warning, with commas, here\n"
                             "kernel/y,oops,z\n")
    assert [(r["name"], r["us_per_call"], r["derived"]) for r in rows] == [
        ("selinv/x", 12.5, "a=1 b=2")]
    out = capsys.readouterr().out
    assert "a warning, with commas, here" in out and "kernel/y,oops,z" in out
