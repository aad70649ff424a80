"""The readers of the host prepare's steps (``prepare.*_s``), which read
the program's counters: on a synthetic run, on a traced tiny cell on the
CPU, and with a program that keeps no such counters."""
import time

import pytest
import torch

from benchtiny import ROOT, tiny_root

from pselbench import harness
from pselbench.cells import Bench

BENCH = Bench(ROOT)
PREPARE = ("prepare.factor_s", "prepare.layout_s", "prepare.upload_s")
#: the per-layer metrics a traced CPU run reported before these
BEFORE = {"prepare_s", "analyze_s", "first_solve_s", "solve.dispatch_ms"}


def _run():
    return harness.Run(cell="c", workload={}, config={}, traced=True,
                       device_kind="cpu", lanes=1)


def test_prepare_readers_read_the_program_counters(monkeypatch):
    from repro_torch.obs.registry import REGISTRY
    from repro_torch.core.engine import Grid, PSelInvEngine
    from repro_torch.core import sparse
    A = sparse.make_numeric(sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                            symmetric_values=True)
    PSelInvEngine.analyze(A, b=8, grid=Grid(2, 2),
                          device="cpu").prepare_values(A)
    calls = REGISTRY.get("selinv_prepare_calls_total").value
    steps = dict(REGISTRY.get("selinv_prepare_seconds_total").children())
    for m in PREPARE:
        step = m.split(".")[1][:-2]
        assert BENCH.metric(m).read(_run()) == pytest.approx(
            steps[(step,)].value / calls, rel=1e-12)
    # a program without the counters
    monkeypatch.setattr(REGISTRY, "get", lambda name: None)
    assert all(BENCH.metric(m).read(_run()) is None for m in PREPARE)


def test_traced_tiny_cell_prints_the_prepare_steps(tmp_path):
    """The prepare's steps print beside every earlier metric, which reads
    as it did."""
    bench = Bench(tiny_root(tmp_path))
    run = harness.run_cell(bench, "tiny-fem.solve", seed=11, seconds=0.3,
                           trace=True, device=torch.device("cpu"),
                           t_start=time.perf_counter())
    res = harness.result(bench, run)
    assert res["correct"] is True
    assert set(res["metrics"]) == BEFORE | set(PREPARE)
    assert all(res["metrics"][m]["value"] > 0 for m in PREPARE)
    assert res["metrics"]["prepare_s"]["value"] == run.prepare_s


def test_a_program_without_the_counters_leaves_them_out(tmp_path,
                                                         monkeypatch):
    """A program that keeps no prepare counters (as before these
    metrics) runs a traced cell as before: the readers raise nothing and
    the line leaves their metrics out."""
    from repro_torch.obs.registry import REGISTRY
    monkeypatch.setattr(REGISTRY, "get", lambda name: None)
    bench = Bench(tiny_root(tmp_path))
    run = harness.run_cell(bench, "tiny-fem.poles4", seed=12, seconds=0.3,
                           trace=True, device=torch.device("cpu"),
                           t_start=time.perf_counter())
    res = harness.result(bench, run)
    assert res["correct"] is True
    assert set(res["metrics"]) == BEFORE
