"""A configuration, cells and a metric added as files are found and run
with no file of the benchmark edited; the run's result line has the
contract's shape."""
import json
import time

import torch

from benchtiny import ROOT, TINY_CELLS, tiny_root

from pselbench import harness
from pselbench.cells import Bench

READER = '''"""A metric added by a test: the calls of the window."""
UNIT = "calls"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "graph runner and engine"
MOVES = "inv_per_s"


def read(run):
    return float(run.calls)
'''


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in (root / "bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts
            and "tests" not in p.relative_to(root).parts}


def test_added_files_are_found_and_nothing_is_edited(tmp_path):
    root = tiny_root(tmp_path)
    (root / "bench" / "metrics" / "window.calls.py").write_text(READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "window.calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "graph runner and engine",
                              "moves": "inv_per_s",
                              "workloads": list(TINY_CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = _tree(ROOT)
    copied = _tree(root)
    assert {k: v for k, v in copied.items() if k in before} == before

    bench = Bench(root)
    assert bench.config("tiny-fem")["n"] == 192
    run = harness.run_cell(bench, "tiny-fem.solve", seed=7, seconds=0.3,
                           trace=True, device=torch.device("cpu"),
                           t_start=time.perf_counter())
    res = harness.result(bench, run)
    assert res["correct"] is True
    assert res["metrics"]["window.calls"]["value"] == run.calls
    assert set(res["metrics"]) >= {"prepare_s", "analyze_s",
                                   "first_solve_s", "solve.dispatch_ms"}
    assert list(res)[-1] == "checks"
    assert _tree(ROOT) == before


def test_result_line_shape(tmp_path):
    bench = Bench(tiny_root(tmp_path))
    run = harness.run_cell(bench, "tiny-fem.poles4",
                           seed=2 ** 31 + 2 ** 40 + 5, seconds=0.3,
                           trace=False, device=torch.device("cpu"),
                           t_start=time.perf_counter())
    res = harness.result(bench, run)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 4 * run.calls > 0
    assert set(res["metrics"]) == {"inv_per_s", "setup_s"}
    assert res["checks"]["rel_gap"]["value"] < 1e-13
    json.loads(json.dumps(res))
