"""The port's tools and examples on the CPU: the verifier's size
baseline (``exec_verify.load_size_baseline`` / ``check_size``, and
``exec_lint --baseline``), ``obs_report`` and ``serve_bench`` with
``--device cpu``, and every example in a subprocess of its own."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.core import exec_verify, sparse
from repro_torch.core.engine import Grid, PlanOptions, PSelInvEngine
from repro_torch.core.exec_verify import check_size, load_size_baseline
from repro_torch.tools import exec_lint, obs_report, serve_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entry(rev, device, kernels, ops):
    return {"rev": rev, "device": device,
            "card": "cpu" if device == "cpu" else "NVIDIA H100, 700.00 W",
            "failed": [], "benches": [
                {"name": "selinv/sweep_stream_graph_kernels",
                 "us_per_call": kernels, "derived": ""},
                {"name": "selinv/sweep_stream_dispatched_ops",
                 "us_per_call": ops, "derived": ""},
                {"name": "selinv/sweep_overlap_graph_kernels",
                 "us_per_call": kernels / 2, "derived": ""},
                {"name": "selinv/sweep_overlap_dispatched_ops",
                 "us_per_call": ops / 2, "derived": ""}]}


def test_load_size_baseline(tmp_path):
    path = tmp_path / "hist.json"
    assert load_size_baseline(str(path)) is None              # no file
    path.write_text("{ not json")
    assert load_size_baseline(str(path)) is None              # corrupt
    path.write_text(json.dumps([_entry("c", "cpu", 0.0, 900.0)]))
    assert load_size_baseline(str(path)) is None              # CPU only
    path.write_text(json.dumps([_entry("a", "cuda", 100.0, 500.0),
                                _entry("b", "cuda", 120.0, 600.0),
                                _entry("c", "cpu", 0.0, 900.0)]))
    assert load_size_baseline(str(path)) == {"graph_kernels": 120.0,
                                             "dispatched_ops": 600.0}
    partial = _entry("d", "cuda", 140.0, 700.0)
    partial["benches"] = partial["benches"][:1]               # no op count
    path.write_text(json.dumps([_entry("b", "cuda", 120.0, 600.0),
                                partial]))
    assert load_size_baseline(str(path)) == {"graph_kernels": 120.0,
                                             "dispatched_ops": 600.0}


def test_check_size_warns_past_the_ratio():
    base = {"graph_kernels": 100.0, "dispatched_ops": 1000.0}
    assert check_size({"graph_kernels": 150.0, "dispatched_ops": 1500.0},
                      base) == []
    diags = check_size({"graph_kernels": 151.0, "dispatched_ops": None},
                       base)
    assert [(d.code, d.severity) for d in diags] == [("hlo/size-regress",
                                                      "warn")]
    assert check_size({"graph_kernels": 1e9}, None) == []


def test_lint_against_a_baseline(tmp_path, capsys):
    """``exec_lint --baseline`` runs, and a baseline a third of the
    sweep's dispatched ops makes the lint of that class WARN — through
    ``lint_program`` and ``engine.lint_compiled``."""
    eng = PSelInvEngine.analyze(sparse.laplacian_2d(16, 8), b=8,
                                grid=Grid(4, 2),
                                options=PlanOptions(stream=True),
                                device="cpu")
    ops = eng.lint_compiled().info["dispatched_ops"]
    path = tmp_path / "hist.json"
    path.write_text(json.dumps([_entry("a", "cuda", 10.0, ops)]))
    assert exec_lint.main(["--grid", "4x2", "--nb", "16", "--baseline",
                           str(path)]) == 0
    assert "size baseline from" in capsys.readouterr().out
    small = {"graph_kernels": 10.0, "dispatched_ops": ops / 3}
    res = eng.lint_compiled(baseline=small)
    assert [d.code for d in res] == ["hlo/size-regress"]
    assert eng.lint_compiled() == []                     # cached, unmoved
    meta = exec_verify.lint_program(eng.program, baseline=small)
    assert [d.code for d in meta] == ["hlo/size-regress"]


def test_obs_report_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.trace.json"
    assert obs_report.main(["--device", "cpu", "--reps", "1", "-o",
                            str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    assert events
    assert "OK: measured inbound-byte skew" in capsys.readouterr().out
    assert obs_report.main(["--device", "cpu", "--reps", "1", "-o",
                            str(out), "--skew-threshold", "1.0"]) == 1


def test_serve_bench_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    serve_bench.main(["--device", "cpu", "--requests", "16", "--burst",
                      "--json", str(out)])
    res = json.loads(out.read_text())
    assert res["n_requests"] == 16 and res["identity_max_abs"] <= 1e-12
    assert "captures" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "pselinv_engine",
                                  "pselinv_serve", "tree_gradient_sync"])
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                        "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    if name == "tree_gradient_sync":
        assert "gradients identical: True" in r.stdout
        assert "(send log)" in r.stdout


def test_examples_and_tools_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.benchmarks.run, repro_torch.tools.obs_report\n"
            "import repro_torch.tools.serve_bench\n"
            "import repro_torch.tools.record_bench\n"
            "import repro_torch.examples.pselinv_engine\n"
            "import repro_torch.benchmarks.pselinv_bench\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
