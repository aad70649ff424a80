"""What the benchmark runs loads neither JAX nor the JAX package
(``repro``, by whole top-level name), reads nothing under
``benchmarks/`` and no ``BENCH_*.json``; the reference imports nothing
of the port; without a card, or without the port beside it, a run exits
non-zero and prints no result."""
import ast
import shutil
import subprocess
import sys

import pytest

from benchtiny import ROOT

SOURCES = sorted(p for p in (ROOT / "bench").rglob("*.py")
                 if "tests" not in p.relative_to(ROOT / "bench").parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_import_or_file(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    text = path.read_text()
    assert "BENCH_" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("name", ["reference", "structure", "matrices",
                                  "stats", "trace", "peaks"])
def test_yardstick_imports_nothing_of_the_port(name):
    path = ROOT / "bench" / "pselbench" / f"{name}.py"
    assert not any(m.split(".")[0] == "repro_torch" for m in _imports(path))


def test_forbidden_modules_by_whole_name(monkeypatch):
    """Whole top-level names: ``repro_torch`` passes, ``repro.*`` and
    ``jax`` fail (other tests in this process may have loaded JAX)."""
    sys.path.insert(0, str(ROOT / "bench"))
    import run
    for name in ("repro_torch_fake", "reprox", "jax_fake.core"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("repro.core.fake", "jax.fake", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    found = run.forbidden_modules()
    assert {"repro.core.fake", "jax.fake", "flax"} <= set(found)
    assert not {"repro_torch_fake", "reprox", "jax_fake.core"} & set(found)


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then its loaded modules."""
    code = (
        "import sys, time, pathlib, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'bench' / 'tests')!r}]\n"
        "import benchtiny, tempfile\n"
        "from pselbench import harness\n"
        "from pselbench.cells import Bench\n"
        "import run\n"
        "root = benchtiny.tiny_root(pathlib.Path(tempfile.mkdtemp()))\n"
        "r = harness.run_cell(Bench(root), 'tiny-fem.solve', seed=1,"
        " seconds=0.2, trace=False, device=torch.device('cpu'),"
        " t_start=time.perf_counter())\n"
        "assert harness.result(Bench(root), r)['correct']\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT / "bench")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_py(cwd):
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "fem3d-b96.solve", "--seed", "1", "--seconds",
                           "1", "--trace", "0"], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a host without one")
    out = _run_py(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_bare_benchmark_no_result(tmp_path):
    """A directory with only BENCHMARK.json and bench/ prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
