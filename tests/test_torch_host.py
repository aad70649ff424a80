"""The port's host half against the JAX package's, on the CPU.

On ``laplacian_2d(16, 8)``, b=8, grid 4×2 and default options, the
port's own copy of the planner must lower the same overlapped schedule,
array for array; its PlanLint must pass; its value preparation must be
bitwise the JAX package's; and its device-table upload must hold the
invariants the sweep relies on (bounds, trash-only duplicate scatters).
The port itself imports neither JAX nor the JAX package."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import pselinv_dist as jdist
from repro.core import sparse as jsparse
from repro.core.engine import structure_key as jkey
from repro.core.schedule import BYTES_PER_ELT
from repro_torch.core import pselinv_dist as tdist
from repro_torch.core.engine import structure_key as tkey
from repro_torch.core.plan import PlanOptions
from repro_torch.core.verify import verify_program

ROOT = Path(__file__).resolve().parents[1]
GRID = (4, 2)


@pytest.fixture(scope="module")
def progs():
    A = sp.csr_matrix(jsparse.laplacian_2d(16, 8))
    jbs, jnb = jdist.analyze_structure(A, 8, *GRID)
    tbs, tnb = tdist.analyze_structure(A, 8, *GRID)
    from repro.core.plan import PlanOptions as JOptions
    jp = jdist.build_program(jbs, jnb, 8, *GRID, options=JOptions())
    tp = tdist.build_program(tbs, tnb, 8, *GRID, options=PlanOptions())
    return A, jp, tp


def _assert_same(a, b, path):
    """Structural equality across the two packages' twin dataclasses:
    same class name, same fields, arrays equal in value and dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "name") and hasattr(a, "value"):          # enums
        assert (a.name, a.value) == (b.name, b.value), path
    else:
        assert a == b, (path, a, b)


def test_overlapped_tables_equal_the_jax_package(progs):
    _, jp, tp = progs
    jov, tov = jp.overlap_plan, tp.overlap_plan
    for name in ("nb", "pr", "pc", "n_ainv", "arena_blocks", "trash",
                 "diag_set_root", "diag_set_slot", "window"):
        _assert_same(getattr(jov, name), getattr(tov, name), name)
    _assert_same(jov.levels, tov.levels, "levels")       # OverlapLevel
    _assert_same(jov.rounds, tov.rounds, "rounds")       # GlobalRound
    _assert_same(jov.compute_at, tov.compute_at, "compute_at")
    _assert_same(jp.plan.ops, tp.plan.ops, "plan.ops")


def test_rounds_and_executed_wire_bytes(progs):
    _, _, tp = progs
    ov = tp.overlap_plan
    assert len(ov.rounds) == 28
    wire = sum(len(r.perm) * r.width * tp.b * tp.b * BYTES_PER_ELT
               for r in ov.rounds)
    assert wire == 177152


def test_planlint_clean(progs):
    _, _, tp = progs
    diags = verify_program(tp)
    assert not [d for d in diags if d.severity == "error"], diags


def test_structure_key_equal(progs):
    _, jp, tp = progs
    assert jkey(jp.bs) == tkey(tp.bs)


def test_prepare_values_bitwise(progs):
    A, jp, tp = progs
    jv = jdist.prepare_values(A, jp.bs, jp.nb, 8, *GRID)
    tv = tdist.prepare_values(A, tp.bs, tp.nb, 8, *GRID)
    mats = [A, A + sp.identity(A.shape[0]), 2 * A]
    jm = jdist.prepare_values_many(mats, jp.bs, jp.nb, 8, *GRID)
    tm = tdist.prepare_values_many(mats, tp.bs, tp.nb, 8, *GRID)
    for x, y in zip(jv + jm, tv + tm):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_upload_checks_bounds_and_trash_only_duplicates(progs):
    _, _, tp = progs
    ov = tp.overlap_plan
    tabs = tdist.upload_tables(tp, "cpu")
    assert len(tabs.comm) == len(ov.rounds) == len(tabs.local)
    # the schedule really has repeated scatter indices — all trash
    reps = 0
    for rnd in ov.rounds:
        for row in rnd.scatter:
            vals, counts = np.unique(row, return_counts=True)
            assert set(vals[counts > 1]) <= {ov.trash}
            reps += int((counts > 1).sum())
    assert reps > 0
    # a round whose lanes write one real slot twice is refused
    t = next(i for i, r in enumerate(ov.rounds) if r.width >= 2)
    bad = ov.rounds[t].scatter.copy()
    bad[:, 1] = bad[:, 0] = 0
    with pytest.raises(ValueError, match="twice"):
        tdist._dupes_are_trash("permute", t, bad, ov.trash)
    # an index past the arena is refused before any sweep runs
    with pytest.raises(ValueError, match="outside"):
        tdist._in_bounds("gather", np.array([0, ov.arena_blocks]),
                         ov.arena_blocks)


def test_gather_blocks_roundtrip(progs):
    """``gather_blocks`` inverts the shard layout for numpy and torch."""
    _, _, tp = progs
    nb, b = tp.nb, tp.b
    G = np.arange(nb * nb * b * b, dtype=np.float64).reshape(nb, nb, b, b)
    S = tdist._shard_blocks(G, nb, b, *GRID)
    assert np.array_equal(tdist.gather_blocks(S, tp), G)
    assert torch.equal(tdist.gather_blocks(torch.from_numpy(S), tp),
                       torch.from_numpy(G))
    assert np.array_equal(jdist.gather_blocks(S, tp), G)


def test_port_imports_neither_jax_nor_repro():
    code = """
import pkgutil, importlib, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print(len(mods), "modules")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[0]) >= 18
