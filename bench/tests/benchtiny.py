"""A checkout of the benchmark with a tiny cell added as files, for the
CPU tests: the real ``BENCHMARK.json`` and ``bench/`` parts copied,
a configuration ``tiny-fem`` (fem3d_like(4, 4, 4, 3), b = 24, grid 2×2)
and its cells ``tiny-fem.solve`` (1 lane) and ``tiny-fem.poles4`` (4
lanes) added beside them, and no file edited."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_CONFIG = {
    "name": "tiny-fem", "source": "a test size of the fem3d-b96 stand-in",
    "generator": "fem3d_like",
    "params": {"nx": 4, "ny": 4, "nz": 4, "block": 3},
    "n": 192, "b": 24, "process_grid": [2, 2], "options": {},
    "dtype": "float64",
    "checks": {"rel_gap": 1e-10}, "reduced": {}, "assumed": {},
}
TINY_CELLS = {"tiny-fem.solve": 1, "tiny-fem.poles4": 4}


def tiny_root(tmp: Path) -> Path:
    """Copy the benchmark under ``tmp`` and add the tiny configuration and
    cells as new files and new ``BENCHMARK.json`` entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "bench" / "configs" / "tiny-fem.json").write_text(
        json.dumps(TINY_CONFIG))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-fem", "source": "test size",
                            "file": "bench/configs/tiny-fem.json",
                            "reduced": [], "why": "CPU tests"})
    for cell, batch in TINY_CELLS.items():
        traffic = cell.split(".", 1)[1]
        (tmp / "bench" / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": "tiny-fem", "traffic": traffic,
             "driver": "closed_loop", "batch": batch, "value_sets": 1,
             "clients": 1, "trace_calls": 2}))
        spec["workloads"].append({"name": cell, "config": "tiny-fem",
                                  "traffic": traffic, "chips": 1,
                                  "why": "CPU tests"})
        for m in spec["per_layer"] + spec["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
