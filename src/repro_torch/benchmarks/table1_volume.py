"""Paper Table 1: Col-Bcast outgoing-volume stats (min/max/median/σ) per
rank for Flat / Binary / Shifted Binary trees — audikw_1-like matrix on a
64×64 grid; the port's copy of ``benchmarks/table1_volume.py`` over the
port's ``symbolic`` and ``simulator`` (host code, no card). Validation
targets: binary max/σ > flat; shifted σ < flat σ, shifted max < flat
max, shifted min > flat min."""
from __future__ import annotations

import csv
import os
import time

from ..core import sparse
from ..core.schedule import Grid2D
from ..core.simulator import volume_stats, volumes_fast
from ..core.symbolic import symbolic_factorize_elements
from ..core.trees import TreeKind
from .common import csv_row, ensure_out


def run(full: bool = False, dims=None):
    """``dims`` overrides the FEM-like structure's (nx, ny, nz)."""
    dims = dims or ((32, 32, 32) if full else (20, 20, 20))
    cap = 12
    G, sizes = sparse.fem3d_like_structure(*dims, 3)
    bs = symbolic_factorize_elements(G, sizes, max_supernode=cap)
    grid = Grid2D(64, 64)

    out = ensure_out()
    rows = []
    stats = {}
    for kind in (TreeKind.FLAT, TreeKind.BINARY, TreeKind.SHIFTED,
                 TreeKind.HYBRID):
        t0 = time.perf_counter()
        v = volumes_fast(bs, grid, kind)
        dt = time.perf_counter() - t0
        s = volume_stats(v["col-bcast"] / 1e6)
        stats[kind.value] = s
        rows.append([kind.value] + [round(s[k], 3) for k in
                                    ("min", "max", "median", "std")])
        csv_row(f"table1/{kind.value}", dt * 1e6,
                f"minMB={s['min']:.1f} maxMB={s['max']:.1f} "
                f"medMB={s['median']:.1f} stdMB={s['std']:.2f}")

    with open(os.path.join(out, "table1_volume.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tree", "min_mb", "max_mb", "median_mb", "std_mb"])
        w.writerows(rows)

    flat, binry, shift = (stats["flat"], stats["binary"], stats["shifted"])
    checks = {
        "binary_max_worse_than_flat": binry["max"] > flat["max"],
        "binary_std_worse_than_flat": binry["std"] > flat["std"],
        "shifted_std_better_than_flat": shift["std"] < flat["std"],
        "shifted_max_better_than_flat": shift["max"] < flat["max"],
        "shifted_min_better_than_flat": shift["min"] > flat["min"],
    }
    csv_row("table1/claims", 0.0,
            " ".join(f"{k}={v}" for k, v in checks.items()))
    return stats, checks


if __name__ == "__main__":
    run(full=True)
