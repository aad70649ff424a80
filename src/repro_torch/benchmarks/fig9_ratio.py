"""Paper Fig 9: communication vs computation time at 256 and 4096 ranks,
flat vs shifted — the dense (DG-like) matrix, on the α-β model (a Cray
XC30, not the card); the port's copy of ``benchmarks/fig9_ratio.py``.
Paper: comm/comp drops from 11.8 (flat) to 1.9 (shifted) at 4096
ranks."""
from __future__ import annotations

import csv
import os
import time

from ..core import sparse
from ..core.schedule import Grid2D
from ..core.simulator import NetworkModel, simulate
from ..core.symbolic import symbolic_factorize_elements
from ..core.trees import TreeKind
from .common import csv_row, ensure_out


def run(full: bool = False, atoms=None):
    """``atoms`` overrides the DG-like structure's (atoms_x, atoms_y,
    block)."""
    out = ensure_out()
    atoms = atoms or ((36, 36, 12) if full else (24, 24, 12))
    G, sizes = sparse.dg_like_structure(*atoms)
    bs = symbolic_factorize_elements(G, sizes, max_supernode=36)
    rows = []
    ratios = {}
    for P, (pr, pc) in {256: (16, 16), 4096: (64, 64)}.items():
        grid = Grid2D(pr, pc)
        for kind in (TreeKind.FLAT, TreeKind.SHIFTED, TreeKind.HYBRID):
            t0 = time.perf_counter()
            res = simulate(bs, grid, kind, NetworkModel())
            dt = time.perf_counter() - t0
            ratio = res.comm_to_comp_ratio()
            ratios[(P, kind.value)] = ratio
            rows.append([P, kind.value, res.total_time, ratio])
            csv_row(f"fig9/p{P}/{kind.value}", dt * 1e6,
                    f"total={res.total_time:.4f}s comm/comp={ratio:.2f}")
    with open(os.path.join(out, "fig9_ratio.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ranks", "tree", "sim_time_s", "comm_comp_ratio"])
        w.writerows(rows)
    return ratios


if __name__ == "__main__":
    run(full=True)
