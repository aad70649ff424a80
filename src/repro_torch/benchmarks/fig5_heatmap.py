"""Paper Figs 4–7: communication-volume heat maps (per-rank volume laid
out on the Pr×Pc grid) for Col-Bcast (sent) and Row-Reduce (received),
per tree scheme — the port's copy of ``benchmarks/fig5_heatmap.py``
(host code, no card). Emits CSV grids under ``build/bench_out/``."""
from __future__ import annotations

import os
import time

import numpy as np

from ..core import sparse
from ..core.schedule import Grid2D
from ..core.simulator import volumes_fast
from ..core.symbolic import symbolic_factorize_elements
from ..core.trees import TreeKind
from .common import csv_row, ensure_out


def run(full: bool = False, dims=None):
    """``dims`` overrides the FEM-like structure's (nx, ny, nz)."""
    dims = dims or ((32, 32, 32) if full else (20, 20, 20))
    G, sizes = sparse.fem3d_like_structure(*dims, 3)
    bs = symbolic_factorize_elements(G, sizes, max_supernode=12)
    out = ensure_out()

    # Fig 5 (4096 ranks) and Fig 6 (256 ranks, flat — imbalance shrinks)
    for grid, kinds, tag in [
        (Grid2D(64, 64), (TreeKind.FLAT, TreeKind.BINARY, TreeKind.SHIFTED),
         "fig5"),
        (Grid2D(16, 16), (TreeKind.FLAT,), "fig6"),
    ]:
        for kind in kinds:
            t0 = time.perf_counter()
            v = volumes_fast(bs, grid, kind)
            dt = time.perf_counter() - t0
            for op, key in [("colbcast", "col-bcast"),
                            ("rowreduce", "row-reduce")]:
                gridvals = v[key].reshape(grid.pr, grid.pc) / 1e6
                path = os.path.join(out, f"{tag}_{kind.value}_{op}.csv")
                np.savetxt(path, gridvals, delimiter=",", fmt="%.3f")
            rel = v["col-bcast"].std() / max(v["col-bcast"].mean(), 1e-12)
            csv_row(f"{tag}/{kind.value}", dt * 1e6,
                    f"relstd={rel:.3f} ranks={grid.size}")
    return True


if __name__ == "__main__":
    run(full=True)
