"""Paper Fig 8: strong scaling of PSelInv with Flat / Binary / Shifted
trees on both matrix classes, plus run-to-run variability from network
inhomogeneity (jittered per-node-pair bandwidths) — discrete-event
simulation on the Edison-like α-β model, the port's copy of
``benchmarks/fig8_scaling.py`` (host code; at ``--full`` it simulates
6400-rank grids for minutes, so it stays off the card runs).

Validation targets: flat-tree scalability stalls around ~1k ranks;
shifted keeps improving to 6400 with multi-× speedup over flat at scale;
shifted's run-to-run σ is lower than flat's."""
from __future__ import annotations

import csv
import os
import time

import numpy as np

from ..core import sparse
from ..core.schedule import Grid2D
from ..core.simulator import NetworkModel, simulate
from ..core.symbolic import symbolic_factorize_elements
from ..core.trees import TreeKind
from .common import csv_row, ensure_out

GRIDS = {256: (16, 16), 1024: (32, 32), 4096: (64, 64), 6400: (80, 80)}
KINDS = (TreeKind.FLAT, TreeKind.BINARY, TreeKind.SHIFTED)


def matrices(full: bool):
    if full:
        return {
            "dg_like": sparse.dg_like_structure(36, 36, 12),
            "fem_like": sparse.fem3d_like_structure(24, 24, 24, 3),
        }, {"dg_like": 36, "fem_like": 12}
    return {
        "dg_like": sparse.dg_like_structure(24, 24, 12),
        "fem_like": sparse.fem3d_like_structure(16, 16, 16, 3),
    }, {"dg_like": 36, "fem_like": 12}


def run(full: bool = False, seeds=(0, 1, 2), grids=None, kinds=KINDS,
        mats=None):
    """``grids`` ({ranks: (pr, pc)}), ``kinds`` and ``mats`` (({name:
    (G, sizes)}, {name: max_supernode})) override the sweep."""
    out = ensure_out()
    grids = grids or GRIDS
    mats, caps = mats or matrices(full)
    rows = []
    summary = {}
    for mname, (G, sizes) in mats.items():
        bs = symbolic_factorize_elements(G, sizes,
                                         max_supernode=caps[mname])
        for P, (pr, pc) in grids.items():
            grid = Grid2D(pr, pc)
            for kind in kinds:
                times = []
                t0 = time.perf_counter()
                for seed in seeds:
                    model = NetworkModel(jitter_sigma=0.3,
                                         placement_seed=seed)
                    res = simulate(bs, grid, kind, model)
                    times.append(res.total_time)
                dt = time.perf_counter() - t0
                mean, std = float(np.mean(times)), float(np.std(times))
                rows.append([mname, P, kind.value, mean, std])
                summary[(mname, P, kind.value)] = mean
                csv_row(f"fig8/{mname}/p{P}/{kind.value}", dt * 1e6,
                        f"simtime={mean:.4f}s runstd={std:.4f}")

    with open(os.path.join(out, "fig8_scaling.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["matrix", "ranks", "tree", "sim_time_s", "run_std_s"])
        w.writerows(rows)

    names = {k.value for k in kinds}
    if {"flat", "shifted"} <= names:
        for mname in mats:
            sp = {P: summary[(mname, P, "flat")]
                  / summary[(mname, P, "shifted")] for P in grids}
            csv_row(f"fig8/{mname}/speedup_shifted_vs_flat", 0.0,
                    " ".join(f"p{P}={v:.2f}x" for P, v in sp.items()))
    return summary


if __name__ == "__main__":
    run(full=True)
