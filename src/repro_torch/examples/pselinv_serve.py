"""Batched serving with ``SelInvServer``: structure-keyed coalescing over
a mixed request stream — the twin of ``examples/pselinv_serve.py``.

Each submitted matrix is fingerprinted by sparsity pattern, coalesced
with same-structure neighbours under a dynamic batch window (flush on a
full bucket, the max wait, or queue pressure), padded to a power-of-2
bucket so odd batch sizes replay captured graphs, and answered through
a per-request future.

    PYTHONPATH=src python -m repro_torch.examples.pselinv_serve [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..core import sparse
from ..core.engine import Grid, PSelInvEngine
from ..serve import BatchWindow, SelInvServer, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    PSelInvEngine.clear_cache()

    # 1. a server: engine parameters + the dynamic batch window
    cfg = ServeConfig(b=8, grid=Grid(4, 2), dtype=torch.float64,
                      device=args.device,
                      window=BatchWindow(max_batch=16, max_wait_ms=2.0,
                                         pressure=64))

    # 2. mixed traffic: two sparsity structures, shifted values — the
    #    server coalesces per structure, never across
    A = sparse.laplacian_2d(16, 8)
    B = sparse.laplacian_2d(24, 8)
    I_A, I_B = sp.identity(A.shape[0]), sp.identity(B.shape[0])
    stream = [A + 0.1 * (i + 1) * I_A if i % 3 else B + 0.1 * (i + 1) * I_B
              for i in range(40)]

    # 3. serve it: the context manager runs the background worker;
    #    submit() returns a future at once
    with SelInvServer(cfg) as srv:
        t0 = time.perf_counter()
        reqs = [srv.submit(M) for M in stream]
        outs = [np.asarray(r.result(timeout=300)) for r in reqs]
        wall = time.perf_counter() - t0
        stats = srv.stats()

    print(f"served {len(stream)} requests on {args.device} in {wall:.2f}s "
          f"({wall / len(stream) * 1e3:.2f} ms/matrix, captures included) "
          f"in {stats['batches']} batches")
    print(f"  latency p50/p95/p99: {stats['latency_p50_us'] / 1e3:.1f} / "
          f"{stats['latency_p95_us'] / 1e3:.1f} / "
          f"{stats['latency_p99_us'] / 1e3:.1f} ms")
    print(f"  batch sizes {stats['batch_size_hist']} rode buckets "
          f"{stats['batch_bucket_hist']} "
          f"(occupancy {stats['batch_occupancy_mean']:.2f})")
    for skey, s in stats["structures"].items():
        print(f"  structure {skey}: buckets {s['buckets_used']} -> "
              f"{s['trace_count']} captures for {s['solve_calls']} "
              f"batched solves")

    # 4. every served result is the matrix's own selected inverse —
    #    equal to an unbatched engine.solve of the same matrix
    eng = srv.engine_for(stream[0])
    ref = eng.solve(stream[0], dtype=torch.float64).cpu().numpy()
    print(f"  |served - unbatched| = {abs(outs[0] - ref).max():.2e}")


if __name__ == "__main__":
    main()
