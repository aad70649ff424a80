"""Serving-layer benchmark — the twin of ``tools/serve_bench.py``:
synthetic mixed-structure Poisson traffic through
``repro_torch.serve.SelInvServer``, in f64.

Runs the acceptance harness (``repro_torch.serve.traffic.run_traffic``):
cold pass → one capture per (structure, bucket) off the session
counters → warm timed pass → warm sequential baseline over the same
matrices → identity check within 1e-12 — then prints the serving
scorecard:

    PYTHONPATH=src python -m repro_torch.tools.serve_bench --grid 4x2 \\
        [--requests 120] [--structures 2] [--rate 4000] [--burst] \\
        [--device cpu] [--json out.json]

``repro_torch.benchmarks.pselinv_bench`` drives the same harness for
the recorded rows; this CLI is the standalone entry point."""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="mixed-structure serving benchmark")
    ap.add_argument("--requests", type=int, default=120,
                    help="trace length (acceptance floor: 100)")
    ap.add_argument("--structures", type=int, default=2,
                    help="distinct block structures in the mix (>= 2)")
    ap.add_argument("--rate", type=float, default=4000.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--burst", action="store_true",
                    help="submit with zero gaps instead of Poisson")
    ap.add_argument("--grid", default="1x1",
                    help="process grid PRxPC (e.g. 4x2)")
    ap.add_argument("--b", type=int, default=8, help="supernode width")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--pressure", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1,
                    help="repeat each timed pass, keep the best wall")
    ap.add_argument("--min-speedup", type=float, default=None,
                    help="fail unless coalesced serving beats the "
                         "sequential baseline by this factor")
    ap.add_argument("--device", default="cuda",
                    help="where the sessions run (default cuda)")
    ap.add_argument("--json", default=None,
                    help="also dump the full result dict to this path")
    args = ap.parse_args(argv)

    import torch

    from ..core.engine import Grid
    from ..serve.batcher import BatchWindow
    from ..serve.traffic import run_traffic

    pr, pc = (int(x) for x in args.grid.lower().split("x"))
    tol = 1e-12
    res = run_traffic(
        n_requests=args.requests, n_structures=args.structures,
        rate_hz=(None if args.burst else args.rate), seed=args.seed,
        b=args.b, grid=Grid(pr, pc),
        window=BatchWindow(max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           pressure=args.pressure),
        dtype=torch.float64, device=args.device, check_identity=True,
        tol=tol, reps=args.reps,
        log=lambda s: print(f"[serve-bench] {s}", flush=True))

    print(f"[serve-bench] {res['n_requests']} requests, "
          f"{res['n_structures']} structures, grid {pr}x{pc}, "
          f"device {args.device}")
    print(f"  serve:    {res['serve_per_matrix_us']:9.1f} us/matrix  "
          f"({res['serve_throughput_rps']:.0f} rps, "
          f"{res['batches']} batches, occupancy "
          f"{res['serve_batch_occupancy']:.2f})")
    print(f"  baseline: {res['baseline_per_matrix_us']:9.1f} us/matrix")
    print(f"  speedup:  {res['speedup']:9.2f}x")
    print(f"  latency:  p50 {res['serve_p50_us']:.0f} us   p95 "
          f"{res['serve_p95_us']:.0f} us   p99 "
          f"{res['serve_p99_us']:.0f} us")
    print(f"  identity: max |serve - unbatched| = "
          f"{res['identity_max_abs']:.2e} (tol {tol:g})")
    print("  captures: "
          + "  ".join(f"{k}: {t} captures / {b} buckets"
                      for k, (t, b) in res["conformance"].items()))

    if args.json:
        with open(args.json, "w") as f:
            json.dump({k: v for k, v in res.items() if k != "stats"},
                      f, indent=1, default=str)
        print(f"[serve-bench] wrote {args.json}")

    if args.min_speedup and res["speedup"] < args.min_speedup:
        print(f"[serve-bench] FAIL: speedup {res['speedup']:.2f}x < "
              f"{args.min_speedup}x", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
