"""The control of the check: the cell's runs with the port's own lower
precision switched on (``engine.solve(..., dtype=torch.float32)`` where
the configuration states float64), one run a seed, all in this process.
Each run must come out not ``correct``; the benchmark's own runs never
run this.

    python3 bench/control.py --workload fem3d-b96.solve \
        --seeds 11,12,13 --seconds 3

Prints one JSON line a seed (its ``rel_gap`` beside the limit) and exits
non-zero if any control run came out ``correct``.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one control run each")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

    import torch
    from pselbench import harness
    from pselbench.cells import Bench

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.run_cell(bench, args.workload, seed=seed,
                               seconds=args.seconds, trace=False,
                               device=torch.device("cuda", 0),
                               t_start=time.perf_counter(),
                               solve_dtype=torch.float32)
        res = harness.result(bench, run)
        passed += res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "float32", "correct": res["correct"],
                          "calls": run.calls, **res["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
