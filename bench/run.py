"""Run one cell of the benchmark of the port (``repro_torch``) on the
card this process finds, and print its result as the last line of
standard output.

    python3 bench/run.py --workload fem3d-b96.solve --seed 1 \
        --seconds 40 --trace 0

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled part of the
window. The numbers compared to decide ``correct`` close standard error,
each beside its limit. Exits non-zero, printing no result, without a
card (or with fewer than the cell asks for), and when JAX or the JAX
package is loaded in this process once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """The loaded modules whose top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line(device_index: int) -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return got.stdout.strip() or got.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed path inside
    # the checkout (the port's nvcc builds are under build/kernels)
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

    import torch
    from pselbench import harness
    from pselbench.cells import Bench
    from pselbench.stats import percentile

    bench = Bench(ROOT)
    chips = int(bench.entry(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_call = time.perf_counter()
    run = harness.run_cell(bench, args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device=device, t_start=T_START)
    res = harness.result(bench, run)
    bad = forbidden_modules()
    if bad:
        print(f"no result: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    res["card"] = card_line(device.index)
    print(f"{args.workload} seed {args.seed}: {res['card']}; setup "
          f"{run.setup_s:.2f} s (imports {t_call - T_START:.2f}, matrices "
          f"{run.matrices_s:.2f}, analyze {run.analyze_s:.2f}, prepare "
          f"{run.prepare_s:.2f}, first solve {run.first_solve_s:.2f}); "
          f"{run.calls} calls x {run.lanes} lanes in {run.window_s:.2f} s; "
          f"calls {run.traced_calls} traced; dispatch mean "
          f"{1e3 * sum(run.dispatch_s) / max(1, run.calls):.3f} ms over "
          f"all calls", file=sys.stderr)
    if run.calls:
        q = [percentile(run.call_s, x) * 1e3 for x in (0, 10, 50, 90, 100)]
        print("  call ms min/p10/p50/p90/max "
              + " / ".join(f"{x:.3f}" for x in q), file=sys.stderr)
    for name, m in res["metrics"].items():
        print(f"  {name} = {m['value']!r} {m['unit']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    checks = res.pop("checks")
    res["checks"] = checks
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
