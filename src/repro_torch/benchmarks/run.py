"""Benchmark driver — the port's twin of ``benchmarks/run.py``: one
module per paper table/figure plus the kernel, selected-inversion and
tree-collective benches. Prints ``name,us_per_call,derived`` CSV rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] \\
        [--json PATH] [--only table1,fig5,...] [--device cpu]

``--full`` uses paper-scale structures (``fig8`` then simulates
6400-rank grids on the host for minutes). ``--device`` (default
``cuda``) is where ``kernels``, ``selinv`` and ``treecomm`` run; the
table and figure benches are host models and ignore it. ``--json``
writes every row ({name, us_per_call, derived}), the failed benches and
the device — ``repro_torch.tools.record_bench`` appends it to
``BENCH_pselinv_torch.json``."""
from __future__ import annotations

import argparse
import json
import sys
import traceback


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write all rows as JSON")
    ap.add_argument("--only", default=None,
                    help="comma list: table1,fig5,fig8,fig9,kernels,"
                         "selinv,treecomm")
    ap.add_argument("--device", default="cuda",
                    help="where kernels, selinv and treecomm run "
                         "(default cuda)")
    args = ap.parse_args(argv)

    from . import (fig5_heatmap, fig8_scaling, fig9_ratio, kernels_bench,
                   pselinv_bench, table1_volume, treecomm_bench)
    from .common import RESULTS

    host = {"table1": table1_volume.run, "fig5": fig5_heatmap.run,
            "fig8": fig8_scaling.run, "fig9": fig9_ratio.run}
    card = {"kernels": kernels_bench.run, "selinv": pselinv_bench.run,
            "treecomm": treecomm_bench.run}
    names = list(host) + list(card)
    selected = args.only.split(",") if args.only else names
    unknown = sorted(set(selected) - set(names))
    if unknown:
        ap.error(f"unknown bench(es) {unknown}; choose from {names}")

    print("name,us_per_call,derived")
    failed = []
    for name in selected:
        try:
            if name in host:
                host[name](full=args.full)
            else:
                card[name](full=args.full, device=args.device)
        except Exception as e:
            traceback.print_exc()
            failed.append((name, repr(e)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"benches": RESULTS, "failed": [n for n, _ in failed],
                       "device": args.device}, f, indent=2)
        print(f"[bench] wrote {len(RESULTS)} rows to {args.json}",
              file=sys.stderr)
    if failed:
        for name, err in failed:
            print(f"{name},FAILED,{err}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
