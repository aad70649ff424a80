"""Record this checkout's benchmark rows in the port's perf history at
the root of the checkout (``BENCH_pselinv_torch.json``) — the twin of
``tools/record_bench.py``. Idempotent per ``--rev``: re-running replaces
that rev's entry in place.

    PYTHONPATH=src python -m repro_torch.tools.record_bench --rev PR19 \\
        [--only selinv,kernels,treecomm] [--device cuda] [--full]

The history is a JSON list of ``{"rev", "device", "card", "benches",
"failed"}`` entries. ``card`` is the card's ``nvidia-smi
--query-gpu=name,power.limit`` line; an entry taken with ``--device
cpu`` says ``cpu`` there, and its rows are host timings of the plain
versions, never the card's. The JAX package's ``BENCH_pselinv.json``
keeps its own (CPU) rows."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir, os.pardir, os.pardir))
OUT = os.path.join(ROOT, "BENCH_pselinv_torch.json")

#: the rows a successful selinv session must land — the JAX list with
#: the port's renames (``stream_compile_ms`` → ``stream_capture_ms``,
#: ``stream_hlo_bytes`` → ``stream_graph_kernels``, ``hlo_lint_ms`` →
#: ``exec_lint_ms``) and the size-baseline rows ``exec_verify`` reads
REQUIRED_SELINV = (
    {f"selinv/solve_batched_us_per_matrix_b{B}" for B in (1, 4, 16)}
    | {"selinv/engine_cache_hits", "selinv/stream_capture_ms",
       "selinv/stream_graph_kernels", "selinv/stream_us_per_call",
       "selinv/stream_wire_bytes", "selinv/stream_shifts_per_round",
       "selinv/plan_lint_ms", "selinv/bigmesh_8x4_lint_ms",
       "selinv/exec_lint_ms",
       "selinv/serve_p50_us", "selinv/serve_throughput_rps",
       "selinv/serve_batch_occupancy",
       "selinv/trace_overhead_pct", "selinv/round_p95_us",
       "selinv/inbound_skew_ratio",
       "selinv/sweep_stream_graph_kernels",
       "selinv/sweep_stream_dispatched_ops"})


def validate_rows(rows, *, where: str) -> None:
    """Every row a dict with a ``name`` string and a numeric
    ``us_per_call``."""
    for i, row in enumerate(rows):
        if not isinstance(row, dict) or not isinstance(
                row.get("name"), str) or not row["name"]:
            raise SystemExit(
                f"[bench] {where}: row {i} has no 'name' string: {row!r}")
        if not isinstance(row.get("us_per_call"), (int, float)) \
                or isinstance(row["us_per_call"], bool):
            raise SystemExit(
                f"[bench] {where}: row {i} ({row['name']}) has no "
                f"numeric 'us_per_call': {row.get('us_per_call')!r}")


def validate_history(hist) -> None:
    """Rev labels unique, every entry labelled with its device and card,
    every entry's rows well-formed."""
    seen = set()
    for entry in hist:
        rev = entry.get("rev")
        if rev in seen:
            raise SystemExit(f"[bench] history has duplicate rev {rev!r}")
        seen.add(rev)
        if entry.get("device") not in ("cuda", "cpu") or not entry.get(
                "card"):
            raise SystemExit(f"[bench] rev {rev!r} names no device and "
                             "card")
        validate_rows(entry.get("benches", []), where=f"rev {rev}")


def missing_rows(session, only) -> list:
    """Required rows absent from a session whose selinv bench ran and
    did not fail."""
    if "selinv" not in only or "selinv" in session["failed"]:
        return []
    names = {row["name"] for row in session["benches"]}
    return sorted(REQUIRED_SELINV - names)


def merge(hist: list, entry: dict) -> str:
    """Replace ``entry["rev"]``'s entry in ``hist`` in place, or append
    it; returns what it did."""
    for i, h in enumerate(hist):
        if h.get("rev") == entry["rev"]:
            hist[i] = entry
            return f"replaced rev {entry['rev']}"
    hist.append(entry)
    return f"appended rev {entry['rev']}"


def card_line(device: str) -> str:
    if device == "cpu":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default="selinv,kernels,treecomm",
                    help="comma list forwarded to repro_torch.benchmarks.run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rev", default=None,
                    help="label for this entry (default: git short rev)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--session", default=None, metavar="JSON",
                    help="record this benchmarks.run --json output "
                         "instead of running the benches")
    args = ap.parse_args(argv)
    only = args.only.split(",")

    card = card_line(args.device)
    rc = 0
    if args.session:
        with open(args.session) as f:
            session = json.load(f)
    else:
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH"))
            if p)
        cmd = [sys.executable, "-m", "repro_torch.benchmarks.run",
               "--only", args.only, "--json", tmp, "--device", args.device]
        if args.full:
            cmd.append("--full")
        rc = subprocess.run(cmd, cwd=ROOT, env=env).returncode
        # the driver writes the JSON (with its failed benches) even when
        # it exits non-zero: record the partial session
        try:
            with open(tmp) as f:
                session = json.load(f)
        except (OSError, json.JSONDecodeError):
            raise SystemExit(rc or 1)
        finally:
            os.unlink(tmp)
    if session.get("device", args.device) != args.device:
        raise SystemExit(f"[bench] session ran on {session['device']}, "
                         f"not --device {args.device}")
    validate_rows(session["benches"], where="session")
    missing = missing_rows(session, only)
    if missing:
        raise SystemExit(f"[bench] selinv session is missing required "
                         f"rows: {missing}")

    hist = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            hist = json.load(f)
    entry = {"rev": args.rev or git_rev(), "device": args.device,
             "card": card, "benches": session["benches"],
             "failed": session["failed"]}
    action = merge(hist, entry)
    validate_history(hist)
    with open(args.out, "w") as f:
        json.dump(hist, f, indent=1)
        f.write("\n")
    print(f"[bench] {action} ({len(session['benches'])} rows, {card}) in "
          f"{args.out}; history={len(hist)} entries")
    if rc or session["failed"]:
        raise SystemExit(rc or 1)      # recorded, but still a failure


if __name__ == "__main__":
    main()
