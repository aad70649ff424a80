"""SweepScope CLI — the port's twin of ``tools/obs_report.py``: trace a
Laplacian's solve, profile its sweep round by round, and write a
Chrome-trace/Perfetto file plus the inbound-imbalance table.

- enables the span tracer (``repro_torch.obs.trace``) and runs
  ``PSelInvEngine.analyze`` → ``prepare_values`` → ``solve``, so the
  host spans (plan, upload, factorization, solve dispatch) land in its
  buffer;
- profiles the overlapped sweep through ``engine.profile_rounds()`` —
  on the card the device time of each round of the captured graph, on
  the CPU each segment timed on the host — joining the times against
  the plan's wire tables and the α-β model (a Cray XC30, not the card);
- on the CPU, writes spans, the round timeline with per-rank inbound
  bytes and, with ``--serve N``, N served requests' lifecycles, to one
  ``*.trace.json`` (``chrome://tracing``, ``ui.perfetto.dev``) through
  ``obs/export.py``, each source on its own clock;
- on the card, runs one more solve under ``torch.profiler`` and writes
  its trace, one clock for all: the spans (as the profiler's ranges),
  the device operations, and two lanes of the graph's phase map
  (:mod:`repro_torch.obs.graphmap`): one of phases, one of rounds with
  each round's permute bytes; and prints its device time by group of
  phases (``graphmap.split``). Served requests (``--serve``) are timed
  on the host's monotonic clock and stay out of it;
- prints ``RoundProfile.report()``.

All ranks run on one device, so nothing re-executes for a device count.
Exits non-zero iff the measured inbound-byte skew (max rank / mean
rank) exceeds ``--skew-threshold`` (default: PlanLint's static
``verify.IMBALANCE_MAX``).

    PYTHONPATH=src python -m repro_torch.tools.obs_report [--device cpu]
    PYTHONPATH=src python -m repro_torch.tools.obs_report --nb 32 --chunk 4
    PYTHONPATH=src python -m repro_torch.tools.obs_report --serve 24 \\
        -o sweep.trace.json
"""
from __future__ import annotations

import argparse
import json


def _serve_lanes(n: int, device):
    """``n`` mixed-structure requests through a worker-threaded
    ``SelInvServer`` (grid 1×1: structure coalescing, not a grid);
    returns the completed requests for the exporter's lifecycle
    lanes."""
    import scipy.sparse as sp

    from ..core import sparse
    from ..core.engine import Grid
    from ..serve.batcher import BatchWindow
    from ..serve.server import SelInvServer, ServeConfig

    mats = [sp.csr_matrix(sparse.laplacian_2d(nx, 4) +
                          sp.eye(nx * 4) * 0.1) for nx in (8, 12)]
    cfg = ServeConfig(b=4, grid=Grid(1, 1), device=device,
                      window=BatchWindow(max_batch=8, max_wait_ms=2.0))
    with SelInvServer(cfg) as srv:
        reqs = [srv.submit(mats[i % len(mats)]) for i in range(n)]
        srv.drain(timeout=120.0)
        for r in reqs:
            r.result(timeout=120.0)
        return srv.recent_requests()


#: the trace's process of the phase and round lanes
_PID_GRAPH = 1 << 20


def _device_trace(out: str, solve, dev) -> None:
    """``solve()`` once under ``torch.profiler`` (host and device), its
    trace written to ``out`` with the lanes of the graph's phase map."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..obs import graphmap

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize(dev)
    doc = graphmap.trace_of(prof)
    doc["traceEvents"] += graphmap.lanes(doc["traceEvents"], _PID_GRAPH)
    with open(out, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    got = graphmap.split(graphmap.attribute(doc["traceEvents"]))
    if got is not None:
        print("[obs-report] device ms of the traced solve: " + ", ".join(
            f"{k} {1e3 * v:.3f}" for k, v in got.items()))


def run_case(nb: int, pr: int, pc: int, *, chunk: int, reps: int,
             serve: int, out: str, skew_threshold: float,
             device="cuda") -> int:
    import scipy.sparse as sp
    import torch

    from ..core import sparse
    from ..core.device import resolve_device
    from ..core.engine import Grid, PSelInvEngine
    from ..obs.export import write_trace
    from ..obs.trace import TRACER

    dev = resolve_device(device)
    TRACER.enable()
    try:
        A = sp.csr_matrix(sparse.laplacian_2d(nb, 8))
        eng = PSelInvEngine.analyze(A, b=8, grid=Grid(pr, pc), device=dev)
        vals = eng.prepare_values(A)
        eng.solve(vals)                      # warm + span-recorded
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        profile = eng.profile_rounds(vals, chunk=chunk, reps=reps)
        requests = _serve_lanes(serve, dev) if serve else None
        if dev.type == "cuda":
            _device_trace(out, lambda: eng.solve(vals), dev)
    finally:
        TRACER.disable()

    if dev.type != "cuda":
        write_trace(out, spans=TRACER.spans(), profile=profile,
                    requests=requests)
    with open(out) as f:
        nev = len(json.load(f)["traceEvents"])
    print(f"[obs-report] laplacian_2d({nb},8) b=8 grid {pr}x{pc} on "
          f"{dev}: {len(TRACER.spans())} span(s), {profile.nrounds} "
          f"round(s)" + (f", {len(requests)} request(s)" if requests
                         else ""))
    print(f"[obs-report] wrote {out} ({nev} trace events"
          + (", one clock" if dev.type == "cuda" else "") + ")")
    print()
    print(profile.report())

    ratio = profile.skew()["skew_ratio"]
    if ratio > skew_threshold:
        print(f"[obs-report] FAIL: measured inbound-byte skew "
              f"{ratio:.2f}x exceeds threshold {skew_threshold:.2f}x")
        return 1
    print(f"[obs-report] OK: measured inbound-byte skew {ratio:.2f}x "
          f"<= threshold {skew_threshold:.2f}x")
    return 0


def main(argv=None) -> int:
    from ..core.verify import IMBALANCE_MAX

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nb", type=int, default=16,
                    help="supernode grid size: laplacian_2d(nb, 8) at "
                         "b=8 (default 16)")
    ap.add_argument("--grid", default="4x2",
                    help="PRxPC process grid (default 4x2)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="rounds per replay segment (default 1)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed replay passes, per-segment min kept "
                         "(default 3)")
    ap.add_argument("--serve", type=int, default=0,
                    help="also serve N requests through a SelInvServer "
                         "and export their lifecycle lanes (default 0)")
    ap.add_argument("-o", "--out", default="selinv.trace.json",
                    help="output trace path (default selinv.trace.json)")
    ap.add_argument("--skew-threshold", type=float, default=IMBALANCE_MAX,
                    help="fail when measured max/mean inbound-byte skew "
                         "exceeds this ratio (default: PlanLint's "
                         f"static IMBALANCE_MAX = {IMBALANCE_MAX})")
    ap.add_argument("--device", default="cuda",
                    help="where the session runs (default cuda)")
    args = ap.parse_args(argv)
    pr, pc = (int(x) for x in args.grid.lower().split("x"))
    return run_case(args.nb, pr, pc, chunk=args.chunk, reps=args.reps,
                    serve=args.serve, out=args.out,
                    skew_threshold=args.skew_threshold, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
