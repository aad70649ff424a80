"""Analyze once / solve many with the ``PSelInvEngine`` session API — the
twin of ``examples/pselinv_engine.py``.

One symbolic analysis (trees, rounds, tables uploaded to the device)
serves a whole stream of matrices that share a sparsity structure; on
the card each shape class is captured once as a CUDA graph and
replayed. Values move; structure does not.

    PYTHONPATH=src python -m repro_torch.examples.pselinv_engine [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..core import sparse
from ..core.engine import Grid, PlanOptions, PSelInvEngine
from ..core.pselinv_dist import gather_blocks
from ..core.selinv import dense_selinv_oracle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    A = sparse.laplacian_2d(16, 8)

    # 1. analyze ONCE: symbolic factorization -> CommPlan IR ->
    #    overlapped round schedule -> device tables. The session is
    #    cached on (structure, b, grid, options, device).
    t0 = time.perf_counter()
    opts = PlanOptions(overlap=True, coalesce_max=8)
    engine = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), options=opts,
                                   device=dev)
    stats = engine.stats()
    print(f"analyze: {time.perf_counter() - t0:.2f}s  "
          f"rounds={stats['ppermute_rounds']} "
          f"peak_arena_blocks={stats['peak_arena_blocks']}")
    again = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), options=opts,
                                  device=dev)
    print(f"re-analyze is cached: {again is engine} "
          f"(hits={PSelInvEngine.cache_hits})")

    # 2. solve MANY: same structure, other values — one batched sweep
    mats = [A + sp.identity(A.shape[0]) * c for c in (0.0, 0.5, 1.0, 2.0)]
    t0 = time.perf_counter()
    outs = engine.solve_many(mats, dtype=torch.float64).cpu().numpy()
    print(f"solve_many(B={len(mats)}): {time.perf_counter() - t0:.2f}s  "
          f"out shape {outs.shape}  captures={engine.trace_count}")

    # 3. each batch member is a real selected inverse
    for i, M in enumerate(mats):
        ref = dense_selinv_oracle(M)
        err = abs(gather_blocks(outs[i], engine)[0, 0] - ref[:8, :8]).max()
        print(f"  matrix {i}: |A^-1(0,0) - oracle| = {err:.2e}")

    # 4. the cached plan answers timing questions on the α-β model
    sim = engine.simulate()
    print(f"simulated sweep time: {sim.total_time * 1e6:.1f} us "
          f"(comm/comp = {sim.comm_to_comp_ratio():.2f}, Cray XC30 model)")

    # 5. the round-stream executor: the SAME overlapped schedule from
    #    round-stacked tables — identical output; on the card its graph
    #    holds every launch, so compare the capture metrics
    streng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                   options=PlanOptions(stream=True),
                                   device=dev)
    out_stream = streng.solve(A, dtype=torch.float64).cpu().numpy()
    out_base = engine.solve(A, dtype=torch.float64).cpu().numpy()
    cs = streng.compile_stats(dtype=torch.float64)
    cu = engine.compile_stats(dtype=torch.float64)
    print(f"stream executor: |out - overlapped| = "
          f"{abs(out_stream - out_base).max():.1e}  graph kernels "
          f"{cs['graph_kernels']} vs {cu['graph_kernels']}, capture "
          f"{cs['capture_ms']} vs {cu['capture_ms']} ms (None on the CPU)")

    # 6. the legacy unrolled executor (the paper's per-supernode
    #    algorithm, one GEMM launch a supernode): the same numbers
    from ..core.pselinv_dist import (build_program_unrolled,
                                     make_sweep_unrolled,
                                     upload_unrolled_tables)
    prog = build_program_unrolled(engine.program.bs, engine.nb, 8, 4, 2)
    vals = engine.prepare_values(A, dtype=torch.float64)
    out_unr = make_sweep_unrolled(prog, upload_unrolled_tables(
        prog, engine.device))(vals.Lh, vals.Dinv).cpu().numpy()
    print(f"unrolled executor: |out - overlapped| = "
          f"{abs(out_unr - out_base).max():.1e}")

    # 7. the axis-factored stream (default) against the flat-ring one
    ss = streng.stats()
    flat = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device=dev,
                                 options=PlanOptions(stream=True,
                                                     axis_factored=False))
    fs = flat.stats()
    out_flat = flat.solve(A, dtype=torch.float64).cpu().numpy()
    print(f"axis-factored stream: JAX wire "
          f"{ss['stream_wire_bytes'] / 1e6:.2f}MB vs flat-ring "
          f"{fs['stream_wire_bytes'] / 1e6:.2f}MB; the port moves "
          f"{ss['moved_bytes'] / 1e6:.2f}MB vs {fs['moved_bytes'] / 1e6:.2f}"
          f"MB; active shifts/round {ss['stream_shifts_per_round']:.2f} vs "
          f"{fs['stream_shifts_per_round']:.2f}; |out - flat| = "
          f"{abs(out_stream - out_flat).max():.1e}")

    # 8. PlanLint: flip one slot_active gate bit off in a copy of the
    #    stream tables while the receive table still routes a rank onto
    #    the slot — the linter names the defect
    from ..core import verify

    st = copy.deepcopy(streng.program.stream_tables)
    t, si = np.argwhere(st.slot_active)[0]
    st.slot_active[t, si] = False
    print("PlanLint on a corrupted copy:")
    print(verify.lint_report(verify.check_stream(st, streng.program.plan)))

    # 9. the executed-communication verifier: the permutes the sweep
    #    executed (and, on the card, those its graph holds) held to the
    #    plan; a stray all-gather noted inside a sweep is named
    from ..core import exec_ir, exec_verify

    diags = streng.lint_compiled(dtype=torch.float64)
    print(f"ExecLint over the stream sweep: {len(diags.errors)} error(s) "
          f"across layers {diags.info['layers']}")
    rec = exec_ir.Record()
    rec.collective("all-gather", torch.zeros(8, 8))
    print("ExecLint on a record with a stray collective:")
    print(verify.lint_report(exec_verify.check_hygiene(rec)))

    # 10. SweepScope: span-trace analyze + solve, replay the sweep round
    #     by round, export one Chrome trace
    from ..benchmarks.common import ensure_out
    from ..obs.export import write_trace
    from ..obs.trace import TRACER

    TRACER.enable()
    try:
        obs_eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device=dev,
                                        options=PlanOptions(coalesce_max=6))
        vals = obs_eng.prepare_values(A)
        obs_eng.solve(vals)
        spans = TRACER.spans()
        profile = obs_eng.profile_rounds(vals, reps=2)
    finally:
        TRACER.disable()
    print(f"traced {len(spans)} host spans: "
          + " ".join(sorted({s.name for s in spans})))
    print(profile.report())
    path = write_trace(os.path.join(ensure_out(),
                                    "pselinv_engine.trace.json"),
                       spans=spans, profile=profile)
    print(f"wrote {path} — load it in chrome://tracing or ui.perfetto.dev")


if __name__ == "__main__":
    main()
