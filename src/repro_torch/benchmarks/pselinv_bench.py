"""Selected-inversion benchmark — the port's twin of
``benchmarks/pselinv_bench.py``, section by section, on the card (or,
with ``device="cpu"``, on the host through the kernels' plain versions).

* **Backends.** ``selinv/{numpy,torch,cuda}``: ``selected_inverse`` with
  each serial backend (the ``cuda`` one runs the hand-written GEMM and
  trsm kernels).
* **Lint.** ``selinv/plan_lint_ms`` and ``selinv/bigmesh_8x4_lint_ms``
  (PlanLint, host only) and ``selinv/exec_lint_ms`` (the
  executed-communication verifier on ``meta`` tensors, in the place of
  the JAX package's ``hlo_lint_ms``); zero ERROR diagnostics asserted.
* **The four-way sweep compare** — the legacy unrolled sweep, the
  level-serial (``ir``), overlapped and stream executors — on
  ``laplacian_2d(16, 8)`` (``--full``: 32), b=8, grid 4×2, f32. The JAX
  trace and compile rows become capture rows: ``…_capture`` is the wall
  of capturing the sweep as one CUDA graph (``core/capture.py``; none on
  the CPU), ``…_graph_kernels`` the graph's kernel nodes and
  ``…_dispatched_ops`` the ops one eager sweep dispatches, in the place
  of ``…_trace``, ``…_compile`` and ``…_hlo_bytes``; ``…_run`` is a
  replay and ``…_eager`` the eager sweep. Carried over with their bars:
  every executor within 1e-4 of the others, the overlapped rounds fewer
  than the level-serial ones, the overlapped peak arena within 1.1× the
  level-serial one, the stream's JAX wire within 2× the overlapped
  executor's and equal to ``executed_wire_bytes``.
* **The batched engine**, **the trace tax and the round timeline**, and
  **the server** (f64, grid 1×1, bursts), with the JAX rows' names. The
  sequential baseline of ``engine_batched_speedup`` is one
  ``engine.solve(A)`` per matrix, host factorization included (what the
  JAX shim costs a call; the port's ``run_distributed`` needs a process
  group).

Three JAX bars are speed ratios set on a CPU host (batched ≥5×, serve
≥5×, tracing tax ≤2 %): here each ratio is measured and written into its
row's derived column as ``bar=… met=…``, not asserted. The JAX bench's
stream-size bar (stream HLO ≤ 0.5× the overlapped program) has no
counterpart: a CUDA graph holds every launch of every round and has no
loop body to share, so ``selinv/stream_graph_kernels`` records the
stream's kernel nodes beside the overlapped graph's, unasserted.

    PYTHONPATH=src python -m repro_torch.benchmarks.pselinv_bench \\
        [--device cpu]
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core import sparse
from ..core.device import resolve_device
from ..core.selinv import compare_with_oracle, selected_inverse
from .common import csv_row, timed, timed_cuda


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bar(value: float, bar: float, ge: bool = True) -> str:
    met = value >= bar if ge else value <= bar
    return f"bar={'>=' if ge else '<='}{bar:g} met={met}"


def run(full: bool = False, device="cuda"):
    dev = resolve_device(device)
    n = 16 if full else 10
    A = sparse.laplacian_2d(n, n)
    for backend in ("numpy", "torch", "cuda"):
        t0 = time.perf_counter()
        Ainv, bs = selected_inverse(
            A, max_supernode=16, backend=backend,
            device=None if backend == "numpy" else dev)
        dt = time.perf_counter() - t0
        err = compare_with_oracle(Ainv, bs, A)
        csv_row(f"selinv/{backend}", dt * 1e6,
                f"N={A.shape[0]} nsuper={bs.nsuper} err={err:.2e}")
        assert err < 1e-3
    _plan_lint_bench()
    _exec_lint_bench()
    _ir_compare(full, dev)
    _serve_bench(full, dev)
    return True


def _plan_lint_bench():
    """PlanLint cost and diagnostic counts, host only: the tier-1 4×2
    case and the 8×4 ``bigmesh`` case, both with zero ERRORs."""
    import scipy.sparse as sp

    from ..core import verify
    from ..core.plan import build_plan, schedule_overlapped
    from ..core.schedule import Grid2D
    from ..core.stream import lower_stream, stream_wire_blocks
    from ..core.symbolic import symbolic_factorize
    from ..core.trees import TreeKind

    for name, nx, nb, pr, pc in (("plan_lint_ms", 16, 16, 4, 2),
                                 ("bigmesh_8x4_lint_ms", 32, 32, 8, 4)):
        bs = symbolic_factorize(
            sp.csr_matrix(sparse.laplacian_2d(nx, 8)), max_supernode=8)
        plan = build_plan(bs, Grid2D(pr, pc), TreeKind.SHIFTED, nb=nb)
        ov = schedule_overlapped(plan)
        st = lower_stream(ov)
        t0 = time.perf_counter()
        diags = (verify.check_plan(plan) + verify.check_overlap(ov, plan)
                 + verify.check_stream(st, plan))
        dt = time.perf_counter() - t0
        nerr = sum(1 for d in diags if d.severity == "error")
        csv_row(f"selinv/{name}", dt * 1e6,
                f"nb={nb} grid={pr}x{pc} errors={nerr} "
                f"warnings={len(diags) - nerr} rounds={len(ov.rounds)} "
                f"wire_blocks={stream_wire_blocks(st)}")
        assert nerr == 0, verify.lint_report(diags)


def _exec_lint_bench():
    """The executed-communication verifier's cost on the nb=16 4×2
    stream program: its sweep once on ``meta`` tensors under the
    recorder and the op layer, held to the plan; zero ERRORs."""
    import scipy.sparse as sp

    from ..core import exec_verify, verify
    from ..core.plan import PlanOptions
    from ..core.pselinv_dist import build_program, pad_nb
    from ..core.symbolic import symbolic_factorize

    bs = symbolic_factorize(
        sp.csr_matrix(sparse.laplacian_2d(16, 8)), max_supernode=8)
    prog = build_program(bs, pad_nb(bs.nsuper, 4, 2), 8, 4, 2,
                         options=PlanOptions(stream=True))
    t0 = time.perf_counter()
    diags = exec_verify.lint_program(prog)
    dt = time.perf_counter() - t0
    nerr = len(diags.errors)
    csv_row("selinv/exec_lint_ms", dt * 1e6,
            f"nb=16 grid=4x2 errors={nerr} warnings={len(diags) - nerr} "
            f"permutes={len(exec_verify.expected_permutes(prog))} "
            f"wire_blocks={exec_verify.expected_wire_blocks(prog)} "
            f"dispatched_ops={diags.info['dispatched_ops']}")
    assert nerr == 0, verify.lint_report(diags)


def _dispatched(sweep, Lh, Dinv) -> int:
    """Ops one eager sweep dispatches (the op layer's count)."""
    from ..core import exec_ir

    with exec_ir.record() as rec, exec_ir.ops_layer(rec):
        sweep(Lh, Dinv)
    return rec.dispatched


def _ir_compare(full: bool, dev):
    """The four executors on one Laplacian in f32: capture, replay and
    eager timings, op and kernel-node counts, the simulated schedules,
    and the carried-over structure asserts."""
    from ..core import capture as cap
    from ..core.engine import Grid, PlanOptions, PSelInvEngine
    from ..core.pselinv_dist import (analyze_structure,
                                     build_program_unrolled,
                                     make_sweep_unrolled, prepare_values,
                                     unrolled_moved, upload_unrolled_tables)
    from ..core.schedule import BYTES_PER_ELT
    from ..core.simulator import executed_wire_bytes
    from ..core.stream import overlap_wire_blocks
    from ..core.trees import TreeKind

    nx = 32 if full else 16          # nb = nx (b=8 supernodes a grid row)
    A = sparse.laplacian_2d(nx, 8)
    b, pr, pc = 8, 4, 2
    bs, nb = analyze_structure(A, b, pr, pc)
    Lh_s, Dinv_s = prepare_values(A, bs, nb, b, pr, pc)
    Lh = torch.as_tensor(Lh_s, dtype=torch.float32, device=dev)
    Dinv = torch.as_tensor(Dinv_s, dtype=torch.float32, device=dev)
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    gate = cap.ReplayGate(threading.RLock())

    outs, rounds, peaks, engines, graphs, caps = {}, {}, {}, {}, {}, {}
    for name in ("unrolled", "ir", "overlap", "stream"):
        t0 = time.perf_counter()
        if name == "unrolled":
            prog = build_program_unrolled(bs, nb, b, pr, pc,
                                          TreeKind.SHIFTED)
            sweep = make_sweep_unrolled(prog,
                                        upload_unrolled_tables(prog, dev))
        else:
            eng = engines[name] = PSelInvEngine.analyze(
                bs, b=b, grid=Grid(pr, pc), device=dev,
                options=PlanOptions(kind=TreeKind.SHIFTED,
                                    overlap=name in ("overlap", "stream"),
                                    stream=name == "stream"))
            sweep = eng.sweep()
        setup_s = time.perf_counter() - t0
        ops = _dispatched(sweep, Lh, Dinv)
        eager_out, dt_eager = timed_cuda(lambda: sweep(Lh, Dinv), dev)
        if dev.type == "cuda":
            runner = cap.capture(sweep, tuple(Lh.shape), Lh.dtype, dev,
                                 pool, gate, batched=False)
            out, dt = timed_cuda(lambda: runner(Lh, Dinv), dev)
            graphs[name], caps[name] = runner.graph_kernels, runner.capture_ms
            csv_row(f"selinv/sweep_{name}_capture", runner.capture_ms * 1e3,
                    f"nb={nb} warmup_ms={runner.warmup_ms:.1f} "
                    f"setup_ms={setup_s * 1e3:.1f}")
            csv_row(f"selinv/sweep_{name}_graph_kernels",
                    float(runner.graph_kernels),
                    f"nb={nb} gemm_nodes={runner.gemm_nodes}")
            assert torch.equal(out, eager_out), f"{name}: replay != eager"
        else:
            out, dt = eager_out, dt_eager
            graphs[name] = caps[name] = None
            csv_row(f"selinv/sweep_{name}_capture", 0.0,
                    f"nb={nb} no CUDA graph on the CPU "
                    f"setup_ms={setup_s * 1e3:.1f}")
            csv_row(f"selinv/sweep_{name}_graph_kernels", 0.0,
                    f"nb={nb} no CUDA graph on the CPU")
        csv_row(f"selinv/sweep_{name}_dispatched_ops", float(ops),
                f"nb={nb}")
        csv_row(f"selinv/sweep_{name}_eager", dt_eager * 1e6,
                f"nb={nb} device={dev.type}")
        csv_row(f"selinv/sweep_{name}_run", dt * 1e6,
                f"nb={nb} device={dev.type} "
                + ("graph replay" if dev.type == "cuda" else "eager"))
        outs[name] = out.cpu().numpy()
        if name == "unrolled":
            r, blocks = unrolled_moved(prog)
            csv_row("selinv/sweep_unrolled_rounds", float(r),
                    f"nb={nb} wire_blocks={blocks}")
        else:
            stats = eng.stats()
            rounds[name] = stats["ppermute_rounds"]
            peaks[name] = stats["peak_arena_blocks"]
            sim = eng.simulate()
            csv_row(f"selinv/sweep_{name}_simulated", sim.total_time * 1e6,
                    f"nb={nb} rounds={rounds[name]} "
                    f"peak_arena_blocks={sim.peak_arena_blocks}")
        if name == "stream":
            csv_row("selinv/stream_us_per_call", dt * 1e6, f"nb={nb}")
    for a, b_, row in (("ir", "unrolled", "ir_vs_unrolled"),
                       ("overlap", "ir", "overlap_vs_ir"),
                       ("stream", "overlap", "stream_vs_overlap")):
        err = float(np.abs(outs[a] - outs[b_]).max())
        csv_row(f"selinv/sweep_{row}_maxdiff", 0.0, f"err={err:.2e}")
        assert err < 1e-4, (row, err)
    st_eng = engines["stream"]
    csv_row("selinv/stream_capture_ms", caps["stream"] or 0.0,
            f"nb={nb} overlap_ms={caps['overlap']}")
    csv_row("selinv/stream_graph_kernels", float(graphs["stream"] or 0),
            f"nb={nb} overlap_graph_kernels={graphs['overlap']} "
            "(unasserted: a graph holds every launch, no loop body)")
    s_stats = st_eng.stats()
    wire_stream = s_stats["stream_wire_bytes"]
    assert executed_wire_bytes(st_eng) == wire_stream
    wire_unrolled = (overlap_wire_blocks(st_eng.program.overlap_plan)
                     * b * b * BYTES_PER_ELT)
    csv_row("selinv/stream_wire_bytes", wire_stream,
            f"nb={nb} unrolled={wire_unrolled:.0f} "
            f"ratio={wire_stream / wire_unrolled:.2f} "
            f"port_moved={s_stats['moved_bytes']:.0f}")
    csv_row("selinv/stream_shifts_per_round",
            s_stats["stream_shifts_per_round"],
            f"nb={nb} nshifts={len(st_eng.program.stream_tables.shifts)}")
    assert wire_stream <= 2.0 * wire_unrolled, (wire_stream, wire_unrolled)
    csv_row("selinv/sweep_ppermute_rounds", float(rounds["overlap"]),
            f"nb={nb} serial={rounds['ir']} overlap={rounds['overlap']}")
    assert rounds["overlap"] < rounds["ir"], rounds
    csv_row("selinv/sweep_peak_arena_blocks", float(peaks["overlap"]),
            f"nb={nb} serial={peaks['ir']} overlap={peaks['overlap']}")
    assert peaks["overlap"] <= 1.1 * peaks["ir"], peaks
    _engine_batched_bench(A, nb, engines["overlap"], dev)
    _obs_bench(engines["overlap"], A, nb, dev)
    return True


def _engine_batched_bench(A, nb, eng, dev):
    """Analyze-once / solve-many throughput: batched f32 solves at
    B∈{1,4,16} (µs per matrix, best of 5 after a warm-up that captures
    the class), against one ``engine.solve(A)`` a matrix, host
    factorization included (best of 3); the session cache's hits."""
    from ..core.engine import PSelInvEngine, stack_values

    vals = eng.prepare_values(A)
    per_matrix = {}
    for B in (1, 4, 16):
        vb = stack_values([vals] * B)
        _, dt = timed_cuda(lambda: eng.solve(vb, dtype=torch.float32), dev,
                           reps=5, best=True)
        per_matrix[B] = dt / B
        csv_row(f"selinv/solve_batched_us_per_matrix_b{B}", dt / B * 1e6,
                f"nb={nb} B={B}")

    def seq():
        out = eng.solve(A, dtype=torch.float32)
        _sync(dev)
        return out

    _, dt_seq = timed(seq, reps=3, best=True)
    speedup = dt_seq / per_matrix[16]
    csv_row("selinv/engine_batched_speedup", speedup,
            f"nb={nb} B=16 seq_us={dt_seq * 1e6:.1f} "
            f"batched_us={per_matrix[16] * 1e6:.1f} {_bar(speedup, 5)}")
    csv_row("selinv/engine_cache_hits", float(PSelInvEngine.cache_hits),
            f"misses={PSelInvEngine.cache_misses}")


def _obs_bench(eng, A, nb, dev):
    """The tracing tax on the solve hot path (best of 20 with the
    tracer off, then on) and the measured round timeline of the
    ``profile_rounds`` replay: p95 round wall and the inbound-byte skew,
    asserted under PlanLint's static imbalance WARN threshold."""
    from ..obs.trace import TRACER

    vals = eng.prepare_values(A)

    def hot():
        out = eng.solve(vals)
        _sync(dev)
        return out

    TRACER.disable()
    _, dt_off = timed(hot, reps=20, best=True)
    TRACER.enable()
    try:
        _, dt_on = timed(hot, reps=20, best=True)
    finally:
        TRACER.disable()
    overhead = max(0.0, (dt_on - dt_off) / dt_off * 100.0)
    csv_row("selinv/trace_overhead_pct", overhead,
            f"nb={nb} off_us={dt_off * 1e6:.1f} on_us={dt_on * 1e6:.1f} "
            f"{_bar(overhead, 2, ge=False)}")

    prof = eng.profile_rounds(vals, reps=3)
    walls = prof.round_walls_us()
    sk = prof.skew()
    alpha, beta = prof.fit_alpha_beta()
    csv_row("selinv/round_p95_us", float(np.percentile(walls, 95)),
            f"nb={nb} rounds={prof.nrounds} "
            f"median_us={np.percentile(walls, 50):.1f} "
            f"total_us={prof.wall_us:.0f} "
            f"alpha_us={alpha * 1e6:.1f} beta_ns_per_B={beta * 1e9:.2f}")
    csv_row("selinv/inbound_skew_ratio", sk["skew_ratio"],
            f"nb={nb} static_warn>{sk['static_warn_threshold']:.1f} "
            f"exceeded={sk['exceeds_static_warn']} "
            f"max_B={int(max(sk['inbound_bytes']))} "
            f"mean_B={np.mean(sk['inbound_bytes']):.0f}")
    assert not sk["exceeds_static_warn"], sk


def _serve_bench(full: bool, dev):
    """Mixed-structure burst traffic through ``SelInvServer`` in f64 on
    grid 1×1: the serving scorecard, exactly one capture per (structure,
    bucket) and every batched result within 1e-12 of its unbatched solve
    (both asserted inside ``run_traffic``); the speedup over sequential
    single solves beside the JAX bar of 5×."""
    from ..core.engine import Grid
    from ..serve.batcher import BatchWindow
    from ..serve.traffic import run_traffic

    n = 200 if full else 120
    res = run_traffic(
        n_requests=n, n_structures=3 if full else 2, rate_hz=None, seed=0,
        b=8, grid=Grid(1, 1), window=BatchWindow(), dtype=torch.float64,
        device=dev, check_identity=True, tol=1e-12, reps=3)
    csv_row("selinv/serve_p50_us", res["serve_p50_us"],
            f"n={n} structures={res['n_structures']} "
            f"p95={res['serve_p95_us']:.0f} p99={res['serve_p99_us']:.0f}")
    csv_row("selinv/serve_throughput_rps", res["serve_throughput_rps"],
            f"n={n} per_matrix_us={res['serve_per_matrix_us']:.1f} "
            f"baseline_us={res['baseline_per_matrix_us']:.1f} "
            f"speedup={res['speedup']:.2f} {_bar(res['speedup'], 5)}")
    csv_row("selinv/serve_batch_occupancy", res["serve_batch_occupancy"],
            f"n={n} batches={res['batches']} "
            f"identity={res['identity_max_abs']:.2e}")
    return True


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(full=args.full, device=args.device)
