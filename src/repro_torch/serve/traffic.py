"""Synthetic mixed-structure traffic for the serving layer (the PyTorch
port of ``repro/serve/traffic.py``).

A seeded Poisson request stream over ≥2 distinct block structures,
served through :class:`~.server.SelInvServer`, then checked three ways —

- **throughput**: per-matrix wall time of coalesced serving vs the
  sequential baseline (``engine.solve`` per request, the exact same
  matrices) on warm runners;
- **capture conformance**: after the cold pass, every structure's
  ``trace_count`` equals the number of distinct batch buckets it
  served — exactly one capture (on the card; one eager runner on the
  CPU) per (structure, bucket), asserted off the engine counters before
  any single-matrix solve runs;
- **identity**: every served result equals its unbatched
  ``engine.solve`` to ≤``tol`` in f64.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import sparse
from ..core.engine import (Grid, PlanOptions, PSelInvEngine,
                           bucket_size, stack_values)
from .batcher import BatchWindow
from .metrics import ServeMetrics
from .server import SelInvServer, ServeConfig

__all__ = ["mixed_structures", "make_trace", "run_traffic"]

#: 2-D Laplacian grid widths giving distinct block structures at b=8
_NX = (12, 16, 20, 24, 28, 32)


def mixed_structures(n_structures: int = 2, b: int = 8) -> List:
    """``n_structures`` distinct-sparsity base matrices (2-D Laplacians
    of growing width; each symbolic-factorizes to its own structure
    sha1 at supernode width ``b``)."""
    if not 1 <= n_structures <= len(_NX):
        raise ValueError(f"n_structures must be in [1, {len(_NX)}], "
                         f"got {n_structures}")
    return [sparse.laplacian_2d(nx, b) for nx in _NX[:n_structures]]


@dataclass(frozen=True)
class TraceItem:
    """One request of the synthetic stream: arrives ``gap_s`` after the
    previous one, targets structure ``sidx``, with values shifted by
    ``shift`` (A + shift·I — same pattern, fresh numbers)."""
    gap_s: float
    sidx: int
    shift: float


def make_trace(n_requests: int, n_structures: int,
               rate_hz: Optional[float], seed: int) -> List[TraceItem]:
    """A seeded Poisson stream: exponential inter-arrivals at
    ``rate_hz`` (``None`` → a burst, zero gaps), uniform structure
    choice, uniform value shifts."""
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(1.0 / rate_hz, n_requests)
            if rate_hz else np.zeros(n_requests))
    sidx = rng.integers(0, n_structures, n_requests)
    shifts = rng.uniform(0.1, 2.0, n_requests)
    return [TraceItem(float(g), int(s), float(c))
            for g, s, c in zip(gaps, sidx, shifts)]


def _materialize(trace: Sequence[TraceItem], bases: Sequence) -> List:
    import scipy.sparse as sp
    eye = [sp.identity(B.shape[0], format="csr") for B in bases]
    return [bases[t.sidx] + t.shift * eye[t.sidx] for t in trace]


def _serve_pass(server: SelInvServer, trace: Sequence[TraceItem],
                mats: Sequence, *, realtime: bool,
                timeout_s: float = 300.0) -> Tuple[float, List]:
    """Submit the whole trace (sleeping out the Poisson gaps when
    ``realtime``), drain, and return (wall seconds, per-request
    results in submit order)."""
    t0 = time.perf_counter()
    reqs = []
    for item, M in zip(trace, mats):
        if realtime and item.gap_s:
            time.sleep(item.gap_s)
        reqs.append(server.submit(M))
    server.drain(timeout=timeout_s)
    outs = [r.result(timeout=timeout_s) for r in reqs]
    return time.perf_counter() - t0, outs


def _host(out: torch.Tensor) -> np.ndarray:
    """A solve's A⁻¹ shards on the host, after the device finished."""
    return out.cpu().numpy()


def run_traffic(n_requests: int = 120, n_structures: int = 2,
                rate_hz: Optional[float] = 4000.0, seed: int = 0, *,
                b: int = 8, grid: Grid = Grid(1, 1),
                options: PlanOptions = PlanOptions(),
                window: BatchWindow = BatchWindow(),
                dtype: torch.dtype = torch.float64, device="cuda",
                background: bool = True, check_identity: bool = True,
                tol: float = 1e-12, reps: int = 1,
                log=lambda s: None) -> Dict:
    """The full serve-bench: cold pass (captures) → capture-conformance
    assert → warm timed pass → warm sequential baseline over the same
    matrices → identity check. Returns one flat dict of everything a
    bench row needs.

    ``reps`` repeats each *timed* pass (warm serve and sequential
    baseline) and keeps the best wall of each, so one descheduled pass
    does not decide an asserted ratio."""
    if n_structures < 2:
        raise ValueError("the mixed-structure bench needs >= 2 "
                         "structures")
    bases = mixed_structures(n_structures, b)
    trace = make_trace(n_requests, n_structures, rate_hz, seed)
    mats = _materialize(trace, bases)

    PSelInvEngine.clear_cache()
    cfg = ServeConfig(b=b, grid=grid, options=options, window=window,
                      max_queue=max(256, 2 * n_requests), dtype=dtype,
                      device=device)
    server = SelInvServer(cfg)
    if background:
        server.start()
    try:
        # ---- cold pass: burst the trace through once so every
        # (structure, bucket) the stream exercises gets its one capture
        log(f"cold pass: {n_requests} requests, {n_structures} "
            f"structures")
        _serve_pass(server, trace, mats, realtime=False)

        # ---- capture conformance, straight off the runner counters —
        # before any single-matrix solve adds its rank-5 class
        st = server.stats()
        conformance = {k: (v["trace_count"], len(v["buckets_used"]))
                       for k, v in st["structures"].items()}
        for k, (traces, buckets) in conformance.items():
            assert traces == buckets, (
                f"structure {k}: {traces} captures for {buckets} "
                f"buckets — expected exactly one per (structure, "
                f"bucket)")

        # ---- pre-warm every power-of-2 bucket the warm pass could
        # coalesce into (arrival timing decides the bucket census, so
        # the timed replay must never pay a stray capture)
        engines = [PSelInvEngine.analyze(B, b=b, grid=grid,
                                         options=options, device=device)
                   for B in bases]           # cache hits: the server's
        for eng, base in zip(engines, bases):
            v = eng.prepare_values(base)
            bkt = 1
            while bkt <= window.max_batch:
                _host(eng.solve(stack_values([v] * bkt), dtype=dtype))
                bkt *= 2
            if bucket_size(window.max_batch) != window.max_batch:
                _host(eng.solve(
                    stack_values([v] * bucket_size(window.max_batch)),
                    dtype=dtype))

        # ---- warm timed pass (same matrices, fresh metrics so the
        # percentiles reflect warm serving only); best-of-``reps``
        serve_wall, served, snap = None, None, None
        for rep in range(max(1, reps)):
            log(f"warm serve pass (timed, rep {rep + 1}/{reps})")
            server.metrics = ServeMetrics()
            wall, outs = _serve_pass(server, trace, mats,
                                     realtime=bool(rate_hz))
            if serve_wall is None or wall < serve_wall:
                serve_wall, served, snap = wall, outs, server.stats()
    finally:
        if background:
            server.stop()

    # ---- warm sequential baseline: the exact same matrices, one
    # full-path engine.solve each (host factorization + sweep)
    for eng, B in zip(engines, bases):       # pay the rank-5 capture
        _host(eng.solve(B, dtype=dtype))
    base_wall, base_outs = None, None
    for rep in range(max(1, reps)):
        log(f"sequential baseline (timed, rep {rep + 1}/{reps})")
        t0 = time.perf_counter()
        outs = [_host(engines[t.sidx].solve(M, dtype=dtype))
                for t, M in zip(trace, mats)]
        wall = time.perf_counter() - t0
        if base_wall is None or wall < base_wall:
            base_wall, base_outs = wall, outs

    identity_max = None
    if check_identity:
        identity_max = float(max(
            abs(o - bo).max() for o, bo in zip(served, base_outs)))
        assert identity_max <= tol, (
            f"served results deviate from unbatched solves by "
            f"{identity_max:g} > {tol:g}")

    return {
        "n_requests": n_requests,
        "n_structures": n_structures,
        "rate_hz": rate_hz,
        "serve_wall_s": serve_wall,
        "baseline_wall_s": base_wall,
        "speedup": base_wall / serve_wall,
        "serve_per_matrix_us": serve_wall / n_requests * 1e6,
        "baseline_per_matrix_us": base_wall / n_requests * 1e6,
        "serve_throughput_rps": n_requests / serve_wall,
        "serve_p50_us": snap["latency_p50_us"],
        "serve_p95_us": snap["latency_p95_us"],
        "serve_p99_us": snap["latency_p99_us"],
        "serve_batch_occupancy": snap["batch_occupancy_mean"],
        "batches": snap["batches"],
        "identity_max_abs": identity_max,
        "conformance": conformance,
        "stats": snap,
    }
