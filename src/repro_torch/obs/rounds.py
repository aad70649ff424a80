"""Per-round profiling replay — ``engine.profile_rounds()`` of the
PyTorch port (counterpart of ``repro/obs/rounds.py``).

The α-per-round simulator *predicts* where the overlapped sweep spends
its time and PlanLint's overload heuristic *warns* from the tables; this
module *measures*. On the card it replays the captured graph of the
session's overlapped sweep — the program a solve runs — ``reps`` times
under ``torch.profiler`` (device activity only) and takes each round's
device time from the graph's phase map (:mod:`.graphmap`), the mean over
the replays. On the CPU, where there is no graph, it re-executes the
sweep as per-round (or per-level-chunk) segments — the very same code as
the fused executor, cut at round boundaries by
:func:`~repro_torch.core.pselinv_dist.make_sweep_segments` — and times
each on the host clock. Either way it joins the measured times against
the plan's per-round wire tables and the α-β model:

* **residuals** — ``measured[t] − simulated[t]`` per executed round
  (:func:`~repro_torch.core.simulator.simulated_round_times` applies the
  same round cut, so the join is like-for-like; the simulated side is
  the α-β model's Cray XC30 network, not the card);
* **inbound skew** — per-rank inbound bytes / messages / attributed
  time: the paper's overload heuristic as a runtime dashboard,
  cross-checked against PlanLint's static ``load/imbalance`` WARN
  (same max/mean statistic, same
  :data:`~repro_torch.core.verify.IMBALANCE_MAX` threshold);
* **α/β fit** — least-squares latency/bandwidth estimates from the
  pure-comm rounds.

On one card the P ranks are virtual, so a "permute" is a device-memory
gather/scatter; the fit reads that, not a network. A round's device
time holds its boundary's compute ops, its lane moves and its permute;
``init_us`` is the arena's set-up, ``final_us`` the trailing boundary's
compute and the extraction.

The replay's final A⁻¹ is returned so callers can assert bit-identity
against ``engine.solve`` (the graph and the segments are the sweep, not
a model of it); the conformance tests additionally pin the round count
and the per-round wire bytes to ``executed_wire_bytes``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.pselinv_dist import make_sweep_segments
from ..core.schedule import BYTES_PER_ELT
from ..core.simulator import NetworkModel, simulated_round_times
from ..core.verify import IMBALANCE_MAX
from . import graphmap

__all__ = ["RoundSample", "RoundProfile", "profile_rounds"]


@dataclass(frozen=True)
class RoundSample:
    """One measured segment of the replay (one executed round at
    ``chunk=1``; a consecutive round range otherwise)."""

    index: int                   #: segment position in the replay
    rounds: Tuple[int, ...]      #: plan round indices this segment ran
    wall_us: float               #: device time (card) or host wall (CPU)
    sim_us: float                #: α-β cost of the same rounds
    wire_bytes: float            #: physical permute payload (padding incl.)
    lane_bytes: float            #: algorithmic lane bytes (plan edges)
    msgs: int                    #: algorithmic lane count
    compute_ops: int             #: boundary compute ops fired
    pure_comm: bool              #: no compute at any covered boundary

    @property
    def residual_us(self) -> float:
        return self.wall_us - self.sim_us


@dataclass
class RoundProfile:
    """The measured per-round timeline of one profiled sweep, joined
    against the plan tables."""

    nrounds: int                     #: executed ppermute rounds in the plan
    nranks: int
    b: int
    chunk: int
    samples: List[RoundSample]
    init_us: float                   #: arena init + diagonal seeds
    final_us: float                  #: trailing compute + extraction
    final_sim_us: float
    inbound_bytes: np.ndarray        #: (P,) algorithmic inbound bytes
    inbound_msgs: np.ndarray         #: (P,) algorithmic inbound lanes
    inbound_time_us: np.ndarray      #: (P,) measured round walls attributed
    rank_bytes: np.ndarray = field(default=None, repr=False)
    """(nseg, P) inbound bytes per segment per rank — the exporter's
    per-rank lane payload."""
    ainv: Any = field(repr=False, default=None)  #: replay's A⁻¹ shards
    graph: Optional[int] = None      #: id of the replayed graph (card)

    # -- joins ------------------------------------------------------------
    @property
    def wall_us(self) -> float:
        """Total time of the replay (init + rounds + final)."""
        return (self.init_us + self.final_us
                + sum(s.wall_us for s in self.samples))

    @property
    def sim_us(self) -> float:
        return self.final_sim_us + sum(s.sim_us for s in self.samples)

    def wire_bytes(self) -> float:
        """Physical permute bytes across the profiled rounds — equals
        ``executed_wire_bytes`` of an overlapped program (tested)."""
        return sum(s.wire_bytes for s in self.samples)

    def residuals_us(self) -> np.ndarray:
        """Measured − simulated per segment (the calibration signal)."""
        return np.array([s.residual_us for s in self.samples])

    def round_walls_us(self) -> np.ndarray:
        return np.array([s.wall_us for s in self.samples])

    def skew(self) -> Dict[str, Any]:
        """The paper's inbound-overload statistic, measured: per-rank
        inbound bytes/messages/attributed time plus the max/mean ratio
        PlanLint's static ``load/imbalance`` lint thresholds
        (``exceeds_static_warn`` mirrors :data:`IMBALANCE_MAX`)."""
        bts = self.inbound_bytes
        mean = float(bts.mean()) if bts.size else 0.0
        ratio = float(bts.max() / mean) if mean > 0 else 1.0
        return {
            "inbound_bytes": bts.tolist(),
            "inbound_msgs": self.inbound_msgs.tolist(),
            "inbound_time_us": [round(t, 3)
                                for t in self.inbound_time_us.tolist()],
            "skew_ratio": ratio,
            "static_warn_threshold": IMBALANCE_MAX,
            "exceeds_static_warn": ratio > IMBALANCE_MAX,
        }

    def fit_alpha_beta(self) -> Tuple[float, float]:
        """Least-squares (α seconds, β seconds/byte) over the measured
        rounds: ``wall ≈ α + β · max-pair-bytes``.  Pure-comm rounds
        (no boundary compute) are preferred; if they don't span two
        distinct payload sizes the fit falls back to every round.  Both
        are held at 0 or above: a negative slope just means dispatch
        latency dominates at this scale (α then carries the whole cost);
        a negative intercept, that the small rounds ran fast (the line
        then goes through the origin)."""
        pool = [s for s in self.samples if s.pure_comm and s.wire_bytes > 0]
        if len({s.wire_bytes for s in pool}) < 2:
            pool = [s for s in self.samples if s.wire_bytes > 0] or \
                list(self.samples)
        x = np.array([s.wire_bytes / max(1, self.nranks) for s in pool])
        y = np.array([s.wall_us * 1e-6 for s in pool])
        if len(pool) == 0:
            return 0.0, 0.0
        if len({float(v) for v in x}) < 2:
            return float(y.mean()), 0.0
        A = np.stack([np.ones_like(x), x], axis=1)
        (alpha, beta), *_ = np.linalg.lstsq(A, y, rcond=None)
        if beta < 0:
            return float(y.mean()), 0.0
        if alpha < 0:
            return 0.0, float(x @ y / (x @ x))
        return float(alpha), float(beta)

    # -- reporting --------------------------------------------------------
    def timeline(self) -> List[Dict[str, Any]]:
        """Flat rows (one per segment, cumulative start) for the
        Chrome-trace exporter and the CLI table."""
        rows: List[Dict[str, Any]] = []
        t = self.init_us
        for s in self.samples:
            rows.append({
                "index": s.index, "rounds": list(s.rounds),
                "start_us": t, "wall_us": s.wall_us, "sim_us": s.sim_us,
                "residual_us": s.residual_us, "wire_bytes": s.wire_bytes,
                "lane_bytes": s.lane_bytes, "msgs": s.msgs,
                "compute_ops": s.compute_ops, "pure_comm": s.pure_comm,
            })
            t += s.wall_us
        return rows

    def report(self) -> str:
        """Human-readable per-round table + the imbalance summary."""
        lines = [
            f"profiled {self.nrounds} executed rounds on {self.nranks} "
            f"ranks (chunk={self.chunk}):",
            f"{'seg':>4} {'rounds':>9} {'wall_us':>9} {'sim_us':>9} "
            f"{'resid_us':>9} {'wire_B':>10} {'msgs':>5} {'comp':>5}",
        ]
        for s in self.samples:
            rng = (f"{s.rounds[0]}" if len(s.rounds) == 1
                   else f"{s.rounds[0]}-{s.rounds[-1]}")
            lines.append(
                f"{s.index:>4} {rng:>9} {s.wall_us:>9.1f} "
                f"{s.sim_us:>9.1f} {s.residual_us:>9.1f} "
                f"{s.wire_bytes:>10.0f} {s.msgs:>5d} {s.compute_ops:>5d}")
        lines.append(f"init {self.init_us:.1f} us · final "
                     f"{self.final_us:.1f} us · total {self.wall_us:.1f} "
                     f"us (simulated {self.sim_us:.1f} us)")
        sk = self.skew()
        alpha, beta = self.fit_alpha_beta()
        lines.append("per-rank inbound bytes: "
                     + " ".join(f"{int(v)}" for v in sk["inbound_bytes"]))
        lines.append("per-rank inbound msgs:  "
                     + " ".join(f"{int(v)}" for v in sk["inbound_msgs"]))
        lines.append("per-rank time (us):     "
                     + " ".join(f"{v:.0f}" for v in sk["inbound_time_us"]))
        lines.append(
            f"inbound skew max/mean = {sk['skew_ratio']:.3f} "
            f"(static lint warns > {sk['static_warn_threshold']:.1f}: "
            f"{'EXCEEDED' if sk['exceeds_static_warn'] else 'ok'})")
        lines.append(f"fitted alpha = {alpha * 1e6:.1f} us, beta = "
                     f"{beta * 1e9:.3f} ns/byte")
        return "\n".join(lines)


def _chunk_boundaries(nrounds: int, chunk: int) -> List[int]:
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    cuts = list(range(0, nrounds, chunk)) + [nrounds]
    # range() already ends < nrounds, but a chunk dividing nrounds
    # exactly would duplicate the terminal cut
    if len(cuts) >= 2 and cuts[-2] == nrounds:
        cuts.pop()
    return cuts


def _graph_rounds(engine, Lh, Dinv, dtype, nrounds: int, reps: int):
    """Device µs of each round, of the init and of the final phases, a
    replay: the mean over ``reps`` profiled replays of the class's
    captured overlapped graph; and the last replay's A⁻¹."""
    from torch.profiler import ProfilerActivity, profile

    runner = engine.profile_runner(dtype)
    if runner.phases is None or not runner.phases.chain:
        raise RuntimeError("profile_rounds: the captured sweep has no "
                           "phase map to read")
    runner(Lh, Dinv)                    # the copy-in's first use
    torch.cuda.synchronize(Lh.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(max(1, reps)):
            ainv = runner(Lh, Dinv)
        torch.cuda.synchronize(Lh.device)
    att = graphmap.attribute(graphmap.trace_of(prof)["traceEvents"],
                             graph=runner.gid)
    if att is None or att["unmatched"]:
        raise RuntimeError(f"profile_rounds: the profiled replays do not "
                           f"match graph {runner.gid}'s phase map "
                           f"({att and att['unmatched']} left out)")
    us = {t: 1e6 * (v["product"] + v["rest"]) / att["replays"]
          for t, v in att["round"].items()}
    rounds = np.array([us.get(t, 0.0) for t in range(nrounds)])
    return (rounds, us.get(-1, 0.0), us.get(nrounds, 0.0), ainv,
            runner.gid)


def profile_rounds(engine, values, *, chunk: int = 1, reps: int = 3,
                   dtype: torch.dtype = torch.float32,
                   model: Optional[NetworkModel] = None) -> RoundProfile:
    """Measure one sweep per executed round. ``engine`` is a
    :class:`~repro_torch.core.engine.PSelInvEngine` with an overlapped
    schedule (stream sessions profile through the overlapped rounds
    their tables were lowered from); ``values`` is a matrix,
    :class:`SolveValues`, or an ``(Lh, Dinv)`` pair — single matrix
    only (rank 5). On the card: ``reps`` profiled replays of the
    captured graph (``engine.profile_runner``), each round's device time
    their mean; ``chunk`` rounds make one sample. On the CPU: every
    segment of ``chunk`` rounds runs once to warm up, then ``reps``
    times, each timed on the host clock, keeping the per-segment
    minimum.

    Prefer :meth:`PSelInvEngine.profile_rounds`, which forwards here."""
    prog = engine.program
    ov = prog.overlap_plan
    if ov is None:
        raise ValueError(
            "profile_rounds needs an overlapped schedule — analyze with "
            "PlanOptions(overlap=True) (default) or stream=True")
    tables = engine.overlap_tables()
    if not (isinstance(values, (tuple, list)) and len(values) == 2):
        values = engine.prepare_values(values)   # a matrix, not shards
    Lh, Dinv = (engine._as_tensor(v, dtype) for v in values)
    if Lh.ndim != 5:
        raise ValueError(f"profile_rounds takes one matrix (rank-5 "
                         f"values), got shape {tuple(Lh.shape)}")

    nrounds = len(ov.rounds)
    boundaries = _chunk_boundaries(nrounds, chunk)
    gid = None
    if Lh.device.type == "cuda":
        per_round, init_wall, final_wall, ainv, gid = _graph_rounds(
            engine, Lh, Dinv, dtype, nrounds, reps)
        walls = np.array([per_round[lo:hi].sum() for lo, hi
                          in zip(boundaries, boundaries[1:])])
    else:
        walls, init_wall, final_wall, ainv = _fenced_segments(
            prog, tables, boundaries, Lh, Dinv, reps)

    # ---- join against the plan tables ---------------------------------
    P_ = ov.pr * ov.pc
    b = prog.b
    sim = simulated_round_times(prog, model) * 1e6   # (nrounds + 1,) us
    inbound_bytes = np.zeros(P_)
    inbound_msgs = np.zeros(P_, dtype=np.int64)
    inbound_time = np.zeros(P_)
    rank_bytes = np.zeros((len(boundaries) - 1, P_))
    samples: List[RoundSample] = []
    for i, (lo, hi) in enumerate(zip(boundaries, boundaries[1:])):
        wire = lane = 0.0
        msgs = 0
        comp = 0
        seg_in = np.zeros(P_)
        seg_msgs = np.zeros(P_, dtype=np.int64)
        for t in range(lo, hi):
            rnd = ov.rounds[t]
            wire += len(rnd.perm) * rnd.width * b * b * BYTES_PER_ELT
            for (_s, d, _kind, _lv, nb_) in rnd.edges:
                lane += nb_
                msgs += 1
                seg_in[d] += nb_
                seg_msgs[d] += 1
            comp += len(ov.compute_at[t])
        inbound_bytes += seg_in
        inbound_msgs += seg_msgs
        rank_bytes[i] = seg_in
        if seg_in.sum() > 0:
            # attribute the round's time to ranks by inbound share — a
            # dashboard statistic, not a per-rank measurement (the ranks
            # of a round run as one set of kernels)
            inbound_time += walls[i] * seg_in / seg_in.sum()
        samples.append(RoundSample(
            index=i, rounds=tuple(range(lo, hi)),
            wall_us=float(walls[i]), sim_us=float(sim[lo:hi].sum()),
            wire_bytes=wire, lane_bytes=lane, msgs=msgs,
            compute_ops=comp, pure_comm=(comp == 0)))

    return RoundProfile(
        nrounds=nrounds, nranks=P_, b=b, chunk=chunk, samples=samples,
        init_us=float(init_wall), final_us=float(final_wall),
        final_sim_us=float(sim[nrounds]),
        inbound_bytes=inbound_bytes, inbound_msgs=inbound_msgs,
        inbound_time_us=inbound_time, rank_bytes=rank_bytes, ainv=ainv,
        graph=gid)


def _fenced_segments(prog, tables, boundaries, Lh, Dinv, reps: int):
    """Host µs of each segment, of the init and of the final (the
    minimum of ``reps`` timed passes after one warm-up pass), and the
    last pass's A⁻¹."""
    init, steps, final = make_sweep_segments(prog, tables, boundaries)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, (time.perf_counter() - t0) * 1e6

    # warm-up pass: every segment once, with its first-call costs
    arena, _ = timed(init, Lh, Dinv)
    for step in steps:
        arena, _ = timed(step, arena, Lh, Dinv)
    ainv, _ = timed(final, arena, Lh, Dinv)

    walls = np.full(len(steps), np.inf)
    init_wall = np.inf
    final_wall = np.inf
    for _ in range(max(1, reps)):
        arena, us = timed(init, Lh, Dinv)
        init_wall = min(init_wall, us)
        for i, step in enumerate(steps):
            arena, us = timed(step, arena, Lh, Dinv)
            walls[i] = min(walls[i], us)
        ainv, us = timed(final, arena, Lh, Dinv)
        final_wall = min(final_wall, us)
    return walls, float(init_wall), float(final_wall), ainv
