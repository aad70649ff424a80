"""Serving observability: latency percentiles, batch occupancy, queue
and rejection counters — thin wrappers over the unified metrics
registry (``repro_torch.obs.registry``). A copy of
``repro/serve/metrics.py`` over the port's own registry.

One :class:`ServeMetrics` instance per server, updated from the submit
path and the batch worker, read via :meth:`ServeMetrics.snapshot`
(exported through ``server.stats()``). Both percentile paths ride the
registry's one :class:`~repro_torch.obs.registry.Histogram` (bounded
keep-the-head reservoir, ``np.percentile``), and every counter/gauge is a
registry metric — so a server is scrape-able in prometheus text via
``metrics.registry`` while ``snapshot()`` keeps the reference's dict
shape (tested).

By default each ``ServeMetrics`` owns a private
:class:`~repro_torch.obs.registry.MetricsRegistry` (two servers don't mix
counts); pass ``registry=repro_torch.obs.registry.REGISTRY`` to publish into
the process-wide scrape surface alongside the engine gauges.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..obs.registry import MetricsRegistry

__all__ = ["ServeMetrics"]

#: counter names every snapshot reports, even when still zero
COUNTERS = ("submitted", "solved", "failed", "timed_out", "rejected",
            "batches")


class ServeMetrics:
    """Thread-safe serving counters + histograms over the registry.

    - request lifecycle counters (``submitted``/``solved``/``failed``/
      ``timed_out``/``rejected``) and ``batches`` served;
    - per-request latency (submit → completion) histogram, reported as
      p50/p95/p99 microseconds;
    - batch-occupancy histogram: per served batch, the real batch size
      and the padded power-of-2 bucket it rode — occupancy is
      real/bucket, the fraction of captured lanes doing real work;
    - flush-cause counter: which window-policy leg released each batch
      (``full``/``window``/``pressure``/``force``);
    - queue-depth gauge (current and high-water).
    """

    def __init__(self, max_latencies: int = 100_000,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self._events = r.counter(
            "selinv_serve_events_total",
            "request lifecycle events by name", labelnames=("name",))
        self._latency = r.histogram(
            "selinv_serve_latency_seconds",
            "submit-to-completion request latency",
            max_samples=max_latencies)
        self._occupancy = r.histogram(
            "selinv_serve_batch_occupancy",
            "real batch size / padded bucket per served batch")
        self._batch_real = r.counter(
            "selinv_serve_batch_size_total",
            "served batches by real size", labelnames=("size",))
        self._batch_bucket = r.counter(
            "selinv_serve_batch_bucket_total",
            "served batches by padded bucket", labelnames=("bucket",))
        self._flush_cause = r.counter(
            "selinv_serve_batch_flush_total",
            "served batches by window flush cause",
            labelnames=("cause",))
        self._depth = r.gauge("selinv_serve_queue_depth",
                              "requests currently queued")
        self._depth_max = r.gauge("selinv_serve_queue_depth_max",
                                  "high-water queued requests")

    # ---- writers ------------------------------------------------------
    def inc(self, name: str, by: int = 1) -> None:
        self._events.labels(name).inc(by)

    def observe_latency(self, seconds: float) -> None:
        self._latency.observe(seconds)

    def observe_batch(self, real: int, bucket: int,
                      cause: Optional[str] = None) -> None:
        self._events.labels("batches").inc()
        self._batch_real.labels(int(real)).inc()
        self._batch_bucket.labels(int(bucket)).inc()
        self._occupancy.observe(real / bucket if bucket else 0.0)
        if cause is not None:
            self._flush_cause.labels(cause).inc()

    def set_queue_depth(self, depth: int) -> None:
        self._depth.set(depth)
        self._depth_max.max(depth)

    # ---- readers ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return int(self._depth.value)

    @property
    def queue_depth_max(self) -> int:
        return int(self._depth_max.value)

    def flush_causes(self) -> Dict[str, int]:
        """Served-batch count per window flush cause."""
        return {k[0]: int(c.value) for k, c in
                self._flush_cause.children()}

    def snapshot(self) -> Dict:
        """One coherent dict of everything above; percentile keys are
        microseconds (``None`` before the first completion). The dict
        shape predates the registry and is frozen — serving dashboards
        and the bench parse it."""
        out: Dict = {name: 0 for name in COUNTERS}
        for key, child in self._events.children():
            out[key[0]] = int(child.value)
        ps = self._latency.percentile((50, 95, 99))
        if ps is not None:
            p50, p95, p99 = ps
            out.update(latency_p50_us=float(p50 * 1e6),
                       latency_p95_us=float(p95 * 1e6),
                       latency_p99_us=float(p99 * 1e6),
                       latency_mean_us=float(self._latency.mean * 1e6))
        else:
            out.update(latency_p50_us=None, latency_p95_us=None,
                       latency_p99_us=None, latency_mean_us=None)
        out["batch_occupancy_mean"] = self._occupancy.mean
        out["batch_size_hist"] = dict(sorted(
            (int(k[0]), int(c.value))
            for k, c in self._batch_real.children()))
        out["batch_bucket_hist"] = dict(sorted(
            (int(k[0]), int(c.value))
            for k, c in self._batch_bucket.children()))
        out["flush_causes"] = dict(sorted(self.flush_causes().items()))
        out["queue_depth"] = self.queue_depth
        out["queue_depth_max"] = self.queue_depth_max
        return out
