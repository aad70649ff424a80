"""Unified metrics registry — counters, gauges and histograms with
labels, one ``snapshot()``, and a prometheus-style text dump.

Before this existed the stack had three ad-hoc metric surfaces:
``engine.stats()`` (a dict rebuilt per call), ``ServeMetrics`` (its own
locks + two hand-rolled percentile paths), and the bench CSV.  The
registry is the single scrape surface they all write through:

* ``Counter``   — monotone ``inc``; labeled children via ``labels()``.
* ``Gauge``     — ``set`` / ``inc``; last value wins.
* ``Histogram`` — ``observe``; keeps exact ``count``/``sum`` plus a
  bounded sample reservoir (first ``max_samples`` observations, the same
  keep-the-head policy ``ServeMetrics`` used) for percentiles.  This is
  the *one* percentile implementation — serve latency and batch
  occupancy are thin wrappers over it.

Registration is idempotent: asking for an existing name returns the
existing metric (type and label names must match).  All mutation is
lock-guarded, so serve worker threads and the engine can share one
registry.  ``REGISTRY`` is the process-wide default; anything that wants
isolation (tests, per-server metrics) builds a private
:class:`MetricsRegistry`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]


def _format_labels(labelnames: Sequence[str],
                   labelvalues: Sequence[Any]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Metric:
    """Shared plumbing: name/help/labels and the child table."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 lock: Optional[threading.Lock] = None) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock if lock is not None else threading.Lock()
        self._children: "OrderedDict[Tuple[Any, ...], _Metric]" = OrderedDict()

    def labels(self, *values: Any, **kv: Any):
        """Child metric for one label-value combination."""
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "keyword, not both")
            values = tuple(kv[k] for k in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values!r}")
        key = tuple(values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _make_child(self) -> "_Metric":
        raise NotImplementedError

    def children(self) -> List[Tuple[Tuple[Any, ...], "_Metric"]]:
        with self._lock:
            return list(self._children.items())

    def _require_plain(self) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.labelnames}; call .labels(...) first")


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help, (), lock=self._lock)

    def inc(self, by: float = 1.0) -> None:
        self._require_plain()
        if by < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self._value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help, (), lock=self._lock)

    def set(self, value: float) -> None:
        self._require_plain()
        with self._lock:
            self._value = float(value)

    def inc(self, by: float = 1.0) -> None:
        self._require_plain()
        with self._lock:
            self._value += by

    def max(self, value: float) -> None:
        """High-water update: keep the larger of current and ``value``."""
        self._require_plain()
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Metric):
    """Count/sum plus a bounded reservoir of raw observations.

    The reservoir keeps the first ``max_samples`` observations and then
    stops growing (``count``/``sum`` stay exact) — the same bounded
    policy the serve latency reservoir shipped with, so percentiles are
    stable under long-running servers without unbounded memory.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 lock: Optional[threading.Lock] = None,
                 max_samples: int = 100_000) -> None:
        super().__init__(name, help, labelnames, lock=lock)
        self.max_samples = int(max_samples)
        self._count = 0
        self._sum = 0.0
        self._samples: List[float] = []

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, (), lock=self._lock,
                         max_samples=self.max_samples)

    def observe(self, value: float) -> None:
        self._require_plain()
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> Optional[float]:
        return (self._sum / self._count) if self._count else None

    def percentile(self, q) -> Any:
        """``np.percentile`` over the reservoir; None when empty.

        Accepts a scalar or a sequence of q values (0–100), matching
        the shape ``np.percentile`` would return.
        """
        with self._lock:
            if not self._samples:
                return None
            return np.percentile(np.asarray(self._samples), q)

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._samples)

    def summary(self, qs: Iterable[float] = (50, 95, 99)) -> Dict[str, Any]:
        qs = tuple(qs)
        ps = self.percentile(qs)
        out: Dict[str, Any] = {"count": self._count, "sum": self._sum,
                               "mean": self.mean}
        for q, p in zip(qs, ps if ps is not None else [None] * len(qs)):
            out[f"p{q:g}"] = float(p) if p is not None else None
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metric table with idempotent registration."""

    def __init__(self) -> None:
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()
        self._lock = threading.Lock()

    # -- registration -----------------------------------------------------
    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if type(got) is not cls or got.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{got.kind}{got.labelnames} — cannot re-register "
                        f"as {cls.kind}{tuple(labelnames)}")
                return got
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  max_samples: int = 100_000) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              max_samples=max_samples)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- scraping ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: scalars for plain counters/gauges, a
        ``{label-string: value}`` dict for labeled ones, and a
        count/sum/mean/percentile summary per histogram."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            if m.labelnames:
                sub: Dict[str, Any] = {}
                for key, child in m.children():
                    label = ",".join(f"{k}={v}" for k, v
                                     in zip(m.labelnames, key))
                    sub[label] = (child.summary()
                                  if isinstance(child, Histogram)
                                  else child.value)
                out[m.name] = sub
            elif isinstance(m, Histogram):
                out[m.name] = m.summary()
            else:
                out[m.name] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition-format dump (histograms as summaries)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} "
                         f"{'summary' if m.kind == 'histogram' else m.kind}")
            flat: List[Tuple[Tuple[Any, ...], _Metric]]
            flat = m.children() if m.labelnames else [((), m)]
            for key, child in flat:
                lbl = _format_labels(m.labelnames, key)
                if isinstance(child, Histogram):
                    base = lbl[1:-1] if lbl else ""
                    ps = child.percentile((50, 95, 99))
                    for q, p in zip((0.5, 0.95, 0.99),
                                    ps if ps is not None else [None] * 3):
                        if p is None:
                            continue
                        qlbl = (f'{{{base + "," if base else ""}'
                                f'quantile="{q}"}}')
                        lines.append(f"{m.name}{qlbl} {float(p):.9g}")
                    lines.append(f"{m.name}_count{lbl} {child.count}")
                    lines.append(f"{m.name}_sum{lbl} {child.sum:.9g}")
                else:
                    lines.append(f"{m.name}{lbl} {child.value:.9g}")
        return "\n".join(lines) + ("\n" if lines else "")


#: process-wide default registry — the one scrape surface.  The engine
#: publishes its gauges here; servers default to private registries but
#: can be pointed at this one.
REGISTRY = MetricsRegistry()
