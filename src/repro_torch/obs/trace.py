"""Lightweight span tracer.

Spans are nested context managers carrying free-form attributes and
monotonic (``time.perf_counter_ns``) timestamps.  Finished spans land in
a bounded, thread-safe ring buffer on the owning :class:`Tracer`; the
Chrome-trace exporter (``obs.export``) serialises them one lane per
thread.

Design constraints, in order:

1. **Near-zero overhead when disabled.**  ``tracer.span(...)`` on a
   disabled tracer returns a shared ``_NullSpan`` singleton — no span
   object is allocated, no clock is read, nothing is buffered.  This is
   what lets the engine leave trace calls inline on the ``solve`` hot
   path (the bench asserts ≤2 % overhead even *enabled*).
2. **Thread safety.**  The span stack is thread-local (nesting never
   crosses threads — a serve worker's spans parent to that worker's
   stack); the ring buffer append is guarded by a lock shared with
   ``spans()`` snapshots.
3. **Bounded memory.**  The buffer is a ``deque(maxlen=capacity)``;
   overflow drops the *oldest* span and bumps ``tracer.dropped``.
4. **One clock with the device.**  While a ``torch.profiler`` records,
   every span also opens a ``record_function`` range of its name — even
   on a disabled tracer — so the spans sit in the profiler's trace,
   beside the kernels they launched, on the profiler's clock. The
   range's name carries the attributes in :data:`RANGE_ATTRS`
   (``graph.replay graph=3``), which name what a launch ran. With no
   profiler and the tracer disabled, ``span()`` is the null span.

A span opened inside another inherits the attributes in
:data:`INHERITED` it does not set itself: the ``call`` id of an
``engine.solve`` span is shared by the spans of that call.

Typical use::

    from repro_torch.obs.trace import TRACER
    TRACER.enable()
    with TRACER.span("engine.solve", B=4) as sp:
        ...
        sp.set(bucket=8)
    events = TRACER.spans()
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch.autograd.profiler as _profiler

__all__ = ["Span", "Tracer", "TRACER", "RANGE_ATTRS", "INHERITED"]

#: attributes a profiler range carries in its name
RANGE_ATTRS = ("graph",)
#: attributes a span takes from the span it opens inside
INHERITED = ("call",)


def _range_name(name: str, attrs: Dict[str, Any]) -> str:
    return name + "".join(f" {k}={attrs[k]}" for k in RANGE_ATTRS
                          if k in attrs)


@dataclass(frozen=True)
class Span:
    """One *finished* span — an immutable record in the ring buffer."""

    name: str
    t0_us: float                 #: start, microseconds on the monotonic clock
    dur_us: float                #: wall duration, microseconds
    span_id: int
    parent_id: Optional[int]     #: enclosing span on the same thread, if any
    tid: int                     #: OS thread ident that ran the span
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def t1_us(self) -> float:
        return self.t0_us + self.dur_us


class _NullSpan:
    """Shared no-op span returned by disabled tracers.

    A single module-level instance serves every disabled ``span()``
    call, so the disabled path allocates nothing per call (tested).
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _RangeSpan:
    """A disabled tracer's span while a profiler records: the profiler
    range alone, nothing buffered."""

    __slots__ = ("_range",)

    def __init__(self, name: str) -> None:
        self._range = _profiler.record_function(name)

    def __enter__(self) -> "_RangeSpan":
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        return False

    def set(self, **attrs: Any) -> "_RangeSpan":
        return self


class _ActiveSpan:
    """A live span: context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id",
                 "tid", "_t0_ns", "_range")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.tid = 0
        self._t0_ns = 0
        self._range = None

    def set(self, **attrs: Any) -> "_ActiveSpan":
        """Attach/overwrite attributes mid-span; chainable."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        stack = self._tracer._stack()
        if stack:
            self.parent_id = stack[-1].span_id
            for k in INHERITED:
                if k in stack[-1].attrs:
                    self.attrs.setdefault(k, stack[-1].attrs[k])
        self.tid = threading.get_ident()
        stack.append(self)
        if _profiler._is_profiler_enabled:     # a profiler records
            self._range = _profiler.record_function(
                _range_name(self.name, self.attrs))
            self._range.__enter__()
        # read the clock last so setup cost is outside the measured window
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:                               # unbalanced exit; don't corrupt
            try:
                stack.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._record(Span(
            name=self.name,
            t0_us=self._t0_ns / 1e3,
            dur_us=(t1_ns - self._t0_ns) / 1e3,
            span_id=self.span_id,
            parent_id=self.parent_id,
            tid=self.tid,
            attrs=self.attrs,
        ))
        return False


class Tracer:
    """Span collector with an enable switch and a bounded ring buffer."""

    def __init__(self, capacity: int = 65536, enabled: bool = False) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.dropped = 0
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    # -- control ----------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # -- emission ---------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Open a span.  Disabled tracers return the shared null span,
        or while a profiler records a bare profiler range."""
        if not self.enabled:
            if _profiler._is_profiler_enabled:  # a profiler records
                return _RangeSpan(_range_name(name, attrs))
            return _NULL
        return _ActiveSpan(self, name, attrs)

    def instant(self, name: str, **attrs: Any) -> None:
        """Record a zero-duration marker (e.g. a flush decision)."""
        if not self.enabled:
            return
        now = time.perf_counter_ns() / 1e3
        stack = self._stack()
        self._record(Span(name=name, t0_us=now, dur_us=0.0,
                          span_id=next(self._ids),
                          parent_id=stack[-1].span_id if stack else None,
                          tid=threading.get_ident(), attrs=attrs))

    # -- inspection -------------------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    # -- internals --------------------------------------------------------
    def _stack(self) -> List[_ActiveSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(span)


#: process-wide default tracer used by the engine and serve layers;
#: disabled until something calls ``TRACER.enable()``.
TRACER = Tracer()
