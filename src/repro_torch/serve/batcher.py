"""Request objects and structure-keyed coalescing queues — a copy of
``repro/serve/batcher.py`` (pure Python), so the port imports nothing of
the JAX package.

A :class:`SolveRequest` is one matrix's journey through the server:
``queued → batched → solved | failed | timed_out`` (or ``rejected`` at
admission). It doubles as the caller's future — :meth:`SolveRequest
.result` blocks until completion and returns the A⁻¹ shards or raises
the recorded error.

The :class:`StructureBatcher` holds one FIFO queue per structure key
and decides *when* a queue becomes a batch (the dynamic batch window):

- **max-batch**: a queue reaching ``max_batch`` flushes immediately —
  the batch the B=max_batch graph was captured for;
- **max-wait**: a queue whose oldest request has waited ``max_wait_ms``
  flushes with whatever coalesced — bounded added latency at low rate;
- **queue pressure**: when the *total* backlog across structures
  exceeds ``pressure``, the fullest queues flush immediately — the
  paper's load-balancing lesson (bound the concurrent work any one
  participant absorbs) applied to the serving queue, and the reason a
  burst drains at batch speed instead of waiting out its windows.

The batcher is not thread-safe by itself; the server serializes access
under its own condition variable.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["RequestStatus", "SolveRequest", "Batch", "BatchWindow",
           "StructureBatcher", "ServeError", "ServerOverloaded",
           "RequestTimedOut"]


class ServeError(RuntimeError):
    """Base class for serving-layer failures recorded on a request."""


class ServerOverloaded(ServeError):
    """Admission control rejected the request (queue at capacity)."""


class RequestTimedOut(ServeError, TimeoutError):
    """The request's deadline passed before a batch served it."""


class RequestStatus(str, Enum):
    QUEUED = "queued"
    BATCHED = "batched"
    SOLVED = "solved"
    FAILED = "failed"
    TIMED_OUT = "timed_out"
    REJECTED = "rejected"


_TERMINAL = (RequestStatus.SOLVED, RequestStatus.FAILED,
             RequestStatus.TIMED_OUT, RequestStatus.REJECTED)

_rid = itertools.count()


@dataclass
class SolveRequest:
    """One matrix's solve request + its future.

    Exactly one of ``matrix`` (raw, host-factorized at batch time) or
    ``values`` (pre-factorized ``SolveValues``-like pair in device
    layout) is set. ``skey`` is the engine structure sha1 the request
    coalesces under. ``deadline`` is an absolute ``time.monotonic``
    instant (None = no deadline)."""
    skey: str
    matrix: object = None
    values: object = None
    deadline: Optional[float] = None
    rid: int = field(default_factory=lambda: next(_rid))
    status: RequestStatus = RequestStatus.QUEUED
    submitted: float = field(default_factory=time.monotonic)
    batched_at: Optional[float] = None
    completed: Optional[float] = None
    error: Optional[BaseException] = None
    _result: object = field(default=None, repr=False)
    _done: threading.Event = field(default_factory=threading.Event,
                                   repr=False)

    def done(self) -> bool:
        return self.status in _TERMINAL

    def result(self, timeout: Optional[float] = None):
        """Block until the request completes; return the A⁻¹ shards
        (rank 5, this request's matrix only) or raise the recorded
        error. ``timeout`` (seconds) bounds the *wait*, not the
        request — a timed-out wait raises ``TimeoutError`` while the
        request stays in flight."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} still {self.status.value} after "
                f"waiting {timeout}s")
        if self.error is not None:
            raise self.error
        return self._result

    def _finish(self, status: RequestStatus, result=None,
                error: Optional[BaseException] = None) -> None:
        if self.done():            # first completion wins
            return
        self.status = status
        self._result = result
        self.error = error
        self.completed = time.monotonic()
        self._done.set()

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed is None:
            return None
        return self.completed - self.submitted


class Batch(list):
    """A flushed same-structure batch — a plain request list plus the
    flush ``cause`` the window policy recorded (``"full"``,
    ``"window"``, ``"pressure"`` or ``"force"``), so the serve spans and
    metrics can attribute every executed batch to the policy leg that
    released it."""

    __slots__ = ("cause",)

    def __init__(self, reqs, cause: str):
        super().__init__(reqs)
        self.cause = cause


@dataclass(frozen=True)
class BatchWindow:
    """The dynamic batch window knobs (see module docstring)."""
    max_batch: int = 16
    max_wait_ms: float = 2.0
    pressure: int = 64

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got "
                             f"{self.max_wait_ms}")
        if self.pressure < 1:
            raise ValueError(f"pressure must be >= 1, got "
                             f"{self.pressure}")


class StructureBatcher:
    """Per-structure FIFO queues + the flush policy."""

    def __init__(self, window: BatchWindow = BatchWindow()):
        self.window = window
        self._q: "OrderedDict[str, Deque[SolveRequest]]" = OrderedDict()

    def add(self, req: SolveRequest) -> None:
        self._q.setdefault(req.skey, deque()).append(req)

    def pending(self) -> int:
        return sum(len(q) for q in self._q.values())

    def pending_by_key(self) -> Dict[str, int]:
        return {k: len(q) for k, q in self._q.items() if q}

    def _pop_chunk(self, key: str, n: int) -> List[SolveRequest]:
        q = self._q[key]
        chunk = [q.popleft() for _ in range(min(n, len(q)))]
        if not q:
            del self._q[key]
        return chunk

    def next_due(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest future instant at which some queue's window or some
        request's deadline expires — the worker's sleep bound. None when
        nothing is pending."""
        due = None
        for q in self._q.values():
            for r in q:
                w = r.submitted + self.window.max_wait_ms * 1e-3
                due = w if due is None else min(due, w)
                if r.deadline is not None:
                    due = min(due, r.deadline)
        return due

    def pop_ready(self, now: Optional[float] = None, *,
                  force: bool = False
                  ) -> Tuple[List[List[SolveRequest]],
                             List[SolveRequest]]:
        """The flush decision: returns ``(batches, expired)`` where each
        batch is ≤ max_batch same-structure requests and ``expired``
        are requests whose deadline passed while queued (never joined a
        batch). ``force=True`` flushes everything regardless of windows
        (drain/shutdown)."""
        now = time.monotonic() if now is None else now
        expired: List[SolveRequest] = []
        for key in list(self._q):
            q = self._q[key]
            live = deque(r for r in q
                         if not (r.deadline is not None
                                 and r.deadline <= now))
            expired.extend(r for r in q
                           if r.deadline is not None and r.deadline <= now)
            if live:
                self._q[key] = live
            else:
                del self._q[key]

        batches: List[List[SolveRequest]] = []
        w = self.window
        for key in list(self._q):
            # full buckets always flush
            while key in self._q and len(self._q[key]) >= w.max_batch:
                batches.append(Batch(self._pop_chunk(key, w.max_batch),
                                     "full"))
            # window expiry flushes the remainder
            if key in self._q:
                oldest = self._q[key][0]
                if force or (now - oldest.submitted
                             >= w.max_wait_ms * 1e-3):
                    batches.append(Batch(
                        self._pop_chunk(key, w.max_batch),
                        "force" if force else "window"))

        # queue pressure: the total backlog must not sit waiting out
        # windows — flush the fullest queues until under the bound
        while self.pending() > w.pressure:
            key = max(self._q, key=lambda k: len(self._q[k]))
            batches.append(Batch(self._pop_chunk(key, w.max_batch),
                                 "pressure"))
        return batches, expired
