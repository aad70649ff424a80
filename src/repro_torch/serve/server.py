"""SelInvServer — the serving loop over :class:`PSelInvEngine` (the
PyTorch port of ``repro/serve/server.py``).

``submit(A)`` fingerprints the matrix's sparsity pattern (sha1 over the
CSR indptr/indices — cheap, no symbolic work on the hot path), maps it
to a warm engine (``PSelInvEngine.analyze`` runs once per new pattern
and after that every lookup is a dict hit), admission-checks the queue,
and hands back a :class:`~.batcher.SolveRequest` future. A worker —
either the background thread (``start()``/context manager) or the
caller via ``pump()``/``drain()`` — pops ready same-structure batches
from the :class:`~.batcher.StructureBatcher` and serves each one:

- per-request pattern check (``check_values_pattern``) so a request
  whose values escape its claimed structure fails *alone* — its batch
  neighbors still solve, bit-identical to their unbatched solves;
- batched host factorization (``prepare_values_many``) — the supernode
  loop runs once for the whole batch;
- one bucket-padded ``engine.solve`` call — on the card one replay of
  the (structure, bucket) class's CUDA graph, captured on the class's
  first batch — or the program cache's runner when configured;
- one device→host copy of the batch's A⁻¹ shards, per-request result
  slicing (numpy arrays) + completion, latency and occupancy recorded in
  :class:`~.metrics.ServeMetrics`.

A failed batch marks only its own requests FAILED; the server and the
engine survive for the next window. A served request drops its payload
(matrix or value shards) so the server's bounded request history holds
no device memory.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..core.engine import (Grid, PlanOptions, PSelInvEngine, SolveValues,
                           bucket_size, stack_values)
from ..core.pselinv_dist import check_values_pattern
from ..obs.trace import TRACER
from .batcher import (BatchWindow, RequestStatus, RequestTimedOut,
                      ServeError, ServerOverloaded, SolveRequest,
                      StructureBatcher)
from .metrics import ServeMetrics

__all__ = ["SelInvServer", "ServeConfig"]


def _pattern_fingerprint(A) -> str:
    """sha1 of the sparsity pattern (shape + CSR indptr/indices). Two
    matrices with one pattern share a fingerprint — and therefore a
    warm engine — without re-running symbolic analysis per request."""
    import scipy.sparse as sp
    C = sp.csr_matrix(A)
    h = hashlib.sha1()
    h.update(np.asarray(C.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(C.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(C.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class ServeConfig:
    """Server knobs. ``b``/``grid``/``options``/``device`` are the engine
    session parameters every request is analyzed under (``device``
    defaults to the card, as every entry point of the port); ``window``
    is the dynamic batch window; ``max_queue`` the admission bound
    (requests beyond it are REJECTED); ``dtype`` the solve's
    ``torch.dtype``; ``bucket`` pads batches to power-of-2 buckets;
    ``batched_prep`` routes host factorization through the stacked pass;
    ``prog_cache`` (a :class:`~.progcache.ProgramDiskCache`) serves
    batches through its runners instead of the engine's own — off by
    default so ``engine.trace_count`` stays the one-capture-per-(
    structure, bucket) ground truth."""
    b: int = 8
    grid: Grid = Grid(1, 1)
    options: PlanOptions = PlanOptions()
    window: BatchWindow = BatchWindow()
    max_queue: int = 256
    dtype: torch.dtype = torch.float32
    bucket: bool = True
    batched_prep: bool = True
    default_timeout_ms: Optional[float] = None
    prog_cache: Optional[object] = None
    device: str = "cuda"


class SelInvServer:
    """Structure-keyed request coalescing + batched serving."""

    def __init__(self, config: ServeConfig = ServeConfig()):
        self.cfg = config
        self.metrics = ServeMetrics()
        self._batcher = StructureBatcher(config.window)
        self._cond = threading.Condition()
        self._engines: "OrderedDict[str, PSelInvEngine]" = OrderedDict()
        self._fp2skey: Dict[str, str] = {}
        self._buckets_used: Dict[str, Set[int]] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # bounded lifecycle history for the Chrome-trace exporter
        self._history: "deque[SolveRequest]" = deque(maxlen=4096)

    # ---- engine lookup ------------------------------------------------
    def engine_for(self, A) -> PSelInvEngine:
        """The warm engine for A's sparsity pattern. First sight of a
        pattern runs symbolic analysis + table upload via
        ``PSelInvEngine.analyze`` (itself structure-cached); every later
        submit of the pattern is a fingerprint dict hit."""
        fp = _pattern_fingerprint(A)
        skey = self._fp2skey.get(fp)
        if skey is not None:
            eng = self._engines.get(skey)
            if eng is not None:
                return eng
        eng = PSelInvEngine.analyze(A, b=self.cfg.b, grid=self.cfg.grid,
                                    options=self.cfg.options,
                                    device=self.cfg.device)
        skey = eng.key[0]
        self._fp2skey[fp] = skey
        self._engines[skey] = eng
        return eng

    # ---- submission ---------------------------------------------------
    def _admit(self, req: SolveRequest) -> SolveRequest:
        with TRACER.span("serve.admission", rid=req.rid,
                         skey=req.skey[:12]) as sp:
            with self._cond:
                if self._batcher.pending() >= self.cfg.max_queue:
                    self.metrics.inc("rejected")
                    sp.set(outcome="rejected")
                    req._finish(RequestStatus.REJECTED,
                                error=ServerOverloaded(
                                    f"queue at capacity "
                                    f"({self.cfg.max_queue} pending)"))
                    return req
                self._batcher.add(req)
                sp.set(outcome="queued",
                       queue_depth=self._batcher.pending())
                self.metrics.set_queue_depth(self._batcher.pending())
                self._cond.notify()
        return req

    def _deadline(self, timeout_ms: Optional[float]) -> Optional[float]:
        if timeout_ms is None:
            timeout_ms = self.cfg.default_timeout_ms
        return (time.monotonic() + timeout_ms * 1e-3
                if timeout_ms is not None else None)

    def submit(self, A, timeout_ms: Optional[float] = None
               ) -> SolveRequest:
        """Enqueue one matrix; returns its :class:`SolveRequest` future
        immediately (possibly already REJECTED by admission control).
        ``timeout_ms`` (or the config default) bounds queue+solve time:
        a request still queued past its deadline completes TIMED_OUT."""
        self.metrics.inc("submitted")
        eng = self.engine_for(A)
        return self._admit(SolveRequest(skey=eng.key[0], matrix=A,
                                        deadline=self._deadline(timeout_ms)))

    def submit_values(self, eng: PSelInvEngine, values: SolveValues,
                      timeout_ms: Optional[float] = None
                      ) -> SolveRequest:
        """Enqueue pre-factorized rank-5 value shards for an engine the
        caller already holds (skips the host factorization AND the
        per-request pattern check — the caller vouches for layout)."""
        self.metrics.inc("submitted")
        self._engines.setdefault(eng.key[0], eng)
        return self._admit(SolveRequest(skey=eng.key[0], values=values,
                                        deadline=self._deadline(timeout_ms)))

    # ---- serving ------------------------------------------------------
    def _expire(self, expired: List[SolveRequest]) -> None:
        for r in expired:
            self.metrics.inc("timed_out")
            r._finish(RequestStatus.TIMED_OUT,
                      error=RequestTimedOut(
                          f"request {r.rid} missed its deadline "
                          f"while queued"))
        self._release(expired)

    def _serve_batch(self, reqs: List[SolveRequest]) -> None:
        """Serve one same-structure batch end to end. Never raises:
        per-request pattern failures and whole-batch solve failures
        land on the affected requests as FAILED."""
        eng = self._engines[reqs[0].skey]
        cause = getattr(reqs, "cause", None)
        now = time.monotonic()
        for r in reqs:
            r.status = RequestStatus.BATCHED
            r.batched_at = now

        with TRACER.span("serve.batch", skey=reqs[0].skey[:12],
                         n=len(reqs), cause=cause or "?") as sp:
            # per-request admission of the *values* against the claimed
            # structure: a matrix whose pattern escapes it fails alone
            live: List[SolveRequest] = []
            for r in reqs:
                if r.matrix is not None:
                    try:
                        check_values_pattern(r.matrix, eng.bs, eng.b)
                    except ValueError as e:
                        self.metrics.inc("failed")
                        r._finish(RequestStatus.FAILED, error=ServeError(
                            f"request {r.rid}: {e}"))
                        continue
                live.append(r)
            self._remember(reqs)
            if not live:
                self._release(reqs)
                return

            try:
                vals = self._prepare(eng, live)
                B = vals.Lh.shape[0]
                bkt = bucket_size(B) if self.cfg.bucket else B
                sp.set(B=B, bucket=bkt)
                # one device→host copy for the whole batch: per-request
                # slicing of device tensors would copy once per request
                out = self._execute(eng, vals, B, bkt).cpu().numpy()
                self.metrics.observe_batch(B, bkt, cause=cause)
                self._buckets_used.setdefault(reqs[0].skey, set()).add(bkt)
                for i, r in enumerate(live):
                    self.metrics.inc("solved")
                    r._finish(RequestStatus.SOLVED, result=out[i])
                    self.metrics.observe_latency(r.latency_s)
            except Exception as e:               # noqa: BLE001 — isolate
                for r in live:
                    self.metrics.inc("failed")
                    r._finish(RequestStatus.FAILED, error=ServeError(
                        f"batch of {len(live)} failed: {e}"))
            self._release(reqs)

    @staticmethod
    def _release(reqs: List[SolveRequest]) -> None:
        for r in reqs:
            r.matrix = r.values = None

    def _prepare(self, eng: PSelInvEngine,
                 reqs: List[SolveRequest]) -> SolveValues:
        """Host numeric factorization for the batch: matrix-bearing
        requests go through the stacked pass, pre-factorized value
        requests slot in at their position (each cast to the solve's
        dtype on the session's device, so a mixed batch stacks)."""
        mat_idx = [i for i, r in enumerate(reqs) if r.values is None]
        if len(mat_idx) == len(reqs):        # all-matrix batch (the
            mats = [r.matrix for r in reqs]  # common path): the stacked
            if self.cfg.batched_prep and len(mats) > 1:  # prep already
                return eng.prepare_values_many(mats)     # IS the batch
            return stack_values([eng.prepare_values(M) for M in mats])

        def cast(v):
            return SolveValues(*(eng._as_tensor(x, self.cfg.dtype)
                                 for x in v))
        per: List[Optional[SolveValues]] = [
            cast(r.values) if r.values is not None else None for r in reqs]
        if mat_idx:
            mats = [reqs[i].matrix for i in mat_idx]
            if self.cfg.batched_prep and len(mats) > 1:
                mv = eng.prepare_values_many(mats)
            else:
                mv = stack_values([eng.prepare_values(M) for M in mats])
            for j, i in enumerate(mat_idx):
                per[i] = cast(SolveValues(mv.Lh[j], mv.Dinv[j]))
        return stack_values(per)

    def _execute(self, eng: PSelInvEngine, vals: SolveValues,
                 B: int, bkt: int) -> torch.Tensor:
        """One device-side sweep for the batch: the engine's counted
        class runner (the default — ``trace_count`` stays the
        one-capture-per-(structure, bucket) ground truth) or the program
        cache's runner for the bucket, which zero-pads the lanes past
        the batch itself."""
        if self.cfg.prog_cache is not None:
            run = self.cfg.prog_cache.get(eng, bkt, self.cfg.dtype)
            return run(eng._as_tensor(vals.Lh, self.cfg.dtype),
                       eng._as_tensor(vals.Dinv, self.cfg.dtype))
        return eng.solve(vals, dtype=self.cfg.dtype,
                         bucket=self.cfg.bucket)

    # ---- synchronous driving ------------------------------------------
    def pump(self, *, force: bool = False) -> int:
        """Serve every currently-ready batch (and expire overdue
        requests) on the caller's thread; returns the number of batches
        served. ``force=True`` flushes partial windows immediately."""
        with self._cond:
            batches, expired = self._batcher.pop_ready(force=force)
            self.metrics.set_queue_depth(self._batcher.pending())
        self._expire(expired)
        for batch in batches:
            self._serve_batch(batch)
        return len(batches)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Flush and serve everything pending (on this thread when no
        worker is running, else wait for the worker to empty the
        queue)."""
        if self._thread is None:
            while self._batcher.pending():
                self.pump(force=True)
            return
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cond:
            self._drain_asap = True
            self._cond.notify()
            while self._batcher.pending():
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0:
                    raise TimeoutError("drain timed out")
                self._cond.wait(timeout=0.01 if left is None
                                else min(0.01, left))
        self._drain_asap = False

    # ---- the background worker ----------------------------------------
    def start(self) -> "SelInvServer":
        if self._thread is not None:
            return self
        self._running = True
        self._drain_asap = False
        self._thread = threading.Thread(target=self._worker,
                                        name="selinv-serve",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join()
        self._thread = None
        # whatever is still queued at shutdown completes FAILED rather
        # than leaving callers blocked forever
        batches, expired = self._batcher.pop_ready(force=True)
        self._expire(expired)
        for batch in batches:
            for r in batch:
                self.metrics.inc("failed")
                r._finish(RequestStatus.FAILED,
                          error=ServeError("server stopped"))
            self._release(batch)

    def __enter__(self) -> "SelInvServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._running and self._batcher.pending() == 0:
                    self._cond.wait()
                if not self._running:
                    return
                now = time.monotonic()
                force = getattr(self, "_drain_asap", False)
                batches, expired = self._batcher.pop_ready(now,
                                                           force=force)
                if not batches and not expired:
                    due = self._batcher.next_due(now)
                    wait = (max(1e-4, due - now) if due is not None
                            else None)
                    self._cond.wait(timeout=wait)
                    continue
                self.metrics.set_queue_depth(self._batcher.pending())
            self._expire(expired)
            for batch in batches:
                self._serve_batch(batch)
            with self._cond:
                self._cond.notify_all()       # wake drain() waiters

    # ---- observability ------------------------------------------------
    def _remember(self, reqs: List[SolveRequest]) -> None:
        with self._cond:
            self._history.extend(reqs)

    def recent_requests(self) -> List[SolveRequest]:
        """The most recent served requests (bounded window), for
        :func:`repro_torch.obs.export.chrome_trace` lifecycle lanes."""
        with self._cond:
            return list(self._history)

    def stats(self) -> Dict:
        """One coherent serving snapshot: request/latency/occupancy
        metrics, queue depth, per-structure captured-bucket census
        (``trace_count``: the engine's runner builds — one capture per
        (structure, bucket) on the card), the engine structure-cache
        health counters, and the program-cache hit/miss/store counters
        when one is configured."""
        out = self.metrics.snapshot()
        out["queue_depth"] = self._batcher.pending()
        out["structures"] = {
            skey[:12]: {"buckets_used":
                        sorted(self._buckets_used.get(skey, ())),
                        "trace_count": eng.trace_count,
                        "solve_calls": eng.solve_calls}
            for skey, eng in self._engines.items()}
        out["engine_cache"] = {
            "engines": len(PSelInvEngine._cache),
            "bytes": PSelInvEngine.cache_bytes(),
            "hits": PSelInvEngine.cache_hits,
            "misses": PSelInvEngine.cache_misses,
            "evictions": PSelInvEngine.cache_evictions}
        if self.cfg.prog_cache is not None:
            out["prog_cache"] = self.cfg.prog_cache.stats()
        return out
