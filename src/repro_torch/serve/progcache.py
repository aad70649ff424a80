"""On-disk program cache for warm serving across restarts (the PyTorch
port of ``repro/serve/progcache.py``).

The JAX package persists compiled XLA executables. The port's
counterpart of a compile is a CUDA-graph capture
(:meth:`~repro_torch.core.engine.PSelInvEngine.aot_compile`), and a CUDA
graph cannot be persisted: it holds device addresses of one process. So
the disk holds what can be: the analyzed host program
(:class:`~repro_torch.core.pselinv_dist.PSelInvProgram`, numpy) — the
symbolic analysis, CommPlan, schedule and PlanLint a restart would
otherwise redo — and ``get`` captures the runner in memory from it.

:class:`ProgramDiskCache` keys each entry by everything that could
invalidate it: the structure sha1, supernode width, grid, plan options,
batch bucket, dtype, the torch and CUDA versions, the device's name and
the hand-written kernels' sources (``kernels._build.source_digest``).
``get`` returns the class runner: an in-memory hit; a disk hit, which
loads the program, uploads its tables and captures without analyzing;
or a miss, which stores the engine's analyzed program and captures.
Writes are atomic (tmp + ``os.replace``) so a crashed writer never
leaves a torn entry; a torn or stale entry counts a load error and is
rebuilt.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import threading
from typing import Dict

import torch

from ..core.engine import PSelInvEngine, structure_key
from ..core.pselinv_dist import (upload_exec_tables, upload_stream_tables,
                                 upload_tables)
from ..kernels import _build

__all__ = ["ProgramDiskCache"]


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class ProgramDiskCache:
    """Persisted analyzed programs + in-memory runners keyed by
    (structure, bucket, dtype, session + runtime parameters). One
    instance per directory; safe for concurrent ``get`` from one
    process (an in-memory layer fronts the disk)."""

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self._lock = threading.Lock()
        self._mem: Dict[str, object] = {}
        self._sessions: Dict[str, PSelInvEngine] = {}
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.load_errors = 0

    # ---- keying -------------------------------------------------------
    @staticmethod
    def _session_hash(engine) -> "hashlib._Hash":
        skey, b, grid, options, _dev = engine.key
        h = hashlib.sha1()
        h.update(skey.encode())
        h.update(repr((b, grid.pr, grid.pc, options)).encode())
        h.update(repr((torch.__version__, torch.version.cuda,
                       _device_name(engine.device))).encode())
        h.update(_build.source_digest().encode())
        return h

    @classmethod
    def cache_key(cls, engine, batch_size: int, dtype) -> str:
        """sha1 over every coordinate that could invalidate an entry."""
        h = cls._session_hash(engine)
        h.update(repr((int(batch_size), str(dtype))).encode())
        return h.hexdigest()

    def _entry(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.pselinv.pkl")

    # ---- the cache ----------------------------------------------------
    def get(self, engine, batch_size: int, dtype=torch.float32):
        """The batched runner for (engine, batch bucket, dtype):
        in-memory hit → disk hit (load the program, upload, capture) →
        store the engine's program + capture."""
        key = self.cache_key(engine, batch_size, dtype)
        with self._lock:
            run = self._mem.get(key)
            if run is not None:
                self.hits += 1
                return run
        session = self._load(key, engine)
        if session is not None:
            with self._lock:
                self.hits += 1
        else:
            with self._lock:
                self.misses += 1
            self._store(key, engine.program)
            session = engine
        run = session.aot_compile(batch_size=batch_size, dtype=dtype,
                                  batched=True)
        with self._lock:
            run = self._mem.setdefault(key, run)
        return run

    def _load(self, key: str, engine):
        """A session over the program stored under ``key``, its tables
        uploaded to the engine's device (one per stored structure and
        process), or None when there is no usable entry."""
        path = self._entry(key)
        if not os.path.exists(path):
            return None
        skey = self._session_hash(engine).hexdigest()
        with self._lock:
            session = self._sessions.get(skey)
        if session is not None:
            return session
        try:
            with open(path, "rb") as f:
                prog = pickle.load(f)
            if (structure_key(prog.bs) != engine.key[0]
                    or (prog.b, prog.pr, prog.pc, prog.nb)
                    != (engine.b, engine.grid.pr, engine.grid.pc,
                        engine.nb)):
                raise ValueError("stored program is another structure's")
        except Exception:            # torn/stale/incompatible entry:
            with self._lock:         # fall through to a fresh store
                self.load_errors += 1
            return None
        opts = engine.options
        upload = (upload_stream_tables if opts.stream else upload_tables
                  if opts.overlap else upload_exec_tables)
        session = PSelInvEngine(
            bs=prog.bs, b=prog.b, nb=prog.nb, grid=engine.grid,
            options=opts, program=prog, device=engine.device,
            tables=upload(prog, engine.device), key=engine.key)
        with self._lock:
            return self._sessions.setdefault(skey, session)

    def _store(self, key: str, program) -> None:
        blob = pickle.dumps(program, protocol=pickle.HIGHEST_PROTOCOL)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._entry(key))   # atomic publish
            with self._lock:
                self.stores += 1
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "stores": self.stores,
                    "load_errors": self.load_errors,
                    "entries": len([n for n in os.listdir(self.path)
                                    if n.endswith(".pselinv.pkl")])}
