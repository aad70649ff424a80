"""Structure-keyed request coalescing and batched serving on top of
:class:`~repro_torch.core.engine.PSelInvEngine` (the PyTorch port of
``repro/serve``).

:class:`SelInvServer` accepts single-matrix solve requests, hashes each
by block structure (the engine's structure sha1), coalesces
same-structure requests into batched solves under dynamic batch windows
(flush on max-batch, max-wait, queue pressure) with padded power-of-2
batch buckets, and streams results back per request with per-request
status. On the card each (structure, bucket) is one CUDA-graph capture
and every batch after it one replay.

Layout: ``batcher`` (requests, futures, windows, the coalescing
queues), ``server`` (the serving loop: admission, dispatch, failure
isolation), ``progcache`` (the on-disk cache of analyzed programs, with
runners captured in memory), ``metrics`` (latency percentiles, batch
occupancy, queue/rejection counters), ``traffic`` (the synthetic
mixed-structure Poisson harness).
"""
from .batcher import (BatchWindow, RequestStatus, RequestTimedOut,
                      ServeError, ServerOverloaded, SolveRequest,
                      StructureBatcher)
from .metrics import ServeMetrics
from .progcache import ProgramDiskCache
from .server import SelInvServer, ServeConfig

__all__ = ["SelInvServer", "ServeConfig", "BatchWindow", "SolveRequest",
           "RequestStatus", "StructureBatcher", "ServeMetrics",
           "ProgramDiskCache", "ServeError", "ServerOverloaded",
           "RequestTimedOut"]
