"""repro_torch.runtime — the port of ``repro.runtime``: the serving loop
(``serve_loop``). The sharding policy (``runtime/sharding.py``) waits for
the multi-card slice and the training loop for the training slice."""
from .serve_loop import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
