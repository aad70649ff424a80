"""repro_torch.runtime — the port of ``repro.runtime``: the serving loop
(``serve_loop``), the fault-tolerant training loop (``train_loop``) and
the sharding rules of the mesh (``sharding``, imported by name)."""
from .serve_loop import Request, ServeEngine
from .train_loop import TrainLoopConfig, run_train_loop

__all__ = ["Request", "ServeEngine", "TrainLoopConfig", "run_train_loop"]
