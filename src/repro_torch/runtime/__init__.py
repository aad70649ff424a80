"""repro_torch.runtime — the port of ``repro.runtime``: the serving loop
(``serve_loop``) and the fault-tolerant training loop (``train_loop``).
The sharding policy (``runtime/sharding.py``) waits for the multi-card
slice."""
from .serve_loop import Request, ServeEngine
from .train_loop import TrainLoopConfig, run_train_loop

__all__ = ["Request", "ServeEngine", "TrainLoopConfig", "run_train_loop"]
