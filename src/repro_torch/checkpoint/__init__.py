"""repro_torch.checkpoint — the port of ``repro.checkpoint``: sharded
checkpoints with an async commit."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
