"""repro_torch.data — the port of ``repro.data``: the counter-based
synthetic token pipeline."""
from .pipeline import SyntheticTokens, make_batch_specs

__all__ = ["SyntheticTokens", "make_batch_specs"]
