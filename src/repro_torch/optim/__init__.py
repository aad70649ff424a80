"""repro_torch.optim — the port of ``repro.optim``: AdamW with the
global-norm clip folded into its update, and the warm-up cosine
schedule."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedules import cosine_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_warmup"]
