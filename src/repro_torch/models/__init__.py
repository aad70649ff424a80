"""repro_torch.models — the port of ``repro.models``: the dense decoders
(granite-3-2b, qwen3-32b, internlm2-20b, starcoder2-15b, internvl2-1b),
RMSNorm and prefill attention on the hand-written kernels."""
from .registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
