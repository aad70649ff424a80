"""repro_torch.models — the port of ``repro.models``: every config of
``configs/`` — the dense decoders, MoE (dbrx, grok), the mamba/attention
hybrid (jamba), xLSTM and the encoder-decoder (seamless) — with RMSNorm
and same-length attention on the hand-written kernels."""
from .registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
