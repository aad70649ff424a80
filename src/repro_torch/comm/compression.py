"""Gradient compression for the slow cross-pod stage — the port of
``repro/comm/compression.py`` (no Pallas kernel lies behind it, so plain
torch is the port).

int8 block quantization with error feedback: the quantization residual
is carried to the next step (the standard EF-SGD construction), so
compressed cross-pod reduction stays unbiased in the long run. Blocks of
256; ``torch.round`` rounds half to even, as ``jnp.round`` does; an
all-zero block gets scale 1.0."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress", "ef_restore"]

_BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization of flattened ``x``: returns
    (q: int8 (nblocks, 256), scale: f32 (nblocks, 1)), the tail block
    zero-padded."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def ef_compress(grad: torch.Tensor, error: torch.Tensor):
    """Error-feedback compression: quantize (grad + carried error), return
    (q, scale, new_error)."""
    target = grad + error
    q, scale = quantize_int8(target)
    approx = dequantize_int8(q, scale, grad.shape, grad.dtype)
    return q, scale, target - approx


def ef_restore(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return dequantize_int8(q, scale, shape, dtype)
