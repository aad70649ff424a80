"""Flash attention over ``(B, S, H, hd)`` — the wrapper of the hand-written
Hopper kernel in ``csrc/flash_attention.cu``, which replaces the TPU
kernel ``repro/kernels/flash_attention.py:flash_attention_pallas`` (the
note at the head of the source says what bounds it and what its design
does about that).

A CPU tensor goes to the plain PyTorch version,
:func:`flash_attention_plain` (``ref.flash_attention_ref``: the kernel's
arithmetic in one tile). A CUDA tensor launches the kernel or raises;
nothing falls back. ``launches`` counts kernel launches, and only
those."""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain", "launches",
           "SUPPORTED", "HEAD_DIMS"]

#: kernel launches since import (or since a caller last reset it)
launches = 0

#: dtype → the kernel's type code
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention").flash_attention_launch
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v: (B, S, H, hd) with the same H (repeat GQA heads outside).
    Returns (B, S, H, hd) in q's dtype."""
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape "
                         f"(B, S, H, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v lie on different devices")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    B, S, H, hd = q.shape
    if q.dtype not in SUPPORTED:
        raise TypeError(f"flash_attention takes "
                        f"{sorted(map(str, SUPPORTED))} on the card, got "
                        f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the hd axis contiguous")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's y limit 65535")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B and S and H:
        st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        arr = (ctypes.c_longlong * 12)(*st)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = _kernel()(SUPPORTED[q.dtype], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), B, S, H, hd, arr,
                            hd ** -0.5, int(causal), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err} (B={B}, S={S}, H={H}, hd={hd}, "
                               f"{q.dtype})")
        launches += 1
    return out
