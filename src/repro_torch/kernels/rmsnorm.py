"""RMSNorm over the last axis — the wrapper of the hand-written Hopper
kernel in ``csrc/rmsnorm.cu``, which replaces the TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm_pallas`` (the note at the head of the
source says what bounds it and what its design does about that).

A CPU tensor goes to the plain PyTorch version, :func:`rmsnorm_plain`
(the kernel's arithmetic: f32 statistics and scale, one rounding). A CUDA
tensor launches the kernel or raises; nothing falls back. ``launches``
counts kernel launches, and only those."""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import rmsnorm_ref as rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_plain", "launches", "SUPPORTED"]

#: kernel launches since import (or since a caller last reset it)
launches = 0

#: dtype → the kernel's type code
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("rmsnorm").rmsnorm_launch
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x², -1) + eps) * scale`` for ``x (…, d)`` and
    ``scale (d,)``; returns x's shape and dtype."""
    global launches
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm takes x (…, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"device mismatch: {x.device} vs {scale.device}")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, got {x.device}")
    if x.dtype not in SUPPORTED:
        raise TypeError(f"rmsnorm takes {sorted(map(str, SUPPORTED))} on "
                        f"the card, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm takes a contiguous x")
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    out = torch.empty_like(x)
    s32 = scale.to(torch.float32).contiguous()
    if rows and d:
        per = 16 // x.element_size()
        vec = int(d % per == 0 and x.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = _kernel()(SUPPORTED[x.dtype], vec, x.data_ptr(),
                            s32.data_ptr(), out.data_ptr(), rows, d,
                            float(eps), stream)
        if err != 0:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error "
                               f"{err} (rows={rows}, d={d}, {x.dtype})")
        launches += 1
    return out
