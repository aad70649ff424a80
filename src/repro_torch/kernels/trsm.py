"""Right-side upper-triangular solve ``X·U = B`` — the wrapper of the
hand-written Hopper kernel in ``csrc/trsm.cu``, which replaces the TPU
kernel ``repro/kernels/trsm.py:trsm_pallas`` (the note at the head of the
source says what bounds it and what its design does about that).

A CPU tensor goes to the plain PyTorch version, :func:`trsm_plain`
(``torch.linalg.solve_triangular`` in the accumulate type). A CUDA tensor
launches the kernel or raises; nothing falls back. ``launches`` counts
kernel launches, and only those."""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import trsm_ref as trsm_plain

__all__ = ["trsm", "trsm_plain", "launches", "SUPPORTED", "MAX_K"]

#: kernel launches since import (or since a caller last reset it)
launches = 0

#: dtype → the kernel's type code (f32 / bf16 / f64)
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

#: the widest U the kernel takes (the TPU kernel's documented limit)
MAX_K = 256

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("trsm").trsm_launch
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def trsm(b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Solve ``X·U = B`` for ``b (…, m, k)`` and an upper-triangular
    ``u`` of shape ``(k, k)`` (one U for every batch item) or ``(…, k,
    k)`` with b's leading dims. Returns X ``(…, m, k)`` in b's dtype; the
    strict lower triangle of u is not read."""
    global launches
    if b.dtype not in SUPPORTED:
        raise TypeError(f"trsm takes {sorted(map(str, SUPPORTED))}, "
                        f"got {b.dtype}")
    if u.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {b.dtype} vs {u.dtype}")
    if u.device != b.device:
        raise ValueError(f"device mismatch: {b.device} vs {u.device}")
    if b.dim() < 2:
        raise ValueError(f"trsm takes (…, m, k) right-hand sides, got "
                         f"{tuple(b.shape)}")
    m, k = b.shape[-2:]
    lead = b.shape[:-2]
    if u.shape[-2:] != (k, k) or u.shape[:-2] not in ((), lead):
        raise ValueError(f"trsm shapes do not chain: X·{tuple(u.shape)} = "
                         f"{tuple(b.shape)}")
    if b.device.type == "cpu":
        return trsm_plain(b, u)
    if b.device.type != "cuda":
        raise ValueError(f"trsm runs on cpu or cuda, got {b.device}")
    if k > MAX_K:
        raise ValueError(f"trsm takes k <= {MAX_K}, got {k}")
    if not (b.is_contiguous() and u.is_contiguous()):
        raise ValueError("trsm takes contiguous operands")
    Z = math.prod(lead)
    if Z > 65535:
        raise ValueError(f"batch {Z} exceeds the grid's y limit 65535")
    x = torch.empty_like(b)
    if Z and m and k:
        su = k * k if u.dim() > 2 else 0
        stream = torch.cuda.current_stream(b.device).cuda_stream
        with torch.cuda.device(b.device):
            err = _kernel()(SUPPORTED[b.dtype], b.data_ptr(), u.data_ptr(),
                            x.data_ptr(), m, k, Z, su, stream)
        if err != 0:
            raise RuntimeError(f"trsm kernel launch failed: CUDA error {err}"
                               f" (m={m}, k={k}, Z={Z}, {b.dtype})")
        launches += 1
    return x
