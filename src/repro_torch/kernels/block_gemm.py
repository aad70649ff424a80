"""Batched block-strided GEMM — the wrapper of the hand-written Hopper
kernel in ``csrc/block_gemm.cu`` (which replaces the TPU kernel
``repro/kernels/block_gemm.py:block_gemm_pallas``; the note at the head
of the source says what bounds it and what its design does about that).

Two entry points share the one kernel:

* :func:`block_gemm` — ``alpha · (a @ b)`` for contiguous row-major
  ``(…, m, k) @ (…, k, n)`` stacks;
* :func:`blocked_gemm` — the selected-inversion sweep's level product
  ``partial[z, k, i] = Σ_j ainv[z, i, j] @ uh[z, k, j]ᵀ`` over blocked
  ``(Z, nbr, nbc, b, b)`` / ``(Z, nk, nbc, b, b)`` tensors, read (and
  written, through ``out``) where they lie — views into the sweep's
  arena included — without the reshape copies of the JAX package.

A CPU tensor goes to the plain PyTorch version beside each entry point
(:func:`block_gemm_plain`, :func:`blocked_gemm_plain`): the same
function, accumulated in the accumulate type. A CUDA tensor launches the
kernel or raises; nothing falls back. ``launches`` counts kernel
launches, and only those."""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["block_gemm", "blocked_gemm", "block_gemm_plain",
           "blocked_gemm_plain", "acc_dtype", "launches", "SUPPORTED"]

#: kernel launches since import (or since a caller last reset it)
launches = 0

#: dtype → the kernel's type code (f32 / bf16 / f64)
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

_fn = None


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulate type: f64 for f64 input, f32 for f32 and bf16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("block_gemm").block_gemm_launch
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_double,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _check(*ts: torch.Tensor) -> str:
    """Common device/dtype checks; returns the device type."""
    dt, dev = ts[0].dtype, ts[0].device
    if dt not in SUPPORTED:
        raise TypeError(f"block_gemm takes {sorted(map(str, SUPPORTED))}, "
                        f"got {dt}")
    for t in ts[1:]:
        if t.dtype != dt:
            raise TypeError(f"dtype mismatch: {dt} vs {t.dtype}")
        if t.device != dev:
            raise ValueError(f"device mismatch: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"block_gemm runs on cpu or cuda, got {dev}")
    return dev.type


def _launch(a, b, c, M, N, K, Z, alpha, desc) -> None:
    """One kernel launch on the current stream; raises on a refused
    launch (the C side returns ``cudaGetLastError()``)."""
    global launches
    if Z > 65535:
        raise ValueError(f"batch {Z} exceeds the grid's z limit 65535")
    arr = (ctypes.c_longlong * 21)(*[int(v) for v in desc])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _kernel()(SUPPORTED[a.dtype], a.data_ptr(), b.data_ptr(),
                        c.data_ptr(), M, N, K, Z, float(alpha), arr, stream)
    if err != 0:
        raise RuntimeError(f"block_gemm kernel launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, K={K}, Z={Z}, "
                           f"{a.dtype})")
    launches += 1


# ---- row-major stacks ------------------------------------------------------

def block_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     alpha: float = 1.0) -> torch.Tensor:
    """``alpha · (a @ b)`` in the accumulate type, cast back."""
    acc = acc_dtype(a.dtype)
    return (alpha * (a.to(acc) @ b.to(acc))).to(a.dtype)


def block_gemm(a: torch.Tensor, b: torch.Tensor,
               alpha: float = 1.0) -> torch.Tensor:
    """``alpha · (a @ b)`` for ``a (…, m, k)``, ``b (…, k, n)`` with equal
    leading (batch) dims; returns ``(…, m, n)`` in the input dtype."""
    dev = _check(a, b)
    if a.dim() < 2 or b.dim() != a.dim() or a.shape[:-2] != b.shape[:-2] \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"block_gemm shapes do not chain: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if dev == "cpu":
        return block_gemm_plain(a, b, alpha)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_gemm takes contiguous operands")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    lead = a.shape[:-2]
    Z = math.prod(lead)
    c = torch.empty(lead + (m, n), dtype=a.dtype, device=a.device)
    if Z and m and n:
        desc = (m * k, m, 0, k, k, 0, 1,
                k * n, k, 0, n, n, 0, 1,
                m * n, m, 0, n, n, 0, 1)
        _launch(a, b, c, m, n, k, Z, alpha, desc)
    return c


# ---- the sweep's blocked level product ------------------------------------

def blocked_gemm_plain(ainv: torch.Tensor, uh: torch.Tensor) -> torch.Tensor:
    """``partial[z, k, i] = Σ_j ainv[z, i, j] @ uh[z, k, j]ᵀ`` as one 2-D
    product per z (the JAX package's reshape/transpose layout,
    ``repro/kernels/ops.py:49-57``), in the accumulate type. One fixed
    shape per z keeps the result independent of the batch size."""
    Z, nbr, nbc, b, _ = ainv.shape
    nk = uh.shape[1]
    acc = acc_dtype(ainv.dtype)
    if Z == 0:
        return ainv.new_empty((0, nk, nbr, b, b))
    outs = []
    for z in range(Z):
        a2 = ainv[z].to(acc).permute(0, 2, 1, 3).reshape(nbr * b, nbc * b)
        b2 = uh[z].to(acc).permute(1, 3, 0, 2).reshape(nbc * b, nk * b)
        outs.append((a2 @ b2).reshape(nbr, b, nk, b).permute(2, 0, 1, 3))
    return torch.stack(outs).to(ainv.dtype)


def blocked_gemm(ainv: torch.Tensor, uh: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The level product over ``ainv (Z, nbr, nbc, b, b)`` and
    ``uh (Z, nk, nbc, b, b)``, returning ``(Z, nk, nbr, b, b)``. Each
    (b, b) block must be contiguous; the block grids may be strided
    views. ``out``, when given, receives the result in place and must
    not overlap the inputs."""
    dev = _check(ainv, uh) if out is None else _check(ainv, uh, out)
    if ainv.dim() != 5 or uh.dim() != 5:
        raise ValueError(f"blocked_gemm takes rank-5 block grids, got "
                         f"{tuple(ainv.shape)} and {tuple(uh.shape)}")
    Z, nbr, nbc, b, b2 = ainv.shape
    nk = uh.shape[1]
    if b != b2 or uh.shape != (Z, nk, nbc, b, b):
        raise ValueError(f"blocked_gemm shapes do not chain: "
                         f"{tuple(ainv.shape)} x {tuple(uh.shape)}")
    oshape = (Z, nk, nbr, b, b)
    if out is not None and tuple(out.shape) != oshape:
        raise ValueError(f"out has shape {tuple(out.shape)}, "
                         f"expected {oshape}")
    if dev == "cpu":
        res = blocked_gemm_plain(ainv, uh)
        if out is None:
            return res
        return out.copy_(res)
    if out is None:
        out = torch.empty(oshape, dtype=ainv.dtype, device=ainv.device)
    for name, t in (("ainv", ainv), ("uh", uh), ("out", out)):
        if t.stride(-1) != 1 or t.stride(-2) != b:
            raise ValueError(f"blocked_gemm needs contiguous (b, b) blocks "
                             f"in {name}, got strides {t.stride()}")
    if Z and nbr and nk:
        sa, sb, so = ainv.stride(), uh.stride(), out.stride()
        desc = (sa[0], b, sa[1], sa[3], b, sa[2], sa[4],    # A: (i,a) x (j,c)
                sb[0], b, sb[2], sb[4], b, sb[1], sb[3],    # B: (j,x) x (k,y)
                so[0], b, so[2], so[3], b, so[1], so[4])    # C: (i,a) x (k,y)
        _launch(ainv, uh, out, nbr * b, nk * b, nbc * b, Z, 1.0, desc)
    return out
