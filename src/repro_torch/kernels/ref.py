"""Plain PyTorch oracles for the ported kernels (the allclose targets) —
the counterparts of ``repro/kernels/ref.py:11-18``. The sum runs in the
accumulate type (f64 for f64 input, f32 otherwise), as the kernel's."""
from __future__ import annotations

import torch

__all__ = ["gemm_ref", "gemm_acc_ref"]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = _acc(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def gemm_acc_ref(acc, a, b, alpha=-1.0):
    t = _acc(a.dtype)
    return acc + (alpha * (a.to(t) @ b.to(t))).to(acc.dtype)
