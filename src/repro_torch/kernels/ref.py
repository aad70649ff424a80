"""Plain PyTorch oracles for the ported kernels (the allclose targets) —
the counterparts of ``repro/kernels/ref.py``, and the plain versions the
kernel modules run on a CPU tensor. The sum runs in the
accumulate type (f64 for f64 input, f32 otherwise), as the kernels';
RMSNorm and flash attention round where their kernels round."""
from __future__ import annotations

import torch

__all__ = ["gemm_ref", "gemm_acc_ref", "trsm_ref", "rmsnorm_ref",
           "flash_attention_ref"]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = _acc(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def gemm_acc_ref(acc, a, b, alpha=-1.0):
    t = _acc(a.dtype)
    return acc + (alpha * (a.to(t) @ b.to(t))).to(acc.dtype)


def trsm_ref(b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Solve X·U = B with U upper triangular (right-side TRSM — the
    supernodal LU's panel solve L(I,K) = A(I,K)·U(K,K)⁻¹); row-major, as
    the kernel writes X."""
    t = _acc(b.dtype)
    return torch.linalg.solve_triangular(u.to(t), b.to(t), upper=True,
                                         left=False).to(b.dtype).contiguous()


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis as the kernel computes it
    (``repro/kernels/rmsnorm.py:14-18``): statistics, normalization and
    scale all in the accumulate type, one rounding at the end."""
    t = _acc(x.dtype)
    xf = x.to(t)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(t)).to(x.dtype)


def flash_attention_ref(q, k, v, causal: bool = True):
    """q/k/v: (B, S, H, hd) — softmax attention as the kernel computes it
    (``repro/kernels/flash_attention.py:22-61``), in one tile: scores in
    the accumulate type, ``p = exp(s - max)`` rounded to v's dtype for the
    PV product, the unrounded row sum as denominator, one rounding at the
    end."""
    t = _acc(q.dtype)
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(t), k.to(t)) * hd ** -0.5
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30).transpose(1, 2)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(t), v.to(t))
    return (acc / den).to(q.dtype)
