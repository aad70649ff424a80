"""Plain PyTorch oracles for the ported kernels (the allclose targets) —
the counterparts of ``repro/kernels/ref.py``, and the plain versions the
kernel modules run on a CPU tensor. The sum runs in the
accumulate type (f64 for f64 input, f32 otherwise), as the kernels';
RMSNorm and flash attention round where their kernels round."""
from __future__ import annotations

import torch

__all__ = ["gemm_ref", "gemm_acc_ref", "trsm_ref", "rmsnorm_ref",
           "flash_attention_ref", "rmsnorm_bwd_ref", "flash_attention_bwd_ref"]


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


def flash_attention_ref(q, k, v, causal: bool = True, lse: bool = False):
    """q/k/v: (B, S, H, hd) — softmax attention as the kernel computes it
    (``repro/kernels/flash_attention.py:22-61``), in one tile: scores in
    the accumulate type, ``p = exp(s - max)`` rounded to v's dtype for the
    PV product, the unrounded row sum as denominator, one rounding at the
    end. With ``lse`` also each row's log-sum-exp ``max + log(sum)``,
    (B, H, S) in the accumulate type; the output is the same either
    way."""
    t = _acc(q.dtype)
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(t), k.to(t)) * hd ** -0.5
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30).transpose(1, 2)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(t), v.to(t))
    out = (acc / den).to(q.dtype)
    if lse:
        return out, (s.amax(dim=-1) + torch.log(
            den.transpose(1, 2)[..., 0]))
    return out


def _causal_keep(S: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def flash_attention_bwd_ref(q, k, v, out, dout, lse, causal: bool = True):
    """The gradient of :func:`flash_attention_ref` as the backward kernel
    computes it (FlashAttention-2): with s = q·kᵀ·hd^-0.5 (masked),
    P = exp(s − lse), D = rowsum(dout∘out), dS = P∘(dout·vᵀ − D):
    dv = Pᵀ·dout, dk = hd^-0.5·dSᵀ·q, dq = hd^-0.5·dS·k. Sums in the
    accumulate type; P and dS rounded to q's dtype as the operands of
    their products (the bf16 kernel's mma operands; no rounding in f32 or
    f64), each gradient rounded once to q's dtype. The rounding of p to
    v's dtype in the forward is taken as the identity."""
    t = _acc(q.dtype)
    S, hd = q.shape[1], q.shape[-1]
    scale = hd ** -0.5
    qf, kf, vf, of, gf = (x.to(t) for x in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.to(t)[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(S, q.device), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(t), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    D = (gf * of).sum(-1).transpose(1, 2)                   # (B, H, S)
    ds = (p * (dp - D[..., None])).to(q.dtype).to(t)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """The gradient of :func:`rmsnorm_ref` as the backward kernel computes
    it: with r = rsqrt(mean(x²) + eps), dx = r·(dy∘s) − x·r³·mean(dy∘s∘x),
    rounded once to x's dtype, and ds = Σ_rows dy∘x·r in the accumulate
    type."""
    t = _acc(x.dtype)
    xf, sf, gf = x.to(t), scale.to(t), dy.to(t)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = gf * sf
    dx = r * g - xf * (r ** 3 * (g * xf).mean(dim=-1, keepdim=True))
    ds = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), ds
