"""GQA attention — the port of ``repro/models/attention.py``: the
hand-written flash kernel for prefill, plain torch ops for decode.

Prefill (:func:`attention`) repeats the KV heads up to H (head h reads
KV head h // G: ``repeat_interleave``, as ``jnp.repeat``) and runs the
causal flash kernel (``kernels.ops.flash_attention``) with Sq = Skv, in
place of the JAX package's two-level ``lax.scan`` (``_flash``). The
kernel applies ``hd**-0.5`` to the f32 scores; the JAX ``_flash`` scales
q in bf16 before the product — one of the roundings the tests' tolerance
covers.

Decode (:func:`decode_attention`) attends one new token against the KV
cache with einsum and softmax, as the JAX package does outside any
kernel. The new K/V are written into the cache at ``pos`` by an indexed
write, in place: the same values as the JAX one-hot blend
(``attention.py:167-171``) for finite entries, without its O(B·S) pass
per layer. A row whose ``pos`` is past the cache writes nothing, as the
blend's all-zero one-hot does."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from . import layers
from .layers import Linear, RMSNorm, apply_rope, linear, rmsnorm
from .sharding_hooks import constrain
from ..kernels import ops as kops
from ..kernels.ref import flash_attention_ref

__all__ = ["Attention", "attention", "decode_attention"]


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = Linear(d, h * hd, dtype, device)
        self.wk = Linear(d, kv * hd, dtype, device)
        self.wv = Linear(d, kv * hd, dtype, device)
        self.wo = Linear(h * hd, d, dtype, device)
        if cfg.qk_norm:
            self.qnorm = RMSNorm(hd, dtype, device)
            self.knorm = RMSNorm(hd, dtype, device)


def _project_qkv(p: Attention, cfg, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(p.wq, x).reshape(B, S, h, hd)
    k = linear(p.wk, x).reshape(B, S, kv, hd)
    v = linear(p.wv, x).reshape(B, S, kv, hd)
    if cfg.qk_norm:                   # the RMSNorm kernel on (…, hd) rows
        q = rmsnorm(p.qnorm, q, cfg.norm_eps)
        k = rmsnorm(p.knorm, k, cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flash(q, k, v, causal: bool):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) → (B,S,H,hd) through the kernel."""
    H, KVh = q.shape[2], k.shape[2]
    if KVh != H:                       # GQA -> MHA compute form
        k = constrain(k, "attn_kv_full")
        v = constrain(v, "attn_kv_full")
        k = k.repeat_interleave(H // KVh, dim=2)
        v = v.repeat_interleave(H // KVh, dim=2)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if layers.plain_route():
        return flash_attention_ref(q, k, v, causal)
    return kops.flash_attention(q, k, v, causal=causal)


def attention(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, kv_override=None) -> torch.Tensor:
    """Full-sequence attention (prefill)."""
    if kv_override is not None:
        raise NotImplementedError(
            "cross-attention (kv_override) comes with the enc-dec slice "
            "(ROADMAP Queue 1, item 4)")
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _flash(q, k, v, causal)
    B, S = x.shape[:2]
    return linear(p.wo, out.reshape(B, S, cfg.n_heads * cfg.hd))


# -- decode -------------------------------------------------------------------

def _write(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor):
    """cache[b, pos[b]] = new[b] for every row with pos[b] < S, in place."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    inside = pos < S
    at = torch.clamp(pos, max=S - 1)
    cache[rows, at] = torch.where(inside[:, None, None], new,
                                  cache[rows, at])


def decode_attention(p: Attention, cfg, x: torch.Tensor, pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); caches: (B,S,KV,hd), written in
    place; pos: (B,) current index. Returns (out, k_cache, v_cache)."""
    B = x.shape[0]
    S = k_cache.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = h // kv
    pos = pos.long()
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])
    _write(k_cache, pos, k_new[:, 0])
    _write(v_cache, pos, v_new[:, 0])

    qr = q.reshape(B, kv, G, hd) * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).to(torch.float32)
    mask = torch.arange(S, device=x.device)[None] <= pos[:, None]   # (B,S)
    s = s.masked_fill(~mask[:, None, None], -1e30)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache).to(x.dtype)
    out = out.reshape(B, 1, h * hd)
    return linear(p.wo, out), k_cache, v_cache
