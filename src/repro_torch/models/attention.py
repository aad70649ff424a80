"""GQA attention — the port of ``repro/models/attention.py``: the
hand-written flash kernel for prefill, plain torch ops for decode.

Prefill and the encoder (:func:`attention`) repeat the KV heads up to H
(head h reads KV head h // G: ``repeat_interleave``, as ``jnp.repeat``)
and run the flash kernel (``kernels.ops.flash_attention``, causal or
not) with Sq = Skv, in place of the JAX package's two-level ``lax.scan``
(``_flash``). The kernel applies ``hd**-0.5`` to the f32 scores; the JAX
``_flash`` scales q in bf16 before the product — one of the roundings the
tests' tolerance covers.

Cross-attention (``attention(kv_override=(k, v))``, the enc-dec
decoder) has Sq ≠ Skv, which the kernel, like the TPU kernel, does not
take: it runs as plain torch ops (:func:`_cross`) with the JAX
``_flash`` numerics — q scaled in bf16, bf16 scores taken to f32, the
probabilities cast to bf16 before the PV product — never causal. Only q
is projected (JAX projects k and v too and discards them); no RoPE or
k-norm touches the given K/V. On DTensors each rank attends its own
queries over the encoder sequence gathered whole (:func:`_cross_sharded`).

Decode (:func:`decode_attention`) attends one new token against the KV
cache with einsum and softmax, as the JAX package does outside any
kernel. The new K/V are written into the cache at ``pos`` by an indexed
write, in place: the same values as the JAX one-hot blend
(``attention.py:167-171``) for finite entries, without its O(B·S) pass
per layer. A row whose ``pos`` is past the cache writes nothing, as the
blend's all-zero one-hot does.

On a mesh the cache is a DTensor laid out by ``cache_pspec`` (batch over
data, sequence over model): each rank writes the new K/V into its own
shard where ``pos`` falls in its sequence range, then attends over its
batch rows with the sequence gathered whole (:func:`_decode_sharded`)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _project_q(p: Attention, cfg, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    q = linear(p.wq, x).reshape(B, S, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(p.qnorm, q, cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _cross(q, k, v):
    """Non-causal attention of q (B,Sq,H,hd) over k/v (B,Skv,KV,hd) in
    plain torch ops, with the JAX ``_flash`` roundings (one kv chunk): q
    scaled in bf16 and bf16 scores. Not ``kernels.ref.flash_attention_ref``,
    which is the flash kernel's own numerics (f32 scores, scaled after the
    product, KV heads already repeated) that the kernel is held to."""
    H, KVh, hd = q.shape[2], k.shape[2], q.shape[3]
    if KVh != H:
        k = k.repeat_interleave(H // KVh, dim=2)
        v = v.repeat_interleave(H // KVh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).to(torch.float32)
    s = torch.exp(s - s.amax(-1, keepdim=True))
    l = s.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", s.to(q.dtype), v).to(torch.float32)
    out = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return out.to(q.dtype)


def _cross_sharded(q, k, v):
    """:func:`_cross` of DTensors on each rank's queries: q keeps its
    batch and query-sequence shards, k and v are gathered whole along the
    encoder sequence for those batch rows; their gradients are sums over
    the ranks whose queries differ."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    qpl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                else Replicate() for p in q.placements)
    kvpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in qpl)
    grad_kv = tuple(Partial() if isinstance(p, Shard) and p.dim == 1
                    else p for p in qpl)
    q = q.redistribute(mesh, qpl)
    k, v = (t.redistribute(mesh, kvpl) for t in (k, v))
    return local_map(_cross, out_placements=list(qpl),
                     in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, grad_kv, grad_kv),
                     device_mesh=mesh)(q, k, v)


def attention(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, kv_override=None) -> torch.Tensor:
    """Full-sequence attention (prefill, encoder); with ``kv_override =
    (k, v)`` cross-attention over them, never causal."""
    if kv_override is not None:                 # cross-attention
        q = _project_q(p, cfg, x, positions)
        out = (_cross_sharded(q, *kv_override) if isinstance(q, DTensor)
               else _cross(q, *kv_override))
    else:
        q, k, v = _project_qkv(p, cfg, x, positions)
        out = _flash(q, k, v, causal)
    out = layers.laid_out_as(out, x)            # back to x's rows
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


def _attend(cfg, q, k_cache, v_cache, pos, dtype) -> torch.Tensor:
    """One new query a row against the cache up to ``pos``: q (B, 1, h,
    hd), caches (B, S, KV, hd) → (B, 1, h·hd)."""
    B, S = k_cache.shape[:2]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qr = q.reshape(B, kv, h // kv, hd) * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).to(torch.float32)
    mask = torch.arange(S, device=q.device)[None] <= pos[:, None]  # (B,S)
    s = s.masked_fill(~mask[:, None, None], -1e30)
    w = torch.softmax(s, dim=-1).to(dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache).to(dtype)
    return out.reshape(B, 1, h * hd)


def decode_attention(p: Attention, cfg, x: torch.Tensor, pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); caches: (B,S,KV,hd), written in
    place; pos: (B,) current index. Returns (out, k_cache, v_cache)."""
    pos = pos.long()
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])
    if isinstance(k_cache, DTensor):
        out = _decode_sharded(cfg, q, k_new, v_new, pos, k_cache, v_cache,
                              x.dtype)
        return linear(p.wo, out), k_cache, v_cache
    _write(k_cache, pos, k_new[:, 0])
    _write(v_cache, pos, v_new[:, 0])
    out = _attend(cfg, q, k_cache, v_cache, pos, x.dtype)
    return linear(p.wo, out), k_cache, v_cache


def _decode_sharded(cfg, q, k_new, v_new, pos, k_cache, v_cache, dtype):
    """The decode attention on DTensors: q, the new K/V and ``pos`` are
    laid out as the cache's batch rows; each rank writes its rows' new
    entries into its sequence shard, in place, then attends over the
    cache gathered whole along the sequence. Returns the output rows as
    a DTensor."""
    mesh = k_cache.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in k_cache.placements)
    q, k_new, v_new, pos = (t.redistribute(mesh, rows).to_local()
                            if isinstance(t, DTensor) else
                            DTensor.from_local(t, mesh, (Replicate(),)
                                               * mesh.ndim,
                                               run_check=False)
                            .redistribute(mesh, rows).to_local()
                            for t in (q, k_new, v_new, pos))
    S = k_cache.shape[1]
    first, n = layers.shard_range(k_cache, 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        loc = cache.to_local()
        rel = pos - first
        inside = (pos < S) & (rel >= 0) & (rel < n)
        at = torch.clamp(rel, 0, n - 1)
        r = torch.arange(loc.shape[0], device=loc.device)
        loc[r, at] = torch.where(inside[:, None, None], new[:, 0],
                                 loc[r, at])
    kf = k_cache.redistribute(mesh, rows).to_local()
    vf = v_cache.redistribute(mesh, rows).to_local()
    out = _attend(cfg, q, kf, vf, pos, dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)
