"""Encoder–decoder stack (seamless-m4t style) — the port of
``repro/models/encdec.py``: an encoder over precomputed frame embeddings
(the speech frontend is a stub in both packages) and a causal text
decoder with cross-attention.

The encoder's self-attention runs the flash kernel non-causal, the
decoder's the flash kernel causal (Sq = Skv); cross-attention has
Sq ≠ Skv and runs as plain torch ops (``attention._cross`` in prefill,
einsums in decode), as the JAX package computes it outside any kernel.
``enc`` and ``dec`` are lists of blocks, one a layer (the JAX tree stacks
them over layers, not groups). The decode cache keeps the JAX layout:
``self_k``/``self_v`` (L, B, seq, KV, hd) written in place, and the
cross K/V of the encoder output, (L, B, S_enc, KV, hd).

As in the JAX package, neither the forward nor the decode step masks the
padded vocabulary columns (``encdec.py:112``, ``:184``): seamless pads
256206 → 256256, and a padding column can win a greedy argmax."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from . import attention as attn_mod
from .attention import Attention
from .layers import MLP, Embed, Linear, RMSNorm, embed, linear, mlp, rmsnorm
from .sharding_hooks import constrain
from .transformer import COMPUTE_DTYPE, param_dtype_of

__all__ = ["EncDec", "encode", "encdec_forward", "encdec_cache_spec",
           "encdec_init_cache", "encdec_decode_step"]


class EncBlock(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = RMSNorm(d, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.norm2 = RMSNorm(d, dtype, device)
        self.ffn = MLP(d, cfg.d_ff, cfg.act, dtype, device)


class DecBlock(nn.Module):
    """``norm1``, ``self`` (causal self-attention), ``normx``, ``cross``
    (its ``wk``/``wv`` project the encoder output), ``norm2``, ``ffn``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = RMSNorm(d, dtype, device)
        self.self = Attention(cfg, dtype, device)
        self.normx = RMSNorm(d, dtype, device)
        self.cross = Attention(cfg, dtype, device)
        self.norm2 = RMSNorm(d, dtype, device)
        self.ffn = MLP(d, cfg.d_ff, cfg.act, dtype, device)


class EncDec(nn.Module):
    """``embed``, ``enc`` (``enc_layers`` blocks), ``dec`` (``n_layers``
    blocks), ``norm_enc``, ``norm_f``, ``unembed``."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype or param_dtype_of(cfg)
        d = cfg.d_model
        self.embed = Embed(cfg.vocab_padded, d, dtype, device)
        self.enc = nn.ModuleList(EncBlock(cfg, dtype, device)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, dtype, device)
                                 for _ in range(cfg.n_layers))
        self.norm_enc = RMSNorm(d, dtype, device)
        self.norm_f = RMSNorm(d, dtype, device)
        self.unembed = Linear(d, cfg.vocab_padded, dtype, device)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(p: EncDec, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frontend embeddings
    (``encdec.py:58-75``); non-causal self-attention."""
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)
    h = constrain(frames, "hidden")
    for bp in p.enc:
        x = rmsnorm(bp.norm1, h, cfg.norm_eps)
        h = h + attn_mod.attention(bp.attn, cfg, x, positions, causal=False)
        x = rmsnorm(bp.norm2, h, cfg.norm_eps)
        h = constrain(h + mlp(bp.ffn, x, cfg.act), "hidden")
    return rmsnorm(p.norm_enc, h, cfg.norm_eps)


def _cross_kv(bp: DecBlock, cfg, memory: torch.Tensor):
    """The cross K/V of one decoder layer: projections only — no RoPE, no
    k-norm (``encdec.py:78-83``)."""
    B, S, _ = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = linear(bp.cross.wk, memory).reshape(B, S, kv, hd)
    v = linear(bp.cross.wv, memory).reshape(B, S, kv, hd)
    return k, v


def encdec_forward(p: EncDec, cfg, tokens: torch.Tensor,
                   frames: torch.Tensor, last_only: bool = False
                   ) -> torch.Tensor:
    """Prefill forward (``encdec.py:86-112``): tokens (B, S), frames
    (B, S_enc, D). Returns the logits (B, S or 1, vocab_padded), the
    padded columns unmasked."""
    memory = encode(p, cfg, frames.to(COMPUTE_DTYPE))
    h = embed(p.embed, tokens, COMPUTE_DTYPE)
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    for bp in p.dec:
        x = rmsnorm(bp.norm1, h, cfg.norm_eps)
        h = h + attn_mod.attention(bp.self, cfg, x, positions)
        x = rmsnorm(bp.normx, h, cfg.norm_eps)
        h = h + attn_mod.attention(bp.cross, cfg, x, positions,
                                   kv_override=_cross_kv(bp, cfg, memory))
        x = rmsnorm(bp.norm2, h, cfg.norm_eps)
        h = constrain(h + mlp(bp.ffn, x, cfg.act), "hidden")
    if last_only:
        h = h[:, -1:]
    h = constrain(rmsnorm(p.norm_f, h, cfg.norm_eps), "pre_logits")
    return constrain(linear(p.unembed, h), "logits")


# -- decode -------------------------------------------------------------------

def encdec_cache_spec(cfg, batch: int, seq: int, enc_seq: int
                      ) -> Dict[str, tuple]:
    L = cfg.n_layers
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {"self_k": (L, batch, seq, kv, hd),
            "self_v": (L, batch, seq, kv, hd),
            "cross_k": (L, batch, enc_seq, kv, hd),
            "cross_v": (L, batch, enc_seq, kv, hd)}


def encdec_init_cache(p: EncDec, cfg, frames: torch.Tensor, seq: int
                      ) -> Dict[str, torch.Tensor]:
    """Run the encoder and precompute every decoder layer's cross K/V
    (the serving prefill, ``encdec.py:133-148``); the self-attention
    cache is zeros of ``seq`` positions."""
    dev = p.embed.table.device
    memory = encode(p, cfg, torch.as_tensor(frames, device=dev).to(
        COMPUTE_DTYPE))
    B = memory.shape[0]
    ck, cv = zip(*(_cross_kv(bp, cfg, memory) for bp in p.dec))
    shape = (cfg.n_layers, B, seq, cfg.n_kv_heads, cfg.hd)
    return {"self_k": torch.zeros(shape, dtype=memory.dtype, device=dev),
            "self_v": torch.zeros(shape, dtype=memory.dtype, device=dev),
            "cross_k": torch.stack(ck), "cross_v": torch.stack(cv)}


def encdec_decode_step(p: EncDec, cfg, token: torch.Tensor,
                       pos: torch.Tensor, cache: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    """One decoder token (``encdec.py:151-185``): token (B,), pos (B,);
    the self cache is written in place. Returns (logits (B,
    vocab_padded), cache)."""
    h = embed(p.embed, token[:, None], COMPUTE_DTYPE)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    B = h.shape[0]
    for l, bp in enumerate(p.dec):
        x = rmsnorm(bp.norm1, h, cfg.norm_eps)
        y, _, _ = attn_mod.decode_attention(bp.self, cfg, x, pos,
                                            cache["self_k"][l],
                                            cache["self_v"][l])
        h = h + y
        x = rmsnorm(bp.normx, h, cfg.norm_eps)
        # cross attention: one query against the fixed encoder memory
        q = linear(bp.cross.wq, x).reshape(B, 1, H, hd)
        if cfg.qk_norm:
            q = rmsnorm(bp.cross.qnorm, q, cfg.norm_eps)
        qr = q.reshape(B, KV, G, hd) * hd ** -0.5
        s = torch.einsum("bkgd,bskd->bkgs", qr,
                         cache["cross_k"][l]).to(torch.float32)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        y = torch.einsum("bkgs,bskd->bkgd", w, cache["cross_v"][l]).reshape(
            B, 1, H * hd)
        h = h + linear(bp.cross.wo, y)
        x = rmsnorm(bp.norm2, h, cfg.norm_eps)
        h = h + mlp(bp.ffn, x, cfg.act)
    h = rmsnorm(p.norm_f, h, cfg.norm_eps)
    return linear(p.unembed, h)[:, 0], cache
