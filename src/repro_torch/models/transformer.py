"""Decoder-only LM assembly — the port of ``repro/models/transformer.py``
for the dense ``attn+mlp`` layer kind (GQA, RoPE, qk-norm, SwiGLU or GELU
MLP, tied or untied unembedding, a precomputed-embedding frontend stub).

The blocks are ``nn.Module``\\ s in an ``nn.ModuleList``, one per layer,
run in a Python loop — in place of the JAX package's params stacked over
layer groups and scanned. The decode cache keeps the JAX layout: a tuple
with one dict per position in the layer group, each entry stacked over
the groups (``(n_groups, B, S, KV, hd)``), so layer ``l`` reads group
``l // layer_group`` of entry ``l % layer_group``; the decode step writes
it in place and returns it.

Compute is bf16, as in the JAX package. The JAX package keeps f32
weights (``param_dtype``) and casts each to bf16 at every use, which XLA
fuses; done eagerly that would read the f32 weights and write bf16 copies
at every step. :func:`serving_params` instead casts every weight once,
when the serving model is built, to the same values.

Any other layer kind (``moe``, ``mamba``, ``mlstm``, ``slstm``) and the
encoder-decoder family raise ``NotImplementedError`` naming the ROADMAP
item that ports them."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from . import attention as attn_mod
from .attention import Attention
from .layers import (MLP, Embed, Linear, RMSNorm, embed, init_normal_,
                     linear, mlp, rmsnorm)
from .sharding_hooks import constrain

__all__ = ["COMPUTE_DTYPE", "LM", "Block", "layer_kinds", "param_dtype_of",
           "check_ported", "init_params", "serving_params", "lm_forward",
           "cache_spec", "cache_dtype", "init_cache", "lm_decode_step"]

#: every activation, the KV cache and the served weights
COMPUTE_DTYPE = torch.bfloat16

#: layer parts this slice does not port, and the ROADMAP item that does
_UNPORTED = {
    "moe": "ROADMAP Queue 1, item 1 (MoE)",
    "mamba": "ROADMAP Queue 1, item 2 (mamba/jamba)",
    "mlstm": "ROADMAP Queue 1, item 3 (xLSTM)",
    "slstm": "ROADMAP Queue 1, item 3 (xLSTM)",
}
_ENCDEC = "ROADMAP Queue 1, item 4 (enc-dec with cross-attention)"


def param_dtype_of(cfg) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.param_dtype]


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------

def layer_kinds(cfg) -> List[str]:
    kinds = []
    for l in range(cfg.n_layers):
        if cfg.xlstm_pattern:
            kinds.append("mlstm" if cfg.xlstm_pattern[
                l % len(cfg.xlstm_pattern)] == "m" else "slstm")
            continue
        if cfg.attn_every and (l % cfg.attn_every) != cfg.attn_every // 2:
            mixer = "mamba"
        else:
            mixer = "attn"
        if cfg.n_experts and (l % cfg.moe_every) == cfg.moe_every - 1:
            ffn = "moe"
        else:
            ffn = "mlp"
        kinds.append(f"{mixer}+{ffn}")
    return kinds


def _group_kinds(cfg) -> List[str]:
    kinds = layer_kinds(cfg)
    g = cfg.layer_group
    assert cfg.n_layers % g == 0
    per_group = [kinds[i * g:(i + 1) * g] for i in range(cfg.n_layers // g)]
    assert all(pg == per_group[0] for pg in per_group), \
        "layer pattern must be periodic with period layer_group"
    return per_group[0]


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is the
    ported ``attn+mlp`` kind and it has no encoder."""
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; "
            f"{_ENCDEC}")
    for kind in _group_kinds(cfg):
        for part in kind.split("+"):
            if part in _UNPORTED:
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind!r} is not ported yet; "
                    f"{_UNPORTED[part]}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One ``attn+mlp`` layer: ``norm1``, ``mixer``, ``norm2``, ``ffn``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = RMSNorm(d, dtype, device)
        self.mixer = Attention(cfg, dtype, device)
        self.norm2 = RMSNorm(d, dtype, device)
        self.ffn = MLP(d, cfg.d_ff, cfg.act, dtype, device)


class LM(nn.Module):
    """The parameters of a dense decoder: ``embed``, ``blocks``,
    ``norm_f`` and, untied, ``unembed``."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = dtype or param_dtype_of(cfg)
        self.embed = Embed(cfg.vocab_padded, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = Linear(cfg.d_model, cfg.vocab_padded, dtype,
                                  device)


def init_params(generator: torch.Generator, cfg, device) -> LM:
    """The port's own seeded init, by the JAX scheme: norms at one,
    embeddings N(0, 0.02²), linears N(0, 1/d_in) — drawn in f32 on
    ``device`` and rounded once to the config's ``param_dtype``. Not the
    JAX package's random numbers; carry those over with
    :func:`..convert.params_from_jax`."""
    model = LM(cfg, device=device)
    for name, w in model.named_parameters():
        if name.endswith("scale"):
            with torch.no_grad():
                w.fill_(1.0)
        elif name.endswith("table"):
            init_normal_(w, 0.02, generator)
        else:
            init_normal_(w, w.shape[0] ** -0.5, generator)
    return model


def serving_params(p: LM) -> LM:
    """The serving model: every weight in :data:`COMPUTE_DTYPE`, cast
    once — the values the JAX package's per-use ``astype`` makes. Returns
    ``p`` itself when it is there already, else a new model (``p`` is left
    as it is)."""
    if all(w.dtype == COMPUTE_DTYPE for w in p.parameters()):
        return p
    out = LM(p.cfg, COMPUTE_DTYPE, device="meta")
    out.load_state_dict({k: v.to(COMPUTE_DTYPE)
                         for k, v in p.state_dict().items()}, assign=True)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def block_forward(p: Block, cfg, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence ``attn+mlp`` block."""
    x = rmsnorm(p.norm1, h, cfg.norm_eps)
    h = h + attn_mod.attention(p.mixer, cfg, x, positions)
    h = constrain(h, "hidden")
    x = rmsnorm(p.norm2, h, cfg.norm_eps)
    h = h + mlp(p.ffn, x, cfg.act)
    return constrain(h, "hidden")


def block_decode(p: Block, cfg, h: torch.Tensor, pos: torch.Tensor,
                 cache: dict) -> Tuple[torch.Tensor, dict]:
    x = rmsnorm(p.norm1, h, cfg.norm_eps)
    y, kc, vc = attn_mod.decode_attention(p.mixer, cfg, x, pos, cache["k"],
                                          cache["v"])
    h = h + y
    x = rmsnorm(p.norm2, h, cfg.norm_eps)
    h = h + mlp(p.ffn, x, cfg.act)
    return h, {"k": kc, "v": vc}


def _logits(p: LM, cfg, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(p.norm_f, h, cfg.norm_eps)
    h = constrain(h, "pre_logits")
    if cfg.tie_embeddings:
        logits = h @ p.embed.table.to(h.dtype).T
    else:
        logits = linear(p.unembed, h)
    if cfg.vocab_padded != cfg.vocab:   # padding columns can never win
        valid = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = logits.masked_fill(~valid, -1e30)
    return constrain(logits, "logits")


def lm_forward(p: LM, cfg, tokens: torch.Tensor,
               frontend: Optional[torch.Tensor] = None,
               last_only: bool = False):
    """Prefill forward. tokens: (B, S) int; frontend: (B, F, D)
    precomputed modality embeddings, prepended (VLM stub). Returns
    (logits, aux) as the JAX function does; aux is 0 without MoE."""
    check_ported(cfg)
    dtype = COMPUTE_DTYPE
    h = embed(p.embed, tokens, dtype)
    if frontend is not None:
        h = torch.cat([frontend.to(h.device, dtype), h], dim=1)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    h = constrain(h, "hidden")
    for blk in p.blocks:
        h = block_forward(blk, cfg, h, positions)
    if frontend is not None:
        h = h[:, frontend.shape[1]:]
    if last_only:
        h = h[:, -1:]
    return _logits(p, cfg, h), torch.zeros((), dtype=torch.float32,
                                           device=h.device)


# -- decode -------------------------------------------------------------------

def cache_spec(cfg, batch: int, seq: int) -> Tuple[dict, ...]:
    """Shape spec (dicts of tuples) for the decode cache."""
    check_ported(cfg)
    n_groups = cfg.n_layers // cfg.layer_group
    spec = {"k": (batch, seq, cfg.n_kv_heads, cfg.hd),
            "v": (batch, seq, cfg.n_kv_heads, cfg.hd)}
    return tuple({k: (n_groups,) + v for k, v in spec.items()}
                 for _ in _group_kinds(cfg))


def cache_dtype(key: str, cfg) -> torch.dtype:
    """KV caches are bf16, the compute dtype (the recurrent statistics of
    the unported kinds stay f32 in the JAX package)."""
    return COMPUTE_DTYPE


def init_cache(cfg, batch: int, seq: int, device) -> Tuple[dict, ...]:
    return tuple({k: torch.zeros(shape, dtype=cache_dtype(k, cfg),
                                 device=device)
                  for k, shape in entry.items()}
                 for entry in cache_spec(cfg, batch, seq))


def lm_decode_step(p: LM, cfg, token: torch.Tensor, pos: torch.Tensor,
                   cache) -> Tuple[torch.Tensor, tuple]:
    """One serving step. token: (B,) int; pos: (B,) current position;
    cache as from :func:`init_cache`, written in place. Returns (logits
    (B, vocab_padded), cache)."""
    g = cfg.layer_group
    h = embed(p.embed, token[:, None], COMPUTE_DTYPE)       # (B,1,D)
    for l, blk in enumerate(p.blocks):
        entry = cache[l % g]
        h, _ = block_decode(blk, cfg, h, pos, {"k": entry["k"][l // g],
                                               "v": entry["v"][l // g]})
    return _logits(p, cfg, h)[:, 0], cache
