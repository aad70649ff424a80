"""Decoder-only LM assembly — the port of ``repro/models/transformer.py``
for every layer kind: dense and MoE transformers (GQA, RoPE, qk-norm,
SwiGLU or GELU MLP, tied or untied unembedding, a precomputed-embedding
frontend stub), the Jamba hybrid (mamba and attention mixers, MLP and
MoE FFNs) and xLSTM stacks (mLSTM / sLSTM blocks, which have ``norm1``
and ``mixer`` only). The encoder-decoder family is :mod:`.encdec`.

The blocks are ``nn.Module``\\ s in an ``nn.ModuleList``, one per layer,
run in a Python loop — in place of the JAX package's params stacked over
layer groups and scanned. The decode cache keeps the JAX layout: a tuple
with one dict per position in the layer group, each entry stacked over
the groups (``(n_groups, B, S, KV, hd)`` for attention, the recurrent
states for the other kinds), so layer ``l`` reads group
``l // layer_group`` of entry ``l % layer_group``; the decode step
writes the KV cache in place and copies each new recurrent state back
into its slot, and returns the cache.

Compute is bf16, as in the JAX package. The JAX package keeps f32
weights (``param_dtype``) and casts each to bf16 at every use, which XLA
fuses; done eagerly that would read the f32 weights and write bf16 copies
at every step. :func:`serving_params` instead casts every weight once,
when the serving model is built, to the same values — save the three the
JAX package uses in f32 (:data:`F32_PARAMS`: the MoE router, mamba's
``A_log`` and ``dt_bias``), which every model holds in f32."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .attention import Attention
from .layers import (MLP, Embed, Linear, RMSNorm, cross_entropy, embed,
                     init_normal_, linear, mlp, rmsnorm, rowwise, whole)
from .sharding_hooks import constrain

__all__ = ["COMPUTE_DTYPE", "F32_PARAMS", "LM", "Block", "layer_kinds",
           "param_dtype_of", "init_weights",
           "serving_params", "train_params", "remat_active", "lm_forward",
           "lm_loss", "block_forward", "block_decode", "cache_spec",
           "cache_dtype", "init_cache", "lm_decode_step"]

#: every activation, the KV cache and the served weights
COMPUTE_DTYPE = torch.bfloat16
#: the parameters held and used in f32 whatever ``param_dtype`` is
#: (``repro/models/moe.py:28``, ``mamba.py:31``, ``:96``)
F32_PARAMS = ("router.w", "A_log", "dt_bias")


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


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer of ``kind`` (:func:`layer_kinds`): ``norm1`` and
    ``mixer`` (attention, mamba, mLSTM or sLSTM), and for the
    ``mixer+ffn`` kinds ``norm2`` and ``ffn`` (MLP or MoE)."""

    def __init__(self, cfg, kind: str, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.norm1 = RMSNorm(d, dtype, device)
        if kind in ("mlstm", "slstm"):
            cls = xlstm_mod.MLSTM if kind == "mlstm" else xlstm_mod.SLSTM
            self.mixer = cls(cfg, dtype, device)
            return
        mixer, ffn = kind.split("+")
        self.mixer = (Attention if mixer == "attn" else mamba_mod.Mamba)(
            cfg, dtype, device)
        self.norm2 = RMSNorm(d, dtype, device)
        self.ffn = (moe_mod.MoE(cfg, dtype, device) if ffn == "moe"
                    else MLP(d, cfg.d_ff, cfg.act, dtype, device))


class LM(nn.Module):
    """The parameters of a decoder-only LM: ``embed``, ``blocks`` (one
    :class:`Block` a layer, of its kind), ``norm_f`` and, untied,
    ``unembed``."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        if cfg.enc_layers:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             "with models.encdec.EncDec")
        _group_kinds(cfg)               # the pattern is periodic
        self.cfg = cfg
        dtype = dtype or param_dtype_of(cfg)
        self.embed = Embed(cfg.vocab_padded, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, kind, dtype, device)
                                    for kind in layer_kinds(cfg))
        self.norm_f = RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = Linear(cfg.d_model, cfg.vocab_padded, dtype,
                                  device)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` by the JAX package's init scheme,
    per parameter: norms one, embeddings N(0, 0.02²), 2-D linears N(0,
    1/d_in), 3-D weights — the MoE experts (E, d_in, d_out) and the sLSTM
    recurrence (H, hd, 4·hd) — N(0, 1/shape[1]); mamba's ``conv_w`` N(0,
    0.1²), ``dt_bias`` 0, ``D`` 1 and ``A_log`` = log(1..ds) on every
    channel (``mamba.py:27-33``). Draws are f32 on the model's device,
    rounded once to each parameter's dtype. Not the JAX package's random
    numbers; carry those over with :func:`..convert.params_from_jax`."""
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if leaf in ("scale", "D"):
                w.fill_(1.0)
            elif leaf == "dt_bias":
                w.zero_()
            elif leaf == "A_log":
                ds = w.shape[1]
                w.copy_(torch.log(torch.arange(
                    1, ds + 1, dtype=torch.float32, device=w.device)
                ).expand(w.shape[0], ds))
            elif leaf == "table":
                init_normal_(w, 0.02, generator)
            elif leaf == "conv_w":
                init_normal_(w, 0.1, generator)
            else:
                init_normal_(w, w.shape[w.dim() - 2] ** -0.5, generator)
    return model


def _served_dtype(name: str, w: torch.Tensor) -> torch.dtype:
    return w.dtype if name.endswith(F32_PARAMS) else COMPUTE_DTYPE


def serving_params(p: nn.Module) -> nn.Module:
    """The serving model: every weight in :data:`COMPUTE_DTYPE`, cast
    once — the values the JAX package's per-use ``astype`` makes — save
    :data:`F32_PARAMS`, left in f32. Returns ``p`` itself when it is
    there already, else a new model of the same class (``p`` is left as
    it is); works for :class:`LM` and ``encdec.EncDec``."""
    state = p.state_dict()
    if all(w.dtype == _served_dtype(k, w) for k, w in state.items()):
        return p
    out = type(p)(p.cfg, COMPUTE_DTYPE, device="meta")
    out.load_state_dict({k: v.to(_served_dtype(k, v))
                         for k, v in state.items()}, assign=True)
    return out


def train_params(p: nn.Module) -> nn.Module:
    """``p`` with every parameter set to need a gradient (in place): the
    trainable model. The parameters are made without one, so the serving
    path records no autograd graph; :func:`serving_params` makes its own
    copy, which never needs one."""
    for w in p.parameters():
        w.requires_grad_(True)
    return p


def remat_active(cfg, module: nn.Module) -> bool:
    """Whether a forward of ``module`` rematerialises each layer group
    (``cfg.remat == "block"``, as ``jax.checkpoint`` of the group body in
    the JAX package): only when a gradient will be taken, so serving and
    ``torch.no_grad`` forwards run as before."""
    return (cfg.remat == "block" and torch.is_grad_enabled()
            and any(w.requires_grad for w in module.parameters()))


def run_remat(fn, *args):
    """``fn(*args)`` with its activations dropped after the forward and
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant;
    no op of a forward draws random numbers)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def block_forward(p: Block, cfg, h: torch.Tensor, positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block of ``p.kind``. Returns (h, moe_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    kind = p.kind
    x = rmsnorm(p.norm1, h, cfg.norm_eps)
    if kind == "mlstm":
        return h + xlstm_mod.mlstm(p.mixer, cfg, x), aux
    if kind == "slstm":
        return h + xlstm_mod.slstm(p.mixer, cfg, x), aux
    mixer, ffn = kind.split("+")
    if mixer == "attn":
        h = h + attn_mod.attention(p.mixer, cfg, x, positions)
    else:
        h = h + mamba_mod.mamba(p.mixer, cfg, x)
    h = constrain(h, "hidden")
    x = rmsnorm(p.norm2, h, cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe_mod.moe_ffn(p.ffn, cfg, x)
        h = h + y
    else:
        h = h + mlp(p.ffn, x, cfg.act)
    return constrain(h, "hidden"), aux


def block_decode(p: Block, cfg, h: torch.Tensor, pos: torch.Tensor,
                 cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token block of ``p.kind``. ``cache`` holds the layer's slice of
    each cache entry; the KV cache is written in place, the recurrent
    states are returned new."""
    kind = p.kind
    x = rmsnorm(p.norm1, h, cfg.norm_eps)
    if kind == "mlstm":
        y, cache = xlstm_mod.mlstm_decode(p.mixer, cfg, x, cache)
        return h + y, cache
    if kind == "slstm":
        y, cache = xlstm_mod.slstm_decode(p.mixer, cfg, x, cache)
        return h + y, cache
    mixer, ffn = kind.split("+")
    if mixer == "attn":
        y, kc, vc = attn_mod.decode_attention(p.mixer, cfg, x, pos,
                                              cache["k"], cache["v"])
        cache = {"k": kc, "v": vc}
    else:
        y, cache = mamba_mod.mamba_decode(p.mixer, cfg, x, cache)
    h = h + y
    x = rmsnorm(p.norm2, h, cfg.norm_eps)
    if ffn == "moe":
        y, _ = moe_mod.moe_ffn(p.ffn, cfg, x)
        h = h + y
    else:
        h = h + mlp(p.ffn, x, cfg.act)
    return h, cache


def _logits(p: LM, cfg, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(p.norm_f, h, cfg.norm_eps)
    h = constrain(h, "pre_logits")
    if cfg.tie_embeddings:
        logits = rowwise(_times_t, h, whole(p.embed.table.to(h.dtype)))
    else:
        logits = linear(p.unembed, h)
    if cfg.vocab_padded != cfg.vocab:   # padding columns can never win
        valid = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = logits.masked_fill(~valid, -1e30)
    return constrain(logits, "logits")


def _times_t(h, table):
    return h @ table.T


def lm_forward(p: LM, cfg, tokens: torch.Tensor,
               frontend: Optional[torch.Tensor] = None,
               last_only: bool = False):
    """Prefill forward. tokens: (B, S) int; frontend: (B, F, D)
    precomputed modality embeddings, prepended (VLM stub). Returns
    (logits, aux) as the JAX function does: aux sums the MoE layers'
    Switch losses (0 without MoE)."""
    dtype = COMPUTE_DTYPE
    h = embed(p.embed, tokens, dtype)
    if frontend is not None:
        h = torch.cat([frontend.to(h.device, dtype), h], dim=1)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    h = constrain(h, "hidden")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if remat_active(cfg, p):
        # one checkpoint a layer group, its aux summed inside the group
        # and added to the carry after it (``transformer.py:216-231``)
        g = cfg.layer_group
        for i in range(0, len(p.blocks), g):
            h, a = run_remat(_group_forward, p.blocks[i:i + g], cfg, h,
                             positions)
            aux = aux + a
    else:
        for blk in p.blocks:
            h, a = block_forward(blk, cfg, h, positions)
            aux = aux + a
    if frontend is not None:
        h = h[:, frontend.shape[1]:]
    if last_only:
        h = h[:, -1:]
    return _logits(p, cfg, h), aux


def _group_forward(blocks, cfg, h, positions):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in blocks:
        h, a = block_forward(blk, cfg, h, positions)
        aux = aux + a
    return h, aux


def lm_loss(p: LM, cfg, batch: Dict) -> torch.Tensor:
    """Token-mean cross entropy over ``batch["labels"]`` (masked by
    ``loss_mask`` when given) plus 0.01 × the MoE Switch loss
    (``transformer.py:243-251``); the batch's entries are tensors on the
    model's device."""
    logits, aux = lm_forward(p, cfg, batch["tokens"],
                             frontend=batch.get("frontend"))
    return cross_entropy(logits, batch["labels"],
                         batch.get("loss_mask")) + 0.01 * aux


# -- decode -------------------------------------------------------------------

def cache_spec(cfg, batch: int, seq: int) -> Tuple[dict, ...]:
    """Shape spec (dicts of tuples) for the decode cache: per group
    position, its kind's state (KV for attention, ``ssm``/``conv`` for
    mamba, ``C``/``n`` for mLSTM, ``h``/``c``/``n``/``m`` for sLSTM),
    stacked over the groups."""
    n_groups = cfg.n_layers // cfg.layer_group
    out = []
    for kind in _group_kinds(cfg):
        if kind == "mlstm":
            spec = xlstm_mod.mlstm_state_spec(cfg, batch)
        elif kind == "slstm":
            spec = xlstm_mod.slstm_state_spec(cfg, batch)
        elif kind.startswith("mamba"):
            spec = mamba_mod.mamba_state_spec(cfg, batch)
        else:
            spec = {"k": (batch, seq, cfg.n_kv_heads, cfg.hd),
                    "v": (batch, seq, cfg.n_kv_heads, cfg.hd)}
        out.append({k: (n_groups,) + v for k, v in spec.items()})
    return tuple(out)


_F32_CACHE_KEYS = {"c", "n", "m", "ssm", "C"}


def cache_dtype(key: str, cfg) -> torch.dtype:
    """The recurrent statistics stay f32; KV, conv window and sLSTM ``h``
    are bf16, the compute dtype (``transformer.py:273-281``)."""
    return torch.float32 if key in _F32_CACHE_KEYS else COMPUTE_DTYPE


def init_cache(cfg, batch: int, seq: int, device) -> Tuple[dict, ...]:
    """Zeros, save the sLSTM stabiliser ``m`` at −1e30."""
    return tuple({k: torch.full(shape, -1e30 if k == "m" else 0.0,
                                dtype=cache_dtype(k, cfg), device=device)
                  for k, shape in entry.items()}
                 for entry in cache_spec(cfg, batch, seq))


def lm_decode_step(p: LM, cfg, token: torch.Tensor, pos: torch.Tensor,
                   cache) -> Tuple[torch.Tensor, tuple]:
    """One serving step. token: (B,) int; pos: (B,) current position;
    cache as from :func:`init_cache`, updated in place: the KV cache is
    written by the attention, each new recurrent state is copied into its
    group slot (a sharded cache's states are written in place by their
    mixers, ``layers.stepwise``). Returns (logits (B, vocab_padded),
    cache)."""
    g = cfg.layer_group
    h = embed(p.embed, token[:, None], COMPUTE_DTYPE)       # (B,1,D)
    for l, blk in enumerate(p.blocks):
        entry, at = cache[l % g], l // g
        state = {k: v[at] for k, v in entry.items()}
        h, new = block_decode(blk, cfg, h, pos, state)
        for k, v in new.items():
            if v is not state[k]:
                entry[k][at].copy_(v)
    return _logits(p, cfg, h)[:, 0], cache
