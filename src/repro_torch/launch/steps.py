"""Step builders shared by the launchers — the port of
``repro/launch/steps.py``: given a (cfg, shape) and a device, the step
function and the stand-ins of its inputs. The JAX builders also return
the mesh shardings; on one card there are none (the mesh waits for ROADMAP
Queue 1, item 6)."""
from __future__ import annotations

from typing import Dict

import torch

from ..core.device import resolve_device
from ..data.pipeline import make_batch_specs
from ..models import get_model
from ..models import transformer as tfm
from ..optim import adamw_update, cosine_warmup

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "input_specs", "state_dtype_of"]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> Dict:
    """``meta`` stand-ins (shape and dtype, no memory) for every input of
    the step that ``shape.mode`` selects."""
    api = get_model(cfg)
    if shape.mode in ("train", "prefill"):
        return {"batch": make_batch_specs(cfg, shape)}
    B, S = shape.global_batch, shape.seq_len
    spec = api.cache_spec(B, S)
    if isinstance(spec, tuple):
        cache = tuple({k: _meta(v, tfm.cache_dtype(k, cfg))
                       for k, v in entry.items()} for entry in spec)
    else:   # enc-dec: KV caches in the compute dtype
        cache = {k: _meta(v, tfm.COMPUTE_DTYPE) for k, v in spec.items()}
    return {"token": _meta((B,), torch.int32),
            "pos": _meta((B,), torch.int32), "cache": cache}


def state_dtype_of(cfg) -> torch.dtype:
    """AdamW's m/v dtype: bf16 for bf16 parameters (the MoE archs), else
    f32 (``launch/steps.py:75-76``)."""
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def build_train_step(cfg, shape, device="cuda", peak_lr: float = 3e-4):
    """``train_step(params, opt_state, batch, step) -> (params,
    opt_state, loss, {"grad_norm": …})``: the loss and its gradient on
    trainable ``params`` (``ModelAPI.train_params``), the warm-up cosine
    learning rate (warm-up 2000, total 500 000) and one AdamW update,
    which writes the parameters and moments in place. ``batch`` holds
    numpy arrays or tensors; ``loss`` and the norm are device scalars."""
    api = get_model(cfg)
    dev = resolve_device(device)

    def train_step(params, opt_state, batch, step):
        for w in params.parameters():
            w.grad = None
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss = api.loss(params, b)
        loss.backward()
        grads = {k: w.grad for k, w in params.named_parameters()}
        lr = cosine_warmup(step, peak_lr, warmup=2000, total=500_000,
                           device=dev)
        params, opt_state, mx = adamw_update(params, grads, opt_state, lr)
        for w in params.parameters():
            w.grad = None
        return params, opt_state, loss.detach(), mx

    return train_step


def build_prefill_step(cfg, shape, device="cuda"):
    """``prefill_step(params, batch) -> last-position logits``."""
    api = get_model(cfg)
    resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, batch)

    return prefill_step


def build_decode_step(cfg, shape, device="cuda"):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``."""
    api = get_model(cfg)
    resolve_device(device)

    @torch.no_grad()
    def decode_step(params, token, pos, cache):
        return api.decode_step(params, token, pos, cache)

    return decode_step
