"""Step builders shared by the launchers and the dry run — the port of
``repro/launch/steps.py``: given a (cfg, shape), the step function and
the stand-ins of its inputs.

Without a mesh a builder returns the one-device step alone (on
``device``). With a ``mesh`` (a ``DeviceMesh`` with named dims, from
``launch/mesh.py``) the step is the sharded one, run by every rank of
the mesh: the parameters are DTensors laid out by ``param_specs``
(:func:`shard_params`), AdamW's moments mirror them (``adamw_init`` of
DTensor parameters), the batch follows ``batch_specs`` and the decode
cache ``cache_pspec`` (:func:`shard_batch`, :func:`shard_cache`), and
the step runs under ``sharding_policy(act_policy(mesh))``.
:func:`step_shardings` returns the spec trees, as the JAX builders
return their in/out shardings. Plain tensors met inside the step
(positions, masks) count as replicated (``implicit_replication``).

The sharded path covers every config: the attention and MoE decoders,
jamba's mamba blocks, the xLSTM blocks and the encoder-decoder (whose
batch carries the encoder's frames, and whose decode cache, from
``encdec_init_cache``, :func:`shard_cache` lays out as a dict)."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..config import get_config, reduced_config
from ..core.device import resolve_device
from ..data.pipeline import make_batch_specs
from ..models import get_model
from ..models import transformer as tfm
from ..optim import adamw_update, cosine_warmup
from ..runtime.sharding import (act_policy, batch_specs, cache_pspec,
                                param_specs, placements)

__all__ = ["launch_config", "build_train_step", "build_prefill_step", "build_decode_step",
           "input_specs", "state_dtype_of", "step_shardings",
           "shard_params", "shard_batch", "shard_cache", "sharded_context"]


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


def launch_config(arch: str, scale: str, device):
    """The config ``--arch``/``--scale`` name on ``device``, for both
    launchers: ``reduced`` is ``reduced_config`` (heads of 16) on the CPU
    and, on the card, the same cut at d_model 512 in 8 heads of 64 (the
    flash kernels take hd 64 and 128 only)."""
    cfg = get_config(arch)
    if scale == "full":
        return cfg
    if torch.device(device).type == "cpu":
        return reduced_config(cfg)
    return reduced_config(cfg, d_model=512, n_heads=8, head_dim=64)


def state_dtype_of(cfg) -> torch.dtype:
    """AdamW's m/v dtype: bf16 for bf16 parameters (the MoE archs), else
    f32 (``launch/steps.py:75-76``)."""
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


# -- the mesh -------------------------------------------------------------------

def step_shardings(cfg, shape, mesh) -> Dict:
    """The spec trees of the step's inputs (the JAX builders' in/out
    shardings, as specs): ``params`` (and the AdamW moments, which mirror
    them), and ``batch`` for train/prefill, or ``token``/``pos`` and
    ``cache`` (the entries of ``input_specs``) for decode. Loss, grad
    norm and logits come back replicated."""
    api = get_model(cfg)
    out = {"params": param_specs(api.param_shapes(), cfg, mesh)}
    ins = input_specs(cfg, shape)
    if shape.mode in ("train", "prefill"):
        out["batch"] = batch_specs(ins["batch"], mesh)
    else:
        tok = batch_specs({"t": ins["token"]}, mesh)["t"]
        out["token"] = out["pos"] = tok
        cache = ins["cache"]
        if isinstance(cache, tuple):
            out["cache"] = tuple({k: cache_pspec(tuple(v.shape), mesh)
                                  for k, v in e.items()} for e in cache)
        else:
            out["cache"] = {k: cache_pspec(tuple(v.shape), mesh)
                            for k, v in cache.items()}
    return out


def _distribute(t: torch.Tensor, mesh, spec):
    """``t``, the same whole tensor on every rank, as the DTensor of
    ``spec``: each rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def shard_params(params, cfg, mesh):
    """Replace every parameter of the module ``params`` (the same values
    on every rank) by its DTensor per ``param_specs``, in place, keeping
    ``requires_grad``; returns ``params``. Each whole parameter is freed
    as its DTensor replaces it, so the module never takes more than its
    own size and one parameter's shard."""
    specs = param_specs(params, cfg, mesh)
    for name in specs:
        mod_name, leaf = name.rpartition(".")[::2]
        mod = params.get_submodule(mod_name)
        w = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(
            _distribute(w.detach(), mesh, specs[name]),
            requires_grad=w.requires_grad))
        del w
    return params


def shard_batch(batch: Dict, mesh, device) -> Dict:
    """A batch (numpy or tensors, whole on every rank) as DTensors per
    ``batch_specs``."""
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    specs = batch_specs(b, mesh)
    return {k: _distribute(v, mesh, specs[k]) for k, v in b.items()}


def shard_cache(cache, mesh):
    """A decode cache — the tuple of dicts of ``init_cache``, or the
    enc-dec's dict of ``encdec_init_cache`` — as DTensors per
    ``cache_pspec``: a whole tensor keeps its shard, a DTensor (the cross
    K/V of sharded parameters) is redistributed."""
    from torch.distributed.tensor import DTensor

    def lay(t):
        spec = cache_pspec(tuple(t.shape), mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements(spec, mesh))
        return _distribute(t, mesh, spec)

    if isinstance(cache, dict):
        return {k: lay(v) for k, v in cache.items()}
    return tuple({k: lay(v) for k, v in entry.items()} for entry in cache)


@contextlib.contextmanager
def sharded_context(mesh):
    """The activation policy of ``mesh`` and implicit replication of the
    plain tensors a step makes."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.sharding_hooks import sharding_policy
    with sharding_policy(act_policy(mesh)), implicit_replication():
        yield


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# -- builders -------------------------------------------------------------------

def build_train_step(cfg, shape, device="cuda", peak_lr: float = 3e-4,
                     mesh=None):
    """``train_step(params, opt_state, batch, step) -> (params,
    opt_state, loss, {"grad_norm": …})``: the loss and its gradient on
    trainable ``params`` (``ModelAPI.train_params``), the warm-up cosine
    learning rate (warm-up 2000, total 500 000) and one AdamW update,
    which writes the parameters and moments in place. ``batch`` holds
    numpy arrays or tensors; ``loss`` and the norm are device scalars.
    With ``mesh``: ``params`` sharded by :func:`shard_params`, the moments
    by ``adamw_init`` of them, the batch sharded here; loss and norm come
    back whole on every rank."""
    api = get_model(cfg)
    if mesh is not None:
        device = mesh.device_type
    dev = resolve_device(device)

    def train_step(params, opt_state, batch, step):
        for w in params.parameters():
            w.grad = None
        if mesh is None:
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            ctx = contextlib.nullcontext()
        else:
            b = shard_batch(batch, mesh, dev)
            ctx = sharded_context(mesh)
        with ctx:
            loss = api.loss(params, b)
            loss.backward()
        grads = {k: w.grad for k, w in params.named_parameters()}
        lr = cosine_warmup(step, peak_lr, warmup=2000, total=500_000,
                           device=dev)
        params, opt_state, mx = adamw_update(params, grads, opt_state, lr)
        for w in params.parameters():
            w.grad = None
        return params, opt_state, _full(loss.detach()), mx

    return train_step


def build_prefill_step(cfg, shape, device="cuda", mesh=None):
    """``prefill_step(params, batch) -> last-position logits`` (whole on
    every rank with ``mesh``)."""
    api = get_model(cfg)
    if mesh is not None:
        device = mesh.device_type
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is None:
            return api.prefill(params, batch)
        with sharded_context(mesh):
            return _full(api.prefill(params, shard_batch(batch, mesh, dev)))

    return prefill_step


def build_decode_step(cfg, shape, device="cuda", mesh=None):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``; with
    ``mesh`` the cache is the DTensor cache of :func:`shard_cache`,
    written in place, and the logits come back whole on every rank."""
    api = get_model(cfg)
    if mesh is not None:
        device = mesh.device_type
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, token, pos, cache):
        if mesh is None:
            return api.decode_step(params, token, pos, cache)
        b = shard_batch({"token": token, "pos": pos}, mesh, dev)
        with sharded_context(mesh):
            logits, cache = api.decode_step(params, b["token"], b["pos"],
                                            cache)
        return _full(logits), cache

    return decode_step
