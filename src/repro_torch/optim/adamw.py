"""AdamW — the port of ``repro/optim/adamw.py``.

Parameters are the model module (or any mapping of names to tensors);
gradients, ``m`` and ``v`` are dicts keyed by the same parameter names.
The math is the JAX function's, in its order: the global norm is the
square root of the per-leaf f32 sums of squares added in leaf order; the
clip scale ``min(1, max_norm / max(norm, 1e-9))`` is folded into each
leaf's one m/v/p chain; the bias correction comes from the step counter;
the weight decay is added to the update before the learning rate. m/v
are held in ``state_dtype`` (bf16 for the MoE archs, whose parameters
are bf16) and the update runs in f32.

Unlike the JAX function, :func:`adamw_update` writes the new parameters,
``m`` and ``v`` into their tensors in place (under ``torch.no_grad``)
and returns them with the new step: at granite-3-2b's size a second
copy of parameters and moments would be another 30 GB.
``tests/test_torch_train.py`` holds the values to the JAX update's.

DTensor parameters (the sharded steps) are updated where they lie: the
moments mirror their placements, each leaf's m/v/p chain runs on the
local shards, and nothing is gathered. The global norm's per-leaf sums
are taken on the local shards, each weighted by one over the number of
ranks that hold the same shard (the mesh dims it is replicated over),
added in leaf order, and made whole with one ``Partial`` reduction."""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "named_tensors"]


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def named_tensors(params) -> Dict[str, torch.Tensor]:
    """Name → tensor of a module's parameters (or a mapping as it is)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    named = named_tensors(params)
    dev = next(iter(named.values())).device

    def zeros():
        return {k: (torch.zeros_like(p, dtype=state_dtype)
                    if isinstance(p, DTensor) else
                    torch.zeros(p.shape, dtype=state_dtype, device=p.device))
                for k, p in named.items()}

    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def _grad(grads: Mapping, name: str, p: torch.Tensor) -> torch.Tensor:
    g = grads.get(name)
    return torch.zeros_like(p) if g is None else g


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _global_norm(grads, names) -> torch.Tensor:
    total, mesh = None, None
    for k in names:
        g = grads.get(k)
        if g is None:
            continue
        s = torch.sum(torch.square(_local(g).to(torch.float32)))
        if isinstance(g, DTensor):
            mesh = g.device_mesh
            copies = math.prod(mesh.size(i) for i, p in
                               enumerate(g.placements)
                               if isinstance(p, Replicate))
            if copies > 1:
                s = s * (1.0 / copies)
        total = s if total is None else total + s
    if mesh is not None:
        total = DTensor.from_local(total, mesh, (Partial(),) * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Mapping, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Grads scaled by ``min(1, max_norm / max(norm, 1e-9))``, each in
    its own dtype, and the norm."""
    gn = _global_norm(grads, list(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return ({k: (g.to(torch.float32) * scale).to(g.dtype)
             for k, g in grads.items()}, gn)


@torch.no_grad()
def adamw_update(params, grads: Mapping, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step with the global-norm clip fused in. ``grads`` maps
    parameter names to gradients (a missing or None gradient is zero).
    Returns ``(params, new state, {"grad_norm": norm})``, the parameters
    and moments updated in place (see the module note)."""
    named = named_tensors(params)
    gnorm = _global_norm(grads, list(named))
    scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=sf.device), sf)
    for k, p in named.items():
        g = _grad(grads, k, p)
        if isinstance(p, DTensor):
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            p, g = p.to_local(), g.to_local()
        m, v = _local(state.m[k]), _local(state.v[k])
        g32 = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(g32)
        u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        u = u + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * u)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
