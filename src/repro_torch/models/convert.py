"""Carry the JAX package's parameters over to the port.

:func:`params_from_jax` takes the tree ``repro.models.ModelAPI.init``
returns, with its leaves as numpy arrays (``jax.tree_util.tree_map(
np.asarray, params)``), and returns the port's :class:`~.transformer.LM`
(or, for an encoder-decoder config, :class:`~.encdec.EncDec`) holding
the same values. The JAX decoder-only tree stacks each group position's
params over the layer groups on axis 0 (``blocks[gp][...][group]``);
layer ``l`` of the port takes group ``l // layer_group`` of position
``l % layer_group`` (jamba: eight positions, one group a period). The
enc-dec tree stacks ``enc`` and ``dec`` over layers: block ``l`` takes
index ``l``. ``linear``'s weight keeps the JAX layout
``(d_in, d_out)`` — the port computes ``x @ w`` as the JAX package does
— so no array is transposed. bf16 leaves (``ml_dtypes.bfloat16``) pass
through f32, which holds them exactly.

:func:`adamw_state_from_jax` carries a JAX ``optim.AdamWState`` (its
leaves numpy) over the same way: ``m`` and ``v`` mirror the parameter
tree, each leaf kept in its own dtype (f32, or bf16 for a bf16
``state_dtype``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device
from .encdec import EncDec
from .transformer import LM

__all__ = ["params_from_jax", "adamw_state_from_jax", "named_from_jax"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    a = a.astype(np.float32) if a.dtype.name == "bfloat16" else a.copy()
    return torch.from_numpy(a).to(device, dtype)


def _by_name(tree: Dict, cfg, model):
    """Each parameter name of ``model`` → its numpy array in the JAX
    tree; every leaf of the tree used exactly once, or it raises."""
    leaves = dict(_leaves(tree))
    g = cfg.layer_group
    used, state = set(), {}
    for name, w in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            l = int(parts[1])
            path = ("blocks", l % g) + tuple(parts[2:])
            arr = np.asarray(leaves[path])[l // g]
        elif parts[0] in ("enc", "dec"):
            path = (parts[0],) + tuple(parts[2:])
            arr = np.asarray(leaves[path])[int(parts[1])]
        else:
            path = tuple(parts)
            arr = leaves[path]
        if tuple(np.shape(arr)) != tuple(w.shape):
            raise ValueError(f"{name}: JAX leaf {path} has shape "
                             f"{np.shape(arr)}, the port wants "
                             f"{tuple(w.shape)}")
        used.add(path)
        state[name] = arr
    extra = set(leaves) - used
    if extra:
        raise ValueError(f"JAX leaves with no place in the port: "
                         f"{sorted(map(str, extra))}")
    return state


def named_from_jax(tree: Dict, cfg) -> Dict[str, np.ndarray]:
    """The leaves of a JAX parameter-shaped tree (parameters, gradients,
    moments) as numpy arrays keyed by the port's parameter names."""
    model = (EncDec if cfg.enc_layers else LM)(cfg, device="meta")
    return {k: np.asarray(a) for k, a in _by_name(tree, cfg, model).items()}


def params_from_jax(tree: Dict, cfg, device="cuda"):
    """The port's parameters from a JAX parameter tree of numpy arrays,
    on ``device``, in the config's ``param_dtype``. Every leaf of the tree
    is used exactly once, or it raises."""
    dev = resolve_device(device)
    model = (EncDec if cfg.enc_layers else LM)(cfg, device="meta")
    dtypes = {k: w.dtype for k, w in model.named_parameters()}
    model.load_state_dict({k: _tensor(a, dtypes[k], dev) for k, a in
                           _by_name(tree, cfg, model).items()}, assign=True)
    return model


def adamw_state_from_jax(state, cfg, device="cuda"):
    """The port's ``optim.AdamWState`` from a JAX one whose leaves are
    numpy (``jax.tree_util.tree_map(np.asarray, state)``): ``m`` and ``v``
    keyed by the port's parameter names, each in its JAX dtype, the step
    an int32 scalar, on ``device``."""
    from ..optim import AdamWState
    dev = resolve_device(device)
    model = (EncDec if cfg.enc_layers else LM)(cfg, device="meta")

    def moments(tree):
        return {k: _tensor(a, torch.bfloat16 if np.asarray(a).dtype.name
                           == "bfloat16" else torch.float32, dev)
                for k, a in _by_name(tree, cfg, model).items()}

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step, moments(state.m), moments(state.v))
