"""Carry the JAX package's parameters over to the port.

:func:`params_from_jax` takes the tree ``repro.models.ModelAPI.init``
returns, with its leaves as numpy arrays (``jax.tree_util.tree_map(
np.asarray, params)``), and returns the port's :class:`~.transformer.LM`
holding the same values. The JAX tree stacks each group position's
params over the layer groups on axis 0 (``blocks[gp][...][group]``);
layer ``l`` of the port takes group ``l // layer_group`` of position
``l % layer_group``. ``linear``'s weight keeps the JAX layout
``(d_in, d_out)`` — the port computes ``x @ w`` as the JAX package does
— so no array is transposed. bf16 leaves (``ml_dtypes.bfloat16``) pass
through f32, which holds them exactly."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device
from .transformer import LM

__all__ = ["params_from_jax"]


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


def params_from_jax(tree: Dict, cfg, device="cuda") -> LM:
    """The port's parameters from a JAX parameter tree of numpy arrays,
    on ``device``, in the config's ``param_dtype``. Every leaf of the tree
    is used exactly once, or it raises."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta")
    leaves = dict(_leaves(tree))
    g = cfg.layer_group
    used, state = set(), {}
    for name, w in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            l = int(parts[1])
            path = ("blocks", l % g) + tuple(parts[2:])
            arr = np.asarray(leaves[path])[l // g]
        else:
            path = tuple(parts)
            arr = leaves[path]
        if tuple(np.shape(arr)) != tuple(w.shape):
            raise ValueError(f"{name}: JAX leaf {path} has shape "
                             f"{np.shape(arr)}, the port wants "
                             f"{tuple(w.shape)}")
        used.add(path)
        state[name] = _tensor(arr, w.dtype, dev)
    extra = set(leaves) - used
    if extra:
        raise ValueError(f"JAX leaves with no place in the port: "
                         f"{sorted(map(str, extra))}")
    model.load_state_dict(state, assign=True)
    return model
