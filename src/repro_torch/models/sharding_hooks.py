"""Sharding-constraint hooks — the API of ``repro/models/sharding_hooks.py``.
The models stay mesh-agnostic; a launcher may install a policy that maps
logical tensor names ("hidden", "logits", "kv_cache", …) to a placement.

Without a mesh no policy is installed and :func:`constrain` returns its
input. A policy is any callable ``policy(name, x)`` returning the tensor
to use in place of ``x`` (or ``None`` to leave it). The sharded steps
install ``runtime.sharding.act_policy(mesh)``, which redistributes a
DTensor to its name's placement; a plain tensor passes untouched."""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

__all__ = ["constrain", "policy_info", "sharding_policy"]

_STATE = threading.local()


def constrain(x, name: str):
    """Apply the active policy to logical tensor ``name``. No-op without
    a policy."""
    pol: Optional[Callable] = getattr(_STATE, "policy", None)
    if pol is None:
        return x
    out = pol(name, x)
    return x if out is None else out


def policy_info(key: str, default=None):
    """Mesh facts exposed by the active policy (its ``info`` dict, e.g.
    the data-shard count). Returns ``default`` with no policy."""
    pol = getattr(_STATE, "policy", None)
    info = getattr(pol, "info", None) if pol is not None else None
    if info is None:
        return default
    return info.get(key, default)


@contextlib.contextmanager
def sharding_policy(policy: Callable):
    prev = getattr(_STATE, "policy", None)
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev
