"""Mesh construction — the port of ``repro/launch/mesh.py``: functions,
never module constants, so importing this module touches no process
group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over the
process group that is already running (``comm.p2p.spawn`` starts one; the
dry run starts a fake one). Its size must be the world size. Axis
semantics, as in the JAX package: ``pod`` = cross-pod data/FSDP, ``data``
= FSDP/DP, ``model`` = the second sharded axis."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

__all__ = ["make_production_mesh", "make_test_mesh", "mesh_from_arg",
           "parse_mesh", "axes_for"]


def axes_for(ndim: int) -> Tuple[str, ...]:
    """The axis names of an ``ndim``-dim mesh: the last ``ndim`` of
    (pod, data, model)."""
    if not 1 <= ndim <= 3:
        raise ValueError(f"a mesh has 1 to 3 dims, not {ndim}")
    return ("pod", "data", "model")[-ndim:]


def parse_mesh(arg: str) -> Tuple[int, ...]:
    """``"AxB[xC]"`` → (A, B[, C])."""
    try:
        dims = tuple(int(d) for d in arg.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {arg!r}: expected AxB or AxBxC") from None
    axes_for(len(dims))
    if any(d < 1 for d in dims):
        raise ValueError(f"--mesh {arg!r}: every dim must be positive")
    return dims


def make_test_mesh(shape: Sequence[int] = (2, 4),
                   axes: Sequence[str] = ("data", "model"),
                   device_type: str = "cpu"):
    """A mesh of ``shape`` named ``axes`` over the running group, whose
    world size must be ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} with axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a running process group "
                           "(comm.p2p.spawn starts one)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} has "
                         f"{math.prod(shape)} devices, the group has "
                         f"{world} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 devices a pod; multi-pod adds a leading 2-pod axis
    (2×16×16 = 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_test_mesh(shape, axes_for(len(shape)), device_type)


def mesh_from_arg(arg: str, device_type: str):
    """The launchers' ``--mesh AxB[xC]`` mesh over the running group."""
    dims = parse_mesh(arg)
    return make_test_mesh(dims, axes_for(len(dims)), device_type)
