"""Sharding rules — the port of ``repro/runtime/sharding.py``: 2-D
FSDP×TP over the mesh axes (data, model), with the optional leading pod
axis folded into the data (FSDP) dimension.

Every parameter is sharded over both axes (ZeRO-3 style: FSDP on one
dim, tensor-parallel on the other); the AdamW moments take their
parameter's spec. Activations: batch→data and, in train/prefill,
sequence→model between blocks. A dim that does not divide its axis falls
back to replication, which is what lets the same rules serve 14-head
internvl2 and 64-head qwen3.

The rules are pure functions of shapes and an abstract mesh — axis names
and sizes (:class:`MeshAxes`, or a ``torch.distributed`` ``DeviceMesh``
with named dims) — so they run without a process group. A spec is a
tuple with one entry per tensor dim, each ``None``, an axis name, or a
tuple of names (the folded ``("pod", "data")``): the entries of the JAX
package's ``PartitionSpec``. :func:`placements` turns a spec into
DTensor placements, one per mesh dim; an entry naming two axes becomes
``Shard(d)`` on both, and DTensor shards left to right over the mesh
dims, which is the pod-major order of JAX.

**Parameter names.** The rules match substrings of the JAX leaf path
(``jax.tree_util.keystr``: ``"['blocks'][0]['mixer']['wq']['w']"``).
:func:`param_specs` maps each of the port's parameter names to that path
the way ``models.convert`` maps names to JAX leaves, and applies the one
rule table below to it. The JAX leaves of the decoder blocks are stacked
over the layer groups (the enc-dec stacks over layers) on a leading axis
the port's one-module-a-layer parameters lack: the port's spec is the
JAX spec of the stacked shape with that leading entry dropped. For a
port leaf of one dim (a block's norm scale, mamba's ``D`` and
``dt_bias``) the JAX rule may shard the stack axis over data; no layer
of the port holds that axis, so only the trailing entry carries over."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

__all__ = ["MeshAxes", "mesh_axes", "param_specs", "batch_specs",
           "cache_pspec", "act_spec", "act_policy", "placements",
           "leaf_path", "local_shape"]

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshAxes:
    """An abstract mesh: axis names and sizes, no devices."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def mesh_axes(mesh) -> MeshAxes:
    """The axis names and sizes of ``mesh``: a :class:`MeshAxes` or a
    ``DeviceMesh`` with ``mesh_dim_names``."""
    if isinstance(mesh, MeshAxes):
        return mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the sharding rules need a mesh with named dims")
    return MeshAxes(tuple(names), tuple(int(s) for s in mesh.shape))


def _axes_of(mesh: MeshAxes) -> Tuple[Any, str]:
    if "pod" in mesh.names:
        return (("pod", "data"), "model")
    return ("data", "model")


def _size(mesh: MeshAxes, axis) -> int:
    if isinstance(axis, tuple):
        return int(math.prod(mesh.shape[a] for a in axis))
    return int(mesh.shape[axis])


def _fits(dim: int, mesh: MeshAxes, axis) -> bool:
    return axis is not None and dim % _size(mesh, axis) == 0


def _spec2d(mesh: MeshAxes, d0: int, d1: int, a0, a1) -> Spec:
    """Shard (d0, d1) over (a0, a1) with divisibility fallback."""
    return (a0 if _fits(d0, mesh, a0) else None,
            a1 if _fits(d1, mesh, a1) else None)


_OUT_PARALLEL = ("wq", "wk", "wv", "up", "gate", "ogate", "wx", "in_proj",
                 "unembed")
_IN_PARALLEL = ("wo", "down", "out_proj")


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh: MeshAxes) -> Spec:
    """The rule table of ``repro/runtime/sharding.py:56-94`` on a JAX
    leaf path and the JAX (stacked) shape."""
    dta, mdl = _axes_of(mesh)
    nd = len(shape)

    def pad(spec) -> Spec:
        return tuple([None] * (nd - len(spec)) + list(spec))

    if nd <= 1:
        return (None,) * nd
    t0, t1 = shape[-2], shape[-1]
    if "w_up" in path or "w_gate" in path:      # (E, D, F)
        E = shape[-3]
        if _fits(E, mesh, mdl):                 # expert parallel
            return pad((None,) * (nd - 3) + (
                mdl, dta if _fits(t0, mesh, dta) else None, None))
        return pad(_spec2d(mesh, t0, t1, dta, mdl))
    if "w_down" in path:                        # (E, F, D)
        E = shape[-3]
        if _fits(E, mesh, mdl):
            return pad((None,) * (nd - 3) + (
                mdl, None, dta if _fits(t1, mesh, dta) else None))
        return pad(_spec2d(mesh, t0, t1, mdl, dta))
    if "embed" in path and "unembed" not in path:   # (V, D)
        return pad(_spec2d(mesh, t0, t1, mdl, dta))
    if "router" in path:                        # (D, E)
        return pad(_spec2d(mesh, t0, t1, dta, None))
    if "x_proj" in path:                        # (di, 2ds+1)
        return pad(_spec2d(mesh, t0, t1, mdl, None))
    if "A_log" in path:
        return pad(_spec2d(mesh, t0, t1, mdl, None))
    if "conv_w" in path:                        # (dc, di)
        return pad(_spec2d(mesh, t0, t1, None, mdl))
    if "wr" in path:                            # (h, hd, 4hd)
        return pad(_spec2d(mesh, t0, t1, None, mdl))
    if any(k in path for k in _IN_PARALLEL):    # (F, D)
        return pad(_spec2d(mesh, t0, t1, mdl, dta))
    if any(k in path for k in _OUT_PARALLEL):   # (D, F)
        return pad(_spec2d(mesh, t0, t1, dta, mdl))
    return pad(_spec2d(mesh, t0, t1, dta, mdl))


def leaf_path(name: str, cfg) -> Tuple[str, int]:
    """The JAX leaf path (``keystr``) of the port's parameter ``name`` and
    the length of the stack axis the JAX leaf has in front of the port's
    shape (0 for an unstacked leaf) — the mapping of
    ``models.convert._by_name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        g = cfg.layer_group
        keys = ("blocks", int(parts[1]) % g) + tuple(parts[2:])
        stack = cfg.n_layers // g
    elif parts[0] in ("enc", "dec"):
        keys = (parts[0],) + tuple(parts[2:])
        stack = cfg.enc_layers if parts[0] == "enc" else cfg.n_layers
    else:
        keys, stack = tuple(parts), 0
    path = "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in keys)
    return path, stack


def param_specs(params, cfg, mesh) -> Dict[str, Spec]:
    """Spec of every parameter of the module ``params`` (``meta`` shapes
    will do), keyed by name. AdamW's moments take the spec of their
    parameter."""
    m = mesh_axes(mesh)
    out = {}
    for name, w in params.named_parameters():
        shape = tuple(w.shape)
        path, stack = leaf_path(name, cfg)
        if stack:
            out[name] = _leaf_spec(path, (stack,) + shape, m)[1:]
        else:
            out[name] = _leaf_spec(path, shape, m)
    return out


# -- batch / cache ------------------------------------------------------------

def _batch_axis(b: int, mesh: MeshAxes):
    dta, _ = _axes_of(mesh)
    if _fits(b, mesh, dta):
        return dta
    return "data" if _fits(b, mesh, "data") else None


def batch_specs(batch_shapes: Dict, mesh) -> Dict[str, Spec]:
    """Spec of each batch entry (anything with ``.shape``, or a shape):
    dim 0 over the data axes, dim 1 over model when it divides and is
    longer than one."""
    m = mesh_axes(mesh)
    _, mdl = _axes_of(m)
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        s0 = _batch_axis(shape[0], m)
        if len(shape) >= 2 and shape[1] % _size(m, mdl) == 0 and \
                shape[1] > 1:
            out[k] = (s0, mdl) + (None,) * (len(shape) - 2)
        else:
            out[k] = (s0,) + (None,) * (len(shape) - 1)
    return out


def cache_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """Decode-cache spec: the leading stack axis unsharded, batch→data,
    the longest remaining (sequence/state) dim→model if it divides."""
    m = mesh_axes(mesh)
    _, mdl = _axes_of(m)
    spec = [None] * len(shape)
    if len(shape) >= 2:
        spec[1] = _batch_axis(shape[1], m)
    if len(shape) >= 3:
        rest = list(range(2, len(shape)))
        best = max(rest, key=lambda i: shape[i])
        if _fits(shape[best], m, mdl):
            spec[best] = mdl
    return tuple(spec)


# -- activation constraint policy ---------------------------------------------

def act_spec(name: str, shape: Tuple[int, ...], mesh) -> Optional[Spec]:
    """The spec ``repro/runtime/sharding.py:act_policy`` gives logical
    tensor ``name`` of ``shape`` (``None``: no constraint)."""
    m = mesh_axes(mesh)
    _, mdl = _axes_of(m)
    nd = len(shape)
    if name == "moe_dispatch" and nd == 4:
        # (G, E, C, D): groups->data; experts->model when divisible
        G, E = shape[0], shape[1]
        return (_batch_axis(G, m), mdl if _fits(E, m, mdl) else None,
                None, None)
    if name == "moe_ffn_act" and nd == 4:
        # (G, E, C, F): experts->model, else ffn->model
        G, E, _, F = shape
        if _fits(E, m, mdl):
            return (_batch_axis(G, m), mdl, None, None)
        return (_batch_axis(G, m), None, None,
                mdl if _fits(F, m, mdl) else None)
    if name == "attn_chunked_q" and nd == 6:
        # (nq, B, H, G, qc, hd): batch->data, heads->model
        _, B, H = shape[:3]
        return (None, _batch_axis(B, m), mdl if _fits(H, m, mdl) else None,
                None, None, None)
    if name == "attn_kv_full" and nd == 4:
        # (B, S, KV, hd): batch->data, heads replicated (pre-repeat)
        return (_batch_axis(shape[0], m), None, None, None)
    if name == "attn_chunked_kv" and nd == 5:
        _, B, H = shape[:3]
        return (None, _batch_axis(B, m), mdl if _fits(H, m, mdl) else None,
                None, None)
    if name == "hidden" and nd == 3:
        B, S, _ = shape
        return (_batch_axis(B, m), mdl if (S > 1 and _fits(S, m, mdl))
                else None, None)
    if name == "pre_logits" and nd == 3:
        return (_batch_axis(shape[0], m), None, None)
    if name == "logits":
        sv = mdl if _fits(shape[-1], m, mdl) else None
        return (_batch_axis(shape[0], m),) + (None,) * (nd - 2) + (sv,)
    return None


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim, in
    the mesh's order): ``Shard(d)`` on every mesh dim that entry ``d``
    names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_axes(mesh)
    out = [Replicate()] * len(m.names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i = m.names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` (every sharded dim divides: the rules fall back otherwise)."""
    m = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= _size(m, entry)
    return tuple(out)


def act_policy(mesh):
    """The activation policy for ``models.sharding_hooks``:
    ``policy(name, x)`` redistributes a DTensor ``x`` to
    :func:`act_spec`'s placement (``None`` for a plain tensor or an
    unconstrained name); ``policy.info`` holds ``data_groups`` (the data
    shard count, the MoE dispatch's group count) and ``model_size``."""
    m = mesh_axes(mesh)
    dta, mdl = _axes_of(m)

    def policy(name: str, x):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return None
        spec = act_spec(name, tuple(x.shape), m)
        if spec is None:
            return None
        want = placements(spec, m)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    policy.info = {"data_groups": _size(m, dta), "model_size": _size(m, mdl)}
    return policy
