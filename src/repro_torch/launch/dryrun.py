"""Multi-pod dry run — the port of ``repro/launch/dryrun.py``: trace one
step of every (arch × shape) cell on the production mesh of 256 (or, with
``--multi-pod``, 512) placeholder ranks, with no memory and no card, and
record FLOPs, collective bytes and memory for the roofline.

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out P]

The JAX dry run lowers and compiles on 512 placeholder host devices. Its
twin here: :func:`main` opens a ``"fake"`` process group (``FakeStore``,
one process standing for rank 0 of the whole world: its collectives move
nothing), builds the production mesh over it — or the
``REPRO_DRYRUN_MESH`` override (``4x4``, ``2x2x4``) — and runs one train,
prefill or decode step of the sharded builders (``launch/steps.py``)
under ``FakeTensorMode``: every tensor has a shape, a dtype and a device
but no storage. Under a fake CPU tensor the kernels' plain versions run,
since a kernel cannot run on a fake tensor.

Each ``ok`` cell records

* ``flops``: ``FlopCounterMode``'s count of the step's products, per
  device (every product runs on local shards);
* ``collective_bytes``: per device, the result bytes of every
  collective the step issues (``_c10d_functional`` and DTensor's
  all-to-all), summed by the JAX dash names (``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``; DTensor issues no
  ``collective-permute``) — the convention of JAX's
  ``hlo_ir.collective_bytes``, with no loop-trip multipliers because the
  port's layer loop runs eagerly;
* ``memory``: ``argument_size_in_bytes``, exactly, from the local shards
  of the parameters, optimizer state and batch (or token, position and
  cache). No temporaries: ``MemTracker`` runs under the fake mode, but on
  these steps it keeps gathered copies that a real run frees (a granite
  decode step's fake-mode peak grew with its layer count; a real run's
  did not), so no peak is recorded;
* ``fits_80gb``: the arguments under one H100's 80 GB — the state fits;
  whether the step's temporaries do too, the dry run cannot say.

The skip rule is the JAX one (``cfg.supports_shape``: long_500k only on a
sub-quadratic arch); every other cell is traced. The process group is
per process: run the dry run as its own process, as the tests do."""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict

import torch

from ..config import SHAPES, get_config, list_configs
from ..models import get_model
from ..optim import adamw_init
from . import steps
from .mesh import axes_for, make_production_mesh, make_test_mesh, parse_mesh

__all__ = ["run_cell", "main"]

#: the collective ops DTensor issues → the JAX package's collective names
COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
#: one H100's device memory
HBM_BYTES = 80 * (1 << 30)


def _mesh_shape(multi_pod: bool):
    override = os.environ.get("REPRO_DRYRUN_MESH")
    if override:
        return parse_mesh(override)
    return (2, 16, 16) if multi_pod else (16, 16)


def _open_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"is open; the dry run needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _make_mesh(multi_pod: bool):
    """The production mesh, or the ``REPRO_DRYRUN_MESH`` override, over a
    fake group of its size."""
    shape = _mesh_shape(multi_pod)
    _open_group(math.prod(shape))
    if os.environ.get("REPRO_DRYRUN_MESH"):
        return make_test_mesh(shape, axes_for(len(shape)), "cpu")
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


class _Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums the result bytes of every collective op, per device."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            name = COLLECTIVE_NAMES.get(func._opname)
            if name is not None:
                res = out[0] if isinstance(out, (tuple, list)) else out
                nbytes = sum(t.numel() * t.element_size() for t in
                             (res if isinstance(res, (tuple, list))
                              else [res]) if isinstance(t, torch.Tensor))
                self.bytes[name] = self.bytes.get(name, 0) + nbytes
        return out


def _card_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard all-to-all as an NCCL mesh issues it
    (``_dtensor.shard_dim_alltoall``; its fake kernel gives the shape) —
    not the all-gather and chunk it falls back to on a CPU mesh, which
    has no all-to-all on gloo."""
    group_name = mesh.get_group(mesh_dim).group_name
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, group_name)


@contextlib.contextmanager
def _as_on_the_card():
    from unittest import mock
    with mock.patch("torch.distributed.tensor.placement_types."
                    "shard_dim_alltoall", _card_alltoall):
        yield


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from ..checkpoint.manager import flatten
    total = 0
    for _, t in flatten(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _zeros(meta_tree):
    if isinstance(meta_tree, dict):
        return {k: _zeros(v) for k, v in meta_tree.items()}
    if isinstance(meta_tree, tuple):
        return tuple(_zeros(v) for v in meta_tree)
    return torch.zeros(meta_tree.shape, dtype=meta_tree.dtype)


def _trace(cfg, shape, mesh):
    """One step of ``cfg`` at ``shape`` on fake tensors; returns (args,
    the step thunk)."""
    api = get_model(cfg)
    ins = steps.input_specs(cfg, shape)
    if shape.mode == "train":
        params = steps.shard_params(api.train_params(
            api._module()(cfg, device="cpu")), cfg, mesh)
        opt = adamw_init(params, state_dtype=steps.state_dtype_of(cfg))
        batch = _zeros(ins["batch"])
        fn = steps.build_train_step(cfg, shape, mesh=mesh)
        return ((params, opt), batch), lambda: fn(params, opt, batch, 0)
    params = steps.shard_params(api.serving_params(
        api._module()(cfg, device="cpu")), cfg, mesh)
    if shape.mode == "prefill":
        batch = _zeros(ins["batch"])
        fn = steps.build_prefill_step(cfg, shape, mesh=mesh)
        return (params, batch), lambda: fn(params, batch)
    cache = steps.shard_cache(_zeros(ins["cache"]), mesh)
    token, pos = _zeros(ins["token"]), _zeros(ins["pos"])
    fn = steps.build_decode_step(cfg, shape, mesh=mesh)
    return ((params, cache), {"token": token, "pos": pos}), \
        lambda: fn(params, token, pos, cache)


def _arg_bytes(args, mesh) -> int:
    """Local bytes of the sharded state plus this rank's shard of the
    batch (``batch_specs``)."""
    from ..runtime.sharding import batch_specs, local_shape
    state, batch = args
    total = _local_bytes(state)
    for k, spec in batch_specs(batch, mesh).items():
        t = batch[k]
        total += math.prod(local_shape(tuple(t.shape), spec, mesh)) * \
            t.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod}
    ok, why = cfg.supports_shape(shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    mesh = _make_mesh(multi_pod)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), _as_on_the_card():
        args, thunk = _trace(cfg, shape, mesh)
        arg_bytes = _arg_bytes(args, mesh)
        flops = FlopCounterMode(display=False)
        coll = _Collectives()
        with flops, coll:
            thunk()
    t_trace = time.time() - t0
    memory = {"argument_size_in_bytes": int(arg_bytes)}
    result = {**head, "status": "ok", "ndev": mesh.size(),
              "mesh": list(mesh.shape), "trace_s": round(t_trace, 1),
              "flops": float(flops.get_total_flops()),
              "collective_bytes": coll.bytes, "memory": memory,
              "fits_80gb": bool(arg_bytes < HBM_BYTES)}
    print(f"[dryrun] {arch} × {shape_name} × {mesh.size()}: OK (trace "
          f"{t_trace:.0f}s, flops={result['flops']:.3e}, "
          f"collective={sum(coll.bytes.values()):.3e} B)", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun_results.json")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, args.multi_pod) for a in list_configs()
                 for s in SHAPES]
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["multi_pod"]) for r in results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for arch, shape, mp in cells:
        if (arch, shape, mp) in done:
            continue
        try:
            r = run_cell(arch, shape, mp)
        except Exception as e:        # one cell's failure is its record
            traceback.print_exc()
            r = {"arch": arch, "shape": shape, "multi_pod": mp,
                 "status": "error", "error": repr(e)}
        results.append(r)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    count = {s: sum(r["status"] == s for r in results)
             for s in ("ok", "skipped", "unsupported", "error")}
    print(f"[dryrun] done: {count['ok']} ok, {count['skipped']} skipped, "
          f"{count['unsupported']} unsupported, {count['error']} errors")
    return 1 if count["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
