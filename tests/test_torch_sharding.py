"""The port's sharding rules (``repro_torch.runtime.sharding``) and mesh
(``repro_torch.launch.mesh``) against the JAX package's on the CPU.

The spec trees — ``param_specs``, ``batch_specs``, ``cache_pspec`` and
every ``act_policy`` name at the shapes the models pass — equal the JAX
package's for all ten configs at full size on the meshes 16×16, 2×16×16,
2×4 and 4×4. The JAX side runs on ``jax.sharding.AbstractMesh``es and
``param_shapes()``, with no devices; the comparison drops the leading
stack axis of the JAX block leaves (the port holds one module a layer).
The DTensor shards the placements make (a fake process group, in a
subprocess so that it stays out of the other tests) have JAX's
``NamedSharding.shard_shape``, the folded ``("pod", "data")`` axis
included.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import config as jconfig
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.runtime import sharding as jsh

from repro_torch import config as tconfig
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import get_model
from repro_torch.runtime import sharding as tsh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x4": ((4, 4), ("data", "model"))}


def _jmesh(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names)


def _tmesh(name):
    sizes, names = MESHES[name]
    return tsh.MeshAxes(names, sizes)


def _jax_param_specs(arch, mesh):
    """The JAX (spec, shape) of the leaf of every port parameter, keyed by
    the port's name: each name's ``leaf_path`` must be a JAX leaf whose
    shape is the port's (after the stack axis), every JAX leaf used."""
    cfg = jconfig.get_config(arch)
    shapes = jget_model(cfg).param_shapes()
    specs = jsh.param_specs(shapes, mesh)
    flat = {jax.tree_util.keystr(kp): (tuple(s), tuple(l.shape))
            for (kp, l), s in zip(
                jax.tree_util.tree_flatten_with_path(shapes)[0],
                jax.tree_util.tree_leaves(
                    specs, is_leaf=lambda x: isinstance(x, P)))}
    tcfg = tconfig.get_config(arch)
    out, used = {}, set()
    for name, w in get_model(tcfg).param_shapes().named_parameters():
        path, stack = tsh.leaf_path(name, tcfg)
        spec, shape = flat[path]
        assert shape == ((stack,) if stack else ()) + tuple(w.shape), name
        out[name] = (spec, shape)
        used.add(path)
    assert used == set(flat), arch
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_jax_every_config(mesh):
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    for arch in ALL_ARCHS:
        cfg = tconfig.get_config(arch)
        ours = tsh.param_specs(get_model(cfg).param_shapes(), cfg, tm)
        ref = _jax_param_specs(arch, jm)
        assert set(ours) == set(ref), arch
        for name, spec in ours.items():
            jspec, jshape = ref[name]
            jspec = jspec + (None,) * (len(jshape) - len(jspec))
            stacked = len(jshape) == len(spec) + 1
            want = jspec[1:] if stacked else jspec
            assert spec == want, (arch, name, spec, jspec)
            local = tsh.local_shape(
                jshape[1:] if stacked else jshape, spec, tm)
            jlocal = NamedSharding(jm, P(*jspec)).shard_shape(jshape)
            assert local == (jlocal[1:] if stacked else jlocal), \
                (arch, name, local, jlocal)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_equal_jax(mesh):
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    for arch in ALL_ARCHS:
        jcfg, tcfg = jconfig.get_config(arch), tconfig.get_config(arch)
        for sname, shape in jconfig.SHAPES.items():
            tshape = tconfig.SHAPES[sname]
            jins = jsteps.input_specs(jcfg, shape, jm)
            tins = tsteps.input_specs(tcfg, tshape)
            if shape.mode != "decode":
                ref = {k: tuple(v) for k, v in
                       jsh.batch_specs(jins["batch"], jm).items()}
                got = tsh.batch_specs(tins["batch"], tm)
                assert got == ref, (arch, sname)
                continue
            jc, tc = jins["cache"], tins["cache"]
            if not isinstance(jc, tuple):
                jc, tc = (jc,), (tc,)
            assert len(jc) == len(tc), arch
            for je, te in zip(jc, tc):
                assert set(je) == set(te), (arch, sname)
                for k, x in je.items():
                    assert tuple(te[k].shape) == tuple(x.shape), (arch, k)
                    assert tsh.cache_pspec(tuple(x.shape), tm) == \
                        tuple(jsh.cache_pspec(x.shape, jm)), (arch, k)
            got = tsh.batch_specs({"t": tins["token"]}, tm)["t"]
            assert got == tuple(jsh.batch_specs({"t": jins["token"]},
                                                jm)["t"])


def _act_shapes(cfg, shape):
    """The shapes the models pass to each constrained name."""
    B = shape.global_batch
    S = shape.seq_len if shape.mode != "decode" else 1
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = [("hidden", (B, S, D)), ("hidden", (B, 1, D)),
           ("pre_logits", (B, S, D)), ("logits", (B, S, cfg.vocab_padded)),
           ("logits", (B, cfg.vocab_padded)),
           ("attn_kv_full", (B, S, KV, hd)),
           ("attn_chunked_q", (4, B, H, max(H // KV, 1), 128, hd)),
           ("attn_chunked_kv", (4, B, H, 128, hd)), ("unknown", (B, S))]
    if cfg.n_experts:
        for G in (1, 2, 16, 32):
            cap = int(B * S / G * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor) + 1
            out += [("moe_dispatch", (G, cfg.n_experts, cap, D)),
                    ("moe_ffn_act", (G, cfg.n_experts, cap, cfg.d_ff))]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_policy_equals_jax(mesh):
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    jpol, tpol = jsh.act_policy(jm), tsh.act_policy(tm)
    assert tpol.info == jpol.info
    for arch in ALL_ARCHS:
        cfg = tconfig.get_config(arch)
        for sname in ("train_4k", "decode_32k"):
            for name, shape in _act_shapes(cfg, tconfig.SHAPES[sname]):
                ref = jpol(name, jax.ShapeDtypeStruct(shape, np.float32))
                got = tsh.act_spec(name, shape, tm)
                assert got == (None if ref is None else tuple(ref)), \
                    (arch, name, shape, got, ref)


@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "dbrx-132b",
                                  "jamba-1.5-large-398b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_step_shardings_equal_the_jax_builders(mesh, arch):
    """``launch.steps.step_shardings`` against the in-shardings the JAX
    package's ``build_train_step`` and ``build_decode_step`` return:
    batch, token and cache (the parameters are ``param_specs``', held to
    JAX's above)."""
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    jcfg, tcfg = jconfig.get_config(arch), tconfig.get_config(arch)
    spec = lambda sh: tuple(sh.spec)                          # noqa: E731
    for sname in ("train_4k", "decode_32k"):
        shape = jconfig.SHAPES[sname]
        got = tsteps.step_shardings(tcfg, tconfig.SHAPES[sname], tm)
        assert got["params"] == tsh.param_specs(
            get_model(tcfg).param_shapes(), tcfg, tm)   # = JAX's, above
        if shape.mode == "train":
            _, _, ins, _ = jsteps.build_train_step(jcfg, shape, jm)
            assert got["batch"] == {k: spec(v) for k, v in ins[2].items()}
            continue
        _, _, ins, _ = jsteps.build_decode_step(jcfg, shape, jm)
        assert got["token"] == got["pos"] == spec(ins[1])
        if isinstance(ins[3], dict):                # the enc-dec cache
            assert got["cache"] == {k: spec(v) for k, v in ins[3].items()}
            continue
        assert len(got["cache"]) == len(ins[3])
        for je, te in zip(ins[3], got["cache"]):
            assert te == {k: spec(v) for k, v in je.items()}


def test_placements_fold_the_pod_axis():
    from torch.distributed.tensor import Replicate, Shard
    m = _tmesh("2x16x16")
    assert tsh.placements((("pod", "data"), "model"), m) == \
        (Shard(0), Shard(0), Shard(1))
    assert tsh.placements((None, "model"), m) == \
        (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="used twice"):
        tsh.placements(("model", "model"), m)


_SHARDS = r"""
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import distribute_tensor
from repro_torch import config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_model
from repro_torch.runtime import sharding as sh
sizes, names = json.loads(sys.argv[1]), json.loads(sys.argv[2])
world = 1
for s in sizes:
    world *= s
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=world)
mesh = tmesh.make_test_mesh(sizes, names)
out = {}
for arch in json.loads(sys.argv[3]):
    cfg = config.get_config(arch)
    shapes = get_model(cfg).param_shapes()
    specs = sh.param_specs(shapes, cfg, mesh)
    for name, w in shapes.named_parameters():
        t = distribute_tensor(torch.empty(w.shape, device="meta"), mesh,
                              sh.placements(specs[name], mesh),
                              src_data_rank=None)
        out[arch + ":" + name] = list(t.to_local().shape)
print(json.dumps(out))
"""


@pytest.mark.parametrize("mesh", ["2x16x16", "2x4"])
def test_dtensor_local_shards_equal_jax_shard_shape(mesh):
    """The DTensor that ``placements`` makes of every parameter holds, on
    rank 0 of a fake group of the mesh's size, JAX's shard shape (the
    stack axis dropped)."""
    sizes, names = MESHES[mesh]
    archs = ["granite-3-2b", "dbrx-132b", "jamba-1.5-large-398b",
             "seamless-m4t-large-v2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _SHARDS, json.dumps(sizes),
                        json.dumps(names), json.dumps(archs)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    jm = _jmesh(mesh)
    n = 0
    for arch in archs:
        for name, (jspec, jshape) in _jax_param_specs(arch, jm).items():
            jspec = jspec + (None,) * (len(jshape) - len(jspec))
            local = NamedSharding(jm, P(*jspec)).shard_shape(jshape)
            want = list(local[1:] if len(jshape) == len(
                got[arch + ":" + name]) + 1 else local)
            assert got[arch + ":" + name] == want, (arch, name)
            n += 1
    assert n == len(got)


def test_mesh_helpers():
    assert tmesh.parse_mesh("2x4") == (2, 4)
    assert tmesh.parse_mesh("2x2x4") == (2, 2, 4)
    assert tmesh.axes_for(3) == ("pod", "data", "model")
    for bad in ("2x", "0x4", "1x1x1x1"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh(bad)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_test_mesh((2, 4))
