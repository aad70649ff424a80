"""The port's sharded steps (``launch.steps`` with a mesh), their
checkpoint resume and the ``--mesh`` launchers, on the CPU.

**Steps.** On 8 gloo ranks and a 2×4 (data × model) mesh, reduced
granite-3-2b's and reduced dbrx-132b's sharded train step, gradients,
prefill and decode are held to the JAX package's jitted sharded steps
on 8 host devices (a 2×4 mesh of ``AxisType.Auto`` axes: JAX 0.9's
default explicit axes refuse the JAX models' sharding constraints), from
the same JAX-drawn parameters and the pipeline's batch 0 (B = 2, S = 24):
the loss to 5e-3, the gradient norm and each gradient leaf to 0.15
relative, logits to rtol 5e-2 and atol 5e-2·max(1, max|ref|) — the
tolerances of ``tests/test_torch_train.py`` and
``tests/test_torch_models.py``. dbrx's MoE groups its tokens by the
policy's ``data_groups`` (2 on this mesh), which moves its capacity: the
JAX side is the JAX sharded MoE. The port's sharded step also matches
its own one-process step (dbrx under a policy with the same
``data_groups``).

**Resume.** A sharded run saves after step 0 and takes step 1; fresh
sharded parameters restored from that checkpoint take step 1 again: the
loss and every parameter are bitwise the uninterrupted run's.

**Launchers.** ``launch.train`` and ``launch.serve --mesh 2x2 --device
cpu --scale reduced`` exit 0 over four gloo ranks; ``spawn(backend=
"nccl")`` on this host, which has no NCCL, raises a ``RuntimeError``
that names it.

All of it runs at once: the JAX subprocess, the eight ranks and the two
launchers start together in one module fixture.

    PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_steps.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro import config as jconfig
from repro.models import get_model as jget_model

from repro_torch import config as tconfig
from repro_torch.comm import p2p
from repro_torch.data import SyntheticTokens
from repro_torch.launch import steps
from repro_torch.models import get_model
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.models.sharding_hooks import sharding_policy
from repro_torch.optim import adamw_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-2b", "dbrx-132b")
B, S, DECODE = 2, 24, 4
LOSS_TOL, GRAD_TOL = 5e-3, 0.15

_JAX = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import config
from repro.data.pipeline import SyntheticTokens
from repro.launch import steps
from repro.models import get_model
from repro.models.sharding_hooks import sharding_policy
from repro.optim import adamw_init
from repro.runtime.sharding import act_policy
B, S, DECODE = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[5:]:
    cfg = config.reduced_config(config.get_config(arch))
    api = get_model(cfg)
    params = api.init(jax.random.key(0))
    flat, tree = jax.tree_util.tree_flatten(params)
    batch = {k: jnp.asarray(v) for k, v in SyntheticTokens(
        vocab=cfg.vocab, seq_len=S, global_batch=B).batch_at(0).items()}
    shape = config.ShapeConfig("t", S, B, "train")
    fn, _, ins, outs = steps.build_train_step(cfg, shape, mesh)
    pol = act_policy(mesh)

    def grads(p, b):
        with sharding_policy(pol):
            return jax.value_and_grad(lambda q: api.loss(q, b))(p)

    with mesh:
        _, _, loss, mx = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
            params, adamw_init(params), batch, jnp.asarray(0))
        _, g = jax.jit(grads, in_shardings=(ins[0], ins[2]))(params, batch)
        pf, _, pins, pouts = steps.build_prefill_step(cfg, shape, mesh)
        logits = jax.jit(pf, in_shardings=pins, out_shardings=pouts)(
            params, batch)
        dshape = config.ShapeConfig("d", S, B, "decode")
        df, _, dins, douts = steps.build_decode_step(cfg, dshape, mesh)
        dstep = jax.jit(df, in_shardings=dins, out_shardings=douts)
        cache = jax.device_put(api.init_cache(B, S), dins[3])
        dec = []
        for t in range(DECODE):
            lg, cache = dstep(params, batch["tokens"][:, t],
                              jnp.full((B,), t, jnp.int32), cache)
            dec.append(np.asarray(lg, np.float32))
    out[arch + "/loss"] = np.asarray(loss)
    out[arch + "/grad_norm"] = np.asarray(mx["grad_norm"])
    out[arch + "/prefill"] = np.asarray(logits, np.float32)
    out[arch + "/decode"] = np.stack(dec)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(g)):
        out[arch + f"/g{i}"] = np.asarray(leaf, np.float32)
np.savez(sys.argv[1], **out)
"""


def _jax_params(arch):
    """The JAX init at key 0 (what the subprocess draws) as numpy."""
    cfg = jconfig.reduced_config(jconfig.get_config(arch))
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(np.float32) if x.dtype.name
                             == "bfloat16" else x),
        jget_model(cfg).init(jax.random.key(0)))


def _batch(cfg, i=0):
    return SyntheticTokens(vocab=cfg.vocab, seq_len=S,
                           global_batch=B).batch_at(i)


def _cfg(arch):
    return tconfig.reduced_config(tconfig.get_config(arch))


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
        .detach().float().numpy()


def _ranked(rank, trees, ckpt):
    """One rank: each arch's sharded train step (its gradients recorded on
    their way to AdamW), prefill and decode; then granite's resume: saved
    after step 0, step 1 taken on, and taken again from the checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)            # eight ranks share the host
    mesh = make_test_mesh((2, 4))
    update = steps.adamw_update
    seen = {}

    def recording(params, grads, state, lr):
        seen.update({k: _full(g) for k, g in grads.items()})
        return update(params, grads, state, lr)

    steps.adamw_update = recording
    out = {}
    for arch, tree in trees.items():
        cfg = _cfg(arch)
        api = get_model(cfg)
        shape = tconfig.ShapeConfig("t", S, B, "train")
        batch = _batch(cfg)

        def start():
            p = api.train_params(params_from_jax(tree, cfg, device="cpu"))
            p = steps.shard_params(p, cfg, mesh)
            return p, adamw_init(p, state_dtype=steps.state_dtype_of(cfg))

        p, opt = start()
        step = steps.build_train_step(cfg, shape, mesh=mesh)
        seen.clear()
        p, opt, loss, mx = step(p, opt, batch, 0)
        out[arch + "/grads"] = dict(seen)
        out[arch + "/loss"] = float(loss)
        out[arch + "/grad_norm"] = float(mx["grad_norm"])
        if arch == ARCHS[0]:
            mgr = CheckpointManager(ckpt)
            mgr.save(1, (p, opt))
            p, opt, loss, _ = step(p, opt, _batch(cfg, 1), 1)
            run = (float(loss), {k: _full(w) for k, w in
                                 p.named_parameters()})
            p, opt = start()
            mgr.restore(1, (p, opt))
            assert int(opt.step) == 1
            p, opt, loss, _ = step(p, opt, _batch(cfg, 1), 1)
            out["resume"] = (run, (float(loss), {
                k: _full(w) for k, w in p.named_parameters()}))

        served = api.serving_params(params_from_jax(tree, cfg, device="cpu"))
        served = steps.shard_params(served, cfg, mesh)
        out[arch + "/prefill"] = steps.build_prefill_step(
            cfg, shape, mesh=mesh)(served, batch).float().numpy()
        dec = steps.build_decode_step(cfg, shape, mesh=mesh)
        cache = steps.shard_cache(api.init_cache(B, S, device="cpu"), mesh)
        logits = []
        for t in range(DECODE):
            lg, cache = dec(served, batch["tokens"][:, t],
                            np.full(B, t, np.int32), cache)
            logits.append(lg.float().numpy())
        out[arch + "/decode"] = np.stack(logits)
    # dbrx on a 1×8 mesh: its 4 experts do not divide the model axis, so
    # each rank takes a slice of every expert's FFN (``moe_ffn_act``)
    cfg = _cfg(ARCHS[1])
    api = get_model(cfg)
    flat = make_test_mesh((1, 8))
    p = api.train_params(params_from_jax(trees[ARCHS[1]], cfg, "cpu"))
    p = steps.shard_params(p, cfg, flat)
    opt = adamw_init(p, state_dtype=steps.state_dtype_of(cfg))
    seen.clear()
    _, _, loss, mx = steps.build_train_step(cfg, None, mesh=flat)(
        p, opt, _batch(cfg), 0)
    out["dbrx-132b/1x8"] = (float(loss), float(mx["grad_norm"]), dict(seen))
    return out if rank == 0 else None


def _launch(module, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", module, "--arch", "granite-3-2b", "--mesh",
         "2x2", "--device", "cpu", "--scale", "reduced", *extra], env=env,
        cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the eight ranks and both launchers, at once."""
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jproc = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(d / "jax.npz"), str(B), str(S),
         str(DECODE), *ARCHS], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    launchers = {
        "train": _launch("repro_torch.launch.train", "--steps", "2",
                         "--batch", "4", "--seq", "32", "--ckpt",
                         str(d / "launch_ckpt")),
        "serve": _launch("repro_torch.launch.serve", "--requests", "3",
                         "--max-new", "4")}
    procs = [jproc, *launchers.values()]
    try:
        trees = {a: _jax_params(a) for a in ARCHS}
        ranked = p2p.spawn(_ranked, 8, trees, str(d / "ckpt"), timeout=400)
        done = {k: p.communicate(timeout=400) + (p.returncode,)
                for k, p in launchers.items()}
        jout, jerr = jproc.communicate(timeout=400)
        assert jproc.returncode == 0, jout + jerr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = dict(np.load(d / "jax.npz"))
    return {"ranked": ranked[0], "jax": ref, "trees": trees,
            "launchers": done}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, ref):
    atol = 5e-2 * max(1.0, float(np.abs(ref).max()))
    return bool(np.all(np.abs(got - ref) <= atol + 5e-2 * np.abs(ref)))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax(runs, arch):
    got, ref = runs["ranked"], runs["jax"]
    assert abs(got[arch + "/loss"] - float(ref[arch + "/loss"])) <= LOSS_TOL
    assert abs(got[arch + "/grad_norm"] / float(ref[arch + "/grad_norm"])
               - 1) <= GRAD_TOL
    cfg = _cfg(arch)
    leaves, tree = jax.tree_util.tree_flatten(runs["trees"][arch])
    jg = named_from_jax(jax.tree_util.tree_unflatten(
        tree, [ref[arch + f"/g{i}"] for i in range(len(leaves))]), cfg)
    worst = {k: _rel(g, jg[k]) for k, g in got[arch + "/grads"].items()}
    k = max(worst, key=worst.get)
    print(f"{arch}: |Δloss| "
          f"{abs(got[arch + '/loss'] - float(ref[arch + '/loss'])):.2e}, "
          f"worst gradient leaf {k} {worst[k]:.3f}")
    assert worst[k] <= GRAD_TOL, (k, worst[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_jax(runs, arch):
    got, ref = runs["ranked"], runs["jax"]
    assert _close(got[arch + "/prefill"], ref[arch + "/prefill"])
    assert got[arch + "/decode"].shape == ref[arch + "/decode"].shape
    assert _close(got[arch + "/decode"], ref[arch + "/decode"])


def _unsharded(arch, tree):
    """The port's one-process step, prefill and decode; dbrx under a
    policy whose only fact is the mesh's ``data_groups``."""
    cfg = _cfg(arch)
    api = get_model(cfg)
    pol = lambda name, x: None                      # noqa: E731
    pol.info = {"data_groups": 2}
    batch = _batch(cfg)
    with sharding_policy(pol):
        p = api.train_params(params_from_jax(tree, cfg, device="cpu"))
        opt = adamw_init(p, state_dtype=steps.state_dtype_of(cfg))
        _, _, loss, mx = steps.build_train_step(cfg, None, "cpu")(
            p, opt, batch, 0)
        served = api.serving_params(params_from_jax(tree, cfg, "cpu"))
        pre = api.prefill(served, batch)
        cache = api.init_cache(B, S, device="cpu")
        dec = []
        for t in range(DECODE):
            lg, cache = api.decode_step(served, batch["tokens"][:, t],
                                        np.full(B, t, np.int32), cache)
            dec.append(lg.float().numpy())
    return float(loss), float(mx["grad_norm"]), pre.float().numpy(), \
        np.stack(dec)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_one_process_step(runs, arch):
    got = runs["ranked"]
    loss, norm, pre, dec = _unsharded(arch, runs["trees"][arch])
    assert abs(got[arch + "/loss"] - loss) <= LOSS_TOL
    assert abs(got[arch + "/grad_norm"] / norm - 1) <= GRAD_TOL
    assert _close(got[arch + "/prefill"], pre)
    assert _close(got[arch + "/decode"], dec)


def test_moe_experts_split_by_ffn_width(runs):
    """dbrx on a 1×8 mesh (E = 4 does not divide 8, d_ff 128 does): the
    sharded step against the one-process step (one data group), loss,
    grad_norm and every gradient leaf."""
    loss, norm, grads = runs["ranked"]["dbrx-132b/1x8"]
    cfg = _cfg("dbrx-132b")
    api = get_model(cfg)
    p = api.train_params(params_from_jax(runs["trees"]["dbrx-132b"], cfg,
                                         "cpu"))
    ref = api.loss(p, _batch(cfg))
    ref.backward()
    assert abs(loss - float(ref)) <= LOSS_TOL
    worst = max(_rel(grads[k], w.grad.float().numpy())
                for k, w in p.named_parameters())
    assert worst <= GRAD_TOL, worst
    ref_norm = float(torch.sqrt(sum(w.grad.float().square().sum()
                                    for w in p.parameters())))
    assert abs(norm / ref_norm - 1) <= GRAD_TOL


def test_sharded_resume_is_bitwise(runs):
    (loss_a, p_a), (loss_b, p_b) = runs["ranked"]["resume"]
    assert loss_a == loss_b
    assert set(p_a) == set(p_b)
    for k in p_a:
        assert np.array_equal(p_a[k], p_b[k]), k


@pytest.mark.parametrize("which", ["train", "serve"])
def test_mesh_launchers_on_the_cpu(runs, which):
    out, err, rc = runs["launchers"][which]
    assert rc == 0, err[-3000:]
    assert "mesh 2x2: 4 gloo ranks" in out
    if which == "train":
        assert out.strip().splitlines()[-1].startswith(
            "[train] done: final step 2, last loss ")
    else:
        assert "completed 3/3 requests, 12 tokens generated" in out


def test_nccl_spawn_without_nccl_names_it():
    with pytest.raises(RuntimeError, match="NCCL"):
        p2p.spawn(_ranked, 2, backend="nccl")


def test_launch_config_cuts_heads_of_64():
    """Both launchers take ``launch_config``: ``--scale reduced`` is
    ``reduced_config`` on the CPU, and on the card the same cut at
    d_model 512 in 8 heads of 64, the narrowest the flash kernels take;
    ``full`` is the config itself."""
    from repro_torch.launch import serve, train
    assert serve.launch_config is steps.launch_config
    assert train.train_config is steps.launch_config
    for arch in ("granite-3-2b", "dbrx-132b", "qwen3-32b"):
        full = tconfig.get_config(arch)
        assert steps.launch_config(arch, "reduced", torch.device("cpu")) \
            == tconfig.reduced_config(full)
        card = steps.launch_config(arch, "reduced", torch.device("cuda"))
        assert (card.hd, card.d_model, card.n_heads) == (64, 512, 8)
        assert steps.launch_config(arch, "full", torch.device("cuda")) \
            is full
