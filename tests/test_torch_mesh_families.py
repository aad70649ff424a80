"""The port's sharded steps for the recurrent and encoder-decoder families
— jamba-1.5-large-398b (mamba, attention and MoE blocks), xlstm-125m
(mLSTM and sLSTM blocks) and seamless-m4t-large-v2 (encoder, decoder,
cross-attention) — on the CPU.

**Against the JAX package.** On 8 gloo ranks and a 2×4 (data × model)
mesh, each arch's sharded train step, gradients, prefill and decode at
``reduced_config`` are held to the JAX package's jitted sharded steps on
8 host devices (a 2×4 mesh of ``AxisType.Auto`` axes), from the same
JAX-drawn parameters and the pipeline's batch 0 (B = 2, S = 24; seamless
with 24 encoder frames; the JAX gradients read off the JAX step's first
moment, which from zero is 0.1 × the gradient clipped to norm 1, in bf16
for jamba): the loss to 5e-3 and each gradient leaf and the
gradient norm to 0.15 relative (jamba 0.30 and 0.025, the bounds of
``tests/test_torch_train.py``), logits to rtol 5e-2 and atol 5e-2 ·
max(1, max|ref|) (``tests/test_torch_models.py``), jamba's decode to 3
of that tolerance (its free-running bound in
``tests/test_torch_models_families.py``). One JAX subprocess runs the
three archs; jamba's MoE groups its tokens by the mesh's two data groups
on both sides.

**Against the port's one-process step**, which runs the same functions
on whole tensors (jamba under a policy with the same ``data_groups``):
the loss to 1e-5, the gradient norm to 1e-3 relative, logits to 1e-3 ·
max(1, max|ref|) — fifty times tighter than the JAX bound — and each
gradient leaf to 0.03 relative, five times tighter: a weight used in
bf16 is gathered in bf16, so its gradient's sum over the ranks is
rounded to bf16 a few times (up to 8.5e-3 read here) where one process
rounds once.

**Planted faults.** Each must fail a bound above: the xLSTM input-gate
stabiliser taken per rank (each rank's own rows' max, not the whole
batch's, as a ``local_map`` would give it) and jamba's decode states not
written back into the cache.

**Serving.** ``ServeEngine(mesh=)`` on jamba and xlstm-125m makes the
one-process engine's tokens for five requests on two slots (slots reused
with their stale recurrent state, as the reference serves them).

**Launcher.** ``launch.train --arch xlstm-125m --mesh 1x2 --device cpu
--scale reduced`` exits 0 over two gloo ranks.

The JAX subprocess, the eight ranks and the launcher start together in
one module fixture.

    PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_families.py
"""
import contextlib
import os
import subprocess
import sys
import types

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
from repro_torch.models import encdec as tenc
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.models.sharding_hooks import sharding_policy
from repro_torch.optim import adamw_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("jamba-1.5-large-398b", "xlstm-125m", "seamless-m4t-large-v2")
#: the archs served on the mesh (the enc-dec is not served, as in JAX)
SERVED = ARCHS[:2]
B, S, DECODE = 2, 24, 4
LOSS_TOL, GRAD_TOL, TOL = 5e-3, 0.15, 5e-2
#: jamba's bounds in tests/test_torch_train.py (gradients, loss) and
#: tests/test_torch_models_families.py (free-running decode), as factors
NOISY_GRAD = {"jamba-1.5-large-398b": 2.0}
NOISY_LOSS = {"jamba-1.5-large-398b": 5.0}
NOISY_DECODE = {"jamba-1.5-large-398b": 3.0}
#: the bounds against the port's own one-process step
OWN_LOSS, OWN_REL, OWN_GRAD = 1e-5, 1e-3, 0.03

_JAX = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import config
from repro.data.pipeline import SyntheticTokens
from repro.launch import steps
from repro.models import get_model
from repro.models import encdec
from repro.optim import adamw_init
from repro.models import moe
MOE_FFN = moe.moe_ffn


def recording(routes, step):
    # moe_ffn handing each call's f32 input and router weight to the host
    # (tagged by decode step and layer), its result unchanged
    layer = [0]

    def wrapped(p, c, x):
        tag = layer[0]
        layer[0] += 1
        jax.debug.callback(
            lambda x, w: routes.append((step[0], tag, np.asarray(x),
                                        np.asarray(w))),
            x.astype(jnp.float32), p["router"]["w"])
        return MOE_FFN(p, c, x)
    return wrapped


B, S, DECODE = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[5:]:
    cfg = config.reduced_config(config.get_config(arch))
    api = get_model(cfg)
    params = api.init(jax.random.key(0))
    raw = SyntheticTokens(vocab=cfg.vocab, seq_len=S, global_batch=B,
                          frontend_tokens=S if cfg.enc_layers else 0,
                          d_model=cfg.d_model).batch_at(0)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    shape = config.ShapeConfig("t", S, B, "train")
    fn, _, ins, outs = steps.build_train_step(cfg, shape, mesh)
    state = (jnp.bfloat16 if cfg.param_dtype == "bfloat16"
             else jnp.float32)
    with mesh:
        _, opt, loss, mx = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
            params, adamw_init(params, state), batch, jnp.asarray(0))
        pf, _, pins, pouts = steps.build_prefill_step(cfg, shape, mesh)
        logits = jax.jit(pf, in_shardings=pins, out_shardings=pouts)(
            params, batch)
        dshape = config.ShapeConfig("d", S, B, "decode")
        df, _, dins, douts = steps.build_decode_step(cfg, dshape, mesh)
        routes, step = [], [0]
        moe.moe_ffn = recording(routes, step) if cfg.n_experts else MOE_FFN
        dstep = jax.jit(df, in_shardings=dins, out_shardings=douts)
        cache = (encdec.encdec_init_cache(params, cfg, batch["frontend"], S)
                 if cfg.enc_layers else api.init_cache(B, S))
        cache = jax.device_put(cache, dins[3])
        dec = []
        for t in range(DECODE):
            step[0] = t
            lg, cache = dstep(params, batch["tokens"][:, t],
                              jnp.full((B,), t, jnp.int32), cache)
            dec.append(np.asarray(lg, np.float32))
            jax.effects_barrier()
        moe.moe_ffn = MOE_FFN
    routes.sort(key=lambda r: r[:2])
    for i, (_, _, x, w) in enumerate(routes):
        out[arch + f"/route_x{i}"], out[arch + f"/route_w{i}"] = x, w
    out[arch + "/loss"] = np.asarray(loss)
    out[arch + "/grad_norm"] = np.asarray(mx["grad_norm"])
    out[arch + "/prefill"] = np.asarray(logits, np.float32)
    out[arch + "/decode"] = np.stack(dec)
    # the step's first moment from zero is (1 - b1) * the clipped gradient
    scale = min(1.0, 1.0 / max(float(mx["grad_norm"]), 1e-9))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(opt.m)):
        out[arch + f"/g{i}"] = np.asarray(leaf, np.float32) / (0.1 * scale)
np.savez(sys.argv[1], **out)
"""


def _cfg(arch):
    return tconfig.reduced_config(tconfig.get_config(arch))


def _jax_params(arch):
    """The JAX init at key 0 (what the subprocess draws) as numpy."""
    cfg = jconfig.reduced_config(jconfig.get_config(arch))
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(np.float32) if x.dtype.name
                             == "bfloat16" else x),
        jget_model(cfg).init(jax.random.key(0)))


def _batch(cfg):
    return SyntheticTokens(
        vocab=cfg.vocab, seq_len=S, global_batch=B,
        frontend_tokens=S if cfg.enc_layers else 0,
        d_model=cfg.d_model).batch_at(0)


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
        .detach().float().numpy()


@contextlib.contextmanager
def _grads_into(seen):
    """Record into ``seen`` the gradients ``build_train_step`` hands to
    AdamW."""
    update = steps.adamw_update

    def recording(params, grads, state, lr):
        seen.update({k: _full(g) for k, g in grads.items()})
        return update(params, grads, state, lr)

    steps.adamw_update = recording
    try:
        yield seen
    finally:
        steps.adamw_update = update


def _run(cfg, tree, mesh, train=True, prefill=True):
    """One sharded train step (and the gradients it hands to AdamW), the
    prefill and ``DECODE`` decode steps of ``cfg`` from ``tree``."""
    api = get_model(cfg)
    batch = _batch(cfg)
    out = {}
    if train:
        p = steps.shard_params(api.train_params(params_from_jax(
            tree, cfg, "cpu")), cfg, mesh)
        opt = adamw_init(p, state_dtype=steps.state_dtype_of(cfg))
        with _grads_into({}) as seen:
            _, _, loss, mx = steps.build_train_step(cfg, None, mesh=mesh)(
                p, opt, batch, 0)
        out.update(loss=float(loss), grad_norm=float(mx["grad_norm"]),
                   grads=seen)
    served = steps.shard_params(api.serving_params(
        params_from_jax(tree, cfg, "cpu")), cfg, mesh)
    if prefill:
        out["prefill"] = steps.build_prefill_step(cfg, None, mesh=mesh)(
            served, batch).float().numpy()
    if cfg.enc_layers:
        with steps.sharded_context(mesh):
            cache = tenc.encdec_init_cache(served, cfg, batch["frontend"], S)
    else:
        cache = api.init_cache(B, S, device="cpu")
    cache = steps.shard_cache(cache, mesh)
    dec = steps.build_decode_step(cfg, None, mesh=mesh)
    logits = []
    with tmoe.RouteLog() as routes:
        for t in range(DECODE):
            lg, cache = dec(served, batch["tokens"][:, t],
                            np.full(B, t, np.int32), cache)
            logits.append(lg.float().numpy())
    out["decode"] = np.stack(logits)
    out["routes"] = [(r.probs.numpy(), r.ids.numpy(), r.keep.numpy())
                     for r in routes.calls]
    return out


#: served requests: 5 on 2 slots of a 16-token cache, so slots are reused
#: (each keeping the recurrent state its last request left, as in JAX)
SERVE = dict(slots=2, max_seq=16, requests=5, max_new=6)


def _serve(cfg, tree, mesh=None):
    """The tokens ``ServeEngine`` makes for :data:`SERVE`'s requests."""
    from repro_torch.runtime import Request, ServeEngine
    api = get_model(cfg)
    eng = ServeEngine(api, params_from_jax(tree, cfg, "cpu"),
                      batch_slots=SERVE["slots"], max_seq=SERVE["max_seq"],
                      mesh=mesh)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 3).tolist(),
                    max_new=SERVE["max_new"])
            for i in range(SERVE["requests"])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


def _per_rank_gates(p, cfg, x):
    """``xlstm._gates`` with the input-gate stabiliser taken over this
    rank's rows only (the planted fault)."""
    from torch.distributed.tensor import DTensor, Replicate
    q, k, v, _, log_f = _TRUE_GATES(p, cfg, x)
    i_raw = txlstm.linear(p.wi, x).to(torch.float32)
    mesh = i_raw.device_mesh
    m = DTensor.from_local(i_raw.to_local().max().detach(), mesh,
                           (Replicate(),) * mesh.ndim, run_check=False)
    return q, k, v, i_raw - m, log_f


_TRUE_GATES = txlstm._gates


def _unwritten(fn, state, *xs, ws=()):
    """``layers.stepwise`` that writes its new states into a copy (the
    planted fault): the cache keeps the states it had."""
    from repro_torch.models import layers
    y, _ = layers.stepwise(fn, {k: v.clone() for k, v in state.items()},
                           *xs, ws=ws)
    return y, state


def _ranked(rank, trees):
    """One rank: each arch's sharded steps, then the planted faults."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import mamba
    torch.set_num_threads(1)            # eight ranks share the host
    mesh = make_test_mesh((2, 4))
    out = {arch: _run(_cfg(arch), tree, mesh)
           for arch, tree in trees.items()}
    for arch in SERVED:
        out[arch]["served"] = _serve(_cfg(arch), trees[arch], mesh)
    txlstm._gates = _per_rank_gates
    out["fault/per_rank_max"] = _run(_cfg("xlstm-125m"), trees["xlstm-125m"],
                                     mesh, prefill=False)
    txlstm._gates = _TRUE_GATES
    mamba.stepwise = _unwritten
    out["fault/unwritten"] = _run(_cfg("jamba-1.5-large-398b"),
                                  trees["jamba-1.5-large-398b"], mesh,
                                  train=False, prefill=False)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the eight ranks and the launcher, at once."""
    d = tmp_path_factory.mktemp("mesh_families")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jproc = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(d / "jax.npz"), str(B), str(S),
         str(DECODE), *ARCHS], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xlstm-125m", "--mesh", "1x2", "--device", "cpu", "--scale",
         "reduced", "--steps", "2", "--batch", "2", "--seq", "32", "--ckpt",
         str(d / "ckpt")], env=dict(env, XLA_FLAGS=""), cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs = [jproc, launcher]
    try:
        trees = {a: _jax_params(a) for a in ARCHS}
        ranked = p2p.spawn(_ranked, 8, trees, timeout=600)
        own = {a: _unsharded(a, trees[a]) for a in ARCHS}
        launched = launcher.communicate(timeout=600) + (launcher.returncode,)
        jout, jerr = jproc.communicate(timeout=600)
        assert jproc.returncode == 0, jout + jerr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = dict(np.load(d / "jax.npz"))
    return {"ranked": ranked[0], "jax": ref, "trees": trees, "own": own,
            "launcher": launched}


def _unsharded(arch, tree):
    """The port's one-process step, prefill and decode (jamba under a
    policy whose only fact is the mesh's ``data_groups``)."""
    cfg = _cfg(arch)
    api = get_model(cfg)
    pol = lambda name, x: None                      # noqa: E731
    pol.info = {"data_groups": 2}
    batch = _batch(cfg)
    with sharding_policy(pol):
        p = api.train_params(params_from_jax(tree, cfg, device="cpu"))
        opt = adamw_init(p, state_dtype=steps.state_dtype_of(cfg))
        with _grads_into({}) as grads:
            _, _, loss, mx = steps.build_train_step(cfg, None, "cpu")(
                p, opt, batch, 0)
        tokens = _serve(cfg, tree) if arch in SERVED else None
        served = api.serving_params(params_from_jax(tree, cfg, "cpu"))
        pre = api.prefill(served, batch)
        cache = (tenc.encdec_init_cache(served, cfg, batch["frontend"], S)
                 if cfg.enc_layers else api.init_cache(B, S, device="cpu"))
        dec = []
        for t in range(DECODE):
            lg, cache = api.decode_step(served, batch["tokens"][:, t],
                                        np.full(B, t, np.int32), cache)
            dec.append(lg.float().numpy())
    return {"loss": float(loss), "grad_norm": float(mx["grad_norm"]),
            "grads": grads, "served": tokens,
            "prefill": pre.float().numpy(), "decode": np.stack(dec)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _reads(got, ref):
    """The share of rtol 5e-2 + atol 5e-2·max(1, max|ref|) that ``got``
    uses against ``ref`` (the padded vocab columns at −1e30 left out)."""
    real = ref > -1e29
    atol = TOL * max(1.0, float(np.abs(ref[real]).max()))
    return float((np.abs(got - ref) / (atol + TOL * np.abs(ref)))[real].max())


def _own_reads(got, ref):
    """max|Δ| of logits over 1e-3·max(1, max|ref|)."""
    real = ref > -1e29
    scale = OWN_REL * max(1.0, float(np.abs(ref[real]).max()))
    return float(np.abs(got - ref)[real].max() / scale)


def _jax_grads(runs, arch, ref):
    leaves, tree = jax.tree_util.tree_flatten(runs["trees"][arch])
    return named_from_jax(jax.tree_util.tree_unflatten(
        tree, [ref[arch + f"/g{i}"] for i in range(len(leaves))]), _cfg(arch))


def _train_reads(got, runs, arch):
    """(|Δloss| / its bound, worst leaf / its bound, its name) against
    the JAX package."""
    ref = runs["jax"]
    dl = abs(got["loss"] - float(ref[arch + "/loss"]))
    jg = _jax_grads(runs, arch, ref)
    worst = {k: _rel(g, jg[k]) for k, g in got["grads"].items()}
    k = max(worst, key=worst.get)
    return (dl / (NOISY_LOSS.get(arch, 1.0) * LOSS_TOL),
            worst[k] / (NOISY_GRAD.get(arch, 1.0) * GRAD_TOL), k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax(runs, arch):
    got, ref = runs["ranked"][arch], runs["jax"]
    loss_used, leaf_used, leaf = _train_reads(got, runs, arch)
    norm = abs(got["grad_norm"] / float(ref[arch + "/grad_norm"]) - 1)
    print(f"{arch}: |Δloss| uses {loss_used:.3f} of its bound, worst "
          f"gradient leaf {leaf} {leaf_used:.3f}, grad norm {norm:.2e}")
    assert loss_used <= 1.0
    assert leaf_used <= 1.0, (leaf, leaf_used)
    assert norm <= NOISY_GRAD.get(arch, 1.0) * GRAD_TOL


def _held(runs, arch):
    """(DECODE, B) rows of the decode no MoE routing flip reached: a slot
    from the step a near-tie flip (``moe.route_flips``, as
    ``tests/test_torch_models_families.py`` holds decode) on."""
    cfg, ref = _cfg(arch), runs["jax"]
    held = np.ones((DECODE, B), bool)
    if not cfg.n_experts:
        return held
    pol = lambda name, x: None                      # noqa: E731
    pol.info = {"data_groups": 2}
    jax_routes = []
    with sharding_policy(pol):
        for i in range(DECODE * _moe_layers(cfg)):
            p = types.SimpleNamespace(router=types.SimpleNamespace(
                w=torch.from_numpy(ref[arch + f"/route_w{i}"])))
            jax_routes.append(tmoe.moe_route(p, cfg, torch.from_numpy(
                ref[arch + f"/route_x{i}"])))
    got = [tmoe.RouteRows(*(torch.from_numpy(a) for a in r))
           for r in runs["ranked"][arch]["routes"]]
    flips = tmoe.route_flips(got, jax_routes, 1, f"{arch} sharded decode")
    for slot, c in flips.items():
        held[c // _moe_layers(cfg):, slot] = False
    return held


def _moe_layers(cfg):
    return sum(k.endswith("moe") for k in ttfm.layer_kinds(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_jax(runs, arch):
    got, ref = runs["ranked"][arch], runs["jax"]
    pre = _reads(got["prefill"], ref[arch + "/prefill"])
    assert got["decode"].shape == ref[arch + "/decode"].shape
    held = _held(runs, arch)
    assert held.sum() >= held.size // 2
    dec = _reads(got["decode"][held], ref[arch + "/decode"][held])
    print(f"{arch}: prefill uses {pre:.3f}, decode {dec:.3f} of the "
          f"tolerance on {held.sum()} of {held.size} rows")
    assert pre <= 1.0
    assert dec <= NOISY_DECODE.get(arch, 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_one_process_step(runs, arch):
    got, own = runs["ranked"][arch], runs["own"][arch]
    dl = abs(got["loss"] - own["loss"])
    norm = abs(got["grad_norm"] / own["grad_norm"] - 1)
    rel = {k: _rel(g, own["grads"][k]) for k, g in got["grads"].items()}
    leaf = max(rel, key=rel.get)
    pre = _own_reads(got["prefill"], own["prefill"])
    dec = _own_reads(got["decode"], own["decode"])
    print(f"{arch} against one process: |Δloss| {dl:.1e}, grad norm "
          f"{norm:.1e}, worst leaf {leaf} {rel[leaf]:.1e}, logits "
          f"{pre:.3f} / {dec:.3f} of 1e-3·max(1, max|ref|)")
    assert dl <= OWN_LOSS
    assert norm <= OWN_REL and rel[leaf] <= OWN_GRAD
    assert pre <= 1.0 and dec <= 1.0


@pytest.mark.parametrize("arch", SERVED)
def test_serve_engine_on_the_mesh(runs, arch):
    """``ServeEngine(mesh=)`` makes the one-process engine's tokens, slots
    reused with their stale recurrent state as the reference keeps it."""
    got = runs["ranked"][arch]["served"]
    assert got == runs["own"][arch]["served"]
    assert [len(t) for t in got] == [SERVE["max_new"]] * SERVE["requests"]


def test_per_rank_stabiliser_fails_the_bounds(runs):
    """Each rank's own max in place of the whole batch's shifts the input
    gates of the rows whose max it is not: the step and the logits leave
    the one-process bound, and the decode leaves the JAX bound."""
    bad, own = runs["ranked"]["fault/per_rank_max"], runs["own"]["xlstm-125m"]
    ref = runs["jax"]
    dec = _reads(bad["decode"], ref["xlstm-125m/decode"])
    worst = max(_rel(g, own["grads"][k]) for k, g in bad["grads"].items())
    own_dec = _own_reads(bad["decode"], own["decode"])
    print(f"per-rank stabiliser: decode reads {dec:.2f} of the JAX "
          f"tolerance; against one process the worst leaf {worst:.2e}, "
          f"the decode {own_dec:.1f} of its bound")
    assert dec > 1.0
    assert worst > OWN_GRAD and own_dec > 1.0


def test_unwritten_state_fails_the_bound(runs):
    """jamba's mamba states left out of the cache: the first decode step
    (which reads the zero states either way) is the sound run's, every
    later one departs from it past the free-running bound."""
    arch = "jamba-1.5-large-398b"
    bad, good = runs["ranked"]["fault/unwritten"], runs["ranked"][arch]
    assert np.array_equal(bad["decode"][0], good["decode"][0])
    later = _reads(bad["decode"][1:], good["decode"][1:])
    print(f"unwritten states: the later steps read {later:.1f} of the "
          "tolerance")
    assert later > NOISY_DECODE[arch]


def test_mesh_launcher_trains_xlstm(runs):
    out, err, rc = runs["launcher"]
    assert rc == 0, err[-3000:]
    assert "mesh 1x2: 2 gloo ranks" in out
    assert out.strip().splitlines()[-1].startswith(
        "[train] done: final step 2, last loss ")


def test_shard_params_frees_each_replaced_parameter(monkeypatch):
    """``shard_params`` lets go of each whole parameter once its DTensor
    replaces it: when a parameter is laid out, no parameter replaced
    before it is still alive (holding them all took twice the model —
    jamba's 32 GB — and ran the card out of memory)."""
    import weakref
    cfg = _cfg("jamba-1.5-large-398b")
    params = get_model(cfg).init(0, device="cpu")
    refs = {k: weakref.ref(w) for k, w in params.named_parameters()}
    done, alive = [], []

    def distribute(t, mesh, spec):
        alive.append(sum(refs[k]() is not None for k in done))
        done.append(next(k for k, r in refs.items()
                         if r() is not None and r().data_ptr()
                         == t.data_ptr() and k not in done))
        return t.clone()

    monkeypatch.setattr(steps, "_distribute", distribute)
    steps.shard_params(params, cfg, types.SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 1)))
    assert len(done) == len(refs) and not any(alive), alive

