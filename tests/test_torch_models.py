"""The port's LM serving path (``repro_torch.models``, ``runtime``,
``launch.serve``) against the JAX package on the CPU, at
``reduced_config`` sizes, for the five dense decoders.

The JAX parameters (``init(jax.random.key(0))``) are carried over with
``params_from_jax``; the same tokens, made with numpy from a seed, go
through both packages. On the CPU the port's RMSNorm and flash attention
run their kernels' plain versions (``kernels/ref.py``).

Logits are held to ``rtol = 5e-2`` and ``atol = 5e-2 · max(1,
max|ref|)`` (:func:`_close`): the tolerance ``tests/test_models.py``
gives bf16 decode against forward where the logits are O(1) (the tied
configs, max|logit| ≈ 0.65), scaled with the logits where they are
larger (the untied ones, ≈ 4), since bf16 noise is relative to the
values summed. There the JAX package's own decode and forward differ by
up to 1.22× the unscaled tolerance (internlm2-20b, seed 1), and the
port's prefill differs from JAX's by up to 1.84× it (0.61 of the scaled
one). The scaled bound still catches the faults the two packages could
silently differ by: ``test_prefill_tolerance_catches_planted_faults``
plants a tiled GQA repeat, interleaved RoPE or a dropped qk-norm, each
of which reads 10–19× the scaled bound.

    PYTHONPATH=src python -m pytest -q tests/test_torch_models.py
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as jconfig
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.runtime import serve_loop as jserve

from repro_torch import config as tconfig
from repro_torch.configs import ALL_ARCHS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trk
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import get_model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import Request, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ["granite-3-2b", "qwen3-32b", "internlm2-20b", "starcoder2-15b",
         "internvl2-1b"]
#: the families served since the dense decoders (held against JAX in
#: tests/test_torch_models_families.py)
FAMILIES = ["dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b",
            "xlstm-125m", "seamless-m4t-large-v2"]
TOL = 5e-2

_PAIRS = {}


def _pair(arch, **overrides):
    """(cfg, JAX api, JAX params, port api, port params) for the reduced
    config of ``arch``, built once per module."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        jcfg = jconfig.reduced_config(jconfig.get_config(arch), **overrides)
        cfg = tconfig.reduced_config(tconfig.get_config(arch), **overrides)
        japi = jget_model(jcfg)
        jparams = japi.init(jax.random.key(0))
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        _PAIRS[key] = (cfg, japi, jparams, get_model(cfg),
                       params_from_jax(tree, cfg, device="cpu"))
    return _PAIRS[key]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _atol(ref):
    """5e-2 · max(1, max|ref|), the padded vocab columns (−1e30) left
    out of the scale."""
    ref = np.asarray(ref)
    return TOL * max(1.0, float(np.abs(ref[ref > -1e29]).max()))


def _close(out, ref, what=""):
    """|out − ref| ≤ atol + rtol·|ref| with rtol = 5e-2 and atol = 5e-2 ·
    max(1, max|ref|); returns the share of the tolerance used."""
    out, ref = _f32(out), _f32(ref)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=_atol(ref),
                               err_msg=what)
    return float((np.abs(out - ref) / (_atol(ref) + TOL * np.abs(ref))
                  ).max())


# -- configs ------------------------------------------------------------------

def test_config_copies_match():
    assert tuple(ALL_ARCHS) == tuple(
        __import__("repro.configs", fromlist=["ALL_ARCHS"]).ALL_ARCHS)
    assert tconfig.list_configs() == jconfig.list_configs()
    assert tconfig.SHAPES.keys() == jconfig.SHAPES.keys()
    for name in tconfig.list_configs():
        full = (dataclasses.asdict(tconfig.get_config(name)),
                dataclasses.asdict(jconfig.get_config(name)))
        assert full[0] == full[1], name
        red = (tconfig.reduced_config(tconfig.get_config(name)),
               jconfig.reduced_config(jconfig.get_config(name)))
        assert dataclasses.asdict(red[0]) == dataclasses.asdict(red[1])
        assert red[0].vocab_padded == red[1].vocab_padded


def test_granite_published_size():
    cfg = tconfig.get_config("granite-3-2b")
    shapes = get_model(cfg).param_shapes()
    n = sum(w.numel() for w in shapes.parameters())
    assert all(w.is_meta for w in shapes.parameters())
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_padded) == (40, 2048, 32, 8, 64,
                                                    8192, 49408)
    assert 2.52e9 < n < 2.54e9 and not hasattr(shapes, "unembed")


# -- weights ------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_carries_every_weight(arch):
    cfg, _, jparams, _, tp = _pair(arch)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    state = tp.state_dict()
    np.testing.assert_array_equal(state["embed.table"].numpy(),
                                  tree["embed"]["table"])
    for l in (0, cfg.n_layers - 1):
        np.testing.assert_array_equal(
            state[f"blocks.{l}.mixer.wq.w"].numpy(),
            tree["blocks"][0]["mixer"]["wq"]["w"][l])
        np.testing.assert_array_equal(
            state[f"blocks.{l}.ffn.down.w"].numpy(),
            tree["blocks"][0]["ffn"]["down"]["w"][l])
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))
    assert sum(w.numel() for w in tp.parameters()) == n_jax
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no place"):
        params_from_jax(bad, cfg, device="cpu")


def test_serving_params_cast_once_to_the_same_values():
    cfg, _, _, api, tp = _pair("granite-3-2b")
    sp = api.serving_params(tp)
    assert sp is not tp and api.serving_params(sp) is sp
    assert all(w.dtype == torch.bfloat16 for w in sp.parameters())
    assert all(w.dtype == torch.float32 for w in tp.parameters())
    for (k, a), (_, b) in zip(tp.state_dict().items(),
                              sp.state_dict().items()):
        assert torch.equal(a.to(torch.bfloat16), b), k
    toks = _tokens(cfg, 2, 12, 5)
    # per-use casts of the f32 model and the cast-once model: same bits
    a = api.prefill(tp, {"tokens": toks})
    b = api.prefill(sp, {"tokens": toks})
    assert torch.equal(a, b)
    # the seeded init is the same model each time
    p32 = api.init(7, device="cpu")
    again = api.init(7, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(p32.parameters(), again.parameters()))


# -- prefill, decode, serving against the JAX package -------------------------

def _frontend(cfg, B, seed):
    if not cfg.frontend:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


_PREFILL = {}


def _prefill_case(arch):
    """(batch of numpy arrays, JAX full-sequence logits) for the prefill
    checks of ``arch``: B = 2, S = 24, tokens from seed 1, the frontend
    stub from seed 2; built once per module."""
    if arch not in _PREFILL:
        cfg, _, jparams, _, _ = _pair(arch)
        B, S = 2, 24
        batch = {"tokens": _tokens(cfg, B, S, 1)}
        front = _frontend(cfg, B, 2)
        if front is not None:
            batch["frontend"] = front
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jfull, _ = jax.jit(lambda p, t, f: jtfm.lm_forward(
            p, jconfig.reduced_config(jconfig.get_config(arch)), t,
            frontend=f))(jparams, jb["tokens"], jb.get("frontend"))
        _PREFILL[arch] = (batch, jfull)
    return _PREFILL[arch]


def _port_forward(tp, cfg, batch):
    front = batch.get("frontend")
    return ttfm.lm_forward(tp, cfg, torch.from_numpy(batch["tokens"]),
                           frontend=None if front is None
                           else torch.from_numpy(front))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax(arch):
    """``ModelAPI.prefill`` (last position) and the full-sequence forward
    of both packages on the same tokens (and frontend stub)."""
    cfg, japi, jparams, api, tp = _pair(arch)
    batch, jfull = _prefill_case(arch)
    B, S = batch["tokens"].shape
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tfull, aux = _port_forward(tp, cfg, batch)
    assert tfull.shape == (B, S, cfg.vocab_padded) and float(aux) == 0.0
    used = _close(tfull, jfull)
    out, ref = _f32(tfull), _f32(jfull)
    real = ref > -1e29
    plain = float((np.abs(out - ref) / (TOL + TOL * np.abs(ref)))[real].max())
    print(f"{arch}: prefill uses {used:.2f} of the tolerance, {plain:.2f} "
          f"of rtol = atol = 5e-2")
    last = api.prefill(tp, batch)
    assert last.shape == (B, 1, cfg.vocab_padded)
    _close(last, japi.prefill(jparams, jb))
    assert torch.equal(last, tfull[:, -1:])


# Planted faults: each is one of the silent differences the tolerance has
# to catch. The exact-erf GELU is not among them: it departs from the tanh
# form by less than the bf16 noise on these logits, so
# test_rope_gqa_and_gelu_match_jax holds it, at 1e-5, on its own.

def _tiled_flash(q, k, v, causal):
    """GQA by ``.repeat`` (head h reads KV head h % KV), not h // G."""
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat(1, 1, G, 1), v.repeat(1, 1, G, 1)
    return flash_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal)


def _interleaved_rope(x, positions, theta):
    """RoPE on interleaved pairs (x[2i], x[2i+1]), not split halves."""
    freqs = tlayers.rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float()[..., 0::2], x.float()[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).flatten(-2).to(x.dtype)


FAULTS = ([(a, "gqa_tiled") for a in DENSE]
          + [(a, "rope_interleaved") for a in DENSE]
          + [("qwen3-32b", "qk_norm_dropped")])


@pytest.mark.parametrize("arch,fault", FAULTS,
                         ids=[f"{a}-{f}" for a, f in FAULTS])
def test_prefill_tolerance_catches_planted_faults(arch, fault, monkeypatch):
    """The control of :func:`_close`: the port with one fault planted
    fails it against the JAX logits of test_prefill_matches_jax."""
    cfg, _, _, _, tp = _pair(arch)
    batch, jfull = _prefill_case(arch)
    if fault == "gqa_tiled":
        monkeypatch.setattr(tattn, "_flash", _tiled_flash)
    elif fault == "rope_interleaved":
        monkeypatch.setattr(tattn, "apply_rope", _interleaved_rope)
    else:
        cfg = dataclasses.replace(cfg, qk_norm=False)
    bad, _ = _port_forward(tp, cfg, batch)
    with pytest.raises(AssertionError):
        _close(bad, jfull)
    out, ref = _f32(bad), _f32(jfull)
    reads = float((np.abs(out - ref) / (_atol(ref) + TOL * np.abs(ref))
                   ).max())
    print(f"{arch} {fault}: reads {reads:.1f} of the tolerance")


@pytest.mark.parametrize("arch", DENSE)
def test_teacher_forced_decode_matches_jax(arch):
    """The first S tokens fed to both packages' ``decode_step``: the
    logits agree at every step, and the port's caches hold the JAX
    caches' values."""
    cfg, japi, jparams, api, tp = _pair(arch)
    B, S = 2, 10
    toks = _tokens(cfg, B, S, 3)
    jstep = jax.jit(japi.decode_step)
    jcache = japi.init_cache(B, S)
    tcache = api.init_cache(B, S, device="cpu")
    sp = api.serving_params(tp)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, t]),
                           jnp.asarray(pos), jcache)
        tl, tcache = api.decode_step(sp, torch.from_numpy(toks[:, t]),
                                     torch.from_numpy(pos), tcache)
        assert tl.shape == (B, cfg.vocab_padded)
        _close(tl, jl, f"step {t}")
    for key in ("k", "v"):
        _close(tcache[0][key], jcache[0][key], key)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_teacher_forced_decode(arch):
    """The port's own prefill and decode agree, as
    ``test_decode_matches_forward_dense`` holds the JAX package's."""
    cfg, _, _, api, tp = _pair(arch)
    sp = api.serving_params(tp)
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 4))
    full, _ = ttfm.lm_forward(sp, cfg, toks)
    cache = api.init_cache(B, S + 4, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = api.decode_step(sp, toks[:, t],
                                    torch.full((B,), t), cache)
        outs.append(lg)
    _close(torch.stack(outs, 1), full)


def _recording(eng, per_token):
    """Wrap ``eng._step`` to keep, for each request, the logits row of
    the step that made each of its tokens (a slot whose prompt is still
    being fed makes none)."""
    step = eng._step

    def recording_step(*args):
        logits, cache = step(*args)
        lg = _f32(logits)
        for i, req in enumerate(eng.slots):
            if req is not None and not req._feed:
                per_token.setdefault(req.rid, []).append(lg[i])
        return logits, cache

    eng._step = recording_step


def _serve(engine_cls, request_cls, api, params, slots, max_seq, prompts,
           max_new):
    eng = engine_cls(api, params, batch_slots=slots, max_seq=max_seq)
    rows = {}
    _recording(eng, rows)
    reqs = [request_cls(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=500)
    return reqs, rows


SERVE_CASES = (
    # test_substrate.py::test_serve_engine_continuous_batching, every arch
    [(arch, {}, 2, 32, [[1 + i, 2, 3] for i in range(5)], 4)
     for arch in DENSE]
    # examples/serve_lm.py
    + [("qwen3-32b", dict(vocab=2048, d_model=128, n_layers=4), 4, 64,
        [[1, 5, 9], [2, 4], [3, 3, 3, 3], [7], [11, 13], [17, 19, 23]], 8)])


@pytest.mark.parametrize("arch,overrides,slots,max_seq,prompts,max_new",
                         SERVE_CASES,
                         ids=[f"{c[0]}-{'example' if c[1] else 'batching'}"
                              for c in SERVE_CASES])
def test_serve_engine_matches_jax(arch, overrides, slots, max_seq, prompts,
                                  max_new):
    """The port's ``ServeEngine`` on the JAX engine's requests: every
    request completes with ``max_new`` tokens; each greedy token equals
    the JAX engine's wherever JAX's top-1/top-2 margin exceeds twice the
    tolerance, and the logits that chose it are within the tolerance —
    up to a request's first token that may legitimately differ (its later
    inputs differ from there on)."""
    cfg, japi, jparams, api, tp = _pair(arch, **overrides)
    jreqs, jrows = _serve(jserve.ServeEngine, jserve.Request, japi, jparams,
                          slots, max_seq, prompts, max_new)
    reqs, rows = _serve(ServeEngine, Request, api, tp, slots, max_seq,
                        prompts, max_new)
    past = held = 0
    for r, jr in zip(reqs, jreqs):
        assert r.done and len(r.out) == max_new
        assert jr.done and len(jr.out) == max_new
        assert all(0 <= t < cfg.vocab for t in r.out)
        for j, (a, b) in enumerate(zip(r.out, jr.out)):
            ref = jrows[r.rid][j]
            _close(rows[r.rid][j], ref, f"request {r.rid} token {j}")
            held += 1
            top2 = np.sort(ref)[-2:]
            tol = _atol(ref) + TOL * abs(top2[1])
            if top2[1] - top2[0] > 2 * tol:
                assert a == b, (r.rid, j, r.out, jr.out)
                past += 1
            elif a != b:
                break
    print(f"{arch}: logits held at {held} of {len(reqs) * max_new} tokens;"
          f" {past} past the margin, all equal")
    assert held >= len(reqs) and len(rows) == len(reqs)


# -- RMSNorm rounding ---------------------------------------------------------

def _ulps(out, ref):
    a = np.maximum(np.abs(out), np.abs(ref))
    spacing = 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7)
    return np.abs(out - ref) / spacing


@pytest.mark.parametrize("d", [16, 64, 2048])
@pytest.mark.parametrize("scale,ulps", [("ones", 1), ("random", 2)])
def test_rmsnorm_rounding_bound(d, scale, ulps):
    """The port's RMSNorm (one rounding, in f32) against
    ``repro.models.layers.rmsnorm`` (bf16 rounding of rsqrt, of x·rsqrt
    and of the product with the scale) on bf16 rows: at most one bf16 ulp
    per element with a scale of ones (every norm at init), two with a
    general bf16 scale, where the JAX function's third rounding adds its
    half ulp."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((256, d)).astype(np.float32)
    s = (np.ones(d, np.float32) if scale == "ones" else
         (1 + 0.5 * rng.standard_normal(d)).astype(np.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(s)}, xj),
                     np.float32)
    p = tlayers.RMSNorm(d, torch.float32)
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(s))
    out = tlayers.rmsnorm(p, torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    du = _ulps(_f32(out), ref)
    assert du.max() <= ulps, du.max()
    if scale == "random":
        assert du.max() > 1          # the bound is met, not loose


def test_rope_gqa_and_gelu_match_jax():
    """The three places where the packages could silently differ: RoPE
    (split halves, f32), the GQA repeat (head h reads KV head h // G) and
    the tanh-approximate GELU."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(6), (2, 1))
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e4).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e4)), rtol=1e-5, atol=1e-5)
    kv = rng.standard_normal((1, 8, 2, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(kv).repeat_interleave(3, dim=2).numpy(),
        np.asarray(jnp.repeat(jnp.asarray(kv), 3, axis=2)))
    y = rng.standard_normal(1000).astype(np.float32) * 4
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(y),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(y))), rtol=1e-5, atol=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 64, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = float(jlayers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(tlayers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-5 * abs(want)


def test_vocab_padding_never_wins():
    cfg, _, _, api, tp = _pair("granite-3-2b")
    cfg2 = dataclasses.replace(cfg, vocab=500)        # 12 padded columns
    api2 = get_model(cfg2)
    p = api2.serving_params(api2.init(3, device="cpu"))
    with torch.no_grad():                  # make the padded rows win
        p.embed.table[500:] = 50.0
    lg, _ = ttfm.lm_forward(p, cfg2, torch.zeros(1, 4, dtype=torch.long))
    assert (lg[..., 500:] == -1e30).all()
    assert int(lg.argmax(-1).max()) < 500


def test_plain_route_switch_is_off_by_default():
    cfg, _, _, api, tp = _pair("granite-3-2b")
    assert not tlayers.plain_route()
    with tlayers.plain_kernels():
        assert tlayers.plain_route()
    assert not tlayers.plain_route()
    # on the CPU both routes are the plain versions: the same bits
    toks = torch.from_numpy(_tokens(cfg, 1, 8, 6))
    a, _ = ttfm.lm_forward(tp, cfg, toks)
    with tlayers.plain_kernels():
        b, _ = ttfm.lm_forward(tp, cfg, toks)
    assert torch.equal(a, b)


def test_kernel_counts_unmoved_on_the_cpu():
    """On CPU tensors the wrappers take their plain versions: no launch
    is counted."""
    cfg, _, _, api, tp = _pair("granite-3-2b")
    trk.launches = tfa.launches = 0
    api.prefill(tp, {"tokens": _tokens(cfg, 1, 8, 7)})
    assert trk.launches == 0 and tfa.launches == 0


# -- every family builds; the loss still raises ------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_unported_kinds_raise(arch):
    """Named when these kinds raised ``NotImplementedError``; each family
    is ported now, so ``init``, ``param_shapes`` and ``cache_spec``
    succeed, with the JAX package's parameter count and cache spec."""
    cfg = tconfig.reduced_config(tconfig.get_config(arch))
    api = get_model(cfg)
    p = api.init(0, device="cpu")
    shapes = api.param_shapes()
    assert all(w.is_meta for w in shapes.parameters())
    assert [(k, w.shape) for k, w in p.named_parameters()] == [
        (k, w.shape) for k, w in shapes.named_parameters()]
    jcfg = jconfig.reduced_config(jconfig.get_config(arch))
    jshapes = jget_model(jcfg).param_shapes()
    assert sum(w.numel() for w in p.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jshapes))
    assert api.cache_spec(2, 8) == jget_model(jcfg).cache_spec(2, 8)


def test_loss_and_cross_attention_raise():
    """The loss still raises, naming the training slice; cross-attention
    (``kv_override``), which raised before the enc-dec slice, now runs
    (``tests/test_torch_models_families.py`` holds it against JAX)."""
    cfg, _, _, api, tp = _pair("granite-3-2b")
    with pytest.raises(NotImplementedError, match="training"):
        api.loss(tp, {})
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    kv = torch.zeros(1, 6, cfg.n_kv_heads, cfg.hd, dtype=torch.bfloat16)
    out = tattn.attention(tp.blocks[0].mixer, cfg, x,
                          torch.arange(4)[None], kv_override=(kv, kv))
    assert out.shape == x.shape


# -- entry points -------------------------------------------------------------

def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_launcher_and_example_on_the_cpu():
    r = _run("-m", "repro_torch.launch.serve", "--arch", "granite-3-2b",
             "--device", "cpu", "--requests", "3", "--max-new", "4")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "completed 3/3 requests, 12 tokens generated" in r.stdout
    r = _run("-m", "repro_torch.examples.serve_lm", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("-> [") == 6
    r = _run("-m", "repro_torch.launch.serve", "--arch", "granite-3-2b",
             "--device", "cpu", "--mesh", "2x4")
    assert r.returncode != 0 and "NotImplementedError" in r.stderr


def test_lm_stack_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.models, repro_torch.models.convert\n"
            "import repro_torch.runtime, repro_torch.launch.serve\n"
            "import repro_torch.examples.serve_lm, repro_torch.config\n"
            "import repro_torch.configs\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    r = _run("-c", code)
    assert r.returncode == 0, r.stderr[-3000:]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    api = get_model(tconfig.reduced_config(tconfig.get_config(
        "granite-3-2b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(2, 8)
