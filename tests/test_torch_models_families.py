"""The port's LM serving path for the MoE (dbrx-132b, grok-1-314b), hybrid
mamba/attention (jamba-1.5-large-398b), xLSTM (xlstm-125m) and
encoder-decoder (seamless-m4t-large-v2) families against the JAX package
on the CPU, at ``reduced_config`` sizes, in-process.

The JAX parameters (``init(jax.random.key(0))``) are carried over with
``params_from_jax``; the inputs are made with numpy from a seed. Logits
are held to the tolerance of ``tests/test_torch_models.py``: rtol 5e-2
and atol 5e-2 · max(1, max|ref|).

**MoE routing near-ties.** The two packages' bf16 activations differ by
an ulp or two (the RMSNorm kernel rounds once, JAX three times), so a
token whose k-th and (k+1)-th router probabilities are closer than that
noise may pick another expert in each package, and since capacity is
counted in token order, a flip can move another token's drop. Such a
token's logits differ by far more than the tolerance. The model-level
MoE checks therefore record every routing of both packages (the JAX
one through ``jax.debug.callback`` in a wrapper of
``repro.models.moe.moe_ffn`` that returns its result unchanged) and
exclude only the rows such a flip reaches (``moe.route_flips``) —
after showing, for each flip, that the expert sets differ and that
JAX's k-th/(k+1)-th margin is below twice the router-probability noise,
the largest difference between the packages over every row and layer
no flip has reached — as ``test_serve_engine_matches_jax`` excludes
near-tied logits. A kept-set change with no flip in its layer fails.

**jamba's free-running noise.** Through jamba's eight mamba, attention
and MoE layers the bf16 noise outgrows the tolerance even within the
JAX package: its own decode reads up to 1.30 tolerances against its own
forward, and the port against the JAX package reads up to 1.82
free-running. Those readings, and the cache states, are held to 3
tolerances (:data:`NOISY`), far below the 16.9 of the smallest planted
fault; each block on the JAX package's own input (the layer-forced
checks) is held to the tolerance itself.

**xLSTM's stabiliser.** The input gate is stabilised by its max over the
whole tensor (``repro/models/xlstm.py:104``), which differs between a
prefill and a decode step, so the JAX package's own teacher-forced
decode does not reproduce its forward: at this file's reduced
xlstm-125m (B = 2, S = 12, seed 4) it departs by 13.37 of the
tolerance. The port's own decode is held to the JAX gap (× 1.1, the
margin measured for the port against JAX's decode, 0.40, being far
smaller); the sLSTM-only stack, whose running-max stabiliser is exact,
is held to the plain tolerance.

    PYTHONPATH=src python -m pytest -q tests/test_torch_models_families.py
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro import config as jconfig
from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models import xlstm as jxlstm
from repro.runtime import serve_loop as jserve

from repro_torch import config as tconfig
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tenc
from repro_torch.models import get_model
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import Request, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b",
            "xlstm-125m", "seamless-m4t-large-v2"]
MOE = ["dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b"]
DECODERS = FAMILIES[:4]
TOL = 5e-2
#: families whose free-running logits carry more bf16 noise than the
#: tolerance even within the JAX package (its own decode against its own
#: forward), with the bound, in tolerances, their free-running readings
#: and cache states are held to (see the module note); their layer-forced
#: readings are held to the tolerance itself
NOISY = {"jamba-1.5-large-398b": 3.0}
#: the JAX package's own decode-vs-forward gap at reduced xlstm-125m,
#: in units of the tolerance (B = 2, S = 12, tokens from seed 4)
XLSTM_JAX_GAP = 13.37

_PAIRS = {}


def _cfgs(arch, **overrides):
    return (jconfig.reduced_config(jconfig.get_config(arch), **overrides),
            tconfig.reduced_config(tconfig.get_config(arch), **overrides))


def _pair(arch, **overrides):
    """(JAX cfg, port cfg, JAX api, JAX params, port api, port serving
    params) for the reduced config of ``arch``, built once per module."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        jcfg, cfg = _cfgs(arch, **overrides)
        japi = jget_model(jcfg)
        jparams = japi.init(jax.random.key(0))
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        api = get_model(cfg)
        tp = params_from_jax(tree, cfg, device="cpu")
        _PAIRS[key] = (jcfg, cfg, japi, jparams, api, api.serving_params(tp))
    return _PAIRS[key]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _frames(cfg, B, seed, S_enc=8):
    return np.random.default_rng(seed).standard_normal(
        (B, S_enc, cfg.d_model)).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _atol(ref):
    ref = np.asarray(ref)
    return TOL * max(1.0, float(np.abs(ref[ref > -1e29]).max()))


def _reads(out, ref, rows=None):
    """The share of rtol 5e-2 + atol 5e-2·max(1, max|ref|) that ``out``
    uses against ``ref`` (padded vocab columns at −1e30 left out), over
    the rows where ``rows`` (a bool array of the leading shape) holds."""
    out, ref = _f32(out), _f32(ref)
    if rows is not None:
        out, ref = out[rows], ref[rows]
    real = ref > -1e29
    return float((np.abs(out - ref) / (_atol(ref) + TOL * np.abs(ref))
                  )[real].max())


def _close(out, ref, what="", rows=None):
    used = _reads(out, ref, rows)
    assert used <= 1.0, f"{what}: uses {used:.2f}× the tolerance"
    return used


# -- routing records ----------------------------------------------------------

#: where the JAX recorder's callbacks write now: (RouteLog, port cfg) —
#: a jitted trace keeps the callback it was traced with
_SINK = []


def _record_jax(monkeypatch, cfg):
    """Record every routing of the JAX package's MoE layers from here on
    (``moe_ffn`` wrapped; its result is returned unchanged), each routed
    again by the port's ``moe_route`` from the f32 input and router
    weight the JAX layer saw."""
    routes = tmoe.RouteLog()
    _SINK[:] = [(routes, cfg)]
    orig = jmoe.moe_ffn

    def cb(x, w):
        log, c = _SINK[0]
        p = types.SimpleNamespace(router=types.SimpleNamespace(
            w=torch.tensor(np.asarray(w, np.float32))))
        log.calls.append(tmoe.moe_route(p, c, torch.tensor(
            np.asarray(x, np.float32))))

    def recording(p, c, x):
        jax.debug.callback(cb, x.astype(jnp.float32), p["router"]["w"],
                           ordered=True)
        return orig(p, c, x)

    monkeypatch.setattr(jmoe, "moe_ffn", recording)
    return routes


def _record_port(monkeypatch):
    """Record every routing of the port's MoE layers from here on."""
    routes = tmoe.RouteLog()
    monkeypatch.setattr(tmoe, "_LOGS", [routes])
    return routes


def _rows(probs, k):
    """A routing of rows (T, E) of probabilities: top-k, nothing dropped."""
    p = torch.tensor(probs, dtype=torch.float32)
    ids = p.topk(k, -1).indices
    return tmoe.RouteRows(p, ids, torch.ones_like(ids, dtype=torch.bool))


def test_route_flips_reach_and_near_tie_rule():
    """``moe.route_flips`` on hand-made routings: two sequences of 4 rows,
    two calls, k = 1 of 3 experts, a noise of 0.006 on the other rows.
    Near-tie flips at rows 1 and 2 of call 0 pass and reach row 3 from
    call 1 on, where any flip is excused; a flip whose margin is far above
    the noise of the rows no flip reached raises, unless the row is known
    to differ; k = E has no flip."""
    base = [[0.60, 0.30, 0.10], [0.50, 0.49, 0.01], [0.45, 0.44, 0.11],
            [0.70, 0.20, 0.10], [0.20, 0.70, 0.10], [0.30, 0.60, 0.10],
            [0.10, 0.50, 0.40], [0.80, 0.10, 0.10]]
    quiet = [[r[0] + 0.006 * (i % 2)] + r[1:] for i, r in enumerate(base)]
    swapped, later, far = ([r[:] for r in quiet] for _ in range(3))
    swapped[1], swapped[2] = [0.49, 0.50, 0.01], [0.44, 0.45, 0.11]
    later[3] = [0.20, 0.70, 0.10]                 # margin 0.5, reached
    far[6] = [0.10, 0.40, 0.50]                   # margin 0.1, not reached
    ref = [_rows(base, 1), _rows(base, 1)]
    assert tmoe.route_flips([_rows(swapped, 1), _rows(later, 1)], ref, 4,
                            "reach") == {1: 0, 2: 0, 3: 1}
    with pytest.raises(AssertionError, match="no near-tie"):
        tmoe.route_flips([_rows(quiet, 1), _rows(far, 1)], ref, 4, "far")
    assert tmoe.route_flips([_rows(quiet, 1), _rows(far, 1)], ref, 4,
                            "known", known={6: 1}) == {6: 1}
    every = [_rows(base, 3)]
    assert tmoe.route_flips(every, every, 4, "k = E") == {}


# -- module level, f32, bitwise-equal inputs ----------------------------------

def _moe_pair(cf):
    jcfg, cfg = _cfgs("dbrx-132b", capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.key(0), jcfg, jnp.float32)
    m = tmoe.MoE(cfg, torch.float32)
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(np.array(jp["router"]["w"])))
        for name in ("w_up", "w_gate", "w_down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(jp[name])))
    x = np.random.default_rng(20).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, m, x


def _jax_keep(jp, cfg, x):
    """JAX's kept (token, choice) slots, from ``lax.top_k`` of its f32
    router (``moe.py:61-78``), G = 1."""
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1])
                           @ jp["router"]["w"], axis=-1)
    _, ids = jax.lax.top_k(probs, cfg.top_k)
    flat = np.asarray(ids).reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    pos = np.take_along_axis(np.cumsum(onehot, 0) - 1, flat[:, None], 1)[:, 0]
    T = x.shape[0] * x.shape[1]
    cap = int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return np.asarray(ids), (pos < cap).reshape(-1, cfg.top_k)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_matches_jax(cf):
    """``moe_ffn`` on the same f32 input and weights: y and the aux loss
    to f32 rounding, the same experts chosen and the same slots dropped
    (at 0.5 most experts overflow)."""
    jcfg, cfg, jp, m, x = _moe_pair(cf)
    jy, jaux = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    y, aux = tmoe.moe_ffn(m, cfg, torch.from_numpy(x))
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * scale)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    r = tmoe.moe_route(m, cfg, torch.from_numpy(x))
    ids, keep = _jax_keep(jp, cfg, x)
    np.testing.assert_array_equal(r.ids.reshape(-1, cfg.top_k).numpy(), ids)
    np.testing.assert_array_equal(r.keep.reshape(-1, cfg.top_k).numpy(),
                                  keep)
    dropped = int((~r.keep).sum())
    print(f"capacity factor {cf}: cap {r.cap}, {dropped} of {keep.size} "
          f"slots dropped")
    assert (dropped > keep.size // 4) == (cf == 0.5)


def _unnormalised(orig):
    def route(p, cfg, x):
        r = orig(p, cfg, x)
        return r._replace(gate=torch.topk(r.probs, cfg.top_k)[0])
    return route


def _cap_minus_one(orig):
    def route(p, cfg, x):
        r = orig(p, cfg, x)
        return r._replace(cap=r.cap - 1, keep=r.pos < r.cap - 1)
    return route


@pytest.mark.parametrize("fault,cf", [("gates_unnormalised", 1.25),
                                      ("capacity_minus_one", 0.5)])
def test_moe_tolerance_catches_planted_faults(fault, cf, monkeypatch):
    jcfg, cfg, jp, m, x = _moe_pair(cf)
    jy, _ = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    make = _unnormalised if fault == "gates_unnormalised" else _cap_minus_one
    monkeypatch.setattr(tmoe, "moe_route", make(tmoe.moe_route))
    bad, _ = tmoe.moe_ffn(m, cfg, torch.from_numpy(x))
    reads = _reads(bad, jy)
    print(f"MoE {fault}: reads {reads:.1f} of the tolerance")
    assert reads > 1.0


def _ssm_inputs(S=96, B=2, di=8, ds=4):
    rng = np.random.default_rng(21)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    A = np.log(np.tile(np.arange(1.0, ds + 1.0), (di, 1))).astype(np.float32)
    Bc = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cc = rng.standard_normal((B, S, ds)).astype(np.float32)
    return u, dt, A, Bc, Cc


@pytest.mark.parametrize("chunk", [96, 16])
def test_ssm_scan_matches_jax(chunk, monkeypatch):
    """The segment-sum scan against ``lax.associative_scan`` at the
    shapes of ``test_mamba_chunk_invariance``, whole chunks and chunks
    split in sub-blocks (the memory rule at jamba's width)."""
    args = _ssm_inputs()
    ref = np.asarray(jmamba._ssm_scan(*map(jnp.asarray, args), chunk=chunk))
    got = tmamba._ssm_scan(*map(torch.from_numpy, args), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    monkeypatch.setattr(tmamba, "SEGMENT_BYTES", 4 * 2 * 4 * 4 * 8 * 4)
    assert tmamba._sub_block(2, chunk, 8, 4) == 4
    split = tmamba._ssm_scan(*map(torch.from_numpy, args), chunk=chunk)
    np.testing.assert_allclose(split.numpy(), ref, atol=1e-4)


def _xlstm_inputs(S, B=2, H=4, hd=16):
    rng = np.random.default_rng(22)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.standard_normal((B, S, H)).astype(np.float32)
    li = i_raw - i_raw.max()
    lf = -np.log1p(np.exp(-rng.standard_normal((B, S, H)) - 2.0))
    return q, k, v, li, lf.astype(np.float32)


@pytest.mark.parametrize("S", [24, 128])
def test_mlstm_chunk_scan_matches_jax(S):
    """One chunk (S = 24) and two, the state carried across (S = 128)."""
    args = _xlstm_inputs(S)
    ref = np.asarray(jxlstm._mlstm_chunk_scan(*map(jnp.asarray, args),
                                              chunk=64))
    got = txlstm._mlstm_chunk_scan(*map(torch.from_numpy, args), chunk=64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_mlstm_rejects_a_partial_chunk():
    args = _xlstm_inputs(96)
    with pytest.raises(ValueError, match="whole number"):
        txlstm._mlstm_chunk_scan(*map(torch.from_numpy, args), chunk=64)
    with pytest.raises(TypeError):          # JAX's reshape refuses it too
        jxlstm._mlstm_chunk_scan(*map(jnp.asarray, args), chunk=64)


def test_slstm_scan_matches_jax():
    """The sLSTM time scan on f32 weights and input."""
    jcfg, cfg, _, jparams, _, _ = _pair("xlstm-125m")
    lp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][2])
    assert set(lp["mixer"]) == {"wx", "wr", "wo"}
    m = txlstm.SLSTM(cfg, torch.float32)
    with torch.no_grad():
        m.wx.w.copy_(torch.tensor(np.asarray(lp["mixer"]["wx"]["w"])))
        m.wr.copy_(torch.tensor(np.asarray(lp["mixer"]["wr"])))
        m.wo.w.copy_(torch.tensor(np.asarray(lp["mixer"]["wo"]["w"])))
    x = np.random.default_rng(23).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    ref = np.asarray(jxlstm.slstm(lp["mixer"], jcfg, jnp.asarray(x)))
    got = txlstm.slstm(m, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_cross_attention_matches_jax():
    """``attention(kv_override=(k, v))`` — Sq ≠ Skv, never causal — on
    bf16 activations: the same numerics as the JAX ``_flash``."""
    jcfg, cfg, _, jparams, _, sp = _pair("seamless-m4t-large-v2")
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 10, cfg.n_kv_heads, cfg.hd, 2)).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb, vb = (jnp.asarray(mem[..., i]).astype(jnp.bfloat16) for i in (0, 1))
    jp = jax.tree_util.tree_map(lambda a: a[0].astype(jnp.bfloat16),
                                jparams["dec"])["cross"]
    pos = jnp.broadcast_to(jnp.arange(6)[None], (2, 6))
    ref = jattn.attention(jp, jcfg, xb, pos, kv_override=(kb, vb))
    t = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tattn.attention(sp.dec[0].cross, cfg, t(xb), torch.from_numpy(
        np.asarray(pos)), kv_override=(t(kb), t(vb)))
    _close(got, ref, "cross-attention")
    # causal=True is ignored with kv_override, as in JAX
    again = tattn.attention(sp.dec[0].cross, cfg, t(xb), torch.from_numpy(
        np.asarray(pos)), causal=True, kv_override=(t(kb), t(vb)))
    assert torch.equal(got, again)


# -- model level: prefill -----------------------------------------------------

_PREFILL = {}


def _jax_forward(arch, jcfg, jparams, batch):
    """(logits, aux) of the JAX package (aux 0 for enc-dec), jitted."""
    if jcfg.enc_layers:
        return jax.jit(lambda p, t, f: (jenc.encdec_forward(p, jcfg, t, f),
                                        0.0))(
            jparams, jnp.asarray(batch["tokens"]),
            jnp.asarray(batch["frontend"]))
    return jax.jit(lambda p, t: jtfm.lm_forward(p, jcfg, t))(
        jparams, jnp.asarray(batch["tokens"]))


def _port_forward(cfg, sp, batch, aux=False):
    toks = torch.from_numpy(batch["tokens"])
    if cfg.enc_layers:
        out = (tenc.encdec_forward(sp, cfg, toks,
                                   torch.from_numpy(batch["frontend"])), 0.0)
    else:
        out = ttfm.lm_forward(sp, cfg, toks)
    return out if aux else out[0]


def _prefill_case(arch, monkeypatch):
    """(batch, JAX logits, port logits, held rows (B, S)) for B = 2,
    S = 24 (tokens seed 1, frames seed 2), built once per module; rows a
    routing flip reaches are not held (see the module note)."""
    if arch not in _PREFILL:
        jcfg, cfg, _, jparams, _, sp = _pair(arch)
        B, S = 2, 24
        batch = {"tokens": _tokens(cfg, B, S, 1)}
        if cfg.enc_layers:
            batch["frontend"] = _frames(cfg, B, 2)
        held = np.ones((B, S), bool)
        with monkeypatch.context() as mp:
            jr = _record_jax(mp, cfg)
            tr = _record_port(mp)
            jfull, jaux = _jax_forward(arch, jcfg, jparams, batch)
            tfull, taux = _port_forward(cfg, sp, batch, aux=True)
            jax.effects_barrier()
        _hold_out(held, tmoe.route_flips(tr.calls, jr.calls, S,
                                         f"{arch} prefill"), cfg)
        _PREFILL[arch] = (batch, jfull, tfull, held, float(jaux),
                          float(taux))
    return _PREFILL[arch]


def _free(arch, used, what):
    """Assert a free-running reading within the tolerance (× the
    :data:`NOISY` bound)."""
    bound = NOISY.get(arch, 1.0)
    print(f"{arch}: {what} uses {used:.2f} of the tolerance (bound "
          f"{bound:.1f})")
    assert used <= bound, f"{arch} {what}: {used:.2f}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_jax(arch, monkeypatch):
    """The full-sequence forward and ``ModelAPI.prefill`` (last position)
    of both packages on the same tokens (enc-dec: and frames), over the
    rows no routing flip reaches."""
    jcfg, cfg, japi, jparams, api, sp = _pair(arch)
    batch, jfull, tfull, held, jaux, aux = _prefill_case(arch, monkeypatch)
    B, S = batch["tokens"].shape
    assert tfull.shape == (B, S, cfg.vocab_padded)
    assert held.sum() >= held.size // 2
    _free(arch, _reads(tfull, jfull, held),
          f"prefill on {held.sum()} of {held.size} rows")
    last = api.prefill(sp, batch)
    assert last.shape == (B, 1, cfg.vocab_padded)
    assert torch.equal(last, tfull[:, -1:])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _free(arch, _reads(last, japi.prefill(jparams, jb), held[:, -1:]),
          "ModelAPI.prefill")
    if cfg.n_experts:                 # the Switch loss summed over layers
        assert aux > 0 and abs(aux - jaux) <= 0.05 * jaux
    else:
        assert aux == jaux == 0.0


def _bf16(a):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))
                            ).to(torch.bfloat16)


_JIT = {}


def _jax_block(jcfg, kind, decode):
    """``block_forward`` / ``block_decode`` of the JAX package for one
    layer kind, jitted once per module."""
    key = (jcfg.name, kind, decode)
    if key not in _JIT:
        fn = jtfm.block_decode if decode else jtfm.block_forward
        _JIT[key] = jax.jit(lambda p, h, pos, *st: fn(p, jcfg, kind, h, pos,
                                                       *st))
    return _JIT[key]


def _layer_params(jparams, cfg, l):
    g = cfg.layer_group
    return jax.tree_util.tree_map(lambda a: a[l // g], jparams["blocks"][l % g])


def _forced_flips(tr, jr, S, what, held):
    """Drop from ``held`` (B, S) the rows of one block's routing flips:
    the MoE is the block's last step, so a flip reaches its own row."""
    for row in tmoe.route_flips(tr.calls, jr.calls, 1, what):
        held[divmod(row, S)] = False


def _layer_forced_prefill(arch, monkeypatch, sp=None):
    """Each block of the port on the JAX package's own hidden state at its
    input (B = 2, S = 24, tokens seed 1) against the JAX block, and the
    logits of the JAX package's last hidden state: (the largest block
    reading, the logits' reading, the fewest rows a layer held)."""
    jcfg, cfg, _, jparams, _, sp0 = _pair(arch)
    sp = sp0 if sp is None else sp
    B, S = 2, 24
    toks = _tokens(cfg, B, S, 1)
    h = jlayers.embed(jparams["embed"], jnp.asarray(toks), jnp.bfloat16)
    pj = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    pt = torch.arange(S)[None].expand(B, S)
    worst, held_rows = 0.0, B * S
    for l, kind in enumerate(ttfm.layer_kinds(cfg)):
        held = np.ones((B, S), bool)
        with monkeypatch.context() as mp:
            jr = _record_jax(mp, cfg)
            tr = _record_port(mp)
            hj, _ = _jax_block(jcfg, kind, False)(
                _layer_params(jparams, cfg, l), h, pj)
            ht, _ = ttfm.block_forward(sp.blocks[l], cfg, _bf16(h), pt)
            jax.effects_barrier()
        _forced_flips(tr, jr, S, f"{arch} layer {l}", held)
        worst = max(worst, _reads(ht, hj, held))
        held_rows = min(held_rows, int(held.sum()))
        h = hj
    lg = _reads(ttfm._logits(sp, cfg, _bf16(h)), jtfm._logits(jparams, jcfg, h))
    return worst, lg, held_rows


@pytest.mark.parametrize("arch", DECODERS)
def test_layer_forced_prefill_matches_jax(arch, monkeypatch):
    """Every block of the port on the JAX package's own hidden state at
    its input, against the JAX block, and the logits of its last hidden
    state. No bf16 noise accumulates across layers here, so each reading
    is one block's (a routing flip drops its own row of that layer
    only)."""
    worst, lg, held_rows = _layer_forced_prefill(arch, monkeypatch)
    print(f"{arch}: blocks use at most {worst:.3f} of the tolerance (at "
          f"least {held_rows} of 48 rows held a layer), logits {lg:.3f}")
    assert worst <= 1.0 and lg <= 1.0 and held_rows >= 24


@pytest.mark.parametrize("arch", DECODERS)
def test_layer_forced_decode_matches_jax(arch, monkeypatch):
    """Every block's decode step of the port on the JAX package's own
    hidden state and cache state at its input, S = 6 steps of B = 2
    (tokens seed 3), against the JAX block: the output and every new
    state (f32 or bf16 as the JAX cache keeps it)."""
    jcfg, cfg, japi, jparams, _, sp = _pair(arch)
    B, S = 2, 6
    toks = _tokens(cfg, B, S, 3)
    jcache = list(japi.init_cache(B, S))
    g = cfg.layer_group
    worst = 0.0
    for t in range(S):
        h = jlayers.embed(jparams["embed"], jnp.asarray(toks[:, t])[:, None],
                          jnp.bfloat16)
        pos = jnp.full((B,), t, jnp.int32)
        for l, kind in enumerate(ttfm.layer_kinds(cfg)):
            held = np.ones((B, 1), bool)
            jstate = {k: v[l // g] for k, v in jcache[l % g].items()}
            tstate = {k: torch.from_numpy(np.array(
                jnp.asarray(v).astype(jnp.float32))).to(ttfm.cache_dtype(k, cfg))
                for k, v in jstate.items()}
            with monkeypatch.context() as mp:
                jr = _record_jax(mp, cfg)
                tr = _record_port(mp)
                hj, jnew = _jax_block(jcfg, kind, True)(
                    _layer_params(jparams, cfg, l), h, pos, jstate)
                ht, tnew = ttfm.block_decode(sp.blocks[l], cfg, _bf16(h),
                                             torch.full((B,), t), tstate)
                jax.effects_barrier()
            _forced_flips(tr, jr, 1, f"{arch} step {t} layer {l}", held)
            what = f"{arch} step {t} layer {l} ({kind})"
            worst = max(worst, _close(ht, hj, what, held))
            for k, v in tnew.items():
                assert v.dtype == ttfm.cache_dtype(k, cfg), (what, k)
                ref = np.asarray(jnp.asarray(jnew[k]).astype(jnp.float32))
                if held.all():
                    _close(v, ref, f"{what} state {k}")
            jcache[l % g] = {k: v.at[l // g].set(jnew[k])
                             for k, v in jcache[l % g].items()}
            h = hj
        lg = _close(ttfm._logits(sp, cfg, _bf16(h)),
                    jtfm._logits(jparams, jcfg, h), f"{arch} step {t} logits")
        worst = max(worst, lg)
    print(f"{arch}: decode blocks and logits use at most {worst:.3f} of the "
          "tolerance")


# -- model level: teacher-forced decode ---------------------------------------

def _decode_both(arch, B, S, seed, monkeypatch):
    """Feed the same S tokens to both packages' decode step: (JAX logits,
    port logits) (B, S, V) and the held rows (B, S) — a slot's rows from
    the first step a routing flip reaches it."""
    jcfg, cfg, japi, jparams, api, sp = _pair(arch)
    toks = _tokens(cfg, B, S, seed)
    if cfg.enc_layers:
        fr = _frames(cfg, B, 2)
        jcache = jenc.encdec_init_cache(jparams, jcfg, jnp.asarray(fr), S)
        tcache = tenc.encdec_init_cache(sp, cfg, torch.from_numpy(fr), S)
    else:
        jcache = japi.init_cache(B, S)
        tcache = api.init_cache(B, S, device="cpu")
    held = np.ones((B, S), bool)
    jl, tl = [], []
    with monkeypatch.context() as mp:
        jr = _record_jax(mp, cfg) if cfg.n_experts else None
        tr = _record_port(mp) if cfg.n_experts else None
        jstep = jax.jit(lambda p, t, q, c: japi.decode_step(p, t, q, c))
        for t in range(S):
            pos = np.full((B,), t, np.int32)
            a, jcache = jstep(jparams, jnp.asarray(toks[:, t]),
                              jnp.asarray(pos), jcache)
            b, tcache = api.decode_step(sp, torch.from_numpy(toks[:, t]),
                                        torch.from_numpy(pos), tcache)
            jl.append(_f32(a))
            tl.append(_f32(b))
        jax.effects_barrier()
    if tr is not None:
        per = _moe_per_step(cfg)
        for slot, c in tmoe.route_flips(tr.calls, jr.calls, 1,
                                        f"{arch} decode").items():
            held[slot, c // per:] = False
    return np.stack(jl, 1), np.stack(tl, 1), held, jcache, tcache


def _moe_per_step(cfg):
    """MoE calls of one forward or decode step: one a MoE layer."""
    return sum(k.endswith("moe") for k in ttfm.layer_kinds(cfg))


def _hold_out(held, rows, cfg):
    """Drop from ``held`` (B, S) the positions a routing difference
    (``{row b·S + s: call}``) reaches: the rest of its sequence, or its
    own row alone when it is in the last layer and that layer is MoE (the
    last step of its block)."""
    S, per = held.shape[1], _moe_per_step(cfg)
    final = ttfm.layer_kinds(cfg)[-1].endswith("moe")
    for row, c in rows.items():
        b, s = divmod(row, S)
        held[b, s:s + 1 if final and c == per - 1 else S] = False


@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_decode_matches_jax(arch, monkeypatch):
    """S tokens through both packages' decode step (enc-dec: from
    ``encdec_init_cache``): the logits at every step, and the states the
    caches end with."""
    jl, tl, held, jcache, tcache = _decode_both(arch, 2, 10, 3, monkeypatch)
    assert held.sum() >= held.size // 2
    _free(arch, _reads(tl, jl, held),
          f"decode on {held.sum()} of {held.size} rows")
    slots = np.flatnonzero(held.all(1))       # no flip reached them
    assert len(slots)
    entries = ([tcache] if isinstance(tcache, dict) else list(tcache))
    jentries = ([jcache] if isinstance(jcache, dict) else list(jcache))
    worst = 0.0
    for te, je in zip(entries, jentries):
        for key, v in te.items():          # (layers or groups, B, ...)
            assert v.dtype == (torch.float32 if key in ("c", "n", "m", "ssm",
                                                        "C")
                               else torch.bfloat16), key
            worst = max(worst, _reads(_f32(v)[:, slots],
                                      _f32(je[key])[:, slots]))
    _free(arch, worst, f"the cache states of slots {slots.tolist()}")


def _own(arch, **overrides):
    cfg = tconfig.reduced_config(tconfig.get_config(arch), **overrides)
    api = get_model(cfg)
    return cfg, api, api.serving_params(api.init(5, device="cpu"))


OWN = [("dbrx-132b", dict(capacity_factor=2.0)),
       ("grok-1-314b", dict(capacity_factor=2.0)),
       ("jamba-1.5-large-398b", dict(capacity_factor=2.0)),
       ("seamless-m4t-large-v2", {}),
       ("xlstm-125m", dict(xlstm_pattern=("s",), n_layers=2, layer_group=1)),
       ("xlstm-125m", {})]


@pytest.mark.parametrize("arch,overrides", OWN, ids=[
    "dbrx", "grok", "jamba", "seamless", "slstm-only", "xlstm-125m"])
def test_prefill_matches_own_decode(arch, overrides, monkeypatch):
    """The port's prefill against its own teacher-forced decode (its
    seeded init, B = 2, S = 12, tokens from seed 4). MoE at capacity
    factor E/k, where no prefill slot can drop (decode never drops at
    B = 2), flipped routings excluded as against JAX; xlstm-125m held to
    the JAX package's own gap."""
    cfg, api, sp = _own(arch, **overrides)
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 4))
    held = np.ones((B, S), bool)
    with monkeypatch.context() as mp:
        rec = _record_port(mp)
        if cfg.enc_layers:
            fr = torch.from_numpy(_frames(cfg, B, 2))
            full = tenc.encdec_forward(sp, cfg, toks, fr)
            cache = tenc.encdec_init_cache(sp, cfg, fr, S)
        else:
            full, _ = ttfm.lm_forward(sp, cfg, toks)
            cache = api.init_cache(B, S, device="cpu")
        per = len(rec.calls)
        outs = []
        for t in range(S):
            lg, cache = api.decode_step(sp, toks[:, t], torch.full((B,), t),
                                        cache)
            outs.append(lg)
    if cfg.n_experts:
        assert len(rec.calls) == (S + 1) * per
        assert all(c.keep.all() for c in rec.calls)    # no slot drops
        pre = tmoe.routes_by_layer(rec.calls[:per], per, B)
        dec = tmoe.routes_by_layer(rec.calls[per:], per, B)
        _hold_out(held, tmoe.route_flips(dec, pre, S, f"{arch} own decode"),
                  cfg)
    used = _reads(torch.stack(outs, 1), full, held)
    bound = XLSTM_JAX_GAP * 1.1 if arch == "xlstm-125m" and not overrides \
        else 1.0
    print(f"{arch} {overrides}: own decode vs prefill reads {used:.2f} of "
          f"the tolerance on {held.sum()} of {held.size} rows "
          f"(bound {bound:.2f})")
    assert used <= bound and held.sum() >= held.size // 2


def test_xlstm_jax_gap_is_the_stated_one():
    """The JAX package's own decode-vs-forward gap at reduced xlstm-125m
    (the bound of the port's own gap), measured: 13.37 of the tolerance,
    where the port's own decode stays within 1.1 × of it."""
    jcfg, cfg, japi, jparams, _, _ = _pair("xlstm-125m")
    B, S = 2, 12
    toks = _tokens(cfg, B, S, 4)
    full, _ = jtfm.lm_forward(jparams, jcfg, jnp.asarray(toks))
    cache = japi.init_cache(B, S)
    step = jax.jit(japi.decode_step)
    outs = []
    for t in range(S):
        lg, cache = step(jparams, jnp.asarray(toks[:, t]),
                         jnp.full((B,), t, jnp.int32), cache)
        outs.append(lg)
    gap = _reads(jnp.stack(outs, 1), full)
    print(f"xlstm-125m: the JAX package's own decode reads {gap:.2f} of the "
          "tolerance against its forward")
    assert abs(gap - XLSTM_JAX_GAP) <= 0.05 * XLSTM_JAX_GAP


# -- served greedy tokens -----------------------------------------------------

def _serve(engine_cls, request_cls, api, params, slots, max_seq, prompts,
           max_new, per_step):
    """Run the engine; keep for each request the logits row of each of
    its tokens, and for each step the request in every slot."""
    eng = engine_cls(api, params, batch_slots=slots, max_seq=max_seq)
    rows, occupants = {}, []
    step = eng._step

    def recording_step(*args):
        logits, cache = step(*args)
        lg = _f32(logits)
        occupants.append([None if r is None else r.rid for r in eng.slots])
        for i, req in enumerate(eng.slots):
            if req is not None and not req._feed:
                rows.setdefault(req.rid, []).append((len(occupants) - 1,
                                                     lg[i]))
        return logits, cache

    eng._step = recording_step
    reqs = [request_cls(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=500)
    return reqs, rows, occupants


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_engine_matches_jax(arch, monkeypatch):
    """The port's ``ServeEngine`` on the JAX engine's requests
    (``test_substrate.py::test_serve_engine_continuous_batching``'s): every
    request completes; each greedy token equals JAX's wherever JAX's
    top-1/top-2 margin exceeds twice the tolerance, and its logits are
    within the tolerance — up to a request's first token that may
    legitimately differ, or the first step a routing flip reaches it.
    Idle slots and refilled slots keep their recurrent state, as the JAX
    engine's do."""
    jcfg, cfg, _, jparams, api, sp = _pair(arch)
    japi = jget_model(jcfg)          # a fresh api: a fresh jit trace
    prompts = [[1 + i, 2, 3] for i in range(5)]
    slots, max_seq, max_new = 2, 32, 4
    with monkeypatch.context() as mp:
        jr = _record_jax(mp, cfg) if cfg.n_experts else None
        tr = _record_port(mp) if cfg.n_experts else None
        jreqs, jrows, jocc = _serve(jserve.ServeEngine, jserve.Request, japi,
                                    jparams, slots, max_seq, prompts,
                                    max_new, None)
        jax.effects_barrier()
        reqs, rows, occ = _serve(ServeEngine, Request, api, sp, slots,
                                 max_seq, prompts, max_new, None)
    assert occ == jocc
    cut = {}                              # request -> first unheld step
    if tr is not None:
        # a slot fed another token, or a flip reaches, stays reached (its
        # state carries over to the next request)
        per = _moe_per_step(cfg)
        fed = {}
        for r, jr_ in zip(reqs, jreqs):
            j = next((j for j, (a, b) in enumerate(zip(r.out, jr_.out))
                      if a != b), None)
            if j is not None:
                t = rows[r.rid][j][0]
                slot = occ[t].index(r.rid)
                fed[slot] = min(fed.get(slot, len(occ) * per), (t + 1) * per)
        hit = dict(fed)
        for slot, c in tmoe.route_flips(tr.calls, jr.calls, 1,
                                        f"{arch} serve", known=fed).items():
            hit[slot] = min(hit.get(slot, c), c)
        for slot, c in hit.items():
            for t in range(c // per, len(occ)):
                if occ[t][slot] is not None:
                    cut.setdefault(occ[t][slot], t)
    past = held = 0
    for r, jr_ in zip(reqs, jreqs):
        assert r.done and len(r.out) == max_new
        assert jr_.done and len(jr_.out) == max_new
        assert all(0 <= t < cfg.vocab for t in r.out)
        for j, (a, b) in enumerate(zip(r.out, jr_.out)):
            t, row = rows[r.rid][j]
            if t >= cut.get(r.rid, len(occ)):
                break
            ref = jrows[r.rid][j][1]
            used = _reads(row, ref)
            assert used <= NOISY.get(arch, 1.0), (r.rid, j, used)
            held += 1
            # |Δ| ≤ δ on every logit decides the argmax past a 2δ margin
            top2 = np.sort(ref)[-2:]
            delta = float(np.abs(row - ref)[ref > -1e29].max())
            tol = max(_atol(ref) + TOL * abs(top2[1]), delta)
            if top2[1] - top2[0] > 2 * tol:
                assert a == b, (r.rid, j, r.out, jr_.out)
                past += 1
            elif a != b:
                break
    print(f"{arch}: {held} of {len(reqs) * max_new} tokens held, {past} "
          f"past the margin, all equal; requests cut by a routing flip or "
          f"a token fed otherwise (at step): {cut}")
    assert held >= len(reqs)


# -- planted faults -----------------------------------------------------------

def _noncausal_F():
    """``torch.nn.functional`` with ``pad`` shifted one place: the conv
    window of position t reaches t + 1."""
    fake = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                    if not k.startswith("__")})
    fake.pad = lambda u, pad: F.pad(u, (pad[0], pad[1], pad[2] - 1, 1))
    return fake


def _stabiliser_per_head(p, cfg, x):
    """``_gates`` with the input gate stabilised per (batch, head), over
    the positions only."""
    q, k, v, _, log_f = _TRUE_GATES(p, cfg, x)
    i_raw = txlstm.linear(p.wi, x).to(torch.float32)
    return q, k, v, i_raw - i_raw.amax(dim=1, keepdim=True), log_f


_TRUE_GATES = txlstm._gates


def _causal_cross(q, k, v):
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    Sq, Skv = q.shape[1], k.shape[1]
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).float()
    mask = torch.arange(Skv)[None] <= torch.arange(Sq)[:, None]
    w = torch.softmax(s.masked_fill(~mask, -1e30), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _causal_flash(q, k, v, causal):
    return _TRUE_FLASH(q, k, v, True)


_TRUE_FLASH = tattn._flash

FAULTS = [("jamba-1.5-large-398b", "conv_noncausal"),
          ("jamba-1.5-large-398b", "D_dropped"),
          ("xlstm-125m", "stabiliser_per_head"),
          ("seamless-m4t-large-v2", "cross_causal"),
          ("seamless-m4t-large-v2", "encoder_causal")]


@pytest.mark.parametrize("arch,fault", FAULTS,
                         ids=[f"{a.split('-')[0]}-{f}" for a, f in FAULTS])
def test_tolerance_catches_planted_faults(arch, fault, monkeypatch):
    """The control of the model-level checks, one planted fault at a time
    (MoE's are at module level, ``test_moe_tolerance_catches_planted_
    faults``): each reads above the bound its family is held to and
    fails it — jamba's layer-forced prefill (and its free-running prefill,
    on the rows the sound run holds, above its :data:`NOISY` bound),
    xlstm-125m's teacher-forced decode, seamless's prefill."""
    jcfg, cfg, _, jparams, api, sp = _pair(arch)
    if arch in NOISY:                          # the sound run, first
        batch, jfull, _, held, _, _ = _prefill_case(arch, monkeypatch)
    if fault == "conv_noncausal":
        monkeypatch.setattr(tmamba, "F", _noncausal_F())
    elif fault == "D_dropped":
        sp = ttfm.serving_params(api.init(0, device="cpu"))
        sp.load_state_dict(_pair(arch)[5].state_dict())
        with torch.no_grad():
            for blk in sp.blocks:
                if hasattr(blk.mixer, "D"):
                    blk.mixer.D.zero_()
    elif fault == "stabiliser_per_head":
        monkeypatch.setattr(txlstm, "_gates", _stabiliser_per_head)
    elif fault == "cross_causal":
        monkeypatch.setattr(tattn, "_cross", _causal_cross)
    else:
        monkeypatch.setattr(tattn, "_flash", _causal_flash)
    if arch == "jamba-1.5-large-398b":
        worst, lg, _ = _layer_forced_prefill(arch, monkeypatch, sp)
        reads = max(worst, lg)
        free = _reads(_port_forward(cfg, sp, batch), jfull, held)
        print(f"{arch} {fault}: free-running prefill reads {free:.1f}")
        assert free > NOISY[arch]
    elif arch == "xlstm-125m":
        jl, tl, held, _, _ = _decode_both(arch, 2, 10, 3, monkeypatch)
        reads = _reads(tl, jl)
    else:
        batch = {"tokens": _tokens(cfg, 2, 24, 1),
                 "frontend": _frames(cfg, 2, 2)}
        reads = _reads(_port_forward(cfg, sp, batch),
                       _jax_forward(arch, jcfg, jparams, batch)[0])
    print(f"{arch} {fault}: reads {reads:.1f} of the tolerance")
    assert reads > 1.0


# -- weights and dtypes -------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_uses_every_leaf(arch):
    """Every leaf of the JAX tree lands in the port, each value in its
    place (jamba: eight group positions; enc-dec: ``enc``/``dec`` stacked
    over layers); a leaf with no place raises."""
    jcfg, cfg, _, jparams, _, sp = _pair(arch)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_from_jax(tree, cfg, device="cpu")
    state = tp.state_dict()
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))
    assert sum(w.numel() for w in tp.parameters()) == n_jax
    if cfg.enc_layers:
        l = cfg.n_layers - 1
        np.testing.assert_array_equal(
            state[f"dec.{l}.cross.wk.w"].numpy(),
            np.asarray(tree["dec"]["cross"]["wk"]["w"][l], np.float32))
        np.testing.assert_array_equal(
            state["enc.1.ffn.up.w"].numpy(),
            np.asarray(tree["enc"]["ffn"]["up"]["w"][1], np.float32))
    else:
        g = cfg.layer_group
        assert len(tree["blocks"]) == g
        for l, kind in enumerate(ttfm.layer_kinds(cfg)):
            leaf = {"mamba": ("mixer", "A_log"), "attn": ("mixer", "wq", "w"),
                    "mlstm": ("mixer", "wi", "w"), "slstm": ("mixer", "wr")
                    }[kind.split("+")[0]]
            if kind.endswith("moe"):
                leaf = ("ffn", "w_gate")
            ref = tree["blocks"][l % g]
            for k in leaf:
                ref = ref[k]
            np.testing.assert_array_equal(
                state[f"blocks.{l}." + ".".join(leaf)].numpy(),
                np.asarray(ref[l // g], np.float32))
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no place"):
        params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_serving_params_keep_the_f32_weights(arch):
    """The serving model is bf16 but for the router, ``A_log`` and
    ``dt_bias``, which stay f32 with the JAX values; the port's own init
    holds them in f32 too, whatever ``param_dtype`` is."""
    jcfg, cfg, _, jparams, api, sp = _pair(arch)
    keep = [k for k, _ in sp.named_parameters()
            if k.endswith(ttfm.F32_PARAMS)]
    assert keep and {k.rsplit(".", 1)[-1] for k in keep} == (
        {"w"} | ({"A_log", "dt_bias"} if cfg.attn_every else set()))
    for k, w in sp.named_parameters():
        assert w.dtype == (torch.float32 if k in keep else torch.bfloat16), k
    assert api.serving_params(sp) is sp
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    l = next(l for l, k in enumerate(ttfm.layer_kinds(cfg))
             if k.endswith("moe"))
    np.testing.assert_array_equal(
        sp.state_dict()[f"blocks.{l}.ffn.router.w"].numpy(),
        tree["blocks"][l % cfg.layer_group]["ffn"]["router"]["w"][
            l // cfg.layer_group])
    full = dataclasses.replace(tconfig.get_config(arch), n_layers=cfg.n_layers,
                               layer_group=cfg.layer_group)
    assert full.param_dtype == "bfloat16"
    shapes = get_model(full).param_shapes()
    for k, w in shapes.named_parameters():
        assert w.is_meta and w.dtype == (
            torch.float32 if k.endswith(ttfm.F32_PARAMS) else torch.bfloat16)


def test_seeded_init_follows_the_jax_scheme():
    """The port's own init: A_log = log(1..ds) on every channel, D = 1,
    dt_bias = 0, conv_w N(0, 0.1²); expert weights scaled so a unit
    input gives unit-std expert outputs (std over the E·d_in fan-in rule
    would give 1/√E); the sLSTM recurrence N(0, 1/hd)."""
    cfg = tconfig.reduced_config(tconfig.get_config("jamba-1.5-large-398b"),
                                 d_model=256, d_ff=512)
    p = get_model(cfg).init(0, device="cpu")
    mix = p.blocks[0].mixer
    ds = cfg.mamba_d_state
    assert mix.A_log.dtype == torch.float32
    assert torch.equal(mix.A_log, torch.log(torch.arange(
        1.0, ds + 1)).expand(2 * cfg.d_model, ds))
    assert torch.equal(mix.D, torch.ones_like(mix.D))
    assert torch.equal(mix.dt_bias, torch.zeros_like(mix.dt_bias))
    assert 0.09 < float(mix.conv_w.std()) < 0.11
    moe = p.blocks[1].ffn
    x = torch.randn(4096, cfg.d_model, generator=torch.Generator().manual_seed(1))
    for e in range(cfg.n_experts):
        up = x @ moe.w_up[e]
        assert 0.95 < float(up.std()) < 1.05, e
        down = torch.randn(4096, cfg.d_ff) @ moe.w_down[e]
        assert 0.95 < float(down.std()) < 1.05, e
    xc = tconfig.reduced_config(tconfig.get_config("xlstm-125m"), head_dim=64)
    wr = get_model(xc).init(0, device="cpu").blocks[2].mixer.wr
    assert abs(float(wr.std()) * 64 ** 0.5 - 1) < 0.05
    again = get_model(cfg).init(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(p.parameters(), again.parameters()))


# -- what still raises, and the launcher --------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_raises_and_naming_the_training_slice(arch):
    _, cfg, _, _, api, sp = _pair(arch)
    with pytest.raises(NotImplementedError, match="training"):
        api.loss(sp, {})


def test_encdec_cache_comes_from_the_encoder():
    _, cfg, japi, _, api, sp = _pair("seamless-m4t-large-v2")
    with pytest.raises(NotImplementedError, match="encdec_init_cache"):
        api.init_cache(2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec_init_cache"):
        japi.init_cache(2, 8)
    spec = api.cache_spec(2, 8)
    assert spec == japi.cache_spec(2, 8)
    cache = tenc.encdec_init_cache(sp, cfg, _frames(cfg, 2, 3, S_enc=6), 8)
    assert {k: tuple(v.shape) for k, v in cache.items()} == dict(
        spec, cross_k=spec["cross_k"][:2] + (6,) + spec["cross_k"][3:],
        cross_v=spec["cross_v"][:2] + (6,) + spec["cross_v"][3:])


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_launcher_on_the_families():
    """``launch.serve`` serves xlstm-125m on the CPU and exits with the
    JAX launcher's message for the enc-dec config."""
    r = _run("-m", "repro_torch.launch.serve", "--arch", "xlstm-125m",
             "--device", "cpu", "--requests", "3", "--max-new", "4")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "completed 3/3 requests, 12 tokens generated" in r.stdout
    r = _run("-m", "repro_torch.launch.serve", "--arch",
             "seamless-m4t-large-v2", "--device", "cpu")
    assert r.returncode != 0
    assert "enc-dec serving needs encoder inputs" in r.stderr
