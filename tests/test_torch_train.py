"""The port's training path (``repro_torch.optim``, ``data``,
``checkpoint``, ``runtime.train_loop``, ``launch.steps``,
``launch.train``, ``ModelAPI.loss``) against the JAX package on the CPU.

AdamW, the schedule and the data pipeline are held to the JAX functions
on the same numbers (the pipeline bit for bit). The checkpoint and the
loop have the JAX package's own tests as twins
(``tests/test_substrate.py``).

**The loss and its gradient, all ten configs** at ``reduced_config``
(B = 2, S = 24 — 64 for xlstm-125m, one whole mLSTM chunk — the
pipeline's batch 0), the JAX parameters carried over
with ``params_from_jax``: ``jax.value_and_grad`` of the JAX loss, one
compile per arch, against ``ModelAPI.loss(...).backward()`` through the
port's backward kernels' plain versions. Each gradient leaf is held to a
relative error ``‖g − g_jax‖ / ‖g_jax‖ ≤`` :data:`GRAD_TOL` = 0.15, the
loss to ``|Δ| ≤`` :data:`LOSS_TOL` = 5e-3. The JAX package's own bf16
noise backs both: its gradient with RMSNorm forced to the port's one f32
rounding against its own three bf16 roundings reads up to 0.065 per leaf
(xlstm-125m's ``wi``; 0.034–0.044 on the dense and MoE decoders, 0.030
on seamless) and moves the loss by up to 1.2e-3 (dbrx-132b); the port
reads up to 0.071 and 2.7e-3 (qwen3-32b). jamba-1.5-large-398b's eight
bf16 mamba/attention/MoE layers carry more: JAX's own spread reads 0.44
on a gradient leaf and 0.023 on the loss (its routing flips with the
rounding), the port, with its flipped rows left out, 0.117 and 8.5e-3;
its gradients are held to :data:`NOISY` = 2 ×, its loss to
:data:`NOISY_LOSS` = 5 × (0.025). MoE
routing flips at near-ties are shown and left out as
``tests/test_torch_models_families.py`` does (``moe.route_flips``): the
loss mask drops each flipped row and, unless the flip is in the last
block, the rest of its sequence, in both packages. The planted faults
read well beyond: a dropped 0.01·aux moves dbrx's loss by 4.9 ×
:data:`LOSS_TOL`; a non-causal flash backward reads hundreds of
:data:`GRAD_TOL`, a zero RMSNorm ``ds`` 1.0 (6.7 ×), and the xLSTM input
gate's max taken with a gradient 0.57 on ``wi`` (3.8 ×).

    PYTHONPATH=src python -m pytest -q tests/test_torch_train.py
"""
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as jconfig
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.data.pipeline import make_batch_specs as jmake_batch_specs
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_warmup as jcosine_warmup

from repro_torch import config as tconfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.configs import ALL_ARCHS
from repro_torch.data import SyntheticTokens, make_batch_specs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_bwd_ref
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train_step, state_dtype_of
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import (adamw_state_from_jax,
                                        named_from_jax, params_from_jax)
from repro_torch.models.layers import cross_entropy, linear
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_warmup)
from repro_torch.runtime import TrainLoopConfig, run_train_loop

from test_torch_models_families import _record_jax, _record_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 0.15
LOSS_TOL = 5e-3
#: archs whose bf16 noise outgrows the tolerances even within the JAX
#: package, with the factor their gradient and loss readings are held to
#: (module note)
NOISY = {"jamba-1.5-large-398b": 2.0}
NOISY_LOSS = {"jamba-1.5-large-398b": 5.0}
B, S = 2, 24
#: xlstm-125m runs one whole mLSTM chunk (64 positions)
SEQ = {"xlstm-125m": 64}


def _tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


# -- AdamW, the schedule, the pipeline -----------------------------------------

def _adamw_case(seed, state_dtype, big):
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((7, 5)).astype(np.float32),
         "b": rng.standard_normal(13).astype(np.float32)}
    gs = [{k: (rng.standard_normal(v.shape) * (3.0 if big else 0.01)
               ).astype(np.float32) for k, v in p.items()}
          for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("state_dtype,big", [
    ("float32", False), ("float32", True), ("bfloat16", True)])
def test_adamw_matches_jax(state_dtype, big):
    """Three AdamW steps from zero state in both packages: parameters,
    ``m``, ``v``, the step and the gradient norm, with the clip inactive
    (small gradients) and active (norm ≫ 1), and with bf16 moments. f32
    to 1e-6 relative; a bf16 moment to one bf16 step (2⁻⁸ relative)."""
    p0, gs = _adamw_case(0, state_dtype, big)
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jadamw_init(jp, state_dtype=jdt)
    tp = _tensors(p0)
    ts = adamw_init(tp, state_dtype=tdt)
    for i, g in enumerate(gs):
        lr = 1e-2 * (i + 1)
        jp, js, jmx = jadamw_update(jp, {k: jnp.asarray(v) for k, v in
                                         g.items()}, js, lr)
        out, ts, mx = adamw_update(tp, _tensors(g), ts, torch.tensor(lr))
        assert out is tp and ts.m["a"].dtype == tdt
        np.testing.assert_allclose(float(mx["grad_norm"]),
                                   float(jmx["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for mine, ref in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            rtol = 2.0 ** -8 if tdt == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(mine.float().numpy(),
                                       np.asarray(ref, np.float32),
                                       rtol=rtol, atol=1e-12)


def test_clip_by_global_norm_matches_jax():
    from repro.optim import clip_by_global_norm as jclip
    _, gs = _adamw_case(1, "float32", True)
    jg, jn = jclip({k: jnp.asarray(v) for k, v in gs[0].items()}, 1.0)
    tg, tn = clip_by_global_norm(_tensors(gs[0]), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in tg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("step", [0, 50, 100, 550, 1000, 1500])
def test_cosine_warmup_matches_jax(step):
    """Warm-up (0, 50), its end (100), the decay (550), the end of the
    decay (1000) and the floor past it (1500)."""
    want = float(jcosine_warmup(jnp.asarray(step), 1e-3, 100, 1000))
    got = cosine_warmup(step, 1e-3, 100, 1000)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
    if step >= 1000:
        assert float(got) == pytest.approx(1e-4, rel=1e-5)


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-1b",
                                  "seamless-m4t-large-v2"])
def test_pipeline_is_bitwise_the_jax_one(arch):
    """Every array of batches 0–4 (with the vision or audio frontend the
    launchers ask for) bitwise the JAX pipeline's, the prefetching
    iterator's stream the same, and the batch specs the same shapes and
    dtypes."""
    cfg = tconfig.reduced_config(tconfig.get_config(arch))
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=3, seed=7,
              frontend_tokens=(cfg.n_frontend_tokens if cfg.frontend ==
                               "vision" else (16 if cfg.enc_layers else 0)),
              d_model=cfg.d_model)
    mine, ref = SyntheticTokens(**kw), JTokens(**kw)
    it = iter(mine)
    for step in range(5):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        n = next(it)
        assert all(np.array_equal(n[k], b[k]) for k in b)
    shape = tconfig.ShapeConfig("t", 16, 3, "train")
    jspec = jmake_batch_specs(jconfig.reduced_config(
        jconfig.get_config(arch)), shape)
    spec = make_batch_specs(cfg, shape)
    assert spec.keys() == jspec.keys()
    for k, v in spec.items():
        assert v.is_meta and tuple(v.shape) == jspec[k].shape
        assert str(v.dtype).replace("torch.", "") == str(jspec[k].dtype)


# -- the checkpoint (twins of tests/test_substrate.py) -------------------------

def _model_and_state(seed=0, arch="dbrx-132b"):
    """A reduced MoE model in bf16 (the MoE archs' param dtype, with the
    f32 router) and bf16 AdamW moments: bf16 and f32 leaves."""
    cfg = tconfig.reduced_config(tconfig.get_config(arch),
                                 param_dtype="bfloat16")
    api = get_model(cfg)
    p = api.train_params(api.init(seed, device="cpu"))
    st = adamw_init(p, state_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(seed + 1)
    for t in list(st.m.values()) + list(st.v.values()):
        t.copy_(torch.randn(t.shape, generator=g))
    return cfg, p, AdamWState(torch.tensor(seed + 3, dtype=torch.int32),
                              st.m, st.v)


def test_checkpoint_roundtrip_bitwise_and_gc(tmp_path):
    """A (module, AdamWState) tree with bf16 and f32 leaves comes back
    bit for bit into a zeroed template of the same structure; ``keep``
    collects the old steps; the manifest names the bf16 leaves."""
    cfg, p, st = _model_and_state()
    assert {w.dtype for w in p.parameters()} == {torch.bfloat16,
                                                 torch.float32}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, (p, st))
    mgr.wait()
    assert mgr.list_steps() == [20, 30]
    _, p2, st2 = _model_and_state(seed=5)
    with torch.no_grad():
        for t in list(p2.parameters()) + list(st2.m.values()):
            t.zero_()
    out = mgr.restore(30, (p2, st2))
    assert out[0] is p2 and out[1] is st2
    for (k, a), (_, b) in zip(ckpt_mod.flatten((p, st)),
                              ckpt_mod.flatten((p2, st2))):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b), k
    import json
    man = json.loads((tmp_path / "step_000000030" / "manifest.json"
                      ).read_text())
    assert {m["dtype"] for m in man["leaves"]} >= {"bfloat16", "float32",
                                                  "int32"}
    assert (tmp_path / "step_000000030" / "COMMITTED").exists()


def test_checkpoint_ignores_uncommitted_and_refuses_a_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.ones(3)}, blocking=True)
    os.makedirs(tmp_path / "step_000000009")          # a torn checkpoint
    assert mgr.latest_step() == 5
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(5, {"y": torch.ones(3)})
    with pytest.raises(ValueError, match="stored"):
        mgr.restore(5, {"x": torch.ones(4)})


def test_checkpoint_writer_error_reaches_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "savez", broken)
    mgr.save(1, {"x": torch.ones(3)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                        # raised once
    assert mgr.latest_step() is None


# -- the loop --------------------------------------------------------------------

def _loop_setup():
    cfg = tconfig.reduced_config(tconfig.get_config("granite-3-2b"))
    api = get_model(cfg)
    shape = tconfig.ShapeConfig("t", 16, 2, "train")
    step = build_train_step(cfg, shape, device="cpu", peak_lr=1e-2)
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=16, global_batch=2)

    def fresh():
        p = api.train_params(api.init(0, device="cpu"))
        return p, adamw_init(p)

    return step, pipe, fresh


def test_train_loop_resumes_exactly(tmp_path):
    """Four steps in one loop against two steps, a checkpoint, and a new
    loop that resumes from it (the pipeline fast-forwarded) for two more:
    the losses and every parameter and moment bitwise equal."""
    step, pipe, fresh = _loop_setup()
    p, o = fresh()
    full = run_train_loop(step, p, o, pipe, TrainLoopConfig(
        total_steps=4, ckpt_every=100, ckpt_dir=str(tmp_path / "a")),
        log=lambda *a: None)
    p, o = fresh()
    half = run_train_loop(step, p, o, pipe, TrainLoopConfig(
        total_steps=2, ckpt_every=2, ckpt_dir=str(tmp_path / "b")),
        log=lambda *a: None)
    logs = []
    p, o = fresh()
    rest = run_train_loop(step, p, o, pipe, TrainLoopConfig(
        total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / "b")),
        log=logs.append)
    assert "[train] resumed from step 2" in logs
    assert half["losses"] + rest["losses"] == full["losses"]
    assert rest["final_step"] == 4 and len(rest["step_s"]) == 2
    for (k, a), (_, b) in zip(
            ckpt_mod.flatten((full["params"], full["opt_state"])),
            ckpt_mod.flatten((rest["params"], rest["opt_state"]))):
        assert torch.equal(a, b), k


def test_train_loop_restarts_and_counts_stragglers(tmp_path):
    """A step that raises at step 7 restarts from the step-5 checkpoint
    and the loop completes; a step 10× slower than the others is counted
    as a straggler (twin of ``test_train_loop_resume_and_straggler_
    accounting``)."""
    step, pipe, fresh = _loop_setup()
    state = {"crashed": False}

    def step_fn(params, opt_state, batch, i):
        if i == 7 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("injected device failure")
        t0 = time.perf_counter()
        out = step(params, opt_state, batch, i)
        if i == 9:
            time.sleep(10 * (time.perf_counter() - t0) + 0.2)
        return out

    logs = []
    p, o = fresh()
    out = run_train_loop(step_fn, p, o, pipe, TrainLoopConfig(
        total_steps=10, ckpt_every=5, ckpt_dir=str(tmp_path),
        log_every=100), log=logs.append)
    assert out["final_step"] == 10 and out["restarts"] == 1
    assert len(out["losses"]) == 12 and np.isfinite(out["losses"][-1])
    assert out["stragglers"] >= 1
    assert any(m.startswith("[train] straggler step 9:") for m in logs)
    assert any("restart #1 from checkpoint 5" in m for m in logs)
    assert CheckpointManager(str(tmp_path)).list_steps() == [5, 10]


def test_train_loop_raises_a_failure_before_the_first_checkpoint(
        tmp_path):
    """AdamW updates in place, so a step that raised may have left the
    state half updated: with no checkpoint to restart from the loop
    raises instead of retrying on it."""
    step, pipe, fresh = _loop_setup()
    state = {"crashed": False}

    def step_fn(params, opt_state, batch, i):
        if i == 1 and not state["crashed"]:
            state["crashed"] = True
            with torch.no_grad():
                next(params.parameters()).add_(1)     # half an update
            raise RuntimeError("injected device failure")
        return step(params, opt_state, batch, i)

    p, o = fresh()
    with pytest.raises(RuntimeError, match="injected device failure"):
        run_train_loop(step_fn, p, o, pipe, TrainLoopConfig(
            total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path)),
            log=lambda *a: None)
    assert CheckpointManager(str(tmp_path)).list_steps() == []


def test_train_loop_default_directory_is_fresh(tmp_path, monkeypatch):
    """Without ``ckpt_dir`` each loop writes into a fresh directory under
    the temporary root, so a second run starts anew (no resume)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    step, pipe, fresh = _loop_setup()
    assert TrainLoopConfig().ckpt_dir is None
    for _ in range(2):
        logs = []
        p, o = fresh()
        out = run_train_loop(step, p, o, pipe,
                             TrainLoopConfig(total_steps=2, ckpt_every=2),
                             log=logs.append)
        assert out["final_step"] == 2 and len(out["losses"]) == 2
        assert not any("resumed" in m for m in logs)
    made = sorted(tmp_path.iterdir())
    assert len(made) == 2 and all(
        CheckpointManager(str(d)).list_steps() == [2] for d in made)


# -- the loss and its gradient against jax.grad, every config --------------------

_CASES = {}


def _frontend_kw(cfg, S_):
    return dict(frontend_tokens=(cfg.n_frontend_tokens
                                 if cfg.frontend == "vision" else
                                 (S_ if cfg.enc_layers else 0)),
                d_model=cfg.d_model)


def _held_mask(cfg, mask, flips, S):
    """The loss mask with every flipped row dropped and, unless its MoE
    layer is the last block (no later layer mixes rows), the rest of its
    sequence."""
    kinds = ttfm.layer_kinds(cfg)
    moe_blocks = [l for l, k in enumerate(kinds) if k.endswith("+moe")]
    mask = mask.copy()
    for row, call in flips.items():
        b, t = divmod(row, S)
        last = moe_blocks[call % len(moe_blocks)] == len(kinds) - 1
        mask[b, t:t + 1 if last else S] = 0.0
    return mask


def _case(arch):
    """(cfg, JAX api and params, the JAX value_and_grad, the batch with
    flipped rows masked, the JAX loss and gradients by name, the port's
    trainable params), built once per module."""
    if arch not in _CASES:
        jcfg = jconfig.reduced_config(jconfig.get_config(arch))
        cfg = tconfig.reduced_config(tconfig.get_config(arch))
        japi, api = jget_model(jcfg), get_model(cfg)
        jparams = japi.init(jax.random.key(0))
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        tp = api.train_params(params_from_jax(tree, cfg, device="cpu"))
        S = SEQ.get(arch, 24)
        batch = SyntheticTokens(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                **_frontend_kw(cfg, S)).batch_at(0)
        vg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss(p, b)))

        def jrun(b):
            jl, jg = vg(jparams, {k: jnp.asarray(v) for k, v in b.items()})
            return float(jl), named_from_jax(
                jax.tree_util.tree_map(np.asarray, jg), cfg)

        if cfg.n_experts:
            with pytest.MonkeyPatch.context() as mp:
                jr, tr = _record_jax(mp, cfg), _record_port(mp)
                jl, jg = jrun(batch)
                with torch.no_grad():
                    api.loss(tp, batch)
                jax.effects_barrier()
            # the JAX recompute calls the recorder again: its first calls
            # are the forward's, one a MoE layer as the port's
            flips = tmoe.route_flips(tr.calls, jr.calls[:len(tr.calls)], S,
                                     f"{arch} loss")
            if flips:
                batch = dict(batch, loss_mask=_held_mask(
                    cfg, batch["loss_mask"], flips, S))
                jl, jg = jrun(batch)
        else:
            jl, jg = jrun(batch)
        _CASES[arch] = (cfg, japi, jparams, batch, jl, jg, api, tp)
    return _CASES[arch]


def _port_grads(api, tp, batch):
    for w in tp.parameters():
        w.grad = None
    loss = api.loss(tp, batch)
    loss.backward()
    return float(loss.detach()), {k: (torch.zeros_like(w) if w.grad is None
                             else w.grad) for k, w in tp.named_parameters()}


def _rel(g, ref):
    g, ref = np.asarray(g, np.float64), np.asarray(ref, np.float64)
    n = np.linalg.norm(ref)
    return float(np.linalg.norm(g - ref) / n) if n else float(
        np.linalg.norm(g) > 0)


def _readings(arch):
    cfg, _, _, batch, jl, jg, api, tp = _case(arch)
    loss, grads = _port_grads(api, tp, batch)
    rel = {k: _rel(g.double().numpy(), jg[k]) for k, g in grads.items()}
    return abs(loss - jl), rel


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``ModelAPI.loss`` and the gradient of every parameter against
    ``jax.value_and_grad`` of the JAX loss (module note)."""
    dl, rel = _readings(arch)
    bound = NOISY.get(arch, 1.0)
    worst = max(rel, key=rel.get)
    print(f"{arch}: |Δloss| {dl:.2e} ({dl / LOSS_TOL:.2f} of the "
          f"tolerance), worst leaf {worst} {rel[worst]:.3f} "
          f"({rel[worst] / GRAD_TOL:.2f}); bound {bound}")
    assert dl <= NOISY_LOSS.get(arch, 1.0) * LOSS_TOL
    assert rel[worst] <= bound * GRAD_TOL, (worst, rel[worst])


FAULTS = [("dropped_aux", "dbrx-132b"), ("noncausal_bwd", "granite-3-2b"),
          ("zero_ds", "granite-3-2b"), ("xlstm_no_detach", "xlstm-125m")]


def _plant(fault, mp):
    if fault == "dropped_aux":
        def lm_loss(p, cfg, b):
            logits, _ = ttfm.lm_forward(p, cfg, b["tokens"],
                                        frontend=b.get("frontend"))
            return cross_entropy(logits, b["labels"], b.get("loss_mask"))
        mp.setattr(ttfm, "lm_loss", lm_loss)
    elif fault == "noncausal_bwd":
        mp.setattr(ops, "_flash_attention_bwd",
                   lambda q, k, v, o, do, lse, causal:
                   flash_attention_bwd_ref(q, k, v, o, do, lse, False))
    elif fault == "zero_ds":
        real = ops._rmsnorm_bwd
        mp.setattr(ops, "_rmsnorm_bwd", lambda x, s, dy, eps: (
            real(x, s, dy, eps)[0], torch.zeros(s.shape)))
    elif fault == "xlstm_no_detach":
        real = txlstm._gates

        def gates(p, cfg, x):
            q, k, v, _, log_f = real(p, cfg, x)
            i_raw = linear(p.wi, x).to(torch.float32)
            return q, k, v, i_raw - i_raw.max(), log_f
        mp.setattr(txlstm, "_gates", gates)


@pytest.mark.parametrize("fault,arch", FAULTS)
def test_tolerances_catch_planted_faults(fault, arch, monkeypatch):
    """Each planted fault reads beyond twice the tolerance: the dropped
    aux on the loss, the others on the worst gradient leaf."""
    _case(arch)
    _plant(fault, monkeypatch)
    dl, rel = _readings(arch)
    worst = max(rel, key=rel.get)
    reading = dl / LOSS_TOL if fault == "dropped_aux" else \
        rel[worst] / GRAD_TOL
    print(f"{fault} on {arch}: {reading:.1f} × the tolerance ({worst})")
    assert reading > 2.0


def test_xlstm_input_gate_max_takes_no_gradient(monkeypatch):
    """The repaired stop-gradient (``xlstm.py:111``, as
    ``repro/models/xlstm.py:104``): every ``wi`` gradient within the
    tolerance of ``jax.grad``'s; with the max's gradient let through, the
    ``wi`` leaves read past it."""
    _, rel = _readings("xlstm-125m")
    wi = {k: v for k, v in rel.items() if k.endswith("mixer.wi.w")}
    assert wi and max(wi.values()) <= GRAD_TOL
    _plant("xlstm_no_detach", monkeypatch)
    _, bad = _readings("xlstm-125m")
    assert max(bad[k] for k in wi) > 2 * GRAD_TOL


def test_train_step_matches_the_jax_step():
    """One ``build_train_step`` step against the JAX package's own
    ``launch.steps.build_train_step`` (a 1×1 mesh) from the same
    parameters and AdamW state — the JAX state after two JAX steps,
    carried over by ``adamw_state_from_jax``, at step 2: the loss, the
    gradient norm, and every leaf of the new ``m``, ``v`` and of the
    parameter change held to the gradient tolerances."""
    arch = "granite-3-2b"
    cfg, japi, jparams, _, _, _, api, _ = _case(arch)
    jcfg = jconfig.reduced_config(jconfig.get_config(arch))
    shape = jconfig.ShapeConfig("t", S, B, "train")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    fn, _, ins, outs = jsteps.build_train_step(jcfg, shape, mesh)
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=S, global_batch=B)
    with mesh:
        jstep = jax.jit(fn, in_shardings=ins, out_shardings=outs)
        jp, jo = jparams, jadamw_init(jparams)
        for i in range(2):
            jp, jo, _, _ = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                          pipe.batch_at(i).items()},
                                 jnp.asarray(i))
        batch = pipe.batch_at(2)
        np_tree = jax.tree_util.tree_map(np.asarray, (jp, jo))
        jp2, jo2, jl, jmx = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, jnp.asarray(2))
    tp = api.train_params(params_from_jax(np_tree[0], cfg, device="cpu"))
    to = adamw_state_from_jax(np_tree[1], cfg, device="cpu")
    before = {k: w.detach().clone() for k, w in tp.named_parameters()}
    step = build_train_step(cfg, tconfig.ShapeConfig("t", S, B, "train"),
                            device="cpu")
    tp, to, loss, mx = step(tp, to, batch, 2)
    assert int(to.step) == 3 and all(w.grad is None for w in tp.parameters())
    assert abs(float(loss) - float(jl)) <= LOSS_TOL
    assert abs(float(mx["grad_norm"]) / float(jmx["grad_norm"]) - 1) \
        <= GRAD_TOL
    jnew = named_from_jax(jax.tree_util.tree_map(np.asarray, jp2), cfg)
    jold = named_from_jax(np_tree[0], cfg)
    jm = named_from_jax(jax.tree_util.tree_map(np.asarray, jo2.m), cfg)
    jv = named_from_jax(jax.tree_util.tree_map(np.asarray, jo2.v), cfg)
    worst = {}
    for k, w in tp.named_parameters():
        worst[f"d{k}"] = _rel((w.detach() - before[k]).double().numpy(),
                              jnew[k].astype(np.float64) - jold[k])
        worst[f"m {k}"] = _rel(to.m[k].double().numpy(), jm[k])
        worst[f"v {k}"] = _rel(to.v[k].double().numpy(), jv[k])
    k = max(worst, key=worst.get)
    print(f"train step: |Δloss| {abs(float(loss) - float(jl)):.2e}, "
          f"worst leaf {k} {worst[k]:.3f}")
    assert worst[k] <= GRAD_TOL, (k, worst[k])


# -- the launcher and the example ------------------------------------------------

def test_checkpoint_save_snapshots_the_tree(tmp_path, monkeypatch):
    """An async save holds the values of the moment it was called: the
    leaves changed in place (as AdamW changes them) while the writer is
    still busy come back as they were, bf16 and f32 alike."""
    _, p, st = _model_and_state()
    before = [(k, t.clone()) for k, t in ckpt_mod.flatten((p, st))]
    go = threading.Event()
    savez = np.savez

    def held(*a, **k):
        go.wait(30)
        return savez(*a, **k)

    monkeypatch.setattr(ckpt_mod.np, "savez", held)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (p, st))
    with torch.no_grad():
        for _, t in ckpt_mod.flatten((p, st)):
            t.add_(1)
    go.set()
    mgr.wait()
    mgr.restore(1, (p, st))
    for (k, a), (_, b) in zip(before, ckpt_mod.flatten((p, st))):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b), k


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_train_launcher_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU exits 0 with the
    JAX launcher's last line (a fresh ``--ckpt``: the launcher resumes
    from whatever it finds there; train_4k's batch and sequence cut to
    (2, 64) for the host), then resumes from its last checkpoint; with
    ``--mesh 1x2`` it trains over two gloo ranks."""
    args = ["-m", "repro_torch.launch.train", "--arch", "granite-3-2b",
            "--scale", "reduced", "--device", "cpu", "--steps", "3",
            "--ckpt", str(tmp_path), "--batch", "2", "--seq", "64"]
    r = _run(*args)
    assert r.returncode == 0, r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done: final step 3, last loss ")
    assert last.endswith("stragglers=0, restarts=0")
    assert CheckpointManager(str(tmp_path)).list_steps() == [3]
    r = _run(*args[:-7], "5", *args[-6:])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[train] resumed from step 3" in r.stdout
    assert "[train] done: final step 5" in r.stdout
    r = _run("-m", "repro_torch.launch.train", "--arch", "granite-3-2b",
             "--scale", "reduced", "--device", "cpu", "--mesh", "1x2",
             "--steps", "1", "--batch", "2", "--seq", "64", "--ckpt",
             str(tmp_path / "mesh"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh 1x2: 2 gloo ranks" in r.stdout
    assert r.stdout.strip().splitlines()[-1].startswith(
        "[train] done: final step 1, last loss ")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_launcher_every_arch(arch, tmp_path, capsys):
    """``launch.train.main`` in-process for every config at its reduced
    size, two steps of (1, 16): the JAX launcher's last line with a
    finite loss; the AdamW moments in the param dtype's state dtype."""
    ttrain.main(["--arch", arch, "--scale", "reduced", "--device", "cpu",
                 "--steps", "2", "--batch", "1", "--seq", "16", "--ckpt",
                 str(tmp_path)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[train] done: final step 2, last loss ")
    assert np.isfinite(float(last.split("last loss ")[1].split(",")[0]))
    cfg = tconfig.get_config(arch)
    assert state_dtype_of(cfg) == (torch.bfloat16 if cfg.param_dtype ==
                                   "bfloat16" else torch.float32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_train_launcher_reduced_scale_fits_the_kernels(arch):
    """``--scale reduced`` is ``reduced_config`` on the CPU; on the card it
    keeps d_model 512 in heads of 64, a width the flash kernels take
    (they take hd 64 and 128, not the host size's 16)."""
    cpu = ttrain.train_config(arch, "reduced", torch.device("cpu"))
    card = ttrain.train_config(arch, "reduced", torch.device("cuda"))
    full = ttrain.train_config(arch, "full", torch.device("cuda"))
    assert cpu == tconfig.reduced_config(tconfig.get_config(arch))
    assert (card.d_model, card.n_heads, card.hd) == (512, 8, 64)
    assert card.n_layers == cpu.n_layers and card.vocab == cpu.vocab
    assert full == tconfig.get_config(arch)
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert card.hd in HEAD_DIMS and cpu.hd not in HEAD_DIMS


def test_train_launcher_without_ckpt_starts_fresh(tmp_path, monkeypatch,
                                                  capsys):
    """Without ``--ckpt`` the launcher writes into a fresh temporary
    directory, which it prints, and never resumes an earlier run."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "granite-3-2b", "--scale", "reduced", "--device",
            "cpu", "--steps", "2", "--batch", "1", "--seq", "16"]
    dirs = []
    for _ in range(2):
        ttrain.main(argv)
        out = capsys.readouterr().out
        assert "resumed" not in out
        dirs += [ln.split("checkpoints under ")[1]
                 for ln in out.splitlines() if "checkpoints under" in ln]
    assert len(set(dirs)) == 2 and all(
        os.path.dirname(d) == str(tmp_path) for d in dirs)


def test_train_example_on_the_cpu(tmp_path):
    """``repro_torch.examples.train_lm`` (the twin of
    ``examples/train_lm.py``) at a host size: the loss falls."""
    r = _run("-m", "repro_torch.examples.train_lm", "--device", "cpu",
             "--steps", "40", "--layers", "1", "--width", "64", "--seq",
             "32", "--batch", "4", "--ckpt", str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "loss " in r.stdout.splitlines()[-1]


def test_train_stack_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.optim, repro_torch.data\n"
            "import repro_torch.checkpoint, repro_torch.runtime.train_loop\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.examples.train_lm\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    r = _run("-c", code)
    assert r.returncode == 0, r.stderr[-3000:]


def test_step_builders_and_input_specs_match_jax():
    """``launch.steps.input_specs`` gives the JAX stand-ins' shapes and
    dtypes for a train, a prefill and a decode shape (as ``meta``
    tensors), and the prefill and decode steps are ``ModelAPI.prefill``
    and ``decode_step`` under ``torch.no_grad``."""
    from repro_torch.launch import steps as tsteps
    for arch in ("granite-3-2b", "jamba-1.5-large-398b",
                 "seamless-m4t-large-v2"):
        cfg = tconfig.reduced_config(tconfig.get_config(arch))
        jcfg = jconfig.reduced_config(jconfig.get_config(arch))
        for mode in ("train", "prefill", "decode"):
            shape = tconfig.ShapeConfig("t", 16, 2, mode)
            mine = jax.tree_util.tree_leaves(
                tsteps.input_specs(cfg, shape))
            ref = jax.tree_util.tree_leaves(jsteps.input_specs(
                jcfg, jconfig.ShapeConfig("t", 16, 2, mode), None))
            assert [(tuple(m.shape), str(m.dtype).replace("torch.", ""))
                    for m in mine] == [(tuple(r.shape), str(r.dtype))
                                       for r in ref], (arch, mode)
            assert all(m.is_meta for m in mine)
    cfg = tconfig.reduced_config(tconfig.get_config("granite-3-2b"))
    api = get_model(cfg)
    p = api.train_params(api.init(0, device="cpu"))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8))
    shape = tconfig.ShapeConfig("t", 8, 2, "prefill")
    last = tsteps.build_prefill_step(cfg, shape, "cpu")(p, {"tokens": toks})
    assert not last.requires_grad
    with torch.no_grad():
        assert torch.equal(last, api.prefill(p, {"tokens": toks}))
    cache = api.init_cache(2, 8, device="cpu")
    logits, _ = tsteps.build_decode_step(cfg, shape, "cpu")(
        p, torch.as_tensor(toks[:, 0]), torch.zeros(2, dtype=torch.long),
        cache)
    assert logits.shape == (2, cfg.vocab_padded) and not logits.requires_grad


def test_training_entry_points_default_to_the_card():
    """Without a card and without ``device="cpu"`` the training entry
    points raise; nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfig.reduced_config(tconfig.get_config("granite-3-2b"))
    shape = tconfig.ShapeConfig("t", 16, 2, "train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(cfg, shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "granite-3-2b", "--scale", "reduced",
                     "--steps", "1"])
