"""The backward kernels' plain versions and the differentiable ops on the
CPU (no JAX needed).

Each plain backward (``kernels/ref.py``: ``flash_attention_bwd_ref``,
``rmsnorm_bwd_ref``, explicit formulas) is held in f64 to
``torch.autograd`` of its plain forward within 1e-12 (× max|grad|, and
at most 1e-12 absolute on O(1) inputs), and the autograd functions pass
``torch.autograd.gradcheck`` at a tiny size. The rest: the ops take the
autograd functions only when a gradient is needed (otherwise the
forward's bits, no log-sum-exp); the backward kernels' plans (pure
Python); and block rematerialisation, which must give every family the
same loss and gradients, bit for bit, as no remat (MoE routing, the
sLSTM loop and mamba's segment sum run twice).

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_grad.py
"""
import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.configs import ALL_ARCHS
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import rmsnorm_bwd as rb
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers

F64 = torch.float64


def _close12(got, want, what):
    err = (got - want).abs().max().item()
    top = max(1.0, want.abs().max().item())
    assert err <= 1e-12 * top, f"{what}: {err:.3e} (max|want| {top:.3e})"


@pytest.mark.parametrize("S", [37, 64, 70, 130])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_backward_is_autograd_of_the_plain_forward(S, hd,
                                                               causal):
    """dq, dk, dv of ``flash_attention_bwd_ref`` (from the forward's own
    log-sum-exp) against ``torch.autograd`` of ``flash_attention_ref`` in
    f64, S a multiple of the kernels' 64-row tile or not."""
    g = torch.Generator().manual_seed(S * hd + causal)
    q, k, v = (torch.randn(2, S, 3, hd, dtype=F64, generator=g
                           ).requires_grad_() for _ in range(3))
    dout = torch.randn(2, S, 3, hd, dtype=F64, generator=g)
    out, lse = ref.flash_attention_ref(q, k, v, causal, lse=True)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      out.detach(), dout, lse.detach(),
                                      causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close12(a, b, name)


@pytest.mark.parametrize("shape", [(5, 7, 64), (3, 128), (1, 1001),
                                   (4, 2, 3, 2048)])
def test_rmsnorm_plain_backward_is_autograd_of_the_plain_forward(shape):
    g = torch.Generator().manual_seed(shape[-1])
    x = torch.randn(shape, dtype=F64, generator=g).requires_grad_()
    s = torch.randn(shape[-1], dtype=F64, generator=g).requires_grad_()
    dy = torch.randn(shape, dtype=F64, generator=g)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, s), (x, s), dy)
    dx, ds = ref.rmsnorm_bwd_ref(x.detach(), s.detach(), dy)
    assert ds.dtype == F64 and ds.shape == s.shape
    _close12(dx, want[0], "dx")
    _close12(ds, want[1], "ds")


def test_gradcheck_of_the_autograd_functions():
    """``torch.autograd.gradcheck`` (finite differences) of the ops with
    inputs that need a gradient: flash causal and not, and RMSNorm."""
    g = torch.Generator().manual_seed(0)
    qkv = tuple(torch.randn(1, 5, 2, 4, dtype=F64, generator=g
                            ).requires_grad_() for _ in range(3))
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda q, k, v: ops.flash_attention(q, k, v, causal), qkv)
    xs = (torch.randn(3, 6, dtype=F64, generator=g).requires_grad_(),
          torch.randn(6, dtype=F64, generator=g).requires_grad_())
    assert torch.autograd.gradcheck(lambda x, s: ops.rmsnorm(x, s), xs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_take_the_autograd_functions_only_for_a_gradient(dtype,
                                                             monkeypatch):
    """Without a gradient (no input needing one, or ``torch.no_grad``)
    the ops call the forward as before: no log-sum-exp is computed, and
    the output is the bits of the plain forward. With one, the forward's
    output is the same bits and the backward is the backward wrapper's
    (on the CPU its plain version; no launch counted)."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 70, 3, 64, generator=g).to(dtype)
               for _ in range(3))
    x = torch.randn(9, 128, generator=g).to(dtype)
    s = torch.randn(128, generator=g).to(dtype)
    asked = []
    real = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **kw: asked.append(kw.get("lse"))
                        or real(*a, **kw))
    plain = ref.flash_attention_ref(q, k, v, True)
    assert torch.equal(ops.flash_attention(q, k, v), plain)
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(qg, k, v), plain)
    assert asked == [False, False]
    counts = (fa.launches, fb.launches, rk.launches, rb.launches)
    out = ops.flash_attention(qg, k, v)
    assert asked[-1] is True and torch.equal(out.detach(), plain)
    dout = torch.randn(out.shape, generator=g).to(dtype)
    out.backward(dout)
    _, lse = ref.flash_attention_ref(q, k, v, True, lse=True)
    assert torch.equal(qg.grad, ref.flash_attention_bwd_ref(
        q, k, v, plain, dout, lse, True)[0])
    xg, sg = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = ops.rmsnorm(xg, sg)
    assert torch.equal(y.detach(), ref.rmsnorm_ref(x, s))
    dy = torch.randn(y.shape, generator=g).to(dtype)
    y.backward(dy)
    dx, ds = ref.rmsnorm_bwd_ref(x, s, dy)
    assert torch.equal(xg.grad, dx) and torch.equal(sg.grad, ds.to(dtype))
    assert (fa.launches, fb.launches, rk.launches, rb.launches) == counts


def test_backward_wrappers_check_their_inputs():
    x = torch.zeros(2, 8, 3, 64)
    lse = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="lse"):
        fb.flash_attention_bwd(x, x, x, x, x, lse[:, :2])
    with pytest.raises(ValueError, match="one shape"):
        fb.flash_attention_bwd(x, x, x, x, x[:, :4], lse)
    with pytest.raises(ValueError, match="scale"):
        rb.rmsnorm_bwd(torch.zeros(4, 8), torch.zeros(7), torch.zeros(4, 8))


# -- the backward kernels' plans (pure Python) ----------------------------------

@pytest.mark.parametrize("hd,t", [(64, 64), (128, 32)])
def test_flash_bwd_plan(hd, t):
    """bf16 on the tensor cores (wgmma fed by TMA only when every operand
    is 16-byte aligned, else mma.sync on guarded loads), f32 on the FMA
    units; the tiles by head width; the shared memory within the card's
    227 KB."""
    p = fb.plan(2, 4096, 32, hd, torch.bfloat16)
    keys = 128 if hd == 64 else 64
    assert (p.variant, p.bq, p.bk) == ("wgmma_tma", 64, 64)
    assert (p.warpgroups, p.threads, p.stages) == (2, 384, 4 if hd == 64
                                                   else 3)
    assert p.dkdv_tile == (keys, 64) and p.dq_tile == (128, 64)
    assert p.dkdv_grid == (64, 4096 // keys) and p.dq_grid == (64, 32)
    assert max(p.dkdv_smem, p.dq_smem) <= 227 * 1024
    tile = 64 * hd * 2
    assert p.dq_smem >= 2 * 2 * tile + 2 * p.stages * tile
    assert p.dkdv_smem >= 2 * keys // 64 * tile + 2 * p.stages * tile
    g = fb.plan(2, 4096, 32, hd, torch.bfloat16, addrs=(0, 2) + (0,) * 6)
    assert (g.variant, g.bq, g.bk) == ("hmma_guarded", t, t)
    assert g.dkdv_grid == g.dq_grid == (64, 64)
    assert g.dq_smem < g.dkdv_smem <= 227 * 1024
    odd = [(4096 * 32 * hd, 32 * hd + 1, hd)] * 8
    assert fb.plan(2, 4096, 32, hd, torch.bfloat16, odd
                   ).variant == "hmma_guarded"
    f = fb.plan(1, 200, 3, hd, torch.float32)
    assert (f.variant, f.bq, f.bk) == ("fma_f32", 64, t)
    assert f.dkdv_grid == (3, -(-200 // t)) and f.dq_grid == (3, 4)
    assert f.dq_smem < f.dkdv_smem <= 227 * 1024
    with pytest.raises(ValueError, match="hd"):
        fb.plan(1, 64, 1, 32, torch.bfloat16)
    with pytest.raises(TypeError):
        fb.plan(1, 64, 1, 64, torch.float64)


@pytest.mark.parametrize("B,S,H", [(2, 4096, 32), (1, 333, 3), (3, 128, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_order(B, S, H, causal):
    """Causal dQ blocks take every q tile once a (b, h), the last (whose
    key loop is the longest) first; without the mask, in order."""
    p = fb.plan(B, S, H, 64, torch.bfloat16, causal=causal)
    order = p.dq_order()
    nbh, nq = p.dq_grid
    assert (nbh, nq) == (B * H, -(-S // 128)) and p.heavy_first == causal
    assert len(order) == nbh * nq
    for bh in range(nbh):
        assert sorted(order[bh::nbh]) == list(range(nq))
    first = order[:nbh]
    assert first == [nq - 1 if causal else 0] * nbh
    assert order[-1] == (0 if causal else nq - 1)
    assert not fb.plan(B, S, H, 64, torch.bfloat16, addrs=(2,) + (0,) * 7,
                       causal=causal).heavy_first


def _check_map(m, shape, elt=2):
    B, S, H, hd = shape
    assert m.dims == (hd, H, S, B)
    assert all(x % 16 == 0 and 0 < x < 2 ** 40 for x in m.strides)
    assert all(1 <= x <= 256 for x in m.box)
    assert m.box[0] * elt <= 128 and m.box[0] * elt % 16 == 0
    assert m.box[1] == m.box[3] == 1 and m.box[2] == 64
    assert len(m.args()) == 11


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_tensor_maps(hd):
    """The TMA maps of the wgmma route: rank 4 (hd, H, S, B) with the
    caller's strides in bytes, on a packed-qkv view (row stride 3·H·hd)
    and on a local shard of a head-sharded tensor (heads 2..5 of 8: a row
    stride of 8·hd, the base 2·hd in); 64-column boxes (one 128-byte
    swizzle atom) of 64 rows."""
    B, S, H = 2, 333, 3
    qkv = torch.zeros(B, S, 3, H, hd, dtype=torch.bfloat16)
    for i, t in enumerate(qkv.unbind(2)):
        m = fb.tensor_map(tuple(t.shape), t.stride())
        _check_map(m, t.shape)
        assert m.strides == (hd * 2, 3 * H * hd * 2, S * 3 * H * hd * 2)
        assert (t.data_ptr() - qkv.data_ptr()) % 16 == 0
    full = torch.zeros(B, S, 8, hd, dtype=torch.bfloat16)
    shard = full[:, :, 2:6]
    m = fb.tensor_map(tuple(shard.shape), shard.stride())
    _check_map(m, shard.shape)
    assert m.strides == (hd * 2, 8 * hd * 2, S * 8 * hd * 2)
    strides = [shard.stride()[:3]] * 8
    addrs = [shard.data_ptr() - full.data_ptr()] * 8
    assert fb.plan(B, S, 4, hd, torch.bfloat16, strides, addrs
                   ).variant == "wgmma_tma"
    # an extent of 1 takes a packed stride whatever the caller's
    one = fb.tensor_map((1, 1, 1, hd), (7, 5, 3, 1))
    assert one.strides == (hd * 2, hd * 2, hd * 2)


@pytest.mark.parametrize("rows,d,dtype,g,ppt", [
    (8192, 2048, torch.bfloat16, 256, 1), (8192, 2048, torch.float32, 256, 2),
    (262144, 64, torch.bfloat16, 8, 1), (4096, 128, torch.float32, 32, 1),
    (7, 1001, torch.bfloat16, 256, 4), (5, 8192, torch.float32, 256, 8),
    (33, 6144, torch.bfloat16, 256, 4)])
def test_rmsnorm_bwd_plan(rows, d, dtype, g, ppt):
    """Threads a row, packs a thread, and rows a block: every row in one
    block, a block's rows a multiple of the rows it takes a step, about
    four blocks an SM when there are rows enough."""
    p = rb.plan(rows, d, dtype)
    assert (p.g, p.ppt) == (g, ppt)
    assert p.g * p.ppt * p.width >= d
    per = rb.THREADS // p.g if p.g <= 32 else 1
    assert p.rpb % per == 0 and p.blocks * p.rpb >= rows
    assert (p.blocks - 1) * p.rpb < rows
    assert p.blocks <= rb.BLOCKS_PER_SM * rb.SMS
    if d <= rb.THREADS * max(rb.PPTS):           # single-element packs
        assert not rb.plan(rows, d, dtype, aligned=False).vec


def test_rmsnorm_bwd_plan_refuses_too_wide_a_row():
    with pytest.raises(ValueError, match="at most"):
        rb.plan(4, 8193, torch.float32, aligned=False)


# -- block rematerialisation -------------------------------------------------------

def _grads(cfg, batch):
    api = get_model(cfg)
    p = api.train_params(api.init(0, device="cpu"))
    loss = api.loss(p, batch)
    loss.backward()
    return loss.detach(), {k: w.grad for k, w in p.named_parameters()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_block_remat_gives_the_same_bits(arch, monkeypatch):
    """The loss and every gradient with ``remat="block"`` (one checkpoint
    a layer group, recomputed in the backward) bitwise those of
    ``remat="none"``; remat is on only when a gradient is taken."""
    import dataclasses
    from repro_torch.models import transformer as ttfm
    from torch.utils import checkpoint as ckpt
    cfg = tconfig.reduced_config(tconfig.get_config(arch))
    S = 64 if cfg.xlstm_pattern else 16
    batch = SyntheticTokens(
        vocab=cfg.vocab, seq_len=S, global_batch=2, seed=3,
        frontend_tokens=(cfg.n_frontend_tokens if cfg.frontend == "vision"
                         else (S if cfg.enc_layers else 0)),
        d_model=cfg.d_model).batch_at(0)
    assert cfg.remat == "block"
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ttfm, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, g = _grads(cfg, batch)
    groups = (cfg.enc_layers + cfg.n_layers if cfg.enc_layers
              else cfg.n_layers // cfg.layer_group)
    assert len(calls) == groups
    loss0, g0 = _grads(dataclasses.replace(cfg, remat="none"), batch)
    assert len(calls) == groups and torch.equal(loss, loss0)
    assert all(torch.equal(g[k], g0[k]) for k in g), arch
    api = get_model(cfg)
    with torch.no_grad():
        api.loss(api.train_params(api.init(0, device="cpu")), batch)
    api.loss(api.init(0, device="cpu"), batch)
    assert len(calls) == groups


def test_trainable_params_serve_the_same_bits():
    """A trainable model's prefill equals the plain model's bit for bit,
    and its serving copy needs no gradient."""
    cfg = tconfig.reduced_config(tconfig.get_config("granite-3-2b"))
    api = get_model(cfg)
    p = api.init(0, device="cpu")
    t = api.train_params(api.init(0, device="cpu"))
    assert not any(w.requires_grad for w in p.parameters())
    assert all(w.requires_grad for w in t.parameters())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    with torch.no_grad():
        assert torch.equal(api.prefill(p, {"tokens": toks}),
                           api.prefill(t, {"tokens": toks}))
    sp = api.serving_params(t)
    assert not any(w.requires_grad for w in sp.parameters())
    assert tlayers.plain_route() is False
