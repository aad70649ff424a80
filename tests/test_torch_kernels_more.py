"""The port's trsm, RMSNorm and flash attention against the JAX
package's, on the CPU.

On a CPU tensor the port's ``ops`` run each kernel's plain PyTorch
version; here they are held against the Pallas kernels in interpret mode
(``*_pallas(..., interpret=True)``) on the shapes and tolerances of
``tests/test_kernels.py``, trsm in f64 against scipy, and flash attention
against the LM stack's chunked attention (``repro.models.attention``).
The CUDA kernels themselves are compared with the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.trsm import trsm_pallas
from repro_torch.kernels import bench
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(7)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _sdpa(q, k, v, causal):
    """``F.scaled_dot_product_attention`` in f32 on (B, S, H, hd)."""
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(q, k, v,
                                          is_causal=causal).transpose(1, 2)


def _pair(x, name):
    """One numpy array as the same values in JAX and in torch."""
    jd, td = DTYPES[name]
    x = x.astype(np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("m,k", [(64, 32), (100, 64), (130, 48)])
def test_trsm_matches_pallas(m, k):
    u0 = np.triu(RNG.standard_normal((k, k))) + 4 * np.eye(k)
    b0 = RNG.standard_normal((m, k))
    ju, tu = _pair(u0, "float32")
    jb, tb = _pair(b0, "float32")
    expect = np.asarray(trsm_pallas(jb, ju, interpret=True))
    out = tops.trsm(tb, tu)
    assert out.dtype == torch.float32 and out.shape == (m, k)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-3, atol=1e-3)
    # residual: X @ U == B
    np.testing.assert_allclose(out.numpy() @ tu.numpy(), tb.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k", [(64, 32), (96, 96), (130, 256)])
def test_trsm_f64_matches_scipy(m, k):
    u = np.triu(RNG.standard_normal((k, k))) / np.sqrt(k) + 2 * np.eye(k)
    b = RNG.standard_normal((3, m, k))
    out = tops.trsm(torch.from_numpy(b), torch.from_numpy(u))
    assert out.dtype == torch.float64 and out.shape == b.shape
    for z in range(3):
        want = sla.solve_triangular(u, b[z].T, lower=False, trans="T").T
        np.testing.assert_allclose(out[z].numpy(), want, rtol=0, atol=1e-12)
    # one U per batch item
    us = np.stack([u, 2 * u, u.T.T])
    out = tops.trsm(torch.from_numpy(b), torch.from_numpy(us))
    np.testing.assert_allclose(out[1].numpy() @ us[1], b[1], atol=1e-12)


@pytest.mark.parametrize("rows,d", [(64, 256), (100, 512), (7, 1024)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_pallas(rows, d, dtype):
    jx, tx = _pair(RNG.standard_normal((rows, d)), dtype)
    js, ts = _pair(RNG.standard_normal((d,)), dtype)
    expect = np.asarray(rmsnorm_pallas(jx, js, interpret=True), np.float32)
    out = tops.rmsnorm(tx, ts)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (rows, d)
    np.testing.assert_allclose(out.float().numpy(), expect, **_tol(dtype))


def test_rmsnorm_rounds_once_like_the_kernel():
    """The plain version keeps f32 to the end (the kernel's arithmetic),
    so in f32 it is the Pallas kernel to rounding, and leading dims pass
    through."""
    jx, tx = _pair(RNG.standard_normal((2, 3, 256)), "float32")
    js, ts = _pair(RNG.standard_normal((256,)), "float32")
    expect = np.asarray(rmsnorm_pallas(jx.reshape(6, 256), js,
                                       interpret=True)).reshape(2, 3, 256)
    np.testing.assert_allclose(tops.rmsnorm(tx, ts).numpy(), expect,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 64), (2, 256, 4, 64),
                                      (1, 512, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_pallas(B, S, H, hd, causal, dtype):
    pairs = [_pair(RNG.standard_normal((B, S, H, hd)), dtype)
             for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = pairs
    expect = np.asarray(flash_attention_pallas(jq, jk, jv, causal=causal,
                                               bq=128, bk=128,
                                               interpret=True), np.float32)
    out = tops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, S, H, hd)
    tol = 3e-2 if dtype == "bfloat16" else 3e-3
    np.testing.assert_allclose(out.float().numpy(), expect, rtol=tol,
                               atol=tol)
    # and against the library's attention on the same values, in f32
    ref = _sdpa(tq, tk, tv, causal)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=tol, atol=tol)


def test_flash_attention_matches_model_attention():
    """The LM stack's chunked attention and the port's flash attention
    agree on the same inputs (f32)."""
    from repro.models.attention import _flash
    x = RNG.standard_normal((2, 256, 4, 64)).astype(np.float32)
    expect = np.asarray(_flash(jnp.asarray(x), jnp.asarray(x),
                               jnp.asarray(x), 0, True, 64, 64))
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tops.flash_attention(t, t, t).numpy(),
                               expect, atol=2e-3)
    # the plain version (one tile) is the oracle in ``ref``, and agrees
    # with the library's attention
    assert tfa.flash_attention_plain is tref.flash_attention_ref
    np.testing.assert_allclose(tfa.flash_attention_plain(t, t, t).numpy(),
                               _sdpa(t, t, t, True).numpy(), atol=1e-5)


@pytest.mark.parametrize("call,exc", [
    (lambda: tops.trsm(torch.ones(4, 3), torch.eye(4)), ValueError),
    (lambda: tops.trsm(torch.ones(4, 3), torch.eye(3, dtype=torch.float64)),
     TypeError),
    (lambda: tops.trsm(torch.ones(2, 4, 3), torch.ones(3, 3, 3)),
     ValueError),
    (lambda: tops.trsm(torch.ones(4, 3, dtype=torch.int32),
                       torch.eye(3, dtype=torch.int32)), TypeError),
    (lambda: tops.rmsnorm(torch.ones(4, 8), torch.ones(4)), ValueError),
    (lambda: tops.flash_attention(torch.ones(1, 8, 2, 64),
                                  torch.ones(1, 8, 1, 64),
                                  torch.ones(1, 8, 1, 64)), ValueError),
    (lambda: tops.flash_attention(torch.ones(1, 8, 2, 64),
                                  torch.ones(1, 8, 2, 64),
                                  torch.ones(1, 8, 2, 64,
                                             dtype=torch.bfloat16)),
     TypeError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc):
    with pytest.raises(exc):
        call()


def test_ops_names_cover_the_jax_package():
    assert set(jops.__all__) - {"use_interpret"} <= set(tops.__all__)


def test_bench_twin_rows_on_the_cpu():
    held = []

    def check(name, out, plain):
        assert out.shape == plain.shape and out.dtype == plain.dtype
        held.append((name, (out - plain).abs().max().item()))
    rows = bench.run(device="cpu", check=check)
    names = ["kernel/block_gemm", "kernel/flash_attention", "kernel/rmsnorm",
             "kernel/trsm"]
    assert [r["name"] for r in rows] == names
    assert all(r["us_per_call"] > 0 for r in rows)
    # each op's output is handed over beside its plain version's
    assert held == [(n.split("/")[1], 0.0) for n in names]


def test_bench_twin_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run()


def test_kernel_modules_import_without_nvcc():
    """Importing the new kernel modules builds nothing and looks for no
    toolkit: the build happens at the first CUDA launch."""
    code = ("import repro_torch.kernels.ops, repro_torch.kernels.bench\n"
            "import repro_torch.kernels.launch_cost\n"
            "import repro_torch.kernels.trsm_sweep\n"
            "import repro_torch.kernels._build as b\n"
            "from repro_torch.kernels import trsm, rmsnorm, "
            "flash_attention\n"
            "for m in (trsm, rmsnorm, flash_attention):\n"
            "    assert m._fn is None and m.launches == 0\n"
            "assert not b._libs\n"
            "print('ok')")
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "PYTHONPATH": "src"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
