"""The port's block GEMM against the JAX package's, on the CPU.

On a CPU tensor the port's wrappers run the kernel's plain PyTorch
version; here it is held against the Pallas kernel in interpret mode
(``block_gemm_pallas(..., interpret=True)``) on the shapes and
tolerances of ``tests/test_kernels.py``, and the sweep's level/round
GEMMs against ``repro.kernels.ops`` in f64 within 1e-12. The CUDA kernel
itself is compared with the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.block_gemm import block_gemm_pallas
from repro_torch.kernels import block_gemm as tbg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(42)
SHAPES = [(64, 64, 64), (128, 256, 128), (200, 130, 70), (33, 17, 129)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _pair(x, name):
    """One numpy array as the same values in JAX and in torch (bf16:
    both round the f32 values to nearest even)."""
    jd, td = DTYPES[name]
    x = x.astype(np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_gemm_matches_pallas(m, k, n, dtype):
    ja, ta = _pair(RNG.standard_normal((m, k)), dtype)
    jb, tb = _pair(RNG.standard_normal((k, n)), dtype)
    expect = np.asarray(block_gemm_pallas(ja, jb, interpret=True),
                        np.float32)
    out = tops.block_gemm(ta, tb)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (m, n)
    np.testing.assert_allclose(out.float().numpy(), expect, **_tol(dtype))
    np.testing.assert_allclose(
        out.float().numpy(), tref.gemm_ref(ta, tb).float().numpy(),
        **_tol(dtype))


@pytest.mark.parametrize("alpha", [1.0, -1.0])
def test_block_gemm_alpha_matches_pallas(alpha):
    ja, ta = _pair(RNG.standard_normal((64, 64)), "float32")
    expect = np.asarray(block_gemm_pallas(ja, ja, alpha=alpha,
                                          interpret=True))
    out = tbg.block_gemm(ta, ta, alpha=alpha)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    acc = torch.ones(64, 64)
    np.testing.assert_allclose(
        tops.block_gemm_acc(acc, ta, ta, alpha=alpha).numpy(),
        1.0 + expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nk,nbr,nbc,b", [(1, 4, 2, 8), (3, 2, 4, 8),
                                          (2, 3, 3, 5)])
def test_level_and_round_gemm_match_jax_f64(nk, nbr, nbc, b):
    Ainv = RNG.standard_normal((nbr, nbc, b, b))
    Uh = RNG.standard_normal((nk, nbc, b, b))
    cm = (RNG.random((nk, nbc)) < 0.6).astype(np.float64)
    with jax.enable_x64(True):
        lvl = np.asarray(jops.pselinv_level_gemm(jnp.asarray(Ainv),
                                                 jnp.asarray(Uh)))
        rnd = np.asarray(jops.pselinv_round_gemm(
            jnp.asarray(Ainv), jnp.asarray(Uh), jnp.asarray(cm)))
    assert lvl.dtype == np.float64
    tA, tU = torch.from_numpy(Ainv), torch.from_numpy(Uh)
    np.testing.assert_allclose(tops.pselinv_level_gemm(tA, tU).numpy(),
                               lvl, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tops.pselinv_round_gemm(tA, tU, torch.from_numpy(cm)).numpy(),
        rnd, rtol=0, atol=1e-12)
    # bool mask, leading batch dims, and an ``out`` view: same function
    out = torch.zeros(2, 3, nk, nbr, b, b, dtype=torch.float64)
    got = tops.pselinv_round_gemm(tA.expand(2, 3, *tA.shape),
                                  tU.expand(2, 3, *tU.shape),
                                  torch.from_numpy(cm != 0).expand(2, 3,
                                                                   nk, nbc),
                                  out=out)
    assert got is out
    np.testing.assert_allclose(out[1, 2].numpy(), rnd, rtol=0, atol=1e-12)


def test_blocked_gemm_plain_is_the_2d_product():
    """The blocked level product equals the 2-D GEMM of the reshaped
    operands — the layout the kernel reads through index arithmetic."""
    Z, nbr, nbc, nk, b = 2, 3, 2, 2, 4
    A = torch.from_numpy(RNG.standard_normal((Z, nbr, nbc, b, b)))
    U = torch.from_numpy(RNG.standard_normal((Z, nk, nbc, b, b)))
    p = tbg.blocked_gemm(A, U)
    for z in range(Z):
        for k in range(nk):
            for i in range(nbr):
                want = sum(A[z, i, j] @ U[z, k, j].T for j in range(nbc))
                np.testing.assert_allclose(p[z, k, i].numpy(),
                                           want.numpy(), atol=1e-12)


@pytest.mark.parametrize("a,b,exc", [
    (torch.ones(4, 4, dtype=torch.int32), torch.ones(4, 4,
                                                     dtype=torch.int32),
     TypeError),
    (torch.ones(4, 4, dtype=torch.float16), torch.ones(4, 4,
                                                       dtype=torch.float16),
     TypeError),
    (torch.ones(4, 4), torch.ones(4, 4, dtype=torch.float64), TypeError),
    (torch.ones(4, 5), torch.ones(4, 4), ValueError),
    (torch.ones(2, 4, 4), torch.ones(3, 4, 4), ValueError),
    (torch.ones(4), torch.ones(4), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(a, b, exc):
    with pytest.raises(exc):
        tbg.block_gemm(a, b)


def test_blocked_wrapper_rejects_bad_shapes():
    A = torch.zeros(2, 3, 2, 4, 4)
    with pytest.raises(ValueError):
        tbg.blocked_gemm(A, torch.zeros(2, 1, 3, 4, 4))   # nbc differs
    with pytest.raises(ValueError):
        tbg.blocked_gemm(A, torch.zeros(2, 1, 2, 4, 4),
                         out=torch.zeros(2, 3, 1, 4, 4))   # out shape
    with pytest.raises(TypeError):
        tbg.blocked_gemm(A, torch.zeros(2, 1, 2, 4, 4, dtype=torch.float64))


def test_import_needs_no_nvcc():
    """Importing the kernel modules builds nothing and looks for no
    toolkit: the build happens at the first CUDA launch."""
    code = ("import repro_torch.kernels.block_gemm as m, "
            "repro_torch.kernels.ops, repro_torch.kernels._build as b\n"
            "assert m._fn is None and not b._libs and m.launches == 0\n"
            "print('ok')")
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "PYTHONPATH": "src"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
