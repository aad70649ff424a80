"""The port on the card: the CUDA block-GEMM kernel against its plain
version, and the engine's CUDA solve against its CPU solve.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one; the file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sparse
from repro_torch.core.engine import Grid, PSelInvEngine
from repro_torch.kernels import block_gemm as bg

SHAPES = [(64, 64, 64), (128, 256, 128), (200, 130, 70), (33, 17, 129)]
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    if dtype == torch.bfloat16:
        return torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    err = (out.double() - ref.double()).abs().max().item()
    return err <= tol * ref.double().abs().max().item()


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_kernel_matches_plain(cuda_device, m, k, n, dtype):
    rng = np.random.default_rng(m * k * n)
    a = torch.from_numpy(rng.standard_normal((m, k))).to(cuda_device, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n))).to(cuda_device, dtype)
    before = bg.launches
    out = bg.block_gemm(a, b, alpha=-1.0)
    torch.cuda.synchronize()
    assert bg.launches == before + 1
    assert _close(out, bg.block_gemm_plain(a, b, alpha=-1.0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_kernel_on_strided_views(cuda_device, dtype):
    """The level product read from, and written into, strided views of
    one arena — the way the sweep calls it — with a ragged b."""
    Z, nbr, nbc, nk, b, A = 3, 4, 5, 2, 12, 40
    arena = torch.randn(Z, A, b, b, dtype=dtype, device=cuda_device)
    Ainv = arena[:, :nbr * nbc].view(Z, nbr, nbc, b, b)
    U = torch.randn(Z, nk, nbc, b, b, dtype=dtype, device=cuda_device)
    out = arena[:, 30:30 + nk * nbr].view(Z, nk, nbr, b, b)
    ref = bg.blocked_gemm_plain(Ainv, U)
    bg.blocked_gemm(Ainv, U, out=out)
    torch.cuda.synchronize()
    assert _close(out, ref, dtype)


def test_engine_cuda_matches_cpu(cuda_device):
    A = sparse.make_numeric(sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                            symmetric_values=True)
    cpu = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device="cpu")
    gpu = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2))
    ref = cpu.solve(A, dtype=torch.float64)
    before = bg.launches
    out = gpu.solve(A, dtype=torch.float64)
    torch.cuda.synchronize()
    assert bg.launches - before == gpu.gemm_ops()
    assert out.device.type == "cuda"
    assert (out.cpu() - ref).abs().max().item() <= 1e-12
    assert torch.equal(gpu.solve(A, dtype=torch.float64), out)


def test_f32_sweep_refuses_tf32(cuda_device):
    A = sparse.laplacian_2d(16, 8)
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            eng.solve(A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert eng.solve(A).dtype == torch.float32
