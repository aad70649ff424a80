"""The port on the card: each CUDA kernel (block GEMM, trsm, RMSNorm,
flash attention) against its plain version, the engine's CUDA solve
against its CPU solve, and the serial path's ``cuda`` backend against
the numpy backend.

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
from repro_torch.core.selinv import selected_inverse
from repro_torch.kernels import block_gemm as bg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import trsm as tk

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


@pytest.mark.parametrize("m,k", [(100, 64), (96, 96), (4096, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_trsm_kernel_matches_plain(cuda_device, m, k, dtype):
    """k = 256 in f64 streams U through eight column panels: the whole
    of U (512 KB) does not fit a block's shared memory."""
    rng = np.random.default_rng(m + k)
    u = np.triu(rng.standard_normal((k, k))) / np.sqrt(k) + 2 * np.eye(k)
    u = torch.from_numpy(u).to(cuda_device, dtype)
    b = torch.from_numpy(rng.standard_normal((2, m, k))).to(cuda_device,
                                                             dtype)
    before = tk.launches
    out = tk.trsm(b, u)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    assert _close(out, tk.trsm_plain(b, u), dtype)


@pytest.mark.parametrize("rows,d", [(100, 512), (7, 1001), (4096, 5120)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda_device, rows, d, dtype):
    """d = 1001 is not a multiple of the 16-byte vector: element loads."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn(rows, d, device=cuda_device, generator=g).to(dtype)
    s = torch.randn(d, device=cuda_device, generator=g).to(dtype)
    before = rk.launches
    out = rk.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    assert _close(out, rk.rmsnorm_plain(x, s), dtype)


@pytest.mark.parametrize("B,S,H,hd", [(2, 256, 4, 64), (1, 200, 2, 128),
                                      (1, 1024, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, B, S, H, hd, causal,
                                    dtype):
    """S = 200 leaves a ragged last tile; q, k and v are strided views of
    one packed (B, S, 3, H, hd) tensor, read where they lie."""
    g = torch.Generator(device=cuda_device).manual_seed(S)
    qkv = torch.randn(B, S, 3, H, hd, device=cuda_device,
                      generator=g).to(dtype)
    q, k, v = qkv.unbind(2)
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal)
    if dtype == torch.bfloat16:
        # one bf16 step of the output plus 2e-3, chip_smoke.py's
        # FLASH_BF16_TOL: a dropped KV tile fails it
        assert torch.allclose(out.float(), ref.float(), rtol=1e-2,
                              atol=2e-3)
    else:
        err = (out - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item()


def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 64, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="hd"):
        fa.flash_attention(x, x, x)
    x = torch.zeros(1, 64, 2, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(x, x, x)


def test_serial_cuda_backend_matches_numpy(cuda_device):
    A = sparse.laplacian_2d(16, 8)
    ref, bs = selected_inverse(A, max_supernode=8)
    before = tk.launches
    got, _ = selected_inverse(A, max_supernode=8, backend="cuda")
    assert tk.launches - before == sum(len(s) for s in bs.struct)
    assert got.keys() == ref.keys()
    err = max(float(np.abs(got[key] - ref[key]).max()) for key in ref)
    assert err <= 1e-12
