"""The port on the card: each CUDA kernel (block GEMM, trsm, RMSNorm,
flash attention) against its plain version, the engine's CUDA solve
against its CPU solve, the level-serial and stream executors against
the overlapped one (one block-GEMM launch per planned GEMM), the
profiling replay against the solve, the serial path's ``cuda``
backend against the numpy backend, the CUDA-graph runners and the
server on them against the eager sweep, and rank processes sharing the
card: a gloo ``ppermute`` of a CUDA tensor (staged through pinned host
memory) and a ranked ``run_distributed``, overlapped and level-serial,
against the single-process solve, with the level-serial send logs held
to the plan (``lint_ranked``); ``lint_compiled`` of every executor
with its captured graph; the LM serving path at granite-3-2b's full
width (2 layers): prefill against teacher-forced decode, the kernel
route against the plain route, and the launches of each; and the MoE,
jamba, xLSTM and enc-dec families at full width, depth cut: the kernel
route against the plain route, their launches, MoE served tokens
repeated bitwise, and the f32 weights of the serving model.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one, save the check that ``ModelAPI.init(device="cuda")`` raises on a
host without one (it skips where a card is present); the file imports
neither JAX nor the JAX package, so it runs on a machine that has only
the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sparse
from repro_torch.core import supernodal_lu as slu
from repro_torch.core.engine import (Grid, PSelInvEngine, SolveValues,
                                     stack_values)
from repro_torch.core.plan import PlanOptions
from repro_torch.core.pselinv_dist import make_sweep_stream
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
    # the class's first solve runs the sweep eagerly (warm-up), records
    # it into a CUDA graph (capture) and replays it; later solves replay
    assert bg.launches - before == 2 * gpu.gemm_ops()
    assert out.device.type == "cuda"
    assert (out.cpu() - ref).abs().max().item() <= 1e-12
    before = bg.launches
    assert torch.equal(gpu.solve(A, dtype=torch.float64), out)
    assert bg.launches == before
    assert gpu.stats()["graph_replays"] == 2


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
    ref, bs = selected_inverse(A, max_supernode=8, backend="numpy")
    before = tk.launches
    got, _ = selected_inverse(A, max_supernode=8, backend="cuda")
    assert tk.launches - before == sum(1 for s in bs.struct if len(s))
    assert got.keys() == ref.keys()
    err = max(float(np.abs(got[key] - ref[key]).max()) for key in ref)
    assert err <= 1e-12


# ---- the tensor-core redesign: each variant and staging path --------------

GEMM_TYPES = [torch.float64, torch.bfloat16, torch.float32]
GEMM_VARIANT = {torch.float64: "dmma_f64", torch.bfloat16: "hmma_bf16",
                torch.float32: "fma_f32"}


def _randn(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)


def _misaligned(x):
    """A copy of ``x`` whose storage starts one element past a 16-byte
    boundary, so no operand of it is 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("m,k,n", [(33, 17, 129), (200, 130, 70)])
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_gemm_ragged_rows_repeat_and_batch(cuda_device, m, k, n, dtype):
    """Rows that are not a multiple of 16 bytes and an N-contiguous B: the
    guarded staging path, zero-filled at the edges. Held against the plain
    version; a repeated launch is bitwise equal, and so is each item of a
    Z = 8 launch to the same item launched alone."""
    a = _randn((8, m, k), dtype, cuda_device, m)
    b = _randn((8, k, n), dtype, cuda_device, n)
    p = bg.plan(m, n, k, dtype, bg.rowmajor_desc(m, k, n),
                (a.data_ptr(), b.data_ptr()))
    assert p.variant == GEMM_VARIANT[dtype] and not p.b_async
    out = bg.block_gemm(a, b, alpha=-1.0)
    torch.cuda.synchronize()
    assert _close(out, bg.block_gemm_plain(a, b, alpha=-1.0), dtype)
    assert torch.equal(bg.block_gemm(a, b, alpha=-1.0), out)
    for z in range(8):
        assert torch.equal(bg.block_gemm(a[z], b[z], alpha=-1.0), out[z])


@pytest.mark.parametrize("nk", [1, 3])
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_blocked_gemm_b96_on_arena_views(cuda_device, nk, dtype):
    """The level product at b = 96, read from and written into strided
    views of one arena, on the cp.async path with BN = b; bitwise repeat
    and batch independence (Z = 8 against Z = 1)."""
    Z, nbr, nbc, b = 8, 3, 4, 96
    arena = _randn((Z, 40, b, b), dtype, cuda_device, nk)
    Ainv = arena[:, :nbr * nbc].view(Z, nbr, nbc, b, b)
    U = _randn((Z, nk, nbc, b, b), dtype, cuda_device, 7 + nk)
    out = arena[:, 20:20 + nk * nbr].view(Z, nk, nbr, b, b)
    p = bg.plan(nbr * b, nk * b, nbc * b, dtype,
                bg.blocked_desc(Ainv.stride(), U.stride(), out.stride(), b),
                (Ainv.data_ptr(), U.data_ptr()))
    assert (p.variant, p.bn, p.a_async, p.b_async) == (
        GEMM_VARIANT[dtype], 96, True, True)
    ref = bg.blocked_gemm_plain(Ainv, U)
    bg.blocked_gemm(Ainv, U, out=out)
    torch.cuda.synchronize()
    assert _close(out, ref, dtype)
    assert torch.equal(bg.blocked_gemm(Ainv, U), out)
    for z in range(Z):
        assert torch.equal(bg.blocked_gemm(Ainv[z:z + 1], U[z:z + 1])[0],
                           out[z])


@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_blocked_gemm_guarded_staging_equals_async(cuda_device, dtype):
    """The same product from operands one element off 16-byte alignment
    goes through the guarded element loads, and gives the same bits as the
    cp.async path: staging moves data, the arithmetic is one."""
    Z, nbr, nbc, nk, b = 2, 2, 3, 2, 128
    Ainv = _randn((Z, nbr, nbc, b, b), dtype, cuda_device, 1)
    U = _randn((Z, nk, nbc, b, b), dtype, cuda_device, 2)
    Am, Um = _misaligned(Ainv), _misaligned(U)
    desc = bg.blocked_desc(Am.stride(), Um.stride(),
                           (nk * nbr * b * b, nbr * b * b, b * b, b, 1), b)
    p = bg.plan(nbr * b, nk * b, nbc * b, dtype, desc,
                (Am.data_ptr(), Um.data_ptr()))
    assert not p.a_async and not p.b_async
    out = bg.blocked_gemm(Ainv, U)
    got = bg.blocked_gemm(Am, Um)
    torch.cuda.synchronize()
    assert _close(got, bg.blocked_gemm_plain(Ainv, U), dtype)
    assert torch.equal(got, out)


def _flash_inputs(B, S, H, hd, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, S, 3, H, hd, device=dev,
                      generator=g).to(torch.bfloat16)
    return qkv.unbind(2)


def _flash_close(out, ref):
    # chip_smoke.py's FLASH_BF16_TOL: one bf16 step of the output plus 2e-3
    return torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("S", [200, 256, 4096])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_tensor_cores(cuda_device, S, hd, causal):
    """bf16 flash attention on the tensor cores (cp.async K/V ring) from
    packed-qkv views: S = 200 leaves a ragged q and KV tile, S = 4096 runs
    the causal diagonal across 32 q tiles. Bitwise repeatable."""
    B, H = (1, 4) if S == 4096 else (2, 3)
    q, k, v = _flash_inputs(B, S, H, hd, cuda_device, S + hd)
    p = fa.plan(B, S, H, hd, q.dtype, causal,
                [t.stride()[:3] for t in (q, k, v)],
                [t.data_ptr() for t in (q, k, v)])
    assert p.variant == "hmma_cpasync"
    before = fa.plans["hmma_cpasync"]
    out = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.plans["hmma_cpasync"] == before + 1
    assert _flash_close(out, fa.flash_attention_plain(q, k, v, causal))
    assert torch.equal(fa.flash_attention(q, k, v, causal), out)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_guarded_and_head_independent(cuda_device, hd, causal):
    """Misaligned q, k, v take the guarded element loads and give the same
    bits as the cp.async path; one (b, h) slice run alone gives the same
    bits as inside a (2, 3)-head launch."""
    B, S, H = 2, 200, 3
    q, k, v = _flash_inputs(B, S, H, hd, cuda_device, hd)
    out = fa.flash_attention(q, k, v, causal)
    qm, km, vm = (_misaligned(t.contiguous()) for t in (q, k, v))
    assert fa.plan(B, S, H, hd, q.dtype, causal,
                   [t.stride()[:3] for t in (qm, km, vm)],
                   [t.data_ptr() for t in (qm, km, vm)]
                   ).variant == "hmma_guarded"
    got = fa.flash_attention(qm, km, vm, causal)
    torch.cuda.synchronize()
    assert _flash_close(got, fa.flash_attention_plain(q, k, v, causal))
    assert torch.equal(got, out)
    one = fa.flash_attention(*(t[1:2, :, 2:3] for t in (q, k, v)),
                             causal=causal)
    assert torch.equal(one[0, :, 0], out[1, :, 2])


# ---- trsm: the reciprocal chain, zero rows, one launch per supernode ------

def _upper(k, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    u = np.triu(rng.standard_normal((k, k))) / np.sqrt(k) + 2 * np.eye(k)
    return torch.from_numpy(u).to(dev, dtype)


@pytest.mark.parametrize("zeros", ["half", "all"])
@pytest.mark.parametrize("m,k", [(96, 96), (130, 48), (4096, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_trsm_zero_rows_match_plain(cuda_device, m, k, dtype, zeros):
    """Right-hand sides with whole rows of exact zeros, as the serial
    path's A(I,K) after Schur updates hold: every other row, or all."""
    u = _upper(k, dtype, cuda_device, k)
    b = _randn((m, k), dtype, cuda_device, m)
    b[slice(1, None, 2) if zeros == "half" else slice(None)] = 0
    out = tk.trsm(b, u)
    torch.cuda.synchronize()
    assert _close(out, tk.trsm_plain(b, u), dtype)
    assert (out[1::2] == 0).all()


def test_trsm_stacked_launch_is_bitwise_per_block(cuda_device):
    """The serial path's stacked solve: ragged blocks of one supernode's
    struct(K) against one U(K,K), k = 96 in f64, in one launch, give the
    bits of one launch per block (the plans differ: 8 rows a block for
    each block alone, more for the stack)."""
    k, sizes = 96, [96, 17, 96, 1, 64, 96, 33] * 8
    u = _upper(k, torch.float64, cuda_device, 5)
    bs = [_randn((n, k), torch.float64, cuda_device, i)
          for i, n in enumerate(sizes)]
    bs[2][::3] = 0
    be = slu.get_backend("cuda", cuda_device)
    before, plans = tk.launches, dict(tk.plans)
    xs = be.solve_tri_right_upper_many(bs, u)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    assert tk.plan(sum(sizes), k, torch.float64) != tk.plan(96, k,
                                                            torch.float64)
    assert tk.plans["rcp_resident"] == plans.get("rcp_resident", 0) + 1
    for b, x in zip(bs, xs, strict=True):
        assert x.is_contiguous()
        assert torch.equal(x, tk.trsm(b, u))
    assert _close(torch.cat(xs), tk.trsm_plain(torch.cat(bs), u),
                  torch.float64)


# ---- RMSNorm: one read, the scale in its own type, one launch a call ------

def _kernels_in(fn):
    """The names of the kernels the card ran for ``fn()``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("d", [128, 1001, 5120, 16384])
@pytest.mark.parametrize("stype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_scale_types_one_launch(cuda_device, d, stype, dtype):
    """x in f32 or bf16 with the scale in either type, read as it is:
    one kernel a call (no conversion of the scale), held against the
    plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn(37, d, device=cuda_device, generator=g).to(dtype)
    s = torch.randn(d, device=cuda_device, generator=g).to(stype)
    before = rk.launches
    out = rk.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    assert _close(out, rk.rmsnorm_plain(x, s), dtype)
    names = _kernels_in(lambda: rk.rmsnorm(x, s))
    assert len(names) == 1 and "rmsnorm" in names[0], names


def test_rmsnorm_two_pass_and_misaligned(cuda_device):
    """Past the register budget (d = 40960 bf16) the two-pass variant; a
    misaligned x takes element loads; both held against the plain."""
    x = torch.randn(5, 40960, device=cuda_device).to(torch.bfloat16)
    s = torch.randn(40960, device=cuda_device).to(torch.bfloat16)
    before = rk.plans["two_pass"]
    assert _close(rk.rmsnorm(x, s), rk.rmsnorm_plain(x, s), torch.bfloat16)
    assert rk.plans["two_pass"] == before + 1
    xm = _misaligned(torch.randn(9, 5120, device=cuda_device))
    sm = torch.randn(5120, device=cuda_device)
    assert not rk.plan(9, 5120, xm.dtype, xm.data_ptr() % 16 == 0).vec
    assert _close(rk.rmsnorm(xm, sm), rk.rmsnorm_plain(xm, sm),
                  torch.float32)


# ---- the level-serial and stream executors and the profiling replay --------

EXECUTORS = {"overlapped": PlanOptions(),
             "level_serial": PlanOptions(overlap=False),
             "stream": PlanOptions(stream=True)}


def _executor_cases():
    fem = sparse.fem3d_like_matrix(4, 4, 4, 2)[0]
    return {
        "lap": sparse.laplacian_2d(16, 8),
        "fem": sparse.make_numeric(fem, symmetric_values=True),
        "dg": sparse.make_numeric(sparse.dg_like_matrix(6, 6, 4)[0],
                                  symmetric_values=True),
    }


@pytest.mark.parametrize("name", ["lap", "fem", "dg"])
def test_executors_match_overlapped_on_the_card(cuda_device, name):
    A = _executor_cases()[name]
    engs = {ex: PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), options=o)
            for ex, o in EXECUTORS.items()}
    vals = engs["overlapped"].prepare_values(A)
    out = {}
    for ex, eng in engs.items():
        before = bg.launches
        out[ex] = eng.sweep()(vals.Lh, vals.Dinv)        # eager: launches
        torch.cuda.synchronize()
        assert bg.launches - before == eng.gemm_ops(), ex
        assert out[ex].device.type == "cuda"
    assert torch.equal(out["stream"], out["overlapped"])
    diff = (out["level_serial"] - out["overlapped"]).abs().max().item()
    print(f"{name}: level-serial vs overlapped max|Δ| {diff:.3e}")
    assert diff <= 1e-12
    for ex, o in EXECUTORS.items():
        cpu = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), options=o,
                                    device="cpu")
        ref = cpu.solve(A, dtype=torch.float64)
        assert (out[ex].cpu() - ref).abs().max().item() <= 1e-12, ex
        assert torch.equal(engs[ex].solve(vals, dtype=torch.float64),
                           out[ex]), ex


@pytest.mark.parametrize("executor", ["overlapped", "stream"])
def test_profile_replay_equals_solve_on_the_card(cuda_device, executor):
    A = _executor_cases()["fem"]
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                options=EXECUTORS[executor])
    vals = eng.prepare_values(A)
    ref = eng.solve(vals, dtype=torch.float64)
    for chunk in (1, 4):
        prof = eng.profile_rounds(vals, chunk=chunk, reps=2,
                                  dtype=torch.float64)
        assert prof.ainv.device.type == "cuda"
        assert torch.equal(prof.ainv, ref)
        assert all(s.wall_us > 0 for s in prof.samples)


@pytest.mark.parametrize("name", ["lap", "fem"])
def test_stream_padded_levels_give_the_same_bits(cuda_device, name):
    """The stream's level tables run NK-padded (as the JAX stream does)
    and cut to each level's nk give the same bits: the level GEMM and the
    diagonal einsum sum each output element in an order that does not
    depend on nk."""
    A = _executor_cases()[name]
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                options=EXECUTORS["stream"])
    st = eng.program.stream_tables
    assert any(len(k) < st.NK for k in st.level_Ks)   # padding happens
    vals = eng.prepare_values(A, dtype=torch.float64)
    real = make_sweep_stream(eng.program, eng.tables)(vals.Lh, vals.Dinv)
    before = bg.launches
    padded = make_sweep_stream(eng.program, eng.tables, padded=True)(
        vals.Lh, vals.Dinv)
    torch.cuda.synchronize()
    assert bg.launches - before == eng.gemm_ops()
    assert torch.equal(padded, real)


# ---- CUDA-graph capture, and the server on it ------------------------------

def _value_sets(vals):
    """Three value sets: the prepared values and two exact power-of-two
    rescalings of them."""
    return [vals, SolveValues(vals.Lh * 0.5, vals.Dinv),
            SolveValues(vals.Lh, vals.Dinv * 2.0)]


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_replay_is_bitwise_the_eager_sweep(cuda_device, executor):
    """A solve replays its class's CUDA graph: bitwise the eager sweep,
    single and in a batch of 3 bucketed to 4, with one block-GEMM node
    a planned GEMM in the graph, all on the DMMA variant."""
    A = _executor_cases()["fem"]
    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                options=EXECUTORS[executor])
    sets = _value_sets(eng.prepare_values(A))
    eager = [eng.sweep()(v.Lh, v.Dinv) for v in sets]
    assert torch.equal(eng.solve(sets[0], dtype=torch.float64), eager[0])
    run = eng._fns[(False, 1, torch.float64)]
    assert run.gemm_nodes == run.gemm_launches == eng.gemm_ops()
    assert {k[0] for k in run.gemm_plans} == {"dmma_f64"}
    assert run.graph_kernels > run.gemm_nodes
    batch = eng.solve(stack_values(sets), dtype=torch.float64, bucket=True)
    assert batch.shape[0] == 3
    for i, e in enumerate(eager):
        assert torch.equal(batch[i], e), i
    assert eng.trace_count == 2


def test_one_capture_per_class(cuda_device):
    """Repeated solves of a class replay its one graph: ``trace_count``
    counts captures, ``graph_replays`` replays; Python-side launch
    counts move only at a capture; measuring a class's compile stats
    captures uncounted."""
    A = _executor_cases()["lap"]
    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2))
    v = eng.prepare_values(A)
    outs = [eng.solve(v, dtype=torch.float64) for _ in range(3)]
    assert eng.trace_count == 1
    before = bg.launches
    sets = _value_sets(v)
    eng.solve(stack_values(sets), dtype=torch.float64, bucket=True)
    eng.solve(stack_values(sets + sets[:1]), dtype=torch.float64)
    torch.cuda.synchronize()
    assert eng.trace_count == 2                   # B=3 rides B=4
    assert bg.launches - before == 2 * eng.gemm_ops()
    st = eng.stats(compile=True)
    assert eng.trace_count == 2
    assert st["graph_replays"] == 5 and st["graph_bytes"] > 0
    assert st["capture_ms"] > 0 and st["warmup_ms"] > 0
    assert st["graph_gemm_nodes"] == eng.gemm_ops()
    assert st["graph_kernels"] > st["graph_gemm_nodes"]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_returned_result_survives_the_next_replay(cuda_device):
    A = _executor_cases()["fem"]
    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2))
    v1, v2, _ = _value_sets(eng.prepare_values(A))
    out1 = eng.solve(v1, dtype=torch.float64)
    out2 = eng.solve(v2, dtype=torch.float64)
    torch.cuda.synchronize()
    assert torch.equal(out1, eng.sweep()(v1.Lh, v1.Dinv))
    assert torch.equal(out2, eng.sweep()(v2.Lh, v2.Dinv))
    assert not torch.equal(out1, out2)


def test_server_through_graphs_matches_eager_bitwise(cuda_device):
    """The background worker serves value and matrix requests through
    the (structure, bucket) graphs while the caller's thread solves on
    the same session: every result is bitwise the eager sweep of its
    values, and each bucket was captured once."""
    import scipy.sparse as sp
    from repro_torch.serve import BatchWindow, SelInvServer, ServeConfig
    A = _executor_cases()["fem"]
    PSelInvEngine.clear_cache()
    cfg = ServeConfig(b=8, grid=Grid(4, 2), dtype=torch.float64,
                      window=BatchWindow(max_batch=4, max_wait_ms=1e6))
    with SelInvServer(cfg) as srv:
        eng = srv.engine_for(A)
        sets = _value_sets(eng.prepare_values(A))
        reqs = [srv.submit_values(eng, v) for v in sets]
        mine = [eng.solve(sets[0], dtype=torch.float64) for _ in range(3)]
        srv.drain()
        I = sp.identity(A.shape[0])
        mats = [A + c * I for c in (0.5, 1.5)]
        mreqs = [srv.submit(M) for M in mats]
        srv.drain()
        eager = [eng.sweep()(v.Lh, v.Dinv).cpu().numpy() for v in sets]
        for r, e in zip(reqs, eager):
            assert np.array_equal(r.result(timeout=60), e)
        mv = eng.prepare_values_many(mats)
        for i, r in enumerate(mreqs):
            e = eng.sweep()(mv.Lh[i], mv.Dinv[i]).cpu().numpy()
            assert np.array_equal(r.result(timeout=60), e), i
        assert all(np.array_equal(m.cpu().numpy(), eager[0]) for m in mine)
        st = srv.stats()
    (s,) = st["structures"].values()
    assert s["buckets_used"] == [2, 4]
    assert eng.trace_count == 3             # buckets 4 and 2, and B=1


# ---- rank processes on the card: the gloo transport and the ranked sweep --

def _ppermute_rank(rank):
    """Rank 0 sends a seeded CUDA f64 tensor to rank 1 and rank 1 sends
    its own back: one round, both ways."""
    from repro_torch.comm import p2p
    torch.cuda.set_device(0)
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (3, 96, 96))).cuda()
    p2p.LOG.clear()
    got = p2p.ppermute(x, [(0, 1), (1, 0)])
    torch.cuda.synchronize()
    return dict(sent=x.cpu().numpy(), got=got.cpu().numpy(),
                device=str(got.device), staged=p2p.LOG.staged_bytes,
                log=list(p2p.LOG.entries))


def test_ppermute_of_a_cuda_tensor_arrives_bitwise(cuda_device):
    from repro_torch.comm import p2p
    r0, r1 = p2p.spawn(_ppermute_rank, 2, timeout=300)
    np.testing.assert_array_equal(r1["got"], r0["sent"])
    np.testing.assert_array_equal(r0["got"], r1["sent"])
    nbytes = 3 * 96 * 96 * 8
    for rank, r in enumerate((r0, r1)):
        assert r["device"] == "cuda:0"
        assert r["staged"] == 2 * nbytes        # down to pinned, and up
        assert sorted(r["log"]) == sorted([(0, 0, 1, nbytes),
                                           (0, 1, 0, nbytes)])


def _ranked_lap_rank(rank):
    from repro_torch.comm import p2p
    from repro_torch.core.pselinv_dist import run_distributed
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    p2p.LOG.clear()
    bg.launches = 0
    out, prog = run_distributed(sparse.laplacian_2d(16, 8), b=8, pr=4, pc=2,
                                dtype=torch.float64, device="cuda")
    return dict(out=out if rank == 0 else None, launches=bg.launches,
                sent=p2p.LOG.sent()[1], staged=p2p.LOG.staged_bytes)


def test_ranked_solve_on_the_card_equals_single_process(cuda_device):
    """A 4×2 ranked solve of ``laplacian_2d(16, 8)`` by 8 processes on the
    one card (kernels built in the parent first) equals the single-process
    card solve; every rank launches the hand-written GEMM once a GEMM op,
    and stages each message it sends and receives."""
    from repro_torch.comm import p2p
    from repro_torch.kernels import _build
    _build.build(["block_gemm"])
    A = sparse.laplacian_2d(16, 8)
    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2))
    single = eng.solve(A, dtype=torch.float64).cpu().numpy()
    rows = p2p.spawn(_ranked_lap_rank, 8, timeout=600)
    np.testing.assert_array_equal(rows[0]["out"], single)
    assert [r["launches"] for r in rows] == [eng.gemm_ops()] * 8
    assert sum(r["sent"] for r in rows) == eng.moved()[1]
    assert sum(r["staged"] for r in rows) == 2 * eng.moved()[1]


@pytest.mark.parametrize("options", [dict(), dict(overlap=False),
                                     dict(stream=True)])
def test_lint_compiled_on_the_card(cuda_device, options):
    """``lint_compiled`` on the card: the eager sweep's ops and permutes
    and the permutes recorded while the class's graph was captured are
    the plan's (the stream's: its landing slots), clean, as are the
    device tables; the graph holds one block-GEMM node a GEMM op."""
    from repro_torch.core.exec_verify import (expected_permutes,
                                              stream_landings)
    A = sparse.laplacian_2d(16, 8)
    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                options=PlanOptions(**options))
    eng.solve(A, dtype=torch.float64)
    res = eng.lint_compiled(dtype=torch.float64, verify_compiled="error")
    st = eng.program.stream_tables
    want = (len(stream_landings(st)) if st is not None else
            sum(e.activations for e in expected_permutes(eng.program)))
    assert list(res) == []
    assert res.info["layers"]["eager"] == res.info["layers"]["graph"] == want
    assert res.info["wire_blocks"] == res.info["expected_blocks"]
    assert res.info["graph_gemm_nodes"] == eng.gemm_ops()
    PSelInvEngine.clear_cache()


def _ranked_lap_ls_rank(rank):
    """``run_distributed(overlap=False)``, then the rank's sweep again
    under the recorder and the op layer, linted with its staged bytes."""
    from repro_torch.comm import p2p
    from repro_torch.core import exec_ir
    from repro_torch.core.exec_verify import lint_ops
    from repro_torch.core.pselinv_dist import (
        analyze_structure, build_program, make_sweep_ranked,
        prepare_values, rank_exec_tables, run_distributed,
        upload_exec_tables)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    A = sparse.laplacian_2d(16, 8)
    p2p.LOG.clear()
    bg.launches = 0
    out, prog = run_distributed(A, b=8, pr=4, pc=2, dtype=torch.float64,
                                device="cuda", overlap=False)
    res = dict(out=out if rank == 0 else None, launches=bg.launches,
               log=p2p.LOG.snapshot())
    bs, nb = analyze_structure(A, 8, 4, 2)
    Lh, Dinv = (torch.from_numpy(x[rank]).cuda()
                for x in prepare_values(A, bs, nb, 8, 4, 2))
    sweep = make_sweep_ranked(prog, rank_exec_tables(
        upload_exec_tables(prog, "cpu"), rank, Lh.device), rank)
    p2p.LOG.clear()
    with exec_ir.record() as rec, exec_ir.ops_layer(rec):
        again = sweep(Lh, Dinv)
    torch.cuda.synchronize()
    res.update(again=again.cpu().numpy(), staged=p2p.LOG.staged_bytes,
               staged_notes=sum(n.kind == "staged" for n in rec.notes),
               codes=[str(d) for d in lint_ops(
                   rec, prog, layer="ranked",
                   staged_bytes=p2p.LOG.staged_bytes)])
    return res


def test_ranked_level_serial_on_the_card(cuda_device):
    """The level-serial sweep by 8 processes on the one card equals the
    single-process level-serial card solve; every rank launches one GEMM a
    level; the ranks' send logs are the plan's, round by round, with every
    message staged down and up; and a rank's sweep under the op layer is
    clean, its staging copies exempt and adding up to its staged bytes."""
    from repro_torch.comm import p2p
    from repro_torch.core.exec_verify import lint_ranked
    from repro_torch.kernels import _build
    _build.build(["block_gemm"])
    A = sparse.laplacian_2d(16, 8)
    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2),
                                options=PlanOptions(overlap=False))
    single = eng.sweep()(*(v.to(cuda_device, torch.float64)
                           for v in eng.prepare_values(A))).cpu().numpy()
    rows = p2p.spawn(_ranked_lap_ls_rank, 8, timeout=600)
    np.testing.assert_array_equal(rows[0]["out"], single)
    assert [r["launches"] for r in rows] == [eng.gemm_ops()] * 8
    res = lint_ranked([r["log"] for r in rows], eng.program)
    assert list(res) == []
    assert res.info["sent_bytes"] == eng.moved()[1]
    assert res.info["staged_bytes"] == 2 * eng.moved()[1]
    np.testing.assert_array_equal(
        np.stack([r["again"] for r in rows]), single)
    assert all(r["codes"] == [] for r in rows)
    assert sum(r["staged"] for r in rows) == 2 * eng.moved()[1]
    assert all(r["staged_notes"] > 0 for r in rows if r["staged"])


@pytest.mark.parametrize("name", ["lap", "fem"])
def test_unrolled_sweep_on_the_card(cuda_device, name):
    """The legacy unrolled sweep on the card against its CPU run (f64,
    within 1e-12·max|A⁻¹|), one block-GEMM launch a supernode with a
    struct, every one on the DMMA variant."""
    from repro_torch.core.pselinv_dist import (analyze_structure,
                                               build_program_unrolled,
                                               make_sweep_unrolled,
                                               prepare_values,
                                               upload_unrolled_tables)
    A = _executor_cases()[name]
    bs, nb = analyze_structure(A, 8, 4, 2)
    prog = build_program_unrolled(bs, nb, 8, 4, 2)
    Lh, Dinv = (torch.from_numpy(x) for x in
                prepare_values(A, bs, nb, 8, 4, 2))
    ref = make_sweep_unrolled(prog, upload_unrolled_tables(prog, "cpu"))(
        Lh, Dinv)
    sweep = make_sweep_unrolled(prog, upload_unrolled_tables(prog,
                                                             cuda_device))
    before = bg.launches
    bg.plans.clear()
    out = sweep(Lh.to(cuda_device), Dinv.to(cuda_device))
    torch.cuda.synchronize()
    assert bg.launches - before == sum(1 for it in prog.iters if it.C)
    assert {k[0] for k in bg.plans} == {"dmma_f64"}
    scale = ref.abs().max().item()
    assert (out.cpu() - ref).abs().max().item() <= 1e-12 * scale


# ---- the LM serving path: granite-3-2b at full width, 2 layers ------------

def _granite2(dev):
    """granite-3-2b at its published width with the depth cut to 2, the
    serving model (bf16) from the port's seeded init on ``dev``."""
    import dataclasses

    from repro_torch.config import get_config
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    api = get_model(cfg)
    return cfg, api, api.serving_params(api.init(0, device=dev))


def _lm_close(out, ref, vocab):
    """rtol 5e-2 and atol 5e-2 · max(1, max|ref|) over the real vocab
    (as ``tests/test_torch_models.py``)."""
    out, ref = out[..., :vocab].float(), ref[..., :vocab].float()
    atol = 5e-2 * max(1.0, ref.abs().max().item())
    return bool(torch.isfinite(out).all()) and torch.allclose(
        out, ref, rtol=5e-2, atol=atol)


def _lm_run(api, cfg, params, toks, steps):
    from repro_torch.models.transformer import lm_forward
    dev = toks.device
    full, _ = lm_forward(params, cfg, toks)
    cache = api.init_cache(toks.shape[0], toks.shape[1], device=dev)
    dec = []
    for t in range(steps):
        lg, cache = api.decode_step(params, toks[:, t],
                                    torch.full((toks.shape[0],), t,
                                               device=dev), cache)
        dec.append(lg)
    torch.cuda.synchronize()
    return full, torch.stack(dec, 1)


def _lm_tokens(cfg, dev, B=2, S=256):
    g = torch.Generator(device=dev).manual_seed(11)
    return torch.randint(0, cfg.vocab, (B, S), device=dev, generator=g)


def test_lm_prefill_matches_teacher_forced_decode(cuda_device):
    cfg, api, params = _granite2(cuda_device)
    toks = _lm_tokens(cfg, cuda_device)
    full, dec = _lm_run(api, cfg, params, toks, 12)
    assert full.shape == (2, 256, cfg.vocab_padded)
    assert _lm_close(dec, full[:, :12], cfg.vocab)
    assert int(full.argmax(-1).max()) < cfg.vocab


def test_lm_kernel_route_matches_plain_route(cuda_device):
    from repro_torch.models import layers as ml
    cfg, api, params = _granite2(cuda_device)
    toks = _lm_tokens(cfg, cuda_device)
    full, dec = _lm_run(api, cfg, params, toks, 8)
    before = (rk.launches, fa.launches)
    with ml.plain_kernels():
        pfull, pdec = _lm_run(api, cfg, params, toks, 8)
    assert (rk.launches, fa.launches) == before    # no kernel launched
    assert not ml.plain_route()
    assert _lm_close(full, pfull, cfg.vocab)
    assert _lm_close(dec, pdec, cfg.vocab)


def test_lm_launch_counts(cuda_device):
    """L flash launches a prefill (on the tensor cores) and 2·L+1
    RMSNorm launches a prefill and a decode step."""
    cfg, api, params = _granite2(cuda_device)
    L = cfg.n_layers
    toks = _lm_tokens(cfg, cuda_device, B=1, S=2048)
    rk.launches = fa.launches = 0
    fa.plans.clear()
    last = api.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert (fa.launches, rk.launches) == (L, 2 * L + 1)
    assert set(fa.plans) <= {"hmma_cpasync", "hmma_guarded"}
    assert last.shape == (1, 1, cfg.vocab_padded)
    cache = api.init_cache(8, 2048, device=cuda_device)
    rk.launches = fa.launches = 0
    api.decode_step(params, toks[0, :8], torch.arange(8), cache)
    torch.cuda.synchronize()
    assert (fa.launches, rk.launches) == (0, 2 * L + 1)


def test_model_init_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.config import get_config, reduced_config
    from repro_torch.models import get_model
    api = get_model(reduced_config(get_config("granite-3-2b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(0, device="cuda")


# ---- the other LM families at full width, depth cut ------------------------

#: each family at its published width, cut to 1-2 layers (jamba: its
#: 8-layer period with 2 of 16 experts; seamless: 2 + 2 layers)
FAMILY_CUTS = {"dbrx-132b": dict(n_layers=1), "grok-1-314b": dict(n_layers=1),
               "jamba-1.5-large-398b": dict(n_layers=8, n_experts=2),
               "xlstm-125m": dict(n_layers=3),
               "seamless-m4t-large-v2": dict(n_layers=2, enc_layers=2)}


def _family(dev, arch):
    import dataclasses

    from repro_torch.config import get_config
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_config(arch), **FAMILY_CUTS[arch])
    api = get_model(cfg)
    return cfg, api, api.serving_params(api.init(0, device=dev))


def _family_run(api, cfg, params, S=256, steps=8):
    """(prefill logits, decode logits, routings of each) at B = 1."""
    from repro_torch.models import encdec
    from repro_torch.models.moe import RouteLog
    from repro_torch.models.transformer import lm_forward
    dev = params.embed.table.device
    g = torch.Generator(device=dev).manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (1, S), device=dev, generator=g)
    with RouteLog() as pre:
        if cfg.enc_layers:
            frames = torch.randn(1, 128, cfg.d_model, device=dev,
                                 generator=g)
            full = encdec.encdec_forward(params, cfg, toks, frames)
            cache = encdec.encdec_init_cache(params, cfg, frames, S)
        else:
            full, _ = lm_forward(params, cfg, toks)
            cache = api.init_cache(1, S, device=dev)
    dec = []
    with RouteLog() as steps_r:
        for t in range(steps):
            lg, cache = api.decode_step(params, toks[:, t],
                                        torch.full((1,), t, device=dev),
                                        cache)
            dec.append(lg)
    torch.cuda.synchronize()
    return full, torch.stack(dec, 1), pre.calls, steps_r.calls


def _rows_close(out, ref, vocab, skip):
    keep = [t for t in range(out.shape[1]) if t not in skip]
    assert len(keep) >= out.shape[1] // 2
    idx = torch.tensor(keep, device=out.device)
    return _lm_close(out.index_select(1, idx), ref.index_select(1, idx),
                     vocab)


@pytest.mark.parametrize("arch", list(FAMILY_CUTS))
def test_family_kernel_route_matches_plain_route(cuda_device, arch):
    """Prefill and 8 decode steps through the kernels and through their
    plain versions (``layers.plain_kernels``), within the LM tolerance
    over the positions whose MoE routing did not differ between them
    (``moe.route_flips``: each flip a near-tie)."""
    from repro_torch.models import layers as ml
    from repro_torch.models.moe import route_flips, routes_by_layer
    cfg, api, params = _family(cuda_device, arch)
    full, dec, rp, rd = _family_run(api, cfg, params)
    before = (rk.launches, fa.launches)
    with ml.plain_kernels():
        pfull, pdec, pp, pd = _family_run(api, cfg, params)
    assert (rk.launches, fa.launches) == before
    per = len(rp)                            # MoE calls a forward
    S, steps = full.shape[1], dec.shape[1]
    skip = route_flips(pp, rp, S, f"{arch} prefill") if per else {}
    assert _rows_close(full, pfull, cfg.vocab, skip)
    skip = route_flips(routes_by_layer(pd, per, 1), routes_by_layer(
        rd, per, 1), steps, f"{arch} decode") if per else {}
    assert _rows_close(dec, pdec, cfg.vocab, skip)


@pytest.mark.parametrize("arch", list(FAMILY_CUTS))
def test_family_launch_counts(cuda_device, arch):
    """Flash launches a prefill (each self-attention; seamless: the
    encoder's non-causal and the decoder's causal, none for
    cross-attention), all on the tensor cores; RMSNorm launches a decode
    step: 2 a mixer+ffn layer, 1 an xLSTM layer, 3 an enc-dec decoder
    layer, and the final norm."""
    from repro_torch.models import encdec
    from repro_torch.models.transformer import layer_kinds
    cfg, api, params = _family(cuda_device, arch)
    toks = torch.randint(0, cfg.vocab, (1, 256), device=cuda_device)
    rk.launches = fa.launches = 0
    fa.plans.clear()
    if cfg.enc_layers:
        frames = torch.randn(1, 128, cfg.d_model, device=cuda_device)
        api.prefill(params, {"tokens": toks, "frontend": frames})
        flash = cfg.enc_layers + cfg.n_layers
        norms = 2 * cfg.enc_layers + 1 + 3 * cfg.n_layers + 1
        step = 3 * cfg.n_layers + 1
    else:
        api.prefill(params, {"tokens": toks})
        kinds = layer_kinds(cfg)
        flash = sum(k.startswith("attn") for k in kinds)
        norms = step = 1 + sum(1 if k in ("mlstm", "slstm") else 2
                               for k in kinds)
    torch.cuda.synchronize()
    assert (fa.launches, rk.launches) == (flash, norms)
    assert set(fa.plans) <= {"hmma_cpasync", "hmma_guarded"}
    cache = (encdec.encdec_init_cache(params, cfg, frames, 256)
             if cfg.enc_layers else api.init_cache(1, 256, device=cuda_device))
    rk.launches = fa.launches = 0
    api.decode_step(params, toks[:, 0], torch.zeros(1, dtype=torch.long),
                    cache)
    torch.cuda.synchronize()
    assert (fa.launches, rk.launches) == (0, step)


def test_moe_served_tokens_are_bitwise_repeatable(cuda_device):
    """dbrx at full width (1 layer) through ``ServeEngine`` twice on the
    same requests: the same tokens — the combine has no atomics."""
    from repro_torch.runtime import Request, ServeEngine
    cfg, api, params = _family(cuda_device, "dbrx-132b")
    outs = []
    for _ in range(2):
        eng = ServeEngine(api, params, batch_slots=4, max_seq=64)
        reqs = [Request(rid=i, prompt=[1 + i, 7, 3 * i + 2], max_new=8)
                for i in range(6)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and len(r.out) == 8 for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_serving_params_keep_the_f32_weights_on_the_card(cuda_device):
    """jamba's serving model on the card: bf16 but for the MoE router,
    ``A_log`` and ``dt_bias``, in f32."""
    from repro_torch.models.transformer import F32_PARAMS
    cfg, api, params = _family(cuda_device, "jamba-1.5-large-398b")
    kept = set()
    for name, w in params.named_parameters():
        assert w.is_cuda
        if name.endswith(F32_PARAMS):
            assert w.dtype == torch.float32, name
            kept.add(name.rsplit(".", 1)[-1])
        else:
            assert w.dtype == torch.bfloat16, name
    assert kept == {"w", "A_log", "dt_bias"}
    assert api.serving_params(params) is params
