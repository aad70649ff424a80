"""The launch plans of the redesigned Hopper kernels, on the CPU.

``block_gemm.plan``, ``flash_attention.plan``, ``trsm.plan`` and
``rmsnorm.plan`` are pure Python: they choose each launch's variant,
tile, staging and (for flash) launch order, and the CUDA entries take that
choice as it is. These tests hold the choices to the kernels' contracts
without a card: every output element is covered by exactly one block and
one thread, the choice never depends on the batch (Z, B·H, or RMSNorm's
rows), K slabs never straddle a b-wide block, the cp.async path is never
chosen for an operand it would read misaligned, the causal launch order is
a permutation of the q tiles, heaviest first, trsm fills the SMs and fits
shared memory, and RMSNorm leaves no idle pass at qwen3-32b's widths.

The thread maps below mirror ``csrc/block_gemm.cu`` (``DmmaCore``,
``HmmaCore``, ``FmaCore``: ``each``, ``at``; ``stage_async``,
``guarded_rk``), ``csrc/trsm.cu`` (rows and lanes of ``trsm_kernel``) and
``csrc/rmsnorm.cu`` (packs of ``rmsnorm_kernel``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_gemm as bg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_cost, trsm_sweep
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import trsm as tk

GEMM_TYPES = [torch.float64, torch.bfloat16, torch.float32]
VARIANT = {torch.float64: "dmma_f64", torch.bfloat16: "hmma_bf16",
           torch.float32: "fma_f32"}


def _blocked(Z, nbr, nbc, nk, b, dtype):
    """Descriptor and shape of the level product on contiguous grids."""
    a = torch.empty(Z, nbr, nbc, b, b, dtype=dtype)
    u = torch.empty(Z, nk, nbc, b, b, dtype=dtype)
    o = torch.empty(Z, nk, nbr, b, b, dtype=dtype)
    desc = bg.blocked_desc(a.stride(), u.stride(), o.stride(), b)
    return nbr * b, nk * b, nbc * b, desc


# (M, N, K, desc) per case: the main path's level products (FEM nk = 1
# and 14 at b = 96, DG at b = 128), the card tests' ragged row-major shapes
# and the serial path's 96-wide products
def _cases(dtype):
    return {
        "fem_nk1": _blocked(8, 32, 64, 1, 96, dtype),
        "fem_nk14": _blocked(8, 32, 64, 14, 96, dtype),
        "dg": _blocked(8, 32, 64, 1, 128, dtype),
        "33x17x129": (33, 129, 17, bg.rowmajor_desc(33, 17, 129)),
        "200x130x70": (200, 70, 130, bg.rowmajor_desc(200, 130, 70)),
        "serial96": (96, 96, 96, bg.rowmajor_desc(96, 96, 96)),
    }


@pytest.mark.parametrize("case", list(_cases(torch.float64)))
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_gemm_tiles_cover_each_output_once(dtype, case):
    M, N, K, desc = _cases(dtype)[case]
    p = bg.plan(M, N, K, dtype, desc)
    assert p.variant == VARIANT[dtype]
    cover = np.zeros((M, N), dtype=np.int32)
    for m0, n0 in p.tiles(M, N):
        cover[m0:m0 + p.bm, n0:n0 + p.bn] += 1
    assert (cover == 1).all()
    gx, gy, _ = p.grid(M, N, 1)
    assert (gx - 1) * p.bn < N <= gx * p.bn
    assert (gy - 1) * p.bm < M <= gy * p.bm


def _thread_outputs(p, tid):
    """The (row, column) of the tile that thread ``tid`` stores."""
    lane, warp = tid % 32, tid // 32
    if p.variant == "fma_f32":
        ntx = p.bn // 8
        tx, ty = tid % ntx, tid // ntx
        return [(ty + 16 * i, tx + ntx * j) for i in range(8)
                for j in range(8)]
    g, t = lane // 4, lane % 4
    wm, wn = (warp // 2) * 32, (warp % 2) * (p.bn // 2)
    return [(wm + i * 16 + g + 8 * (e // 2), wn + j * 8 + 2 * t + e % 2)
            for i in range(2) for j in range(p.bn // 16) for e in range(4)]


@pytest.mark.parametrize("bn", [64, 96, 128])
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_gemm_thread_maps_cover_the_tile_once(dtype, bn):
    """Each output of a tile is accumulated and stored by one thread
    (one mma slot), and each 16-byte chunk of a staged K slab is copied by
    one thread — so no sum is split or repeated."""
    M, N, K, desc = bn * 4, bn, 4 * 16 * 2, bg.rowmajor_desc(bn * 4, 128,
                                                             bn)
    p = bg.plan(M, N, K, dtype, desc)
    assert p.bn == bn
    cover = np.zeros((p.bm, p.bn), dtype=np.int32)
    for tid in range(p.threads):
        for r, c in _thread_outputs(p, tid):
            cover[r, c] += 1
    assert (cover == 1).all()
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    cpr = p.bk // vec
    for rows in (p.bm, p.bn):
        per = -(-rows * cpr // p.threads)
        chunks = [tid + q * p.threads for tid in range(p.threads)
                  for q in range(per) if tid + q * p.threads < rows * cpr]
        assert sorted(chunks) == list(range(rows * cpr))
    assert p.smem <= 227 * 1024


def _guarded_rk(e, kfast, rows, bk):
    """``guarded_rk``: element e of a rows × bk slab on the guarded path."""
    if kfast:
        return e // bk, e % bk
    rl, kl, q = e & 7, (e >> 3) & 3, e >> 5
    return (q % (rows // 8)) * 8 + rl, (q // (rows // 8)) * 4 + kl


@pytest.mark.parametrize("kfast", [True, False])
@pytest.mark.parametrize("rows,bk", [(64, 16), (64, 32), (96, 32),
                                     (128, 16), (128, 32)])
def test_guarded_staging_map_is_a_bijection(rows, bk, kfast):
    """The guarded path copies every element of a slab exactly once; with
    rows the contiguous index, a warp's 32 copies take 8 rows × 4 k."""
    got = [_guarded_rk(e, kfast, rows, bk) for e in range(rows * bk)]
    assert sorted(got) == [(r, k) for r in range(rows) for k in range(bk)]
    if not kfast:
        warp = got[:32]
        assert {r for r, _ in warp} == set(range(8))
        assert {k for _, k in warp} == set(range(4))


def _swizzled_f64(r, k):
    """``DmmaCore::at``: 32 f64 per row (BK = 32), bit 2 of the 16-byte
    chunk index flipped on odd rows."""
    return r * 32 + (((k >> 1) ^ ((r & 1) << 2)) << 1) + (k & 1)


def test_dmma_shared_layout_is_a_bijection_and_conflict_free():
    """The f64 tile layout puts every (row, k) in its own slot, and the 8
    lanes of a quarter-warp (rows g, g+1 of a 16-row fragment; k pairs
    2t, 2t+1 of a k8 step) read 8 distinct 16-byte bank groups."""
    assert bg.plan(64, 96, 64, torch.float64,
                   bg.rowmajor_desc(64, 64, 96)).bk == 32
    slots = {_swizzled_f64(r, k) for r in range(128) for k in range(32)}
    assert slots == set(range(128 * 32))
    for base in (0, 16, 48):
        for kk in range(4):
            for quarter in range(4):
                groups = set()
                for lane in range(8 * quarter, 8 * quarter + 8):
                    g, t = lane // 4, lane % 4
                    off = _swizzled_f64(base + g, kk * 8 + 2 * t)
                    assert off % 2 == 0            # 16-byte aligned pair
                    groups.add((off * 8 // 16) % 8)
                assert len(groups) == 8


@pytest.mark.parametrize("setting", ["fem_nk1", "fem_nk14", "dg"])
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_gemm_plan_is_the_same_for_every_Z(dtype, setting):
    nbr, nbc, nk, b = {"fem_nk1": (32, 64, 1, 96),
                       "fem_nk14": (32, 64, 14, 96),
                       "dg": (32, 64, 1, 128)}[setting]
    plans = set()
    for Z in (1, 2, 3, 8, 16):
        M, N, K, desc = _blocked(Z, nbr, nbc, nk, b, dtype)
        p = bg.plan(M, N, K, dtype, desc)
        plans.add(p)
        assert p.grid(M, N, Z)[2] == Z
    assert len(plans) == 1


@pytest.mark.parametrize("b", [96, 128])
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_blocked_bk_divides_b_and_stages_by_cp_async(dtype, b):
    """On the level product BK divides b (a K slab never straddles a column
    block of A⁻¹ or a row block of Û), BN = b, and both operands are
    K-contiguous and aligned: cp.async staging."""
    M, N, K, desc = _blocked(8, 4, 6, 3, b, dtype)
    p = bg.plan(M, N, K, dtype, desc)
    assert b % p.bk == 0
    assert p.bn == b
    assert p.a_async and p.b_async
    # on an arena view (a leading rank axis, a slot offset) as well
    arena = torch.empty(2, 8, 50, b, b, dtype=dtype)
    a = arena[:, :, :4 * 6].unflatten(2, (4, 6))
    o = arena[:, :, 30:30 + 3 * 4].unflatten(2, (3, 4))
    u = torch.empty(2, 8, 3, 6, b, b, dtype=dtype)
    a, u, o = (t.flatten(0, 1) for t in (a, u, o))
    q = bg.plan(M, N, K, dtype, bg.blocked_desc(a.stride(), u.stride(),
                                                o.stride(), b),
                (a.data_ptr() % 256, u.data_ptr() % 256))
    assert (q.bk, q.bn, q.a_async, q.b_async) == (p.bk, b, True, True)


def _misaligned_cases(dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    M, N, K, desc = _blocked(2, 4, 6, 2, 96, dtype)
    d = list(desc)
    odd_ri = list(d)
    odd_ri[3] = d[3] + 1                # A's row stride off the 16 bytes
    b_nk = list(d)
    b_nk[3] = 96                        # B not K-contiguous (ri != 1)
    return {
        "row_length_17": (33, 129, 17, bg.rowmajor_desc(33, 17, 129),
                          (0, 0), (False, False)),
        "a_pointer": (M, N, K, desc, (elt, 0), (False, True)),
        "b_pointer": (M, N, K, desc, (0, 16 + elt), (True, False)),
        "a_row_stride": (M, N, K, tuple(odd_ri), (0, 0), (False, True)),
        "b_not_k_contiguous": (M, N, K, tuple(b_nk[:7]) + (d[7], 96, d[9],
                                                        96, 96, d[12], 1)
                               + tuple(d[14:]), (0, 0), (True, False)),
    }


@pytest.mark.parametrize("case", list(_misaligned_cases(torch.float64)))
@pytest.mark.parametrize("dtype", GEMM_TYPES)
def test_gemm_cp_async_never_on_a_misaligned_operand(dtype, case):
    M, N, K, desc, addrs, want = _misaligned_cases(dtype)[case]
    p = bg.plan(M, N, K, dtype, desc, addrs)
    assert (p.a_async, p.b_async) == want


@pytest.mark.parametrize("BH", [(1, 1), (2, 3), (1, 64), (4, 16)])
@pytest.mark.parametrize("S", [200, 256, 4096])
def test_flash_causal_launch_order_is_a_permutation(S, BH):
    """Every (b·h, q tile) is launched once; on a causal run the first B·H
    blocks take the last (heaviest) q tile, the order never rises, and the
    q tiles cover the sequence exactly."""
    B, H = BH
    p = fa.plan(B, S, H, 128, torch.bfloat16, True)
    order = p.launch_order()
    nq = -(-S // p.bq)
    assert (nq - 1) * p.bq < S <= nq * p.bq
    assert sorted(order) == sorted(list(range(nq)) * (B * H))
    assert order[:B * H] == [nq - 1] * (B * H)
    assert all(x >= y for x, y in zip(order, order[1:]))
    assert fa.plan(B, S, H, 128, torch.bfloat16, False).launch_order() \
        == sorted(order)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_plan_is_the_same_for_every_BH(dtype, hd):
    keys = set()
    for B, H in ((1, 1), (1, 64), (2, 3), (8, 8)):
        for causal in (True, False):
            p = fa.plan(B, 4096, H, hd, dtype, causal)
            keys.add((p.variant, p.bq, p.bk, p.warps, p.stages, p.smem))
            assert B * H in p.grid
    assert len(keys) == 1
    assert next(iter(keys))[0] == ("hmma_cpasync" if dtype == torch.bfloat16
                                   else "fma_f32")


@pytest.mark.parametrize("case", ["q_pointer", "v_pointer", "seq_stride",
                                  "head_stride", "batch_stride"])
def test_flash_cp_async_never_on_a_misaligned_operand(case):
    """Packed-qkv views are aligned; a base pointer or a stride off the 16
    bytes sends the launch to the guarded element loads."""
    B, S, H, hd = 2, 200, 3, 64
    packed = (S * 3 * H * hd, 3 * H * hd, hd)
    strides, addrs = [packed] * 3, [0, 2 * H * hd * 2, 4 * H * hd * 2]
    assert fa.plan(B, S, H, hd, torch.bfloat16, True, strides,
                   addrs).variant == "hmma_cpasync"
    if case == "q_pointer":
        addrs = [2, addrs[1], addrs[2]]
    elif case == "v_pointer":
        addrs = [addrs[0], addrs[1], addrs[2] + 8]
    else:
        i = ("batch_stride", "seq_stride", "head_stride").index(case)
        bad = list(packed)
        bad[i] += 1
        strides = [packed, tuple(bad), packed]
    assert fa.plan(B, S, H, hd, torch.bfloat16, True, strides,
                   addrs).variant == "hmma_guarded"


# ---- trsm and RMSNorm (csrc/trsm.cu, csrc/rmsnorm.cu) ----------------------

# chip_smoke.TRSM_SHAPES, and the serial path's stacked struct(K) solves at
# k = 96 (a few to thirty 96-row blocks)
TRSM_CASES = [(64, 32), (100, 64), (130, 48), (96, 96), (1440, 96),
              (4096, 256), (960, 96), (2880, 96), (1, 1), (33, 250)]
TRSM_TYPES = [torch.float64, torch.float32, torch.bfloat16]


def _trsm_outputs(p, m, k, block, warp):
    """The (row, column) outputs warp ``warp`` of block ``block`` stores,
    as ``csrc/trsm.cu`` maps them: RPW rows of the warp, lane c on column
    p0 + c of each 32-column panel."""
    row0 = block * p.rows + warp * tk.RPW
    kpad = -(-k // tk.PW) * tk.PW
    return [(row0 + rr, p0 + lane) for p0 in range(0, kpad, tk.PW)
            for rr in range(tk.RPW) for lane in range(32)
            if row0 + rr < m and p0 + lane < k]


@pytest.mark.parametrize("m,k", TRSM_CASES)
@pytest.mark.parametrize("dtype", TRSM_TYPES)
def test_trsm_plan_covers_each_output_once(dtype, m, k):
    p = tk.plan(m, k, dtype)
    assert p.rows == tk.RPW * p.warps and p.warps in tk.WARPS
    gx, gz = p.grid(m, 3)
    assert gz == 3 and (gx - 1) * p.rows < m <= gx * p.rows
    cover = np.zeros((m, k), dtype=np.int32)
    for block in range(gx):
        for warp in range(p.warps):
            for r, c in _trsm_outputs(p, m, k, block, warp):
                cover[r, c] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("m,k", TRSM_CASES)
@pytest.mark.parametrize("dtype", TRSM_TYPES)
def test_trsm_plan_fills_the_card_and_fits_shared_memory(dtype, m, k):
    """Four warps a block while eight-warp blocks would leave more than
    half the SMs idle, eight from there (4096 x 256: 128 blocks of 32
    rows); the resident variant whenever the whole triangle fits a block,
    the streamed one otherwise; neither passes the block limit. The plan
    never looks at Z."""
    p = tk.plan(m, k, dtype)
    assert p.warps == (8 if -(-m // 32) >= tk.SMS // 2 else 4)
    if m >= 32 * tk.SMS:
        assert p.grid(m, 1)[0] >= tk.SMS
    assert p.smem <= tk.SMEM_LIMIT
    acc = 8 if dtype == torch.float64 else 4
    kpad = -(-k // tk.PW) * tk.PW
    np_ = kpad // tk.PW
    resident = (kpad + 512 * np_ * (np_ + 1) + p.rows * kpad) * acc
    assert (p.variant, p.group, p.smem) == (
        ("rcp_resident", np_, resident) if resident <= tk.SMEM_LIMIT else
        ("rcp_streamed", 1, (kpad + kpad * tk.PW + p.rows * kpad) * acc))
    assert {tk.plan(m, k, dtype).grid(m, Z)[0] for Z in (1, 2, 8)} \
        == {p.grid(m, 1)[0]}


def test_trsm_plan_of_the_serial_path_is_resident():
    """The serial path's k <= 96 solves in f64 stage all of U once."""
    for m in (8, 96, 960, 2880):
        for k in (32, 48, 64, 96):
            assert tk.plan(m, k, torch.float64).variant == "rcp_resident"
    assert tk.plan(4096, 256, torch.float64).variant == "rcp_streamed"
    assert tk.plan(4096, 256, torch.float32).variant == "rcp_resident"
    assert tk.plan(4096, 256, torch.float64).rows == 32
    assert tk.plan(1440, 96, torch.float64).rows == 16


def _rms_slots(p, d):
    """Every element of a row, as often as the one-read kernel touches
    it: thread gid of the row holds packs gid + q·g, q < ppt, of
    ``width`` elements each (the last one guarded by c < d)."""
    cover = np.zeros(d, dtype=np.int32)
    for gid in range(p.g):
        for q in range(p.ppt):
            c = (gid + q * p.g) * p.width
            if c < d:
                cover[c:c + p.width] += 1
    return cover


RMS_CASES = [(5120, torch.bfloat16), (5120, torch.float32),
             (128, torch.bfloat16), (128, torch.float32),
             (1001, torch.bfloat16), (1001, torch.float32),
             (1024, torch.bfloat16), (16384, torch.bfloat16),
             (16384, torch.float32), (256, torch.float32),
             (512, torch.float32), (3, torch.float32),
             (16384 - 8, torch.float32), (4096, torch.float32)]


@pytest.mark.parametrize("d,dtype", RMS_CASES)
def test_rmsnorm_plan_covers_each_element_once(d, dtype):
    p = rk.plan(4096, d, dtype)
    assert p.variant == "one_read"
    assert (_rms_slots(p, d) == 1).all()
    assert p.ppt in rk.PPTS and p.ppt * p.width <= rk.MAX_ELEMS
    assert p.threads % 32 == 0 and p.threads <= rk.MAX_THREADS
    if p.g <= 32:
        assert p.g & (p.g - 1) == 0 and p.threads == rk.WARP_ROW_BLOCK
    else:
        assert p.g == p.threads and p.g % 32 == 0
    # rows per block tile the rows
    assert p.grid(4096) * p.rows_per_block() >= 4096
    assert (p.grid(4096) - 1) * p.rows_per_block() < 4096


@pytest.mark.parametrize("d,dtype,g,ppt", [
    (5120, torch.bfloat16, 320, 2), (128, torch.bfloat16, 16, 1),
    (128, torch.float32, 32, 1), (5120, torch.float32, 320, 4)])
def test_rmsnorm_plan_has_no_idle_pass(d, dtype, g, ppt):
    """qwen3-32b's d_model and head_dim: every slot of every thread holds
    a pack of the row (320 threads x 2 packs at d = 5120 bf16; 16 threads
    x 1 pack, two rows a warp, at d = 128 bf16)."""
    p = rk.plan(4096, d, dtype)
    assert (p.g, p.ppt, p.vec) == (g, ppt, True)
    assert p.g * p.ppt * p.width == d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_two_pass_only_past_the_register_budget(dtype):
    """One read up to 512 threads x 32 elements (16-byte packs) or x 8
    elements (element loads); the two-pass variant past that."""
    budget = rk.MAX_THREADS * rk.MAX_ELEMS
    per = 16 // dtype.itemsize
    elems = rk.MAX_THREADS * max(rk.PPTS)
    assert rk.plan(1, budget, dtype).variant == "one_read"
    assert rk.plan(1, budget + per, dtype).variant == "two_pass"
    assert rk.plan(1, budget, dtype, aligned=False).variant == "two_pass"
    assert rk.plan(1, elems, dtype, aligned=False).variant == "one_read"
    assert rk.plan(1, elems + 1, dtype).variant == "two_pass"
    for d in (1, 7, 128, 1001, 4096, 5120, 12000, 16384):
        assert rk.plan(1, d, dtype).variant == "one_read"
    p = rk.plan(1, 2 * budget, dtype)
    assert (p.ppt, p.threads) == (0, rk.TWO_PASS_THREADS)


@pytest.mark.parametrize("d,dtype", RMS_CASES)
def test_rmsnorm_plan_is_the_same_for_every_batch(d, dtype):
    plans = {rk.plan(rows, d, dtype) for rows in (1, 7, 64, 4096, 262144)}
    assert len(plans) == 1


@pytest.mark.parametrize("tool", [launch_cost, trsm_sweep])
def test_card_timing_tools_refuse_the_cpu(tool):
    """The wrapper-cost and plan-sweep tools time the card only: on the
    CPU they raise before timing anything."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.run(device="cpu")


def test_trsm_sweep_covers_the_plans_of_its_shapes():
    """Each shape's plan is one of the choices the sweep times."""
    for m, k, dt in trsm_sweep.SHAPES:
        p = tk.plan(m, k, dt)
        kpad = -(-k // tk.PW) * tk.PW
        assert p.warps in (2, 4, 8) and p.group in {kpad // tk.PW, 1}
