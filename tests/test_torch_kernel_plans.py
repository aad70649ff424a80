"""The launch plans of the redesigned Hopper kernels, on the CPU.

``block_gemm.plan`` and ``flash_attention.plan`` are pure Python: they
choose each launch's variant, tile, staging and (for flash) launch order,
and the CUDA entries take that choice as it is. These tests hold the
choices to the kernels' contracts without a card: every output element is
covered by exactly one block and one thread, the choice never depends on
the batch (Z, or B·H), K slabs never straddle a b-wide block, the cp.async
path is never chosen for an operand it would read misaligned, and the
causal launch order is a permutation of the q tiles, heaviest first.

The thread maps below mirror ``csrc/block_gemm.cu`` (``DmmaCore``,
``HmmaCore``, ``FmaCore``: ``each``, ``at``; ``stage_async``,
``guarded_rk``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_gemm as bg
from repro_torch.kernels import flash_attention as fa

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
