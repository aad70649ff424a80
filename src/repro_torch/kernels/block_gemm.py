"""Batched block-strided GEMM — the wrapper of the hand-written Hopper
kernel in ``csrc/block_gemm.cu`` (which replaces the TPU kernel
``repro/kernels/block_gemm.py:block_gemm_pallas``; the note at the head
of the source says what bounds it and what its design does about that).

Two entry points share the one kernel:

* :func:`block_gemm` — ``alpha · (a @ b)`` for contiguous row-major
  ``(…, m, k) @ (…, k, n)`` stacks;
* :func:`blocked_gemm` — the selected-inversion sweep's level product
  ``partial[z, k, i] = Σ_j ainv[z, i, j] @ uh[z, k, j]ᵀ`` over blocked
  ``(Z, nbr, nbc, b, b)`` / ``(Z, nk, nbc, b, b)`` tensors, read (and
  written, through ``out``) where they lie — views into the sweep's
  arena included — without the reshape copies of the JAX package; with
  the level's struct mask, the sum runs over the kept ``j`` only.

A CPU tensor goes to the plain PyTorch version beside each entry point
(:func:`block_gemm_plain`, :func:`blocked_gemm_plain`): the same
function, accumulated in the accumulate type. A CUDA tensor launches the
kernel or raises; nothing falls back. ``launches`` counts kernel
launches, and only those.

:func:`plan` — pure Python, no card needed — chooses the kernel's
variant, tile and staging for each launch; the C entry takes its choice
as it is."""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from . import _build

__all__ = ["block_gemm", "blocked_gemm", "block_gemm_plain",
           "blocked_gemm_plain", "mask_uh", "acc_dtype", "launches",
           "SUPPORTED", "plans", "GemmPlan", "plan", "rowmajor_desc",
           "blocked_desc", "MASKED_BS"]

#: kernel launches since import (or since a caller last reset it)
launches = 0
#: the same launches by (variant, bn, a_async, b_async) of their plan,
#: and "masked" last for those whose K loop the struct mask cut
plans: collections.Counter = collections.Counter()

#: dtype → the kernel's type code (f32 / bf16 / f64)
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

_fn = None


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulate type: f64 for f64 input, f32 for f32 and bf16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---- the launch plan ---------------------------------------------------------

#: per type: (variant, BM, BK, stages, threads for a BN) — the compiled
#: instances of ``csrc/block_gemm.cu`` (its head note says why each)
_TILES = {
    torch.float64: ("dmma_f64", 64, 32, 2, lambda bn: 128),
    torch.bfloat16: ("hmma_bf16", 64, 32, 3, lambda bn: 128),
    torch.float32: ("fma_f32", 128, 16, 3, lambda bn: 2 * bn),
}
#: the compiled N tiles
BNS = (64, 96, 128)
#: the column blocks b that a level product takes as its N tile: BN = b
#: makes an N tile one k, so a block reads one row of the struct mask and
#: the kernel masks the product itself
MASKED_BS = BNS[1:]
_ELT = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2}


@dataclass(frozen=True)
class GemmPlan:
    """One launch's kernel choice: variant (instruction route), the block
    tile ``bm × bn`` with ``bk``-deep K slabs in a ring of ``stages``,
    ``threads`` per block, ``smem`` bytes of dynamic shared memory, and
    whether each operand is staged by ``cp.async`` (else by guarded element
    loads)."""
    variant: str
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    smem: int
    a_async: bool
    b_async: bool

    def grid(self, M: int, N: int, Z: int) -> tuple:
        """Blocks along (N, M, Z), as the kernel's grid."""
        return (-(-N // self.bn), -(-M // self.bm), Z)

    def tiles(self, M: int, N: int):
        """The (m0, n0) corner of every output tile one z's blocks own."""
        gx, gy, _ = self.grid(M, N, 1)
        return [(y * self.bm, x * self.bn) for y in range(gy)
                for x in range(gx)]


def rowmajor_desc(m: int, k: int, n: int) -> tuple:
    """The 21-value descriptor of contiguous row-major (…, m, k) @
    (…, k, n) → (…, m, n) stacks: (sz, rblk, ro, ri, cblk, co, ci) per
    operand, in elements."""
    return (m * k, m, 0, k, k, 0, 1,
            k * n, k, 0, n, n, 0, 1,
            m * n, m, 0, n, n, 0, 1)


def blocked_desc(sa: Sequence[int], sb: Sequence[int], so: Sequence[int],
                 b: int) -> tuple:
    """The descriptor of the level product from the strides of ``ainv``
    (Z, nbr, nbc, b, b), ``uh`` (Z, nk, nbc, b, b) and ``out`` (Z, nk,
    nbr, b, b): A⁻¹ as (nbr·b) × (nbc·b), Û transposed per block as
    (nbc·b) × (nk·b), the partials as (nbr·b) × (nk·b)."""
    return (sa[0], b, sa[1], sa[3], b, sa[2], sa[4],    # A: (i,a) x (j,c)
            sb[0], b, sb[2], sb[4], b, sb[1], sb[3],    # B: (j,x) x (k,y)
            so[0], b, so[2], so[3], b, so[1], so[4])    # C: (i,a) x (k,y)


def plan(M: int, N: int, K: int, dtype: torch.dtype, desc: Sequence[int],
         addrs: Sequence[int] = (0, 0)) -> GemmPlan:
    """The kernel choice for one launch of ``M × N × K`` per z, from the
    operands' descriptor and their base addresses (``addrs``: A, B). It
    never looks at Z, so every batch size runs the same tile in the same
    K order.

    BN follows the blocks of B's columns — b on the level product (96 or
    128), so a narrow level reads its A⁻¹ panel once — else N's largest
    divisor in :data:`BNS`, else 64. An operand is staged by ``cp.async``
    only when it is K-contiguous (A: ci = 1; B: ri = 1), its K blocks and
    K are multiples of BK (so a slab never straddles a block) and its base
    and every stride are 16-byte aligned; otherwise by guarded element
    loads."""
    if dtype not in _TILES:
        raise TypeError(f"block_gemm takes {sorted(map(str, SUPPORTED))}, "
                        f"got {dtype}")
    return _plan(M, N, K, dtype, tuple(int(x) for x in desc[:14]),
                 addrs[0] % 16, addrs[1] % 16)


@functools.lru_cache(maxsize=4096)
def _plan(M, N, K, dtype, desc, a_mis, b_mis) -> GemmPlan:
    # cached: the serial path asks for the same few plans thousands of times
    variant, bm, bk, stages, threads = _TILES[dtype]
    elt = _ELT[dtype]
    vec = 16 // elt
    a, bd = desc[0:7], desc[7:14]
    cblk_b = bd[4]
    if cblk_b in MASKED_BS:
        bn = cblk_b
    else:
        bn = next((c for c in BNS[::-1] if N % c == 0), BNS[0])

    def ok(mis, strides):
        return mis == 0 and all(x % vec == 0 for x in strides)

    a_async = (a[6] == 1 and a[4] % bk == 0 and K % bk == 0
               and ok(a_mis, (a[0], a[2], a[3], a[5])))
    b_async = (bd[3] == 1 and bd[1] % bk == 0 and K % bk == 0
               and ok(b_mis, (bd[0], bd[2], bd[5], bd[6])))
    ld = {"dmma_f64": bk, "hmma_bf16": bk + 8, "fma_f32": bk + 4}[variant]
    # the stages, then one int64 offset per tile row of A and column of B
    smem = stages * (bm + bn) * ld * elt + 8 * (bm + bn)
    return GemmPlan(variant, bm, bn, bk, stages, threads(bn), smem, a_async,
                    b_async)


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("block_gemm").block_gemm_launch
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_double,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _check(*ts: torch.Tensor) -> str:
    """Common device/dtype checks; returns the device type."""
    dt, dev = ts[0].dtype, ts[0].device
    if dt not in SUPPORTED:
        raise TypeError(f"block_gemm takes {sorted(map(str, SUPPORTED))}, "
                        f"got {dt}")
    for t in ts[1:]:
        if t.dtype != dt:
            raise TypeError(f"dtype mismatch: {dt} vs {t.dtype}")
        if t.device != dev:
            raise ValueError(f"device mismatch: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"block_gemm runs on cpu or cuda, got {dev}")
    return dev.type


def _launch(a, b, c, M, N, K, Z, alpha, desc, mask=None) -> None:
    """One kernel launch on the current stream, as :func:`plan` chooses
    it; ``mask``, a bool (Pm, nk, nbc) struct mask, cuts the K loop to
    the column blocks it keeps. Raises on a refused launch (the C side
    returns ``cudaGetLastError()``)."""
    global launches
    if Z > 65535:
        raise ValueError(f"batch {Z} exceeds the grid's z limit 65535")
    p = plan(M, N, K, a.dtype, desc, (a.data_ptr(), b.data_ptr()))
    arr = (ctypes.c_longlong * 21)(*[int(v) for v in desc])
    if mask is None:
        mptr, pm, nbc, mst = None, 0, 0, None
    else:
        mptr, pm, nbc = mask.data_ptr(), mask.shape[0], mask.shape[2]
        mst = (ctypes.c_longlong * 3)(*mask.stride())
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _kernel()(SUPPORTED[a.dtype], p.bm, p.bn, p.bk,
                        int(p.a_async), int(p.b_async), a.data_ptr(),
                        b.data_ptr(), c.data_ptr(), M, N, K, Z,
                        float(alpha), arr, mptr, pm, nbc, mst, stream)
    if err != 0:
        raise RuntimeError(f"block_gemm kernel launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, K={K}, Z={Z}, "
                           f"{a.dtype}, {p}, masked={mask is not None})")
    launches += 1
    key = (p.variant, p.bn, p.a_async, p.b_async)
    plans[key + ("masked",) if mask is not None else key] += 1


# ---- row-major stacks ------------------------------------------------------

def block_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     alpha: float = 1.0) -> torch.Tensor:
    """``alpha · (a @ b)`` in the accumulate type, cast back."""
    acc = acc_dtype(a.dtype)
    return (alpha * (a.to(acc) @ b.to(acc))).to(a.dtype)


def block_gemm(a: torch.Tensor, b: torch.Tensor,
               alpha: float = 1.0) -> torch.Tensor:
    """``alpha · (a @ b)`` for ``a (…, m, k)``, ``b (…, k, n)`` with equal
    leading (batch) dims; returns ``(…, m, n)`` in the input dtype."""
    dev = _check(a, b)
    if a.dim() < 2 or b.dim() != a.dim() or a.shape[:-2] != b.shape[:-2] \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"block_gemm shapes do not chain: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if dev == "cpu":
        return block_gemm_plain(a, b, alpha)
    if dev == "meta":                 # shapes only (the verifier's sweep)
        return a.new_empty(a.shape[:-1] + b.shape[-1:])
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_gemm takes contiguous operands")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    lead = a.shape[:-2]
    Z = math.prod(lead)
    c = torch.empty(lead + (m, n), dtype=a.dtype, device=a.device)
    if Z and m and n:
        _launch(a, b, c, m, n, k, Z, alpha, rowmajor_desc(m, k, n))
    return c


# ---- the sweep's blocked level product ------------------------------------

def mask_uh(uh: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    """``where(cmask, uh, 0)`` with item z of ``uh (Z, nk, nbc, b, b)``
    masked by row ``z % Pm`` of the bool ``cmask (Pm, nk, nbc)``: the Û
    the dense level product multiplies."""
    cm = cmask.repeat(uh.shape[0] // cmask.shape[0], 1, 1)
    return torch.where(cm[..., None, None], uh, 0.0)


def blocked_gemm_plain(ainv: torch.Tensor, uh: torch.Tensor) -> torch.Tensor:
    """``partial[z, k, i] = Σ_j ainv[z, i, j] @ uh[z, k, j]ᵀ`` as one 2-D
    product per z (the JAX package's reshape/transpose layout,
    ``repro/kernels/ops.py:49-57``), in the accumulate type. One fixed
    shape per z keeps the result independent of the batch size."""
    Z, nbr, nbc, b, _ = ainv.shape
    nk = uh.shape[1]
    acc = acc_dtype(ainv.dtype)
    if Z == 0:
        return ainv.new_empty((0, nk, nbr, b, b))
    outs = []
    for z in range(Z):
        a2 = ainv[z].to(acc).permute(0, 2, 1, 3).reshape(nbr * b, nbc * b)
        b2 = uh[z].to(acc).permute(1, 3, 0, 2).reshape(nbc * b, nk * b)
        outs.append((a2 @ b2).reshape(nbr, b, nk, b).permute(2, 0, 1, 3))
    return torch.stack(outs).to(ainv.dtype)


def blocked_gemm(ainv: torch.Tensor, uh: torch.Tensor,
                 out: torch.Tensor | None = None,
                 cmask: torch.Tensor | None = None) -> torch.Tensor:
    """The level product over ``ainv (Z, nbr, nbc, b, b)`` and
    ``uh (Z, nk, nbc, b, b)``, returning ``(Z, nk, nbr, b, b)``. Each
    (b, b) block must be contiguous; the block grids may be strided
    views. ``out``, when given, receives the result in place and must
    not overlap the inputs.

    ``cmask``, when given, is the level's struct mask ``(Pm, nk, nbc)``,
    bool or 0/1 values, with Z a multiple of Pm: item z sums over the
    column blocks j that row ``z % Pm`` keeps, the product with
    :func:`mask_uh`. For b in :data:`MASKED_BS` on the card the kernel
    reads the mask where it lies and skips the other blocks, bitwise the
    dense product of the masked Û (A⁻¹ finite); for any other b, and on
    the CPU, Û is masked first and the product is dense."""
    dev = _check(ainv, uh) if out is None else _check(ainv, uh, out)
    if ainv.dim() != 5 or uh.dim() != 5:
        raise ValueError(f"blocked_gemm takes rank-5 block grids, got "
                         f"{tuple(ainv.shape)} and {tuple(uh.shape)}")
    Z, nbr, nbc, b, b2 = ainv.shape
    nk = uh.shape[1]
    if b != b2 or uh.shape != (Z, nk, nbc, b, b):
        raise ValueError(f"blocked_gemm shapes do not chain: "
                         f"{tuple(ainv.shape)} x {tuple(uh.shape)}")
    oshape = (Z, nk, nbr, b, b)
    if out is not None and tuple(out.shape) != oshape:
        raise ValueError(f"out has shape {tuple(out.shape)}, "
                         f"expected {oshape}")
    if cmask is not None:
        if cmask.dim() != 3 or tuple(cmask.shape[1:]) != (nk, nbc) \
                or not cmask.shape[0] or Z % cmask.shape[0]:
            raise ValueError(f"cmask has shape {tuple(cmask.shape)}, "
                             f"expected (Pm, {nk}, {nbc}) with Pm "
                             f"dividing Z = {Z}")
        if cmask.device != ainv.device:
            raise ValueError(f"device mismatch: {ainv.device} vs "
                             f"{cmask.device}")
        if cmask.dtype != torch.bool:
            cmask = cmask != 0
        if dev != "cuda" or b not in MASKED_BS:
            uh, cmask = mask_uh(uh, cmask), None
    if dev == "cpu":
        res = blocked_gemm_plain(ainv, uh)
        if out is None:
            return res
        return out.copy_(res)
    if dev == "meta":                 # shapes only (the verifier's sweep)
        return ainv.new_empty(oshape) if out is None else out
    if out is None:
        out = torch.empty(oshape, dtype=ainv.dtype, device=ainv.device)
    for name, t in (("ainv", ainv), ("uh", uh), ("out", out)):
        if t.stride(-1) != 1 or t.stride(-2) != b:
            raise ValueError(f"blocked_gemm needs contiguous (b, b) blocks "
                             f"in {name}, got strides {t.stride()}")
    if Z and nbr and nk:
        desc = blocked_desc(ainv.stride(), uh.stride(), out.stride(), b)
        _launch(ainv, uh, out, nbr * b, nk * b, nbc * b, Z, 1.0, desc,
                cmask)
    return out
