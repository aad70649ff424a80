"""Flash attention backward over ``(B, S, H, hd)`` — the wrapper of the
hand-written Hopper kernel in ``csrc/flash_attention_bwd.cu``, the
gradient of the forward in ``csrc/flash_attention.cu``. The TPU kernel
``repro/kernels/flash_attention.py:flash_attention_pallas`` has no
backward (the JAX package differentiates its chunked jnp attention); the
note at the head of the source says what bounds this one and what its
design does about that.

A CPU tensor goes to the plain PyTorch version,
:func:`flash_attention_bwd_plain` (``ref.flash_attention_bwd_ref``: the
kernel's arithmetic in one tile). A CUDA tensor launches the kernel or
raises; nothing falls back. ``launches`` counts calls that launched the
kernel (three kernels a call: D, dK/dV, dQ), and only those; ``plans``
counts them by variant. :func:`plan` — pure Python — chooses the variant
and the tiles, and :func:`tensor_map` the TMA maps of the ``wgmma_tma``
route; the C entry takes both as they are."""
from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from . import _build
from .ref import flash_attention_bwd_ref as flash_attention_bwd_plain

__all__ = ["flash_attention_bwd", "flash_attention_bwd_plain", "launches",
           "plans", "SUPPORTED", "HEAD_DIMS", "VARIANTS", "BwdPlan", "plan",
           "TensorMap", "tensor_map"]

#: calls that launched the kernel since import (or a caller's reset)
launches = 0
#: the same calls by the variant of their plan
plans: collections.Counter = collections.Counter()

SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
#: the C entry's variant codes
VARIANTS = {"fma_f32": 0, "hmma_guarded": 2, "wgmma_tma": 3}
BQ, THREADS = 64, 128
#: wgmma_tma: rows of a tile (one warpgroup's 64-row M, one TMA box),
#: consumer warpgroups a block, the ring's stages by head width, the keys
#: of a dK/dV block by head width (at hd 128 both warpgroups take the
#: same 64 keys, one accumulating dV and the other dK), and the bytes of a
#: swizzle atom (the inner extent of a box)
TILE, WARPGROUPS, SWIZZLE = 64, 2, 128
STAGES = {64: 4, 128: 3}
DKDV_KEYS = {64: 128, 128: 64}

_fn = None


@dataclass(frozen=True)
class BwdPlan:
    """One call's kernel choice: the variant (``fma_f32`` on the FMA
    units; ``wgmma_tma`` on the tensor cores by wgmma, tiles by TMA through
    a ring, or ``hmma_guarded`` by mma.sync, tiles by guarded element
    loads), ``bq`` and ``bk`` (fma: 64 q rows by ``bk`` keys a tile; hmma:
    ``bq`` q rows a dK/dV step, ``bk`` keys a dQ step; wgmma: the 64 rows of
    a ring stage), the threads of a block, the dK/dV grid (B·H, key tiles)
    and the dQ grid (B·H, q tiles), the dynamic shared memory of each, the
    ring's ``stages``, the consumer ``warpgroups`` of a block (0 off the
    wgmma route), ``dkdv_tile`` (keys a block, q rows a step), ``dq_tile``
    (q rows a block, keys a step), and whether the dQ blocks take their q
    tiles last first (causal)."""
    variant: str
    bq: int
    bk: int
    dkdv_grid: tuple
    dq_grid: tuple
    dkdv_smem: int
    dq_smem: int
    threads: int = THREADS
    stages: int = 1
    warpgroups: int = 0
    dkdv_tile: tuple = ()
    dq_tile: tuple = ()
    heavy_first: bool = False

    def dq_order(self) -> list:
        """The q tile (of ``dq_tile[0]`` rows) each dQ block takes, in the
        order the blocks are numbered (x fastest): under ``heavy_first``
        every head's last tile, whose key loop is the longest, first."""
        nbh, nq = self.dq_grid
        return [(nq - 1 - y) if self.heavy_first else y
                for y in range(nq) for _ in range(nbh)]


def plan(B: int, S: int, H: int, hd: int, dtype: torch.dtype,
         strides: Sequence[Sequence[int]] | None = None,
         addrs: Sequence[int] = (0,) * 8, causal: bool = True) -> BwdPlan:
    """f32 takes the FMA kernel at 64 q rows by 64 keys (hd 64) or 32
    keys (hd 128), so each thread's dK and dV accumulators are 32 f32
    each at either width. bf16 whose every base address (``addrs`` of q,
    k, v, out, dout, dq, dk, dv) and (batch, seq, head) stride is 16-byte
    aligned takes ``wgmma_tma``: blocks of two consumer warpgroups and a
    producer warpgroup, 128 keys a dK/dV block at hd 64 (64 at hd 128)
    and 128 q rows a dQ block, 64-row tiles through a ring of 4 (hd 64) or
    3 (hd 128) stages. Other bf16 takes ``hmma_guarded``: 64 keys a dK/dV
    block (4 warps of 16) against 64 (hd 64) or 32 (hd 128) q rows a step,
    64 q rows a dQ block against 64 or 32 keys a step."""
    if dtype not in SUPPORTED:
        raise TypeError(f"flash_attention_bwd takes "
                        f"{sorted(map(str, SUPPORTED))} on the card, got "
                        f"{dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd takes hd in {HEAD_DIMS}, got "
                         f"{hd}")
    t = 64 if hd == 64 else 32
    if dtype == torch.float32:
        tiles = 4 * ((2 * BQ + 2 * t) * (hd + 1) + 2 * BQ)
        return BwdPlan("fma_f32", BQ, t, (B * H, -(-S // t)),
                       (B * H, -(-S // BQ)), tiles + 4 * 2 * BQ * (t + 1),
                       tiles + 4 * BQ * (t + 1), dkdv_tile=(t, BQ),
                       dq_tile=(BQ, t))
    if strides is None:
        strides = [(S * H * hd, H * hd, hd)] * 8
    aligned = (all(a % 16 == 0 for a in addrs)
               and all(int(x) * 2 % 16 == 0 for st in strides for x in st))
    if aligned:
        st, tb, keys = STAGES[hd], TILE * hd * 2, DKDV_KEYS[hd]
        rows = WARPGROUPS * TILE
        ring = 2 * st * tb + (1 + 2 * st) * 8 + 1024   # + barriers, alignment
        return BwdPlan(
            "wgmma_tma", TILE, TILE, (B * H, -(-S // keys)),
            (B * H, -(-S // rows)),
            ring + 2 * keys // TILE * tb + st * 2 * TILE * 4,
            ring + 2 * WARPGROUPS * tb, threads=128 * (WARPGROUPS + 1),
            stages=st, warpgroups=WARPGROUPS, dkdv_tile=(keys, TILE),
            dq_tile=(rows, TILE), heavy_first=causal)
    ld = 2 * (hd + 8)
    return BwdPlan("hmma_guarded", t, t, (B * H, -(-S // 64)),
                   (B * H, -(-S // 64)), ld * (2 * 64 + 2 * t) + 4 * 2 * t,
                   ld * (2 * 64 + 2 * t), dkdv_tile=(64, t), dq_tile=(64, t))


@dataclass(frozen=True)
class TensorMap:
    """The parameters of one TMA map (``cuTensorMapEncodeTiled``) over a
    (B, S, H, hd) bf16 operand: ``dims`` (hd, H, S, B), innermost first;
    ``strides`` in bytes of a head, a row and a batch; ``box`` the extent
    of one load, 64 columns (one 128-byte swizzle atom) by one head by
    :data:`TILE` rows by one batch."""
    dims: tuple
    strides: tuple
    box: tuple

    def args(self) -> list:
        return [*self.dims, *self.strides, *self.box]


def tensor_map(shape: Sequence[int], stride: Sequence[int],
               elt: int = 2) -> TensorMap:
    """The map of an operand of ``shape`` (B, S, H, hd) with element
    ``stride`` (the caller's, hd contiguous). A dimension of extent 1 is
    never stepped, so it takes the stride of a packed layout (the caller's
    may be anything there)."""
    B, S, H, hd = shape
    sb, ss, sh = (int(x) * elt for x in stride[:3])
    if H == 1:
        sh = hd * elt
    if S == 1:
        ss = H * hd * elt
    if B == 1:
        sb = S * H * hd * elt
    return TensorMap((hd, H, S, B), (sh, ss, sb),
                     (SWIZZLE // elt, 1, TILE, 1))


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention_bwd").flash_attention_bwd_launch
        f.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 10
                      + [ctypes.c_int] * 4
                      + [ctypes.POINTER(ctypes.c_longlong)] * 2
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True):
    """The gradients (dq, dk, dv) of ``out = flash_attention(q, k, v,
    causal)`` for the output gradient ``dout``, from the forward's ``lse``
    (B, H, S) f32; each in q's dtype and shape."""
    global launches
    ts = (q, k, v, out, dout)
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"flash_attention_bwd takes q, k, v, out, dout of "
                         f"one shape (B, S, H, hd), got "
                         f"{[tuple(t.shape) for t in ts]}")
    B, S, H, hd = q.shape
    if lse.shape != (B, H, S):
        raise ValueError(f"lse has shape {tuple(lse.shape)}, want "
                         f"{(B, H, S)}")
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"dtype mismatch: {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts + (lse,)):
        raise ValueError("the inputs lie on different devices")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, got "
                         f"{q.device}")
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    outs = ts + tuple(grads)
    p = plan(B, S, H, hd, q.dtype, [t.stride()[:3] for t in outs],
             [t.data_ptr() for t in outs], causal)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous f32 tensor")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention_bwd needs the hd axis contiguous")
    if max(p.dkdv_grid[1], p.dq_grid[1]) > 65535:
        raise ValueError(f"S = {S} exceeds the grid's y limit")
    if B and S and H:
        # wgmma_tma: lse·log2 e and D, each row padded to a whole tile
        n = B * H * (2 * -(-S // TILE) * TILE if p.variant == "wgmma_tma"
                     else S)
        D = torch.empty(n, dtype=torch.float32, device=q.device)
        st = [s for t in outs for s in t.stride()[:3]]
        arr = (ctypes.c_longlong * 24)(*st)
        maps = (ctypes.c_longlong * 44)(*(
            [x for t in (q, k, v, dout)
             for x in tensor_map(t.shape, t.stride()).args()]
            if p.variant == "wgmma_tma" else [0] * 44))
        err = _build.launch(
            _kernel(), q.get_device(), SUPPORTED[q.dtype],
            VARIANTS[p.variant], p.bq, p.bk, *(t.data_ptr() for t in ts),
            lse.data_ptr(), D.data_ptr(), *(g.data_ptr() for g in grads),
            B, S, H, hd, arr, maps, hd ** -0.5, int(causal))
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                               f"error {err} (B={B}, S={S}, H={H}, "
                               f"hd={hd}, {q.dtype}, {p})")
        launches += 1
        plans[p.variant] += 1
    return tuple(grads)
