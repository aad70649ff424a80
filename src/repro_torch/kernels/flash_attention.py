"""Flash attention over ``(B, S, H, hd)`` — the wrapper of the hand-written
Hopper kernel in ``csrc/flash_attention.cu``, which replaces the TPU
kernel ``repro/kernels/flash_attention.py:flash_attention_pallas`` (the
note at the head of the source says what bounds it and what its design
does about that).

A CPU tensor goes to the plain PyTorch version,
:func:`flash_attention_plain` (``ref.flash_attention_ref``: the kernel's
arithmetic in one tile). A CUDA tensor launches the kernel or raises;
nothing falls back. ``launches`` counts kernel launches, and only
those. :func:`plan` — pure Python, no card needed — chooses the
kernel's variant, tile and launch order; the C entry takes its choice
as it is."""
from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from . import _build
from .ref import flash_attention_ref as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain", "launches",
           "plans", "SUPPORTED", "HEAD_DIMS", "FlashPlan", "plan", "VARIANTS"]

#: kernel launches since import (or since a caller last reset it)
launches = 0
#: the same launches by the variant of their plan
plans: collections.Counter = collections.Counter()

#: dtype → the kernel's type code
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

#: the C entry's variant codes
VARIANTS = {"fma_f32": 0, "hmma_cpasync": 1, "hmma_guarded": 2}

_fn = None


@dataclass(frozen=True)
class FlashPlan:
    """One launch's kernel choice: the variant (``fma_f32`` on the FMA
    units; ``hmma_cpasync`` / ``hmma_guarded`` on the tensor cores, K/V
    staged by cp.async or by guarded element loads), ``bq`` q rows and
    ``bk`` keys per tile, ``warps`` per block, ``stages`` of K/V in
    shared memory, ``smem`` bytes of it, the grid, and whether q tiles
    launch heaviest first (causal)."""
    variant: str
    bq: int
    bk: int
    warps: int
    stages: int
    smem: int
    grid: tuple
    heavy_first: bool

    def launch_order(self) -> list:
        """The q tile each block takes, in the order the blocks are
        numbered (x fastest): on the tensor-core grid (B·H, q tiles) that
        is every head's last (heaviest causal) tile first."""
        if self.variant == "fma_f32":               # grid (q tiles, B·H)
            nq, nbh = self.grid
            return [x for _ in range(nbh) for x in range(nq)]
        nbh, nq = self.grid
        return [(nq - 1 - y) if self.heavy_first else y
                for y in range(nq) for _ in range(nbh)]


def plan(B: int, S: int, H: int, hd: int, dtype: torch.dtype,
         causal: bool, strides: Sequence[Sequence[int]] | None = None,
         addrs: Sequence[int] = (0, 0, 0)) -> FlashPlan:
    """The kernel choice for q, k, v of shape (B, S, H, hd), from their
    (batch, seq, head) ``strides`` (default contiguous) and base
    ``addrs``. f32 takes the FMA kernel (64-row q tiles, 4 warps, f32
    tiles in shared memory); bf16 the tensor-core kernel (64-row q tiles,
    4 warps of 16 rows, 64-key K/V tiles in a ring of 2), whose K/V and Q
    are staged by cp.async only when every base address and stride is
    16-byte aligned. The tile and variant never depend on B·H."""
    if dtype not in SUPPORTED:
        raise TypeError(f"flash_attention takes "
                        f"{sorted(map(str, SUPPORTED))} on the card, got "
                        f"{dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}, got {hd}")
    if strides is None:
        strides = [(S * H * hd, H * hd, hd)] * 3
    if dtype == torch.float32:
        bq = bk = 64
        smem = 4 * (bq * (hd + 1) + bk * (hd + 1) + bk * hd + bq * (bk + 1))
        return FlashPlan("fma_f32", bq, bk, 4, 1, smem,
                         (-(-S // bq), B * H), False)
    elt = 2
    aligned = (all(a % 16 == 0 for a in addrs)
               and all(int(x) * elt % 16 == 0 for st in strides for x in st))
    bq, bk = 64, 64
    smem = elt * (bq + 4 * bk) * (hd + 8)
    return FlashPlan("hmma_cpasync" if aligned else "hmma_guarded", bq, bk,
                     bq // 16, 2, smem, (B * H, -(-S // bq)), bool(causal))


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention").flash_attention_launch
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, lse: bool = False):
    """q/k/v: (B, S, H, hd) with the same H (repeat GQA heads outside).
    Returns (B, S, H, hd) in q's dtype; with ``lse`` also each row's f32
    log-sum-exp of its scaled scores, (B, H, S) — the backward's input —
    the output being the same bits either way."""
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape "
                         f"(B, S, H, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v lie on different devices")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    B, S, H, hd = q.shape
    strides = [t.stride()[:3] for t in (q, k, v)]
    p = plan(B, S, H, hd, q.dtype, causal, strides,
             [t.data_ptr() for t in (q, k, v)])
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the hd axis contiguous")
    if p.grid[1] > 65535:
        raise ValueError(f"grid {p.grid} exceeds the grid's y limit 65535")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
             if lse else None)
    if B and S and H:
        st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        arr = (ctypes.c_longlong * 12)(*st)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = _kernel()(SUPPORTED[q.dtype], VARIANTS[p.variant],
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), B, S, H, hd, arr, hd ** -0.5,
                            int(causal),
                            None if lse_t is None else lse_t.data_ptr(),
                            stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err} (B={B}, S={S}, H={H}, hd={hd}, "
                               f"{q.dtype}, {p.variant})")
        launches += 1
        plans[p.variant] += 1
    return (out, lse_t) if lse else out
