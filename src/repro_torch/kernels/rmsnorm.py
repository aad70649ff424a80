"""RMSNorm over the last axis — the wrapper of the hand-written Hopper
kernel in ``csrc/rmsnorm.cu``, which replaces the TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm_pallas`` (the note at the head of the
source says what bounds it and what its design does about that).

A CPU tensor goes to the plain PyTorch version, :func:`rmsnorm_plain`
(the kernel's arithmetic: f32 statistics and scale, one rounding). A CUDA
tensor launches the kernel or raises; nothing falls back. ``launches``
counts kernel launches, and only those; ``plans`` counts them by variant.
One call is one launch: the scale is read in its own type (f32 or bf16).

:func:`plan` — pure Python, no card needed — chooses each launch's
variant, threads per row and packs per thread; the C entry takes its
choice as it is."""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build
from .ref import rmsnorm_ref as rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_plain", "launches", "plans", "SUPPORTED",
           "RmsPlan", "plan"]

#: kernel launches since import (or since a caller last reset it)
launches = 0
#: the same launches by the variant of their plan
plans: collections.Counter = collections.Counter()

#: dtype → the kernel's type code (x and out; the scale's, too)
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}

#: packs a thread may hold (compiled instances), elements a thread may
#: hold in registers, the most threads a row (the kernel's launch bound,
#: which leaves 128 registers a thread), the two-pass variant's block
PPTS, MAX_ELEMS, MAX_THREADS, TWO_PASS_THREADS = (1, 2, 4, 8), 32, 512, 256
#: threads per block when a warp holds one or more rows
WARP_ROW_BLOCK = 256

_fn = None


@dataclass(frozen=True)
class RmsPlan:
    """One launch's kernel choice: the variant (``one_read``: each
    thread keeps ``ppt`` packs of its row in registers; ``two_pass``: the
    row is read twice, for rows past the register budget), whether a pack
    is 16 bytes (``vec``) or one element, ``g`` threads a row and
    ``threads`` a block. ``ppt`` is 0 on the two-pass variant."""
    variant: str
    vec: bool
    width: int       # elements a pack
    g: int
    ppt: int
    threads: int

    def rows_per_block(self) -> int:
        return self.threads // self.g if self.g <= 32 else 1

    def grid(self, rows: int) -> int:
        return -(-rows // self.rows_per_block())


def plan(rows: int, d: int, dtype: torch.dtype,
         aligned: bool = True) -> RmsPlan:
    """The kernel choice for ``rows`` rows of ``d`` elements; it never
    looks at ``rows``. Packs are 16 bytes when d is a multiple of 16
    bytes and every pointer is 16-byte ``aligned``, else one element.

    A warp (or a power-of-two part of one) per row when 32 threads cover
    the row with at most :data:`MAX_ELEMS` elements each — the fewest
    packs a thread that do; else a block per row, of ``g`` threads (a
    multiple of 32, at most :data:`MAX_THREADS`) holding ``ppt`` packs
    each, with the fewest idle slots (``g·ppt`` − packs), then ``g``
    nearest 256; past that, the two-pass variant."""
    if dtype not in SUPPORTED:
        raise TypeError(f"rmsnorm takes {sorted(map(str, SUPPORTED))}, got "
                        f"{dtype}")
    return _plan(d, dtype, aligned)


@functools.lru_cache(maxsize=1024)
def _plan(d: int, dtype: torch.dtype, aligned: bool) -> RmsPlan:
    per = 16 // dtype.itemsize
    vec = aligned and d % per == 0
    width = per if vec else 1
    units = -(-d // width)
    ppts = [p for p in PPTS if p * width <= MAX_ELEMS]
    for p in ppts:
        n = -(-units // p)
        if n <= 32:
            return RmsPlan("one_read", vec, width, 1 << (n - 1).bit_length(),
                           p, WARP_ROW_BLOCK)
    best = None
    for p in ppts:
        g = -(-units // (32 * p)) * 32
        if g > MAX_THREADS:
            continue
        key = (g * p - units, abs(math.log(g / 256)))
        if best is None or key < best[0]:
            best = (key, RmsPlan("one_read", vec, width, g, p, g))
    if best is not None:
        return best[1]
    return RmsPlan("two_pass", vec, width, TWO_PASS_THREADS, 0,
                   TWO_PASS_THREADS)


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("rmsnorm").rmsnorm_launch
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x², -1) + eps) * scale`` for ``x (…, d)`` and
    ``scale (d,)``; returns x's shape and dtype."""
    global launches
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm takes x (…, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"device mismatch: {x.device} vs {scale.device}")
    if x.is_cpu:
        return rmsnorm_plain(x, scale, eps)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm runs on cpu or cuda, got {x.device}")
    if x.dtype not in SUPPORTED or scale.dtype not in SUPPORTED:
        raise TypeError(f"rmsnorm takes x and scale in "
                        f"{sorted(map(str, SUPPORTED))} on the card, got "
                        f"{x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes a contiguous x and scale")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows:
        p = plan(rows, d, x.dtype, (x.data_ptr() | out.data_ptr()
                                    | scale.data_ptr()) % 16 == 0)
        err = _build.launch(_fn or _kernel(), x.get_device(),
                            SUPPORTED[x.dtype], SUPPORTED[scale.dtype],
                            int(p.vec), p.ppt, p.g, p.threads, x.data_ptr(),
                            scale.data_ptr(), out.data_ptr(), rows, d, eps)
        if err != 0:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error "
                               f"{err} (rows={rows}, d={d}, {x.dtype}, {p})")
        launches += 1
        plans[p.variant] += 1
    return out
