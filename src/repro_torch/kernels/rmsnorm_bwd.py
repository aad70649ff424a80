"""RMSNorm backward over the last axis — the wrapper of the hand-written
Hopper kernel in ``csrc/rmsnorm_bwd.cu``, the gradient of the forward in
``csrc/rmsnorm.cu``. The TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm_pallas`` has no backward (the JAX
package differentiates its jnp RMSNorm); the note at the head of the
source says what bounds this one and what its design does about that.

A CPU tensor goes to the plain PyTorch version, :func:`rmsnorm_bwd_plain`
(``ref.rmsnorm_bwd_ref``). A CUDA tensor launches the kernel or raises;
nothing falls back. ``launches`` counts calls that launched the kernel
(two kernels a call: the rows, then the fixed-order sum of the blocks'
ds partials), and only those. :func:`plan` — pure Python — chooses the
packs, threads a row and rows a block."""
from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .ref import rmsnorm_bwd_ref as rmsnorm_bwd_plain

__all__ = ["rmsnorm_bwd", "rmsnorm_bwd_plain", "launches", "plans",
           "SUPPORTED", "RmsBwdPlan", "plan"]

launches = 0
plans: collections.Counter = collections.Counter()

SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
#: threads a block; packs a thread (compiled instances); elements a thread
#: holds of each of x and dy; blocks an SM the grid aims at; SMs
THREADS, PPTS, MAX_ELEMS, BLOCKS_PER_SM, SMS = 256, (1, 2, 4, 8), 32, 4, 132

_fn = None


@dataclass(frozen=True)
class RmsBwdPlan:
    """One call's kernel choice: 16-byte packs (``vec``) of ``width``
    elements or single elements, ``g`` threads a row (a power of two up
    to 32, several rows a warp; or the block of 256, one row), ``ppt``
    packs a thread, ``rpb`` rows a block, ``blocks`` blocks."""
    variant: str
    vec: bool
    width: int
    g: int
    ppt: int
    rpb: int
    blocks: int


def plan(rows: int, d: int, dtype: torch.dtype,
         aligned: bool = True) -> RmsBwdPlan:
    """The kernel choice for ``rows`` rows of ``d`` elements. A row of at
    most 32 packs takes the fewest threads (a power of two) that hold a
    pack each; a wider one the whole block, with the fewest packs a
    thread (a power of two) that cover it. The rows are split into about
    four blocks an SM, each a multiple of the rows a block step takes."""
    if dtype not in SUPPORTED:
        raise TypeError(f"rmsnorm_bwd takes {sorted(map(str, SUPPORTED))}, "
                        f"got {dtype}")
    vec, width, g, ppt = _shape(d, dtype, aligned)
    per = THREADS // g if g <= 32 else 1
    rpb = -(-max(rows, 1) // (BLOCKS_PER_SM * SMS))
    rpb = -(-rpb // per) * per
    return RmsBwdPlan("one_read", vec, width, g, ppt, rpb,
                      -(-rows // rpb) if rows else 0)


@functools.lru_cache(maxsize=256)
def _shape(d: int, dtype: torch.dtype, aligned: bool):
    per = 16 // dtype.itemsize
    vec = aligned and d % per == 0
    width = per if vec else 1
    units = -(-d // width)
    if units <= 32:
        return vec, width, 1 << (units - 1).bit_length(), 1
    for ppt in PPTS:
        if ppt * width <= MAX_ELEMS and THREADS * ppt >= units:
            return vec, width, THREADS, ppt
    raise ValueError(f"rmsnorm_bwd takes rows of at most "
                     f"{THREADS * MAX_ELEMS} elements (16-byte aligned "
                     f"packs) or {THREADS * max(PPTS)} (single elements), "
                     f"got d = {d} in {dtype}")


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("rmsnorm_bwd").rmsnorm_bwd_launch
        f.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """The gradients (dx in x's dtype, ds in f32 — f64 on a CPU f64
    input) of ``rmsnorm(x, scale, eps)`` for the output gradient ``dy``."""
    global launches
    if x.dim() < 1 or scale.shape != x.shape[-1:] or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd takes x (…, d), scale (d,) and dy "
                         f"like x, got {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(dy.shape)}")
    if scale.device != x.device or dy.device != x.device:
        raise ValueError("the inputs lie on different devices")
    if x.is_cpu:
        return rmsnorm_bwd_plain(x, scale, dy, eps)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_bwd runs on cpu or cuda, got {x.device}")
    if (x.dtype not in SUPPORTED or scale.dtype not in SUPPORTED
            or dy.dtype != x.dtype):
        raise TypeError(f"rmsnorm_bwd takes x, dy and scale in "
                        f"{sorted(map(str, SUPPORTED))} on the card, got "
                        f"{x.dtype}, {dy.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd takes contiguous x, scale and dy")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    ds = torch.zeros(d, dtype=torch.float32, device=x.device)
    if rows:
        p = plan(rows, d, x.dtype, (x.data_ptr() | dx.data_ptr()
                                    | dy.data_ptr() | scale.data_ptr())
                 % 16 == 0)
        partial = torch.empty((p.blocks, d), dtype=torch.float32,
                              device=x.device)
        err = _build.launch(_fn or _kernel(), x.get_device(),
                            SUPPORTED[x.dtype], SUPPORTED[scale.dtype],
                            int(p.vec), p.ppt, p.g, p.rpb, p.blocks,
                            x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                            dx.data_ptr(), partial.data_ptr(), ds.data_ptr(),
                            rows, d, eps)
        if err != 0:
            raise RuntimeError(f"rmsnorm_bwd kernel launch failed: CUDA "
                               f"error {err} (rows={rows}, d={d}, {x.dtype},"
                               f" {p})")
        launches += 1
        plans[p.variant] += 1
    return dx, ds
