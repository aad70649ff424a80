"""Right-side upper-triangular solve ``X·U = B`` — the wrapper of the
hand-written Hopper kernel in ``csrc/trsm.cu``, which replaces the TPU
kernel ``repro/kernels/trsm.py:trsm_pallas`` (the note at the head of the
source says what bounds it and what its design does about that).

A CPU tensor goes to the plain PyTorch version, :func:`trsm_plain`
(``torch.linalg.solve_triangular`` in the accumulate type). A CUDA tensor
launches the kernel or raises; nothing falls back. ``launches`` counts
kernel launches, and only those; ``plans`` counts them by variant.

:func:`plan` — pure Python, no card needed — chooses each launch's
variant, rows per block and shared memory; the C entry takes its choice
as it is (and refuses one whose shared memory is not its own count)."""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build
from .ref import trsm_ref as trsm_plain

__all__ = ["trsm", "trsm_plain", "launches", "plans", "SUPPORTED", "MAX_K",
           "TrsmPlan", "plan"]

#: kernel launches since import (or since a caller last reset it)
launches = 0
#: the same launches by the variant of their plan
plans: collections.Counter = collections.Counter()

#: dtype → the kernel's type code (f32 / bf16 / f64)
SUPPORTED = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

#: the widest U the kernel takes (the TPU kernel's documented limit)
MAX_K = 256

#: columns per panel (one per lane), rows per warp, warps per block allowed
PW, RPW, WARPS = 32, 4, (8, 4)
#: streaming multiprocessors of an H100 SXM
SMS = 132
#: the shared memory a block may use (227 KB)
SMEM_LIMIT = 232448

_fn = None


@dataclass(frozen=True)
class TrsmPlan:
    """One launch's kernel choice: the variant (``rcp_resident``: all of
    U's column panels staged once per block; ``rcp_streamed``: one panel at
    a time), ``warps`` of :data:`RPW` rows each (``rows`` per block),
    ``group`` panels per stage and ``smem`` bytes of dynamic shared
    memory."""
    variant: str
    warps: int
    rows: int
    group: int
    smem: int

    def grid(self, m: int, Z: int) -> tuple:
        """Blocks along (rows of B, z), as the kernel's grid."""
        return (-(-m // self.rows), Z)


def _smem(kpad: int, group: int, rows: int, acc: int) -> int:
    """``smem_bytes`` of ``csrc/trsm.cu``: reciprocals, staged panels
    (all of them, or the widest), and the x of each row."""
    np_ = kpad // PW
    us = 512 * np_ * (np_ + 1) if group >= np_ else kpad * PW
    return (kpad + us + rows * kpad) * acc


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, dtype: torch.dtype) -> TrsmPlan:
    """The kernel choice for ``m`` rows of width ``k`` per z; it never
    looks at Z. Four warps a block (one per scheduler: the column chain's
    latency sets the time) while 8-warp blocks would not fill half the
    SMs, else eight (U staged once for twice the rows). Resident when the
    whole staged triangle fits a block, else streamed. Both rules follow
    the timings of every choice on the H100 (``trsm_sweep``, ``PERF.md``)."""
    if dtype not in SUPPORTED:
        raise TypeError(f"trsm takes {sorted(map(str, SUPPORTED))}, got "
                        f"{dtype}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"trsm takes 0 < k <= {MAX_K}, got {k}")
    acc = 8 if dtype == torch.float64 else 4
    kpad = -(-k // PW) * PW
    warps = WARPS[0] if -(-m // (RPW * WARPS[0])) >= SMS // 2 else WARPS[1]
    rows = RPW * warps
    np_ = kpad // PW
    smem = _smem(kpad, np_, rows, acc)
    if smem <= SMEM_LIMIT:
        return TrsmPlan("rcp_resident", warps, rows, np_, smem)
    return TrsmPlan("rcp_streamed", warps, rows, 1, _smem(kpad, 1, rows, acc))


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("trsm").trsm_launch
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def trsm(b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Solve ``X·U = B`` for ``b (…, m, k)`` and an upper-triangular
    ``u`` of shape ``(k, k)`` (one U for every batch item) or ``(…, k,
    k)`` with b's leading dims. Returns X ``(…, m, k)`` in b's dtype; the
    strict lower triangle of u is not read."""
    global launches
    if b.dtype not in SUPPORTED:
        raise TypeError(f"trsm takes {sorted(map(str, SUPPORTED))}, "
                        f"got {b.dtype}")
    if u.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {b.dtype} vs {u.dtype}")
    if u.device != b.device:
        raise ValueError(f"device mismatch: {b.device} vs {u.device}")
    if b.dim() < 2:
        raise ValueError(f"trsm takes (…, m, k) right-hand sides, got "
                         f"{tuple(b.shape)}")
    m, k = b.shape[-2:]
    lead = b.shape[:-2]
    if u.shape[-2:] != (k, k) or u.shape[:-2] not in ((), lead):
        raise ValueError(f"trsm shapes do not chain: X·{tuple(u.shape)} = "
                         f"{tuple(b.shape)}")
    if b.is_cpu:
        return trsm_plain(b, u)
    if not b.is_cuda:
        raise ValueError(f"trsm runs on cpu or cuda, got {b.device}")
    if k > MAX_K:
        raise ValueError(f"trsm takes k <= {MAX_K}, got {k}")
    if not (b.is_contiguous() and u.is_contiguous()):
        raise ValueError("trsm takes contiguous operands")
    Z = math.prod(lead)
    if Z > 65535:
        raise ValueError(f"batch {Z} exceeds the grid's y limit 65535")
    x = torch.empty_like(b)
    if Z and m and k:
        p = plan(m, k, b.dtype)
        err = _build.launch(_fn or _kernel(), b.get_device(),
                            SUPPORTED[b.dtype], b.data_ptr(), u.data_ptr(),
                            x.data_ptr(), m, k, Z,
                            k * k if u.dim() > 2 else 0, p.warps, p.group,
                            p.smem)
        if err != 0:
            raise RuntimeError(f"trsm kernel launch failed: CUDA error {err}"
                               f" (m={m}, k={k}, Z={Z}, {b.dtype}, {p})")
        launches += 1
        plans[p.variant] += 1
    return x
