"""Shared model layers — the port of ``repro/models/layers.py``.

Parameters live in small ``nn.Module`` containers whose attribute names
are the JAX package's dict keys (``RMSNorm.scale``, ``Linear.w``,
``Embed.table``, ``MLP.up/gate/down``), and the functions take them the
way the JAX functions take their dicts: ``rmsnorm(p, x)``,
``linear(p, x)``, ``mlp(p, x, act)``. The compute dtype is bf16, as in
the JAX package; a weight is used in the activation's dtype, and the
serving model holds its weights in that dtype already
(``transformer.serving_params``), so the casts below are no-ops there.

:func:`rmsnorm` runs the hand-written RMSNorm kernel
(``kernels.ops.rmsnorm``: the kernel on a CUDA tensor, its plain version
on a CPU tensor). Its rounding differs from ``repro/models/layers.py:20-23``
by design: the JAX function rounds in the compute dtype, to bf16, three
times (``rsqrt(var).astype(bf16)``, ``x *`` that, then ``*
scale.astype(bf16)``); the kernel, like the TPU kernel
``_rmsnorm_kernel``, keeps the statistics, the normalization and the
scale in f32 and rounds once. With a scale of ones (every norm at init)
the last JAX rounding is exact and the two differ by at most one bf16 ulp
per element; with a general bf16 scale the bound is two ulps
(``tests/test_torch_models.py`` holds both).

:func:`whole` is the sharded steps' one rule for weights: a DTensor
parameter (sharded at rest per ``runtime/sharding.py``) is cast to the
activation's dtype and gathered whole on every rank at its use — the
all-gather of ZeRO-3 — so that a product splits its rows the way the
activation does (batch over data, sequence or heads over model), and its
gradient comes back to the parameter's shards as a reduce-scatter.

:func:`plain_kernels` is a test-only switch: inside it, RMSNorm and flash
attention run their plain PyTorch versions on any device. It is off by
default and nothing turns it on after a failure."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops as kops
from ..kernels.ref import rmsnorm_ref

__all__ = ["RMSNorm", "Linear", "MLP", "Embed", "rmsnorm", "linear",
           "rope_freqs", "apply_rope", "mlp", "embed", "cross_entropy",
           "plain_kernels", "plain_route", "whole", "rowwise"]

_PLAIN = False


@contextlib.contextmanager
def plain_kernels():
    """Run RMSNorm and flash attention through their plain PyTorch
    versions (``kernels/ref.py``) inside the block, on any device — the
    yardstick route of the card checks. Test-only; off by default."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def plain_route() -> bool:
    """Whether :func:`plain_kernels` is active."""
    return _PLAIN


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)


class Linear(nn.Module):
    """``w`` keeps the JAX layout ``(d_in, d_out)``: ``linear`` computes
    ``x @ w`` with no transpose."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)


class MLP(nn.Module):
    def __init__(self, d: int, f: int, act: str, dtype, device=None):
        super().__init__()
        self.up = Linear(d, f, dtype, device)
        self.down = Linear(f, d, dtype, device)
        if act == "silu":                       # SwiGLU
            self.gate = Linear(d, f, dtype, device)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = _param((vocab, d), dtype, device)


def whole(w: torch.Tensor) -> torch.Tensor:
    """``w`` itself; a DTensor replicated on every mesh dim."""
    if isinstance(w, DTensor):
        return w.redistribute(w.device_mesh,
                              (Replicate(),) * w.device_mesh.ndim)
    return w


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis through the hand-written kernel (see the
    module note for its one rounding against the JAX function's three)."""
    scale = p.scale.to(x.dtype)
    x = x.contiguous()
    if _PLAIN:
        return rmsnorm_ref(x, scale, eps)
    return kops.rmsnorm(x, scale, eps)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return rowwise(torch.matmul, x, whole(p.w.to(x.dtype)))


def rowwise(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(x, w)``. For a DTensor ``x``: on each rank's rows of ``x``
    (whole rows, see ``kernels.ops.row_placements``) with ``w`` whole, the result
    keeping the rows' placements and ``w``'s gradient a sum over the
    ranks whose rows differ — a ``local_map``, not DTensor's own
    propagation, which would flatten (B, S) and cannot unflatten a batch
    and a sequence sharded over two mesh dims."""
    if not isinstance(x, DTensor):
        return fn(x, w)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = kops.row_placements(x)
    x = x.redistribute(mesh, pl)
    whole_pl = (Replicate(),) * mesh.ndim
    grad_w = tuple(Partial() if isinstance(p, Shard) else Replicate()
                   for p in pl)
    return local_map(fn, out_placements=list(pl),
                     in_placements=(pl, whole_pl),
                     in_grad_placements=(pl, grad_w),
                     device_mesh=mesh)(x, w)


# -- RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split halves
    (not interleaved pairs), computed in f32 and cast back once."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., s, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLP ---------------------------------------------------------------------

def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    up = linear(p.up, x)
    if act == "silu":
        up = F.silu(linear(p.gate, x)) * up
    else:           # jax.nn.gelu is the tanh approximation by default
        up = F.gelu(up, approximate="tanh")
    return linear(p.down, up)


# -- embedding / unembedding ---------------------------------------------------

def embed(p: Embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``table.astype(dtype)[tokens]``: the rows are gathered first and
    cast after, the same values without casting the whole table."""
    return rowwise(_gather_rows, tokens, whole(p.table)).to(dtype)


def _gather_rows(tokens, table):
    return table[tokens.long()]


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lmax = logits.detach().amax(dim=-1, keepdim=True).to(torch.float32)
    shifted = logits.to(torch.float32) - lmax
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in f32, as ``repro/models/layers.py:81``
    (the max is taken without gradient). DTensor logits: each rank's
    whole rows (the vocabulary gathered), then the mean over the mesh."""
    if isinstance(logits, DTensor):
        nll = _rowwise_nll(logits, labels)
    else:
        nll = _nll(logits, labels)
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _rowwise_nll(logits: DTensor, labels: DTensor) -> DTensor:
    """:func:`_nll` on each rank's whole rows of ``logits`` (B, S, V), the
    labels laid out as the rows."""
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    pl = kops.row_placements(logits)
    logits = logits.redistribute(mesh, pl)
    labels = labels.redistribute(mesh, pl)
    return local_map(_nll, out_placements=list(pl),
                     in_placements=(pl, pl), device_mesh=mesh)(logits,
                                                                labels)


def init_normal_(w: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Fill ``w`` with N(0, std²) drawn in f32 and rounded once to w's
    dtype (the JAX init draws f32, scales, then casts)."""
    with torch.no_grad():
        t = torch.randn(w.shape, dtype=torch.float32, device=w.device,
                        generator=generator)
        w.copy_((t * std).to(w.dtype))
    return w
