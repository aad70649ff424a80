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
:func:`on_rows` and :func:`stepwise` are the recurrent mixers' layouts
(mamba, mLSTM, sLSTM): a scan needs every position of a row, so each rank
runs it on its batch rows with the sequence (and, in a decode step, every
state) gathered whole, and a decode step writes back its own shard of
each state, in place.

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
           "plain_kernels", "plain_route", "whole", "rowwise", "batch_rows",
           "laid_out_as", "to_rows", "on_rows", "stepwise", "shard_range"]

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
    return _row_map(fn, (x,), kops.row_placements(x), (w,))


def batch_rows(x: DTensor) -> tuple:
    """``x``'s placements with the shards of its batch (dim 0) kept and
    every other dim whole: each rank holds whole rows of its batch."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def laid_out_as(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` itself; a DTensor redistributed to ``x``'s placements."""
    if isinstance(y, DTensor):
        return y.redistribute(x.device_mesh, x.placements)
    return y


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; a DTensor laid out as :func:`batch_rows`."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, batch_rows(x))
    return x


def on_rows(fn, *xs: torch.Tensor, ws=()) -> torch.Tensor:
    """``fn(*xs, *ws)`` on whole sequences. For DTensors: on each rank's
    batch rows of every ``x`` (:func:`batch_rows` of the first, the
    sequence gathered) with every ``w`` whole, the result laid out as
    those rows and each ``w``'s gradient a sum over the ranks whose rows
    differ."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs, *ws)
    return _row_map(fn, xs, batch_rows(xs[0]), tuple(whole(w) for w in ws))


def _row_map(fn, xs: tuple, pl: tuple, ws: tuple) -> DTensor:
    from torch.distributed.tensor.experimental import local_map
    mesh = xs[0].device_mesh
    xs = tuple(x.redistribute(mesh, pl) for x in xs)
    whole_pl = (Replicate(),) * mesh.ndim
    grad_w = tuple(Partial() if isinstance(p, Shard) else Replicate()
                   for p in pl)
    n, m = len(xs), len(ws)
    return local_map(fn, out_placements=list(pl),
                     in_placements=(pl,) * n + (whole_pl,) * m,
                     in_grad_placements=(pl,) * n + (grad_w,) * m,
                     device_mesh=mesh)(*xs, *ws)


def shard_range(t: DTensor, dim: int):
    """(first index, length) of this rank's shard of ``t``'s dim ``dim``
    (which every mesh dim sharding it divides), sharded left to right
    over the mesh dims that name it."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    first, n = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(i)
            first += coord[i] * n
    return first, n


def stepwise(fn, state: dict, *xs: torch.Tensor, ws=()):
    """One decode step ``fn(state, *xs, *ws) -> (y, new state)`` of a
    recurrent mixer. Plain tensors: ``fn`` itself. A DTensor ``state``
    (``cache_pspec``: batch over data, its longest other dim over model)
    is read and written back in place, shard by shard: each rank runs
    ``fn`` on its batch rows of every entry, gathered whole, and of every
    ``x``, with every ``w`` whole, then writes its own shard of each new
    entry into ``state``. Returns ``y`` (a DTensor of those rows) and
    ``state`` itself."""
    first = next(iter(state.values()))
    if not isinstance(first, DTensor):
        return fn(state, *xs, *ws)
    mesh = first.device_mesh
    rows = batch_rows(first)
    local = {k: v.redistribute(mesh, rows).to_local()
             for k, v in state.items()}
    y, new = fn(local, *(x.redistribute(mesh, rows).to_local()
                         for x in xs), *(whole(w).to_local() for w in ws))
    for k, v in state.items():
        block = [slice(None)] * v.ndim
        for d in range(1, v.ndim):
            a, n = shard_range(v, d)
            block[d] = slice(a, a + n)
        v.to_local().copy_(new[k][tuple(block)])
    return DTensor.from_local(y, mesh, rows, run_check=False), state


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
