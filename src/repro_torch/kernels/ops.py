"""Public kernel entry points — the names of ``repro/kernels/ops.py``, on
top of the hand-written Hopper kernels (``block_gemm``, ``trsm``,
``rmsnorm``, ``flash_attention``, and the backward kernels
``rmsnorm_bwd`` and ``flash_attention_bwd``).

Every op takes leading batch dims. A CPU tensor runs the kernel's plain
PyTorch version, a CUDA tensor the kernel; the JAX package's
interpret-mode switch has no counterpart, because the tensor's device
decides.

:func:`rmsnorm` and :func:`flash_attention` are differentiable. When an
input needs a gradient they run as ``torch.autograd.Function`` objects: the
forward kernel (flash with its log-sum-exp output on), and the backward
kernel in the backward pass — on a CPU tensor the plain versions of
both. When none does (serving, ``torch.no_grad``) they call the forward
kernel exactly as before, and the log-sum-exp is not written.

A DTensor input (the sharded steps of ``launch/steps.py``) reaches the
same kernels on its local shard, through ``local_map`` with placements
declared per input and output, and the backward kernels see the same
shards. RMSNorm is row-local: rows stay sharded as they come (batch over
data, sequence over model); a sharded last dim or a pending sum is
redistributed first, explicitly, and the scale is whole on every rank.
Flash attention is local per (batch, head) shard: batch over the mesh
dims that already shard it, heads over ``model`` when H divides, else
replicated there (the rule of ``runtime/sharding.py``'s ``attn_*``
specs); the sequence is whole on every rank."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .block_gemm import block_gemm as _block_gemm
from .block_gemm import blocked_gemm
from .flash_attention import flash_attention as _flash_attention
from .flash_attention_bwd import flash_attention_bwd as _flash_attention_bwd
from .rmsnorm import rmsnorm as _rmsnorm
from .rmsnorm_bwd import rmsnorm_bwd as _rmsnorm_bwd
from .trsm import trsm as _trsm

__all__ = ["block_gemm", "block_gemm_acc", "flash_attention", "rmsnorm",
           "trsm", "pselinv_level_gemm", "pselinv_round_gemm",
           "row_placements"]


def block_gemm(a, b):
    return _block_gemm(a, b)


def block_gemm_acc(acc, a, b, alpha=-1.0):
    """acc + alpha·(a@b) — the Schur-update form used by supernodal LU."""
    return acc + _block_gemm(a, b, alpha=alpha)


def pselinv_level_gemm(Ainv, Uh_m, out=None):
    """The sweep's block-GEMM for one elimination-tree level over Û
    stacks masked beforehand: :func:`pselinv_round_gemm` with no mask."""
    return pselinv_round_gemm(Ainv, Uh_m, None, out=out)


def pselinv_round_gemm(Ainv, Uh, cmask, out=None):
    """Masked sweep GEMM keyed by a *round* of the overlapped stream: the
    struct mask arrives per round boundary (whatever elimination-tree
    level fires there). ``partial[…, k, i] = Σ_j cmask[…, k, j] ·
    Ainv[…, i, j] @ Uh[…, k, j]ᵀ`` — all of a level's supernodes, for
    every leading (batch, rank) index, in one kernel launch.

    Ainv: (…, nbr, nbc, b, b) local A⁻¹ grids; Uh: (…, nk, nbc, b, b) raw
    Û stacks straight out of the comm arena; cmask: None (every j), or
    the (…, nk, nbc) struct mask of the firing level, bool or 0/1 values,
    whose leading dims broadcast against Ainv's. Returns (…, nk, nbr, b,
    b) partial products, written into ``out`` when given (e.g. a view of
    the sweep's arena). The leading dims are flattened into the kernel's
    batch index as views, so a strided arena slice is read where it lies;
    so is a mask whose leading dims are the last of Ainv's (one (P, nk,
    nbc) table over a (B, P) lead, item z taking its row z % P), which
    :func:`~.block_gemm.blocked_gemm` hands to the kernel: no masked copy
    of Û is made where the kernel skips the blocks itself."""
    lead = Ainv.shape[:-4]
    nbr, nbc, b = Ainv.shape[-4], Ainv.shape[-3], Ainv.shape[-1]
    nk = Uh.shape[-4]
    if Uh.shape[:-4] != lead:
        raise ValueError(f"batch dims differ: {tuple(Ainv.shape)} vs "
                         f"{tuple(Uh.shape)}")
    a = Ainv.reshape((-1, nbr, nbc, b, b))
    u = Uh.reshape((-1, nk, nbc, b, b))
    o = None if out is None else out.view((-1, nk, nbr, b, b))
    if cmask is not None:
        ml = cmask.shape[:-2]
        if len(ml) > len(lead) or lead[len(lead) - len(ml):] != ml:
            cmask = cmask.expand(lead + cmask.shape[-2:])
        cmask = cmask.reshape((-1,) + cmask.shape[-2:])
    p = blocked_gemm(a, u, out=o, cmask=cmask)
    return p.view(lead + (nk, nbr, b, b)) if out is None else out


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward kernel: the forward saves q, k,
    v, the output and the f32 log-sum-exp, and the backward recomputes
    the probabilities tile by tile from them (no S×S tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_attention(q, k, v, causal=causal, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                          lse, ctx.causal)
        return dq, dk, dv, None


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with its backward kernel: the forward saves x and the
    scale, the backward recomputes each row's statistic from x."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = _rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, ds.to(scale.dtype), None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_local(q, k, v, causal):
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _flash_attention(q, k, v, causal=causal)


def _rmsnorm_local(x, scale, eps):
    if _needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps=eps)


def flash_attention(q, k, v, causal=True):
    """Softmax attention over (B, S, H, hd) tensors, same H for q, k, v."""
    if isinstance(q, DTensor):
        return _flash_sharded(q, k, v, causal)
    return _flash_local(q, k, v, causal)


def rmsnorm(x, scale, eps=1e-5):
    if isinstance(x, DTensor):
        return _rmsnorm_sharded(x, scale, eps)
    return _rmsnorm_local(x, scale, eps)


def row_placements(x: DTensor) -> tuple:
    """``x``'s placements with a shard of its last dim, or a pending sum,
    made replicated: the layout in which each rank holds whole rows."""
    last = x.ndim - 1
    return tuple(Replicate() if isinstance(p, Partial) or
                 (isinstance(p, Shard) and p.dim in (last, -1)) else p
                 for p in x.placements)


def _rmsnorm_sharded(x, scale, eps):
    """RMSNorm of a DTensor on its local rows: ``x`` keeps every shard of
    its leading dims; a shard of the last dim or a pending sum becomes
    replicated first. The scale's gradient is a sum over the ranks whose
    rows differ (``Partial`` there)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = row_placements(x)
    x = x.redistribute(mesh, pl)
    whole = (Replicate(),) * mesh.ndim
    if isinstance(scale, DTensor):
        scale = scale.redistribute(mesh, whole)
    else:
        scale = DTensor.from_local(scale, mesh, whole, run_check=False)
    ds = tuple(Partial() if isinstance(p, Shard) else Replicate()
               for p in pl)
    fn = local_map(_rmsnorm_local, out_placements=list(pl),
                   in_placements=(pl, whole, None),
                   in_grad_placements=(pl, ds, None), device_mesh=mesh)
    return fn(x, scale, eps)


def _flash_placements(q) -> tuple:
    """The flash kernel's placement of a (B, S, H, hd) DTensor: ``Shard(0)``
    on the mesh dims that shard its batch now, ``Shard(2)`` on ``model``
    when H divides that dim, ``Replicate()`` elsewhere."""
    mesh, H = q.device_mesh, q.shape[2]
    names = mesh.mesh_dim_names or ()
    out = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(p)
        elif i < len(names) and names[i] == "model" and \
                H % mesh.size(i) == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _flash_sharded(q, k, v, causal):
    """Flash attention of DTensors on each rank's (batch, head) shard:
    q, k and v are redistributed to :func:`_flash_placements` of ``q``
    (the whole sequence on every rank) and the kernel runs on the local
    shards, forward and backward."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = _flash_placements(q)
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    fn = local_map(_flash_local, out_placements=list(pl),
                   in_placements=(pl, pl, pl, None), device_mesh=mesh)
    return fn(q, k, v, causal)


def trsm(b, u):
    """Solve X·U = B with U upper triangular (right side)."""
    return _trsm(b, u)
