"""Mamba (S6) block for the Jamba hybrid — the port of
``repro/models/mamba.py``: the selective SSM over the sequence in
chunks, and the O(1)-state single-token decode, in plain torch ops.

The scan keeps the JAX chunk rule (``L = min(128, S)``, lowered until it
divides S) and the (B, di, ds) f32 state carried between chunks. torch
has no ``associative_scan``, so within a chunk the state is the
segment-sum form of the same recurrence: with ``a = −exp(A_log)`` and
``c_t = Σ_{i≤t} dt_i·a`` (per channel and state, ≤ 0 and falling),

    h_t = Σ_{j≤t} exp(c_t − c_j) · dt_j·u_j·B_j  +  exp(c_t) · h0,

the masked lower-triangular weights ``exp(c_t − c_j)`` (every exponent
≤ 0, so nothing overflows; nothing is divided by a cumulative product)
applied in one einsum. The decay depends on the state index as well as
the channel (A is (di, ds)), so the weights of a chunk are (B, L, L, di,
ds); where that passes :data:`SEGMENT_BYTES` the chunk is taken in
sub-blocks of the largest divisor of L that fits, the state carried
between them as between chunks. At jamba's width (di = 16384, ds = 16)
a sub-block is 16 positions (268 MB of weights).

The A_log parameter is f32 and ``dt_bias`` is used in f32
(``mamba.py:31``, ``:96``): both stay f32 in the serving model."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, _param, linear

__all__ = ["Mamba", "mamba", "mamba_decode", "mamba_state_spec",
           "SEGMENT_BYTES"]

_MAMBA_CHUNK = 128
#: the most bytes one (B, l, l, di, ds) f32 weight tensor of the
#: segment-sum may take
SEGMENT_BYTES = 1 << 28


class Mamba(nn.Module):
    """``in_proj`` (d, 2·di), ``conv_w`` (d_conv, di), ``x_proj`` (di,
    2·ds + 1: B, C and one dt a position), ``dt_bias`` (di,) and
    ``A_log`` (di, ds) in f32, ``D`` (di,), ``out_proj`` (di, d)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        di = cfg.mamba_expand * d
        ds = cfg.mamba_d_state
        self.in_proj = Linear(d, 2 * di, dtype, device)
        self.conv_w = _param((cfg.mamba_d_conv, di), dtype, device)
        self.x_proj = Linear(di, ds * 2 + 1, dtype, device)
        self.dt_bias = _param((di,), torch.float32, device)
        self.A_log = _param((di, ds), torch.float32, device)
        self.D = _param((di,), dtype, device)
        self.out_proj = Linear(di, d, dtype, device)


def _sub_block(B: int, L: int, di: int, ds: int) -> int:
    """The largest divisor of L whose (B, l, l, di, ds) f32 weights fit
    :data:`SEGMENT_BYTES` (at least 1)."""
    for l in range(L, 0, -1):
        if L % l == 0 and 4 * B * l * l * di * ds <= SEGMENT_BYTES:
            return l
    return 1


def _ssm_scan(u, dt, A_log, Bc, Cc, chunk: int = _MAMBA_CHUNK):
    """u: (B,S,di); dt: (B,S,di); A_log: (di,ds); Bc/Cc: (B,S,ds), all
    f32. h_t = exp(dt·A) h_{t-1} + dt·B_t u_t; y_t = C_t·h_t, A = −exp(A_log)
    (``mamba.py:41-74``). Returns y (B,S,di)."""
    B, S, di = u.shape
    ds = Bc.shape[-1]
    L = min(chunk, S)
    while S % L:
        L -= 1
    l = _sub_block(B, L, di, ds)
    a = -torch.exp(A_log)                                      # (di,ds)
    tri = torch.tril(torch.ones(l, l, dtype=torch.bool, device=u.device))
    h = torch.zeros(B, di, ds, dtype=u.dtype, device=u.device)
    ys = []
    for c0 in range(0, S, L):           # the chunks, then their sub-blocks
        for s0 in range(c0, c0 + L, l):
            uc, dtc = u[:, s0:s0 + l], dt[:, s0:s0 + l]
            bc, cc = Bc[:, s0:s0 + l], Cc[:, s0:s0 + l]
            cum = torch.cumsum(dtc[..., None] * a, dim=1)    # (B,l,di,ds)
            w = cum[:, :, None] - cum[:, None, :]            # (B,t,j,di,ds)
            w.masked_fill_(~tri[None, :, :, None, None], float("-inf"))
            w.exp_()
            x = (dtc * uc)[..., None] * bc[:, :, None, :]    # (B,l,di,ds)
            hs = torch.einsum("btjdn,bjdn->btdn", w, x) \
                + torch.exp(cum) * h[:, None]
            del w
            ys.append(torch.einsum("btdn,btn->btd", hs, cc))
            h = hs[:, -1]
    return torch.cat(ys, dim=1)


def mamba(p: Mamba, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x: (B,S,D) (``mamba.py:77-101``)."""
    B, S, D = x.shape
    dc = cfg.mamba_d_conv
    ds = cfg.mamba_d_state
    u, z = torch.chunk(linear(p.in_proj, x), 2, dim=-1)       # (B,S,di)

    # depthwise causal conv1d, summed tap by tap in x's dtype as JAX does
    pad = F.pad(u, (0, 0, dc - 1, 0))
    conv = pad[:, 0:S] * p.conv_w[0].to(x.dtype)
    for i in range(1, dc):
        conv = conv + pad[:, i:i + S] * p.conv_w[i].to(x.dtype)
    u = F.silu(conv)

    bcd = linear(p.x_proj, u)
    Bc, Cc, dt = bcd[..., :ds], bcd[..., ds:2 * ds], bcd[..., 2 * ds:]
    # one selective dt a position, a learned bias per channel, in f32
    dt = F.softplus(dt.to(torch.float32)
                    + p.dt_bias.to(torch.float32)[None, None, :])
    y = _ssm_scan(u.to(torch.float32), dt, p.A_log.to(torch.float32),
                  Bc.to(torch.float32), Cc.to(torch.float32))
    y = y.to(x.dtype) + u * p.D.to(x.dtype)
    y = y * F.silu(z)
    return linear(p.out_proj, y)


def mamba_state_spec(cfg, batch: int) -> Dict[str, tuple]:
    """State carried across decode steps: the SSM state and the conv
    window."""
    di = cfg.mamba_expand * cfg.d_model
    return {"ssm": (batch, di, cfg.mamba_d_state),
            "conv": (batch, cfg.mamba_d_conv - 1, di)}


def mamba_decode(p: Mamba, cfg, x: torch.Tensor, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step. x: (B,1,D) (``mamba.py:113-138``). Returns
    (out, new state); ``state`` is not written."""
    ds = cfg.mamba_d_state
    u, z = torch.chunk(linear(p.in_proj, x)[:, 0], 2, dim=-1)   # (B,di)

    win = torch.cat([state["conv"], u[:, None]], dim=1)         # (B,dc,di)
    conv = torch.einsum("bcd,cd->bd", win, p.conv_w.to(x.dtype))
    u = F.silu(conv)

    bcd = u @ p.x_proj.w.to(x.dtype)
    Bc, Cc, dt = bcd[..., :ds], bcd[..., ds:2 * ds], bcd[..., 2 * ds:]
    dt = F.softplus(dt.to(torch.float32)
                    + p.dt_bias.to(torch.float32)[None, :])
    dA = torch.exp(dt[..., None] * (-torch.exp(p.A_log))[None])  # (B,di,ds)
    h = state["ssm"] * dA + (dt * u.to(torch.float32))[..., None] \
        * Bc.to(torch.float32)[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cc.to(torch.float32))
    y = y.to(x.dtype) + u * p.D.to(x.dtype)
    y = y * F.silu(z)
    out = (y @ p.out_proj.w.to(x.dtype))[:, None]
    return out, {"ssm": h, "conv": win[:, 1:]}
