"""xLSTM blocks — the port of ``repro/models/xlstm.py``: the chunkwise
mLSTM (matrix memory) and the recurrent sLSTM (scalar memory), with
their single-token decodes, in plain torch ops.

The mLSTM is evaluated chunk by chunk (``xlstm_chunk`` positions): the
intra-chunk terms as an (L × L) masked product in log-gate space, the
(B, H, hd, hd) state carried between chunks by a Python loop in place of
``lax.scan``. As in JAX, a sequence longer than one chunk must be a
whole number of chunks (``nc = S // L``, no remainder loop): anything
else raises. The sLSTM runs its true hidden-to-gate recurrence as a
Python loop over the positions.

The input-gate stabiliser is the JAX package's: ``i_raw`` minus its max
over the whole tensor — batch, positions and heads (``xlstm.py:104``).
In a decode step that is a max over every slot of the batch, so a
request's output depends on the other slots, and prefill and decode use
different stabilisers: the JAX package's own decode does not reproduce
its forward exactly. The port mirrors both."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, _param, linear

__all__ = ["MLSTM", "SLSTM", "mlstm", "mlstm_decode", "mlstm_state_spec",
           "slstm", "slstm_decode", "slstm_init_state", "slstm_state_spec"]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
        self.wq = Linear(d, h * hd, dtype, device)
        self.wk = Linear(d, h * hd, dtype, device)
        self.wv = Linear(d, h * hd, dtype, device)
        self.wi = Linear(d, h, dtype, device)        # input gate (per head)
        self.wf = Linear(d, h, dtype, device)        # forget gate
        self.wo = Linear(h * hd, d, dtype, device)
        self.ogate = Linear(d, h * hd, dtype, device)


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int):
    """q/k/v: (B,S,H,hd) f32; log_i/log_f: (B,S,H). Returns y (B,S,H,hd)
    (``xlstm.py:47-92``)."""
    B, S, H, hd = q.shape
    L = min(chunk, S)
    nc = S // L
    if nc * L != S:
        raise ValueError(f"mLSTM: a sequence of {S} positions is not a "
                         f"whole number of {L}-position chunks")
    scale = hd ** -0.5

    def chunks(t):            # (B,S,H,…) -> (nc,B,H,L,…)
        t = t.reshape(B, nc, L, H, *t.shape[3:])
        return t.permute(1, 0, 3, 2, *range(4, t.dim()))

    qr, kr, vr = chunks(q) * scale, chunks(k), chunks(v)
    lir, lfr = chunks(log_i), chunks(log_f)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))

    C0 = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=q.device)
    n0 = torch.zeros(B, H, hd, dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        qc, kc, vc, li, lf = qr[c], kr[c], vr[c], lir[c], lfr[c]
        bf = torch.cumsum(lf, dim=-1)                 # (B,H,L) log Π f
        # intra-chunk: w_tj = exp(bf_t - bf_j + li_j), j <= t
        wlog = bf[..., :, None] - bf[..., None, :] + li[..., None, :]
        w = torch.where(tri, torch.exp(wlog), 0.0)
        s = torch.einsum("bhtd,bhjd->bhtj", qc, kc) * w
        y_intra = torch.einsum("bhtj,bhjd->bhtd", s, vc)
        n_intra = torch.einsum("bhtj,bhjd->bhtd", w, kc)
        # inter-chunk: the carry scaled by Π f up to t
        Ft = torch.exp(bf)
        y_state = torch.einsum("bhtd,bhde->bhte", qc, C0) * Ft[..., None]
        n_state = n0[:, :, None] * Ft[..., None]
        nvec = n_intra + n_state
        denom = torch.clamp(torch.einsum("bhtd,bhtd->bht", qc, nvec).abs(),
                            min=1.0)
        ys.append((y_intra + y_state) / denom[..., None])
        # chunk-end state
        FL = torch.exp(bf[..., -1])                   # (B,H)
        decay = torch.exp(bf[..., -1:] - bf + li)     # (B,H,L)
        C0 = C0 * FL[..., None, None] + torch.einsum(
            "bhld,bhle,bhl->bhde", kc, vc, decay)
        n0 = n0 * FL[..., None] + torch.einsum("bhld,bhl->bhd", kc, decay)
    y = torch.stack(ys)                               # (nc,B,H,L,hd)
    return y.permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)


def _gates(p: MLSTM, cfg, x):
    """q, k, v, log_i, log_f in f32 (``xlstm.py:95-105``): log σ(f), and
    ``i_raw`` less its max over the whole tensor."""
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    q = linear(p.wq, x).reshape(B, S, h, hd).to(f32)
    k = linear(p.wk, x).reshape(B, S, h, hd).to(f32)
    v = linear(p.wv, x).reshape(B, S, h, hd).to(f32)
    i_raw = linear(p.wi, x).to(f32)                           # (B,S,H)
    f_raw = linear(p.wf, x).to(f32)
    log_f = -F.softplus(-f_raw)                               # log σ(f)
    log_i = i_raw - i_raw.max()                               # exp gate ≤ 1
    return q, k, v, log_i, log_f


def mlstm(p: MLSTM, cfg, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v, log_i, log_f = _gates(p, cfg, x)
    y = _mlstm_chunk_scan(q, k, v, log_i, log_f, cfg.xlstm_chunk)
    y = y.to(x.dtype).reshape(B, S, cfg.n_heads * cfg.hd)
    o = torch.sigmoid(linear(p.ogate, x))
    return linear(p.wo, y * o)


def mlstm_state_spec(cfg, batch: int) -> Dict[str, tuple]:
    h, hd = cfg.n_heads, cfg.hd
    return {"C": (batch, h, hd, hd), "n": (batch, h, hd)}


def mlstm_decode(p: MLSTM, cfg, x: torch.Tensor, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,D) (``xlstm.py:122-138``). Returns (out, new state)."""
    B = x.shape[0]
    q, k, v, log_i, log_f = _gates(p, cfg, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                     # (B,H,hd)
    li, lf = log_i[:, 0], log_f[:, 0]                       # (B,H)
    f = torch.exp(lf)[..., None, None]
    i = torch.exp(li)[..., None, None]
    C = state["C"] * f + i * torch.einsum("bhd,bhe->bhde", k, v)
    n = state["n"] * f[..., 0] + i[..., 0] * k
    qs = q * cfg.hd ** -0.5
    denom = torch.clamp(torch.einsum("bhd,bhd->bh", qs, n).abs(), min=1.0)
    y = torch.einsum("bhd,bhde->bhe", qs, C) / denom[..., None]
    y = y.to(x.dtype).reshape(B, 1, cfg.n_heads * cfg.hd)
    o = torch.sigmoid(linear(p.ogate, x))
    return linear(p.wo, y * o), {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``wx`` (d, 4·H·hd): z, i, f, o from x; ``wr`` (H, hd, 4·hd): the
    block-diagonal recurrence; ``wo`` (H·hd, d)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
        self.wx = Linear(d, 4 * h * hd, dtype, device)
        self.wr = _param((h, hd, 4 * hd), dtype, device)
        self.wo = Linear(h * hd, d, dtype, device)


def _slstm_cell(p: SLSTM, cfg, xg, state):
    """One step. xg: (B,H,4·hd) pre-activations from x
    (``xlstm.py:156-171``)."""
    h_, c, n, m = state["h"], state["c"], state["n"], state["m"]
    rec = torch.einsum("bhd,hde->bhe", h_, p.wr.to(h_.dtype))
    g = (xg + rec).to(torch.float32)
    z, i_raw, f_raw, o_raw = torch.chunk(g, 4, dim=-1)
    log_f = -F.softplus(-f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(z)
    n_new = f * n + i
    hh = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1.0)
    hh = hh.to(h_.dtype)
    return hh, {"h": hh, "c": c_new, "n": n_new, "m": m_new}


def slstm(p: SLSTM, cfg, x: torch.Tensor) -> torch.Tensor:
    """The time scan (``xlstm.py:174-186``): one cell a position."""
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    xg = linear(p.wx, x).reshape(B, S, h, 4 * hd)
    state = slstm_init_state(cfg, B, x.dtype, x.device)
    hs = []
    for t in range(S):
        hh, state = _slstm_cell(p, cfg, xg[:, t], state)
        hs.append(hh)
    y = torch.stack(hs, dim=1).reshape(B, S, h * hd)
    return linear(p.wo, y)


def slstm_init_state(cfg, batch: int, dtype, device=None) -> Dict:
    h, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    return {"h": torch.zeros(batch, h, hd, dtype=dtype, device=device),
            "c": torch.zeros(batch, h, hd, dtype=f32, device=device),
            "n": torch.zeros(batch, h, hd, dtype=f32, device=device),
            "m": torch.full((batch, h, hd), -1e30, dtype=f32,
                            device=device)}


def slstm_state_spec(cfg, batch: int) -> Dict[str, tuple]:
    h, hd = cfg.n_heads, cfg.hd
    return {"h": (batch, h, hd), "c": (batch, h, hd),
            "n": (batch, h, hd), "m": (batch, h, hd)}


def slstm_decode(p: SLSTM, cfg, x: torch.Tensor, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    B = x.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    xg = linear(p.wx, x)[:, 0].reshape(B, h, 4 * hd)
    hh, state = _slstm_cell(p, cfg, xg, state)
    return linear(p.wo, hh.reshape(B, 1, h * hd)), state
