"""Mixture-of-Experts FFN with capacity-based dispatch — the port of
``repro/models/moe.py``: the same routing, capacity, dispatch order and
drops, step for step, in plain torch ops (the JAX function calls no
Pallas kernel either).

The router weight is f32 and is used in f32, as in the JAX package
(``moe.py:28``, ``:61-62``): it stays f32 in the serving model
(``transformer.serving_params``). The expert weights are the activation's
dtype (bf16 when served).

The combine is deterministic. The JAX package scatter-adds each slot's
gate-weighted bf16 row into its token's row (``moe.py:114-118``); on the
card ``index_add_`` in bf16 would run on atomics, whose order changes from
run to run. Here each (token, choice) gathers its slot's gate-weighted
row — the same bf16 product as JAX's — and the k rows of a token are
summed in f32 and rounded once to the activation dtype. JAX's scatter
rounds the running sum to bf16 after each of the k adds, so the two
agree exactly for k = 1 and otherwise differ by the k − 1 extra
roundings of the JAX sum (at most (k − 1)/2 bf16 ulp of the row's
magnitude per element); dropped choices add zero in both.

Two runs of one model (the kernel route against the plain route, a
decode against its prefill, the port against the JAX package) can route
a token to different experts where its k-th and (k+1)-th router
probabilities are closer than the runs' rounding noise. :class:`RouteLog`
records every routing ``moe_ffn`` makes, and :func:`route_flips` says
which rows such flips reach, after holding each flip to that near-tie
rule.

On a mesh (a DTensor ``x``, the sharded steps) the routing and the
combine run on every rank over all tokens, in plain ops on the gathered
activations and router — the same ``G`` = ``data_groups`` groups as the
JAX package's sharded MoE, whose capacity is per group — and the expert
FFN, the bulk of the work, runs sharded: the dispatched buffer is a
DTensor constrained by ``moe_dispatch`` (groups over data, experts over
model when E divides) and ``moe_ffn_act``, with each expert weight
gathered whole at its use."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from .layers import Linear, _param, whole
from .sharding_hooks import constrain, policy_info

__all__ = ["MoE", "Route", "moe_route", "moe_ffn", "RouteLog", "RouteRows",
           "routes_by_layer", "route_flips"]


class MoE(nn.Module):
    """``router.w`` (d, E) in f32; ``w_up``/``w_gate`` (E, d, f) and
    ``w_down`` (E, f, d) in ``dtype`` — the JAX names and layouts."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = Linear(d, e, torch.float32, device)
        self.w_up = _param((e, d, f), dtype, device)
        self.w_gate = _param((e, d, f), dtype, device)
        self.w_down = _param((e, f, d), dtype, device)


class Route(NamedTuple):
    """The routing of ``G`` groups of ``Tl`` tokens: ``ids``/``gate``
    (G, Tl, k) (top-k experts in descending probability, gates
    renormalised), ``probs`` (G, Tl, E) the router's f32 softmax, ``pos``
    (G, Tl·k) each (token, choice)'s slot in its expert in flattened
    (token, choice) order, ``keep`` = pos < cap, ``cap`` the per-expert
    capacity and ``aux`` the Switch loss."""
    ids: torch.Tensor
    gate: torch.Tensor
    probs: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def _groups(cfg, T: int) -> int:
    G = policy_info("data_groups", 1)
    return 1 if T % G else G


def moe_route(p: MoE, cfg, x: torch.Tensor) -> Route:
    """The routing of ``moe_ffn`` for x (B, S, D) (``moe.py:54-78``):
    ``G`` data groups (1 without a sharding policy), capacity
    ``int(Tl·k/E · capacity_factor) + 1`` (not the ceil the JAX
    docstring names), an f32 router, softmax, top-k in descending order
    with renormalised gates, the Switch aux loss over all tokens, and
    slot positions by a cumsum over the flattened (token, choice) order,
    so earlier tokens win a full expert. ``(~route.keep).sum()`` counts
    the dropped (token, choice) slots."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _groups(cfg, T)
    Tl = T // G
    cap = int((Tl * k) / E * cfg.capacity_factor) + 1

    xt = x.reshape(G, Tl, D)
    w = p.router.w
    if isinstance(w, DTensor):
        w = whole(w).to_local()
    logits = torch.einsum("gtd,de->gte", xt.to(torch.float32),
                          w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1, sorted=True)     # (G,Tl,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean((0, 1))                                      # (E,)
    flat = ids.reshape(-1)            # counts of a known shape (no bincount)
    ce = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat)).to(torch.float32) / (T * k)
    aux = E * torch.sum(me * ce)

    flat_ids = ids.reshape(G, Tl * k)
    onehot = F.one_hot(flat_ids, E)                              # (G,Tk,E)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos, 2, flat_ids[..., None])[..., 0]
    return Route(ids, gate, probs, pos, pos < cap, cap, aux)


def moe_ffn(p: MoE, cfg, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux): top-k routing with per-expert capacity;
    overflowing (token, choice) slots are dropped (``moe.py:39-118``).
    Each expert runs SwiGLU over its whole (cap, D) buffer, unused slots
    being the zero row, as in JAX; the combine is the deterministic
    gather of the module note."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    like = x if isinstance(x, DTensor) else None
    if like is not None:                # every rank routes every token
        x = x.full_tensor()
    r = moe_route(p, cfg, x)
    for log in _LOGS:
        log.calls.append(r)
    G, Tl = r.ids.shape[:2]
    cap, Tk = r.cap, Tl * k
    dev = x.device
    xt = x.reshape(G, Tl, D)

    # index map (G, E, cap): slot -> (token, choice); the sentinel Tk
    # marks an empty slot and maps to the zero row Tl. Overflowing
    # choices land in the extra column ``cap``, which is cut off.
    dpos = torch.where(r.keep, r.pos, cap)
    flat_ids = r.ids.reshape(G, Tk)
    imap = torch.full((G, E * (cap + 1)), Tk, dtype=torch.long, device=dev)
    imap.scatter_(1, flat_ids * (cap + 1) + dpos,
                  torch.arange(Tk, device=dev).expand(G, Tk).contiguous())
    imap = imap.view(G, E, cap + 1)[:, :, :cap]
    slot2tok = imap // k                                 # (G,E,cap) ∈ [0,Tl]
    xt_pad = torch.cat([xt, xt.new_zeros(G, 1, D)], dim=1)
    gi = torch.arange(G, device=dev)[:, None, None]
    eb = xt_pad[gi, slot2tok]                                # (G,E,cap,D)
    if like is not None:
        eb = _replicated(eb, like)
    eb = constrain(eb, "moe_dispatch")

    if like is None:
        out = _experts(eb, p.w_up.to(x.dtype), p.w_gate.to(x.dtype),
                       p.w_down.to(x.dtype))
    else:
        out = _experts_sharded(eb, p, x.dtype)
    out = constrain(out, "moe_dispatch")
    if like is not None:
        out = out.full_tensor()

    # combine: each (token, choice) gathers its slot's row (a dropped one
    # the zero row E·cap), weighted by its gate in x's dtype; the k rows
    # of a token are summed in f32 and rounded once
    slot = torch.where(r.keep, flat_ids * cap + r.pos, E * cap)  # (G,Tk)
    rows = torch.cat([out.reshape(G, E * cap, D),
                      out.new_zeros(G, 1, D)], dim=1)
    picked = rows[torch.arange(G, device=dev)[:, None], slot]   # (G,Tk,D)
    picked = picked * r.gate.reshape(G, Tk, 1).to(x.dtype)
    y = picked.reshape(G, Tl, k, D).sum(2, dtype=torch.float32).to(x.dtype)
    y = y.reshape(B, S, D)
    if like is not None:
        return (_replicated(y, like).redistribute(like.device_mesh,
                                                  like.placements),
                _replicated(r.aux, like))
    return y, r.aux


def _expert_up(eb, w_up, w_gate):
    """The gated up-projection of every expert: eb (G, E, cap, D) →
    (G, E, cap, F)."""
    up = torch.einsum("gecd,edf->gecf", eb, w_up)
    g = torch.einsum("gecd,edf->gecf", eb, w_gate)
    return F.silu(g) * up


def _expert_down(h, w_down):
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _experts(eb, w_up, w_gate, w_down):
    """SwiGLU of every expert over its buffer: eb (G, E, cap, D)."""
    h = constrain(_expert_up(eb, w_up, w_gate), "moe_ffn_act")
    return _expert_down(h, w_down)


def _experts_sharded(eb: DTensor, p: MoE, dtype) -> DTensor:
    """:func:`_experts` on each rank's shard of the dispatched buffer
    (``moe_dispatch``: groups over data, experts over model when E
    divides), with each rank's experts' weights. Where the experts do not
    divide and the FFN width does (``moe_ffn_act``), each rank takes a
    slice of every expert's up-projections; the activations are then
    gathered whole and the down-projection runs on every rank of the
    model axis (its output would otherwise be a pending sum, whose
    gradient ``local_map`` cannot hand back). Gradients of a weight or
    of the buffer are sums over the ranks whose rows or FFN slices
    differ."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..runtime.sharding import act_spec
    mesh = eb.device_mesh
    names = mesh.mesh_dim_names
    G, E, cap, _ = eb.shape
    act = act_spec("moe_ffn_act", (G, E, cap, p.w_up.shape[-1]), mesh)
    f_axis = act[3] if act is not None else None
    eb_pl = tuple(eb.placements)
    up_pl, dn_pl, h_pl, g_eb, g_w, g_dn = [], [], [], [], [], []
    for i, pl in enumerate(eb_pl):
        rows = isinstance(pl, Shard) and pl.dim == 0          # groups
        if isinstance(pl, Shard) and pl.dim == 1:             # experts
            up_pl.append(Shard(0)); dn_pl.append(Shard(0))
            h_pl.append(pl); g_eb.append(pl); g_w.append(Shard(0))
            g_dn.append(Shard(0))
        elif names[i] == f_axis:                              # FFN width
            up_pl.append(Shard(2)); dn_pl.append(Replicate())
            h_pl.append(Shard(3)); g_eb.append(Partial())
            g_w.append(Shard(2)); g_dn.append(Replicate())
        else:
            up_pl.append(Replicate()); dn_pl.append(Replicate())
            h_pl.append(pl); g_eb.append(pl)
            g_w.append(Partial() if rows else Replicate())
            g_dn.append(g_w[-1])
    w_up, w_gate, w_down = (
        (w.to(dtype) if isinstance(w, DTensor)
         else _replicated(w.to(dtype), eb)).redistribute(mesh, pl)
        for w, pl in ((p.w_up, up_pl), (p.w_gate, up_pl),
                      (p.w_down, dn_pl)))
    h = local_map(_expert_up, out_placements=h_pl,
                  in_placements=(eb_pl, up_pl, up_pl),
                  in_grad_placements=(g_eb, g_w, g_w),
                  device_mesh=mesh)(eb, w_up, w_gate)
    h = constrain(h, "moe_ffn_act")
    rows_pl = tuple(Replicate() if isinstance(q, Shard) and q.dim == 3
                    else q for q in h.placements)
    h = h.redistribute(mesh, rows_pl)
    return local_map(_expert_down, out_placements=list(rows_pl),
                     in_placements=(rows_pl, dn_pl),
                     in_grad_placements=(rows_pl, g_dn),
                     device_mesh=mesh)(h, w_down)


def _replicated(t: torch.Tensor, like: DTensor) -> DTensor:
    """``t``, the same on every rank, as a replicated DTensor on
    ``like``'s mesh."""
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# routing records
# ---------------------------------------------------------------------------

_LOGS = []


class RouteLog:
    """Every routing :func:`moe_ffn` makes while entered: ``calls``, one
    :class:`Route` a call, in call order (a forward: one a MoE layer; a
    decode step: one a MoE layer a step)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        _LOGS.append(self)
        return self

    def __exit__(self, *exc):
        _LOGS.remove(self)


class RouteRows(NamedTuple):
    """One call's routing as rows: ``probs`` (T, E), ``ids`` and
    ``keep`` (T, k)."""
    probs: torch.Tensor
    ids: torch.Tensor
    keep: torch.Tensor


def routes_by_layer(calls, per: int, batch: int, upto=None):
    """Routings of ``per`` MoE layers a call round (a forward: one round;
    teacher-forced decode: one round a step, B rows each) as one
    :class:`RouteRows` a layer, its rows (slot, position) in that order
    — the layout of a forward's routing over the same tokens — cut to
    the first ``upto`` positions of each slot when given."""
    out = []
    for j in range(per):
        rows = [torch.cat([getattr(c, f).reshape(batch, -1, c.ids.shape[-1]
                                                 if f == "keep" else
                                                 getattr(c, f).shape[-1])
                           for c in calls[j::per]], 1)[:, :upto]
                for f in RouteRows._fields]
        out.append(RouteRows(*(r.reshape(-1, r.shape[-1]) for r in rows)))
    return out


def route_flips(got, ref, seq: int, what: str, known=(), log=print):
    """Where two runs' routings of the same tokens part: ``got`` and
    ``ref`` hold one routing a call, in call order (:class:`Route` or
    :class:`RouteRows`, T rows each, the same rows in both). A difference
    is another expert set, or the same set with other choices dropped.

    Returns ``{row: the first call where it differs}``. Raises unless
    every expert-set flip on a row nothing reached before is a near-tie —
    ``ref``'s k-th/(k+1)-th probability margin on that row at most twice
    the noise — and unless every dropped-set change on such a row has an
    expert-set flip in its call (capacity is shared in token order). The
    noise is the largest router-probability difference between the runs
    over every (call, row) that no difference reached and that does not
    differ itself: rows fall in sequences of ``seq`` consecutive rows, and
    a difference at row r of call c reaches row r from call c on and rows
    r + 1, ... to the end of r's sequence from call c + 1 on (``seq`` = 1:
    the row alone); ``known``: ``{row: call}`` of rows whose input differs
    from that call on for another reason (a served slot fed another
    token). Logs each flip."""
    reached, differs, flips, noise = dict(known), {}, [], 0.0
    for c, (a, b) in enumerate(zip(got, ref, strict=True)):
        E, k = b.probs.shape[-1], b.ids.shape[-1]
        pa, pb = (r.probs.reshape(-1, E).float().cpu() for r in (a, b))
        ia, ib = (r.ids.reshape(-1, k).cpu() for r in (a, b))
        ka, kb = (r.keep.reshape(-1, k).cpu().gather(1, i.argsort(-1))
                  for r, i in ((a, ia), (b, ib)))
        ia, ib = ia.sort(-1).values, ib.sort(-1).values
        chosen = (ia != ib).any(-1)
        differ = chosen | (ka != kb).any(-1)
        fresh = torch.tensor([reached.get(t, c + 1) > c
                              for t in range(len(pb))])
        calm = fresh & ~differ
        if calm.any():
            noise = max(noise, (pa - pb).abs()[calm].max().item())
        if (differ & fresh & ~chosen).any() and not chosen.any():
            raise AssertionError(f"{what}: call {c} drops other slots with "
                                 "no routing flip")
        top = pb.topk(min(k + 1, E), -1).values    # k = E: no flip
        for t in (chosen & fresh).nonzero()[:, 0].tolist():
            flips.append((c, t, ia[t].tolist(), ib[t].tolist(),
                          (top[t, k - 1] - top[t, k]).item()))
        for t in differ.nonzero()[:, 0].tolist():
            differs.setdefault(t, c)
            reached[t] = min(reached.get(t, c), c)
            for u in range(t + 1, (t // seq + 1) * seq):
                reached[u] = min(reached.get(u, c + 1), c + 1)
    for c, t, ea, eb, margin in flips:
        log(f"  {what}: MoE call {c} row {t}: experts {ea} vs {eb}, margin "
            f"{margin:.2e}, noise {noise:.2e}")
        if not margin <= 2 * noise:
            raise AssertionError(f"{what}: the routing flip at row {t} of "
                                 f"call {c} is no near-tie (margin "
                                 f"{margin:.2e}, noise {noise:.2e})")
    return differs
