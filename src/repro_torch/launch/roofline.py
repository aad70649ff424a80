"""Roofline analysis — the port of ``repro/launch/roofline.py``, with
the NVIDIA H100's constants.

Three terms per (arch × shape) cell:

  compute    = FLOPs / (chips · 989e12)    [bf16 dense tensor-core peak]
  memory     = HBM bytes / (chips · 3.35e12)
  collective = collective bytes / 450e9    [NVLink 4, each way a GPU]

(NVIDIA H100 SXM5 datasheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
900 GB/s NVLink = 450 GB/s each way; the card's power limit, 700 W,
assumed. A card set lower runs slower: read a measured step against
these with its ``power.limit`` beside it.)

* FLOPs and HBM bytes come from the JAX package's analytic
  per-component model (:func:`flops_model`), ported term for term: the
  functions here equal the JAX ones float for float
  (``tests/test_torch_roofline.py``). It counts attention over the full
  S × S "as implemented" by the JAX chunked path, which visits every kv
  chunk; the port's flash kernels skip the causal tiles, so for the port
  the compute term over-counts prefill/train attention by up to 2× —
  kept for parity.
* Collective bytes are per device, from the dry run
  (``launch/dryrun.py``: the result bytes of every collective the
  sharded step issues).
* MODEL_FLOPS = 6·N·D (dense train) / 6·N_active·D (MoE train) /
  2·N·D (forward-only); MODEL_FLOPS / model FLOPs exposes remat,
  causal-waste and GQA-repeat overheads.
* :func:`measured_shares` reads one measured step against a row: the
  bound's share and the model-FLOP share of the peak.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

from ..config import SHAPES, ModelConfig, ShapeConfig, get_config
from ..models.transformer import layer_kinds

PEAK_FLOPS = 989e12          # bf16 dense / H100 SXM5
HBM_BW = 3.35e12             # B/s / H100 SXM5 (HBM3)
LINK_BW = 450e9              # B/s / GPU, NVLink 4, each way

__all__ = ["param_count", "model_flops", "flops_model", "roofline_row",
           "measured_shares", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active-per-token) parameter counts, embeddings excluded
    from the *active* count's FFN scaling but included in totals."""
    D, F, H, KV, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.hd)
    embed = cfg.vocab_padded * D * (1 if cfg.tie_embeddings else 2)

    def attn():
        return D * H * hd + 2 * D * KV * hd + H * hd * D

    def mlp():
        return (3 if cfg.act == "silu" else 2) * D * F

    def moe_total():
        return cfg.n_experts * 3 * D * F + D * cfg.n_experts

    def moe_active():
        return cfg.top_k * 3 * D * F + D * cfg.n_experts

    def mamba():
        di = cfg.mamba_expand * D
        return (D * 2 * di + cfg.mamba_d_conv * di
                + di * (2 * cfg.mamba_d_state + 1) + di * D)

    def mlstm():
        return 3 * D * H * hd + 2 * D * H + 2 * D * H * hd

    def slstm():
        return 4 * D * H * hd + H * hd * 4 * hd + H * hd * D

    total = active = embed
    if cfg.enc_layers:
        per = attn() + mlp()
        dec = 2 * attn() + mlp()
        total += cfg.enc_layers * per + cfg.n_layers * dec
        active = total
        return float(total), float(active)
    for kind in layer_kinds(cfg):
        if kind == "mlstm":
            total += mlstm(); active += mlstm(); continue
        if kind == "slstm":
            total += slstm(); active += slstm(); continue
        mixer, ffn = kind.split("+")
        m = attn() if mixer == "attn" else mamba()
        total += m; active += m
        if ffn == "moe":
            total += moe_total(); active += moe_active()
        else:
            total += mlp(); active += mlp()
    return float(total), float(active)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Textbook useful FLOPs: 6·N_active·D train, 2·N_active·D fwd."""
    total, active = param_count(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch      # decode: 1 token/seq


# ---------------------------------------------------------------------------
# analytic compiled-FLOPs / HBM-bytes model (matches the implementation,
# including its documented waste: non-causal chunk visits, GQA repeat)
# ---------------------------------------------------------------------------

def flops_model(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    D, F, H, KV, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.hd)
    B = shape.global_batch
    S = shape.seq_len
    mode = shape.mode
    T = B * (S if mode in ("train", "prefill") else 1)
    Vp = cfg.vocab_padded

    fl = 0.0
    by = 0.0
    p_dtype = 2 if cfg.param_dtype == "bfloat16" else 4
    a_dtype = 2  # bf16 activations

    def add_linear(t, d_in, d_out):
        nonlocal fl, by
        fl += 2.0 * t * d_in * d_out
        by += (d_in * d_out * p_dtype            # weights
               + t * (d_in + d_out) * a_dtype)   # act in/out

    def attn_layer(t):
        nonlocal fl, by
        add_linear(t, D, H * hd)
        add_linear(t, D, 2 * KV * hd)
        add_linear(t, H * hd, D)
        if mode == "decode":
            ctx = S
            fl_att = 2.0 * B * H * hd * ctx * 2          # qk + pv
            by_att = B * ctx * 2 * KV * hd * a_dtype      # read KV cache
        else:
            # the JAX chunked implementation visits ALL kv chunks (no
            # causal skip): full S per query — counted as implemented
            # there, kept for parity (the port's flash skips causal
            # tiles: up to 2× fewer attention FLOPs)
            fl_att = 2.0 * B * H * S * S * hd * 2
            by_att = B * S * 2 * H * hd * a_dtype * 2     # repeated KV rw
        fl += fl_att
        by += by_att

    def mlp_layer(t):
        if cfg.act == "silu":
            add_linear(t, D, F); add_linear(t, D, F); add_linear(t, F, D)
        else:
            add_linear(t, D, F); add_linear(t, F, D)

    def moe_layer(t):
        add_linear(t, D, cfg.n_experts)                   # router
        te = t * cfg.top_k * cfg.capacity_factor
        add_linear(te, D, F); add_linear(te, D, F); add_linear(te, F, D)

    def mamba_layer(t):
        di = cfg.mamba_expand * D
        ds = cfg.mamba_d_state
        add_linear(t, D, 2 * di)
        add_linear(t, di, 2 * ds + 1)
        add_linear(t, di, D)
        nonlocal fl, by
        fl += t * di * (2 * cfg.mamba_d_conv + 6 * ds)    # conv + scan
        by += t * di * ds * 4 * (2 if mode != "decode" else 0.02)

    def mlstm_layer(t):
        nonlocal fl, by
        add_linear(t, D, 3 * H * hd)
        add_linear(t, D, 2 * H)
        add_linear(t, D, H * hd)
        add_linear(t, H * hd, D)
        L = min(cfg.xlstm_chunk, S if mode != "decode" else 1)
        fl += 2.0 * t * H * L * hd * 2           # intra-chunk attention
        fl += 2.0 * t * H * hd * hd * 2 / max(L, 1)  # chunk state update
        if mode == "decode":
            fl += 2.0 * B * H * hd * hd * 2

    def slstm_layer(t):
        add_linear(t, D, 4 * H * hd)
        add_linear(t, H * hd, D)
        nonlocal fl
        fl += 2.0 * t * H * hd * 4 * hd          # recurrent matmul

    kinds = (layer_kinds(cfg) if not cfg.enc_layers else [])
    if cfg.enc_layers:
        # encoder runs at full seq even for decode (cross memory given)
        t_enc = B * S if mode != "decode" else 0
        for _ in range(cfg.enc_layers):
            if t_enc:
                attn_layer(t_enc); mlp_layer(t_enc)
        for _ in range(cfg.n_layers):
            attn_layer(T)          # self
            attn_layer(T)          # cross (approx: same cost shape)
            mlp_layer(T)
    else:
        for kind in kinds:
            if kind == "mlstm":
                mlstm_layer(T); continue
            if kind == "slstm":
                slstm_layer(T); continue
            mixer, ffn = kind.split("+")
            (attn_layer if mixer == "attn" else mamba_layer)(T)
            (moe_layer if ffn == "moe" else mlp_layer)(T)

    add_linear(T, D, Vp)                          # logits
    by += T * 4                                   # tokens/labels

    if mode == "train":
        # backward 2×, remat recompute 1× of block fwd; optimizer reads
        # m, v + writes p, m, v (f32 math on p_dtype storage)
        total, _ = param_count(cfg)
        fwd_fl, fwd_by = fl, by
        fl = fwd_fl * (3.0 + (1.0 if cfg.remat == "block" else 0.0))
        by = fwd_by * 3.0 + total * p_dtype * 5.0
    return {"flops": fl, "hbm_bytes": by}


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def roofline_row(cell: Dict, chips: int = 256) -> Dict:
    """The three terms of ``cell`` (``arch``; ``shape`` a name of
    ``SHAPES`` or a ``ShapeConfig``; optional dry-run ``collective_bytes``
    and ``memory``) on ``chips`` cards. ``chips=1`` reads one card's step:
    ``collective_bytes`` absent, the collective term is 0."""
    cfg = get_config(cell["arch"])
    shape = (cell["shape"] if isinstance(cell["shape"], ShapeConfig)
             else SHAPES[cell["shape"]])
    anal = flops_model(cfg, shape)
    coll_dev = sum(cell.get("collective_bytes", {}).values())
    t_compute = anal["flops"] / (chips * PEAK_FLOPS)
    t_memory = anal["hbm_bytes"] / (chips * HBM_BW)
    t_coll = coll_dev / LINK_BW          # collective_bytes is per device
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    bound = max(terms.values())
    row = {
        "arch": cell["arch"], "shape": shape.name, "chips": chips,
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_coll, "dominant": dom,
        "model_flops": mf,
        "useful_ratio": mf / max(anal["flops"], 1.0),
        "bound_s": bound,
        "roofline_fraction": (mf / (chips * PEAK_FLOPS)) / max(bound, 1e-30),
        "hbm_gb_per_dev": (cell.get("memory", {}).get(
            "argument_size_in_bytes", 0)
            + cell.get("memory", {}).get("temp_size_in_bytes", 0)) / 2**30,
    }
    return row


def measured_shares(row: Dict, step_s: float) -> Dict:
    """A measured step of ``step_s`` seconds against ``row``: the bound's
    share of it (``bound_share`` = bound / step) and the model-FLOP share
    of the peak (``mfu`` = model FLOPs / (chips · peak · step))."""
    return {"step_s": step_s, "bound_share": row["bound_s"] / step_s,
            "mfu": row["model_flops"] / (row["chips"] * PEAK_FLOPS
                                         * step_s)}


LEVERS = {
    "compute": "cut non-causal chunk visits / GQA repeat (kernel-level "
               "block-causal schedule) to close the useful-FLOPs gap",
    "memory": "fuse normalization+projection reads, bf16 optimizer "
              "states, larger tiles to raise arithmetic intensity",
    "collective": "reduce per-layer FSDP all-gathers (wider prefetch "
                  "bucketing), tree-scheduled cross-pod stage, "
                  "reduce-scatter gradients instead of all-reduce",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Roofline rows of a dry run's "
                                 "cells (python -m repro_torch.launch."
                                 "dryrun --all writes them)")
    ap.add_argument("--dryrun", default="build/dryrun_results.json")
    ap.add_argument("--out", default="build/roofline.json")
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        cells = json.load(f)
    rows = []
    for cell in cells:
        if cell["status"] != "ok" or cell.get("multi_pod"):
            continue
        row = roofline_row(cell)
        row["lever"] = LEVERS[row["dominant"]]
        rows.append(row)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    hdr = (f"{'arch':24s} {'shape':12s} {'compute':>9s} {'memory':>9s} "
           f"{'coll':>9s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s}")
    print(hdr)
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} "
              f"{r['compute_s']:9.4f} {r['memory_s']:9.4f} "
              f"{r['collective_s']:9.4f} {r['dominant']:>10s} "
              f"{r['useful_ratio']:7.2%} {r['roofline_fraction']:7.2%}")


if __name__ == "__main__":
    main()
