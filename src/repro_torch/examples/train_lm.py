"""End-to-end training example: a small dense LM for a few hundred steps
with the whole substrate (data pipeline, AdamW, checkpoints, the
fault-tolerant loop) — the twin of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \
        [--device cpu]

Any arch works through ``--arch`` (cut to a few layers of ``--width``).
The loss must fall: the mean of the last ten steps below the first ten.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..config import get_config
from ..core.device import resolve_device
from ..data.pipeline import SyntheticTokens
from ..models import get_model
from ..optim import adamw_init, adamw_update, cosine_warmup
from ..runtime.train_loop import TrainLoopConfig, run_train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh "
                    "temporary one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    base = get_config(args.arch)
    cfg = dataclasses.replace(
        base, n_layers=args.layers, d_model=args.width,
        n_heads=8, n_kv_heads=min(base.n_kv_heads, 4) or 4, head_dim=64,
        d_ff=4 * args.width if base.d_ff else 0, vocab=8192,
        n_experts=min(base.n_experts, 4), top_k=min(base.top_k, 2),
        enc_layers=2 if base.enc_layers else 0,
        layer_group=1 if not (base.attn_every or base.xlstm_pattern)
        else base.layer_group, param_dtype="float32",
        attn_every=min(base.attn_every, 2) if base.attn_every else 0)
    if cfg.attn_every:
        cfg = dataclasses.replace(cfg, n_layers=max(args.layers, 2),
                                  layer_group=2, attn_every=2)
    dev = resolve_device(args.device)
    api = get_model(cfg)
    params = api.train_params(api.init(0, device=dev))
    nparams = sum(w.numel() for w in params.parameters())
    print(f"arch={cfg.name} params={nparams/1e6:.1f}M")
    opt = adamw_init(params)

    def step_fn(params, opt_state, batch, step):
        for w in params.parameters():
            w.grad = None
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if cfg.frontend == "vision":
            b["frontend"] = torch.ones(args.batch, cfg.n_frontend_tokens,
                                       cfg.d_model, device=dev)
        elif cfg.enc_layers:
            b["frontend"] = torch.ones(args.batch, args.seq, cfg.d_model,
                                       device=dev)
        loss = api.loss(params, b)
        loss.backward()
        lr = cosine_warmup(step, 3e-4, warmup=20, total=args.steps,
                           device=dev)
        params, opt_state, mx = adamw_update(
            params, {k: w.grad for k, w in params.named_parameters()},
            opt_state, lr)
        return params, opt_state, loss.detach(), mx

    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch)
    out = run_train_loop(
        step_fn, params, opt, pipe,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                        ckpt_dir=args.ckpt, log_every=20))
    first = sum(out["losses"][:10]) / 10
    last = sum(out["losses"][-10:]) / 10
    print(f"loss {first:.3f} -> {last:.3f} "
          f"(stragglers={out['stragglers']}, restarts={out['restarts']})")
    assert last < first, "training did not reduce the loss"


if __name__ == "__main__":
    main()
