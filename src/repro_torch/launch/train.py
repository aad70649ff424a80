"""Training launcher — the port of ``repro/launch/train.py``: the model
from its config and seed, AdamW, the synthetic token pipeline and the
fault-tolerant loop with async checkpoints, on one card.

    python -m repro_torch.launch.train --arch granite-3-2b --shape train_4k \
        [--steps 100] [--ckpt DIR] [--batch 2] [--scale full|reduced] \
        [--device cuda|cpu]

``--mesh`` takes the JAX launcher's ``AxB[xC]`` form; more than one
device raises ``NotImplementedError`` (the mesh waits for ROADMAP Queue
1, item 6). A run resumes from the latest committed step under
``--ckpt``; without ``--ckpt`` it writes into a fresh temporary
directory, which it prints. On the CPU pass ``--device cpu --scale
reduced``; on the card ``--scale reduced`` keeps heads of 64, the
narrowest the flash kernels take."""
from __future__ import annotations

import argparse
import math
import tempfile

from ..config import SHAPES, ShapeConfig, get_config, reduced_config
from ..core.device import resolve_device
from ..data.pipeline import SyntheticTokens
from ..models import get_model
from ..optim import adamw_init
from ..runtime.train_loop import TrainLoopConfig, run_train_loop
from .steps import build_train_step, state_dtype_of


def train_config(arch: str, scale: str, device):
    """The config ``--arch``/``--scale`` name on ``device``: ``reduced`` is
    ``reduced_config`` (heads of 16) on the CPU and, on the card, the same
    cut at d_model 512 in 8 heads of 64 (the flash kernels take hd 64 and
    128 only)."""
    cfg = get_config(arch)
    if scale == "full":
        return cfg
    if device.type == "cpu":
        return reduced_config(cfg)
    return reduced_config(cfg, d_model=512, n_heads=8, head_dim=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to resume from and write "
                    "to (default: a fresh temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--scale", default="full", choices=["full", "reduced"],
                    help="reduced = CPU-sized model for smoke runs")
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = ShapeConfig(shape.name, args.seq or shape.seq_len,
                            args.batch or shape.global_batch, shape.mode)
    if args.mesh:
        dims = tuple(int(d) for d in args.mesh.split("x"))
        if math.prod(dims) > 1:
            raise NotImplementedError(
                f"--mesh {args.mesh}: training over several devices waits "
                "for the multi-card slice (ROADMAP Queue 1, item 6)")
    dev = resolve_device(args.device)
    cfg = train_config(args.arch, args.scale, dev)
    if args.ckpt is None:
        args.ckpt = tempfile.mkdtemp(prefix="repro_ckpt_")
        print(f"[train] checkpoints under {args.ckpt}")

    step_fn = build_train_step(cfg, shape, dev)
    api = get_model(cfg)
    params = api.train_params(api.init(0, device=dev))
    opt = adamw_init(params, state_dtype=state_dtype_of(cfg))
    pipe = SyntheticTokens(
        vocab=cfg.vocab, seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        frontend_tokens=(cfg.n_frontend_tokens if cfg.frontend == "vision"
                         else (shape.seq_len if cfg.enc_layers else 0)),
        d_model=cfg.d_model)
    out = run_train_loop(
        step_fn, params, opt, pipe,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt))
    print(f"[train] done: final step {out['final_step']}, "
          f"last loss {out['losses'][-1]:.4f}, "
          f"stragglers={out['stragglers']}, restarts={out['restarts']}")


if __name__ == "__main__":
    main()
