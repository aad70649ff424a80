"""Training launcher — the port of ``repro/launch/train.py``: the model
from its config and seed, AdamW, the synthetic token pipeline and the
fault-tolerant loop with checkpoints.

    python -m repro_torch.launch.train --arch granite-3-2b --shape train_4k \
        [--mesh AxB[xC]] [--steps 100] [--ckpt DIR] [--batch 2] \
        [--scale full|reduced] [--device cuda|cpu]

Without ``--mesh`` it trains on one device. ``--mesh AxB[xC]`` spawns
``A·B·C`` ranks (``comm.p2p.spawn``) that run the sharded step of
``launch/steps.py`` over that mesh: gloo ranks with ``--device cpu``,
NCCL ranks, one a card, with ``--device cuda`` (``--mesh 1x1`` on the
card is one NCCL rank). This departs from the JAX launcher, which
without ``--mesh`` builds the 256-chip production mesh. A run resumes
from the latest committed step under ``--ckpt``; without ``--ckpt`` it
writes into a fresh temporary directory, which it prints. On the CPU
pass ``--device cpu --scale reduced``; on the card ``--scale reduced``
keeps heads of 64, the narrowest the flash kernels take."""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from ..config import SHAPES, ShapeConfig
from ..core.device import resolve_device
from ..data.pipeline import SyntheticTokens
from ..models import get_model
from ..optim import adamw_init
from ..runtime.train_loop import TrainLoopConfig, run_train_loop
from .mesh import mesh_from_arg, parse_mesh
from .steps import build_train_step, shard_params, state_dtype_of
from .steps import launch_config as train_config

__all__ = ["main", "train_config"]


def _train(args, shape, mesh=None, log=print):
    dev = resolve_device(args.device)
    cfg = train_config(args.arch, args.scale, dev)
    step_fn = build_train_step(cfg, shape, dev, mesh=mesh)
    api = get_model(cfg)
    params = api.train_params(api.init(0, device=dev))
    if mesh is not None:
        shard_params(params, cfg, mesh)
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
                        ckpt_dir=args.ckpt), log=log)
    return (f"[train] done: final step {out['final_step']}, "
            f"last loss {out['losses'][-1]:.4f}, "
            f"stragglers={out['stragglers']}, restarts={out['restarts']}")


def _rank_main(rank, args, shape):
    """One rank of a ``--mesh`` run; rank 0 logs."""
    dev = resolve_device(args.device)
    if dev.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // math.prod(parse_mesh(args.mesh))))
    mesh = mesh_from_arg(args.mesh, dev.type)
    return _train(args, shape, mesh,
                  log=print if rank == 0 else (lambda *a, **k: None))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default=None,
                    help="AxB[xC] (pod x data x model): that many ranks")
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
    dev = resolve_device(args.device)
    if args.ckpt is None:
        args.ckpt = tempfile.mkdtemp(prefix="repro_ckpt_")
        print(f"[train] checkpoints under {args.ckpt}")
    if args.mesh is None:
        print(_train(args, shape))
        return
    from ..comm.p2p import spawn
    world = math.prod(parse_mesh(args.mesh))
    backend = "gloo" if dev.type == "cpu" else "nccl"
    print(f"[train] mesh {args.mesh}: {world} {backend} ranks")
    print(spawn(_rank_main, world, args, shape, backend=backend)[0])


if __name__ == "__main__":
    main()
