"""Serving launcher — the port of ``repro/launch/serve.py``: a model
built from its config and seed, and continuous batching over random
requests.

    python -m repro_torch.launch.serve --arch granite-3-2b \
        [--mesh AxB[xC]] [--scale full|reduced] [--requests 8] \
        [--device cuda|cpu]

Without ``--mesh`` it serves on one device. ``--mesh AxB[xC]`` spawns
``A·B·C`` ranks that serve the same requests through the sharded decode
step (``ServeEngine(mesh=)``): gloo ranks with ``--device cpu``, NCCL
ranks, one a card, with ``--device cuda``; rank 0 reports. This departs
from the JAX launcher, which without ``--mesh`` builds the production
mesh. ``--scale reduced`` (the default) is ``launch.steps.launch_config``'s
cut: heads of 16 on the CPU, of 64 on the card, where the flash kernels
take hd 64 and 128 only. ``ServeEngine`` casts the seeded init once to
the compute dtype, the values the JAX launcher's per-use casts make."""
from __future__ import annotations

import argparse
import math
import os

import numpy as np

import torch

from ..core.device import resolve_device
from ..models import get_model
from ..runtime.serve_loop import Request, ServeEngine
from .mesh import mesh_from_arg, parse_mesh
from .steps import launch_config

__all__ = ["main"]


def _serve(args, mesh=None):
    """Serve the requests; returns the report lines and whether every
    request completed."""
    dev = resolve_device(args.device)
    cfg = launch_config(args.arch, args.scale, dev)
    api = get_model(cfg)
    eng = ServeEngine(api, api.init(0, device=dev), batch_slots=args.slots,
                      max_seq=args.max_seq, mesh=mesh)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab,
                                        rng.integers(2, 8)).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    done = sum(r.done for r in reqs)
    lines = [f"[serve] completed {done}/{len(reqs)} requests, "
             f"{sum(len(r.out) for r in reqs)} tokens generated"]
    lines += [f"  req {r.rid}: {r.prompt} -> {r.out}" for r in reqs[:3]]
    return lines, len(reqs) - done


def _rank_main(rank, args):
    dev = resolve_device(args.device)
    if dev.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // math.prod(parse_mesh(args.mesh))))
    mesh = mesh_from_arg(args.mesh, dev.type)
    return _serve(args, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default=None,
                    help="AxB[xC] (pod x data x model): that many ranks")
    ap.add_argument("--scale", default="reduced",
                    choices=["full", "reduced"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if launch_config(args.arch, args.scale, dev).enc_layers:
        raise SystemExit("enc-dec serving needs encoder inputs; use the "
                         "encdec decode path in tests/examples")
    if args.mesh is None:
        lines, missing = _serve(args)
    else:
        from ..comm.p2p import spawn
        world = math.prod(parse_mesh(args.mesh))
        backend = "gloo" if dev.type == "cpu" else "nccl"
        print(f"[serve] mesh {args.mesh}: {world} {backend} ranks")
        lines, missing = spawn(_rank_main, world, args, backend=backend)[0]
    print("\n".join(lines))
    if missing:
        raise SystemExit(f"{missing} requests did not complete")


if __name__ == "__main__":
    main()
