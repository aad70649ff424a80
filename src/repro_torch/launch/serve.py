"""Serving launcher — the port of ``repro/launch/serve.py``: a model
built from its config and seed, and continuous batching over random
requests, on one card.

    python -m repro_torch.launch.serve --arch granite-3-2b \
        [--scale full|reduced] [--requests 8] [--device cuda|cpu]

``--mesh`` takes the JAX launcher's ``AxB[xC]`` form; more than one
device raises ``NotImplementedError`` (``launch/mesh.py`` waits for the
multi-card slice). ``ServeEngine`` casts the seeded init once to the
compute dtype, the values the JAX launcher's per-use casts make."""
from __future__ import annotations

import argparse
import math

import numpy as np

from ..config import get_config, reduced_config
from ..core.device import resolve_device
from ..models import get_model
from ..runtime.serve_loop import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--scale", default="reduced",
                    choices=["full", "reduced"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale == "reduced":
        cfg = reduced_config(cfg)
    if cfg.enc_layers:
        raise SystemExit("enc-dec serving needs encoder inputs; use the "
                         "encdec decode path in tests/examples")
    if args.mesh:
        dims = tuple(int(d) for d in args.mesh.split("x"))
        if math.prod(dims) > 1:
            raise NotImplementedError(
                f"--mesh {args.mesh}: serving over several devices waits "
                "for the multi-card slice (ROADMAP Queue 1, item 6)")
    dev = resolve_device(args.device)

    api = get_model(cfg)
    eng = ServeEngine(api, api.init(0, device=dev),
                      batch_slots=args.slots, max_seq=args.max_seq)
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
    print(f"[serve] completed {done}/{len(reqs)} requests, "
          f"{sum(len(r.out) for r in reqs)} tokens generated")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.prompt} -> {r.out}")
    if done != len(reqs):
        raise SystemExit(f"{len(reqs) - done} requests did not complete")


if __name__ == "__main__":
    main()
