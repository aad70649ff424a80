"""Batched serving example: continuous batching over a request queue
with per-slot KV caches (greedy decoding of a small random-weight LM) —
the twin of ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

from ..config import get_config, reduced_config
from ..models import get_model
from ..runtime.serve_loop import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config("qwen3-32b"), vocab=2048, d_model=128,
                         n_layers=4)
    api = get_model(cfg)
    params = api.init(0, device=args.device)
    eng = ServeEngine(api, params, batch_slots=4, max_seq=64)

    prompts = [[1, 5, 9], [2, 4], [3, 3, 3, 3], [7], [11, 13], [17, 19, 23]]
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out}")
        assert r.done and len(r.out) == 8


if __name__ == "__main__":
    main()
