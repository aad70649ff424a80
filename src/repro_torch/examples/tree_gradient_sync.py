"""The paper's technique in a data-parallel gradient sync: hierarchical
*tree* cross-pod reduction against a flat all-reduce, on 8 rank
processes as 2 pods × 4 — numerically identical, a different
communication schedule. The twin of ``examples/tree_gradient_sync.py``:
where the JAX example prints the collectives of the compiled HLO, this
one prints what each rank's send log counted.

    PYTHONPATH=src python -m repro_torch.examples.tree_gradient_sync \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

NPODS, INNER = 2, 4


def _rank(rank: int, device: str):
    import torch.distributed as dist

    from ..comm import p2p
    from ..comm.hierarchical import hierarchical_allreduce, mesh_groups
    from ..core.trees import TreeKind

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    pod_group, inner_group = mesh_groups(NPODS, INNER)
    x = torch.arange(2.0 * 4 * 4096).reshape(2, 4, 4096) / 1e5
    xb = x[rank // INNER, rank % INNER].reshape(1, -1).to(dev)
    w = (torch.ones(4096) * 0.1).to(dev).requires_grad_()
    torch.sum(torch.tanh(xb @ w)).backward()
    g = w.grad.detach()

    out = {}
    p2p.LOG.clear()
    # reduce-scatter in the pod, shifted-tree all-reduce across pods,
    # all-gather in the pod
    out["tree"] = hierarchical_allreduce(
        g, pod_group, inner_group, NPODS, INNER, kind=TreeKind.SHIFTED,
        tag=0).cpu().numpy()
    sent = p2p.LOG.sent()
    h = g.to("cpu", copy=True)
    dist.all_reduce(h)                    # the flat sum, psum's twin
    out["psum"] = h.numpy()
    return dict(out, sent=sent)


def main(argv=None):
    from ..comm import p2p
    from ..core.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = p2p.spawn(_rank, NPODS * INNER, str(dev), timeout=300)
    for r, row in enumerate(rows):
        n, nbytes = row["sent"]
        print(f"rank {r}: tree sync sent {n} point-to-point message(s), "
              f"{nbytes / 1e3:.1f} KB (send log); reduce-scatter "
              f"{4096 // INNER * 4 / 1e3:.1f} KB and all-gather "
              f"{4096 * 4 / 1e3:.1f} KB reckoned; flat all-reduce "
              f"{4096 * 4 / 1e3:.1f} KB reckoned")
    tree = np.stack([row["tree"] for row in rows])
    flat = np.stack([row["psum"] for row in rows])
    assert np.allclose(tree, flat, rtol=1e-6)
    print("gradients identical: True")


if __name__ == "__main__":
    main()
