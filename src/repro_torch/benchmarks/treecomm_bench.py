"""Tree-collective accounting over rank processes — the port's twin of
``benchmarks/treecomm_bench.py``: hierarchical (reduce-scatter in a pod,
a shifted-tree all-reduce across pods, all-gather in a pod) against a
flat all-reduce, on 8 rank processes as 2 pods × 4
(``comm.p2p.spawn``, gloo; on the card every rank shares it and the
payloads are staged through pinned host memory).

The flat sync is ``torch.distributed.all_reduce`` over the whole group,
the counterpart of ``psum``. The tree's permute bytes are read from the
send log (``p2p.LOG``: what each rank sent); its reduce-scatter and
all-gather bytes, and the flat all-reduce's, are reckoned from their
result shapes per rank, as the JAX bench counts compiled HLO results,
and labelled ``reckoned``. The results must agree, as in the JAX bench.
Each row's ``us_per_call`` is the sync's wall (max over ranks, host
clock ending in a synchronize, after one warm-up)."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import resolve_device
from .common import csv_row

NPODS, INNER = 2, 4


def _rank(rank: int, n: int, device: str):
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
    x = (torch.arange(n, dtype=torch.float32) % 97 + rank).to(dev)

    def tree(v):
        return hierarchical_allreduce(v, pod_group, inner_group, NPODS,
                                      INNER, kind=TreeKind.SHIFTED, tag=3)

    def flat(v):
        h = v.to("cpu", copy=True)   # gloo reduces host memory, in place
        dist.all_reduce(h)
        return h.to(dev)

    res = {}
    for name, fn in (("flat_psum", flat), ("hier_tree", tree)):
        fn(x)
        dist.barrier()
        p2p.LOG.clear()
        t0 = time.perf_counter()
        y = fn(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res[name] = dict(wall_s=time.perf_counter() - t0,
                         out=y.cpu().numpy(), sent=p2p.LOG.sent()[1])
    return res


def run(full: bool = False, device="cuda"):
    from ..comm import p2p

    dev = resolve_device(device)
    n = 1 << (16 if full else 12)
    rows = p2p.spawn(_rank, NPODS * INNER, n, str(dev), timeout=600)
    elt = 4
    reckoned = {
        "flat_psum": {"all-reduce": n * elt},
        "hier_tree": {"reduce-scatter": n // INNER * elt,
                      "all-gather": n * elt},
    }
    for name in ("flat_psum", "hier_tree"):
        wall = max(r[name]["wall_s"] for r in rows)
        parts = [f"{k}={v / 1e3:.1f}KB(reckoned)"
                 for k, v in reckoned[name].items()]
        if name == "hier_tree":
            sent = max(r[name]["sent"] for r in rows)
            parts.insert(1, f"collective-permute={sent / 1e3:.1f}KB"
                            "(send log, max over ranks)")
        csv_row(f"treecomm/{name}", wall * 1e6, " ".join(parts))
    a = np.stack([r["flat_psum"]["out"] for r in rows])
    b = np.stack([r["hier_tree"]["out"] for r in rows])
    assert np.allclose(a, b)
    csv_row("treecomm/equivalence", 0.0, "tree == psum: True")
    return rows
