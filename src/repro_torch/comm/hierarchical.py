"""Hierarchical cross-pod collectives — the port of
``repro/comm/hierarchical.py``.

A pod of ranks with a fast link inside and a slow link between pods has
the paper's two-level network inhomogeneity. Gradient reduction is
split:

    reduce-scatter (intra-pod)  →  tree all-reduce (inter-pod)
       →  all-gather (intra-pod)

so only ``1/pod_size`` of the gradient bytes cross the slow boundary.
The inter-pod stage uses the paper's trees; concurrent buckets get
different shifted-tree rotations (``tag=bucket``), so the forwarding
role rotates across pods.

The mesh is ``npods × inner_size`` ranks of the default group, rank =
pod·inner_size + inner (the JAX test's ``devs.reshape(npods,
inner_size)``); :func:`mesh_groups` builds the two groups a rank needs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.trees import TreeKind, build_tree
from .p2p import all_gather, reduce_scatter
from .treecomm import tree_allreduce

__all__ = ["cross_pod_tree_allreduce", "hierarchical_allreduce",
           "mesh_groups"]


def mesh_groups(npods: int, inner_size: int):
    """(pod group, inner group) of the calling rank: the ranks that share
    its inner index across pods (group rank = pod), and the ranks of its
    own pod (group rank = inner index). ``dist.new_group`` is collective,
    so every rank of the default group builds every group, in one
    order."""
    if dist.get_world_size() != npods * inner_size:
        raise ValueError(f"a {npods}x{inner_size} mesh needs "
                         f"{npods * inner_size} ranks, the group has "
                         f"{dist.get_world_size()}")
    me = dist.get_rank()
    pod_group = inner_group = None
    for i in range(inner_size):
        g = dist.new_group([p * inner_size + i for p in range(npods)])
        if me % inner_size == i:
            pod_group = g
    for p in range(npods):
        g = dist.new_group([p * inner_size + i for i in range(inner_size)])
        if me // inner_size == p:
            inner_group = g
    return pod_group, inner_group


def cross_pod_tree_allreduce(x: torch.Tensor, pod_group, npods: int,
                             kind: TreeKind = TreeKind.SHIFTED,
                             tag: int = 0, root: int = 0) -> torch.Tensor:
    """All-reduce across the pod group via an explicit comm tree."""
    if npods == 1:
        return x
    receivers = [p for p in range(npods) if p != root]
    tree = build_tree(kind, root, receivers, tag=tag)
    return tree_allreduce(x, pod_group, tree)


def hierarchical_allreduce(x: torch.Tensor, pod_group, inner_group,
                           npods: int, inner_size: int,
                           kind: TreeKind = TreeKind.SHIFTED,
                           tag: int = 0) -> torch.Tensor:
    """RS(intra) → tree-AR(inter) → AG(intra) over a 2-level mesh.

    ``x`` must have a leading dim divisible by ``inner_size``. Every rank
    of the mesh calls it, with its own groups (:func:`mesh_groups`)."""
    # 1. reduce-scatter within the pod: each inner rank ends with one
    #    1/inner_size slice of the pod-local sum
    scat = reduce_scatter(x, inner_group)
    # 2. cross-pod tree all-reduce on the slice, the tree's root rotated
    #    by the tag so concurrent buckets spread the forwarding load
    root = tag % npods
    scat = cross_pod_tree_allreduce(scat, pod_group, npods, kind=kind,
                                    tag=tag, root=root)
    # 3. all-gather within the pod
    return all_gather(scat, inner_group)
