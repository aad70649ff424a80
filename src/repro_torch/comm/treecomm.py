"""Executable tree collectives: the paper's restricted broadcast/reduce
as :func:`~.p2p.ppermute` rounds over a ``torch.distributed`` group — the
port of ``repro/comm/treecomm.py``.

A process group, like the MPI standard and like XLA's mesh axes, has no
*subset* collective: ``all_reduce`` involves every rank of the group.
As the paper does with ``MPI_Isend/Irecv``, restricted collectives are
built from point-to-point transfers: each :class:`CommTree` becomes a
static schedule of rounds (one (src, dst) set per round; a rank sources
at most one transfer per round — the collective-permute rule, and the
paper's one-message-at-a-time sender model).

Every rank of ``group`` calls each function with the same arguments (the
rounds are SPMD); trees are over *group ranks* [0, group size). Where
the JAX package takes an axis name, these take the group (None: the
default group)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.trees import CommTree, TreeKind, build_tree
from .p2p import ppermute

__all__ = ["tree_broadcast", "tree_reduce", "tree_allreduce",
           "subset_broadcast", "subset_reduce", "batched_rounds"]


def _receives(me: int, perm: List[Tuple[int, int]]) -> bool:
    return any(d == me for _, d in perm)


def _apply_bcast_rounds(x: torch.Tensor, rounds, group) -> torch.Tensor:
    """Broadcast rounds: destinations overwrite their buffer with the
    received value; everyone else keeps theirs."""
    for perm in rounds:
        x = ppermute(x, perm, group)
    return x


def _apply_reduce_rounds(x: torch.Tensor, rounds, group) -> torch.Tensor:
    """Reduction rounds: receivers accumulate the incoming partial, in
    the JAX order ``o + m``."""
    me = dist.get_rank(group)
    for perm in rounds:
        moved = ppermute(x, perm, group)
        if _receives(me, perm):
            x = x + moved
    return x


def tree_broadcast(x: torch.Tensor, group, tree: CommTree) -> torch.Tensor:
    """Broadcast the root's value to every participant of ``tree``.
    Non-participants keep their local value."""
    return _apply_bcast_rounds(x, tree.bcast_rounds(), group)


def tree_reduce(x: torch.Tensor, group, tree: CommTree) -> torch.Tensor:
    """Sum participants' values onto the root. Non-participants are
    masked to zero before combining; the root ends with the participant
    sum, every other rank's buffer is finite working state, as with MPI
    reduce scratch buffers."""
    if dist.get_rank(group) not in tree.ranks:
        x = torch.zeros_like(x)
    return _apply_reduce_rounds(x, tree.reduce_rounds(), group)


def tree_allreduce(x: torch.Tensor, group, tree: CommTree) -> torch.Tensor:
    """Reduce onto the root then broadcast back down the same tree."""
    return tree_broadcast(tree_reduce(x, group, tree), group, tree)


def subset_broadcast(x: torch.Tensor, group, root: int,
                     members: Sequence[int],
                     kind: TreeKind = TreeKind.SHIFTED,
                     tag: int = 0) -> torch.Tensor:
    """Restricted broadcast among ``members`` (group ranks) from ``root``
    — the paper's Col-Bcast as a one-call API."""
    receivers = [m for m in members if m != root]
    return tree_broadcast(x, group, build_tree(kind, root, receivers,
                                               tag=tag))


def subset_reduce(x: torch.Tensor, group, root: int,
                  members: Sequence[int],
                  kind: TreeKind = TreeKind.SHIFTED,
                  tag: int = 0) -> torch.Tensor:
    """Restricted sum-reduction onto ``root`` — the paper's Row-Reduce."""
    receivers = [m for m in members if m != root]
    return tree_reduce(x, group, build_tree(kind, root, receivers,
                                            tag=tag))


def batched_rounds(trees: Sequence[Tuple[CommTree, int]], op: str
                   ) -> List[List[Tuple[int, int]]]:
    """Merge the per-round edge lists of several *independent* collectives
    into shared rounds, each entry ``(tree, coordinate_offset)`` moved
    into a global rank space by its offset — how PSelInv keeps many
    restricted collectives in flight at once: trees over disjoint rank
    groups interleave their (src, dst) pairs in one round. The merge
    (broadcasts left-aligned, reductions right-aligned) and the
    disjointness check (``ValueError`` naming the colliding pairs) are
    :func:`repro_torch.core.plan.merge_round_lists`, as in the JAX
    package."""
    from ..core.plan import merge_round_lists

    per_tree = []
    for tree, off in trees:
        rounds = tree.bcast_rounds() if op == "bcast" else tree.reduce_rounds()
        per_tree.append([[(s + off, d + off) for (s, d) in rnd]
                         for rnd in rounds])
    return merge_round_lists(per_tree, op)
