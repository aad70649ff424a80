"""Communication-tree construction for restricted collectives (paper §3).

The paper implements restricted (subset) broadcast / reduction with
asynchronous point-to-point messages routed along an explicit tree:

* ``FLAT``    — root sends ``p-1`` messages (PSelInv v0.7.3 baseline).
* ``BINARY``  — the ordered receiver list is split in halves recursively;
  the *first* rank of each half becomes an internal (forwarding) node.
* ``SHIFTED`` — a (pseudo-random, tag-seeded) circular shift is applied to
  the sorted receiver list before the binary construction, so that
  *concurrent* collectives pick different internal nodes (the paper's
  load-balancing heuristic).
* ``HYBRID``  — flat below a participant-count threshold (intra-node fast
  path, paper §4.2), shifted-binary above it.

The same :class:`CommTree` objects drive both the discrete-event network
simulator (`core/simulator.py`) and the executable ``ppermute`` lowering
(`comm/treecomm.py`), so the schedule that is *simulated* is the schedule
that *runs*.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "TreeKind",
    "CommTree",
    "flat_tree",
    "binary_tree",
    "shifted_binary_tree",
    "build_tree",
    "stable_hash",
]


class TreeKind(enum.Enum):
    FLAT = "flat"
    BINARY = "binary"
    SHIFTED = "shifted"
    HYBRID = "hybrid"


def stable_hash(*vals: int) -> int:
    """Deterministic 32-bit FNV-1a over integers (independent of
    PYTHONHASHSEED, stable across processes — required so that every rank
    of an SPMD program derives the *same* shift for the same collective)."""
    h = 2166136261
    for v in vals:
        for b in int(v).to_bytes(8, "little", signed=True):
            h ^= b
            h = (h * 16777619) & 0xFFFFFFFF
    return h


@dataclass(frozen=True)
class CommTree:
    """An explicit communication tree over integer ranks.

    ``children`` lists are *ordered*: a node forwards to its children one
    message per round, in order (each rank can source at most one
    point-to-point transfer per round — the ``collective-permute``
    constraint, and also how MPI_Isend progression was modeled in the
    paper's cost analysis).
    """

    root: int
    ranks: Tuple[int, ...]  # all participants, root included
    children: Tuple[Tuple[int, Tuple[int, ...]], ...]  # (rank, ordered kids)

    # -- derived ---------------------------------------------------------
    def children_map(self) -> Dict[int, Tuple[int, ...]]:
        return dict(self.children)

    def parent_map(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for p, kids in self.children:
            for k in kids:
                out[k] = p
        return out

    def messages_sent(self) -> Dict[int, int]:
        """Number of point-to-point messages each rank *sends* during a
        broadcast over this tree (== messages *received* during the mirrored
        reduction). This is the quantity behind the paper's Table 1."""
        return {p: len(kids) for p, kids in self.children if kids}

    def recv_round(self) -> Dict[int, int]:
        """Round at which each rank holds the data, under the one-message-
        per-round-per-sender schedule. root -> 0."""
        kmap = self.children_map()
        t: Dict[int, int] = {self.root: 0}
        stack = [self.root]
        while stack:
            u = stack.pop()
            for i, c in enumerate(kmap.get(u, ())):
                t[c] = t[u] + i + 1
                stack.append(c)
        return t

    def bcast_rounds(self) -> List[List[Tuple[int, int]]]:
        """Per-round (src, dst) edge lists for a broadcast. Round ``r``
        contains edges whose destination receives at round ``r+1``."""
        t = self.recv_round()
        nrounds = max(t.values(), default=0)
        rounds: List[List[Tuple[int, int]]] = [[] for _ in range(nrounds)]
        pmap = self.parent_map()
        for dst, r in t.items():
            if dst == self.root:
                continue
            rounds[r - 1].append((pmap[dst], dst))
        return rounds

    def reduce_rounds(self) -> List[List[Tuple[int, int]]]:
        """Per-round (src, dst) edge lists for the mirrored reduction
        (leaves send first; root combines last)."""
        return [[(d, s) for (s, d) in rnd] for rnd in reversed(self.bcast_rounds())]

    def depth(self) -> int:
        t = self.recv_round()
        return max(t.values(), default=0)

    def validate(self) -> None:
        """Every participant is reached exactly once; no cycles."""
        seen = {self.root}
        for p, kids in self.children:
            for k in kids:
                if k in seen:
                    raise ValueError(f"rank {k} reached twice")
                seen.add(k)
        if seen != set(self.ranks):
            raise ValueError(f"tree covers {sorted(seen)} != {sorted(self.ranks)}")


# -- construction ---------------------------------------------------------

def _binary_children(root: int, ordered: Sequence[int]) -> List[Tuple[int, Tuple[int, ...]]]:
    """Paper §3: repeatedly split the ordered receiver list in two halves;
    the first rank of each half is the internal node at the current level.

    Example (paper Fig. 3b): root=4, receivers [1,2,3,5,6] ->
    4 sends to 1 and 5; 1 sends to 2 and 3; 5 sends to 6.
    """
    out: Dict[int, List[int]] = {}

    def rec(local_root: int, lst: Sequence[int]) -> None:
        if not lst:
            return
        mid = (len(lst) + 1) // 2
        for half in (lst[:mid], lst[mid:]):
            if half:
                head = half[0]
                out.setdefault(local_root, []).append(head)
                rec(head, half[1:])

    rec(root, list(ordered))
    return [(p, tuple(kids)) for p, kids in out.items()]


def flat_tree(root: int, receivers: Sequence[int]) -> CommTree:
    recv = tuple(sorted(receivers))
    return CommTree(root=root, ranks=(root,) + recv,
                    children=((root, recv),) if recv else ())


def binary_tree(root: int, receivers: Sequence[int]) -> CommTree:
    recv = tuple(sorted(receivers))
    return CommTree(root=root, ranks=(root,) + recv,
                    children=tuple(_binary_children(root, recv)))


def shifted_binary_tree(root: int, receivers: Sequence[int], tag: int = 0,
                        shift: int | None = None) -> CommTree:
    """Binary tree over a circularly shifted receiver list (paper §3).

    ``shift`` may be given explicitly; otherwise it is derived from a
    stable hash of ``(root, tag)`` — deterministic, but decorrelated across
    collectives so concurrent trees pick different internal nodes.
    """
    recv = tuple(sorted(receivers))
    if not recv:
        return CommTree(root=root, ranks=(root,), children=())
    s = (stable_hash(root, tag) if shift is None else shift) % len(recv)
    rotated = recv[s:] + recv[:s]
    return CommTree(root=root, ranks=(root,) + recv,
                    children=tuple(_binary_children(root, rotated)))


#: Participant-count threshold below which HYBRID uses a flat tree
#: (paper §4.2: intra-node shared-memory message passing is cheap and a
#: single send buffer improves cache reuse; Edison nodes had 24 cores).
HYBRID_FLAT_MAX = 24


def build_tree(kind: TreeKind, root: int, receivers: Sequence[int],
               tag: int = 0, shift: int | None = None) -> CommTree:
    if kind is TreeKind.FLAT:
        return flat_tree(root, receivers)
    if kind is TreeKind.BINARY:
        return binary_tree(root, receivers)
    if kind is TreeKind.SHIFTED:
        return shifted_binary_tree(root, receivers, tag=tag, shift=shift)
    if kind is TreeKind.HYBRID:
        if len(receivers) + 1 <= HYBRID_FLAT_MAX:
            return flat_tree(root, receivers)
        return shifted_binary_tree(root, receivers, tag=tag, shift=shift)
    raise ValueError(f"unknown tree kind {kind!r}")


@lru_cache(maxsize=200_000)
def cached_tree(kind: str, root: int, receivers: Tuple[int, ...], tag: int) -> CommTree:
    """Memoized construction keyed on structure — PSelInv re-issues many
    collectives with identical participant sets; the simulator exploits
    this heavily."""
    return build_tree(TreeKind(kind), root, receivers, tag=tag)
