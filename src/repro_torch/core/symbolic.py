"""Supernode partition + block symbolic factorization + block etree.

PSelInv consumes a supernodal LU factorization. Following the paper
(§2.1), supernodes are *relaxed*: maximal same-structure column runs,
capped at ``max_size`` columns. We operate directly at the block
(supernode) level:

1. partition columns into supernodes,
2. form the quotient (block) structure of ``A``,
3. run a right-looking *block* symbolic factorization to obtain the filled
   block structure of ``L`` (struct-symmetric => ``U = Lᵀ`` structurally),
4. derive the block elimination tree: ``parent(K) = min struct(K)``.

All downstream machinery — the comm-event schedule, the simulator, the
numeric factorization and the selected inversion — works on the resulting
:class:`BlockStructure`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["BlockStructure", "partition_supernodes", "symbolic_factorize"]


def partition_supernodes(n: int, max_size: int,
                         sizes: np.ndarray | None = None) -> np.ndarray:
    """Column offsets of the supernode partition.

    If per-element ``sizes`` are given (e.g. dense atom blocks from
    ``sparse.dg_like_matrix``), supernodes are groups of whole elements
    with total width <= max_size; else fixed-width blocking of columns.
    Returns ``offsets`` with supernode K owning columns
    [offsets[K], offsets[K+1]).
    """
    if sizes is None:
        cuts = list(range(0, n, max_size)) + [n]
        return np.asarray(cuts, dtype=np.int64)
    offs = [0]
    acc = 0
    for s in sizes:
        if acc and acc + s > max_size:
            offs.append(offs[-1] + acc)
            acc = 0
        acc += int(s)
    offs.append(offs[-1] + acc)
    if offs[-1] != n:
        raise ValueError(
            f"supernode cuts cover {offs[-1]} of {n} columns — the "
            "given sizes do not partition the matrix")
    return np.asarray(offs, dtype=np.int64)


@dataclass
class BlockStructure:
    """Filled block (supernodal) structure of the LU factors."""

    offsets: np.ndarray                 # (NB+1,) supernode column offsets
    struct: List[np.ndarray]            # struct[K] = sorted I>K with L(I,K)!=0
    a_struct: List[np.ndarray]          # pre-fill block structure of A
    parent: np.ndarray                  # block etree, -1 at roots

    @property
    def nsuper(self) -> int:
        return len(self.offsets) - 1

    def width(self, K: int) -> int:
        return int(self.offsets[K + 1] - self.offsets[K])

    def widths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def children(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.nsuper)]
        for k, p in enumerate(self.parent):
            if p >= 0:
                out[int(p)].append(k)
        return out

    def roots(self) -> List[int]:
        return [k for k, p in enumerate(self.parent) if p < 0]

    def postorder(self) -> np.ndarray:
        """Children-before-parents ordering (factorization order)."""
        order: List[int] = []
        ch = self.children()
        for r in self.roots():
            stack = [(r, False)]
            while stack:
                node, done = stack.pop()
                if done:
                    order.append(node)
                else:
                    stack.append((node, True))
                    for c in reversed(ch[node]):
                        stack.append((c, False))
        return np.asarray(order, dtype=np.int64)

    def fill_nnz_blocks(self) -> int:
        return sum(len(s) for s in self.struct)

    def postordered(self) -> "BlockStructure":
        """Relabel supernodes by etree postorder (children before parents,
        subtrees contiguous) — the ordering SuperLU_DIST hands PSelInv.
        Ancestor chains become near-contiguous, which concentrates
        flat-tree roots near the grid diagonal (paper Fig. 5a)."""
        order = self.postorder()                     # new -> old
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))           # old -> new
        w = self.widths()
        new_offsets = np.concatenate([[0], np.cumsum(w[order])])
        new_struct = [np.sort(inv[self.struct[int(o)]]) for o in order]
        new_a = [np.sort(inv[self.a_struct[int(o)]]) for o in order]
        new_parent = np.array(
            [inv[self.parent[int(o)]] if self.parent[int(o)] >= 0 else -1
             for o in order], dtype=np.int64)
        return BlockStructure(offsets=new_offsets, struct=new_struct,
                              a_struct=new_a, parent=new_parent)

    def factor_nnz(self) -> int:
        """nnz in L+U (both triangles + diagonal blocks)."""
        w = self.widths()
        tri = sum(int(w[K]) * int(w[K]) for K in range(self.nsuper))
        off = sum(int(w[K]) * int(w[int(I)]) for K in range(self.nsuper)
                  for I in self.struct[K])
        return tri + 2 * off


def symbolic_factorize_elements(G: sp.spmatrix, sizes: np.ndarray,
                                max_supernode: int = 32) -> BlockStructure:
    """Block symbolic factorization straight from an *element* graph
    (nodes = dense element blocks of ``sizes[e]`` columns, as produced by
    ``sparse.dg_like_structure``/``fem3d_like_structure``) — avoids
    materializing the kron-expanded scalar pattern at bench scale."""
    G = sp.csr_matrix(G)
    ne = G.shape[0]
    sizes = np.asarray(sizes, dtype=np.int64)
    n = int(sizes.sum())

    # group consecutive elements into supernodes of width <= max_supernode
    el2sn = np.zeros(ne, dtype=np.int64)
    offsets = [0]
    acc = 0
    sn = 0
    for e in range(ne):
        s = int(sizes[e])
        if acc and acc + s > max_supernode:
            offsets.append(offsets[-1] + acc)
            sn += 1
            acc = 0
        el2sn[e] = sn
        acc += s
    offsets.append(offsets[-1] + acc)
    offsets = np.asarray(offsets, dtype=np.int64)
    nb = len(offsets) - 1

    coo = G.tocoo()
    bi = el2sn[coo.row]
    bj = el2sn[coo.col]
    mask = bi > bj
    pairs = np.unique(np.stack([bj[mask], bi[mask]], axis=1), axis=0)
    a_struct: List[List[int]] = [[] for _ in range(nb)]
    for J, I in pairs:
        a_struct[int(J)].append(int(I))

    struct: List[set] = [set(s) for s in a_struct]
    parent = np.full(nb, -1, dtype=np.int64)
    for K in range(nb):
        s = struct[K]
        if not s:
            continue
        p = min(s)
        parent[K] = p
        struct[p].update(x for x in s if x != p)

    return BlockStructure(
        offsets=offsets,
        struct=[np.asarray(sorted(s), dtype=np.int64) for s in struct],
        a_struct=[np.asarray(sorted(s), dtype=np.int64) for s in a_struct],
        parent=parent,
    )


def symbolic_factorize(A: sp.spmatrix, max_supernode: int = 32,
                       sizes: np.ndarray | None = None) -> BlockStructure:
    """Block symbolic factorization of a structurally-symmetric pattern.

    For non-symmetric input the pattern of ``A + Aᵀ`` is used (what
    SuperLU_DIST does before MC64/ND). Right-looking fill rule at block
    granularity: for each supernode K with parent P = min(struct(K)),
    struct(P) ∪= struct(K) \\ {P}.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    S = ((A != 0) + (A.T != 0)).tocsr()
    offsets = partition_supernodes(n, max_supernode, sizes)
    nb = len(offsets) - 1

    # map columns -> supernode
    col2sn = np.zeros(n, dtype=np.int64)
    for K in range(nb):
        col2sn[offsets[K]:offsets[K + 1]] = K

    # quotient structure of A (lower block triangle, strict)
    coo = S.tocoo()
    bi = col2sn[coo.row]
    bj = col2sn[coo.col]
    mask = bi > bj
    pairs = np.unique(np.stack([bj[mask], bi[mask]], axis=1), axis=0)
    a_struct: List[List[int]] = [[] for _ in range(nb)]
    for J, I in pairs:
        a_struct[int(J)].append(int(I))

    struct: List[set] = [set(s) for s in a_struct]
    parent = np.full(nb, -1, dtype=np.int64)
    for K in range(nb):
        s = struct[K]
        if not s:
            continue
        p = min(s)
        parent[K] = p
        struct[p].update(x for x in s if x != p)

    return BlockStructure(
        offsets=offsets,
        struct=[np.asarray(sorted(s), dtype=np.int64) for s in struct],
        a_struct=[np.asarray(sorted(s), dtype=np.int64) for s in a_struct],
        parent=parent,
    )
