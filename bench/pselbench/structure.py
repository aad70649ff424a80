"""The benchmark's own structure analysis and operation counts.

``block_structure`` is a frozen copy of the fixed-width branch of
``symbolic_factorize`` in ``src/repro_torch/core/symbolic.py`` at commit
738e407: supernodes of ``b`` columns, the quotient pattern of A + Aᵀ,
and the right-looking block fill rule struct(P) ∪= struct(K) \\ {P} with
P = min struct(K). The reference picks its selected blocks from it, and
the roofline counts its work on it, whatever the port computes.

The selected inversion of a symmetric A = L D Lᵀ walks the supernodes
from the last to the first; with C = struct(K) (``c = |C|``) it needs

    A⁻¹(C, K) = −A⁻¹(C, C) · L̂(C, K)       2·(c·b)²·b operations
    A⁻¹(K, K) = D⁻¹(K, K) − L̂(C, K)ᵀ · A⁻¹(C, K)   2·c·b·b² operations

(A⁻¹(K, C) is the transpose: no work). Its least traffic reads L̂(C, K)
and D⁻¹(K, K) once and writes each selected block once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["Structure", "block_structure", "selected_pairs",
           "inversion_flops", "inversion_bytes"]


@dataclass(frozen=True)
class Structure:
    """Filled block structure: ``struct[K]``, the sorted supernodes I > K
    with L(I, K) ≠ 0, for supernodes of width ``b``."""
    b: int
    struct: Tuple[np.ndarray, ...]

    @property
    def nsuper(self) -> int:
        return len(self.struct)


def block_structure(A, b: int) -> Structure:
    """Block symbolic factorization of the pattern of A + Aᵀ with
    supernodes of ``b`` columns."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n % b:
        raise ValueError(f"n={n} is not a multiple of b={b}")
    S = ((A != 0) + (A.T != 0)).tocoo()
    bi = S.row // b
    bj = S.col // b
    mask = bi > bj
    pairs = np.unique(np.stack([bj[mask], bi[mask]], axis=1), axis=0)
    nb = n // b
    struct: List[set] = [set() for _ in range(nb)]
    for J, I in pairs:
        struct[int(J)].add(int(I))
    for K in range(nb):
        if struct[K]:
            p = min(struct[K])
            struct[p].update(x for x in struct[K] if x != p)
    return Structure(b=b, struct=tuple(np.asarray(sorted(s), dtype=np.int64)
                                       for s in struct))


def selected_pairs(st: Structure) -> Tuple[np.ndarray, np.ndarray]:
    """The selected blocks as (row, column) supernode index arrays: each
    diagonal block, then struct(K) × K and its transpose."""
    rows, cols = [], []
    for K, C in enumerate(st.struct):
        rows.append(np.array([K]))
        cols.append(np.array([K]))
        rows += [C, np.full_like(C, K)]
        cols += [np.full_like(C, K), C]
    return np.concatenate(rows), np.concatenate(cols)


def inversion_flops(st: Structure) -> int:
    """Floating-point operations (two a multiply-add) that one selected
    inversion needs on this structure."""
    c = np.array([len(C) for C in st.struct], dtype=np.int64)
    return int(2 * st.b ** 3 * (c * c + c).sum())


def inversion_bytes(st: Structure, elt: int = 8) -> int:
    """Bytes one selected inversion must move at the least: L̂(C, K) and
    D⁻¹(K, K) read once, each selected block written once."""
    c = int(sum(len(C) for C in st.struct))
    blocks_read = c + st.nsuper
    blocks_written = 2 * c + st.nsuper
    return int((blocks_read + blocks_written) * st.b * st.b * elt)
