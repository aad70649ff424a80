"""Supernodal (block) sparse LU factorization — the PSelInv pre-step.

PSelInv consumes an unpivoted supernodal LU (SuperLU_DIST with static
pivoting). We factorize right-looking at the supernode-block level over
the filled structure from :mod:`repro_torch.core.symbolic`.

Block math runs through a pluggable backend. This package carries the
``numpy`` backend only (plain BLAS on the host, the orchestration
default); device backends built on the port's kernels come later.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import scipy.sparse as sp

from .symbolic import BlockStructure, symbolic_factorize

__all__ = ["LUFactors", "factorize", "get_backend", "dense_lu_nopivot"]

Key = Tuple[int, int]


# -- backends ---------------------------------------------------------------

class _NumpyBackend:
    name = "numpy"

    @staticmethod
    def gemm(acc, a, b, alpha=-1.0):
        return acc + alpha * (a @ b)

    @staticmethod
    def matmul(a, b):
        return a @ b

    @staticmethod
    def solve_tri_right_upper(b, u):
        """X U = B  (U upper)."""
        import scipy.linalg as sla
        return sla.solve_triangular(u, b.T, lower=False, trans="T").T

    @staticmethod
    def solve_tri_left_unit_lower(l, b):
        """L X = B  (L unit lower)."""
        import scipy.linalg as sla
        return sla.solve_triangular(l, b, lower=True, unit_diagonal=True)

    @staticmethod
    def asarray(x):
        return np.asarray(x, dtype=np.float64)


_BACKENDS: Dict[str, Callable[[], object]] = {
    "numpy": _NumpyBackend,
}
_CACHE: Dict[str, object] = {}


def get_backend(name: str):
    if name not in _CACHE:
        _CACHE[name] = _BACKENDS[name]()
    return _CACHE[name]


# -- dense unpivoted LU -------------------------------------------------------

def dense_lu_nopivot(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Doolittle LU without pivoting: A = L U, L unit-lower.
    Stable for the diagonally-dominant blocks we feed it (static pivoting
    regime, as in SuperLU_DIST under PSelInv)."""
    a = np.array(a, dtype=np.float64, copy=True)
    n = a.shape[0]
    for k in range(n - 1):
        piv = a[k, k]
        a[k + 1:, k] /= piv
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    L = np.tril(a, -1) + np.eye(n)
    U = np.triu(a)
    return L, U


# -- factorization ------------------------------------------------------------

@dataclass
class LUFactors:
    bs: BlockStructure
    Ldiag: Dict[int, np.ndarray]      # unit-lower diagonal factors
    Udiag: Dict[int, np.ndarray]      # upper diagonal factors
    L: Dict[Key, np.ndarray]          # off-diag L(I,K), I > K
    U: Dict[Key, np.ndarray]          # off-diag U(K,J), J > K
    backend: str = "numpy"

    def nnz_blocks(self) -> int:
        return len(self.L) + len(self.U) + len(self.Ldiag) * 2


def _get_block(A: sp.csr_matrix, bs: BlockStructure, I: int, J: int) -> np.ndarray:
    r0, r1 = bs.offsets[I], bs.offsets[I + 1]
    c0, c1 = bs.offsets[J], bs.offsets[J + 1]
    return np.asarray(A[r0:r1, c0:c1].todense(), dtype=np.float64)


def factorize(A: sp.spmatrix, bs: BlockStructure | None = None,
              max_supernode: int = 32, backend: str = "numpy") -> LUFactors:
    """Right-looking supernodal LU over the filled block structure."""
    A = sp.csr_matrix(A)
    if bs is None:
        bs = symbolic_factorize(A, max_supernode=max_supernode)
    be = get_backend(backend)
    nb = bs.nsuper

    # working Schur storage, lazily initialized from A
    work: Dict[Key, np.ndarray] = {}

    def load(I: int, J: int):
        key = (I, J)
        if key not in work:
            work[key] = be.asarray(_get_block(A, bs, I, J))
        return work[key]

    Ldiag: Dict[int, np.ndarray] = {}
    Udiag: Dict[int, np.ndarray] = {}
    L: Dict[Key, np.ndarray] = {}
    U: Dict[Key, np.ndarray] = {}

    for K in range(nb):
        lkk, ukk = dense_lu_nopivot(np.asarray(load(K, K)))
        Ldiag[K] = be.asarray(lkk)
        Udiag[K] = be.asarray(ukk)
        C = bs.struct[K]
        for I in C:
            I = int(I)
            L[(I, K)] = be.solve_tri_right_upper(load(I, K), Udiag[K])
            U[(K, I)] = be.solve_tri_left_unit_lower(Ldiag[K], load(K, I))
        # Schur complement update over the clique struct(K) x struct(K)
        for I in C:
            I = int(I)
            lik = L[(I, K)]
            for J in C:
                J = int(J)
                work[(I, J)] = be.gemm(load(I, J), lik, U[(K, int(J))])

    return LUFactors(bs=bs, Ldiag=Ldiag, Udiag=Udiag, L=L, U=U,
                     backend=backend)
