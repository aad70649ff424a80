"""Selected inversion (paper Algorithm 1), supernodal/blocked.

Given supernodal LU factors of ``A``, computes every block ``A⁻¹(I,J)``
on the *filled* block pattern (both triangles + diagonals) — a superset of
the paper's selected set Eq. (1), closed under the clique property that
Algorithm 1 requires (for I,J ∈ struct(K), block (I,J) is in the filled
pattern).

Two layers:

* :func:`selinv` — the production supernodal algorithm (Python
  orchestration mirrors the per-supernode task graph that the
  distributed runtime executes; the host assembles A⁻¹(C,C), the LU's
  backend — ``numpy``, ``torch`` or ``cuda`` — runs the products),
* :func:`dense_selinv_oracle` — O(N³) dense oracle used by the tests.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from .supernodal_lu import LUFactors, factorize, get_backend
from .symbolic import BlockStructure, symbolic_factorize

__all__ = ["selinv", "selected_inverse", "dense_selinv_oracle",
           "normalize_factors"]

Key = Tuple[int, int]


def _backend(lu: LUFactors):
    return get_backend(lu.backend, lu.device, lu.dtype)


def normalize_factors(lu: LUFactors):
    """Paper Alg. 1, first loop:  L̂(C,K) = L(C,K)·L(K,K)⁻¹,
    Û(K,C) = U(K,K)⁻¹·U(K,C).  (In PSelInv this pass has the simple
    column-group broadcast of the diagonal block.) The solves run on the
    host, as in the JAX package; the results are backend arrays."""
    be = _backend(lu)
    bs = lu.bs
    Lhat: Dict[Key, np.ndarray] = {}
    Uhat: Dict[Key, np.ndarray] = {}
    for K in range(bs.nsuper):
        ld = be.to_numpy(lu.Ldiag[K])
        ud = be.to_numpy(lu.Udiag[K])
        for I in bs.struct[K]:
            I = int(I)
            # X L = B  with L unit-lower  <=>  Lᵀ Xᵀ = Bᵀ (unit-upper solve)
            lik = be.to_numpy(lu.L[(I, K)])
            Lhat[(I, K)] = be.asarray(
                sla.solve_triangular(ld.T, lik.T, lower=False,
                                     unit_diagonal=True).T)
            # U X = B with U upper
            uki = be.to_numpy(lu.U[(K, I)])
            Uhat[(K, I)] = be.asarray(
                sla.solve_triangular(ud, uki, lower=False))
    return Lhat, Uhat


def selinv(lu: LUFactors) -> Dict[Key, np.ndarray]:
    """Paper Algorithm 1, second loop, at supernode-block granularity.
    Every block comes back as a numpy array: the host assembles
    A⁻¹(C,C) from them for the next supernodes anyway."""
    be = _backend(lu)
    bs = lu.bs
    nb = bs.nsuper
    Lhat, Uhat = normalize_factors(lu)

    def diag_inv(K: int) -> np.ndarray:
        # (U_KK)⁻¹ (L_KK)⁻¹
        n = bs.width(K)
        linv = sla.solve_triangular(be.to_numpy(lu.Ldiag[K]), np.eye(n),
                                    lower=True, unit_diagonal=True)
        return be.asarray(sla.solve_triangular(be.to_numpy(lu.Udiag[K]),
                                               linv, lower=False))

    Ainv: Dict[Key, np.ndarray] = {}
    w = bs.widths()

    for K in range(nb - 1, -1, -1):
        C = [int(i) for i in bs.struct[K]]
        if not C:
            Ainv[(K, K)] = be.to_numpy(diag_inv(K))
            continue
        sizes = [int(w[i]) for i in C]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        m = int(offs[-1])
        wk = bs.width(K)

        # gather A⁻¹(C,C) — every (J,I) block exists (clique property)
        AinvCC = np.zeros((m, m))
        for a, J in enumerate(C):
            for b, I in enumerate(C):
                AinvCC[offs[a]:offs[a + 1], offs[b]:offs[b + 1]] = \
                    Ainv[(J, I)]
        AinvCC = be.asarray(AinvCC)

        LhatCK = be.asarray(np.concatenate(
            [be.to_numpy(Lhat[(I, K)]) for I in C], axis=0))
        UhatKC = be.asarray(np.concatenate(
            [be.to_numpy(Uhat[(K, I)]) for I in C], axis=1))

        # step 3:  A⁻¹(C,K) = −A⁻¹(C,C)·L̂(C,K)
        AinvCK = -be.matmul(AinvCC, LhatCK)
        # step 5:  A⁻¹(K,C) = −Û(K,C)·A⁻¹(C,C)
        AinvKC = -be.matmul(UhatKC, AinvCC)
        # step 4:  A⁻¹(K,K) = U⁻¹L⁻¹ − Û(K,C)·A⁻¹(C,K)
        AinvKK = be.gemm(diag_inv(K), UhatKC, AinvCK)

        AinvCK = be.to_numpy(AinvCK)
        AinvKC = be.to_numpy(AinvKC)
        for a, J in enumerate(C):
            Ainv[(J, K)] = AinvCK[offs[a]:offs[a + 1], :]
            Ainv[(K, J)] = AinvKC[:, offs[a]:offs[a + 1]]
        Ainv[(K, K)] = be.to_numpy(AinvKK)

    return Ainv


def selected_inverse(A: sp.spmatrix, max_supernode: int = 32,
                     backend: str = "cuda", device=None,
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[Dict[Key, np.ndarray], BlockStructure]:
    """End-to-end: symbolic → LU → selected inversion, by default on the
    card (the ``cuda`` backend; it raises without one — pass
    ``backend="numpy"`` or ``device="cpu"`` for the host). ``device`` and
    ``dtype`` choose where the torch backends run (default the card, in
    float64)."""
    bs = symbolic_factorize(A, max_supernode=max_supernode)
    lu = factorize(A, bs=bs, backend=backend, device=device, dtype=dtype)
    return selinv(lu), bs


def dense_selinv_oracle(A: sp.spmatrix) -> np.ndarray:
    """O(N³) oracle: the full inverse."""
    return np.linalg.inv(np.asarray(sp.csr_matrix(A).todense()))


def compare_with_oracle(Ainv_blocks: Dict[Key, np.ndarray],
                        bs: BlockStructure, A: sp.spmatrix) -> float:
    """Max abs error of every computed block vs the dense inverse."""
    ref = dense_selinv_oracle(A)
    err = 0.0
    for (I, J), blk in Ainv_blocks.items():
        r0, r1 = bs.offsets[I], bs.offsets[I + 1]
        c0, c1 = bs.offsets[J], bs.offsets[J + 1]
        err = max(err, float(np.max(np.abs(np.asarray(blk) - ref[r0:r1, c0:c1]))))
    return err
