"""Supernodal (block) sparse LU factorization — the PSelInv pre-step.

PSelInv consumes an unpivoted supernodal LU (SuperLU_DIST with static
pivoting). We factorize right-looking at the supernode-block level over
the filled structure from :mod:`repro_torch.core.symbolic`.

Block math runs through a pluggable backend:

* ``numpy`` — plain BLAS on the host, the orchestration default;
* ``torch`` — plain torch ops on the backend's device (the counterpart
  of the JAX package's ``jax`` backend);
* ``cuda``  — the ``torch`` backend with the port's hand-written kernels
  (the counterpart of ``pallas``): the Schur GEMMs and the products of
  selected inversion go through ``kernels.ops.block_gemm[_acc]``, the
  right-side triangular solves L(I,K) = A(I,K)·U(K,K)⁻¹ of one supernode
  through one ``kernels.ops.trsm`` launch (all of struct(K) stacked).

The torch backends carry an explicit device (default ``"cuda"``, which
raises on a host without a card; ``device="cpu"`` runs on the host, the
``cuda`` backend then on its kernels' plain versions) and dtype (default
float64). Every host conversion of a backend array goes through the
backend's ``to_numpy``: ``np.asarray`` of a CUDA tensor raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .device import resolve_device
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
    def solve_tri_right_upper_many(bs, u):
        """X_i U = B_i (U upper) for every B_i of ``bs``."""
        import scipy.linalg as sla
        return [sla.solve_triangular(u, b.T, lower=False, trans="T").T
                for b in bs]

    @staticmethod
    def solve_tri_left_unit_lower(l, b):
        """L X = B  (L unit lower)."""
        import scipy.linalg as sla
        return sla.solve_triangular(l, b, lower=True, unit_diagonal=True)

    @staticmethod
    def asarray(x):
        return np.asarray(x, dtype=np.float64)

    @staticmethod
    def to_numpy(x):
        return np.asarray(x)


class _TorchBackend:
    """Plain torch ops on one device, in one dtype."""
    name = "torch"

    def __init__(self, device="cuda", dtype=torch.float64):
        self.device = resolve_device(device)
        self.dtype = dtype

    def gemm(self, acc, a, b, alpha=-1.0):
        if alpha != -1.0:
            raise ValueError(f"gemm supports only alpha=-1.0 (the "
                             f"Schur-update sign), got {alpha}")
        return acc - a @ b

    def matmul(self, a, b):
        return a @ b

    def solve_tri_right_upper_many(self, bs, u):
        """X_i U = B_i (U upper) for every B_i of ``bs``."""
        return [torch.linalg.solve_triangular(u, b, upper=True, left=False)
                for b in bs]

    def solve_tri_left_unit_lower(self, l, b):
        """L X = B  (L unit lower)."""
        return torch.linalg.solve_triangular(l, b, upper=False,
                                             unitriangular=True)

    def asarray(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=self.device, dtype=self.dtype)

    @staticmethod
    def to_numpy(x):
        return x.detach().cpu().numpy()


class _CudaBackend(_TorchBackend):
    """The torch backend with the port's hand-written kernels: block GEMM
    for ``gemm``/``matmul``, trsm for ``solve_tri_right_upper_many``. The
    unit-lower left solve has no TPU kernel and stays
    ``torch.linalg.solve_triangular``."""
    name = "cuda"

    def __init__(self, device="cuda", dtype=torch.float64):
        super().__init__(device, dtype)
        from ..kernels import ops as kops
        self._kops = kops

    def gemm(self, acc, a, b, alpha=-1.0):
        if alpha != -1.0:
            raise ValueError(f"gemm supports only alpha=-1.0 (the "
                             f"Schur-update sign), got {alpha}")
        return self._kops.block_gemm_acc(acc, a, b, alpha=-1.0)

    def matmul(self, a, b):
        return self._kops.block_gemm(a, b)

    def solve_tri_right_upper_many(self, bs, u):
        """X_i U = B_i for every B_i of ``bs`` in one trsm launch: the
        blocks stacked along the rows, X returned as row slices (each
        contiguous). Rows are solved independently, so each X_i has the
        bits of its own launch."""
        if not bs:
            return []
        x = self._kops.trsm(torch.cat(bs), u)
        return list(x.split([b.shape[0] for b in bs]))

    def solve_tri_left_unit_lower(self, l, b):
        """L X = B  (L unit lower). torch.linalg.solve_triangular may
        return a column-major X; U(K,J) is made row-major once here, for
        the kernels that take it in every Schur update."""
        return super().solve_tri_left_unit_lower(l, b).contiguous()


_BACKENDS: Dict[str, Callable[..., object]] = {
    "numpy": _NumpyBackend,
    "torch": _TorchBackend,
    "cuda": _CudaBackend,
}
_CACHE: Dict[tuple, object] = {}


def get_backend(name: str, device=None, dtype: Optional[torch.dtype] = None):
    """The backend ``name``, cached per (name, device, dtype). The torch
    backends default to ``device="cuda"`` and float64; the numpy backend
    takes neither."""
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have "
                         f"{sorted(_BACKENDS)}")
    if name == "numpy":
        if device not in (None, "cpu") or dtype not in (None, torch.float64):
            raise ValueError("the numpy backend runs on the host in float64")
        key = (name, None, None)
        if key not in _CACHE:
            _CACHE[key] = _NumpyBackend()
        return _CACHE[key]
    dev = resolve_device("cuda" if device is None else device)
    dt = torch.float64 if dtype is None else dtype
    key = (name, dev, dt)
    if key not in _CACHE:
        _CACHE[key] = _BACKENDS[name](dev, dt)
    return _CACHE[key]


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
    device: Optional[torch.device] = None   # torch backends: where blocks live
    dtype: Optional[torch.dtype] = None

    def nnz_blocks(self) -> int:
        return len(self.L) + len(self.U) + len(self.Ldiag) * 2


def _get_block(A: sp.csr_matrix, bs: BlockStructure, I: int, J: int) -> np.ndarray:
    r0, r1 = bs.offsets[I], bs.offsets[I + 1]
    c0, c1 = bs.offsets[J], bs.offsets[J + 1]
    return np.asarray(A[r0:r1, c0:c1].todense(), dtype=np.float64)


def factorize(A: sp.spmatrix, bs: BlockStructure | None = None,
              max_supernode: int = 32, backend: str = "cuda",
              device=None, dtype: Optional[torch.dtype] = None) -> LUFactors:
    """Right-looking supernodal LU over the filled block structure. The
    diagonal blocks are factored on the host (``dense_lu_nopivot``), the
    panel solves and Schur updates run on the backend — by default the
    ``cuda`` one, on the card (it raises without one)."""
    A = sp.csr_matrix(A)
    if bs is None:
        bs = symbolic_factorize(A, max_supernode=max_supernode)
    be = get_backend(backend, device, dtype)
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
        lkk, ukk = dense_lu_nopivot(be.to_numpy(load(K, K)))
        Ldiag[K] = be.asarray(lkk)
        Udiag[K] = be.asarray(ukk)
        C = [int(I) for I in bs.struct[K]]
        lks = be.solve_tri_right_upper_many([load(I, K) for I in C],
                                            Udiag[K])
        for I, lik in zip(C, lks):
            L[(I, K)] = lik
            U[(K, I)] = be.solve_tri_left_unit_lower(Ldiag[K], load(K, I))
        # Schur complement update over the clique struct(K) x struct(K)
        for I in C:
            lik = L[(I, K)]
            for J in C:
                work[(I, J)] = be.gemm(load(I, J), lik, U[(K, J)])

    return LUFactors(bs=bs, Ldiag=Ldiag, Udiag=Udiag, L=L, U=U,
                     backend=backend, device=getattr(be, "device", None),
                     dtype=getattr(be, "dtype", None))
