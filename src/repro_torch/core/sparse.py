"""Synthetic structured sparse matrices + orderings.

The paper evaluates on two matrices we cannot redistribute offline:

* ``DG_PNF14000`` — Kohn-Sham Hamiltonian of a 2-D phosphorene nanoflake
  (14,000 atoms, adaptive-local-basis DG discretization). N = 512,000 with
  0.2% nnz: *block-dense* — each atom/element carries a dense basis block
  (~37 columns) coupled to its 2-D lattice neighbours.
* ``audikw_1`` — 3-D FEM (UF collection), N = 943,695, 0.009% nnz.

We generate structure-faithful stand-ins: a 2-D lattice of dense
element-blocks ("dg_like") and a 3-D 27-point stencil grid ("fem3d_like"),
both ordered by geometric nested dissection (the ordering SuperLU_DIST
would get from METIS on these geometries). Generators return scipy CSR
structure; numerics helpers make them diagonally dominant so unpivoted
supernodal LU is stable (PSelInv consumes a static-pivoting SuperLU_DIST
factorization — same regime).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "grid_graph_2d", "grid_graph_3d", "nested_dissection_grid",
    "dg_like_matrix", "fem3d_like_matrix", "laplacian_2d",
    "make_numeric", "MatrixSuite", "PAPER_SUITE",
]


# -- geometric nested dissection -----------------------------------------

def nested_dissection_grid(dims: Sequence[int], leaf: int = 2) -> np.ndarray:
    """Geometric nested-dissection permutation of an n-D grid.

    Recursively splits the longest axis with a one-plane separator;
    separator nodes are ordered *last* (eliminated last => they form the
    top supernodes / etree root path, exactly the structure PSelInv's
    communication pattern feeds on).
    Returns ``perm`` with ``perm[new_index] = old_index``.
    """
    dims = tuple(int(d) for d in dims)
    idx = np.arange(int(np.prod(dims))).reshape(dims)

    def rec(block: np.ndarray) -> List[int]:
        shape = block.shape
        axis = int(np.argmax(shape))
        n = shape[axis]
        if n <= leaf or block.size <= leaf ** len(dims):
            return block.reshape(-1).tolist()
        mid = n // 2
        sl_lo = [slice(None)] * len(shape)
        sl_sep = [slice(None)] * len(shape)
        sl_hi = [slice(None)] * len(shape)
        sl_lo[axis] = slice(0, mid)
        sl_sep[axis] = slice(mid, mid + 1)
        sl_hi[axis] = slice(mid + 1, n)
        lo = rec(block[tuple(sl_lo)])
        hi = rec(block[tuple(sl_hi)])
        sep = block[tuple(sl_sep)].reshape(-1).tolist()
        return lo + hi + sep

    return np.asarray(rec(idx), dtype=np.int64)


def grid_graph_2d(nx: int, ny: int, stencil: int = 5,
                  radius: int = 1) -> sp.csr_matrix:
    """Structure of a 2-D grid graph (5-/9-point stencil, or a dense
    radius-r neighbourhood for DG-like strongly-coupled lattices)."""
    n = nx * ny
    ii: List[int] = []
    jj: List[int] = []
    if radius > 1:
        offs = [(dx, dy) for dx in range(-radius, radius + 1)
                for dy in range(-radius, radius + 1)
                if dx * dx + dy * dy <= radius * radius]
    elif stencil == 5:
        offs = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)]
    else:
        offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    X = X.ravel(); Y = Y.ravel()
    for dx, dy in offs:
        Xn, Yn = X + dx, Y + dy
        ok = (Xn >= 0) & (Xn < nx) & (Yn >= 0) & (Yn < ny)
        ii.append((X[ok] * ny + Y[ok]))
        jj.append((Xn[ok] * ny + Yn[ok]))
    i = np.concatenate(ii); j = np.concatenate(jj)
    return sp.csr_matrix((np.ones_like(i, dtype=np.int8), (i, j)), shape=(n, n))


def grid_graph_3d(nx: int, ny: int, nz: int, stencil: int = 27) -> sp.csr_matrix:
    n = nx * ny * nz
    if stencil == 7:
        offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1)]
    else:
        offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                for c in (-1, 0, 1)]
    X, Y, Z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    X = X.ravel(); Y = Y.ravel(); Z = Z.ravel()
    ii: List[np.ndarray] = []
    jj: List[np.ndarray] = []
    for dx, dy, dz in offs:
        Xn, Yn, Zn = X + dx, Y + dy, Z + dz
        ok = ((Xn >= 0) & (Xn < nx) & (Yn >= 0) & (Yn < ny)
              & (Zn >= 0) & (Zn < nz))
        ii.append(X[ok] * ny * nz + Y[ok] * nz + Z[ok])
        jj.append(Xn[ok] * ny * nz + Yn[ok] * nz + Zn[ok])
    i = np.concatenate(ii); j = np.concatenate(jj)
    return sp.csr_matrix((np.ones_like(i, dtype=np.int8), (i, j)), shape=(n, n))


def _permute(A: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """Symmetric permutation: B = A[perm][:, perm]."""
    return A[perm][:, perm].tocsr()


# -- paper-matrix stand-ins ----------------------------------------------

def dg_like_structure(atoms_x: int = 12, atoms_y: int = 12,
                      block: int = 8,
                      radius: int = 3) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Element graph of the DG_PNF14000 stand-in: 2-D lattice of atoms,
    each a dense basis block of ``block`` columns, radius-3 neighbour
    coupling (the adaptive-local-basis DG Hamiltonian is *relatively
    dense* — each element couples tens of neighbours)."""
    G = grid_graph_2d(atoms_x, atoms_y, radius=radius)
    perm = nested_dissection_grid((atoms_x, atoms_y))
    G = _permute(G, perm)
    sizes = np.full(atoms_x * atoms_y, block, dtype=np.int64)
    return G, sizes


def fem3d_like_structure(nx: int = 12, ny: int = 12, nz: int = 12,
                         block: int = 3) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Element graph of the audikw_1 stand-in: 3-D solid-mechanics mesh,
    27-point coupling, ``block`` dof per node (audikw_1 has 3 displacement
    dof)."""
    G = grid_graph_3d(nx, ny, nz, stencil=27)
    perm = nested_dissection_grid((nx, ny, nz))
    G = _permute(G, perm)
    sizes = np.full(nx * ny * nz, block, dtype=np.int64)
    return G, sizes


def dg_like_matrix(atoms_x: int = 12, atoms_y: int = 12,
                   block: int = 8) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Scalar (kron-expanded) pattern of the DG stand-in, for numerics."""
    G, sizes = dg_like_structure(atoms_x, atoms_y, block)
    A = sp.kron(G, np.ones((block, block), dtype=np.int8), format="csr")
    return A, sizes


def fem3d_like_matrix(nx: int = 12, ny: int = 12, nz: int = 12,
                      block: int = 3) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Scalar (kron-expanded) pattern of the FEM stand-in, for numerics."""
    G, sizes = fem3d_like_structure(nx, ny, nz, block)
    A = sp.kron(G, np.ones((block, block), dtype=np.int8), format="csr")
    return A, sizes


def laplacian_2d(nx: int, ny: int, nd_order: bool = True) -> sp.csr_matrix:
    """Numeric 2-D Laplacian (SPD), optionally ND-ordered — the small
    correctness workhorse for the LU/SelInv tests."""
    n = nx * ny
    S = grid_graph_2d(nx, ny, stencil=5)
    if nd_order:
        S = _permute(S, nested_dissection_grid((nx, ny)))
    A = S.astype(np.float64)
    A.setdiag(0.0)
    A.eliminate_zeros()
    A = -A
    deg = -np.asarray(A.sum(axis=1)).ravel()
    A = A + sp.diags(deg + 4.0)
    return A.tocsr()


def make_numeric(struct: sp.csr_matrix, seed: int = 0,
                 symmetric_values: bool = False) -> sp.csr_matrix:
    """Fill a structure with random values, strongly diagonally dominant
    (=> unpivoted LU is stable; mirrors SuperLU_DIST static pivoting)."""
    rng = np.random.default_rng(seed)
    A = struct.astype(np.float64).tocsr().copy()
    A.data = rng.uniform(-1.0, 1.0, size=A.nnz)
    if symmetric_values:
        A = (A + A.T) * 0.5
    rowsum = np.abs(A).sum(axis=1)
    A = A + sp.diags(np.asarray(rowsum).ravel() + 1.0)
    return A.tocsr()


# -- named suite -----------------------------------------------------------

@dataclass(frozen=True)
class MatrixSuite:
    name: str
    kind: str          # "dg_like" | "fem3d_like"
    params: tuple      # generator args
    description: str

    def build(self) -> Tuple[sp.csr_matrix, np.ndarray]:
        if self.kind == "dg_like":
            return dg_like_matrix(*self.params)
        if self.kind == "fem3d_like":
            return fem3d_like_matrix(*self.params)
        raise ValueError(self.kind)


#: Benchmark-scale stand-ins (structure only; sized so the discrete-event
#: simulator finishes in minutes on one CPU while preserving the papers'
#: dense-vs-sparse contrast).
PAPER_SUITE = {
    # relatively dense block structure, large supernodes, comm-volume bound
    "dg_small":   MatrixSuite("dg_small", "dg_like", (10, 10, 6),
                              "DG nanoflake-like, tiny (tests)"),
    "dg_bench":   MatrixSuite("dg_bench", "dg_like", (26, 26, 12),
                              "DG nanoflake-like, bench scale"),
    # sparser 3-D FEM: comm/compute ratio bound
    "fem_small":  MatrixSuite("fem_small", "fem3d_like", (6, 6, 6, 3),
                              "audikw-like, tiny (tests)"),
    "fem_bench":  MatrixSuite("fem_bench", "fem3d_like", (14, 14, 14, 3),
                              "audikw-like, bench scale"),
}
