"""The benchmark's own matrix generators.

Frozen copy of ``nested_dissection_grid``, ``grid_graph_2d``,
``grid_graph_3d``, ``dg_like_matrix``, ``fem3d_like_matrix`` and
``make_numeric`` from ``src/repro_torch/core/sparse.py`` at commit
738e407, so that a later change to the port cannot move the inputs.

* ``fem3d_like``: the audikw_1 stand-in, a 3-D 27-point grid with
  ``block`` dof a node, ordered by geometric nested dissection.
* ``dg_like``: a DG stand-in, a 2-D lattice of dense element blocks
  with radius-3 coupling, ordered the same way. No configuration uses it
  yet: a DG_PNF14000 cell waits for a source that states its basis
  functions an element and nonzeros a row.

``make_numeric`` fills a structure with values from a seed, strongly
diagonally dominant, so unpivoted LU is stable.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["GENERATORS", "nested_dissection_grid", "grid_graph_2d",
           "grid_graph_3d", "dg_like_matrix", "fem3d_like_matrix",
           "make_numeric", "make_matrix"]


def nested_dissection_grid(dims: Sequence[int], leaf: int = 2) -> np.ndarray:
    """Geometric nested-dissection permutation of an n-D grid: split the
    longest axis with a one-plane separator, separators last. Returns
    ``perm`` with ``perm[new_index] = old_index``."""
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
    radius-r neighbourhood)."""
    n = nx * ny
    ii: List[np.ndarray] = []
    jj: List[np.ndarray] = []
    if radius > 1:
        offs = [(dx, dy) for dx in range(-radius, radius + 1)
                for dy in range(-radius, radius + 1)
                if dx * dx + dy * dy <= radius * radius]
    elif stencil == 5:
        offs = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)]
    else:
        offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    X = X.ravel()
    Y = Y.ravel()
    for dx, dy in offs:
        Xn, Yn = X + dx, Y + dy
        ok = (Xn >= 0) & (Xn < nx) & (Yn >= 0) & (Yn < ny)
        ii.append(X[ok] * ny + Y[ok])
        jj.append(Xn[ok] * ny + Yn[ok])
    i = np.concatenate(ii)
    j = np.concatenate(jj)
    return sp.csr_matrix((np.ones_like(i, dtype=np.int8), (i, j)),
                         shape=(n, n))


def grid_graph_3d(nx: int, ny: int, nz: int,
                  stencil: int = 27) -> sp.csr_matrix:
    """Structure of a 3-D grid graph (7- or 27-point stencil)."""
    n = nx * ny * nz
    if stencil == 7:
        offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1)]
    else:
        offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                for c in (-1, 0, 1)]
    X, Y, Z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    X = X.ravel()
    Y = Y.ravel()
    Z = Z.ravel()
    ii: List[np.ndarray] = []
    jj: List[np.ndarray] = []
    for dx, dy, dz in offs:
        Xn, Yn, Zn = X + dx, Y + dy, Z + dz
        ok = ((Xn >= 0) & (Xn < nx) & (Yn >= 0) & (Yn < ny)
              & (Zn >= 0) & (Zn < nz))
        ii.append(X[ok] * ny * nz + Y[ok] * nz + Z[ok])
        jj.append(Xn[ok] * ny * nz + Yn[ok] * nz + Zn[ok])
    i = np.concatenate(ii)
    j = np.concatenate(jj)
    return sp.csr_matrix((np.ones_like(i, dtype=np.int8), (i, j)),
                         shape=(n, n))


def _permute(A: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """Symmetric permutation: B = A[perm][:, perm]."""
    return A[perm][:, perm].tocsr()


def dg_like_matrix(atoms_x: int, atoms_y: int,
                   block: int) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Scalar pattern of the DG stand-in: a 2-D lattice of atoms, each a
    dense basis block of ``block`` columns, radius-3 coupling."""
    G = grid_graph_2d(atoms_x, atoms_y, radius=3)
    G = _permute(G, nested_dissection_grid((atoms_x, atoms_y)))
    sizes = np.full(atoms_x * atoms_y, block, dtype=np.int64)
    A = sp.kron(G, np.ones((block, block), dtype=np.int8), format="csr")
    return A, sizes


def fem3d_like_matrix(nx: int, ny: int, nz: int,
                      block: int) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Scalar pattern of the FEM stand-in: a 3-D 27-point mesh with
    ``block`` dof a node."""
    G = grid_graph_3d(nx, ny, nz, stencil=27)
    G = _permute(G, nested_dissection_grid((nx, ny, nz)))
    sizes = np.full(nx * ny * nz, block, dtype=np.int64)
    A = sp.kron(G, np.ones((block, block), dtype=np.int8), format="csr")
    return A, sizes


def make_numeric(struct: sp.csr_matrix, seed: int = 0,
                 symmetric_values: bool = False) -> sp.csr_matrix:
    """Fill a structure with random values from ``seed``, strongly
    diagonally dominant (unpivoted LU is stable)."""
    rng = np.random.default_rng(seed)
    A = struct.astype(np.float64).tocsr().copy()
    A.data = rng.uniform(-1.0, 1.0, size=A.nnz)
    if symmetric_values:
        A = (A + A.T) * 0.5
    rowsum = np.abs(A).sum(axis=1)
    A = A + sp.diags(np.asarray(rowsum).ravel() + 1.0)
    return A.tocsr()


GENERATORS = {"fem3d_like": fem3d_like_matrix, "dg_like": dg_like_matrix}


def make_matrix(generator: str, params: dict, seed) -> sp.csr_matrix:
    """The matrix a configuration names, with symmetric values from
    ``seed``: the port inverts A = L D Lᵀ."""
    if generator not in GENERATORS:
        raise ValueError(f"unknown generator {generator!r}; the benchmark "
                         f"has {sorted(GENERATORS)}")
    pattern = GENERATORS[generator](**params)[0]
    return make_numeric(pattern, seed=seed, symmetric_values=True)
