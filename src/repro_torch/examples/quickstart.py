"""Quickstart: selected inversion end to end + the paper's three
communication trees on a real sparse structure — the twin of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..core import sparse
from ..core.schedule import Grid2D
from ..core.selinv import compare_with_oracle, selected_inverse
from ..core.simulator import volume_stats, volumes_fast
from ..core.symbolic import symbolic_factorize_elements
from ..core.trees import TreeKind, binary_tree, shifted_binary_tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. numeric selected inversion on a 2-D Laplacian, through the
    #    hand-written GEMM and trsm kernels (their plain versions on
    #    the CPU)
    A = sparse.laplacian_2d(12, 12)
    Ainv, bs = selected_inverse(A, max_supernode=8, backend="cuda",
                                device=args.device)
    err = compare_with_oracle(Ainv, bs, A)
    print(f"selected inversion on {args.device}: N={A.shape[0]} "
          f"supernodes={bs.nsuper} max|err| vs dense inverse = {err:.2e}")

    # 2. the paper's trees (Fig. 3): root 4, receivers 1,2,3,5,6
    t = binary_tree(4, [1, 2, 3, 5, 6])
    print("binary tree children:", t.children_map())
    t = shifted_binary_tree(4, [1, 2, 3, 5, 6], shift=4)
    print("shifted tree children:", t.children_map())

    # 3. communication-volume balance on a PSelInv schedule (Table 1)
    G, sizes = sparse.fem3d_like_structure(12, 12, 12, 3)
    bs = symbolic_factorize_elements(G, sizes, max_supernode=12)
    grid = Grid2D(16, 16)
    for kind in (TreeKind.FLAT, TreeKind.BINARY, TreeKind.SHIFTED):
        s = volume_stats(volumes_fast(bs, grid, kind)["col-bcast"] / 1e6)
        print(f"{kind.value:8s} col-bcast MB/rank: "
              f"min={s['min']:.2f} max={s['max']:.2f} std={s['std']:.2f}")


if __name__ == "__main__":
    main()
