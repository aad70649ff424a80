"""The plain reference and the comparison that decides ``correct``.

The reference is the dense inverse of the same A, in f64, by
``torch.linalg.inv``; its selected blocks are picked by the benchmark's
own structure analysis (:mod:`.structure`). It imports nothing of the
port and takes nothing that the port made.

The port returns A⁻¹ in its shard layout, (…, pr·pc, nb/pr, nb/pc, b, b),
cyclic over both grid dimensions: block (I, J) of the padded block grid
lies in shard (I mod pr)·pc + (J mod pc) at (I div pr, J div pc). That is
the port's output format (``_shard_blocks`` in
``src/repro_torch/core/pselinv_dist.py`` at commit 738e407);
:func:`selected_from_shards` reads the selected blocks out of it only to
judge them.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .structure import Structure, selected_pairs

__all__ = ["dense_inverse_blocks", "selected_from_shards", "worst_gap"]


def dense_inverse_blocks(A, st: Structure, device) -> torch.Tensor:
    """The selected blocks of A⁻¹, (nsel, b, b) f64 on ``device``, in
    :func:`~.structure.selected_pairs` order, from the dense inverse."""
    A = sp.coo_matrix(A)
    n, b = A.shape[0], st.b
    dense = torch.zeros((n, n), dtype=torch.float64, device=device)
    rows = torch.as_tensor(A.row.astype(np.int64), device=device)
    cols = torch.as_tensor(A.col.astype(np.int64), device=device)
    dense.index_put_((rows, cols),
                     torch.as_tensor(A.data, dtype=torch.float64,
                                     device=device), accumulate=True)
    del rows, cols
    inv = torch.linalg.inv(dense)
    del dense
    nb0 = n // b
    rs, cs = (torch.as_tensor(x, device=device) for x in selected_pairs(st))
    out = inv.view(nb0, b, nb0, b).permute(0, 2, 1, 3)[rs, cs].clone()
    del inv
    return out


def selected_from_shards(out: torch.Tensor, st: Structure,
                         grid: Tuple[int, int]) -> torch.Tensor:
    """The selected blocks of one lane's A⁻¹ shards ``out`` (pr·pc, nbr,
    nbc, b, b), in :func:`~.structure.selected_pairs` order, as f64."""
    pr, pc = grid
    rs, cs = (torch.as_tensor(x, device=out.device)
              for x in selected_pairs(st))
    return out[(rs % pr) * pc + cs % pc, rs // pr, cs // pc].double()


def worst_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| over the selected blocks, as a share of
    max |ref|; infinite where ``got`` is not finite."""
    gap = (got - ref).abs().max().item()
    if not math.isfinite(gap):
        return math.inf
    return gap / ref.abs().max().item()
