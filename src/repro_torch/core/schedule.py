"""PSelInv communication schedule on a 2-D block-cyclic processor grid.

Derives, from a :class:`BlockStructure`, the exact set of restricted
collectives PSelInv issues (paper §2.2/§3, Fig. 2):

* ``diag-bcast``  (step a of loop 1): owner of L(K,K) → owners of blocks
  L(I,K) within the processor-*column* group of supernode K.
* ``xfer``        (step a, Fig. 2): point-to-point L̂(I,K) → owner of
  Û(K,I) (the symmetric-transpose handoff).
* ``col-bcast``   (paper "Col-Bcast"): owner of Û(K,I) → owners of
  A⁻¹(J,I), J ∈ struct(K) — a *subset* of a grid-column group.
* ``row-reduce``  (paper "Row-Reduce"): partial products A⁻¹(J,I)·L̂(I,K)
  reduced onto the owner of A⁻¹(J,K) — a *subset* of a grid-row group.

Block (I,J) is owned by grid processor (I mod Pr, J mod Pc) with rank
``row·Pc + col`` (SuperLU_DIST layout). Bytes assume float64.

This module is the *enumeration front-end* of the CommPlan IR
(`core/plan.py`): it decides **what** must be communicated;
:func:`~.plan.build_plan` lowers these events — once, for every consumer
— into concrete trees and executable rounds. Do not derive trees or
rounds anywhere else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from .symbolic import BlockStructure

__all__ = ["Grid2D", "CommEvent", "ComputeTask", "pselinv_events",
           "pselinv_supernode_program"]

BYTES_PER_ELT = 8.0


@dataclass(frozen=True)
class Grid2D:
    pr: int
    pc: int

    @property
    def size(self) -> int:
        return self.pr * self.pc

    def owner(self, I: int, J: int) -> int:
        return (I % self.pr) * self.pc + (J % self.pc)

    def rank_of(self, prow: int, pcol: int) -> int:
        return prow * self.pc + pcol

    def coords(self, rank: int) -> Tuple[int, int]:
        return rank // self.pc, rank % self.pc


@dataclass(frozen=True)
class CommEvent:
    """One restricted collective: broadcast from / reduction onto ``root``
    among ``participants`` (global ranks, root included), ``nbytes`` per
    edge message. ``tag`` seeds the shifted-tree rotation. ``supernode``
    links the event to its position in the elimination-tree pipeline."""
    kind: str                      # "diag-bcast" | "xfer" | "col-bcast" | "row-reduce"
    supernode: int
    root: int
    participants: Tuple[int, ...]  # sorted, root included
    nbytes: float
    tag: int
    # index of the supernode whose A⁻¹ data this event consumes (dependency)
    consumes: int = -1
    # supernode index of the block the event's payload carries (I for
    # xfer/col-bcast, J for row-reduce, K for diag-bcast) — the CommPlan
    # executor uses it to derive gather/scatter slots
    block: int = -1


@dataclass(frozen=True)
class ComputeTask:
    """Local dense work attributed to one rank at one supernode step."""
    kind: str          # "trsm" | "gemm" | "diag"
    supernode: int
    rank: int
    flops: float


def _col_group_rows(grid: Grid2D, rows: List[int], pcol: int) -> Tuple[int, ...]:
    return tuple(sorted({grid.rank_of(r % grid.pr, pcol) for r in rows}))


def pselinv_events(bs: BlockStructure, grid: Grid2D
                   ) -> Tuple[List[CommEvent], List[ComputeTask]]:
    """Materialize every restricted collective + compute task of one
    selected-inversion pass (both Alg. 1 loops)."""
    w = bs.widths()
    events: List[CommEvent] = []
    tasks: List[ComputeTask] = []
    nb = bs.nsuper

    for K in range(nb):
        C = [int(i) for i in bs.struct[K]]
        wk = int(w[K])
        kcol = K % grid.pc
        krow = K % grid.pr

        # ---- loop 1: diagonal-block broadcast + local TRSMs ------------
        if C:
            parts = _col_group_rows(grid, C + [K], kcol)
            root = grid.owner(K, K)
            if len(parts) > 1:
                events.append(CommEvent(
                    "diag-bcast", K, root, parts,
                    nbytes=wk * wk * BYTES_PER_ELT,
                    tag=(K << 1) | 0, consumes=-1, block=K))
            for I in C:
                tasks.append(ComputeTask(
                    "trsm", K, grid.owner(I, K),
                    flops=float(w[I]) * wk * wk))

        # ---- loop 2 ----------------------------------------------------
        # xfer: L̂(I,K) -> owner of Û(K,I)   (transpose handoff, p2p)
        for I in C:
            src = grid.owner(I, K)
            dst = grid.owner(K, I)
            if src != dst:
                events.append(CommEvent(
                    "xfer", K, src, tuple(sorted({src, dst})),
                    nbytes=float(w[I]) * wk * BYTES_PER_ELT,
                    tag=(K << 20) ^ I, consumes=-1, block=I))

        # col-bcast: Û(K,I) broadcast down grid-column (I mod Pc) to the
        # owners of A⁻¹(J,I) for J in C
        for I in C:
            root = grid.owner(K, I)
            parts = tuple(sorted(
                {root} | {grid.owner(J, I) for J in C}))
            if len(parts) > 1:
                events.append(CommEvent(
                    "col-bcast", K, root, parts,
                    nbytes=float(w[I]) * wk * BYTES_PER_ELT,
                    tag=(K << 20) ^ (I << 1), consumes=I, block=I))
            # local GEMM at each owner of A⁻¹(J,I): (wJ x wI) @ (wI x wK)
            for J in C:
                tasks.append(ComputeTask(
                    "gemm", K, grid.owner(J, I),
                    flops=2.0 * float(w[J]) * float(w[I]) * wk))

        # row-reduce: Σ_I A⁻¹(J,I)·L̂(I,K) onto owner of A⁻¹(J,K),
        # within grid-row (J mod Pr)
        for J in C:
            root = grid.owner(J, K)
            parts = tuple(sorted(
                {root} | {grid.owner(J, I) for I in C}))
            if len(parts) > 1:
                events.append(CommEvent(
                    "row-reduce", K, root, parts,
                    nbytes=float(w[J]) * wk * BYTES_PER_ELT,
                    tag=(K << 20) ^ (J << 1) ^ 1, consumes=-1, block=J))

        # step 4/5 local work on the diagonal/row owners
        csum = float(sum(w[i] for i in C))
        tasks.append(ComputeTask(
            "diag", K, grid.owner(K, K),
            flops=2.0 * wk * wk * max(csum, 1.0) + 2.0 * wk ** 3))

    return events, tasks


def pselinv_supernode_program(bs: BlockStructure, grid: Grid2D,
                              kind=None):
    """Ops/tasks grouped per supernode, in *reverse* elimination order
    (the selected-inversion sweep), with the etree dependency:
    supernode K may start once every I ∈ struct(K) has finished.
    Yields (K, deps, ops_K, tasks_K) — ops are the CommPlan IR's
    :class:`~.plan.PlanOp` (tree kind defaults to SHIFTED)."""
    from .plan import build_plan          # lazy: plan builds on this module
    from .trees import TreeKind
    plan = build_plan(bs, grid, kind or TreeKind.SHIFTED)
    by_sn_e = plan.ops_by_supernode()
    by_sn_t: dict[int, list] = {}
    for t in plan.tasks:
        by_sn_t.setdefault(t.supernode, []).append(t)
    for K in range(bs.nsuper - 1, -1, -1):
        deps = [int(i) for i in bs.struct[K]]
        yield K, deps, by_sn_e.get(K, []), by_sn_t.get(K, [])
