"""Distributed PSelInv on one card — the port of
``repro/core/pselinv_dist.py``'s main path to PyTorch.

The JAX package runs the selected-inversion sweep as one SPMD program
under ``shard_map`` over ``P = pr·pc`` devices. Here every rank is a
*virtual* rank on one device: the per-rank state is one leading ``P``
axis of a single tensor, and a batch of same-structure matrices is one
more axis in front of it (``(B, P, …)``).

  host plan   ``build_program``   CommPlan → overlapped round schedule
                                  → PlanLint (copies of the JAX host code)
  upload      ``upload_tables``   the schedule's per-rank index tables,
                                  bounds-checked once, on the device
  device      ``make_sweep_overlapped``  table-driven gather / permute /
                                  scatter over a flat ``(B, P, arena, b, b)``
                                  block arena, and the masked level GEMM
                                  in the hand-written block-GEMM kernel

What the SPMD primitives become:

* ``jnp.take(table, axis_index)`` — the whole ``(P, …)`` table, applied
  by advanced indexing; per-rank arena addresses are pre-flattened to
  ``rank·arena_blocks + slot`` so one ``index_select`` serves all ranks.
* ``lax.ppermute(payload, perm)`` — ``moved[:, dst] = payload[:, src]``
  over the rank axis; ranks that receive nothing get zeros, as in JAX.
* ``vmap`` over the batch — the leading ``B`` axis, tables shared.
* ``mode="promise_in_bounds"`` — every table is checked against its
  target's extent once, in :func:`upload_tables`; the sweep then indexes
  freely.
* ``.at[…].set`` with duplicate indices — correct only because duplicates
  land in the trash block; :func:`upload_tables` asserts that, per rank
  and per round, every repeated scatter index is the trash slot.
* ``.at[…].add`` — ``index_add_``; the duplicate entries add exact zeros.

Symmetric matrices (as the paper's implementation): Û(K,I) = L̂(I,K)ᵀ and
A⁻¹(K,J) = A⁻¹(J,K)ᵀ — both identities hold blockwise for unpivoted LU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import pselinv_round_gemm
from ..obs.trace import TRACER
from .plan import (CommPlan, ExecPlan, OverlappedExec, PlanOptions,
                   build_plan, compile_exec, schedule_overlapped,
                   schedule_stream)
from .schedule import Grid2D
from .selinv import normalize_factors
from .stream import StreamTables
from .supernodal_lu import factorize
from .symbolic import BlockStructure, symbolic_factorize
from .trees import TreeKind

__all__ = ["PSelInvProgram", "build_program", "SweepTables",
           "upload_tables", "make_sweep_overlapped",
           "validate_uniform_widths", "pad_nb", "analyze_structure",
           "check_values_pattern", "prepare_values", "prepare_values_many",
           "gather_blocks"]


@dataclass
class PSelInvProgram:
    """A compiled sweep: grid geometry, the CommPlan and its executable
    tables (the overlapped round stream on the main path)."""
    nb: int
    b: int
    pr: int
    pc: int
    kind: TreeKind
    bs: BlockStructure
    plan: Optional[CommPlan] = None
    exec_plan: Optional[ExecPlan] = None
    overlap_plan: Optional[OverlappedExec] = None
    stream_tables: Optional[StreamTables] = None

    @property
    def nbr(self) -> int:
        return self.nb // self.pr

    @property
    def nbc(self) -> int:
        return self.nb // self.pc


# ---------------------------------------------------------------------------
# host plan: CommPlan -> schedule -> PlanLint
# ---------------------------------------------------------------------------

def build_program(bs: BlockStructure, nb: int, b: int, pr: int, pc: int,
                  kind: TreeKind = TreeKind.SHIFTED,
                  overlap: bool = False,
                  coalesce_max: int = 8,
                  window: int | None = None,
                  stream: bool = False, *,
                  options: PlanOptions | None = None,
                  verify: str = "error",
                  verify_compiled: str = "off") -> PSelInvProgram:
    """Build the CommPlan IR and compile it to executable tables — the
    host code of ``repro/core/pselinv_dist.py:build_program``, same
    arguments, same tables. ``options`` overrides the loose kwargs.

    ``verify`` runs PlanLint (``core/verify.py``) over every artifact
    just compiled (``"error"`` raises, ``"warn"`` warns, ``"off"``
    skips). ``verify_compiled`` must be ``"off"``: the compiled-artifact
    pass (HloLint) checks XLA programs and has no counterpart here yet."""
    if options is not None:
        kind, overlap = options.kind, options.overlap
        coalesce_max, window = options.coalesce_max, options.window
        stream = options.stream
        verify = options.verify
        verify_compiled = options.verify_compiled
    if verify_compiled != "off":
        raise NotImplementedError(
            f"verify_compiled={verify_compiled!r}: the compiled-program "
            "lint (HloLint) is not ported; use verify_compiled='off'")
    if stream and not overlap:
        raise ValueError(
            "stream=True lowers the overlapped round stream — it "
            "requires overlap=True")
    if nb % pr or nb % pc:
        raise ValueError(f"nb={nb} not divisible by grid {pr}x{pc}")
    with TRACER.span("plan.build", nb=nb):
        plan = build_plan(bs, Grid2D(pr, pc), kind, nb=nb)
    ov = st = None
    with TRACER.span("plan.schedule", stream=stream, overlap=overlap):
        if stream:
            ov, st = schedule_stream(plan, coalesce_max=coalesce_max,
                                     window=window, options=options)
        elif overlap:
            ov = schedule_overlapped(plan, coalesce_max=coalesce_max,
                                     window=window, options=options)
        prog = PSelInvProgram(
            nb=nb, b=b, pr=pr, pc=pc, kind=kind, bs=bs, plan=plan,
            exec_plan=None if overlap else compile_exec(plan),
            overlap_plan=ov, stream_tables=st)
    if verify != "off":
        from .verify import enforce_verification, verify_program
        with TRACER.span("plan.verify", mode=verify):
            enforce_verification(
                verify_program(prog), mode=verify,
                where=f"build_program(nb={nb}, grid={pr}x{pc}, "
                      f"stream={stream}, overlap={overlap})")
    return prog


# ---------------------------------------------------------------------------
# device tables: uploaded once per session, bounds-checked once
# ---------------------------------------------------------------------------

@dataclass
class LevelTables:
    """One elimination-tree level's compute tables for all P ranks.
    ``ut`` holds flattened arena addresses ``rank·arena_blocks + slot``
    of the level's Û lanes; the masks are bool, applied by selects."""
    nk: int
    base_p: int
    base_s: int
    ut: torch.Tensor          # (P·nk·nbc,) flat arena addresses
    cm: torch.Tensor          # (P, nk, nbc) struct mask
    kcs: torch.Tensor         # (nk,) K // pc
    w: torch.Tensor           # (P, nbr, nk) column-write mask
    krs: torch.Tensor         # (nk,) K // pr
    rm: torch.Tensor          # (P, nk) diagonal row mask
    dslot: torch.Tensor       # (nk,) flat A⁻¹ slot of (K, K)
    dslot_c: torch.Tensor     # (nk,) the same, clamped below n_ainv
    droot: torch.Tensor       # (P, nk) this rank owns (K, K)


@dataclass
class LaneTables:
    """One set of lanes of a round (the owner-local moves, or the
    permute) for all P ranks, flattened to ``P·width`` lanes: gather
    addresses into the arena (``ga``) and the input L̂ shard (``gl``),
    each masked in bounds where the other buffer is taken; the L̂
    select ``lh``; the scatter addresses ``sc``; the receiver-transpose
    and accumulate masks ``tm``/``am``; and for the permute the
    (src, dst) rank pairs."""
    width: int
    ga: torch.Tensor
    gl: torch.Tensor
    lh: torch.Tensor
    mixed: bool
    sc: torch.Tensor
    tm: torch.Tensor
    any_t: bool
    am: Optional[torch.Tensor] = None
    src: Optional[torch.Tensor] = None
    dst: Optional[torch.Tensor] = None


@dataclass
class SweepTables:
    """Every table the overlapped sweep reads, on one device."""
    device: torch.device
    P: int
    N: int
    arena_blocks: int
    dset_slot: torch.Tensor   # (m,) structless-supernode diagonal slots
    dset_m: torch.Tensor      # (P, m) this rank owns it
    levels: List[LevelTables]
    local: List[Optional[LaneTables]]
    comm: List[Optional[LaneTables]]
    compute_at: List[List[Tuple[str, int]]]
    nbytes: int = 0


def _in_bounds(name: str, a: np.ndarray, hi: int) -> None:
    """The one-time bounds check that replaces ``promise_in_bounds``."""
    a = np.asarray(a)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
        raise ValueError(f"table {name} indexes outside [0, {hi}): "
                         f"range [{int(a.min())}, {int(a.max())}]")


def _dupes_are_trash(name: str, t: int, scatter: np.ndarray,
                     trash: int) -> None:
    """Per rank, every scatter index that repeats within one round must
    be the trash slot: an overwrite scatter with two writers to one real
    slot has no defined winner on the card."""
    for p, row in enumerate(np.asarray(scatter)):
        vals, counts = np.unique(row, return_counts=True)
        bad = vals[(counts > 1) & (vals != trash)]
        if bad.size:
            raise ValueError(
                f"round {t}: rank {p} scatters {name} lanes twice into "
                f"arena slots {bad.tolist()} — only the trash slot "
                f"{trash} may repeat")


def _lanes(t: int, name: str, g, s, tmask, glh, addm, perm, A: int,
           N: int, trash: int, P: int, dev) -> LaneTables:
    g = np.asarray(g, np.int64)
    s = np.asarray(s, np.int64)
    glh = np.asarray(glh, bool)
    width = g.shape[1]
    # arena gathers stay below the arena, L̂ gathers below the shard
    _in_bounds(f"{name}.gather[arena]", np.where(glh, 0, g), A)
    _in_bounds(f"{name}.gather[lh]", np.where(glh, g, 0), N)
    _in_bounds(f"{name}.scatter", s, A)
    _dupes_are_trash(name, t, s, trash)
    rank = np.arange(P, dtype=np.int64)[:, None]

    def up(x, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(x).reshape(-1),
                               dtype=dtype, device=dev)

    lt = LaneTables(
        width=width,
        ga=up(rank * A + np.where(glh, 0, g)),
        gl=up(rank * N + np.where(glh, g, 0)),
        lh=up(glh, torch.bool), mixed=bool(glh.any()),
        sc=up(rank * A + s),
        tm=up(tmask, torch.bool), any_t=bool(np.asarray(tmask).any()))
    if perm is not None:
        src = np.array([p[0] for p in perm], np.int64)
        dst = np.array([p[1] for p in perm], np.int64)
        _in_bounds(f"{name}.perm", np.concatenate([src, dst]), P)
        if len(set(dst.tolist())) != len(dst):
            raise ValueError(f"round {t}: a rank receives twice")
        lt.am = up(np.asarray(addm) != 0, torch.bool)
        lt.src, lt.dst = up(src), up(dst)
    return lt


def upload_tables(prog: PSelInvProgram, device) -> SweepTables:
    """Lower the overlapped schedule's per-rank tables to device tensors
    — once per session. Checks every index against the extent it
    addresses and that duplicate scatter indices are trash only, so the
    sweep can index without further checks."""
    ov = prog.overlap_plan
    if ov is None:
        raise ValueError("build_program(..., overlap=True) first")
    dev = torch.device(device)
    P, N, A, trash = ov.pr * ov.pc, ov.n_ainv, ov.arena_blocks, ov.trash
    nbr, nbc, pc = ov.nbr, ov.nbc, ov.pc
    rank = np.arange(P)
    r_of, c_of = rank // pc, rank % pc

    def up(x, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    _in_bounds("diag_set_slot", ov.diag_set_slot, N)
    levels = []
    for li, lv in enumerate(ov.levels):
        nk = len(lv.Ks)
        _in_bounds(f"level {li} u_gather", lv.u_gather, A)
        _in_bounds(f"level {li} kcs", lv.kcs, nbc)
        _in_bounds(f"level {li} krs", lv.krs, nbr)
        _in_bounds(f"level {li} diag_slot", lv.diag_slot, A)
        _in_bounds(f"level {li} partial", [lv.base_p, lv.base_p
                                           + nk * nbr - 1], A)
        _in_bounds(f"level {li} S", [lv.base_s, lv.base_s + nk - 1], A)
        w = (np.asarray(lv.col_write_row)[r_of]
             * np.asarray(lv.col_write_col)[c_of][:, :, None])
        levels.append(LevelTables(
            nk=nk, base_p=int(lv.base_p), base_s=int(lv.base_s),
            ut=up((rank[:, None] * A
                   + np.asarray(lv.u_gather, np.int64)).reshape(-1)),
            cm=up(np.asarray(lv.cmask)[c_of] != 0, torch.bool),
            kcs=up(lv.kcs), w=up(w.transpose(0, 2, 1) != 0, torch.bool),
            krs=up(lv.krs),
            rm=up(np.asarray(lv.diag_rowmask)[r_of] != 0, torch.bool),
            dslot=up(lv.diag_slot),
            dslot_c=up(np.minimum(lv.diag_slot, N - 1)),
            droot=up(np.asarray(lv.diag_root)[None, :] == rank[:, None],
                     torch.bool)))
    local: List[Optional[LaneTables]] = []
    comm: List[Optional[LaneTables]] = []
    for t, rnd in enumerate(ov.rounds):
        local.append(_lanes(t, "local", rnd.lgather, rnd.lscatter,
                            rnd.ltmask, rnd.lglh, None, None, A, N,
                            trash, P, dev) if rnd.lwidth else None)
        comm.append(_lanes(t, "permute", rnd.gather, rnd.scatter,
                           rnd.tmask, rnd.glh, rnd.addm, rnd.perm, A, N,
                           trash, P, dev) if rnd.perm else None)
    tabs = SweepTables(
        device=dev, P=P, N=N, arena_blocks=A,
        dset_slot=up(ov.diag_set_slot),
        dset_m=up(np.asarray(ov.diag_set_root)[None, :] == rank[:, None],
                  torch.bool),
        levels=levels, local=local, comm=comm,
        compute_at=[[(op.kind, op.level) for op in ops]
                    for ops in ov.compute_at])
    seen = set()
    for obj in [tabs, *levels, *[x for x in local + comm if x is not None]]:
        for v in vars(obj).values():
            if isinstance(v, torch.Tensor) and id(v) not in seen:
                seen.add(id(v))
                tabs.nbytes += v.numel() * v.element_size()
    return tabs


# ---------------------------------------------------------------------------
# the overlapped sweep on a (B, P, arena, b, b) block arena
# ---------------------------------------------------------------------------

# The four arena compute phases — ports of ``repro/core/pselinv_dist.py``
# ``_phase_gemm/_write/_scomp/_diagw`` (:395-447). ``arena`` is the
# (B, P, A, b, b) tensor, ``flat`` its (B, P·A, b, b) view. Writes go into
# the arena in place (slice assignment and ``index_add_`` where JAX used
# ``dynamic_update_slice`` and ``.at[].add``): the arena is private to one
# sweep call, so nothing else observes the update.

def _phase_gemm(arena, flat, lv: LevelTables, N, nbr, nbc, b):
    """Level GEMM: partial[k, i] = Σ_j A⁻¹[i, j] · Û_m[k, j]ᵀ, written by
    the kernel straight into the shared partial region."""
    B, P = arena.shape[:2]
    U = flat.index_select(1, lv.ut).view(B, P, lv.nk, nbc, b, b)
    Ainv = arena[:, :, :N].view(B, P, nbr, nbc, b, b)
    out = arena[:, :, lv.base_p:lv.base_p + lv.nk * nbr].view(
        B, P, lv.nk, nbr, b, b)
    pselinv_round_gemm(Ainv, U, lv.cm, out=out)


def _phase_write(arena, lv: LevelTables, N, nbr, nbc, b):
    """A⁻¹(C, K) column write for every K of the level: masked delta +
    scatter-add — same-level K's write disjoint (rank, slot) pairs, so
    duplicate ``kcs`` entries add zeros."""
    B, P = arena.shape[:2]
    partial = arena[:, :, lv.base_p:lv.base_p + lv.nk * nbr].view(
        B, P, lv.nk, nbr, b, b)
    Ainv = arena[:, :, :N].view(B, P, nbr, nbc, b, b)
    old = Ainv.index_select(3, lv.kcs)                 # (B, P, nbr, nk, b, b)
    new = -partial.transpose(2, 3)
    delta = torch.where(lv.w[None, :, :, :, None, None], new - old, 0.0)
    Ainv.index_add_(3, lv.kcs, delta)


def _phase_scomp(arena, flat, lv: LevelTables, N, nbr, nbc, b):
    """Diagonal partial sum S(K) = Σ_I A⁻¹(K, I) · L̂(I, K) into the shared
    S region (masked to row K%pr). The einsum runs once per batch item so
    every item sees the same shapes — and the same summation order — at
    any batch size."""
    B, P = arena.shape[:2]
    cm = lv.cm[None, :, :, :, None, None]
    Uh_m = torch.where(
        cm, flat.index_select(1, lv.ut).view(B, P, lv.nk, nbc, b, b), 0.0)
    Ainv = arena[:, :, :N].view(B, P, nbr, nbc, b, b)
    Arow = torch.where(cm, Ainv.index_select(2, lv.krs), 0.0)
    S = torch.stack([torch.einsum("pkjab,pkjcb->pkac", Arow[i], Uh_m[i])
                     for i in range(B)])
    arena[:, :, lv.base_s:lv.base_s + lv.nk] = torch.where(
        lv.rm[None, :, :, None, None], S, 0.0)


def _phase_diagw(arena, Dinv, lv: LevelTables):
    """Diagonal write A⁻¹(K,K) = D⁻¹ − Sᵀ at the owner."""
    S = arena[:, :, lv.base_s:lv.base_s + lv.nk]
    newd = Dinv.index_select(2, lv.dslot_c) - S.transpose(-1, -2)
    cur = arena.index_select(2, lv.dslot)
    arena.index_add_(2, lv.dslot, torch.where(
        lv.droot[None, :, :, None, None], newd - cur, 0.0))


def _gather_lanes(flat, lh_flat, ln: LaneTables):
    """Per-lane select between the arena and the resident input L̂ shard
    (no arena copy of L̂ exists); both gathers are masked in bounds at
    upload, and ``mixed`` skips the L̂ gather where no lane takes it."""
    blks = flat.index_select(1, ln.ga)
    if not ln.mixed:
        return blks
    blks_l = lh_flat.index_select(1, ln.gl)
    return torch.where(ln.lh[None, :, None, None], blks_l, blks)


def _transpose_lanes(blks, ln: LaneTables):
    if not ln.any_t:
        return blks
    return torch.where(ln.tm[None, :, None, None],
                       blks.transpose(-1, -2), blks)


def _compute(tabs: SweepTables, kind: str, li: int, arena, flat, Dinv,
             nbr, nbc, b):
    lv = tabs.levels[li]
    if kind == "gemm":
        _phase_gemm(arena, flat, lv, tabs.N, nbr, nbc, b)
    elif kind == "write":
        _phase_write(arena, lv, tabs.N, nbr, nbc, b)
    elif kind == "scomp":
        _phase_scomp(arena, flat, lv, tabs.N, nbr, nbc, b)
    else:                       # "diagw"
        _phase_diagw(arena, Dinv, lv)


def _round(tabs: SweepTables, t: int, arena, flat, lh_flat, Dinv,
           nbr, nbc, b):
    """One executed round: the boundary's pinned compute ops, the
    owner-local lane moves, then round ``t``'s coalesced multi-lane
    permute with per-lane gather/scatter/accumulate/transpose tables."""
    for kind, li in tabs.compute_at[t]:
        _compute(tabs, kind, li, arena, flat, Dinv, nbr, nbc, b)
    ln = tabs.local[t]
    if ln is not None:
        blks = _transpose_lanes(_gather_lanes(flat, lh_flat, ln), ln)
        # non-participating lanes land in the trash block
        flat.index_copy_(1, ln.sc, blks)
    ln = tabs.comm[t]
    if ln is not None:
        B, P = arena.shape[:2]
        payload = _gather_lanes(flat, lh_flat, ln).view(
            B, P, ln.width, b, b)
        moved = torch.zeros_like(payload)
        moved.index_copy_(1, ln.dst, payload.index_select(1, ln.src))
        moved = _transpose_lanes(moved.view(B, P * ln.width, b, b), ln)
        cur = flat.index_select(1, ln.sc)
        flat.index_copy_(1, ln.sc, torch.where(
            ln.am[None, :, None, None], moved + cur, moved))


def make_sweep_overlapped(prog: PSelInvProgram, tables: SweepTables,
                          batched: bool = False):
    """The cross-level overlapped sweep over ``tables`` (from
    :func:`upload_tables`). The returned ``sweep(Lh, Dinv)`` takes the
    value shards ``(P, nbr, nbc, b, b)`` — or ``(B, P, nbr, nbc, b, b)``
    with ``batched=True`` — on the tables' device and returns the A⁻¹
    shards in the same layout. No table moves and no value is read back
    to the host inside the sweep."""
    ov = prog.overlap_plan
    b = prog.b
    P, N, A = tables.P, tables.N, tables.arena_blocks
    nbr, nbc = ov.nbr, ov.nbc
    shape = (P, nbr, nbc, b, b)

    def sweep(Lh: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
        if not batched:
            Lh, Dinv = Lh[None], Dinv[None]
        if Lh.shape[1:] != shape or Dinv.shape != Lh.shape:
            raise ValueError(f"value shards must be (B, *{shape}), got "
                             f"{tuple(Lh.shape)} and {tuple(Dinv.shape)}")
        if Lh.device != tables.device or Dinv.device != tables.device:
            raise ValueError(f"values on {Lh.device}, tables on "
                             f"{tables.device}")
        if (Lh.dtype == torch.float32 and Lh.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            # the scomp einsum goes to cuBLAS: TF32 would keep ~3 digits
            raise RuntimeError(
                "a float32 sweep needs full-precision matmuls: set "
                "torch.backends.cuda.matmul.allow_tf32 = False (the "
                "PyTorch default)")
        B = Lh.shape[0]
        lh_flat = Lh.reshape(B, P * N, b, b)
        Dinv_f = Dinv.reshape(B, P, N, b, b)
        # fresh arena + structless-supernode diagonal seeds (leaves
        # without fill + grid padding get A⁻¹(K,K) = D⁻¹ up front)
        arena = torch.zeros((B, P, A, b, b), dtype=Lh.dtype,
                            device=Lh.device)
        flat = arena.view(B, P * A, b, b)
        if tables.dset_slot.numel():
            arena.index_add_(2, tables.dset_slot, torch.where(
                tables.dset_m[None, :, :, None, None],
                Dinv_f.index_select(2, tables.dset_slot), 0.0))
        for t in range(len(tables.comm)):
            _round(tables, t, arena, flat, lh_flat, Dinv_f, nbr, nbc, b)
        for kind, li in tables.compute_at[len(tables.comm)]:
            _compute(tables, kind, li, arena, flat, Dinv_f, nbr, nbc, b)
        out = arena[:, :, :N].reshape(B, *shape).clone(
            memory_format=torch.contiguous_format)
        return out if batched else out[0]

    return sweep


# ---------------------------------------------------------------------------
# host-side data preparation / gather
# ---------------------------------------------------------------------------

def validate_uniform_widths(bs: BlockStructure, b: int) -> None:
    """The dense-blocked layout requires every supernode at width b —
    one check shared by every structure entry point (matrix or ready
    :class:`BlockStructure`)."""
    if not np.all(bs.widths() == b):
        raise ValueError(
            f"structure has non-uniform supernode widths "
            f"{sorted(set(bs.widths().tolist()))} — the dense-blocked "
            f"layout requires every supernode to have width exactly "
            f"b={b}")


def pad_nb(nsuper: int, pr: int, pc: int) -> int:
    """Pad the supernode count so both grid dims divide it (the one
    padding rule — engine cache keys depend on it being identical for
    every entry point)."""
    nb = nsuper
    while nb % pr or nb % pc:
        nb += 1
    return nb


def analyze_structure(A, b: int, pr: int, pc: int
                      ) -> Tuple[BlockStructure, int]:
    """The value-independent half of :func:`prepare_inputs`: symbolic
    factorization + uniform-width validation + grid padding. Everything
    the engine caches hangs off this (bs, nb) pair."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    # real input validation, not asserts: these guard user-provided
    # matrices and must survive ``python -O``
    if n % b:
        raise ValueError(
            f"matrix size n={n} is not a multiple of the supernode block "
            f"size b={b} — pad the matrix (or pick b dividing n)")
    bs = symbolic_factorize(A, max_supernode=b)
    validate_uniform_widths(bs, b)
    return bs, pad_nb(bs.nsuper, pr, pc)


def check_values_pattern(A, bs: BlockStructure, b: int):
    """Validate one matrix's *pattern* against an analyzed structure.

    The structured factorization only ever visits blocks in
    ``bs.struct``, so a matrix whose pattern escapes the analyzed
    structure would be silently truncated into the selected inverse of a
    *different* matrix — reject it instead (O(nnz) block-coordinate
    check against the symmetric filled pattern). Returns the matrix as
    CSR. Shared by :func:`prepare_values`, the batched
    :func:`prepare_values_many`, and the serving layer's per-request
    admission check (``repro.serve``) — a bad request must be rejectable
    *before* it joins a batch, so its neighbors still solve."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n != int(bs.offsets[-1]):
        raise ValueError(
            f"matrix size n={n} does not match the analyzed structure "
            f"(expected n={int(bs.offsets[-1])}) — re-run analyze for a "
            "different-sized matrix")
    nb0 = bs.nsuper
    present = np.zeros((nb0, nb0), dtype=bool)
    np.fill_diagonal(present, True)
    for K in range(nb0):
        present[np.asarray(bs.struct[K], dtype=np.int64), K] = True
    coo = A.tocoo()
    hi = np.maximum(coo.row // b, coo.col // b)
    lo = np.minimum(coo.row // b, coo.col // b)
    bad = (coo.data != 0) & ~present[hi, lo]
    if bad.any():
        blocks = sorted({(int(i), int(j))
                         for i, j in zip(hi[bad], lo[bad])})[:8]
        raise ValueError(
            f"matrix has {int(bad.sum())} nonzero(s) outside the "
            f"analyzed block structure (e.g. blocks {blocks}) — its "
            "sparsity pattern differs from the analyzed matrix; re-run "
            "analyze for this structure")
    return A


def _shard_blocks(G: np.ndarray, nb: int, b: int, pr: int,
                  pc: int) -> np.ndarray:
    """Dense (…, nb, nb, b, b) block grid → (…, pr*pc, nbr, nbc, b, b)
    device shards for ``in_specs=P("xy")`` (cyclic over both grid dims).
    The one layout rule — :func:`prepare_values`,
    :func:`prepare_values_many` and :func:`gather_blocks` must agree."""
    nbr, nbc = nb // pr, nb // pc
    lead = G.shape[:-4]
    G = G.reshape(lead + (nbr, pr, nbc, pc, b, b))
    perm = tuple(range(len(lead)))
    off = len(lead)
    G = G.transpose(perm + (off + 1, off + 3, off, off + 2,
                            off + 4, off + 5))
    return G.reshape(lead + (pr * pc, nbr, nbc, b, b))


def prepare_values(A, bs: BlockStructure, nb: int, b: int, pr: int,
                   pc: int) -> Tuple[np.ndarray, np.ndarray]:
    """The numeric half of :func:`prepare_inputs`: factorize this
    matrix's *values* on the host against an already-analyzed structure,
    normalize, and lay out the dense-blocked shards.

    Returns (Lh, Dinv) with shape (pr*pc, nbr, nbc, b, b) for
    ``in_specs=P("xy")``. The caller guarantees ``A`` has the sparsity
    structure that produced ``bs`` — this is the engine's analyze-once /
    solve-many hot path, so no symbolic work happens here."""
    import scipy.linalg as sla

    A = check_values_pattern(A, bs, b)
    nb0 = bs.nsuper

    lu = factorize(A, bs=bs)
    Lhat, _ = normalize_factors(lu)

    Lh_g = np.zeros((nb, nb, b, b))
    Dinv_g = np.zeros((nb, nb, b, b))
    for (I, K), blk in Lhat.items():
        Lh_g[I, K] = np.asarray(blk)
    for K in range(nb0):
        linv = sla.solve_triangular(np.asarray(lu.Ldiag[K]), np.eye(b),
                                    lower=True, unit_diagonal=True)
        Dinv_g[K, K] = sla.solve_triangular(np.asarray(lu.Udiag[K]), linv,
                                            lower=False)
    for K in range(nb0, nb):       # padding supernodes: identity diag
        Dinv_g[K, K] = np.eye(b)

    return (_shard_blocks(Lh_g, nb, b, pr, pc),
            _shard_blocks(Dinv_g, nb, b, pr, pc))


def _batched_lu_nopivot(Akk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Doolittle LU without pivoting over a (B, b, b) block stack —
    the batched twin of ``supernodal_lu.dense_lu_nopivot`` (same
    elimination order, so the factors agree to rounding)."""
    B, b = Akk.shape[0], Akk.shape[1]
    lu = Akk.copy()
    for k in range(b - 1):
        piv = lu[:, k, k]
        lu[:, k + 1:, k] /= piv[:, None]
        lu[:, k + 1:, k + 1:] -= (lu[:, k + 1:, k, None]
                                  * lu[:, None, k, k + 1:])
    L = np.tril(lu, -1) + np.eye(b)
    return L, np.triu(lu)


def prepare_values_many(mats: Sequence, bs: BlockStructure, nb: int,
                        b: int, pr: int, pc: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched host factorization: B same-structure matrices → stacked
    ``(B, pr*pc, nbr, nbc, b, b)`` shards in ONE structure-driven pass.

    Same math as B :func:`prepare_values` calls — right-looking
    supernodal LU over the filled structure, factor normalization,
    diagonal inverses — but the Python loop over supernodes runs once
    with every block stacked ``(B, b, b)``, so the interpreter overhead
    that dominates the single-matrix path (measured ~11 ms/matrix at
    nb=16) amortizes across the batch (~1.3 ms/matrix at B=16). This is
    the serving layer's host-side half of the batching win: without it a
    coalesced batch still pays B sequential GIL-bound factorizations.

    The dense (nb0, nb0) block workspace is the same asymptotic
    footprint as the device layout :func:`prepare_values` already
    emits. Numerics match the single-matrix scipy path to rounding
    (≤1e-12 asserted in tests; observed ~1e-18).

    Raises ``ValueError`` naming the offending batch *index* when any
    matrix's pattern escapes the analyzed structure — callers that need
    per-request isolation (the serving layer) validate each matrix with
    :func:`check_values_pattern` first."""
    if not len(mats):
        raise ValueError("prepare_values_many needs at least one matrix")
    csr = []
    for i, M in enumerate(mats):
        try:
            csr.append(check_values_pattern(M, bs, b))
        except ValueError as e:
            raise ValueError(f"matrix {i} of {len(mats)}: {e}") from e
    B, nb0 = len(csr), bs.nsuper
    eye = np.eye(b)

    # dense (B, nb0, nb0, b, b) block workspace holding the evolving
    # Schur complement; fill lands in blocks the symbolic structure
    # already owns, so reading only struct blocks below is exact
    W = np.stack([np.asarray(M.todense()) for M in csr])
    W = (W.reshape(B, nb0, b, nb0, b).transpose(0, 1, 3, 2, 4)
          .astype(np.float64, copy=True))
    Lh = np.zeros((B, nb, nb, b, b))
    Dinv = np.zeros((B, nb, nb, b, b))
    bidx = np.arange(B)
    for K in range(nb0):
        L, U = _batched_lu_nopivot(W[:, K, K])
        C = [int(i) for i in bs.struct[K]]
        if C:
            # L(C,K): X·U = A  ⇔  Uᵀ·Xᵀ = Aᵀ (batched, broadcast over C)
            LCK = np.linalg.solve(
                U.transpose(0, 2, 1)[:, None],
                W[:, C, K].transpose(0, 1, 3, 2)).transpose(0, 1, 3, 2)
            UKC = np.linalg.solve(L[:, None], W[:, K, C])   # L·X = A
            W[:, C, K] = LCK
            W[:, K, C] = UKC
            # Schur update over the whole struct(K) × struct(K) clique
            W[np.ix_(bidx, C, C)] -= np.einsum(
                'bikl,bjlm->bijkm', LCK, UKC)
            # L̂(C,K) = L(C,K)·L(K,K)⁻¹:  X·L = A  ⇔  Lᵀ·Xᵀ = Aᵀ
            Lh[:, C, K] = np.linalg.solve(
                L.transpose(0, 2, 1)[:, None],
                LCK.transpose(0, 1, 3, 2)).transpose(0, 1, 3, 2)
        linv = np.linalg.solve(L, np.broadcast_to(eye, (B, b, b)))
        Dinv[:, K, K] = np.linalg.solve(U, linv)   # (U_KK)⁻¹(L_KK)⁻¹
    Dinv[:, range(nb0, nb), range(nb0, nb)] = eye   # padding supernodes
    return (_shard_blocks(Lh, nb, b, pr, pc),
            _shard_blocks(Dinv, nb, b, pr, pc))



def gather_blocks(out, prog):
    """Invert the shard layout back to a dense (nb, nb, b, b) block grid.
    Accepts the :class:`PSelInvProgram` or anything carrying one under
    ``.program`` (the engine), and a numpy array or a tensor (returned
    as the same kind) — the geometry is derived, not re-passed."""
    prog = getattr(prog, "program", prog)
    nb, b, pr, pc = prog.nb, prog.b, prog.pr, prog.pc
    nbr, nbc = nb // pr, nb // pc
    g = out.reshape(pr, pc, nbr, nbc, b, b)
    g = (g.permute(2, 0, 3, 1, 4, 5) if isinstance(g, torch.Tensor)
         else g.transpose(2, 0, 3, 1, 4, 5))
    return g.reshape(nb, nb, b, b)
