"""ExecLint CLI — the executed-communication verifier
(``repro_torch.core.exec_verify``) over a generated structure corpus,
the twin of the JAX package's ``tools/hlo_lint.py``. Every executor
lowering (level-serial, overlapped, gated stream under both
``axis_factored`` settings) runs its own sweep once on ``meta`` tensors
(shapes and dtypes, no memory, no arithmetic) under the recorder and the
op layer, and its executed permutes are held to the plan tables: pairs,
rounds, lane widths, wire blocks, hygiene. No card is needed (the 8×4
case lints on the CPU in seconds):

    PYTHONPATH=src python -m repro_torch.tools.exec_lint        # corpus
    PYTHONPATH=src python -m repro_torch.tools.exec_lint --grid 8x4 --nb 32
    PYTHONPATH=src python -m repro_torch.tools.exec_lint -v     # per case
    PYTHONPATH=src python -m repro_torch.tools.exec_lint \
        --baseline BENCH_pselinv_torch.json      # + the size lint

With ``--baseline`` the nb=16 4×2 stream sweep's dispatched ops are
also held to the size baseline recorded there for that class
(``exec_verify.load_size_baseline``, the newest card entry); a
regression past ``SIZE_REGRESS_RATIO`` is a WARN. Exits non-zero iff
any case produces an ERROR-severity diagnostic.
"""
from __future__ import annotations

import argparse
import time

import scipy.sparse as sp_mod

from ..core import sparse
from ..core.exec_verify import lint_program, load_size_baseline
from ..core.plan import PlanOptions
from ..core.pselinv_dist import build_program, pad_nb
from ..core.symbolic import symbolic_factorize

#: default corpus: (nx, ny, nb, pr, pc) — the JAX tools' shapes
DEFAULT_CORPUS = [
    (16, 8, 16, 4, 2),
    (32, 8, 32, 4, 2),
    (32, 8, 32, 8, 4),
]

#: the executor lowerings every case lints
EXECUTORS = [
    ("exec", PlanOptions(overlap=False)),
    ("overlap", PlanOptions(overlap=True)),
    ("stream", PlanOptions(stream=True)),
    ("stream(axis_factored=False)",
     PlanOptions(stream=True, axis_factored=False)),
]


def lint_case(nx: int, ny: int, nb: int, pr: int, pc: int, *,
              verbose: bool = False, baseline=None):
    """Lint every executor lowering of one (structure, grid) case.
    Returns (n_errors, n_warnings, n_programs)."""
    bs = symbolic_factorize(
        sp_mod.csr_matrix(sparse.laplacian_2d(nx, ny)), max_supernode=8)
    nbp = pad_nb(bs.nsuper, pr, pc)
    nerr = nwarn = 0
    case = f"laplacian_2d({nx},{ny}) nb={nbp} grid {pr}x{pc}"
    for what, opts in EXECUTORS:
        prog = build_program(bs, nbp, 8, pr, pc, options=opts)
        # the baseline is the nb=16 4x2 stream class's: hold that only
        same = (nbp, pr, pc, what) == (16, 4, 2, "stream")
        diags = lint_program(prog, baseline=baseline if same else None)
        errs = [d for d in diags if d.severity == "error"]
        warns = [d for d in diags if d.severity == "warn"]
        nerr += len(errs)
        nwarn += len(warns)
        if errs or warns or verbose:
            print(f"  {case} :: {what}: {len(errs)} error(s), "
                  f"{len(warns)} warning(s); {diags.info['ppermute_count']}"
                  f" permutes, {diags.info['wire_blocks']} of "
                  f"{diags.info['expected_blocks']} planned wire blocks")
        for d in errs + warns:
            print(f"    {d}")
    return nerr, nwarn, len(EXECUTORS)


def corpus(grid: str | None, nb: int):
    if grid:
        pr, pc = (int(x) for x in grid.lower().split("x"))
        return [(nb, 8, nb, pr, pc)]
    return DEFAULT_CORPUS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default=None,
                    help="lint one PRxPC grid (e.g. 8x4) instead of the "
                         "default corpus")
    ap.add_argument("--nb", type=int, default=32,
                    help="supernode blocking for --grid (default 32)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="report clean programs too")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="hold the nb=16 4x2 stream sweep's dispatched "
                         "ops to the size baseline in this bench history")
    args = ap.parse_args(argv)
    baseline = None
    if args.baseline:
        baseline = load_size_baseline(args.baseline)
        print(f"[exec-lint] size baseline from {args.baseline}: "
              f"{baseline or 'none recorded on the card'}")

    cases = corpus(args.grid, args.nb)
    t0 = time.time()
    nerr = nwarn = nprog = 0
    for case in cases:
        e, w, p = lint_case(*case, verbose=args.verbose, baseline=baseline)
        nerr += e
        nwarn += w
        nprog += p
    status = "FAIL" if nerr else "OK"
    print(f"[exec-lint] {status}: {nprog} executed sweep(s) across "
          f"{len(cases)} case(s) — {nerr} error(s), {nwarn} warning(s) "
          f"in {time.time() - t0:.1f}s")
    return 1 if nerr else 0


if __name__ == "__main__":
    raise SystemExit(main())
