"""PlanLint CLI — the static schedule verifier
(``repro_torch.core.verify``) over a generated structure corpus, the
twin of the JAX package's ``tools/plan_lint.py``.

Lints each (structure, grid) case through every lowering the port
ships — the CommPlan IR, the level-serial ExecPlan, the overlapped
round stream (with and without a Û liveness window), and the gated
stream tables under both ``axis_factored`` settings — entirely on the
host:

    PYTHONPATH=src python -m repro_torch.tools.plan_lint         # corpus
    PYTHONPATH=src python -m repro_torch.tools.plan_lint --grid 8x4 --nb 32
    PYTHONPATH=src python -m repro_torch.tools.plan_lint -v
    PYTHONPATH=src python -m repro_torch.tools.plan_lint --compiled

``--compiled`` chains the executed-communication verifier
(``python -m repro_torch.tools.exec_lint``) over the same corpus: each
executor's sweep runs on ``meta`` tensors and its permutes are held to
the plan tables — still no card.

Exits non-zero iff any case produces an ERROR-severity diagnostic.
"""
from __future__ import annotations

import argparse
import time

import scipy.sparse as sp_mod

from ..core import sparse, verify
from ..core.plan import (TreeKind, build_plan, compile_exec,
                         schedule_overlapped)
from ..core.schedule import Grid2D
from ..core.stream import lower_stream
from ..core.symbolic import symbolic_factorize
from . import exec_lint


def lint_case(nx: int, ny: int, nb: int, pr: int, pc: int, *,
              windows=(None, 1), verbose: bool = False):
    """Lint every lowering of one (structure, grid) case. Returns
    (n_errors, n_warnings, n_artifacts)."""
    bs = symbolic_factorize(
        sp_mod.csr_matrix(sparse.laplacian_2d(nx, ny)), max_supernode=8)
    plan = build_plan(bs, Grid2D(pr, pc), TreeKind.SHIFTED, nb=nb)
    artifacts = [("plan", verify.check_plan(plan)),
                 ("exec", verify.check_exec(compile_exec(plan)))]
    for w in windows:
        ov = schedule_overlapped(plan, window=w)
        artifacts.append((f"overlap(window={w})",
                          verify.check_overlap(ov, plan)))
        for af in (True, False):
            st = lower_stream(ov, axis_factored=af)
            artifacts.append(
                (f"stream(window={w}, axis_factored={af})",
                 verify.check_stream(st, plan)))
    nerr = nwarn = 0
    case = f"laplacian_2d({nx},{ny}) nb={nb} grid {pr}x{pc}"
    for what, diags in artifacts:
        errs = [d for d in diags if d.severity == "error"]
        warns = [d for d in diags if d.severity == "warn"]
        nerr += len(errs)
        nwarn += len(warns)
        if errs or warns or verbose:
            print(f"  {case} :: {what}: "
                  f"{len(errs)} error(s), {len(warns)} warning(s)")
        for d in errs + warns:
            print(f"    {d}")
    return nerr, nwarn, len(artifacts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default=None,
                    help="lint one PRxPC grid (e.g. 8x4) instead of the "
                         "default corpus")
    ap.add_argument("--nb", type=int, default=32,
                    help="supernode blocking for --grid (default 32)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="report clean artifacts too")
    ap.add_argument("--compiled", action="store_true",
                    help="additionally run the executed-communication "
                         "verifier (repro_torch.tools.exec_lint) over the "
                         "same corpus")
    args = ap.parse_args(argv)

    cases = exec_lint.corpus(args.grid, args.nb)
    t0 = time.time()
    nerr = nwarn = narts = 0
    for case in cases:
        e, w, a = lint_case(*case, verbose=args.verbose)
        nerr += e
        nwarn += w
        narts += a
    status = "FAIL" if nerr else "OK"
    print(f"[plan-lint] {status}: {narts} artifact(s) across "
          f"{len(cases)} case(s) — {nerr} error(s), {nwarn} warning(s) "
          f"in {time.time() - t0:.1f}s")
    if args.compiled:
        ce = cw = cp = 0
        for case in cases:
            e, w, p = exec_lint.lint_case(*case, verbose=args.verbose)
            ce += e
            cw += w
            cp += p
        cstatus = "FAIL" if ce else "OK"
        print(f"[exec-lint] {cstatus}: {cp} executed sweep(s) across "
              f"{len(cases)} case(s) — {ce} error(s), {cw} warning(s)")
        nerr += ce
    return 1 if nerr else 0


if __name__ == "__main__":
    raise SystemExit(main())
