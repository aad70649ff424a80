"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout: it puts ``src`` on ``sys.path``, builds
the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/`` and then, on the card:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   nvcc versions and the kernel build time;
2. holds the block-GEMM kernel against its plain PyTorch version in f32,
   bf16 and f64 on the shapes of ``tests/test_kernels.py`` and at the
   main path's batched shapes, and times the kernel, the plain version
   and a batched ``torch.matmul`` yardstick beside the card's bound;
3. runs the main path — ``PSelInvEngine.analyze`` → ``prepare_values`` →
   ``solve`` on grid 4×2 — on the FEM-like (audikw_1 stand-in) and
   DG-like (DG_PNF14000 stand-in) matrices at full size, and checks the
   selected blocks against a dense f64 inverse computed on the card,
   bitwise-equal repeated solves, one kernel launch per planned GEMM op
   and the f32 solve against the f64 one;
4. checks a bucketed ``solve_many`` against single solves, bitwise;
5. writes every measured row to ``build/chip_smoke.json`` and prints the
   kernels' JSON line, the card line and, last, the result.

Every failed check raises and the script exits non-zero; without a CUDA
device, or outside a checkout, it exits non-zero before printing any
result. Numbers from this script are the only ones quoted for the port.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build"

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W): memory
# rate, and the peak rate of each working type's multiply-add — f64 on
# the tensor cores (DMMA), f32 outside them (no TF32), bf16 on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
TOL = {"float64": 1e-12, "float32": 1e-5}      # × max|plain|; bf16 below
BF16_TOL = dict(rtol=2e-2, atol=2e-2)          # as tests/test_kernels.py


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 5, warm: int = 1):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound(Z, M, N, K, dtype_name, elt):
    """Least time (ms) for Z products (M×K)·(K×N): each operand read and
    the result written once, over the memory rate, against 2·Z·M·N·K
    operations over the type's peak; and which of the two binds."""
    t_bytes = Z * (M * K + K * N + M * N) * elt / HBM_BYTES_PER_S
    t_ops = 2.0 * Z * M * N * K / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

# The main path's batched level-GEMM shapes, (setting, Z, nbr, nbc, b, nk):
# Z = 8 ranks of grid 4×2; FEM (b=96): m=3072, k=6144, n=nk·96 for nk = 1
# and 14; DG (b=128): m=4096, k=8192, n=128 (its tree is a chain: nk = 1)
MAIN_SHAPES = [("fem", 8, 32, 64, 96, 1), ("fem", 8, 32, 64, 96, 14),
               ("dg", 8, 32, 64, 128, 1)]


def kernel_checks(dev, main_shapes=MAIN_SHAPES):
    import numpy as np
    import torch
    from repro_torch.kernels import block_gemm as bg

    rng = np.random.default_rng(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float64": torch.float64}

    def compare(out, ref, name, what):
        err = (out.double() - ref.double()).abs().max().item()
        scale = ref.double().abs().max().item()
        if name == "bfloat16":
            ok = torch.allclose(out.float(), ref.float(), **BF16_TOL)
        else:
            ok = err <= TOL[name] * scale
        if not ok:
            raise AssertionError(f"block_gemm {what} {name}: max|Δ| {err:.3e}"
                                 f" vs max|plain| {scale:.3e}")
        return err

    for m, k, n in [(64, 64, 64), (128, 256, 128), (200, 130, 70),
                    (33, 17, 129)]:
        for name, dt in dtypes.items():
            for alpha in (1.0, -1.0):
                a = torch.from_numpy(rng.standard_normal((m, k))).to(dev, dt)
                b = torch.from_numpy(rng.standard_normal((k, n))).to(dev, dt)
                out = bg.block_gemm(a, b, alpha=alpha)
                torch.cuda.synchronize()
                err = compare(out, bg.block_gemm_plain(a, b, alpha), name,
                              f"{m}x{k}x{n} alpha={alpha}")
        log(f"kernel {m}x{k}x{n}: f32/bf16/f64, alpha ±1 ok "
            f"(last max|Δ| {err:.2e})")

    rows = []
    for setting, Z, nbr, nbc, b, nk in main_shapes:
        M, K, N = nbr * b, nbc * b, nk * b
        for name in ("float64", "float32", "bfloat16"):
            dt = dtypes[name]
            A = torch.randn(Z, nbr, nbc, b, b, dtype=torch.float64,
                            device=dev).to(dt)
            U = torch.randn(Z, nk, nbc, b, b, dtype=torch.float64,
                            device=dev).to(dt)
            out = bg.blocked_gemm(A, U)
            ref = bg.blocked_gemm_plain(A, U)
            torch.cuda.synchronize()
            err = compare(out, ref, name, f"{setting} Z={Z} {M}x{K}x{N}")
            a2 = A.permute(0, 1, 3, 2, 4).reshape(Z, M, K).contiguous()
            b2 = U.permute(0, 2, 4, 1, 3).reshape(Z, K, N).contiguous()
            ms = timed_ms(lambda: bg.blocked_gemm(A, U, out=out))
            plain_ms = timed_ms(lambda: bg.blocked_gemm_plain(A, U))
            lib_ms = timed_ms(lambda: torch.matmul(a2, b2))
            bms, by = bound(Z, M, N, K, name, A.element_size())
            rows.append(dict(setting=setting, dtype=name, Z=Z, m=M, k=K,
                             n=N, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             max_abs_err=err,
                             tflops=2.0 * Z * M * N * K / ms / 1e9))
            log(f"kernel {setting} {name} Z={Z} m={M} k={K} n={N}: "
                f"{ms:.3f} ms ({rows[-1]['tflops']:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound "
                f"{bms:.3f} ms ({by}), max|Δ| {err:.2e}")
            del A, U, out, ref, a2, b2
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def selected_error(out, eng, A, dev):
    """max|Δ| between the solve and the dense f64 inverse (computed on
    the card, as a check only) over the selected blocks — the diagonal,
    struct(K) and their transposes — and max|A⁻¹| over them."""
    import numpy as np
    import torch
    from repro_torch.core.pselinv_dist import gather_blocks

    b, nb0 = eng.b, eng.bs.nsuper
    rs, cs = [], []
    for K in range(nb0):
        rs.append(K)
        cs.append(K)
        for I in (int(i) for i in eng.bs.struct[K]):
            rs += [I, K]
            cs += [K, I]
    rs = torch.as_tensor(np.array(rs), device=dev)
    cs = torch.as_tensor(np.array(cs), device=dev)
    dense = torch.as_tensor(A.toarray(), device=dev)
    inv = torch.linalg.inv(dense)
    del dense
    ref = inv.view(nb0, b, nb0, b).permute(0, 2, 1, 3)[rs, cs]
    del inv
    got = gather_blocks(out.double(), eng)[rs, cs]
    err = (got - ref).abs().max().item()
    return err, ref.abs().max().item(), int(rs.numel())


def main_path(dev, setting, make, b, grid=(4, 2)):
    import torch
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PSelInvEngine
    from repro_torch.kernels import block_gemm as bg

    A = sparse.make_numeric(make()[0], seed=0, symmetric_values=True)
    n = A.shape[0]
    torch.cuda.reset_peak_memory_stats()
    # host clock around work that ends in a synchronize; analyze runs on
    # an emptied session cache each time (a hit would skip the work)
    analyze_s, prepare_s = [], []
    for _ in range(3):
        PSelInvEngine.clear_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = PSelInvEngine.analyze(A, b=b, grid=Grid(*grid), device=dev)
        torch.cuda.synchronize()
        analyze_s.append(time.perf_counter() - t0)
    vals = None
    for _ in range(3):
        vals = None
        t0 = time.perf_counter()
        vals = eng.prepare_values(A)
        torch.cuda.synchronize()
        prepare_s.append(time.perf_counter() - t0)
    ov = eng.program.overlap_plan
    gemm_ops = eng.gemm_ops()
    log(f"{setting}: n={n} b={b} nb={eng.nb} levels={len(ov.levels)} "
        f"max nk={max(len(lv.Ks) for lv in ov.levels)} "
        f"rounds={len(ov.rounds)} gemm ops={gemm_ops} "
        f"arena={ov.arena_blocks} blocks/rank; analyze "
        f"{statistics.median(analyze_s):.2f} s, prepare "
        f"{statistics.median(prepare_s):.2f} s (host clock, medians of "
        f"{[round(x, 2) for x in analyze_s]} and "
        f"{[round(x, 2) for x in prepare_s]})")

    # the main path's kernel launches: counts zeroed right before the
    # first solve, read right after it
    bg.launches = 0
    out = eng.solve(vals, dtype=torch.float64)
    torch.cuda.synchronize()
    launches = bg.launches
    if launches != gemm_ops:
        raise AssertionError(f"{setting}: {launches} block_gemm launches, "
                             f"plan has {gemm_ops} gemm ops")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{setting}: non-finite values in A⁻¹")

    solve_ms = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        again = eng.solve(vals, dtype=torch.float64)
        e.record()
        torch.cuda.synchronize()
        solve_ms.append(s.elapsed_time(e))
        if not torch.equal(again, out):
            raise AssertionError(f"{setting}: repeated solve differs")
        del again
    err, scale, nblk = selected_error(out, eng, A, dev)
    if not err <= 1e-10 * scale:
        raise AssertionError(f"{setting}: selected blocks max|Δ| {err:.3e}"
                             f" > 1e-10 · max|A⁻¹| {scale:.3e}")
    prof = profile_solve(eng, vals)
    out32 = eng.solve(vals, dtype=torch.float32)
    torch.cuda.synchronize()
    rel32 = ((out32.double() - out).abs().max().item()
             / out.abs().max().item())
    if not rel32 <= 1e-5:
        raise AssertionError(f"{setting}: f32 solve off the f64 one by "
                             f"{rel32:.3e} · max|A⁻¹|")
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = dict(setting=setting, n=n, b=b, nb=eng.nb,
               levels=len(ov.levels), rounds=len(ov.rounds),
               gemm_ops=gemm_ops, launches=launches,
               analyze_s_median=statistics.median(analyze_s),
               prepare_s_median=statistics.median(prepare_s),
               analyze_s=analyze_s, prepare_s=prepare_s, profile=prof,
               solve_ms_f64_median=statistics.median(solve_ms),
               solve_ms_f64=solve_ms, selected_blocks=nblk,
               max_err=err, max_ainv=scale, f32_rel=rel32,
               peak_gib=peak)
    log(f"{setting}: solve f64 {res['solve_ms_f64_median']:.1f} ms (median "
        f"of {[round(x, 1) for x in solve_ms]}, CUDA events, warm); "
        f"{launches} block_gemm launches = {gemm_ops} gemm ops; selected "
        f"{nblk} blocks max|Δ| {err:.3e} (max|A⁻¹| {scale:.3e}); repeated "
        f"solves bitwise equal; f32 vs f64 {rel32:.2e} · max|A⁻¹|; peak "
        f"{peak:.1f} GiB")
    del out, out32, vals, eng
    PSelInvEngine.clear_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return res


def profile_solve(eng, vals):
    """Device time of one f64 solve by kernel class (torch.profiler),
    against the solve's wall on CUDA events taken inside the traced
    window: the busy share and where it goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        eng.solve(vals, dtype=torch.float64)
        e.record()
        torch.cuda.synchronize()
    wall_us = s.elapsed_time(e) * 1e3
    classes = {}
    kernels = []
    for ev in p.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t <= 0 or ev.key.startswith("aten::"):
            continue
        k = ev.key
        if "block_gemm_kernel" in k:
            c = "block_gemm (hand-written)"
        elif any(x in k for x in ("gemm", "Gemm", "cutlass", "xmma",
                                  "sm90", "cublas")):
            c = "cuBLAS (scomp einsum)"
        elif "ndex" in k or "catter" in k or "ather" in k:
            c = "gather / scatter / index_add"
        elif "emcpy" in k or "emset" in k:
            c = "memcpy / memset"
        else:
            c = "elementwise (where, sub, transpose copies, zeros)"
        classes[c] = classes.get(c, 0.0) + t
        kernels.append((t, ev.count, k[:90]))
    busy = sum(classes.values())
    if busy <= 0:
        log("  profile: the profiler recorded no device time — breakdown "
            "not measured")
        return {"wall_us": wall_us, "busy_us": None}
    log(f"  profile (one f64 solve, traced): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %)")
    for c, t in sorted(classes.items(), key=lambda x: -x[1]):
        log(f"    {c}: {t / 1e3:.1f} ms ({100 * t / busy:.1f} % of busy)")
    for t, cnt, k in sorted(kernels, reverse=True)[:6]:
        log(f"    top kernel {t / 1e3:.1f} ms x{cnt}: {k}")
    return {"wall_us": wall_us, "busy_us": busy, "classes_us": classes,
            "top_kernels": [dict(us=t, count=c, name=k)
                            for t, c, k in sorted(kernels, reverse=True)[:10]]}


# ---------------------------------------------------------------------------
# phase 4: bucketed batch against single solves
# ---------------------------------------------------------------------------

def batched_path(dev):
    import torch
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PSelInvEngine, SolveValues

    S = sparse.dg_like_matrix(16, 16, 8)[0]
    mats = [sparse.make_numeric(S, seed=s, symmetric_values=True)
            for s in range(3)]
    eng = PSelInvEngine.analyze(mats[0], b=64, grid=Grid(4, 2), device=dev)
    many = eng.solve_many(mats, dtype=torch.float64, bucket=True)
    vals = eng.prepare_values_many(mats)
    batch = eng.solve(vals, dtype=torch.float64, bucket=True)
    if not torch.equal(many, batch):
        raise AssertionError("solve_many differs from the batched solve")
    for i in range(len(mats)):
        single = eng.solve(SolveValues(vals.Lh[i], vals.Dinv[i]),
                           dtype=torch.float64)
        if not torch.equal(batch[i], single):
            raise AssertionError(f"batch item {i} differs from its single "
                                 "solve")
    torch.cuda.synchronize()
    log(f"batched: dg_like(16,16,8) b=64 nb={eng.nb}, 3 matrices bucketed "
        f"to 4: each equal (bitwise) to its single solve")
    PSelInvEngine.clear_cache()


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src} — run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import sparse
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}), "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.build(["block_gemm"])
    _build.load("block_gemm")
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = kernel_checks(dev)
    settings = [
        main_path(dev, "fem3d_like(16,16,16,3)",
                  lambda: sparse.fem3d_like_matrix(16, 16, 16, 3), 96),
        main_path(dev, "dg_like(32,32,16)",
                  lambda: sparse.dg_like_matrix(32, 32, 16), 128),
    ]
    batched_path(dev)

    head = next(r for r in rows if r["setting"] == "fem"
                and r["dtype"] == "float64" and r["n"] == 14 * 96)
    kernels = [{
        "name": "block_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_gemm.cu",
        "replaces": "src/repro/kernels/block_gemm.py:43",
        "launches": sum(s["launches"] for s in settings),
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": f"Z={head['Z']} m={head['m']} k={head['k']} "
                 f"n={head['n']} float64",
    }]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "kernel_rows": rows, "main_path": settings, "kernels": kernels},
        indent=1))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
