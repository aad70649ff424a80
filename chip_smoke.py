"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout: it puts ``src`` on ``sys.path``, builds
the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/`` (one nvcc per source, all started together) and then,
on the card:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   nvcc versions and the kernel build time; counts the tensor-core
   instructions in each built library (``cuobjdump -sass``: DMMA in every
   f64 block-GEMM instance, HMMA in every bf16 block-GEMM and flash
   instance, or it fails) and prints ptxas's registers, shared memory and
   spills per template instance;
2. holds each kernel against its plain PyTorch version and times it
   beside the card's bound, the plain version and one library call used
   only as a yardstick: the block GEMM in f32, bf16 and f64 on the shapes
   of ``tests/test_kernels.py`` and the main path's batched shapes
   (``torch.matmul``); trsm in f32/bf16/f64 up to (4096, 256), and at
   (96, 96) with the serial path's zero rows
   (``torch.linalg.solve_triangular``); RMSNorm in f32/bf16 up to
   qwen3-32b's widths, one kernel a call (``F.rms_norm``); flash attention
   in f32/bf16, causal and not, up to qwen3-32b's (1, 4096, 64, 128)
   (``F.scaled_dot_product_attention``);
3. runs the main path — ``PSelInvEngine.analyze`` → ``prepare_values`` →
   ``solve`` on grid 4×2 — on the FEM-like (audikw_1 stand-in) and
   DG-like (DG_PNF14000 stand-in) matrices at full size, and checks the
   selected blocks against a dense f64 inverse computed on the card,
   bitwise-equal repeated solves, one kernel launch per planned GEMM op,
   every f64 launch on the DMMA variant, and the f32 solve against the
   f64 one;
3b. runs the level-serial (``PlanOptions(overlap=False)``) and stream
   (``PlanOptions(stream=True)``) executors on the same prepared values:
   selected blocks against the dense inverse, the stream bitwise equal to
   the overlapped solve, the level-serial sweep within 1e-12·max|A⁻¹| of
   it, one block-GEMM launch per planned GEMM, repeated solves bitwise
   equal and, on FEM, a bucketed batch of 3 bitwise equal to its single
   solves for every executor;
3c. replays the FEM setting's overlapped solve round by round
   (``engine.profile_rounds``, each round fenced): the round count and
   wire bytes against the plan, the replay's A⁻¹ bitwise against the
   solve, the slowest rounds beside the α-β model, skew and fitted α/β;
4. runs the serial path — ``factorize`` + ``selinv`` with the ``cuda`` and
   ``torch`` backends in f64 — on the FEM matrix, against the dense
   inverse and the engine's solve, with one trsm launch per supernode
   (all of struct(K) stacked, on the resident variant) and one block-GEMM
   launch per host-loop product, beside the numpy backend's time, a
   traced split of where the time goes, and all of the path's stacked trsm
   solves timed through the kernel and ``torch.linalg.solve_triangular``
   beside their summed bound;
5. checks a bucketed ``solve_many`` against single solves, bitwise;
6. drives the ``ops`` entry points through the port's kernel benchmark
   (``repro_torch.kernels.bench``) and, for RMSNorm and flash attention,
   at qwen3-32b's widths in bf16, every output held against its plain
   version, every kernel launched and bf16 flash on the tensor cores;
7. writes every measured row to ``build/chip_smoke.json`` and prints the
   kernels' JSON line, the total wall time, the card line and, last, the
   result.

Every launch count is zeroed right before its path runs and read right
after it. Every failed check raises and the script exits non-zero; without a CUDA
device, or outside a checkout, it exits non-zero before printing any
result. Numbers from this script are the only ones quoted for the port.
"""
from __future__ import annotations

import json
import re
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
    """Mean time per call of ``fn`` over ``reps`` back-to-back runs,
    between CUDA events: the device's time, or the host's launch time
    where that is the slower (small calls)."""
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


def device_ms(fn, reps: int = 5):
    """Device time per call of ``fn``: the kernels' time in a traced
    window of ``reps`` calls (torch.profiler), over ``reps``. Unlike
    :func:`timed_ms` it leaves out the host's time between launches,
    which sets the pace of a loop of small calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) or 0
             for ev in p.key_averages() if not ev.key.startswith("aten::"))
    return us / 1e3 / reps


def bound(Z, M, N, K, dtype_name, elt):
    """Least time (ms) for Z products (M×K)·(K×N): each operand read and
    the result written once, over the memory rate, against 2·Z·M·N·K
    operations over the type's peak; and which of the two binds."""
    t_bytes = Z * (M * K + K * N + M * N) * elt / HBM_BYTES_PER_S
    t_ops = 2.0 * Z * M * N * K / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


KERNELS = ("block_gemm", "trsm", "rmsnorm", "flash_attention")


def _kernel_modules():
    import importlib
    return {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in KERNELS}


def zero_counts():
    """Set every kernel's launch count to 0 (right before a path runs),
    and the per-variant counts where a wrapper keeps them."""
    for mod in _kernel_modules().values():
        mod.launches = 0
        if hasattr(mod, "plans"):
            mod.plans.clear()


def read_counts():
    return {n: mod.launches for n, mod in _kernel_modules().items()}


def check_close(kernel, out, ref, name, what, tol, bf16_tol=BF16_TOL):
    """max|Δ| of a kernel's output against its plain version, and the
    share of the tolerance it uses; raises past the tolerance (× max|plain|
    for f64/f32; for bf16 |Δ| ≤ atol + rtol·|plain| element by element, as
    ``torch.allclose``)."""
    import torch
    delta = (out.double() - ref.double()).abs()
    err = delta.max().item()
    scale = ref.double().abs().max().item()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{kernel} {what} {name}: non-finite output")
    if name == "bfloat16":
        used = bf16_used(delta, ref, bf16_tol)
    else:
        used = err / (tol[name] * scale) if scale else float(err > 0)
    if not used <= 1.0:
        raise AssertionError(f"{kernel} {what} {name}: max|Δ| {err:.3e} vs "
                             f"max|plain| {scale:.3e} ({used:.2f}× the "
                             "tolerance)")
    return err, used


def bf16_used(delta, ref, tol):
    """The largest share of ``atol + rtol·|ref|`` that ``delta`` uses."""
    return (delta / (tol["atol"] + tol["rtol"] * ref.double().abs())
            ).max().item()


# ---------------------------------------------------------------------------
# phase 1b: what the compiler made of the kernels — tensor-core instructions
# in the SASS of each built library, and ptxas's registers, shared memory
# and spills for each template instance
# ---------------------------------------------------------------------------

SASS_OPS = ("DMMA", "HMMA", "LDGSTS", "LDSM")
# the instruction each redesigned library must hold, and the instances
# (by name prefix) that must hold it
SASS_REQUIRED = {
    "block_gemm": [("block_gemm_kernel<double", "DMMA"),
                   ("block_gemm_kernel<__nv_bfloat16", "HMMA")],
    "flash_attention": [("flash_hmma_kernel<", "HMMA")],
}
CTYPE = {"float64": "double", "bfloat16": "__nv_bfloat16",
         "float32": "float"}


def cuda_tool(name):
    """A CUDA toolkit program beside nvcc; raises when it is missing."""
    from repro_torch.kernels import _build
    path = Path(_build.nvcc_path()).parent / name
    if not path.is_file():
        raise RuntimeError(f"{name} not found beside nvcc ({path}): the "
                           "tensor-core check cannot run")
    return str(path)


_MANGLED_ARG = re.compile(r"d|f|13__nv_bfloat16|Li(\d+)E|Lb([01])E|S\d*_")
_MANGLED_TYPE = {"d": "double", "f": "float",
                 "13__nv_bfloat16": "__nv_bfloat16"}


def instance_name(mangled):
    """The template instance a kernel symbol names, read off its Itanium
    mangling (e.g. ``...17block_gemm_kernelIdLi96EE...`` →
    ``block_gemm_kernel<double, 96>``); the symbol itself if it is not one
    of the port's kernel templates."""
    m = re.search(r"\d+(block_gemm_kernel|flash_hmma_kernel|flash_kernel|"
                  r"trsm_kernel|rmsnorm_kernel|rmsnorm_two_pass)I", mangled)
    if not m:
        return mangled
    args, pos = [], m.end()
    while pos < len(mangled) and mangled[pos] != "E":
        a = _MANGLED_ARG.match(mangled, pos)
        if not a:
            return mangled
        if a.group(0).startswith("S"):
            # a substitution: the one class type among the arguments
            # (__nv_bfloat16) named a second time
            if "__nv_bfloat16" not in args:
                return mangled
            args.append("__nv_bfloat16")
        else:
            args.append(a.group(1) or {"0": "false", "1": "true"}.get(
                a.group(2)) or _MANGLED_TYPE[a.group(0)])
        pos = a.end()
    return f"{m.group(1)}<{', '.join(args)}>"


def sass_counts(lib):
    """Count SASS_OPS per kernel in ``cuobjdump -sass`` of one library."""
    r = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)],
                       capture_output=True, text=True, check=True,
                       timeout=120)
    counts, cur = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if cur is not None and m and m.group(1) in counts[cur]:
            counts[cur][m.group(1)] += 1
    return {instance_name(k): v for k, v in counts.items()}


def ptxas_report(log):
    """Registers, static shared memory, stack and spills per kernel, from
    ``nvcc -Xptxas -v``'s output."""
    rep, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            rep[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rep[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            rep[cur].update(registers=int(m.group(1)),
                            static_smem=int(sm.group(1)) if sm else 0)
    return {instance_name(k): v for k, v in rep.items()}


def compiled_checks(libs, logs):
    """The tensor-core check and the ptxas report of every instance: the
    block-GEMM library must hold DMMA in each f64 instance and HMMA in each
    bf16 one, the flash library HMMA in each tensor-core instance."""
    sass = {n: sass_counts(libs[n]) for n in SASS_REQUIRED}
    for lib, reqs in SASS_REQUIRED.items():
        for prefix, op in reqs:
            hits = {k: v[op] for k, v in sass[lib].items()
                    if k.startswith(prefix)}
            if not hits or not all(hits.values()):
                raise AssertionError(f"{lib}: no {op} in {prefix}* "
                                     f"instances: {hits} (SASS of {lib}: "
                                     f"{sass[lib]})")
    ptxas = {n: ptxas_report(t) for n, t in logs.items()}
    for lib in SASS_REQUIRED:
        for k, v in sass[lib].items():
            p = ptxas.get(lib, {}).get(k, {})
            log(f"  {lib} {k}: SASS " + ", ".join(
                f"{op} {c}" for op, c in v.items() if c)
                + f"; ptxas {p.get('registers')} registers, "
                f"{p.get('static_smem')} B static smem, spills "
                f"{p.get('spill_stores')}/{p.get('spill_loads')} B")
    return sass, ptxas


def gemm_symbol(dtype_name, p):
    return f"block_gemm_kernel<{CTYPE[dtype_name]}, {p.bn}>"


def flash_symbol(p, hd):
    if p.variant == "fma_f32":
        return f"flash_kernel<float, {hd}>"
    return (f"flash_hmma_kernel<{hd}, "
            f"{'true' if p.variant == 'hmma_cpasync' else 'false'}>")


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
        return check_close("block_gemm", out, ref, name, what, TOL)[0]

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
            p = bg.plan(M, N, K, dt, bg.blocked_desc(A.stride(), U.stride(),
                                                     out.stride(), b),
                        (A.data_ptr(), U.data_ptr()))
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
                             tflops=2.0 * Z * M * N * K / ms / 1e9,
                             variant=p.variant,
                             tile=f"{p.bm}x{p.bn}x{p.bk}",
                             staging="cp.async" if p.a_async and p.b_async
                             else f"a_async={p.a_async} b_async={p.b_async}",
                             symbol=gemm_symbol(name, p)))
            log(f"kernel {setting} {name} Z={Z} m={M} k={K} n={N} "
                f"[{p.variant} {p.bm}x{p.bn}x{p.bk}, {rows[-1]['staging']}]: "
                f"{ms:.3f} ms ({rows[-1]['tflops']:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound "
                f"{bms:.3f} ms ({by}), max|Δ| {err:.2e}")
            del A, U, out, ref, a2, b2
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2b: the trsm, RMSNorm and flash-attention kernels against their
# plain versions, timed beside the bound and one library call
# ---------------------------------------------------------------------------

# tolerances of the phase: f64 and f32 × max|plain|, bf16 allclose
TRSM_TOL = {"float64": 1e-12, "float32": 1e-5}
RMS_TOL = {"float32": 1e-5}
FLASH_TOL = {"float32": 1e-4}       # sums over up to 4096 keys, rescaled
# one bf16 step of the output (2^-7 relative) plus 2e-3: typical outputs
# are 0.02-0.04 at S = 4096, and one KV tile left out fails it (checked)
FLASH_BF16_TOL = dict(rtol=1e-2, atol=2e-3)

# back-to-back calls timed per trsm and RMSNorm row: their calls are tens
# of µs, where five calls read the host's start-up as much as the call
SMALL_REPS = 50
TRSM_SHAPES = [(64, 32), (100, 64), (130, 48), (96, 96), (1440, 96),
               (4096, 256)]
# the serial path's right-hand sides, A(I,K) after Schur updates, hold
# whole rows of exact zeros: every other row zero, and all of them
TRSM_ZERO_SHAPES = [(96, 96, "half"), (96, 96, "all")]
# configs/qwen3_32b.py: d_model 5120, head_dim 128 (qk-norm over
# 64 heads of a 4096-token sequence), n_heads 64
RMS_SHAPES = [(64, 256), (100, 512), (7, 1024), (4096, 5120),
              (4096 * 64, 128)]
FLASH_SHAPES = [((1, 128, 2, 64), ("float32", "bfloat16")),
                ((2, 256, 4, 64), ("float32", "bfloat16")),
                ((1, 512, 1, 128), ("float32", "bfloat16")),
                ((1, 4096, 64, 128), ("bfloat16",)),
                ((1, 1024, 64, 128), ("float32",))]


def _dtypes():
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}


def _bound(nbytes, nops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _row(kernel, shape, name, err, fn, plain, lib, nbytes, nops, reps=5,
         **kw):
    ms, plain_ms, lib_ms = (None if f is None else
                            timed_ms(f, reps, max(1, reps // 10))
                            for f in (fn, plain, lib))
    dev = [None if f is None else device_ms(f) for f in (fn, plain, lib)]
    bms, by = _bound(nbytes, nops, name)
    r = dict(kernel=kernel, shape=shape, dtype=name, ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
             bound_by=by, max_abs_err=err, device_ms=dev[0],
             plain_device_ms=dev[1], library_device_ms=dev[2], **kw)
    lib = ("none" if lib_ms is None else
           f"{lib_ms:.4f} ms (device {dev[2]:.4f})")
    extra = "".join(f" {k}={v}" for k, v in kw.items()
                    if k in ("causal", "variant"))
    log(f"{kernel} {shape}{extra} {name}: {ms:.4f} ms (device {dev[0]:.4f}),"
        f" plain {plain_ms:.4f} ms (device {dev[1]:.4f}), library {lib}, "
        f"bound {bms:.4f} ms ({by}), max|Δ| {err:.2e} "
        f"({kw['tol_used']:.3f} of the tolerance)")
    return r


def trsm_checks(dev, shapes=TRSM_SHAPES + TRSM_ZERO_SHAPES):
    """trsm against its plain version in f32/bf16/f64 (U upper with a
    diagonal of 2 and off-diagonal N(0, 1/k), well conditioned at every
    k); yardstick ``torch.linalg.solve_triangular``, which takes no bf16.
    A shape ``(m, k, "half")`` zeroes every other row of B, ``(m, k,
    "all")`` every row: the serial path's zero rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import trsm as tk

    rng = np.random.default_rng(1)
    rows = []
    for m, k, *zeros in shapes:
        u0 = np.triu(rng.standard_normal((k, k))) / np.sqrt(k) + 2 * np.eye(k)
        b0 = rng.standard_normal((m, k))
        label = f"{m}x{k}"
        if zeros:
            b0[slice(1, None, 2) if zeros[0] == "half" else slice(None)] = 0.0
            label += f" {zeros[0]}-zero"
        for name, dt in _dtypes().items():
            u = torch.from_numpy(u0).to(dev, dt)
            b = torch.from_numpy(b0).to(dev, dt)
            out = tk.trsm(b, u)
            torch.cuda.synchronize()
            err, used = check_close("trsm", out, tk.trsm_plain(b, u), name,
                                    label, TRSM_TOL)
            elt = b.element_size()
            p = tk.plan(m, k, dt)
            rows.append(_row(
                "trsm", label, name, err, lambda: tk.trsm(b, u),
                lambda: tk.trsm_plain(b, u),
                None if name == "bfloat16" else
                lambda: torch.linalg.solve_triangular(u, b, upper=True,
                                                      left=False),
                (2 * m * k + k * k) * elt, m * k * k, reps=SMALL_REPS,
                m=m, k=k, tol_used=used, variant=p.variant,
                tile=f"{p.rows} rows x 32 columns a block, "
                     f"{p.group} panel(s) a stage",
                symbol=trsm_symbol(name)))
    return rows


def trsm_symbol(dtype_name):
    acc = "double" if dtype_name == "float64" else "float"
    return f"trsm_kernel<{CTYPE[dtype_name]}, {acc}>"


def rmsnorm_symbol(dtype_name, p, scale_name):
    x, sc = CTYPE[dtype_name], CTYPE[scale_name]
    if p.variant == "two_pass":
        return f"rmsnorm_two_pass<{x}, {p.width}, {sc}>"
    return f"rmsnorm_kernel<{x}, {p.width}, {p.ppt}, {sc}>"


def kernels_per_call(fn):
    """The kernels the card runs for one ``fn()`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def rmsnorm_checks(dev, shapes=RMS_SHAPES):
    """RMSNorm against its plain version in f32 and bf16, the scale in
    x's type; one kernel a call (torch.profiler); yardstick
    ``torch.nn.functional.rms_norm``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rk

    rng = np.random.default_rng(2)
    rows = []
    for r, d in shapes:
        x0 = torch.from_numpy(rng.standard_normal((r, d), dtype=np.float32))
        s0 = torch.from_numpy(rng.standard_normal(d, dtype=np.float32))
        for name in ("float32", "bfloat16"):
            dt = _dtypes()[name]
            x, s = x0.to(dev, dt), s0.to(dev, dt)
            out = rk.rmsnorm(x, s)
            torch.cuda.synchronize()
            err, used = check_close("rmsnorm", out, rk.rmsnorm_plain(x, s),
                                    name, f"{r}x{d}", RMS_TOL)
            ran = kernels_per_call(lambda: rk.rmsnorm(x, s))
            if len(ran) != 1:
                raise AssertionError(f"rmsnorm {r}x{d} {name}: one call ran "
                                     f"{len(ran)} kernels: {ran}")
            elt = x.element_size()
            p = rk.plan(r, d, dt)
            rows.append(_row(
                "rmsnorm", f"{r}x{d}", name, err, lambda: rk.rmsnorm(x, s),
                lambda: rk.rmsnorm_plain(x, s),
                lambda: F.rms_norm(x, (d,), weight=s, eps=1e-5),
                2 * r * d * elt + d * elt, 4 * r * d, reps=SMALL_REPS,
                rows=r, d=d, tol_used=used, kernels_per_call=len(ran),
                variant=p.variant,
                tile=f"{p.g} threads x {p.ppt} packs of {p.width} a row",
                symbol=rmsnorm_symbol(name, p, name)))
            del x, s, out
    torch.cuda.empty_cache()
    return rows


def flash_checks(dev, shapes=FLASH_SHAPES):
    """Flash attention against its plain version, causal and not;
    yardstick ``F.scaled_dot_product_attention`` on (B, H, S, hd) copies
    made outside the timed call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for (B, S, H, hd), names in shapes:
        for name in names:
            dt = _dtypes()[name]
            q, k, v = (torch.randn(B, S, H, hd, device=dev, generator=g,
                                   dtype=torch.float32).to(dt)
                       for _ in range(3))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            for causal in (True, False):
                out = fa.flash_attention(q, k, v, causal)
                ref = fa.flash_attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                what = f"B={B} S={S} H={H} hd={hd} causal={causal}"
                err, used = check_close("flash_attention", out, ref, name,
                                        what, FLASH_TOL, FLASH_BF16_TOL)
                del ref
                pairs = S * (S + 1) // 2 if causal else S * S
                p = fa.plan(B, S, H, hd, dt, causal,
                            [t.stride()[:3] for t in (q, k, v)],
                            [t.data_ptr() for t in (q, k, v)])
                rows.append(_row(
                    "flash_attention", f"{B}x{S}x{H}x{hd}", name, err,
                    lambda: fa.flash_attention(q, k, v, causal),
                    lambda: fa.flash_attention_plain(q, k, v, causal),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal),
                    4 * B * S * H * hd * q.element_size(),
                    4 * B * H * hd * pairs, causal=causal, tol_used=used,
                    variant=p.variant, tile=f"{p.bq}x{p.bk}",
                    symbol=flash_symbol(p, hd)))
                torch.cuda.empty_cache()
            if name == "bfloat16" and S >= 4096:
                rows[-1]["dropped_tile_tol_used"] = flash_check_power(
                    fa, q, k, v)
            del q, k, v, qt, kt, vt
    return rows


def flash_check_power(fa, q, k, v):
    """Show the bf16 check can fail: the plain version with one KV tile
    (keys 64-127) left out, held against the whole plain version, must
    use more than the whole of ``FLASH_BF16_TOL``."""
    import torch
    ref = fa.flash_attention_plain(q, k, v, False)
    kd, vd = (torch.cat([t[:, :64], t[:, 128:]], 1) for t in (k, v))
    drop = fa.flash_attention_plain(q, kd, vd, False)
    used = bf16_used((drop.double() - ref.double()).abs(), ref,
                     FLASH_BF16_TOL)
    if not used > 1.0:
        raise AssertionError(f"flash bf16 check passes a dropped KV tile "
                             f"({used:.2f}× the tolerance)")
    log(f"flash_attention bf16 check: one KV tile left out uses {used:.1f}×"
        f" the tolerance (fails, as it must)")
    return used


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def selected_keys(bs):
    """The selected blocks: the diagonal, struct(K) and their transposes,
    as (row, column) supernode pairs."""
    keys = []
    for K in range(bs.nsuper):
        keys.append((K, K))
        for I in (int(i) for i in bs.struct[K]):
            keys += [(I, K), (K, I)]
    return keys


def selected_index(bs, dev):
    """The (row, column) supernode index tensors of
    :func:`selected_keys`."""
    import numpy as np
    import torch
    return tuple(torch.as_tensor(np.array(x), device=dev)
                 for x in zip(*selected_keys(bs)))


def selected_blocks(out, eng, dev):
    """The selected blocks of a solve's A⁻¹ shards, in
    :func:`selected_keys` order."""
    from repro_torch.core.pselinv_dist import gather_blocks
    rs, cs = selected_index(eng.bs, dev)
    return gather_blocks(out.double(), eng)[rs, cs]


def selected_error(out, eng, A, dev):
    """max|Δ| between the solve and the dense f64 inverse (computed on
    the card, as a check only) over the selected blocks, max|A⁻¹| over
    them, and both stacks of blocks, in :func:`selected_keys` order."""
    import torch

    b, nb0 = eng.b, eng.bs.nsuper
    rs, cs = selected_index(eng.bs, dev)
    dense = torch.as_tensor(A.toarray(), device=dev)
    inv = torch.linalg.inv(dense)
    del dense
    ref = inv.view(nb0, b, nb0, b).permute(0, 2, 1, 3)[rs, cs]
    del inv
    got = selected_blocks(out, eng, dev)
    err = (got - ref).abs().max().item()
    return err, ref.abs().max().item(), got, ref


def main_path(dev, setting, make, b, grid=(4, 2)):
    """The engine's main path on one setting. The result also holds, in
    ``res["_state"]``, what the later phases reuse: the matrix, the
    session, its prepared values and f64 solve, and the selected blocks
    of the solve and of the dense inverse (see :func:`release`)."""
    import torch
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PSelInvEngine

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
    zero_counts()
    out = eng.solve(vals, dtype=torch.float64)
    torch.cuda.synchronize()
    launches = read_counts()["block_gemm"]
    if launches != gemm_ops:
        raise AssertionError(f"{setting}: {launches} block_gemm launches, "
                             f"plan has {gemm_ops} gemm ops")
    from repro_torch.kernels import block_gemm as bg
    variants = {" ".join(map(str, k)): c for k, c in bg.plans.items()}
    if any(k[0] != "dmma_f64" for k in bg.plans):
        raise AssertionError(f"{setting}: the f64 solve ran {variants}, "
                             "not only the DMMA variant")
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
    err, scale, got, ref = selected_error(out, eng, A, dev)
    nblk = got.shape[0]
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
               gemm_ops=gemm_ops, launches=launches, variants=variants,
               analyze_s_median=statistics.median(analyze_s),
               prepare_s_median=statistics.median(prepare_s),
               analyze_s=analyze_s, prepare_s=prepare_s, profile=prof,
               solve_ms_f64_median=statistics.median(solve_ms),
               solve_ms_f64=solve_ms, selected_blocks=nblk,
               max_err=err, max_ainv=scale, f32_rel=rel32,
               peak_gib=peak)
    log(f"{setting}: solve f64 {res['solve_ms_f64_median']:.1f} ms (median "
        f"of {[round(x, 1) for x in solve_ms]}, CUDA events, warm); "
        f"{launches} block_gemm launches = {gemm_ops} gemm ops "
        f"(variant, BN, A cp.async, B cp.async: {variants}); selected "
        f"{nblk} blocks max|Δ| {err:.3e} (max|A⁻¹| {scale:.3e}); repeated "
        f"solves bitwise equal; f32 vs f64 {rel32:.2e} · max|A⁻¹|; peak "
        f"{peak:.1f} GiB")
    res["_state"] = dict(A=A, eng=eng, vals=vals, out=out, got=got,
                         ref=ref, scale=scale,
                         solve_ms=res["solve_ms_f64_median"])
    del out32
    return res


def release(res):
    """Drop a setting's kept state (:func:`main_path`) from the card."""
    import torch
    from repro_torch.core.engine import PSelInvEngine

    res.pop("_state", None)
    PSelInvEngine.clear_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


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
# phase 3b: the level-serial and stream executors on phase 3's settings
# ---------------------------------------------------------------------------

EXECUTORS = ("level_serial", "stream")


def _options(name):
    from repro_torch.core.plan import PlanOptions
    return {"overlapped": PlanOptions(),
            "level_serial": PlanOptions(overlap=False),
            "stream": PlanOptions(stream=True)}[name]


def _events_ms(fn, reps=3):
    """Each of ``reps`` calls of ``fn`` between CUDA events; returns the
    times (ms) and the last call's result."""
    import torch
    times, out = [], None
    for _ in range(reps):
        out = None
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return times, out


def batch_check(eng, vals, what):
    """A bucketed batch of three value sets (the prepared values, and two
    exact power-of-two rescalings of them) against the three single
    solves, bitwise."""
    import torch
    from repro_torch.core.engine import SolveValues

    sets = [vals, SolveValues(vals.Lh * 0.5, vals.Dinv),
            SolveValues(vals.Lh, vals.Dinv * 2.0)]
    singles = [eng.solve(v, dtype=torch.float64) for v in sets]
    batch = eng.solve(SolveValues(torch.stack([v.Lh for v in sets]),
                                  torch.stack([v.Dinv for v in sets])),
                      dtype=torch.float64, bucket=True)
    torch.cuda.synchronize()
    for i, single in enumerate(singles):
        if not torch.equal(batch[i], single):
            raise AssertionError(f"{what}: batch item {i} differs from "
                                 "its single solve")
    del singles, batch


def padded_check(eng, vals, out, setting):
    """The stream with its level tables NK-padded, as the JAX stream runs
    them (every level's GEMM and diagonal einsum at the widest level's
    shape, the padded rows masked to zero), against the solve at each
    level's own nk: bitwise, one GEMM launch per planned GEMM."""
    import torch
    from repro_torch.core.pselinv_dist import make_sweep_stream

    st = eng.program.stream_tables
    zero_counts()
    padded = make_sweep_stream(eng.program, eng.tables, padded=True)(
        vals.Lh, vals.Dinv)
    torch.cuda.synchronize()
    launches = read_counts()["block_gemm"]
    if launches != eng.gemm_ops() or not torch.equal(padded, out):
        raise AssertionError(f"{setting} stream: NK-padded levels give "
                             f"other bits or {launches} GEMM launches")
    log(f"{setting} stream: NK={st.NK}-padded level tables give the same "
        f"bits as each level's own nk ({launches} GEMM launches)")


def executor_path(dev, setting, state, b, grid=(4, 2), batch=False):
    """Phase 3b: ``PlanOptions(overlap=False)`` and ``PlanOptions(
    stream=True)`` on the values phase 3 prepared (they do not depend on
    the executor): analyze s, solve ms (median of 3, CUDA events), one
    block-GEMM launch per planned GEMM (all on the DMMA variant),
    ppermute rounds and the stream's wire bytes. Fails unless the
    selected blocks are within 1e-10·max|A⁻¹| of the dense inverse, the
    stream is bitwise equal to the overlapped solve, the level-serial
    sweep within 1e-12·max|A⁻¹| of it, repeated solves bitwise equal and,
    with ``batch``, a bucketed batch of 3 bitwise equal to its single
    solves for each executor (the overlapped one too) and the NK-padded
    stream bitwise equal to the stream. Each executor's solve is traced
    once for its device-busy breakdown."""
    import torch
    from repro_torch.core.engine import Grid, PSelInvEngine
    from repro_torch.core.simulator import executed_wire_bytes
    from repro_torch.kernels import block_gemm as bg

    A, vals, out_ov = state["A"], state["vals"], state["out"]
    ref, scale = state["ref"], state["scale"]
    wire_ov = executed_wire_bytes(state["eng"])
    res = {}
    if batch:
        batch_check(state["eng"], vals, f"{setting} overlapped")
    for name in EXECUTORS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = PSelInvEngine.analyze(A, b=b, grid=Grid(*grid),
                                    options=_options(name), device=dev)
        torch.cuda.synchronize()
        analyze_s = time.perf_counter() - t0
        gemm_ops = eng.gemm_ops()
        zero_counts()
        out = eng.solve(vals, dtype=torch.float64)
        torch.cuda.synchronize()
        launches = read_counts()["block_gemm"]
        variants = {" ".join(map(str, k)): c for k, c in bg.plans.items()}
        if launches != gemm_ops:
            raise AssertionError(f"{setting} {name}: {launches} block_gemm "
                                 f"launches, plan has {gemm_ops} gemm ops")
        if any(k[0] != "dmma_f64" for k in bg.plans):
            raise AssertionError(f"{setting} {name}: the f64 solve ran "
                                 f"{variants}, not only the DMMA variant")
        solve_ms, again = _events_ms(
            lambda: eng.solve(vals, dtype=torch.float64))
        if not torch.equal(again, out):
            raise AssertionError(f"{setting} {name}: repeated solve differs")
        del again
        err = (selected_blocks(out, eng, dev) - ref).abs().max().item()
        if not err <= 1e-10 * scale:
            raise AssertionError(f"{setting} {name}: selected blocks max|Δ| "
                                 f"{err:.3e} > 1e-10 · max|A⁻¹| {scale:.3e}")
        vs_ov = (out - out_ov).abs().max().item()
        if name == "stream" and not torch.equal(out, out_ov):
            raise AssertionError(f"{setting} stream: not bitwise equal to "
                                 f"the overlapped solve (max|Δ| {vs_ov:.3e})")
        if not vs_ov <= 1e-12 * scale:
            raise AssertionError(f"{setting} {name}: max|Δ| {vs_ov:.3e} "
                                 f"from the overlapped solve > 1e-12 · "
                                 f"max|A⁻¹| {scale:.3e}")
        if batch:
            batch_check(eng, vals, f"{setting} {name}")
        if batch and name == "stream":
            padded_check(eng, vals, out, setting)
        log(f"{setting} {name}:")
        prof = profile_solve(eng, vals)
        st = eng.stats()
        r = dict(analyze_s=analyze_s, solve_ms=solve_ms,
                 solve_ms_median=statistics.median(solve_ms),
                 gemm_ops=gemm_ops, launches=launches, variants=variants,
                 ppermute_rounds=st["ppermute_rounds"],
                 peak_arena_blocks=st["peak_arena_blocks"],
                 table_bytes=st["table_bytes"], max_err=err,
                 vs_overlapped=vs_ov, batch_checked=batch, profile=prof)
        wire = ""
        if name == "stream":
            r["stream_wire_bytes"] = st["stream_wire_bytes"]
            r["stream_shifts_per_round"] = st["stream_shifts_per_round"]
            r["overlapped_wire_bytes"] = wire_ov
            wire = (f", stream wire {st['stream_wire_bytes']:.0f} B "
                    f"({st['stream_shifts_per_round']:.2f} slots a round; "
                    f"{st['stream_wire_bytes'] / wire_ov:.2f}x the "
                    f"overlapped executed wire {wire_ov:.0f} B)")
        log(f"{setting} {name}: analyze {analyze_s:.2f} s (host clock), "
            f"solve f64 {r['solve_ms_median']:.1f} ms (median of "
            f"{[round(x, 1) for x in solve_ms]}, CUDA events, against "
            f"{state['solve_ms']:.1f} ms overlapped); {launches} block_gemm "
            f"launches = {gemm_ops} gemm ops; {st['ppermute_rounds']} "
            f"ppermute rounds{wire}; selected max|Δ| {err:.3e}; "
            f"vs overlapped max|Δ| {vs_ov:.3e}"
            + (" (bitwise equal)" if name == "stream" else "")
            + "; repeated solve bitwise equal"
            + ("; batch of 3 bucketed to 4 bitwise equal to singles"
               if batch else ""))
        res[name] = r
        del out, eng
        PSelInvEngine.clear_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3c: the per-round profiling replay on the FEM setting
# ---------------------------------------------------------------------------

def profile_path(dev, setting, state, reps=3):
    """Phase 3c: ``engine.profile_rounds`` of phase 3's overlapped session
    (each round a segment fenced with ``torch.cuda.synchronize()``, the
    minimum of ``reps``). Fails unless it covers ``len(overlap_plan.
    rounds)`` rounds, its wire bytes equal ``executed_wire_bytes`` and
    its A⁻¹ equals the solve bitwise. Prints the five slowest rounds
    beside the α-β model's time for them (the simulator's default
    network, a Cray XC30 — a model, not this card), the sum of the
    segments against the fused solve, the inbound skew and the fitted
    α/β."""
    import torch
    from repro_torch.core.simulator import executed_wire_bytes

    eng, vals, out = state["eng"], state["vals"], state["out"]
    ov = eng.program.overlap_plan
    t0 = time.perf_counter()
    prof = eng.profile_rounds(vals, reps=reps, dtype=torch.float64)
    wall_s = time.perf_counter() - t0
    if prof.nrounds != len(ov.rounds) or len(prof.samples) != len(ov.rounds):
        raise AssertionError(f"profile: {prof.nrounds} rounds / "
                             f"{len(prof.samples)} segments, the plan has "
                             f"{len(ov.rounds)}")
    wire = executed_wire_bytes(eng.program)
    if prof.wire_bytes() != wire:
        raise AssertionError(f"profile: wire {prof.wire_bytes()} B, "
                             f"executed {wire} B")
    if not torch.equal(prof.ainv, out):
        raise AssertionError("profile: the replay's A⁻¹ differs from the "
                             "solve")
    slow = sorted(prof.samples, key=lambda s: -s.wall_us)[:5]
    seg_sum_ms = prof.wall_us / 1e3
    sk = prof.skew()
    alpha, beta = prof.fit_alpha_beta()
    comp = [s for s in prof.samples if not s.pure_comm]
    pure = [s for s in prof.samples if s.pure_comm]
    log(f"profile {setting}: {prof.nrounds} rounds (= plan), wire "
        f"{prof.wire_bytes():.0f} B (= executed_wire_bytes), A⁻¹ bitwise "
        f"equal to the solve; replay {wall_s:.1f} s host clock")
    for s in slow:
        log(f"  round {s.rounds[0]}: {s.wall_us:.1f} us measured, "
            f"{s.sim_us:.1f} us α-β model; {s.compute_ops} compute ops, "
            f"{s.msgs} lanes, {s.wire_bytes:.0f} wire B")
    log(f"  segments: init {prof.init_us:.1f} us + {len(prof.samples)} "
        f"rounds {sum(s.wall_us for s in prof.samples) / 1e3:.2f} ms "
        f"(with compute {sum(s.wall_us for s in comp) / 1e3:.2f} ms over "
        f"{len(comp)}, pure comm {sum(s.wall_us for s in pure) / 1e3:.2f} "
        f"ms over {len(pure)}) + final {prof.final_us:.1f} us = "
        f"{seg_sum_ms:.2f} ms fenced, against the fused solve "
        f"{state['solve_ms']:.2f} ms; α-β model total "
        f"{prof.sim_us / 1e3:.3f} ms")
    log(f"  inbound skew max/mean {sk['skew_ratio']:.3f} (PlanLint warns "
        f"past {sk['static_warn_threshold']}: "
        f"{'exceeded' if sk['exceeds_static_warn'] else 'ok'}); fitted "
        f"α {alpha * 1e6:.2f} us, β {beta * 1e9:.4f} ns/B")
    return dict(nrounds=prof.nrounds, wire_bytes=prof.wire_bytes(),
                replay_s=wall_s, init_us=prof.init_us,
                final_us=prof.final_us, segments_ms=seg_sum_ms,
                fused_solve_ms=state["solve_ms"], sim_ms=prof.sim_us / 1e3,
                compute_rounds_ms=sum(s.wall_us for s in comp) / 1e3,
                compute_rounds=len(comp),
                pure_comm_ms=sum(s.wall_us for s in pure) / 1e3,
                pure_comm_rounds=len(pure),
                slowest=[dict(round=s.rounds[0], wall_us=s.wall_us,
                              sim_us=s.sim_us, compute_ops=s.compute_ops,
                              msgs=s.msgs, wire_bytes=s.wire_bytes)
                         for s in slow],
                skew=sk, alpha_s=alpha, beta_s_per_byte=beta,
                timeline=prof.timeline())


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


# ---------------------------------------------------------------------------
# phase 5: the serial supernodal path (factorize + selinv) on the card
# ---------------------------------------------------------------------------

def serial_path(dev, blocks, max_supernode=96):
    """``factorize`` + ``selinv`` with the ``cuda`` and ``torch`` backends
    in f64 on the FEM matrix of phase 3, held against the dense inverse
    (1e-10·max|A⁻¹|) and the engine's f64 solve (1e-12·max|A⁻¹|) on every
    selected block; the ``cuda`` backend must launch trsm once per
    supernode with a non-empty struct (all of struct(K) stacked), every
    launch on the resident reciprocal-chain variant, and the block GEMM
    once per ``gemm``/``matmul`` of the host loop. The numpy backend runs
    once on the same host as the yardstick, and one traced ``cuda`` run
    splits its time."""
    import numpy as np
    import torch
    from repro_torch.core.selinv import selinv
    from repro_torch.core.supernodal_lu import factorize
    from repro_torch.core.symbolic import symbolic_factorize
    from repro_torch.kernels import trsm as tk

    A, eng_blk, ref_blk = blocks["A"], blocks["got"], blocks["ref"]
    bs = symbolic_factorize(A, max_supernode=max_supernode)
    keys = selected_keys(bs)
    if len(keys) != ref_blk.shape[0]:
        raise AssertionError(f"serial: {len(keys)} selected blocks, the "
                             f"engine gathered {ref_blk.shape[0]}")
    sizes = [len(s) for s in bs.struct]
    with_struct = sum(1 for c in sizes if c)
    # factorize: one stacked trsm per supernode with a non-empty struct
    # and |struct(K)|² Schur updates; selinv: 2 matmuls and 1 gemm per
    # supernode with a non-empty struct
    want = {"trsm": with_struct,
            "block_gemm": sum(c * c for c in sizes) + 3 * with_struct}
    scale = ref_blk.abs().max().item()
    res = dict(n=A.shape[0], nsuper=bs.nsuper, blocks=len(keys),
               max_struct=max(sizes), want_launches=want, backends={})

    def run(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu = factorize(A, bs=bs, backend=backend, device=dev,
                       dtype=torch.float64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Ainv = selinv(lu)
        torch.cuda.synchronize()
        return Ainv, t1 - t0, time.perf_counter() - t1

    for backend in ("cuda", "torch"):
        zero_counts()
        Ainv, fs, ss = run(backend)
        counts = read_counts()
        got = torch.stack([torch.from_numpy(Ainv[k]) for k in keys]).to(dev)
        e_ref = (got - ref_blk).abs().max().item()
        e_eng = (got - eng_blk).abs().max().item()
        if not (e_ref <= 1e-10 * scale and e_eng <= 1e-12 * scale):
            raise AssertionError(
                f"serial {backend}: max|Δ| {e_ref:.3e} vs the dense inverse,"
                f" {e_eng:.3e} vs the engine (max|A⁻¹| {scale:.3e})")
        expect = want if backend == "cuda" else {"trsm": 0, "block_gemm": 0}
        if any(counts[n] != c for n, c in expect.items()):
            raise AssertionError(f"serial {backend}: launches {counts}, "
                                 f"expected {expect}")
        variants = dict(tk.plans)
        if backend == "cuda" and variants != {"rcp_resident": want["trsm"]}:
            raise AssertionError(f"serial cuda: trsm variants {variants}, "
                                 f"expected every launch on rcp_resident")
        res["backends"][backend] = dict(factorize_s=fs, selinv_s=ss,
                                        err_dense=e_ref, err_engine=e_eng,
                                        launches=counts, variants=variants)
        log(f"serial {backend}: factorize {fs:.2f} s + selinv {ss:.2f} s "
            f"(host clock); {len(keys)} blocks max|Δ| {e_ref:.3e} vs the "
            f"dense inverse, {e_eng:.3e} vs the engine (max|A⁻¹| "
            f"{scale:.3e}); launches trsm {counts['trsm']} {variants}, "
            f"block_gemm {counts['block_gemm']}")
        del Ainv, got

    t0 = time.perf_counter()
    lu = factorize(A, bs=bs, backend="numpy")
    t1 = time.perf_counter()
    selinv(lu)
    res["numpy"] = dict(factorize_s=t1 - t0,
                        selinv_s=time.perf_counter() - t1)
    log(f"serial numpy (host yardstick): factorize "
        f"{res['numpy']['factorize_s']:.2f} s + selinv "
        f"{res['numpy']['selinv_s']:.2f} s")
    res["split"] = serial_split(dev, A, bs, run)
    res["trsm_stacks"] = serial_trsm_stacks(dev, A, bs)
    return res


def serial_trsm_stacks(dev, A, bs):
    """The serial path's trsm work as a whole: the stacked solves (one per
    supernode with a non-empty struct) recorded from one ``cuda``
    factorize, then run back to back through the kernel and through
    ``torch.linalg.solve_triangular`` (CUDA events, mean of 5 passes, and
    the profiler's device time), beside the bound summed over the
    stacks. These launches come after the path's counts were read."""
    import torch
    from repro_torch.core.supernodal_lu import factorize
    from repro_torch.kernels import ops
    from repro_torch.kernels import trsm as tk

    stacks, orig = [], ops.trsm

    def record(b, u):
        stacks.append((b.clone(), u.clone()))
        return orig(b, u)

    ops.trsm = record
    try:
        factorize(A, bs=bs, backend="cuda", device=dev, dtype=torch.float64)
    finally:
        ops.trsm = orig
    torch.cuda.synchronize()

    def kernel():
        return [tk.trsm(b, u) for b, u in stacks]

    def library():
        return [torch.linalg.solve_triangular(u, b, upper=True, left=False)
                for b, u in stacks]

    err = max((x - y).abs().max().item()
              for x, y in zip(kernel(), library()))
    t_bytes = t_ops = bound = 0.0
    for b, u in stacks:
        m, k = b.shape
        nbytes, nops = (2 * m * k + k * k) * b.element_size(), m * k * k
        bound += _bound(nbytes, nops, "float64")[0]
        t_bytes += nbytes / HBM_BYTES_PER_S * 1e3
        t_ops += nops / PEAK_FLOPS["float64"] * 1e3
    rows = [b.shape[0] for b, _ in stacks]
    out = dict(stacks=len(stacks), rows_min=min(rows), rows_max=max(rows),
               k=stacks[0][1].shape[0], ms=timed_ms(kernel),
               device_ms=device_ms(kernel), library_ms=timed_ms(library),
               library_device_ms=device_ms(library), bound_ms=bound,
               bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
               max_abs_err_vs_library=err)
    log(f"serial trsm, all {len(stacks)} stacks ({min(rows)}-{max(rows)} "
        f"rows x {out['k']}, f64): kernel {out['ms']:.3f} ms (device "
        f"{out['device_ms']:.3f}), solve_triangular {out['library_ms']:.3f}"
        f" ms (device {out['library_device_ms']:.3f}), bound {bound:.4f} ms "
        f"(sum over the stacks; bytes {t_bytes:.4f}, operations "
        f"{t_ops:.4f}), max|Δ| vs the library {err:.2e}")
    return out


def serial_split(dev, A, bs, run):
    """Where the ``cuda`` backend's serial time goes: one traced run's
    device-busy time by kernel against its wall, beside the host's own
    parts timed alone — the per-K dense LU of the diagonal blocks and the
    reads of the blocks out of the CSR matrix."""
    import scipy.sparse as sp
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import supernodal_lu as slu

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        _, fs, ss = run("cuda")
    classes = {}
    for ev in p.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t <= 0 or ev.key.startswith("aten::"):
            continue
        c = ("block_gemm" if "block_gemm_kernel" in ev.key else
             "trsm" if "trsm_kernel" in ev.key else
             "memcpy" if "emcpy" in ev.key else "other")
        classes[c] = classes.get(c, 0.0) + t / 1e6
    # the blocks factorize reads out of the CSR matrix (each once: its
    # working store caches them)
    need = set()
    for K in range(bs.nsuper):
        C = [int(i) for i in bs.struct[K]]
        need.add((K, K))
        need.update((I, J) for I in C for J in C)
        need.update(x for I in C for x in ((I, K), (K, I)))
    Acsr = sp.csr_matrix(A)
    t0 = time.perf_counter()
    diag = {k: slu._get_block(Acsr, bs, *k) for k in need}
    read_s = time.perf_counter() - t0
    loaded = len(need)
    t0 = time.perf_counter()
    for K in range(bs.nsuper):
        slu.dense_lu_nopivot(diag[(K, K)])
    lu_s = time.perf_counter() - t0
    out = dict(traced_wall_s=fs + ss, device_s=classes,
               csr_block_reads_s=read_s, csr_block_reads=loaded,
               diag_lu_s=lu_s)
    log(f"serial split (cuda, traced): wall {fs + ss:.2f} s, device busy "
        + ", ".join(f"{c} {t:.3f} s" for c, t in sorted(classes.items()))
        + f"; host alone: {loaded} CSR block reads {read_s:.2f} s, dense "
        f"LU of {bs.nsuper} diagonal blocks {lu_s:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6: the ops entry points, through the port's kernel benchmark
# ---------------------------------------------------------------------------

# the ops entry points at the widths of configs/qwen3_32b.py, as a
# (B, S, …) caller passes them: RMSNorm over d_model and over head_dim
# (qk-norm), causal attention over 64 heads of 128
OPS_MAIN = dict(rms=[(1, 4096, 5120), (1, 4096, 64, 128)],
                flash=(1, 4096, 64, 128))


def ops_path(dev, main=OPS_MAIN):
    """``repro_torch.kernels.bench.run`` — the twin of
    ``benchmarks/kernels_bench.py``, the JAX package's only driver of
    ``ops.rmsnorm`` and ``ops.flash_attention`` besides the tests — then
    ``ops.rmsnorm`` and ``ops.flash_attention`` at qwen3-32b's widths in
    bf16; every output held against its plain version with the kernel
    phase's tolerances, every count zeroed before and read after."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import bench
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import trsm as tk

    tols = {"block_gemm": (TOL, BF16_TOL), "trsm": (TRSM_TOL, BF16_TOL),
            "rmsnorm": (RMS_TOL, BF16_TOL),
            "flash_attention": (FLASH_TOL, FLASH_BF16_TOL)}
    held = []

    def check(kernel, out, plain, what="bench"):
        name = str(out.dtype).replace("torch.", "")
        err, used = check_close(kernel, out, plain, name, f"ops {what}",
                                *tols[kernel])
        held.append(dict(kernel=kernel, what=what, dtype=name,
                         max_abs_err=err, tol_used=used))

    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    zero_counts()
    rows = bench.run(full=True, device=dev, check=check)
    for shape in main["rms"]:
        x, sc = randn(*shape), randn(shape[-1])
        check("rmsnorm", ops.rmsnorm(x, sc), rk.rmsnorm_plain(x, sc),
              "x".join(map(str, shape)))
        del x
    q, k, v = (randn(*main["flash"]) for _ in range(3))
    check("flash_attention", ops.flash_attention(q, k, v, causal=True),
          fa.flash_attention_plain(q, k, v, True),
          "x".join(map(str, main["flash"])) + " causal")
    torch.cuda.synchronize()
    counts = read_counts()
    variants = {"flash_attention": dict(fa.plans),
                "rmsnorm": dict(rk.plans), "trsm": dict(tk.plans),
                "block_gemm": {" ".join(map(str, k)): c
                               for k, c in bg.plans.items()}}
    del q, k, v
    torch.cuda.empty_cache()
    if any(c == 0 for c in counts.values()):
        raise AssertionError(f"ops path: a kernel never launched: {counts}")
    if not fa.plans["hmma_cpasync"]:
        raise AssertionError(f"ops path: bf16 flash attention never ran on "
                             f"the tensor cores: {variants}")
    log(f"ops path (kernels bench + qwen3-32b widths): launches {counts}; "
        f"variants {variants}; "
        + ", ".join(f"{h['kernel']} {h['what']} {h['dtype']} max|Δ| "
                    f"{h['max_abs_err']:.2e} ({h['tol_used']:.3f} of the "
                    "tolerance)" for h in held))
    return dict(rows=rows, launches=counts, variants=variants, held=held)


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
    t_start = time.perf_counter()
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
    libs = _build.build(KERNELS)     # one nvcc per source, all at once
    for name in KERNELS:
        _build.load(name)
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s; SASS and ptxas per instance:")
    sass, ptxas = compiled_checks(libs, _build.build_logs)
    for name in ("trsm", "rmsnorm"):
        for k, v in ptxas.get(name, {}).items():
            log(f"  {name} {k}: ptxas {v.get('registers')} registers, "
                f"spills {v.get('spill_stores')}/{v.get('spill_loads')} B")

    rows = kernel_checks(dev)
    new_rows = trsm_checks(dev) + rmsnorm_checks(dev) + flash_checks(dev)
    # phase 3, then 3b (the other executors) on each setting's prepared
    # values, and 3c (the per-round replay) on the FEM setting
    fem = main_path(dev, "fem3d_like(16,16,16,3)",
                    lambda: sparse.fem3d_like_matrix(16, 16, 16, 3), 96)
    fem["executors"] = executor_path(dev, fem["setting"], fem["_state"], 96,
                                     batch=True)
    fem["round_profile"] = profile_path(dev, fem["setting"], fem["_state"])
    blocks = {k: fem["_state"][k] for k in ("A", "got", "ref")}
    release(fem)
    dg = main_path(dev, "dg_like(32,32,16)",
                   lambda: sparse.dg_like_matrix(32, 32, 16), 128)
    dg["executors"] = executor_path(dev, dg["setting"], dg["_state"], 128)
    release(dg)
    settings = [fem, dg]
    serial = serial_path(dev, blocks)
    del blocks
    batched_path(dev)
    ops = ops_path(dev)
    for r in rows + new_rows:    # ptxas's report of the instance each ran
        if "symbol" in r:
            lib = next(n for n in KERNELS
                       if r["symbol"].startswith(n.split("_")[0]))
            r["ptxas"] = ptxas.get(lib, {}).get(r["symbol"])

    head = next(r for r in rows if r["setting"] == "fem"
                and r["dtype"] == "float64" and r["n"] == 14 * 96)
    heads = {  # each new kernel's row at the shape its path gives it
        "trsm": ("96x96", "float64", None),
        "rmsnorm": ("4096x5120", "bfloat16", None),
        "flash_attention": ("1x4096x64x128", "bfloat16", True),
    }
    # each kernel's launches by variant on its main path, from the plans
    # dicts as that path left them
    variants = {"block_gemm": {
                    **{s_["setting"]: s_["variants"] for s_ in settings},
                    **{f"{s_['setting']} {ex}": r["variants"]
                       for s_ in settings
                       for ex, r in s_["executors"].items()}},
                "trsm": {"serial": serial["backends"]["cuda"]["variants"],
                         "ops": ops["variants"]["trsm"]},
                "rmsnorm": ops["variants"]["rmsnorm"],
                "flash_attention": ops["variants"]["flash_attention"]}
    launches = {
        "block_gemm": sum(s_["launches"] for s_ in settings)
        + sum(r["launches"] for s_ in settings
              for r in s_["executors"].values())
        + serial["backends"]["cuda"]["launches"]["block_gemm"]
        + ops["launches"]["block_gemm"],
        "trsm": serial["backends"]["cuda"]["launches"]["trsm"]
        + ops["launches"]["trsm"],
        "rmsnorm": ops["launches"]["rmsnorm"],
        "flash_attention": ops["launches"]["flash_attention"],
    }
    replaces = {"block_gemm": "src/repro/kernels/block_gemm.py:43",
                "trsm": "src/repro/kernels/trsm.py:37",
                "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
                "flash_attention": "src/repro/kernels/flash_attention.py:66"}
    kernels = [{
        "name": "block_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_gemm.cu",
        "replaces": replaces["block_gemm"],
        "launches": launches["block_gemm"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": f"Z={head['Z']} m={head['m']} k={head['k']} "
                 f"n={head['n']} float64",
        "variant": head["variant"], "tile": head["tile"],
        "variants": variants["block_gemm"], "ptxas": head.get("ptxas"),
    }]
    for name, (shape, dt, causal) in heads.items():
        r = next(r for r in new_rows if r["kernel"] == name
                 and r["shape"] == shape and r["dtype"] == dt
                 and r.get("causal") == causal)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "shape": f"{shape} {dt}"
                     + ("" if causal is None else f" causal={causal}"),
            "variant": r["variant"], "tile": r["tile"],
            "variants": variants[name], "ptxas": r.get("ptxas")})
    wall_s = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "wall_s": wall_s, "kernel_rows": rows, "new_kernel_rows": new_rows,
         "main_path": settings, "serial": serial, "ops_path": ops,
         "sass": sass, "ptxas": ptxas, "kernels": kernels}, indent=1,
        default=str))
    log(f"total wall {wall_s:.1f} s (host clock, build included)")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
