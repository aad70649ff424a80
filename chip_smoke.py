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
   (``F.scaled_dot_product_attention``); and both at the shapes phase 10
   gives them (granite-3-2b's decode and prefill rows, qwen3-32b's
   qk-norm rows, granite's (1, 2048, 32, 64) prefill attention);
3. runs the main path — ``PSelInvEngine.analyze`` → ``prepare_values`` →
   the session's eager sweep on grid 4×2 — on the FEM-like (audikw_1
   stand-in) and DG-like (DG_PNF14000 stand-in) matrices at full size,
   and checks the selected blocks against a dense f64 inverse computed on
   the card, bitwise-equal repeated solves, one kernel launch per planned
   GEMM op, every f64 launch on the DMMA variant, and the f32 solve
   against the f64 one;
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
3d. solves through ``engine.solve`` on each setting and executor: the
   single-matrix f64 class captured once as a CUDA graph, every replay
   bitwise equal to the eager sweep, one block-GEMM node per planned GEMM
   in the graph (all on the DMMA variant), eager and replayed solves
   timed in turns, a replay traced for its busy share;
3e. lints each setting's executors (``engine.lint_compiled``, f64): the op
   layer and the executed permutes of one eager sweep and the permutes
   recorded while phase 3d captured the graph, held to the plan — no
   ERROR diagnostic, recorded wire blocks = the plan's, the graph's
   block-GEMM nodes = ``gemm_ops()`` — with the lint's wall and op
   counts; then a Laplacian session whose permute helper retargets one
   pair must fail its lint on the card;
3f. runs the legacy unrolled sweep (``build_program_unrolled`` →
   ``make_sweep_unrolled``: per supernode, the broadcast of the whole Û
   buffer and the reduction of the whole partial round by round, one
   block-GEMM launch) on each setting's prepared f64 values: one eager
   and one timed solve, its rounds against the host program (1805 /
   3321), one launch per supernode with a struct (127 / 127) on the DMMA
   variant, the selected blocks against the dense inverse, the solve
   within 1e-12·max|A⁻¹| of the overlapped one, a traced solve's busy
   share;
4. runs the serial path — ``factorize`` + ``selinv`` with the ``cuda`` and
   ``torch`` backends in f64 — on the FEM matrix, against the dense
   inverse and the engine's solve, with one trsm launch per supernode
   (all of struct(K) stacked, on the resident variant) and one block-GEMM
   launch per host-loop product, beside the numpy backend's time, a
   traced split of where the time goes, and all of the path's stacked trsm
   solves timed through the kernel and ``torch.linalg.solve_triangular``
   beside their summed bound;
5. serves through ``SelInvServer`` on grid 4×2: (a) 16 full-size FEM
   requests (phase 3's values for αᵢ·A) in bursts that coalesce into the
   buckets 1, 2 and 4, each result bitwise its eager single solve and
   within 1e-12·max|A⁻¹/αᵢ| of A⁻¹/αᵢ, one capture per bucket, latency,
   occupancy and per-matrix times; (b) the traffic harness
   (``serve.traffic.run_traffic``: 64 requests over 2 structures, f64);
   (c) a request with a pattern outside its structure failing alone;
6. checks a bucketed ``solve_many`` against single solves, bitwise;
7. drives the ``ops`` entry points through the port's kernel benchmark
   (``repro_torch.kernels.bench``) and, for RMSNorm and flash attention,
   at qwen3-32b's widths in bf16, every output held against its plain
   version, every kernel launched and bf16 flash on the tensor cores;
8. right after phase 3 on FEM, runs its f64 solve by 8 rank processes on
   the one card (``comm.p2p.spawn``, gloo, CUDA payloads staged through
   pinned host memory; kernels built in this process first): every rank
   analyzes, takes its prepared shards from a temporary directory and
   runs the ranked overlapped sweep three times barrier to barrier; each
   rank's A⁻¹ shard against phase 3's (sha1, else max|Δ| within
   1e-12·max|A⁻¹| with the differing op isolated), 35 block-GEMM launches
   a rank a solve on the DMMA variant, the sent bytes against the
   session's moved bytes, time in rounds against the rest; then the
   paper's level-serial sweep by the same ranks (``make_sweep_ranked``,
   every tree round a point-to-point message): a warm-up and two solves
   barrier to barrier, each rank's shard against the single-process level-serial
   solve (sha1, else max|Δ| within 1e-12·max|A⁻¹|), the sent bytes
   against the plan's wire and every rank's send log held to the plan
   round by round (``exec_verify.lint_ranked``); then the legacy
   unrolled sweep by the same ranks (``make_sweep_unrolled_ranked``,
   each round one message of the JAX round's payload) on
   ``laplacian_2d(32, 8)`` at b=8 (222 rounds) and on the FEM values
   (1805 rounds), a warm-up and one solve each: each shard against a
   single-process unrolled solve (sha1, else max|Δ| within
   1e-12·max|A⁻¹|), the sent bytes against the bytes reckoned from the
   rounds, the wall, the time on the wire and waiting for the card; then
   ``subset_broadcast``, ``subset_reduce`` and ``tree_allreduce`` on
   64 MiB of integer-valued f32 a rank, exact, with wall and GB/s;
9b. runs ``python -m repro_torch.benchmarks.run --only
   kernels,selinv,treecomm --json build/bench_torch.json`` on the card:
   it must exit 0 with every row ``tools.record_bench`` requires; prints
   the three speed ratios the JAX bench asserts on a CPU host and whether
   each met its bar here; loads the size baseline from the committed
   ``BENCH_pselinv_torch.json`` (``exec_verify.load_size_baseline``, its
   newest card entry) and lints the nb=16 4×2 f32 stream class on the
   card against it: no diagnostic;
10. runs the LM stack's serving path (``repro_torch.models``,
   ``runtime.ServeEngine``, ``launch.serve``) with RMSNorm and prefill
   attention on the hand-written kernels: (a) granite-3-2b at its full
   published size (40 layers, 2.53 B params, the port's seeded f32 init
   cast once to bf16) — a (1, 2048) prefill (40 flash launches on the tensor
   cores), 16 teacher-forced decode steps held against the prefill's
   logits, 81 RMSNorm launches a step, and the same through the plain
   versions held against the kernel route; (b) 16 requests served by
   ``ServeEngine`` (8 slots, a 2048-token cache, 32 new tokens each):
   every request complete, decode-step p50/p95, tokens/s, a traced
   step's busy share (only from a trace that holds all 81 of its RMSNorm
   kernels), peak memory; and ``python -m
   repro_torch.launch.serve --arch granite-3-2b --scale full`` exiting 0;
   (c) qwen3-32b at full width with its depth cut to 2 layers (qk-norm
   on 128-wide rows, head_dim 128, untied unembedding) at S = 4096, the
   checks of (a) with 9 RMSNorm launches a step (the RMSNorm and flash
   kernels are held against their plain versions at the shapes this path
   gives them in phase 2b);
11. runs the other LM families at their full published widths through
   the same entry points, each from the port's seeded init in bf16, its
   depth (jamba: and experts) cut to fit the card and printed as
   ``reduced:``: (a) dbrx-132b, 4 layers; (b) grok-1-314b, 2 layers; (c)
   jamba-1.5-large-398b, one 8-layer period with 4 of 16 experts; (d)
   xlstm-125m at full size; (e) seamless-m4t-large-v2 at full size, 24 +
   24 layers, frames (1, 1024, 1024) and tokens (1, 256). Each: a prefill
   with its flash launches counted (all on the tensor cores) and its
   RMSNorm launches; 16 teacher-forced decode steps held against the
   prefill's logits (xlstm-125m, whose batch-global stabiliser makes them
   differ by design: to 1.1 × the JAX package's own gap on the same
   weights and tokens, measured on the CPU by ``tests/xlstm_decode_gap.py``;
   its sLSTM layers alone to the tolerance);
   the same through the plain versions against the kernel route; the
   RMSNorm launches of every step against the family's formula; prefill
   and decode-step ms and peak memory. MoE routings that flip at a
   near-tie (``moe.route_flips``: the k-th/(k+1)-th margin under twice
   the probability noise between the two runs) are printed and the
   positions whose routing differs left out (kernels against plain; a
   decode from its first flip on). Then
   ``ServeEngine`` on dbrx (as (a), twice: the tokens bitwise equal, the
   slots dropped by capacity per step) and on xlstm-125m, 16 requests on 8
   slots of a 2048-token cache, and ``python -m repro_torch.launch.serve
   --arch xlstm-125m --scale full`` exiting 0;
9. writes every measured row to ``build/chip_smoke.json`` and prints the
   kernels' JSON line, the total wall time, the card line and, last, the
   result.

Every launch count is zeroed right before its path runs and read right
after it (in each rank process for phase 8). Every failed check raises and the script exits non-zero; without a CUDA
device, or outside a checkout, it exits non-zero before printing any
result. Numbers from this script are the only ones quoted for the port.
"""
from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# when this module was imported: in a phase-8 rank process, its start
_IMPORTED = time.time()
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


def kernels_per_call(fn, tries=3):
    """The kernels the card runs for one ``fn()`` (torch.profiler). The
    profiler can lose the kernels launched through ctypes: a window that
    holds no kernel is logged and traced again, up to ``tries`` windows;
    a window with any kernel in it is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ran = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ran:
            return ran
        log(f"  profiler window {i + 1} of {tries} held no kernel")
    return ran


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
    # first solve, read right after it (phases 3–3c run the eager sweep,
    # launch by launch; phase 3d the same sweep as a CUDA-graph replay)
    zero_counts()
    out = eager_solve(eng, vals, torch.float64)
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
        again = eager_solve(eng, vals, torch.float64)
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
    prof = profile_solve(lambda: eager_solve(eng, vals, torch.float64))
    out32 = eager_solve(eng, vals, torch.float32)
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


def eager_solve(eng, vals, dtype):
    """The session's eager sweep (``engine.sweep``) on ``vals`` cast to
    ``dtype``: every kernel launched from Python, counted and timed as
    in PR 15. ``engine.solve`` replays the same sweep from a CUDA graph
    (phase 3d)."""
    Lh, Dinv = (eng._as_tensor(v, dtype) for v in vals)
    return eng.sweep(Lh.ndim == 6)(Lh, Dinv)


def trace_device(fn, classify, warm=0):
    """One ``fn()`` traced (torch.profiler), its wall on CUDA events taken
    inside the traced window; with ``warm``, that many calls of ``fn``
    before it run under the profiler's warm-up (traced, discarded).
    ``classify`` maps a kernel's name to its class. Returns the wall
    (µs), device time (µs) and kernels recorded by class, and the kernels
    as (µs, count, name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=1)
                 if warm else None) as p:
        for _ in range(warm):
            fn()
            torch.cuda.synchronize()
            p.step()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
    wall_us = s.elapsed_time(e) * 1e3
    classes, counts, kernels = {}, {}, []
    for ev in p.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        # the schedule's step annotation carries the step's span
        if t <= 0 or ev.key.startswith(("aten::", "ProfilerStep")):
            continue
        c = classify(ev.key)
        classes[c] = classes.get(c, 0.0) + t
        counts[c] = counts.get(c, 0) + ev.count
        kernels.append((t, ev.count, ev.key[:90]))
    return wall_us, classes, counts, kernels


_CUBLAS = ("gemm", "Gemm", "cutlass", "xmma", "sm90", "nvjet", "cublas")
_GEMM_CLASS = "block_gemm (hand-written)"


def _solve_class(k):
    if "block_gemm_kernel" in k:
        return _GEMM_CLASS
    if any(x in k for x in _CUBLAS):
        return "cuBLAS (scomp einsum)"
    if "ndex" in k or "catter" in k or "ather" in k:
        return "gather / scatter / index_add"
    if "emcpy" in k or "emset" in k:
        return "memcpy / memset"
    return "elementwise (where, sub, transpose copies, zeros)"


def profile_solve(solve):
    """Device time of one f64 solve (``solve()``) by kernel class
    (:func:`trace_device`), against the solve's wall: the busy share and
    where it goes, and the block-GEMM kernels the card ran."""
    wall_us, classes, counts, kernels = trace_device(solve, _solve_class)
    gemm_calls = counts.get(_GEMM_CLASS, 0)
    busy = sum(classes.values())
    if busy <= 0:
        log("  profile: the profiler recorded no device time — breakdown "
            "not measured")
        return {"wall_us": wall_us, "busy_us": None, "gemm_calls": None}
    log(f"  profile (one f64 solve, traced): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %)")
    for c, t in sorted(classes.items(), key=lambda x: -x[1]):
        log(f"    {c}: {t / 1e3:.1f} ms ({100 * t / busy:.1f} % of busy)")
    for t, cnt, k in sorted(kernels, reverse=True)[:6]:
        log(f"    top kernel {t / 1e3:.1f} ms x{cnt}: {k}")
    return {"wall_us": wall_us, "busy_us": busy, "classes_us": classes,
            "gemm_calls": gemm_calls,
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


def value_sets(vals):
    """The prepared values and two exact power-of-two rescalings."""
    from repro_torch.core.engine import SolveValues
    return [vals, SolveValues(vals.Lh * 0.5, vals.Dinv),
            SolveValues(vals.Lh, vals.Dinv * 2.0)]


def batch_check(eng, vals, what):
    """A batch of three value sets (:func:`value_sets`) padded with a zero
    lane to the bucket of 4, as ``solve(bucket=True)`` pads it, through
    the eager batched sweep, against the three eager single solves,
    bitwise."""
    import torch

    sets = value_sets(vals)
    singles = [eager_solve(eng, v, torch.float64) for v in sets]
    Lh, Dinv = (torch.stack([getattr(v, f) for v in sets]
                            + [torch.zeros_like(vals.Lh)])
                for f in ("Lh", "Dinv"))
    batch = eng.sweep(batched=True)(Lh, Dinv)[:3]
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


def executor_path(dev, setting, state, b, grid=(4, 2), batch=False,
                  captures=None):
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
    once for its device-busy breakdown. With ``captures`` (a dict), phase
    3d runs on each executor, the overlapped one included, and fills it
    by executor name, each entry with phase 3e's lint under ``"lint"``."""
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
    if captures is not None:
        captures["overlapped"] = capture_path(setting, "overlapped",
                                              state["eng"], vals, out_ov)
        captures["overlapped"]["lint"] = lint_path(setting, "overlapped",
                                                   state["eng"])
    for name in EXECUTORS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = PSelInvEngine.analyze(A, b=b, grid=Grid(*grid),
                                    options=_options(name), device=dev)
        torch.cuda.synchronize()
        analyze_s = time.perf_counter() - t0
        gemm_ops = eng.gemm_ops()
        zero_counts()
        out = eager_solve(eng, vals, torch.float64)
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
            lambda: eager_solve(eng, vals, torch.float64))
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
        if captures is not None:
            captures[name] = capture_path(setting, name, eng, vals, out)
            captures[name]["lint"] = lint_path(setting, name, eng)
        log(f"{setting} {name}:")
        prof = profile_solve(lambda: eager_solve(eng, vals, torch.float64))
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
# phase 3d: each executor's solve captured as a CUDA graph and replayed
# ---------------------------------------------------------------------------

def capture_path(setting, name, eng, vals, eager_out):
    """Phase 3d: ``engine.solve`` of the single-matrix f64 class on phase
    3's values. Its first call runs the sweep once eagerly (warm-up),
    captures it as a CUDA graph and replays it; each later call copies
    the values in, replays and copies A⁻¹ out. Fails unless every replay
    is bitwise the eager sweep (``eager_out``), the wrapper launched the
    block GEMM twice a planned GEMM (warm-up, capture) and no more, and
    the graph holds one block-GEMM kernel node a planned GEMM (the
    driver's view of the graph), each planned on the DMMA variant. Times
    eager solves and replays in turns (median of 3 each, CUDA events) and
    traces one replay for its busy share and the block-GEMM kernels the
    profiler recorded."""
    import torch

    gemm_ops = eng.gemm_ops()
    zero_counts()
    t0 = time.perf_counter()
    out = eng.solve(vals, dtype=torch.float64)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()["block_gemm"]
    run = eng._fns[(False, 1, torch.float64)]
    plans = {" ".join(map(str, k)): c for k, c in run.gemm_plans.items()}
    what = f"{setting} {name} capture"
    if not torch.equal(out, eager_out):
        raise AssertionError(f"{what}: the replay differs from the eager "
                             "sweep")
    if (launches, run.gemm_launches, run.gemm_nodes) != (
            2 * gemm_ops, gemm_ops, gemm_ops):
        raise AssertionError(
            f"{what}: {launches} wrapper launches (expected {2 * gemm_ops}"
            f"), {run.gemm_launches} captured, {run.gemm_nodes} GEMM nodes "
            f"in the graph; the plan has {gemm_ops} gemm ops")
    if any(k[0] != "dmma_f64" for k in run.gemm_plans):
        raise AssertionError(f"{what}: the graph's GEMMs are planned "
                             f"{plans}, not only on the DMMA variant")
    del out
    eager_ms, replay_ms = [], []
    for _ in range(3):      # in turns: eager, replay
        t, e = _events_ms(lambda: eager_solve(eng, vals, torch.float64), 1)
        eager_ms += t
        del e
        t, r = _events_ms(lambda: eng.solve(vals, dtype=torch.float64), 1)
        replay_ms += t
        if not torch.equal(r, eager_out):
            raise AssertionError(f"{what}: a later replay differs")
        del r
    # the profiler's kernel records of a replay are a second lens only:
    # in a replay of ~20k kernels (DG level-serial) it lost one GEMM's
    # record, while the graph itself holds all of them (the census above)
    log(f"{setting} {name} replay:")
    prof = profile_solve(lambda: eng.solve(vals, dtype=torch.float64))
    st = eng.stats()
    r = dict(first_solve_s=first_s, warmup_ms=run.warmup_ms,
             capture_ms=run.capture_ms, graph_kernels=run.graph_kernels,
             graph_gemm_nodes=run.gemm_nodes, gemm_ops=gemm_ops,
             launches=launches, plans=plans, eager_ms=eager_ms,
             replay_ms=replay_ms,
             eager_ms_median=statistics.median(eager_ms),
             replay_ms_median=statistics.median(replay_ms),
             graph_bytes=st["graph_bytes"],
             graph_replays=st["graph_replays"], profile=prof)
    busy = ("not measured" if prof["busy_us"] is None else
            f"{100 * prof['busy_us'] / prof['wall_us']:.1f} %")
    log(f"{setting} {name} capture: first solve {first_s:.2f} s (warm-up "
        f"{run.warmup_ms:.0f} ms + capture {run.capture_ms:.0f} ms, host "
        f"clock); graph {run.graph_kernels} kernel nodes, "
        f"{run.gemm_nodes} block-GEMM nodes = {gemm_ops} gemm ops "
        f"({plans}), traced replay ran {prof['gemm_calls']}; replay "
        f"bitwise equal to the eager sweep; solve eager "
        f"{r['eager_ms_median']:.1f} ms vs replay "
        f"{r['replay_ms_median']:.1f} ms (medians of "
        f"{[round(x, 1) for x in eager_ms]} / "
        f"{[round(x, 1) for x in replay_ms]}, CUDA events, in turns); "
        f"replay busy {busy}; graph memory {st['graph_bytes'] / 2**30:.2f}"
        f" GiB")
    return r


# ---------------------------------------------------------------------------
# phase 3e: the executed-communication verifier on the card
# ---------------------------------------------------------------------------

def lint_path(setting, name, eng):
    """Phase 3e: ``engine.lint_compiled`` of the single-matrix f64
    class, whose graph phase 3d captured: one eager sweep on zero values
    under the recorder and the op layer, and the permutes recorded at the
    capture, each held to the plan, and the session's device index
    tables to the host lists the records are made from. Fails on any
    ERROR diagnostic, on recorded wire blocks other than the plan's (the
    stream's: its landed blocks), on a layer that did not record every
    planned permute (the stream: every landing slot at its step), and on
    graph block-GEMM nodes other than ``gemm_ops()``. Host clock around
    the lint (it ends in a synchronize)."""
    import torch
    from repro_torch.core.exec_verify import (expected_permutes,
                                              stream_landings)

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.lint_compiled(dtype=torch.float64)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()["block_gemm"]
    info = res.info
    what = f"{setting} {name} lint"
    if res.errors:
        raise AssertionError(f"{what}: " + "; ".join(map(str, res.errors)))
    if info["wire_blocks"] != info["expected_blocks"]:
        raise AssertionError(f"{what}: recorded {info['wire_blocks']} wire "
                             f"blocks, the plan {info['expected_blocks']}")
    st = eng.program.stream_tables
    want = (len(stream_landings(st)) if st is not None else
            sum(e.activations for e in expected_permutes(eng.program)))
    layers = info["layers"]
    if (layers["eager"], layers["graph"]) != (want, want):
        raise AssertionError(f"{what}: {layers} permutes recorded, the "
                             f"plan runs {want}")
    if info["graph_gemm_nodes"] != eng.gemm_ops():
        raise AssertionError(f"{what}: {info['graph_gemm_nodes']} graph "
                             f"GEMM nodes, {eng.gemm_ops()} gemm ops")
    log(f"{what}: clean in {wall_s:.2f} s (host clock, one eager sweep "
        f"under the op layer + the capture's record): {layers['ops']} ops "
        f"dispatched, {layers['eager']} permutes eager = {layers['graph']} "
        f"in the graph = the plan's; wire {info['wire_blocks']} blocks = "
        f"planned ({info['wire_blocks'] * eng.b ** 2 * 8} B f64; JAX's "
        f"yardstick {info['plan_wire_blocks']}); "
        f"{info['graph_gemm_nodes']} graph GEMM nodes = gemm_ops; "
        f"{launches} block_gemm launches")
    return dict(wall_s=wall_s, dispatched_ops=layers["ops"],
                permutes=layers["eager"], graph_permutes=layers["graph"],
                wire_blocks=info["wire_blocks"],
                plan_wire_blocks=info["plan_wire_blocks"],
                graph_gemm_nodes=info["graph_gemm_nodes"],
                graph_kernels=info["graph_kernels"], launches=launches)


def mutated_lint(dev):
    """Phase 3e's negative controls: a Laplacian session on the card
    whose overlapped permute helper ships one round's first pair to a
    rank that receives nothing there must fail
    ``lint_compiled(verify_compiled="error")`` — the lint is not vacuous
    on the card. The mutated lanes are built before the sweep runs, so
    nothing is allocated from the host inside the capture. Then a fresh
    session whose device index table alone is retargeted (its host list,
    which the records come from, left right) must fail the same way, on
    the table check."""
    import copy

    import torch
    from repro_torch.core import pselinv_dist as pd
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PSelInvEngine
    from repro_torch.core.verify import PlanVerificationError

    PSelInvEngine.clear_cache()
    eng = PSelInvEngine.analyze(sparse.laplacian_2d(16, 8), b=8,
                                grid=Grid(4, 2), device=dev)
    ln = next(x for x in eng.tables.comm if x is not None and
              len(x.perm) > 1)
    busy = {d for _, d in ln.perm} | {ln.perm[0][0]}
    free = next(r for r in range(8) if r not in busy)
    bad = copy.copy(ln)
    bad.perm = [(ln.perm[0][0], free)] + ln.perm[1:]
    bad.dst = torch.tensor([d for _, d in bad.perm], device=dev)
    real = pd._permute_lanes
    pd._permute_lanes = (lambda payload, x: real(payload, bad)
                         if x is ln else real(payload, x))
    zero_counts()
    try:
        eng.lint_compiled(dtype=torch.float64, verify_compiled="error")
    except PlanVerificationError as e:
        codes = sorted({d.code for d in e.diagnostics
                        if d.severity == "error"})
    else:
        raise AssertionError("a retargeted pair linted clean on the card")
    finally:
        pd._permute_lanes = real
    torch.cuda.synchronize()
    PSelInvEngine.clear_cache()
    if "hlo/perm-unknown" not in codes:
        raise AssertionError(f"the retargeted pair raised {codes}, not "
                             "hlo/perm-unknown")
    log(f"lint negative control (laplacian_2d(16,8) b=8 on the card, "
        f"{ln.where}'s first pair retargeted to rank {free}): raised "
        f"PlanVerificationError with {codes}")
    eng = PSelInvEngine.analyze(sparse.laplacian_2d(16, 8), b=8,
                                grid=Grid(4, 2), device=dev)
    ln = next(x for x in eng.tables.comm if x is not None and
              len(x.perm) > 1)
    ln.dst[0] = free
    try:
        eng.lint_compiled(dtype=torch.float64, verify_compiled="error")
    except PlanVerificationError as e:
        table_codes = sorted({d.code for d in e.diagnostics
                              if d.severity == "error"})
        table_msg = str(e.diagnostics[0])
    else:
        raise AssertionError("a retargeted device table linted clean on "
                             "the card")
    torch.cuda.synchronize()
    launches = read_counts()["block_gemm"]
    PSelInvEngine.clear_cache()
    if table_codes != ["hlo/perm-unknown"] or \
            "uploaded index table" not in table_msg:
        raise AssertionError(f"the retargeted device table raised "
                             f"{table_codes}: {table_msg}")
    log(f"lint negative control 2 ({ln.where}'s device dst table alone "
        f"retargeted to rank {free}): raised PlanVerificationError with "
        f"{table_codes} from the table check")
    return dict(codes=codes, where=ln.where, table_codes=table_codes,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 3f: the legacy unrolled sweep on phase 3's settings
# ---------------------------------------------------------------------------

#: the unrolled schedule's rounds on each setting at b = 96 / 128, grid 4×2
UNROLLED_ROUNDS = {"fem3d_like(16,16,16,3)": 1805, "dg_like(32,32,16)": 3321}


def unrolled_path(dev, setting, state, b, grid=(4, 2)):
    """Phase 3f: the legacy unrolled sweep (``build_program_unrolled`` →
    ``upload_unrolled_tables`` → ``make_sweep_unrolled``: per supernode,
    xfer-in, the broadcast of the whole Û buffer round by round, one
    block-GEMM launch, the reduction of the whole partial, xfer-out and
    the diagonal) on phase 3's prepared f64 values: one eager solve with
    the launch counts zeroed before it and read after it, then a timed
    one (CUDA events). Fails unless the rounds are the host program's
    (:data:`UNROLLED_ROUNDS`), there is one launch per supernode with a
    non-empty struct, all on the DMMA variant, the selected blocks are
    within 1e-10·max|A⁻¹| of the dense inverse, the solve is within
    1e-12·max|A⁻¹| of the overlapped one and a repeated solve is bitwise
    equal. One solve is traced for its busy share."""
    import torch
    from repro_torch.core.pselinv_dist import (build_program_unrolled,
                                               make_sweep_unrolled,
                                               unrolled_moved,
                                               upload_unrolled_tables)
    from repro_torch.kernels import block_gemm as bg

    eng, vals, out_ov = state["eng"], state["vals"], state["out"]
    ref, scale = state["ref"], state["scale"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog = build_program_unrolled(eng.bs, eng.nb, b, *grid)
    tabs = upload_unrolled_tables(prog, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rounds, blocks = unrolled_moved(prog)
    if rounds != UNROLLED_ROUNDS[setting]:
        raise AssertionError(f"{setting} unrolled: {rounds} rounds, "
                             f"expected {UNROLLED_ROUNDS[setting]}")
    live = sum(1 for it in prog.iters if it.C)
    sweep = make_sweep_unrolled(prog, tabs)
    Lh, Dinv = (eng._as_tensor(v, torch.float64) for v in vals)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = sweep(Lh, Dinv)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    launches = read_counts()["block_gemm"]
    variants = {" ".join(map(str, k)): c for k, c in bg.plans.items()}
    if launches != live:
        raise AssertionError(f"{setting} unrolled: {launches} block_gemm "
                             f"launches, {live} supernodes with a struct")
    if any(k[0] != "dmma_f64" for k in bg.plans):
        raise AssertionError(f"{setting} unrolled: the f64 solve ran "
                             f"{variants}, not only the DMMA variant")
    peak = torch.cuda.max_memory_allocated() / 2**30
    solve_ms, again = _events_ms(lambda: sweep(Lh, Dinv), reps=1)
    if not torch.equal(again, out):
        raise AssertionError(f"{setting} unrolled: repeated solve differs")
    del again
    err = (selected_blocks(out, eng, dev) - ref).abs().max().item()
    if not err <= 1e-10 * scale:
        raise AssertionError(f"{setting} unrolled: selected blocks max|Δ| "
                             f"{err:.3e} > 1e-10 · max|A⁻¹| {scale:.3e}")
    vs_ov = (out - out_ov).abs().max().item()
    if not vs_ov <= 1e-12 * scale:
        raise AssertionError(f"{setting} unrolled: max|Δ| {vs_ov:.3e} from "
                             f"the overlapped solve > 1e-12 · max|A⁻¹| "
                             f"{scale:.3e}")
    log(f"{setting} unrolled:")
    prof = profile_solve(lambda: sweep(Lh, Dinv))
    wire = blocks * b * b * 8
    log(f"{setting} unrolled: program + tables {build_s:.2f} s (host "
        f"clock), {rounds} rounds, {blocks} blocks = {wire / 1e6:.1f} MB "
        f"on the wire of a rank-process run; eager solve {eager_s * 1e3:.1f}"
        f" ms (host clock, first), {solve_ms[0]:.1f} ms (CUDA events) "
        f"against {state['solve_ms']:.1f} ms overlapped; {launches} "
        f"block_gemm launches = {live} supernodes ({variants}); selected "
        f"max|Δ| {err:.3e}; vs overlapped max|Δ| {vs_ov:.3e}"
        + (" (bitwise equal)" if torch.equal(out, out_ov) else "")
        + f"; repeated solve bitwise equal; peak {peak:.1f} GiB")
    del out, sweep, tabs
    return dict(rounds=rounds, wire_blocks=blocks, wire_bytes=wire,
                build_s=build_s, eager_s=eager_s, solve_ms=solve_ms,
                launches=launches, variants=variants, max_err=err,
                vs_overlapped=vs_ov, peak_gib=peak, profile=prof)


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
# phase 5: the server — structure-batched requests served by graph replay
# ---------------------------------------------------------------------------

# phase 5a's bursts of same-structure requests: each coalesces into one
# batch, so the batches ride the buckets 4, 2 and 1 (FEM buckets stay ≤ 4);
# the widest class is captured first, so the narrower ones carve their
# temporaries out of its block of the session's graph pool
SERVE_BURSTS = (4, 2, 1, 4, 4, 1)


def serve_path(dev, setting, state, b, grid=(4, 2), bursts=SERVE_BURSTS,
               seed=5):
    """Phase 5a: ``SelInvServer`` on the FEM setting at full size. Each
    request is phase 3's prepared values for αᵢ·A (αᵢ seeded in [0.5,
    2)): L̂ is A's and D⁻¹ is D⁻¹/αᵢ, so no host prepare runs. The bursts
    are submitted through ``submit_values`` to the background worker and
    drained, one batch a burst, served by the (structure, bucket) graph
    of a fresh session. Fails unless every result is bitwise the eager
    single solve of its values and within 1e-12·max|A⁻¹/αᵢ| of
    A⁻¹/αᵢ (phase 3's eager solve over αᵢ), and the session captured
    once per bucket used. Reports latency percentiles, occupancy, the
    served wall per matrix of each burst, one bucket-4 batch against one
    single solve (CUDA events), and the graphs' memory."""
    import numpy as np
    import torch
    from repro_torch.core.engine import (Grid, PSelInvEngine, SolveValues,
                                         stack_values)
    from repro_torch.serve import BatchWindow, SelInvServer, ServeConfig

    A, vals, ref = state["A"], state["vals"], state["out"]
    state["eng"] = None             # phase 3's session and its graphs go
    PSelInvEngine.clear_cache()
    torch.cuda.empty_cache()
    alphas = np.random.default_rng(seed).uniform(0.5, 2.0, sum(bursts))
    scale = ref.abs().max().item()
    cfg = ServeConfig(b=b, grid=Grid(*grid), dtype=torch.float64,
                      window=BatchWindow(max_batch=4, max_wait_ms=1e6),
                      device=str(dev))

    def values(a):
        return SolveValues(vals.Lh, vals.Dinv / a)

    walls, results = [], []
    with SelInvServer(cfg) as srv:
        t0 = time.perf_counter()
        eng = srv.engine_for(A)
        analyze_s = time.perf_counter() - t0
        zero_counts()
        at = 0
        for k in bursts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [srv.submit_values(eng, values(a))
                    for a in alphas[at:at + k]]
            srv.drain()
            results += [r.result(timeout=600) for r in reqs]
            walls.append(time.perf_counter() - t0)
            at += k
        launches = read_counts()["block_gemm"]
        st = srv.stats()
    (census,) = st["structures"].values()
    want = sorted({1 << (k - 1).bit_length() for k in bursts})
    if census["buckets_used"] != want or census["trace_count"] != len(want):
        raise AssertionError(f"serve {setting}: {census} — expected one "
                             f"capture per bucket of {want}")
    if launches != 2 * len(want) * eng.gemm_ops():
        raise AssertionError(f"serve {setting}: {launches} block-GEMM "
                             f"wrapper launches, expected warm-up + capture"
                             f" of {eng.gemm_ops()} for each of {want}")
    worst = 0.0
    for a, res in zip(alphas, results):
        got = torch.from_numpy(res).to(dev)
        if not torch.equal(got, eager_solve(eng, values(a), torch.float64)):
            raise AssertionError(f"serve {setting}: the result for α={a} "
                                 "differs from its eager single solve")
        err = (got - ref / a).abs().max().item() / (scale / a)
        if not err <= 1e-12:
            raise AssertionError(f"serve {setting}: α={a}: max|Δ| from "
                                 f"A⁻¹/α is {err:.3e}·max|A⁻¹/α|")
        worst = max(worst, err)
        del got
    del results
    four = stack_values([values(a) for a in alphas[:4]])
    batch_ms, out4 = _events_ms(lambda: eng.solve(four, dtype=torch.float64,
                                                  bucket=True))
    # the server's one copy of a batch to the host, alone (host clock)
    t0 = time.perf_counter()
    host = out4.cpu().numpy()
    d2h_s = time.perf_counter() - t0
    d2h_gbs = host.nbytes / d2h_s / 1e9
    del out4, four, host
    eager_ms, out1 = _events_ms(lambda: eager_solve(eng, vals,
                                                    torch.float64))
    del out1
    est = eng.stats()
    per = {}
    for k, w in zip(bursts, walls):
        per.setdefault(k, []).append(w / k * 1e3)
    r = dict(requests=len(alphas), bursts=list(bursts), analyze_s=analyze_s,
             burst_wall_s=walls, served_ms_per_matrix=per,
             batch4_replay_ms=batch_ms,
             batch4_ms_per_matrix=statistics.median(batch_ms) / 4,
             batch4_to_host_s=d2h_s, to_host_gb_per_s=d2h_gbs,
             single_eager_ms=eager_ms,
             latency_p50_us=st["latency_p50_us"],
             latency_p95_us=st["latency_p95_us"],
             latency_p99_us=st["latency_p99_us"],
             occupancy=st["batch_occupancy_mean"],
             batch_size_hist=st["batch_size_hist"], census=census,
             launches=launches, graph_bytes=est["graph_bytes"],
             graph_replays=est["graph_replays"], worst_err=worst)
    log(f"serve {setting}: {len(alphas)} requests in bursts {list(bursts)} "
        f"→ batches {st['batch_size_hist']}, buckets "
        f"{census['buckets_used']}, {census['trace_count']} captures; "
        f"every result bitwise its eager single solve, max|Δ| from A⁻¹/α "
        f"{worst:.2e}·max|A⁻¹/α|; latency p50/p95/p99 "
        f"{st['latency_p50_us'] / 1e3:.1f}/{st['latency_p95_us'] / 1e3:.1f}"
        f"/{st['latency_p99_us'] / 1e3:.1f} ms, occupancy "
        f"{st['batch_occupancy_mean']:.2f}; served wall per matrix by "
        f"burst (host clock, with the copy to the host) "
        + ", ".join(f"{k}: {[round(x, 1) for x in v]} ms"
                    for k, v in per.items())
        + f"; a bucket-4 replay {statistics.median(batch_ms):.1f} ms = "
        f"{r['batch4_ms_per_matrix']:.1f} ms a matrix, against an eager "
        f"single solve {statistics.median(eager_ms):.1f} ms (CUDA events, "
        f"medians of 3); its copy to the host {d2h_s * 1e3:.0f} ms "
        f"({d2h_gbs:.1f} GB/s, host clock)"
        f"; {launches} block-GEMM wrapper launches (3 captures × 2 × "
        f"{eng.gemm_ops()}); graph memory {est['graph_bytes'] / 2**30:.2f} "
        f"GiB")
    return r


def traffic_path(dev, n_requests=64):
    """Phase 5b: ``serve.traffic.run_traffic`` on the card at the
    harness's sizes — a seeded Poisson stream over 2 Laplacian
    structures, b=8, grid 4×2, f64 — which asserts one capture per
    (structure, bucket) and every served result within 1e-12 of its
    unbatched solve."""
    import torch
    from repro_torch.core.engine import Grid
    from repro_torch.serve.traffic import run_traffic

    zero_counts()
    res = run_traffic(n_requests=n_requests, n_structures=2,
                      rate_hz=4000.0, seed=0, b=8, grid=Grid(4, 2),
                      dtype=torch.float64, device=dev, tol=1e-12)
    res["launches"] = read_counts()["block_gemm"]
    log(f"traffic: {n_requests} requests, 2 structures, grid 4x2, f64: "
        f"captures per structure = buckets used {res['conformance']}; "
        f"identity {res['identity_max_abs']:.2e}; served "
        f"{res['serve_per_matrix_us']:.0f} us a matrix vs sequential "
        f"{res['baseline_per_matrix_us']:.0f} us ({res['speedup']:.2f}x, "
        f"host clock), p50/p95/p99 {res['serve_p50_us']:.0f}/"
        f"{res['serve_p95_us']:.0f}/{res['serve_p99_us']:.0f} us, "
        f"occupancy {res['serve_batch_occupancy']:.2f}, "
        f"{res['batches']} batches")
    return res


def isolation_path(dev):
    """Phase 5c: a request whose pattern escapes its structure (a
    nonzero outside the analyzed blocks swapped onto the queued request)
    fails alone; its three batch neighbours are bitwise the eager single
    solves of their prepared values, and the server serves the next
    window."""
    import scipy.sparse as sp
    import torch
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PSelInvEngine
    from repro_torch.serve import (BatchWindow, RequestStatus, SelInvServer,
                                   ServeConfig, ServeError)

    PSelInvEngine.clear_cache()
    srv = SelInvServer(ServeConfig(
        b=8, grid=Grid(4, 2), dtype=torch.float64,
        window=BatchWindow(max_batch=4, max_wait_ms=1e6), device=str(dev)))
    A = sparse.laplacian_2d(12, 8)
    eye = sp.identity(A.shape[0])
    mats = [A + c * eye for c in (0.5, 1.5, 2.5)]
    good = [srv.submit(M) for M in mats]
    bad = srv.submit(A + eye)
    E = sp.lil_matrix(A)
    E[0, 95] = E[95, 0] = 1.0
    bad.matrix = sp.csr_matrix(E)
    srv.pump(force=True)
    try:
        bad.result()
        raise AssertionError("isolation: the bad request returned a result")
    except ServeError as e:
        if "outside the analyzed block" not in str(e):
            raise
    eng = srv.engine_for(A)
    vals = eng.prepare_values_many(mats)
    for i, r in enumerate(good):
        single = eager_solve(eng, (vals.Lh[i], vals.Dinv[i]), torch.float64)
        if (r.status is not RequestStatus.SOLVED
                or not torch.equal(torch.from_numpy(r.result()).to(dev),
                                   single)):
            raise AssertionError(f"isolation: neighbour {i} is {r.status} "
                                 "or differs from its single solve")
    nxt = srv.submit(A + 3.0 * eye)
    srv.pump(force=True)
    st = srv.stats()
    if nxt.status is not RequestStatus.SOLVED or (st["failed"],
                                                  st["solved"]) != (1, 4):
        raise AssertionError(f"isolation: after the failure {nxt.status}, "
                             f"{st['failed']} failed / {st['solved']} "
                             "solved")
    log(f"isolation: the bad-pattern request failed alone ({bad.error}); "
        f"its 3 neighbours (one batch, bucket 4) bitwise their single "
        f"solves; the next request solved")
    PSelInvEngine.clear_cache()
    return dict(failed=st["failed"], solved=st["solved"],
                batches=st["batch_size_hist"])


# ---------------------------------------------------------------------------
# phase 6: bucketed batch against single solves
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
# phase 8: the multi-rank sweep — 8 rank processes on the one card
# ---------------------------------------------------------------------------

# the tree collectives' payload per rank: 64 MiB of f32
COLL_NUMEL = 16 << 20
MEMBERS = [1, 3, 4, 6]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _sha1(t):
    import hashlib
    return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _collective(dev, name, fn, x, expect):
    """One tree collective on every rank, barrier to barrier after one
    warm-up call (which allocates the pinned buffers): host wall ending
    in a synchronize, exactness against ``expect`` (or None: this rank's
    result is working state), and what this rank sent."""
    import torch
    import torch.distributed as dist
    from repro_torch.comm import p2p

    fn(x)
    dist.barrier()
    _sync(dev)
    p2p.LOG.clear()
    t0 = time.perf_counter()
    y = fn(x)
    _sync(dev)
    wall = time.perf_counter() - t0
    dist.barrier()
    exact = True if expect is None else bool(torch.equal(y, expect))
    return dict(name=name, wall_s=wall, exact=exact,
                sent=p2p.LOG.sent(), received=p2p.LOG.received(),
                staged=p2p.LOG.staged_bytes)


def _ranked_solves(sweep, Lh, Dinv, dev, reps):
    """``reps`` ranked solves barrier to barrier (host clock ending in a
    synchronize), each with its launch counts and send log zeroed right
    before it; returns the runs and the last result."""
    import torch.distributed as dist
    from repro_torch.comm import p2p
    from repro_torch.kernels import block_gemm as bg

    runs, out = [], None
    for _ in range(reps):
        out = None
        dist.barrier()
        _sync(dev)
        p2p.LOG.clear()
        bg.launches = 0
        bg.plans.clear()
        t1 = time.perf_counter()
        out = sweep(Lh, Dinv)
        _sync(dev)
        t2 = time.perf_counter()
        dist.barrier()
        t3 = time.perf_counter()
        runs.append(dict(
            wall_s=t2 - t1, barrier_s=t3 - t1, rounds_s=p2p.LOG.wait_s,
            sync_s=p2p.LOG.sync_s,
            launches=bg.launches,
            variants=sorted({k[0] for k in bg.plans}),
            sent=p2p.LOG.sent(), received=p2p.LOG.received(),
            staged=p2p.LOG.staged_bytes, log=p2p.LOG.snapshot()))
    return runs, out


def rank_main(rank, A, b, grid, tmp, hashes, reps, coll_numel, device,
              t_spawn, ls_hashes=None, ls_reps=2, unrolled=None):
    """One rank of phase 8, in its own process: analyze (every rank;
    deterministic), this rank's view of the overlapped tables, its value
    shards from ``tmp``; then ``reps`` ranked f64 solves barrier to
    barrier (host clock ending in a synchronize), each with its launch
    counts and send log zeroed right before it; the result's sha1 against
    the single-process shard's (``hashes``; a differing shard is saved to
    ``tmp`` for the parent). With ``ls_hashes`` the same for the
    level-serial sweep (``make_sweep_ranked``): a warm-up, then
    ``ls_reps`` solves, their send logs kept for the parent's
    ``lint_ranked`` and their shards against ``ls_hashes``. Then the tree collectives on a ``coll_numel``-element
    f32 tensor of integer values. ``stamps`` are wall-clock seconds since
    the parent spawned (``t_spawn``), at each stage's end. With
    ``unrolled`` (``{tag: (matrix, b, hashes)}``; a matrix of None is
    ``A`` on this rank's shards) the unrolled sweep by the ranks on each
    case (:func:`_rank_unrolled`), before the collectives."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.comm import (p2p, subset_broadcast, subset_reduce,
                                  tree_allreduce)
    from repro_torch.core.pselinv_dist import (analyze_structure,
                                               build_program,
                                               make_sweep_overlapped_ranked,
                                               make_sweep_ranked,
                                               rank_exec_tables,
                                               rank_tables,
                                               upload_exec_tables,
                                               upload_tables)
    from repro_torch.core.trees import TreeKind, build_tree

    stamps = {"process": _IMPORTED - t_spawn,
              "started": time.time() - t_spawn}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.zeros(1, device=dev)
    else:
        torch.set_num_threads(1)
    stamps["device"] = time.time() - t_spawn
    t0 = time.perf_counter()
    bs, nb = analyze_structure(A, b, *grid)
    prog = build_program(bs, nb, b, *grid, overlap=True)
    tabs = rank_tables(upload_tables(prog, "cpu"), rank, dev)
    sweep = make_sweep_overlapped_ranked(prog, tabs, rank)
    analyze_s = time.perf_counter() - t0
    stamps["analyzed"] = time.time() - t_spawn
    Lh = torch.from_numpy(np.load(tmp / f"lh{rank}.npy")).to(dev)
    Dinv = torch.from_numpy(np.load(tmp / f"dinv{rank}.npy")).to(dev)
    stamps["loaded"] = time.time() - t_spawn
    sweep(Lh, Dinv)                      # warm-up: cuBLAS, pinned buffers
    _sync(dev)
    stamps["warm"] = time.time() - t_spawn
    runs, out = _ranked_solves(sweep, Lh, Dinv, dev, reps)
    for run in runs:
        run.pop("log")
    stamps["solved"] = time.time() - t_spawn
    digest = _sha1(out)
    if digest != hashes[rank]:
        np.save(tmp / f"out{rank}.npy", out.cpu().numpy())
    del out, sweep, tabs
    ls = None
    if ls_hashes is not None:
        t0 = time.perf_counter()
        prog_ls = build_program(bs, nb, b, *grid, overlap=False)
        sweep = make_sweep_ranked(prog_ls, rank_exec_tables(
            upload_exec_tables(prog_ls, "cpu"), rank, dev), rank)
        ls_analyze_s = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        sweep(Lh, Dinv)
        _sync(dev)
        warm_s = time.perf_counter() - t0
        stamps["ls_warm"] = time.time() - t_spawn
        ls_runs, out = _ranked_solves(sweep, Lh, Dinv, dev, ls_reps)
        ls_digest = _sha1(out)
        if ls_digest != ls_hashes[rank]:
            np.save(tmp / f"ls_out{rank}.npy", out.cpu().numpy())
        ls = dict(analyze_s=ls_analyze_s, warm_s=warm_s, runs=ls_runs,
                  sha1=ls_digest, bitwise=ls_digest == ls_hashes[rank])
        stamps["ls_solved"] = time.time() - t_spawn
        del out, sweep
    unr = {}
    for tag, (M, bu, hs) in (unrolled or {}).items():
        unr[tag] = (_rank_unrolled(rank, dev, tag, M, bu, grid, hs, tmp)
                    if M is not None else
                    _rank_unrolled(rank, dev, tag, A, b, grid, hs, tmp, Lh,
                                   Dinv))
        stamps[f"unrolled_{tag}"] = time.time() - t_spawn
    del Lh, Dinv

    base = torch.arange(coll_numel, device=dev) % 1024
    x = (base + rank).float()
    P = grid[0] * grid[1]
    everyone = build_tree(TreeKind.SHIFTED, 2,
                          [r for r in range(P) if r != 2], tag=13)
    coll = [
        _collective(dev, "subset_broadcast", lambda v: subset_broadcast(
            v, None, 3, MEMBERS, TreeKind.SHIFTED, tag=7), x,
            (base + (3 if rank in MEMBERS else rank)).float()),
        _collective(dev, "subset_reduce", lambda v: subset_reduce(
            v, None, 4, MEMBERS, TreeKind.BINARY), x,
            (base * len(MEMBERS) + sum(MEMBERS)).float() if rank == 4
            else None),
        _collective(dev, "tree_allreduce",
                    lambda v: tree_allreduce(v, None, everyone), x,
                    (base * P + P * (P - 1) // 2).float()),
    ]
    stamps["collectives"] = time.time() - t_spawn
    return dict(rank=rank, analyze_s=analyze_s, runs=runs, sha1=digest,
                bitwise=digest == hashes[rank], collectives=coll,
                stamps=stamps, level_serial=ls, unrolled=unr)


def _rank_unrolled(rank, dev, tag, A, b, grid, hashes, tmp, Lh=None,
                   Dinv=None):
    """The unrolled sweep by this rank (``make_sweep_unrolled_ranked``)
    on ``A``: its program, a warm-up, then one solve barrier to barrier
    (:func:`_ranked_solves`), its shard's sha1 against ``hashes`` (a
    differing shard is saved to ``tmp`` for the parent). Without ``Lh``
    the rank prepares its own shards (deterministic host code)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.pselinv_dist import (analyze_structure,
                                               build_program_unrolled,
                                               make_sweep_unrolled_ranked,
                                               prepare_values)

    t0 = time.perf_counter()
    bs, nb = analyze_structure(A, b, *grid)
    prog = build_program_unrolled(bs, nb, b, *grid)
    sweep = make_sweep_unrolled_ranked(prog, rank, None, dev)
    if Lh is None:
        lh, dinv = prepare_values(A, bs, nb, b, *grid)
        Lh = torch.from_numpy(lh[rank]).to(dev)
        Dinv = torch.from_numpy(dinv[rank]).to(dev)
    analyze_s = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    sweep(Lh, Dinv)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    runs, out = _ranked_solves(sweep, Lh, Dinv, dev, 1)
    for run in runs:
        run["rounds"] = run.pop("log")["rounds"]
    digest = _sha1(out)
    if digest != hashes[rank]:
        np.save(tmp / f"unr_{tag}{rank}.npy", out.cpu().numpy())
    return dict(analyze_s=analyze_s, warm_s=warm_s, runs=runs, sha1=digest,
                bitwise=digest == hashes[rank])


def ranked_unrolled(setting, rows, tag, prog, out, tmp):
    """Phase 8's unrolled half for one case, read off the ranks' rows:
    every shard bitwise the single-process unrolled solve's (``out``),
    else within 1e-12·max|A⁻¹|; every rank counted the program's rounds;
    the sent and received bytes of the solve the bytes reckoned from the
    rounds (:func:`~repro_torch.core.pselinv_dist.unrolled_moved`, f64);
    one block-GEMM launch a supernode with a struct, a rank, all on the
    DMMA variant."""
    import numpy as np
    from repro_torch.core.pselinv_dist import unrolled_moved

    P = len(rows)
    us = [row["unrolled"][tag] for row in rows]
    scale = out.abs().max().item()
    for row, u in zip(rows, us):
        u["max_abs_diff"] = 0.0
        if not u["bitwise"]:
            got = np.load(tmp / f"unr_{tag}{row['rank']}.npy")
            u["max_abs_diff"] = float(np.abs(
                got - out[row["rank"]].cpu().numpy()).max())
    bad = [row["rank"] for row, u in zip(rows, us) if not u["bitwise"]
           and not u["max_abs_diff"] <= 1e-12 * scale]
    if bad:
        raise AssertionError(f"{setting} ranked unrolled: ranks {bad} differ "
                             "from the single-process unrolled solve by "
                             f"more than 1e-12·max|A⁻¹| ({scale:.3e})")
    rounds, blocks = unrolled_moved(prog)
    want = blocks * prog.b ** 2 * 8
    live = sum(1 for it in prog.iters if it.C)
    runs = [u["runs"][0] for u in us]
    if {x["rounds"] for x in runs} != {rounds}:
        raise AssertionError(f"{setting} ranked unrolled: the ranks counted "
                             f"{sorted({x['rounds'] for x in runs})} rounds,"
                             f" the program has {rounds}")
    if [x["launches"] for x in runs] != [live] * P or any(
            x["variants"] != ["dmma_f64"] for x in runs):
        raise AssertionError(f"{setting} ranked unrolled: "
                             f"{[x['launches'] for x in runs]} GEMM "
                             f"launches, {live} a rank expected, all "
                             "dmma_f64")
    sent = sum(x["sent"][1] for x in runs)
    recv = sum(x["received"][1] for x in runs)
    if not sent == recv == want:
        raise AssertionError(f"{setting} ranked unrolled: sent {sent} B, "
                             f"received {recv} B, reckoned from the rounds "
                             f"{want} B")
    solve_ms = max(x["barrier_s"] for x in runs) * 1e3
    wall = [x["wall_s"] * 1e3 for x in runs]
    wire = [(x["rounds_s"] - x["sync_s"]) * 1e3 for x in runs]
    sync = [x["sync_s"] * 1e3 for x in runs]
    log(f"{setting}: ranked unrolled solve {solve_ms:.1f} ms barrier to "
        f"barrier (max over ranks; warm-up "
        f"{max(u['warm_s'] for u in us):.2f} s), {rounds} rounds, sent "
        f"{sent} B = reckoned from the rounds; per rank wall "
        f"{[round(w, 1) for w in wall]} ms, of it on the wire "
        f"{[round(w, 1) for w in wire]} ms and waiting for the card "
        f"{[round(w, 1) for w in sync]} ms; {P} × {live} block GEMM "
        "launches, all dmma_f64; shards "
        + ("all bitwise equal to the single-process unrolled solve"
           if all(u["bitwise"] for u in us) else
           f"within max|Δ| {max(u['max_abs_diff'] for u in us):.3e} of it "
           f"(1e-12·max|A⁻¹| = {1e-12 * scale:.3e})"))
    return dict(solve_ms=solve_ms, rounds=rounds, sent_bytes=want,
                launches=sum(x["launches"] for x in runs),
                warm_s=max(u["warm_s"] for u in us), wall_ms=wall,
                wire_ms=wire, sync_ms=sync,
                bitwise=[u["bitwise"] for u in us],
                max_abs_diff=max(u["max_abs_diff"] for u in us))


def _diag_sum_per_rank(Ainv, U, lv):
    """``pselinv_dist._diag_sum`` with its einsum run once per rank, at
    the P=1 shapes a rank process gives it (cuBLAS may pick another kernel
    for the smaller batch)."""
    import torch
    B, P = Ainv.shape[:2]
    cm = lv.cm[None, :, :, :, None, None]
    Uh_m = torch.where(cm, U, 0.0)
    Arow = torch.where(cm, Ainv.index_select(2, lv.krs), 0.0)
    S = torch.stack([torch.cat([
        torch.einsum("pkjab,pkjcb->pkac", Arow[i, p:p + 1], Uh_m[i, p:p + 1])
        for p in range(P)]) for i in range(B)])
    return torch.where(lv.rm[None, :, :, None, None], S, 0.0)


def differing_op(eng, vals, rows):
    """Where ranked shards differ from the single-process solve: rerun
    the single-process eager sweep with only the diagonal einsum at the
    ranks' shapes. If every shard then matches its rank's bit for bit,
    that einsum is the one op that differs."""
    import torch
    from repro_torch.core import pselinv_dist as pd

    keep = pd._diag_sum
    pd._diag_sum = _diag_sum_per_rank
    try:
        out = eager_solve(eng, vals, torch.float64)
    finally:
        pd._diag_sum = keep
    same = [_sha1(out[row["rank"]]) == row["sha1"] for row in rows]
    return ("_diag_sum's einsum (cuBLAS, batch nk at P=1 against 8·nk)"
            if all(same) else
            f"not isolated: with the einsum per rank, ranks "
            f"{[r['rank'] for r, ok in zip(rows, same) if not ok]} still "
            "differ")


def ranked_level_serial(setting, eng_ls, rows, scale, reps):
    """Phase 8's level-serial half, read off the ranks' rows: every
    shard bitwise the single-process level-serial solve's, else within
    1e-12·max|A⁻¹|; each solve's sent
    bytes the plan's wire (``expected_wire_blocks·b²·8``, the session's
    moved bytes) and its send logs held to the plan round by round
    (``lint_ranked``); ``gemm_ops`` DMMA launches a rank a solve."""
    from repro_torch.core.exec_verify import expected_wire_blocks, lint_ranked

    P = len(rows)
    gemm_ops = eng_ls.gemm_ops()
    want = expected_wire_blocks(eng_ls.program) * eng_ls.b ** 2 * 8
    moved = eng_ls.moved()[1]
    lss = [row["level_serial"] for row in rows]
    if want != moved:
        raise AssertionError(f"{setting} level-serial: the plan's wire "
                             f"{want} B, the session moves {moved:.0f} B")
    bad = [row["rank"] for row, ls in zip(rows, lss) if not ls["bitwise"]
           and not ls["max_abs_diff"] <= 1e-12 * scale]
    if bad:
        raise AssertionError(f"{setting} ranked level-serial: ranks {bad} "
                             "differ from the single-process level-serial "
                             f"solve by more than 1e-12·max|A⁻¹| "
                             f"({scale:.3e})")
    lint = []
    for i in range(reps):
        runs = [ls["runs"][i] for ls in lss]
        if [x["launches"] for x in runs] != [gemm_ops] * P or any(
                x["variants"] != ["dmma_f64"] for x in runs):
            raise AssertionError(f"{setting} ranked level-serial solve {i}: "
                                 f"{[x['launches'] for x in runs]} GEMM "
                                 f"launches, plan has {gemm_ops} a rank, "
                                 "all dmma_f64")
        sent = sum(x["sent"][1] for x in runs)
        recv = sum(x["received"][1] for x in runs)
        if not sent == recv == want:
            raise AssertionError(f"{setting} ranked level-serial solve {i}:"
                                 f" sent {sent} B, received {recv} B, the "
                                 f"plan's wire is {want} B")
        res = lint_ranked([x.pop("log") for x in runs], eng_ls.program)
        if res.errors:
            raise AssertionError(f"{setting} ranked level-serial solve {i}:"
                                 " " + "; ".join(map(str, res.errors)))
        lint.append({k: v for k, v in res.info.items() if k != "layers"})
    solve_ms = [max(ls["runs"][i]["barrier_s"] for ls in lss) * 1e3
                for i in range(reps)]
    for row, ls in zip(rows, lss):
        walls = [x["wall_s"] * 1e3 for x in ls["runs"]]
        wires = [(x["rounds_s"] - x["sync_s"]) * 1e3 for x in ls["runs"]]
        syncs = [x["sync_s"] * 1e3 for x in ls["runs"]]
        r0 = ls["runs"][0]
        log(f"  rank {row['rank']} level-serial: shard "
            + ("bitwise equal to the single-process one" if ls["bitwise"]
               else f"differs, max|Δ| {ls['max_abs_diff']:.3e}")
            + f"; analyze {ls['analyze_s']:.2f} s, warm-up "
            f"{ls['warm_s']:.2f} s; sent {r0['sent'][0]} msgs {r0['sent'][1]} B, received "
            f"{r0['received'][0]} msgs {r0['received'][1]} B, staged "
            f"{r0['staged']} B a solve; wall "
            f"{[round(w, 1) for w in walls]} ms, of it on the wire "
            f"{[round(w, 1) for w in wires]} ms and waiting for the card "
            f"before a send {[round(w, 1) for w in syncs]} ms")
    rounds = lint[0]["ppermute_count"]
    log(f"{setting}: ranked level-serial solve "
        f"{[round(x, 1) for x in solve_ms]} ms barrier to barrier (max over "
        f"ranks), {rounds} point-to-point rounds; sent {want} B a solve = "
        f"the plan's wire = the session's moved bytes; every send log "
        f"held to the plan round by round (lint_ranked clean); {P} × "
        f"{gemm_ops} block GEMM launches a solve, all dmma_f64; shards "
        + ("all bitwise equal to the single-process level-serial solve"
           if all(ls["bitwise"] for ls in lss) else
           f"within max|Δ| {max(ls['max_abs_diff'] for ls in lss):.3e} of "
           f"the single-process level-serial solve (1e-12·max|A⁻¹| = "
           f"{1e-12 * scale:.3e})"))
    return dict(solve_ms=solve_ms, rounds=rounds, sent_bytes=want,
                gemm_ops=gemm_ops, lint=lint,
                launches=sum(x["launches"] for ls in lss
                             for x in ls["runs"]),
                bitwise=[ls["bitwise"] for ls in lss],
                max_abs_diff=max(ls["max_abs_diff"] for ls in lss))


def multirank_path(dev, setting, state, b, grid=(4, 2), reps=3,
                   coll_numel=COLL_NUMEL, ls_reps=2, lap=(32, 8)):
    """Phase 8: phase 3's FEM f64 solve by ``pr·pc`` rank processes on
    the one card (``comm.p2p.spawn``, gloo, CUDA payloads staged through
    pinned host memory), each over its own view of the tables and its own
    arena, launching the hand-written block GEMM for its shard. Holds
    every rank's A⁻¹ shard against phase 3's single-process solve
    (bitwise, else max|Δ| within 1e-12·max|A⁻¹|), each solve to
    ``gemm_ops`` launches a rank, the ranks' sent bytes to the session's
    moved bytes and ``executed_wire_bytes``; then the level-serial
    sweep by the same ranks (``ls_reps`` timed solves after a plain
    warm-up) against a single-process level-serial solve of the same
    values, its send logs held to the plan (``lint_ranked``; the op-layer
    check of a rank's sweep runs only in the card test
    ``test_ranked_level_serial_on_the_card``); then the legacy unrolled
    sweep by the same ranks (``make_sweep_unrolled_ranked``, every round
    one message of the JAX round's payload) on ``laplacian_2d(*lap)`` at
    b=8 and on phase 3's FEM values, a warm-up and one solve each,
    against a single-process unrolled solve (:func:`ranked_unrolled`);
    then times three tree collectives on ``coll_numel`` f32 elements a
    rank, whose integer results must be exact."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.comm import p2p
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PSelInvEngine
    from repro_torch.core.pselinv_dist import (analyze_structure,
                                               build_program_unrolled,
                                               make_sweep_unrolled,
                                               prepare_values,
                                               upload_unrolled_tables)
    from repro_torch.core.simulator import executed_wire_bytes

    eng, vals, out, A = (state[k] for k in ("eng", "vals", "out", "A"))
    P = grid[0] * grid[1]
    moved = eng.moved()[1]
    # the single-process unrolled solves the ranked ones are held to
    A_lap = sparse.laplacian_2d(*lap)
    bs_lap, nb_lap = analyze_structure(A_lap, 8, *grid)
    unr_progs = {"lap": build_program_unrolled(bs_lap, nb_lap, 8, *grid),
                 "fem": build_program_unrolled(eng.bs, eng.nb, b, *grid)}
    lap_vals = [torch.as_tensor(x, device=dev) for x in
                prepare_values(A_lap, bs_lap, nb_lap, 8, *grid)]
    fem_vals = [eng._as_tensor(v, torch.float64) for v in vals]
    unr_outs = {tag: make_sweep_unrolled(
        prog, upload_unrolled_tables(prog, dev))(*v) for (tag, prog), v in
        zip(unr_progs.items(), (lap_vals, fem_vals))}
    del lap_vals, fem_vals
    unrolled = {"lap": (A_lap, 8, [_sha1(o) for o in unr_outs["lap"]]),
                "fem": (None, b, [_sha1(o) for o in unr_outs["fem"]])}
    if executed_wire_bytes(eng) != moved:
        raise AssertionError(f"{setting}: executed_wire_bytes "
                             f"{executed_wire_bytes(eng)} != moved {moved}")
    # the single-process level-serial solve the ranked one is held to
    eng_ls = PSelInvEngine.analyze(A, b=b, grid=Grid(*grid),
                                   options=_options("level_serial"),
                                   device=dev)
    out_ls = eager_solve(eng_ls, vals, out.dtype)
    _sync(dev)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    try:
        t0 = time.perf_counter()
        hashes, ls_hashes = [], []
        for r in range(P):
            np.save(tmp / f"lh{r}.npy", vals.Lh[r].cpu().numpy())
            np.save(tmp / f"dinv{r}.npy", vals.Dinv[r].cpu().numpy())
            hashes.append(_sha1(out[r]))
            ls_hashes.append(_sha1(out_ls[r]))
        stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = p2p.spawn(rank_main, P, A, b, grid, tmp, hashes, reps,
                         coll_numel, str(dev), time.time(), ls_hashes,
                         ls_reps, unrolled, timeout=900)
        spawn_s = time.perf_counter() - t0
        scale = out.abs().max().item()
        for row in rows:
            row["max_abs_diff"] = 0.0
            if not row["bitwise"]:
                got = np.load(tmp / f"out{row['rank']}.npy")
                row["max_abs_diff"] = float(np.abs(
                    got - out[row["rank"]].cpu().numpy()).max())
            ls = row["level_serial"]
            ls["max_abs_diff"] = 0.0
            if not ls["bitwise"]:
                got = np.load(tmp / f"ls_out{row['rank']}.npy")
                ls["max_abs_diff"] = float(np.abs(
                    got - out_ls[row["rank"]].cpu().numpy()).max())
        diff_op = (None if all(row["bitwise"] for row in rows)
                   else differing_op(eng, vals, rows))
        unr = {tag: ranked_unrolled(
            f"laplacian_2d{lap} b=8" if tag == "lap" else setting, rows,
            tag, unr_progs[tag], unr_outs[tag], tmp) for tag in unr_progs}
        del unr_outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    level_serial = ranked_level_serial(setting, eng_ls, rows, scale,
                                       ls_reps)
    del out_ls, eng_ls
    PSelInvEngine.clear_cache()

    gemm_ops = eng.gemm_ops()
    stages = {k: max(row["stamps"][k] for row in rows)
              for k in rows[0]["stamps"]}
    log(f"{setting}: {P} rank processes on {dev} (gloo, staged through "
        f"pinned host buffers): values written and hashed in {stage_s:.1f}"
        f" s, ranks spawned, analyzed, solved and joined in {spawn_s:.1f} s"
        f" (host clock); the last rank past each stage, s after the spawn: "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    for row in rows:
        r0 = row["runs"][0]
        walls = [x["wall_s"] * 1e3 for x in row["runs"]]
        wires = [(x["rounds_s"] - x["sync_s"]) * 1e3 for x in row["runs"]]
        syncs = [x["sync_s"] * 1e3 for x in row["runs"]]
        log(f"  rank {row['rank']}: shard "
            + ("bitwise equal to the single-process one" if row["bitwise"]
               else f"differs, max|Δ| {row['max_abs_diff']:.3e}")
            + f"; block_gemm launches {[x['launches'] for x in row['runs']]}"
            f" ({r0['variants']}); sent {r0['sent'][0]} msgs "
            f"{r0['sent'][1]} B, received {r0['received'][0]} msgs "
            f"{r0['received'][1]} B, staged {r0['staged']} B a solve; wall "
            f"{[round(w, 1) for w in walls]} ms, of it on the wire "
            f"(staging copies + gloo) {[round(w, 1) for w in wires]} ms "
            f"and waiting for the card before a send "
            f"{[round(w, 1) for w in syncs]} ms, analyze "
            f"{row['analyze_s']:.2f} s")
    if diff_op is not None:
        log(f"  the differing op: {diff_op}; max|Δ| "
            f"{max(row['max_abs_diff'] for row in rows):.3e} against "
            f"1e-12·max|A⁻¹| = {1e-12 * scale:.3e}")
    bad = [row["rank"] for row in rows if not row["bitwise"]
           and not row["max_abs_diff"] <= 1e-12 * scale]
    if bad:
        raise AssertionError(f"{setting}: ranks {bad} differ from the "
                             "single-process solve by more than "
                             f"1e-12·max|A⁻¹| ({scale:.3e})")
    for i in range(reps):
        launches = [row["runs"][i]["launches"] for row in rows]
        if launches != [gemm_ops] * P:
            raise AssertionError(f"{setting}: ranked solve {i} launched "
                                 f"{launches} block GEMMs, plan has "
                                 f"{gemm_ops} a rank")
        if any(row["runs"][i]["variants"] != ["dmma_f64"] for row in rows):
            raise AssertionError(f"{setting}: a ranked f64 solve ran off "
                                 "the DMMA variant")
        sent = sum(row["runs"][i]["sent"][1] for row in rows)
        recv = sum(row["runs"][i]["received"][1] for row in rows)
        if not sent == recv == moved:
            raise AssertionError(f"{setting}: ranked solve {i} sent {sent}"
                                 f" B, received {recv} B, the session "
                                 f"moves {moved:.0f} B")
    solve_ms = [max(row["runs"][i]["barrier_s"] for row in rows) * 1e3
                for i in range(reps)]
    log(f"{setting}: ranked solve {[round(x, 1) for x in solve_ms]} ms "
        f"barrier to barrier (max over ranks), against the single-process "
        f"eager solve {state['solve_ms']:.1f} ms; sent {sent} B a solve = "
        f"the session's moved bytes {moved:.0f} = executed_wire_bytes; "
        f"{P} × {gemm_ops} block GEMM launches a solve, all dmma_f64")
    coll = {}
    for j, name in enumerate(r["name"] for r in rows[0]["collectives"]):
        cs = [row["collectives"][j] for row in rows]
        if not all(c["exact"] for c in cs):
            raise AssertionError(f"{name}: integer result not exact on "
                                 f"ranks {[c for c in cs if not c['exact']]}")
        wall = max(c["wall_s"] for c in cs)
        wire = sum(c["sent"][1] for c in cs)
        payload = coll_numel * 4
        coll[name] = dict(wall_ms=wall * 1e3, payload_bytes=payload,
                          wire_bytes=wire,
                          payload_gb_s=payload / wall / 1e9,
                          wire_gb_s=wire / wall / 1e9,
                          staged=sum(c["staged"] for c in cs))
        log(f"  {name}: {payload / 2**20:.0f} MiB f32 a rank, exact; wall "
            f"{wall * 1e3:.1f} ms (max over ranks, host clock), "
            f"{payload / wall / 1e9:.2f} GB/s of payload, wire {wire} B "
            f"({wire / wall / 1e9:.2f} GB/s), staged "
            f"{coll[name]['staged']} B")
    return dict(setting=setting, ranks=P, gemm_ops=gemm_ops, stages=stages,
                differing_op=diff_op, max_ainv=scale,
                level_serial=level_serial, unrolled=unr,
                launches=sum(x["launches"] for row in rows
                             for x in row["runs"])
                + level_serial["launches"]
                + sum(u["launches"] for u in unr.values()),
                moved_bytes=moved, solve_ms=solve_ms,
                single_ms=state["solve_ms"], spawn_s=spawn_s,
                stage_s=stage_s, collectives=coll,
                rows=[{k: v for k, v in row.items()} for row in rows])


# ---------------------------------------------------------------------------
# phase 4: the serial supernodal path (factorize + selinv) on the card
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
# phase 7: the ops entry points, through the port's kernel benchmark
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


# ---------------------------------------------------------------------------
# phase 9b: the port's benchmark CLI on the card, and the size baseline
# ---------------------------------------------------------------------------

#: the speed ratios the JAX bench asserts on a CPU host, and their bars
SPEED_BARS = (("engine_batched_speedup", "batched B=16 over sequential"),
              ("serve_throughput_rps", "coalesced serving over sequential"),
              ("trace_overhead_pct", "tracing tax on the solve"))


def bench_path(dev, only="kernels,selinv,treecomm", timeout=600):
    """Phase 9b: ``python -m repro_torch.benchmarks.run --only <only>
    --json build/bench_torch.json`` as a subprocess on the card. Fails
    unless it exits 0 and its session holds every row
    ``tools.record_bench`` requires (recorded, as that tool records it,
    into ``build/bench_torch_history.json``). Prints the speed ratios the
    JAX bench asserts and whether each met its bar here; then loads the
    size baseline from the committed ``BENCH_pselinv_torch.json`` (its
    newest card entry, ``exec_verify.load_size_baseline``) and lints the
    nb=16 4×2 f32 stream class on the card against it
    (``engine.lint_compiled(baseline=)``): no diagnostic, so a graph or an
    op count grown past the ratio over the recorded one fails here."""
    import os

    import torch
    from repro_torch.core import sparse
    from repro_torch.core.engine import Grid, PlanOptions, PSelInvEngine
    from repro_torch.core.exec_verify import load_size_baseline
    from repro_torch.tools import record_bench

    OUT_DIR.mkdir(exist_ok=True)
    session = OUT_DIR / "bench_torch.json"
    hist = OUT_DIR / "bench_torch_history.json"
    for p in (session, hist):
        if p.exists():
            p.unlink()
    PSelInvEngine.clear_cache()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only", only,
         "--json", str(session), "--device", dev.type], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    wall_s = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        log(f"  bench: {line}")
    if r.returncode:
        raise AssertionError(f"benchmarks.run exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    record_bench.main(["--session", str(session), "--only", only,
                       "--device", dev.type, "--rev", "chip_smoke",
                       "--out", str(hist)])
    rows = {row["name"]: row
            for row in json.loads(session.read_text())["benches"]}
    ratios = {}
    for name, what in SPEED_BARS:
        row = rows[f"selinv/{name}"]
        met = re.search(r"bar=(\S+) met=(\w+)", row["derived"])
        value = row["us_per_call"]
        if name == "serve_throughput_rps":
            value = float(re.search(r"speedup=(\S+)",
                                    row["derived"]).group(1))
        ratios[name] = dict(value=value, bar=met.group(1),
                            met=met.group(2) == "True")
        log(f"  {what}: {value:.2f} against the JAX bar {met.group(1)} — "
            + ("met" if ratios[name]["met"] else "NOT met") + " on this card")
    recorded = ROOT / "BENCH_pselinv_torch.json"
    baseline = load_size_baseline(str(recorded))
    if baseline is None:
        raise AssertionError(f"no card entry with a size baseline in "
                             f"{recorded.name}")
    eng = PSelInvEngine.analyze(sparse.laplacian_2d(16, 8), b=8,
                                grid=Grid(4, 2),
                                options=PlanOptions(stream=True), device=dev)
    lint = eng.lint_compiled(dtype=torch.float32, baseline=baseline)
    if len(lint):
        raise AssertionError("the nb=16 4x2 stream class against its size "
                             f"baseline {baseline}: "
                             + "; ".join(map(str, lint)))
    log(f"benchmarks.run --only {only} on the card: exit 0 in {wall_s:.1f}"
        f" s (host clock), {len(rows)} rows, every required row present; "
        f"size baseline {baseline} from {recorded.name}; the nb=16 4x2 f32 "
        f"stream class lints clean against it (graph kernels "
        f"{lint.info.get('graph_kernels')}, dispatched ops "
        f"{lint.info['dispatched_ops']})")
    del eng
    PSelInvEngine.clear_cache()
    return dict(wall_s=wall_s, rows=len(rows), ratios=ratios,
                baseline=baseline,
                lint=dict(graph_kernels=lint.info.get("graph_kernels"),
                          dispatched_ops=lint.info["dispatched_ops"]))


# ---------------------------------------------------------------------------
# phase 10: the LM serving path — dense decoders at full width
# ---------------------------------------------------------------------------

#: logits are held to rtol 5e-2 and atol 5e-2 · max(1, max|ref|), the
#: padded vocab columns left out (as ``tests/test_torch_models.py``)
LM_TOL = 5e-2
#: teacher-forced decode steps held against the prefill's logits
LM_STEPS = 16
#: phase 10b: ``ServeEngine`` at granite-3-2b's full size
LM_SERVE = dict(slots=8, max_seq=2048, requests=16, max_new=32)
#: the kernels at the shapes the LM path gives them: granite's decode
#: rows (8 slots, and 1 teacher-forced) and prefill rows, qwen3-32b's
#: d_model row and its qk-norm rows (q: 64 heads, k: 8 heads a token)
LM_RMS_SHAPES = [(8, 2048), (1, 2048), (2048, 2048), (1, 5120), (64, 128),
                 (8, 128),
                 # phase 11's decode rows: dbrx/grok (1 and 8 slots),
                 # jamba, xlstm-125m, seamless
                 (1, 6144), (8, 6144), (1, 8192), (1, 768), (1, 1024)]
#: granite's prefill; dbrx/grok's (phase 11, causal) and seamless's
#: encoder (non-causal); ``flash_checks`` runs each causal and not
LM_FLASH_SHAPES = [((1, 2048, 32, 64), ("bfloat16",)),
                   ((1, 2048, 48, 128), ("bfloat16",)),
                   ((1, 1024, 16, 64), ("bfloat16",))]


def lm_close(out, ref, what, bound=1.0):
    """max|Δ| of ``out`` against ``ref`` (logits over the real vocab), and
    the share of rtol 5e-2 + atol 5e-2 · max(1, max|ref|) it uses;
    raises past ``bound`` shares or on a non-finite value."""
    import torch
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"LM {what}: non-finite logits")
    atol = LM_TOL * max(1.0, ref.abs().max().item())
    delta = (out - ref).abs()
    used = (delta / (atol + LM_TOL * ref.abs())).max().item()
    err = delta.max().item()
    if not used <= bound:
        raise AssertionError(f"LM {what}: max|Δ| {err:.3e} uses {used:.2f}×"
                             f" the tolerance (atol {atol:.3e}), the bound "
                             f"is {bound:.2f}×")
    return err, used


_RMS_CLASS = "rmsnorm (hand-written)"


def _lm_class(k):
    if "rmsnorm" in k:
        return _RMS_CLASS
    if "flash_attention" in k:
        return "flash_attention (hand-written)"
    if any(x in k for x in _CUBLAS):
        return "cuBLAS (linears, decode einsums)"
    return "elementwise / index / softmax"


def lm_trace(fn, rms_launches, tries=3):
    """``fn()`` traced after one warm-up call (:func:`trace_device`):
    device time by kernel class against its wall. A trace counts only
    when it holds the ``rms_launches`` RMSNorm kernels ``fn`` launched
    (the profiler can lose the kernels launched through ctypes) and no
    more device time than its wall (one stream). Up to ``tries`` traces
    are taken, two calls of ``fn`` each; with none complete the busy
    share reads not measured."""
    recorded = []
    for _ in range(tries):
        wall_us, classes, counts, _ = trace_device(fn, _lm_class, warm=1)
        busy = sum(classes.values())
        recorded.append(counts.get(_RMS_CLASS, 0))
        if 0 < busy <= wall_us and recorded[-1] == rms_launches:
            return dict(wall_us=wall_us, busy_us=busy,
                        busy_share=busy / wall_us,
                        kernels=sum(counts.values()),
                        rmsnorm_recorded=recorded, classes_us=classes)
        log(f"  trace: {recorded[-1]} of {rms_launches} RMSNorm kernels, "
            f"{busy:.0f} µs of device time in a {wall_us:.0f} µs wall")
    log("  trace: no complete trace — busy share not measured")
    return dict(wall_us=wall_us, busy_us=None, busy_share=None,
                rmsnorm_recorded=recorded)


def _lm_model(dev, arch, n_layers=None, **cut):
    """The config (depth cut to ``n_layers`` and any other field to
    ``cut`` when given), its API and the serving model from the port's
    seeded init, drawn on the card (:data:`HOST_INIT`: on the host, then
    moved to the card)."""
    import dataclasses

    from repro_torch.config import get_config
    from repro_torch.models import get_model

    cfg = get_config(arch)
    if n_layers is not None:
        cut = dict(n_layers=n_layers, **cut)
    reduced = ", ".join(f"{k} {getattr(cfg, k)}→{v}"
                        for k, v in cut.items()) or None
    cfg = dataclasses.replace(cfg, **cut)
    api = get_model(cfg)
    t0 = time.perf_counter()
    on_host = arch in HOST_INIT
    params = api.serving_params(api.init(0, device="cpu" if on_host
                                         else dev)).to(dev)
    _sync(dev)
    _empty_cache(dev)           # the f32 init is gone: peaks start here
    return cfg, api, params, reduced, time.perf_counter() - t0


def lm_model_path(dev, arch, S, n_layers=None, steps=LM_STEPS):
    """Phase 10a / 10c: the full-width model on the card — a (1, S)
    prefill through ``lm_forward`` and ``ModelAPI.prefill`` (one flash
    launch a layer, RMSNorm at every norm), ``steps`` teacher-forced
    decode steps of the same tokens held against the prefill's
    logits, and the same prefill and steps through the plain versions
    (``layers.plain_kernels``) held against the kernel route. Counts are
    zeroed right before each run and read right after it."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.models import layers as ml
    from repro_torch.models import transformer as tfm

    _empty_cache(dev)
    cfg, api, params, reduced, init_s = _lm_model(dev, arch, n_layers)
    L, V = cfg.n_layers, cfg.vocab
    per_step = (4 if cfg.qk_norm else 2) * L + 1
    n_params = sum(w.numel() for w in params.parameters())
    g = torch.Generator(device=dev).manual_seed(10)
    toks = torch.randint(0, V, (1, S), device=dev, generator=g)

    def prefill():
        return tfm.lm_forward(params, cfg, toks)[0]

    def decode(counts=None):
        cache = api.init_cache(1, S, device=dev)
        out = []
        for t in range(steps):
            before = rk.launches
            lg, cache = api.decode_step(params, toks[:, t],
                                        torch.full((1,), t, device=dev),
                                        cache)
            if counts is not None:
                counts.append(rk.launches - before)
            out.append(lg)
        _sync(dev)
        return torch.stack(out, 1)

    launches = dict(rmsnorm=0, flash_attention=0)
    rms_variants = collections.Counter()
    zero_counts()
    full = prefill()
    _sync(dev)
    pre = read_counts()
    pre_variants = dict(fa.plans)
    rms_variants.update(rk.plans)
    zero_counts()
    last = api.prefill(params, {"tokens": toks})
    _sync(dev)
    entry = read_counts()
    rms_variants.update(rk.plans)
    zero_counts()
    step_counts = []
    dec = decode(step_counts)
    dcounts = read_counts()
    rms_variants.update(rk.plans)
    for c in (pre, entry, dcounts):
        for k in launches:
            launches[k] += c[k]
    want_pre = dict(block_gemm=0, trsm=0, rmsnorm=per_step,
                    flash_attention=L)
    if pre != want_pre or entry != want_pre:
        raise AssertionError(f"{arch} prefill launches {pre} / {entry}, "
                             f"want {want_pre}")
    if set(pre_variants) - {"hmma_cpasync", "hmma_guarded"}:
        raise AssertionError(f"{arch} prefill flash off the tensor cores: "
                             f"{pre_variants}")
    if step_counts != [per_step] * steps or dcounts["flash_attention"]:
        raise AssertionError(f"{arch} decode RMSNorm launches a step "
                             f"{step_counts}, want {per_step}; {dcounts}")
    if not torch.equal(last, full[:, -1:]):
        raise AssertionError(f"{arch}: ModelAPI.prefill differs from the "
                             "forward's last position")
    err_pd, used_pd = lm_close(dec[0, :, :V], full[0, :steps, :V],
                               f"{arch} decode vs prefill")
    with ml.plain_kernels():
        zero_counts()
        pfull = prefill()
        pdec = decode()
        plain_counts = read_counts()
    if any(plain_counts.values()):
        raise AssertionError(f"{arch}: the plain route launched kernels: "
                             f"{plain_counts}")
    err_pp, used_pp = lm_close(full[..., :V], pfull[..., :V],
                               f"{arch} prefill, kernels vs plain")
    err_dp, used_dp = lm_close(dec[..., :V], pdec[..., :V],
                               f"{arch} decode, kernels vs plain")
    top = full[0, -1, :V].float().topk(2).values.tolist()
    del pfull, pdec, full, dec, last
    _empty_cache(dev)
    prefill_ms = timed_ms(prefill, reps=3)
    with ml.plain_kernels():
        plain_prefill_ms = timed_ms(prefill, reps=3)
    cache = api.init_cache(1, S, device=dev)
    tok0, pos0 = toks[:, 0], torch.zeros(1, dtype=torch.long, device=dev)
    step_ms = timed_ms(lambda: api.decode_step(params, tok0, pos0, cache),
                       reps=10, warm=2)
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in params.parameters())
    row = dict(arch=arch, reduced=reduced, S=S, params=n_params,
               weight_bytes=weight_bytes, init_s=init_s,
               launches_prefill=pre, launches_per_step=per_step,
               prefill_variants=pre_variants, prefill_ms=prefill_ms,
               plain_prefill_ms=plain_prefill_ms, decode_step_ms=step_ms,
               decode_vs_prefill=dict(max_abs_err=err_pd, tol_used=used_pd),
               plain_prefill=dict(max_abs_err=err_pp, tol_used=used_pp),
               plain_decode=dict(max_abs_err=err_dp, tol_used=used_dp),
               last_top2=top, peak_bytes=peak, launches=launches,
               rmsnorm_variants=dict(rms_variants))
    size = "full size" if reduced is None else f"reduced: {reduced}"
    log(f"LM {arch} ({size}, {n_params / 1e9:.3f} B params, "
        f"{weight_bytes / 1e9:.2f} GB bf16, init {init_s:.1f} s): prefill (1, {S}) {prefill_ms:.1f} ms "
        f"(plain route {plain_prefill_ms:.1f} ms), launches {pre} on "
        f"{pre_variants}; decode step {step_ms:.2f} ms, {per_step} RMSNorm "
        f"launches a step x {steps}; decode vs prefill max|Δ| {err_pd:.3e} "
        f"({used_pd:.3f} of the tolerance), kernels vs plain: prefill "
        f"{err_pp:.3e} ({used_pp:.3f}), decode {err_dp:.3e} ({used_dp:.3f});"
        f" peak {peak / 2**30:.2f} GiB")
    del params, cache
    _empty_cache(dev)
    return row


def _empty_cache(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def lm_serve_path(dev, arch="granite-3-2b", serve=LM_SERVE,
                  cli_requests=4, timeout=300):
    """Phase 10b: ``ServeEngine`` on the full-size model — ``requests``
    requests with prompts of 2–8 tokens (numpy, seed 0), continuous
    batching over ``slots`` slots of a ``max_seq`` cache; one step
    traced for its busy share (:func:`lm_trace`; the steps run under the
    profiler are left out of the step times and the tokens/s); then ``python -m repro_torch.launch.serve
    --arch <arch> --scale full --requests <cli_requests>`` as a
    subprocess, which must exit 0 with every request completed."""
    import os

    import numpy as np
    import torch
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.runtime import Request, ServeEngine

    _empty_cache(dev)
    cfg, api, params, _, _ = _lm_model(dev, arch)
    per_step = (4 if cfg.qk_norm else 2) * cfg.n_layers + 1
    eng = ServeEngine(api, params, batch_slots=serve["slots"],
                      max_seq=serve["max_seq"])
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
                        1, cfg.vocab, rng.integers(2, 9)).tolist(),
                    max_new=serve["max_new"])
            for i in range(serve["requests"])]
    for r in reqs:
        eng.submit(r)

    def made():
        return sum(len(r.out) for r in reqs)

    zero_counts()
    t0 = time.perf_counter()
    for _ in range(4):
        eng.step()
    t1 = time.perf_counter()
    traced_tok, i0 = made(), len(eng.step_s)
    trace = lm_trace(eng.step, per_step)
    traced_tok, i1 = made() - traced_tok, len(eng.step_s)
    t2 = time.perf_counter()
    eng.run()
    _sync(dev)
    wall = (time.perf_counter() - t2) + (t1 - t0)
    counts = read_counts()
    rms_variants = dict(rk.plans)
    steps = len(eng.step_s)
    untraced = eng.step_s[:i0] + eng.step_s[i1:]
    if counts["rmsnorm"] != per_step * steps or counts["flash_attention"]:
        raise AssertionError(f"serve: launches {counts} over {steps} steps, "
                             f"want {per_step} RMSNorm a step")
    for r in reqs:
        if not (r.done and len(r.out) == serve["max_new"]
                and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"serve: request {r.rid} incomplete or "
                                 f"out of vocab: {r.out}")
    n_tok = made()
    rate = (n_tok - traced_tok) / wall      # the traced step left out
    ms = sorted(1e3 * t for t in untraced)
    p50 = statistics.median(ms)
    p95 = ms[min(len(ms) - 1, int(round(0.95 * (len(ms) - 1))))]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    res = dict(arch=arch, **serve, completed=sum(r.done for r in reqs),
               steps=steps, tokens=n_tok, traced_step_tokens=traced_tok,
               wall_s=wall, tok_per_s=rate,
               step_ms_p50=p50, step_ms_p95=p95, trace=trace,
               peak_bytes=peak, launches=counts, launches_per_step=per_step,
               rmsnorm_variants=rms_variants)
    share = trace.get("busy_share")
    log(f"LM serve {arch} full size: {res['completed']}/{len(reqs)} "
        f"requests, {n_tok} tokens in {steps} steps; {n_tok - traced_tok} "
        f"of them in {wall:.2f} s (host clock) outside the traced step: "
        f"{rate:.1f} tokens/s; "
        f"{i1 - i0} steps under the profiler; "
        f"decode step p50 {p50:.2f} ms, p95 {p95:.2f} ms; traced step "
        f"busy {'not measured' if share is None else f'{100 * share:.1f} %'}"
        f" ({trace.get('kernels')} kernels, "
        + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                    sorted((trace.get("classes_us") or {}).items(),
                           key=lambda x: -x[1]))
        + f"); peak {peak / 2**30:.2f} GiB; launches {counts}")
    del eng, params
    _empty_cache(dev)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--scale", "full", "--requests", str(cli_requests), "--device",
         dev.type], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)
    cli_s = time.perf_counter() - t0
    for line in r.stdout.splitlines()[:4]:
        log(f"  launch.serve: {line}")
    want = f"completed {cli_requests}/{cli_requests} requests"
    if r.returncode or want not in r.stdout:
        raise AssertionError(f"launch.serve exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    log(f"  launch.serve --scale full --requests {cli_requests}: exit 0 in "
        f"{cli_s:.1f} s (host clock, process start included)")
    res["cli_s"] = cli_s
    return res


def lm_path(dev):
    """Phase 10: (a) granite-3-2b at full size, (b) served through
    ``ServeEngine`` and the launcher, (c) qwen3-32b at full width with
    its depth cut to 2 layers. The RMSNorm and flash kernels are held
    against their plain versions at the shapes this path gives them in
    phase 2b (:data:`LM_RMS_SHAPES`, :data:`LM_FLASH_SHAPES`): late in the
    script the profiler traced no device time for the hand-written
    kernels (PR 20), and those rows need it."""
    t0 = time.perf_counter()
    granite = lm_model_path(dev, "granite-3-2b", 2048)
    serve = lm_serve_path(dev)
    qwen = lm_model_path(dev, "qwen3-32b", 4096, n_layers=2)
    launches = {k: granite["launches"][k] + qwen["launches"][k]
                + serve["launches"][k] for k in ("rmsnorm",
                                                 "flash_attention")}
    wall = time.perf_counter() - t0
    log(f"phase 10 (LM serving path): {wall:.1f} s, main-path launches "
        f"{launches}")
    return dict(granite=granite, serve=serve, qwen3=qwen,
                launches=launches, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 11: the other LM families at full width
# ---------------------------------------------------------------------------

#: xlstm-125m's input-gate stabiliser is a max over the whole tensor, so
#: its decode departs from its prefill by design, by an amount that
#: depends on the weights and tokens. ``tests/xlstm_decode_gap.py``
#: measures the JAX package's own gap on the CPU on the weights and
#: tokens of phase 11 (the port's seeded init drawn on the host, tokens
#: from numpy seed 10), in tolerances, and the weights' fingerprint (the
#: port's own gap there: 20.77 on the CPU)
XLSTM_GAP = dict(jax_decode_vs_prefill=19.872344970703125,
                 weights_fingerprint=9966.589053148733)
#: archs whose seeded init is drawn on the host and moved to the card,
#: so that the CPU draws the same weights
HOST_INIT = {"xlstm-125m"}
#: (arch, the cut, the prefill, the bound on decode against prefill in
#: tolerances): depth (jamba: and experts) cut to fit the card's 80 GB in
#: bf16 beside the prefill's activations; xlstm-125m at 1.1 × the JAX
#: package's gap, and its sLSTM layers alone (whose running-max
#: stabiliser makes decode and prefill the same function) at the
#: tolerance.
FAMILY_RUNS = [
    ("dbrx-132b", dict(n_layers=4), 2048, 1.0),
    ("grok-1-314b", dict(n_layers=2), 2048, 1.0),
    ("jamba-1.5-large-398b", dict(n_layers=8, n_experts=4), 2048, 1.0),
    ("xlstm-125m", {}, 2048, 1.1 * XLSTM_GAP["jax_decode_vs_prefill"]),
    ("xlstm-125m", dict(xlstm_pattern=("s",), n_layers=4, layer_group=1),
     256, 1.0),
    ("seamless-m4t-large-v2", {}, (1024, 256), 1.0),
]
#: phase 11's served models: 8 slots, a 2048-token cache, 16 requests
FAMILY_SERVE = [("dbrx-132b", dict(n_layers=4)), ("xlstm-125m", {})]


def lm_norms_per_step(cfg):
    """RMSNorm launches of one decode step: two a ``mixer+ffn`` layer
    (four with qk-norm on attention), one an xLSTM layer, three an
    enc-dec decoder layer, and the final norm."""
    from repro_torch.models.transformer import layer_kinds
    if cfg.enc_layers:
        return 3 * cfg.n_layers + 1
    n = 1
    for kind in layer_kinds(cfg):
        if kind in ("mlstm", "slstm"):
            n += 1
        else:
            n += 2 + (2 if cfg.qk_norm and kind.startswith("attn") else 0)
    return n


def lm_rows_close(out, ref, rows_out, what, bound=1.0):
    """:func:`lm_close` over the positions (axis 1 of (1, S, V) logits)
    not in ``rows_out`` (:func:`moe.route_flips`'s rows), held to
    ``bound`` tolerances."""
    import torch
    keep = [t for t in range(out.shape[1]) if t not in set(rows_out)]
    idx = torch.tensor(keep, device=out.device)
    return lm_close(out.index_select(1, idx), ref.index_select(1, idx),
                    what, bound)


def family_path(dev, arch, cut, shape, bound, steps=LM_STEPS):
    """Phase 11 (a)-(e): one family at full width (see the module note),
    decode against prefill held to ``bound`` tolerances. Counts are zeroed
    right before each run and read right after it."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.models import encdec
    from repro_torch.models import layers as ml
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.transformer import layer_kinds

    _empty_cache(dev)
    cfg, api, params, reduced, init_s = _lm_model(dev, arch, **cut)
    if arch in HOST_INIT and not cut:
        fp = sum(w.detach().cpu().double().sum().item()
                 for w in params.parameters())
        want = XLSTM_GAP["weights_fingerprint"]
        if not abs(fp - want) <= 1e-9 * abs(want):
            raise AssertionError(f"{arch}: weights fingerprint {fp!r}, the "
                                 f"JAX gap was measured on {want!r}")
    V = cfg.vocab
    per_step = lm_norms_per_step(cfg)
    kinds = layer_kinds(cfg)
    n_moe = sum(x.endswith("moe") for x in kinds)
    g = torch.Generator(device=dev).manual_seed(10)
    if cfg.enc_layers:
        S_enc, S = shape
        frames = torch.randn(1, S_enc, cfg.d_model, device=dev, generator=g)
        flash_pre = cfg.enc_layers + cfg.n_layers
        norms_pre = 2 * cfg.enc_layers + 1 + per_step
    else:
        S = shape
        frames = None
        flash_pre = sum(x.startswith("attn") for x in kinds)
        norms_pre = per_step
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, V, (1, S))).to(dev)
    n_params = sum(w.numel() for w in params.parameters())
    # the sLSTM time scan and the mamba segment-sum take seconds a prefill
    reps = 1 if any(x == "slstm" or x.startswith("mamba")
                    for x in kinds) else 3

    def prefill():
        if frames is not None:
            return encdec.encdec_forward(params, cfg, toks, frames)
        return tfm.lm_forward(params, cfg, toks)[0]

    def new_cache():
        if frames is not None:
            return encdec.encdec_init_cache(params, cfg, frames, S)
        return api.init_cache(1, S, device=dev)

    def decode(cache, counts=None):
        out = []
        for t in range(steps):
            before = rk.launches
            lg, cache = api.decode_step(params, toks[:, t],
                                        torch.full((1,), t, device=dev),
                                        cache)
            if counts is not None:
                counts.append(rk.launches - before)
            out.append(lg)
        _sync(dev)
        return torch.stack(out, 1)

    batch = {"tokens": toks} if frames is None else {"tokens": toks,
                                                      "frontend": frames}
    launches = dict(rmsnorm=0, flash_attention=0)
    rms_variants = collections.Counter()
    zero_counts()
    with moe.RouteLog() as r_pre:
        full = prefill()
        _sync(dev)
    pre = read_counts()
    pre_variants = dict(fa.plans)
    rms_variants.update(rk.plans)
    zero_counts()
    last = api.prefill(params, batch)
    _sync(dev)
    entry = read_counts()
    rms_variants.update(rk.plans)
    cache = new_cache()
    _sync(dev)
    zero_counts()
    step_counts = []
    with moe.RouteLog() as r_dec:
        dec = decode(cache, step_counts)
    dcounts = read_counts()
    rms_variants.update(rk.plans)
    for c in (pre, entry, dcounts):
        for key in launches:
            launches[key] += c[key]
    want_pre = dict(block_gemm=0, trsm=0, rmsnorm=norms_pre,
                    flash_attention=flash_pre)
    if pre != want_pre or entry != want_pre:
        raise AssertionError(f"{arch} prefill launches {pre} / {entry}, "
                             f"want {want_pre}")
    if flash_pre and set(pre_variants) - {"hmma_cpasync", "hmma_guarded"}:
        raise AssertionError(f"{arch} prefill flash off the tensor cores: "
                             f"{pre_variants}")
    if step_counts != [per_step] * steps or dcounts["flash_attention"]:
        raise AssertionError(f"{arch} decode RMSNorm launches a step "
                             f"{step_counts}, want {per_step}; {dcounts}")
    if not torch.equal(last, full[:, -1:]):
        raise AssertionError(f"{arch}: ModelAPI.prefill differs from the "
                             "forward's last position")
    flips = {}
    if n_moe:
        a = moe.routes_by_layer(r_dec.calls, n_moe, 1)
        b = moe.routes_by_layer(r_pre.calls, n_moe, 1, upto=steps)
        if not all(x.keep.all() for x in a + b):
            raise AssertionError(f"{arch}: a slot dropped in the first "
                                 f"{steps} tokens")
        # a flip carries into every later step (KV cache, mamba state)
        first = min(moe.route_flips(a, b, steps, f"{arch} decode vs "
                                    "prefill", log=log), default=steps)
        flips["decode"] = list(range(first, steps))
    err_pd, used_pd = lm_rows_close(
        dec[..., :V], full[:, :steps, :V], flips.get("decode", ()),
        f"{arch} decode vs prefill", bound)
    with ml.plain_kernels():
        zero_counts()
        with moe.RouteLog() as r_plain:
            pfull = prefill()
            pdec = decode(new_cache())
        plain_counts = read_counts()
    if any(plain_counts.values()):
        raise AssertionError(f"{arch}: the plain route launched kernels: "
                             f"{plain_counts}")
    if n_moe:
        flips["plain prefill"] = moe.route_flips(
            r_plain.calls[:n_moe], r_pre.calls, S,
            f"{arch} plain vs kernel prefill", log=log)
        flips["plain decode"] = moe.route_flips(
            moe.routes_by_layer(r_plain.calls[n_moe:], n_moe, 1),
            moe.routes_by_layer(r_dec.calls, n_moe, 1), steps,
            f"{arch} plain vs kernel decode", log=log)
    err_pp, used_pp = lm_rows_close(full[..., :V], pfull[..., :V],
                                    flips.get("plain prefill", ()),
                                    f"{arch} prefill, kernels vs plain")
    err_dp, used_dp = lm_rows_close(dec[..., :V], pdec[..., :V],
                                    flips.get("plain decode", ()),
                                    f"{arch} decode, kernels vs plain")
    top = full[0, -1, :V].float().topk(2).values.tolist()
    del pfull, pdec, full, dec, last
    _empty_cache(dev)
    prefill_ms = timed_ms(prefill, reps=reps, warm=1)
    with ml.plain_kernels():
        plain_prefill_ms = timed_ms(prefill, reps=reps, warm=1)
    cache = new_cache()
    tok0, pos0 = toks[:, 0], torch.zeros(1, dtype=torch.long, device=dev)
    step_ms = timed_ms(lambda: api.decode_step(params, tok0, pos0, cache),
                       reps=10, warm=2)
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in params.parameters())
    row = dict(arch=arch, reduced=reduced, S=S, shape=shape, params=n_params,
               weight_bytes=weight_bytes, init_s=init_s,
               launches_prefill=pre, launches_per_step=per_step,
               prefill_variants=pre_variants, prefill_ms=prefill_ms,
               plain_prefill_ms=plain_prefill_ms, decode_step_ms=step_ms,
               decode_vs_prefill=dict(max_abs_err=err_pd, tol_used=used_pd,
                                      bound=bound),
               plain_prefill=dict(max_abs_err=err_pp, tol_used=used_pp),
               plain_decode=dict(max_abs_err=err_dp, tol_used=used_dp),
               routing_flips={k: len(v) for k, v in flips.items()},
               last_top2=top, peak_bytes=peak, launches=launches,
               rmsnorm_variants=dict(rms_variants))
    log(f"LM {arch} (reduced: {reduced or 'none, full size'}; "
        f"{n_params / 1e9:.3f} B params, {weight_bytes / 1e9:.2f} GB, init "
        f"{init_s:.1f} s): prefill {shape} {prefill_ms:.1f} ms (plain route "
        f"{plain_prefill_ms:.1f} ms), launches {pre} on {pre_variants}; "
        f"decode step {step_ms:.2f} ms, {per_step} RMSNorm launches a step "
        f"x {steps}; decode vs prefill max|Δ| {err_pd:.3e} ({used_pd:.3f} "
        f"of the tolerance, bound {bound:.2f}), kernels vs plain: prefill "
        f"{err_pp:.3e} ({used_pp:.3f}), decode {err_dp:.3e} "
        f"({used_dp:.3f}); routing flips left out "
        f"{row['routing_flips']}; peak {peak / 2**30:.2f} GiB")
    del params, cache
    _empty_cache(dev)
    return row


def family_serve(dev, arch, cut, serve=LM_SERVE, runs=1):
    """Phase 11 serving: ``ServeEngine`` on ``arch`` (cut as ``cut``),
    ``runs`` times on the same requests (the tokens of every run bitwise
    equal to the first's); step p50/p95, tokens/s and, with MoE, the
    (token, choice) slots dropped by capacity per step."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.runtime import Request, ServeEngine

    _empty_cache(dev)
    cfg, api, params, reduced, _ = _lm_model(dev, arch, **cut)
    per_step = lm_norms_per_step(cfg)
    n_moe = sum(x.endswith("moe") for x in layer_kinds(cfg))
    rows = []
    for run in range(runs):
        eng = ServeEngine(api, params, batch_slots=serve["slots"],
                          max_seq=serve["max_seq"])
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
                            1, cfg.vocab, rng.integers(2, 9)).tolist(),
                        max_new=serve["max_new"])
                for i in range(serve["requests"])]
        for r in reqs:
            eng.submit(r)
        zero_counts()
        t0 = time.perf_counter()
        with moe.RouteLog() as routes:
            eng.run()
            _sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = len(eng.step_s)
        if counts["rmsnorm"] != per_step * steps or counts["flash_attention"]:
            raise AssertionError(f"serve {arch}: launches {counts} over "
                                 f"{steps} steps, want {per_step} RMSNorm "
                                 "a step")
        for r in reqs:
            if not (r.done and len(r.out) == serve["max_new"]
                    and all(0 <= t < cfg.vocab for t in r.out)):
                raise AssertionError(f"serve {arch}: request {r.rid} "
                                     f"incomplete or out of vocab: {r.out}")
        tokens = [r.out for r in reqs]
        if rows and tokens != rows[0]["tokens_out"]:
            raise AssertionError(f"serve {arch}: run {run} made other tokens"
                                 " than run 0")
        dropped = None
        if n_moe:
            d = torch.stack([(~r.keep).sum() for r in routes.calls]).cpu()
            dropped = d.reshape(steps, n_moe).sum(1).tolist()
        ms = sorted(1e3 * t for t in eng.step_s)
        n_tok = sum(len(r.out) for r in reqs)
        row = dict(run=run, completed=sum(r.done for r in reqs),
                   steps=steps, tokens=n_tok, wall_s=wall,
                   tok_per_s=n_tok / wall, step_ms_p50=statistics.median(ms),
                   step_ms_p95=ms[min(len(ms) - 1,
                                      int(round(0.95 * (len(ms) - 1))))],
                   dropped_per_step=dropped, launches=counts,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   tokens_out=tokens)
        rows.append(row)
        log(f"LM serve {arch} (reduced: {reduced or 'none, full size'}) run "
            f"{run}: {row['completed']}/{len(reqs)} requests, {n_tok} tokens"
            f" in {steps} steps, {wall:.2f} s (host clock): "
            f"{row['tok_per_s']:.1f} tokens/s; step p50 "
            f"{row['step_ms_p50']:.2f} ms, p95 {row['step_ms_p95']:.2f} ms"
            + ("" if dropped is None else
               f"; slots dropped by capacity a step: {dropped} "
               f"(sum {sum(dropped)})")
            + f"; peak {row['peak_bytes'] / 2**30:.2f} GiB"
            + ("; tokens bitwise run 0's" if run else ""))
        del eng
    del params
    _empty_cache(dev)
    return dict(arch=arch, reduced=reduced, **serve, runs=rows)


def families_path(dev, cli_requests=4, timeout=300):
    """Phase 11: :data:`FAMILY_RUNS`, :data:`FAMILY_SERVE` (dbrx twice,
    bitwise), and ``launch.serve --arch xlstm-125m --scale full``."""
    import os
    t0 = time.perf_counter()
    models = [family_path(dev, arch, cut, shape, bound)
              for arch, cut, shape, bound in FAMILY_RUNS]
    serve = [family_serve(dev, arch, cut, runs=2 if cut else 1)
             for arch, cut in FAMILY_SERVE]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-125m", "--scale", "full", "--requests", str(cli_requests),
         "--device", dev.type], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout)
    cli_s = time.perf_counter() - t1
    for line in r.stdout.splitlines()[:4]:
        log(f"  launch.serve: {line}")
    want = f"completed {cli_requests}/{cli_requests} requests"
    if r.returncode or want not in r.stdout:
        raise AssertionError(f"launch.serve exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    log(f"  launch.serve --arch xlstm-125m --scale full --requests "
        f"{cli_requests}: exit 0 in {cli_s:.1f} s (host clock, process "
        "start included)")
    launches = {key: sum(m["launches"][key] for m in models)
                + sum(run["launches"][key] for s_ in serve
                      for run in s_["runs"])
                for key in ("rmsnorm", "flash_attention")}
    wall = time.perf_counter() - t0
    log(f"phase 11 (LM families): {wall:.1f} s, main-path launches "
        f"{launches}")
    return dict(models=models, serve=serve, cli_s=cli_s, launches=launches,
                wall_s=wall)


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
    # phase 10's kernels at the LM path's shapes, checked while the
    # profiler still traces them (see lm_path)
    lm_rows = rmsnorm_checks(dev, LM_RMS_SHAPES) + flash_checks(
        dev, LM_FLASH_SHAPES)
    # phase 3, then 3b (the other executors) and 3d (each executor's
    # solve as a CUDA-graph replay) on each setting's prepared values, 3c
    # (the per-round replay) and 5a (the server) on the FEM setting
    fem = main_path(dev, "fem3d_like(16,16,16,3)",
                    lambda: sparse.fem3d_like_matrix(16, 16, 16, 3), 96)
    fem["multirank"] = multirank_path(dev, fem["setting"], fem["_state"], 96)
    fem["capture"] = {}
    fem["executors"] = executor_path(dev, fem["setting"], fem["_state"], 96,
                                     batch=True, captures=fem["capture"])
    fem["unrolled"] = unrolled_path(dev, fem["setting"], fem["_state"], 96)
    fem["round_profile"] = profile_path(dev, fem["setting"], fem["_state"])
    fem["serve"] = serve_path(dev, fem["setting"], fem["_state"], 96)
    blocks = {k: fem["_state"][k] for k in ("A", "got", "ref")}
    release(fem)
    dg = main_path(dev, "dg_like(32,32,16)",
                   lambda: sparse.dg_like_matrix(32, 32, 16), 128)
    dg["capture"] = {}
    dg["executors"] = executor_path(dev, dg["setting"], dg["_state"], 128,
                                    captures=dg["capture"])
    dg["unrolled"] = unrolled_path(dev, dg["setting"], dg["_state"], 128)
    release(dg)
    settings = [fem, dg]
    lint_neg = mutated_lint(dev)
    serial = serial_path(dev, blocks)
    del blocks
    serve = {"fem": fem["serve"], "traffic": traffic_path(dev),
             "isolation": isolation_path(dev)}
    batched_path(dev)
    ops = ops_path(dev)
    bench = bench_path(dev)
    lm = lm_path(dev)
    fam = families_path(dev)
    for r in rows + new_rows + lm_rows:  # ptxas's report of each instance
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
                       for ex, r in s_["executors"].items()},
                **{f"{s_['setting']} {ex} graph": r["plans"]
                   for s_ in settings
                   for ex, r in s_["capture"].items()},
                **{f"{s_['setting']} unrolled": s_["unrolled"]["variants"]
                   for s_ in settings}},
                "trsm": {"serial": serial["backends"]["cuda"]["variants"],
                         "ops": ops["variants"]["trsm"]},
                "rmsnorm": {"ops": ops["variants"]["rmsnorm"],
                            **{f"{k} LM": lm[k]["rmsnorm_variants"]
                               for k in ("granite", "serve", "qwen3")},
                            **{f"{m['arch']} ({m['reduced']}) LM":
                               m["rmsnorm_variants"]
                               for m in fam["models"]}},
                "flash_attention": {
                    "ops": ops["variants"]["flash_attention"],
                    **{f"{m['arch']} ({m['reduced']}) prefill":
                       m["prefill_variants"]
                       for m in (lm["granite"], lm["qwen3"],
                                 *fam["models"])}}}
    launches = {
        "block_gemm": sum(s_["launches"] for s_ in settings)
        + sum(r["launches"] for s_ in settings
              for r in s_["executors"].values())
        + sum(s_["unrolled"]["launches"] for s_ in settings)
        + sum(r["launches"] + r["lint"]["launches"] for s_ in settings
              for r in s_["capture"].values())
        + lint_neg["launches"]
        + serial["backends"]["cuda"]["launches"]["block_gemm"]
        + serve["fem"]["launches"] + serve["traffic"]["launches"]
        + fem["multirank"]["launches"]
        + ops["launches"]["block_gemm"],
        "trsm": serial["backends"]["cuda"]["launches"]["trsm"]
        + ops["launches"]["trsm"],
        "rmsnorm": ops["launches"]["rmsnorm"] + lm["launches"]["rmsnorm"]
        + fam["launches"]["rmsnorm"],
        "flash_attention": ops["launches"]["flash_attention"]
        + lm["launches"]["flash_attention"]
        + fam["launches"]["flash_attention"],
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
         "main_path": settings, "lint_negative": lint_neg,
         "serial": serial, "serve": serve,
         "ops_path": ops, "bench": bench, "lm": lm, "lm_families": fam,
         "lm_kernel_rows": lm_rows,
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
