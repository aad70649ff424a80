"""Check and time the flash-attention backward kernel on the card.

Runs the backward wrapper of a checkout's ``repro_torch`` against its plain
version at chip_smoke phase 2c's bf16 shapes and at ragged, packed-qkv and
local-shard layouts (the bf16 tolerance of ``chip_smoke.grads_close``),
checks that a second call is bitwise the same, prints the ptxas report
and the tensor-core and TMA instructions of each bf16 instance, and with
``--time`` times each phase 2c shape with CUDA events beside SDPA's
backward through autograd, and the device time of each kernel of a call
(torch.profiler). ``--train`` runs only chip_smoke's phase 12a (the
granite-3-2b training step at full size) of the checkout. One JSON object
a line on stdout; the card's name and power limit first.

    python3 tools/flash_bwd_bench.py [--src DIR] [--time] [--reps N]
    python3 tools/flash_bwd_bench.py --train [--src DIR]

``--src`` imports ``repro_torch`` (and, with ``--train``, the
``chip_smoke.py`` beside it) from another checkout's ``src`` (for example
the parent commit unpacked into ``build/``), so that two versions are
compared in one call on one card, in turns.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: chip_smoke phase 2c's bf16 shapes (B, S, H, hd), causal
TIMED = [((2, 4096, 32, 64), True), ((1, 4096, 64, 128), True),
         ((1, 1024, 16, 64), False)]
#: ragged and strided layouts: (B, S, H, hd), causal, layout
CHECKED = [((1, 200, 2, 128), True, "packed"),
           ((1, 333, 3, 64), False, "packed"),
           ((2, 256, 4, 64), True, "packed"),
           ((1, 1024, 4, 128), False, "packed"),
           ((2, 333, 3, 128), True, "shard"),
           ((1, 130, 5, 64), True, "shard")]


def emit(**kw):
    print(json.dumps(kw, default=str), flush=True)


def inputs(torch, shape, layout, seed):
    """q, k, v, dout: ``packed`` views of one (B, S, 3, H, hd) tensor, or a
    ``shard``: heads 1..H of an (B, S, H + 2, hd) tensor (a head stride of
    hd, a row stride of (H + 2)·hd), as a head-sharded local tensor has;
    else contiguous."""
    B, S, H, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    if layout == "packed":
        qkv = torch.randn(B, S, 3, H, hd, device="cuda", generator=g).to(bf)
        q, k, v = qkv.unbind(2)
    elif layout == "shard":
        q, k, v = (torch.randn(B, S, H + 2, hd, device="cuda", generator=g
                               ).to(bf)[:, :, 1:H + 1] for _ in range(3))
    else:
        q, k, v = (torch.randn(B, S, H, hd, device="cuda", generator=g
                               ).to(bf) for _ in range(3))
    dout = torch.randn(B, S, H, hd, device="cuda", generator=g).to(bf)
    return q, k, v, dout


def share(got, ref):
    """The largest share of |Δ| ≤ 1e-2·|plain| + 1e-3·max|plain| used."""
    used = 0.0
    for a, b in zip(got, ref):
        a, b = a.double(), b.double()
        if not a.isfinite().all():
            return float("inf")
        tol = 1e-2 * b.abs() + 1e-3 * b.abs().max()
        used = max(used, ((a - b).abs() / tol.clamp_min(1e-300)).max().item())
    return used


def compiled(_build):
    """ptxas's registers and spills and the SASS counts of HGMMA, HMMA and
    UTMALDG of each kernel in the backward's library."""
    log = _build.build_logs.get("flash_attention_bwd", "")
    for line in log.splitlines():
        if re.search(r"warning|setmaxnreg|wgmma", line, re.I):
            emit(ptxas_warning=line.strip())
    rep, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            rep[cur] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if cur and m:
            rep[cur]["spills"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            rep[cur]["registers"] = int(m.group(1))
    lib = _build.build(["flash_attention_bwd"])["flash_attention_bwd"]
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            ops[cur] = dict(HGMMA=0, HMMA=0, UTMALDG=0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if cur and m and m.group(1) in ops[cur]:
            ops[cur][m.group(1)] += 1
    for k in sorted(set(rep) | set(ops)):
        emit(kernel=k, ptxas=rep.get(k), sass=ops.get(k))


def timed(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def kernel_ms(torch, fn, reps=3):
    """Device time (ms) per call of each kernel ``fn`` launches, from a
    torch.profiler trace of ``reps`` calls, by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:90]: ev.self_device_time_total / 1e3 / reps
            for ev in p.key_averages()
            if getattr(ev, "self_device_time_total", 0)
            and not ev.key.startswith("aten::")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train", action="store_true")
    a = ap.parse_args(argv)
    sys.path.insert(0, a.src)
    if a.train:
        root = str(Path(a.src).resolve().parent)
        sys.path.insert(0, root)
        import chip_smoke
        import torch
        from repro_torch.kernels import _build
        _build.build(chip_smoke.KERNELS + chip_smoke.BWD_KERNELS)
        r = chip_smoke.train_full(torch.device("cuda"))
        emit(train_full=root, result=r)
        return 0
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit(card=card, src=a.src, torch=torch.__version__)
    bad = 0
    cases = [(s, c, "contiguous") for s, c in TIMED] + CHECKED
    for i, (shape, causal, layout) in enumerate(cases):
        q, k, v, dout = inputs(torch, shape, layout, i)
        out, lse = fa.flash_attention(q, k, v, causal, lse=True)
        before = dict(fb.plans)
        got = fb.flash_attention_bwd(q, k, v, out, dout, lse, causal)
        torch.cuda.synchronize()
        variant = [n for n, c in fb.plans.items() if c != before.get(n, 0)]
        again = fb.flash_attention_bwd(q, k, v, out, dout, lse, causal)
        ref = fb.flash_attention_bwd_plain(q, k, v, out, dout, lse, causal)
        used = share(got, ref)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = used <= 1.0 and same
        bad += not ok
        emit(shape=list(shape), causal=causal, layout=layout,
             variant=variant, tol_used=used, bitwise_repeat=same, ok=ok)
        del got, again, ref
        torch.cuda.empty_cache()
    compiled(_build)
    if a.time:
        for i, (shape, causal) in enumerate(TIMED):
            q, k, v, dout = inputs(torch, shape, "contiguous", 100 + i)
            out, lse = fa.flash_attention(q, k, v, causal, lse=True)
            ms = timed(torch, lambda: fb.flash_attention_bwd(
                q, k, v, out, dout, lse, causal), a.reps)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dt = dout.transpose(1, 2).contiguous()
            sdpa = timed(torch, lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dt, retain_graph=True), a.reps)
            split = kernel_ms(torch, lambda: fb.flash_attention_bwd(
                q, k, v, out, dout, lse, causal))
            emit(timed=list(shape), causal=causal, ms=ms, sdpa_bwd_ms=sdpa,
                 device_ms=sum(split.values()), kernels=split, card=card)
            del q, k, v, dout, out, lse, qt, kt, vt, ot, dt
            torch.cuda.empty_cache()
    emit(failed=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
