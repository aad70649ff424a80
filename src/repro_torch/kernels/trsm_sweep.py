"""Every launch choice of the trsm kernel, timed on the card: the evidence
behind the rules of :func:`repro_torch.kernels.trsm.plan`.

    PYTHONPATH=src python -m repro_torch.kernels.trsm_sweep

For each shape, every warps-per-block count (2, 4, 8 warps of 4 rows)
and both stagings (all panels of U resident, or one streamed at a time;
only what fits a block's shared memory) is launched through the C entry
directly, checked bitwise against the launch ``trsm.plan`` chooses (a
row's arithmetic does not depend on the choice), and timed as the
profiler's device time per call over 20 calls. Prints one row per choice
and marks the plan's. Needs a CUDA device."""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import _build
from . import trsm as tk

__all__ = ["run", "SHAPES"]

#: the serial path's k = 96 solves (one block, a supernode's stack, the
#: largest stack) and the kernel phase's (4096, 256)
SHAPES = [(96, 96, torch.float64), (960, 96, torch.float64),
          (1440, 96, torch.float64), (2880, 96, torch.float64),
          (100, 64, torch.float64), (96, 96, torch.float32),
          (4096, 256, torch.float64), (4096, 256, torch.float32),
          (4096, 256, torch.bfloat16)]


def _device_us(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def run(shapes=SHAPES, device="cuda"):
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("trsm_sweep times the kernel on the card: it "
                           "needs a CUDA device")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    rng = np.random.default_rng(1)
    rows = []
    for m, k, dt in shapes:
        u0 = np.triu(rng.standard_normal((k, k))) / np.sqrt(k) + 2 * np.eye(k)
        u = torch.from_numpy(u0).to(dev, dt)
        b = torch.from_numpy(rng.standard_normal((m, k))).to(dev, dt)
        ref = tk.trsm(b, u)
        p = tk.plan(m, k, dt)
        kpad = -(-k // tk.PW) * tk.PW
        acc = 8 if dt == torch.float64 else 4
        for warps in (2, 4, 8):
            for group in sorted({kpad // tk.PW, 1}):
                smem = tk._smem(kpad, group, tk.RPW * warps, acc)
                if smem > tk.SMEM_LIMIT:
                    continue
                x = torch.empty_like(b)

                def fn():
                    err = _build.launch(tk._kernel(), idx, tk.SUPPORTED[dt],
                                        b.data_ptr(), u.data_ptr(),
                                        x.data_ptr(), m, k, 1, 0, warps,
                                        group, smem)
                    if err:
                        raise RuntimeError(f"trsm launch failed: {err}")
                fn()
                torch.cuda.synchronize()
                r = dict(m=m, k=k, dtype=str(dt).replace("torch.", ""),
                         warps=warps, group=group, smem=smem,
                         device_us=_device_us(fn),
                         bitwise_equal_to_plan=torch.equal(x, ref),
                         plan=(p.warps, p.group) == (warps, group))
                rows.append(r)
                print(f"trsm {m}x{k} {r['dtype']} warps={warps} "
                      f"group={group} smem={smem}: device "
                      f"{r['device_us']:.2f} us, bitwise = plan: "
                      f"{r['bitwise_equal_to_plan']}"
                      f"{'  <- plan' if r['plan'] else ''}", flush=True)
    return rows


if __name__ == "__main__":
    run()
