"""Per-kernel microbenchmarks — the benchmark CLI's entry over
``repro_torch.kernels.bench`` (block GEMM, flash attention, RMSNorm and
trsm through the ``ops`` entry points, each beside its plain version),
its rows recorded for ``--json``."""
from __future__ import annotations

from ..kernels import bench
from . import common


def run(full: bool = False, device="cuda"):
    rows = bench.run(full=full, device=device)
    common.RESULTS.extend(rows)
    return rows
