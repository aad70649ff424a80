"""Percentile arithmetic.

``percentile`` is a frozen copy of the arithmetic of
``Histogram.percentile`` in ``src/repro_torch/obs/registry.py`` (which
``src/repro_torch/serve/metrics.py`` reports) at commit 738e407:
``np.percentile`` with linear interpolation over every sample.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["percentile"]


def percentile(samples: Sequence[float], q: float) -> float:
    """The q-th percentile (0–100) of ``samples``."""
    if not len(samples):
        raise ValueError("percentile of no samples")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))
