"""Published peaks of the cards the benchmark reads rooflines against.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power limit.
The f64 rate is the tensor cores' (DMMA), which the port's f64 products
use. A card whose name is not here has no roofline: the readers that
need one return nothing.
"""
from __future__ import annotations

__all__ = ["PEAKS", "peak_for"]

#: card name prefix → peak f64 operations a second and bytes a second
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f64_flops": 67e12, "bytes": 3.35e12},
}


def peak_for(kind: str):
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None."""
    for name, peak in PEAKS.items():
        if kind.startswith(name):
            return peak
    return None
