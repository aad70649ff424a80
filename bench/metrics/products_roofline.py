"""Share of the roofline of the window's matrix products, every
matrix-product kernel together (the hand-written ``block_gemm`` and any
library product): the least time the card could take for the products
one selected inversion needs on the filled block structure
(:func:`pselbench.structure.inversion_flops` at the f64 peak, or
:func:`~pselbench.structure.inversion_bytes` at the memory bandwidth,
whichever is longer), times the traced inversions, over those kernels'
device time in the traced window."""
from pselbench.trace import PRODUCT_CLASSES

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "inv_per_s"


def read(run):
    if run.trace is None or run.peaks is None or not run.traced_inversions:
        return None
    spent = sum(run.trace.by_class.get(c, 0.0) for c in PRODUCT_CLASSES)
    if not spent > 0:
        return None
    least = max(run.flops / run.peaks["f64_flops"],
                run.least_bytes / run.peaks["bytes"])
    return 100.0 * least * run.traced_inversions / spent
