"""Device time a selected inversion of every kernel that is not a matrix
product: the sweep's gathers, scatters, index_add, elementwise kernels,
copies and fills, in the traced window."""
from pselbench.trace import PRODUCT_CLASSES

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "sweep"
MOVES = "inv_per_s"


def read(run):
    if run.trace is None or not run.traced_inversions:
        return None
    moved = sum(t for c, t in run.trace.by_class.items()
                if c not in PRODUCT_CLASSES)
    return 1e3 * moved / run.traced_inversions
