"""The host prepare of every value set (``engine.prepare_values``:
supernodal LU, normalization, D⁻¹ and the shard layout, and the copy to
the card), by the benchmark's clock around the calls."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "host prep"
MOVES = "setup_s"


def read(run):
    return run.prepare_s
