"""The first ``engine.solve`` of the cell's shape class, ending in a
synchronise: the eager warm-up sweep and the CUDA graph's capture."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "graph runner and engine"
MOVES = "setup_s"


def read(run):
    return run.first_solve_s
