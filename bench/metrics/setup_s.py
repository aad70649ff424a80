"""Process start to the window's start: imports, matrix generation,
analyze, the host prepare, the first solve (the graph capture) and two
warm calls; in a fresh checkout also the kernels' build."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s if run.calls else None
