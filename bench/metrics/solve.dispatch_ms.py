"""Host wall of the ``engine.solve`` call itself, without the
synchronise: the copy-in, the replay's launch and the output's clone.
The mean over the calls of a traced run that precede the profiler:
once it is attached, a graph's launch takes several times as long."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "graph runner and engine"
MOVES = "inv_per_s"


def read(run):
    before = run.dispatch_s[:run.profile_start] if run.traced else []
    if not before:
        return None
    return 1e3 * sum(before) / len(before)
