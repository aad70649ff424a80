"""Selected inversions completed in the window a second: calls × lanes,
each call's output synchronised on the card, over the window's wall time
(from the first call's dispatch to the last call's synchronised end,
less the check's copy of its sampled output to the host)."""
UNIT = "inversions/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if not run.calls or not run.window_s > 0:
        return None
    return run.inversions / run.window_s
