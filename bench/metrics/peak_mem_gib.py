"""``torch.cuda.max_memory_allocated`` over set-up and window, read
before the reference runs: the largest matrix a card holds follows from
it. The window holds one output at a time, as a closed-loop client; the
check's sampled output waits on the host. Its source is ``host_clock``:
a reading the benchmark takes itself, on the host, and not a span or
counter of the program."""
UNIT = "GiB"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
