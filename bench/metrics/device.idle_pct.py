"""Share of the replays' device time in which no kernel, copy or fill
ran: the gaps inside each replay of the shape class's CUDA graph (from
its first operation's start to its last one's end), which the program's
own graph and schedule leave. The gaps between replays are left out:
they are the host's dispatch, which ``solve.dispatch_ms`` reads, and in
a traced run mostly the profiler's cost on each graph launch."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "inv_per_s"


def read(run):
    if run.trace is None or not run.trace.replay_span_s > 0:
        return None
    return 100.0 * (1.0 - run.trace.replay_busy_s / run.trace.replay_span_s)
