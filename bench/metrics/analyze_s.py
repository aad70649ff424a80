"""``PSelInvEngine.analyze`` on an empty session cache (symbolic
analysis, plan, schedule, PlanLint, the tables' upload), by the
benchmark's clock around the call."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "session"
MOVES = "setup_s"


def read(run):
    return run.analyze_s
