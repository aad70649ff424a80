"""Closed loop: each client hands over its next call only when the last
one's result is on hand, as a self-consistent-field loop hands its poles
over and waits. The workload's ``clients`` says how many; the port's
session serves one caller at a time, so this driver runs one.

``solve()`` makes one call and returns once its output is synchronised;
the driver stops after ``calls`` calls or once ``seconds`` have passed,
whichever comes first, and returns the number of calls made.
"""
from __future__ import annotations

import time


def drive(solve, workload: dict, *, seconds: float | None = None,
          calls: int | None = None) -> int:
    if workload["clients"] != 1:
        raise ValueError(f"closed_loop runs one client, the workload asks "
                         f"for {workload['clients']}")
    if seconds is None and calls is None:
        raise ValueError("closed_loop needs seconds or calls")
    made = 0
    t0 = time.perf_counter()
    while ((calls is None or made < calls)
           and (seconds is None or time.perf_counter() - t0 < seconds)):
        solve()
        made += 1
    return made
