"""Chrome-trace / Perfetto JSON export — a copy of ``repro/obs/export.py``
(pure Python) for the PyTorch port.

Serialises the three observability surfaces into one
``chrome://tracing`` / `ui.perfetto.dev` loadable file:

* **spans** (``obs.trace``) — pid 1, one lane per host thread;
* **round timeline** (``obs.rounds.RoundProfile``) — pid 2, an
  aggregate lane (tid 0) of the fenced per-round walls plus one lane
  per rank carrying that rank's inbound bytes/messages per round;
* **serve request lifecycles** — pid 3, one lane per structure queue,
  each request an ``X`` event from submission to completion with nested
  ``queued`` / ``batched`` phases when the batch timestamps are set.

Every event is a standard Trace-Event ``X`` (complete) or ``M``
(metadata) record with ``ph``/``name``/``ts``/``dur``/``pid``/``tid``/
``args`` — the fields the golden schema test pins.  Each source is
normalised to its own zero origin (spans use ``perf_counter``, serve
requests ``time.monotonic``; the epochs differ, so cross-source
alignment would be fiction — lanes within a source are exact).

One clock for spans and device work is the profiler's: while a
``torch.profiler`` records, every span is also a profiler range
(:mod:`.trace`), so the profiler's own trace holds the spans beside the
device operations they launched; :func:`.graphmap.lanes` adds the
sweep graph's phases and rounds to it from those operations
(``tools/obs_report.py`` writes such a trace on the card).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["chrome_trace", "write_trace"]

_PID_SPANS = 1
_PID_ROUNDS = 2
_PID_SERVE = 3


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
    return out


def _span_events(spans) -> List[Dict[str, Any]]:
    spans = list(spans)
    if not spans:
        return []
    origin = min(s.t0_us for s in spans)
    events = _meta(_PID_SPANS, "host spans")
    tids: Dict[int, int] = {}
    for s in spans:
        tid = tids.get(s.tid)
        if tid is None:
            tid = tids[s.tid] = len(tids)
            events += _meta(_PID_SPANS, "host spans", tid,
                            f"thread {s.tid}")[1:]
        args = dict(s.attrs)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({"ph": "X", "name": s.name, "cat": "span",
                       "ts": s.t0_us - origin, "dur": s.dur_us,
                       "pid": _PID_SPANS, "tid": tid, "args": args})
    return events


def _round_events(profile) -> List[Dict[str, Any]]:
    events = _meta(_PID_ROUNDS, "sweep rounds", 0, "all ranks")
    for rank in range(profile.nranks):
        events += _meta(_PID_ROUNDS, "sweep rounds", rank + 1,
                        f"rank {rank}")[1:]
    rank_bytes = profile.rank_bytes
    for row in profile.timeline():
        i = row["index"]
        name = (f"round {row['rounds'][0]}" if len(row["rounds"]) == 1
                else f"rounds {row['rounds'][0]}-{row['rounds'][-1]}")
        base = {"ph": "X", "cat": "round", "ts": row["start_us"],
                "dur": row["wall_us"], "pid": _PID_ROUNDS}
        events.append({**base, "name": name, "tid": 0, "args": {
            "sim_us": row["sim_us"], "residual_us": row["residual_us"],
            "wire_bytes": row["wire_bytes"],
            "lane_bytes": row["lane_bytes"], "msgs": row["msgs"],
            "compute_ops": row["compute_ops"],
            "pure_comm": row["pure_comm"]}})
        if rank_bytes is None:
            continue
        for rank in range(profile.nranks):
            nb = float(rank_bytes[i, rank])
            if nb <= 0:
                continue
            events.append({**base, "name": name, "tid": rank + 1,
                           "args": {"inbound_bytes": nb}})
    return events


def _serve_events(requests) -> List[Dict[str, Any]]:
    reqs = [r for r in requests if r.completed is not None]
    if not reqs:
        return []
    origin = min(r.submitted for r in reqs)
    events = _meta(_PID_SERVE, "serve requests")
    lanes: Dict[str, int] = {}
    for r in sorted(reqs, key=lambda r: r.submitted):
        tid = lanes.get(r.skey)
        if tid is None:
            tid = lanes[r.skey] = len(lanes)
            events += _meta(_PID_SERVE, "serve requests", tid,
                            f"queue {r.skey[:12]}")[1:]
        ts = (r.submitted - origin) * 1e6
        dur = (r.completed - r.submitted) * 1e6
        events.append({"ph": "X", "name": f"request {r.rid}",
                       "cat": "request", "ts": ts, "dur": dur,
                       "pid": _PID_SERVE, "tid": tid,
                       "args": {"rid": r.rid,
                                "status": r.status.value,
                                "latency_us": dur}})
        if r.batched_at is not None:
            cut = (r.batched_at - origin) * 1e6
            events.append({"ph": "X", "name": "queued", "cat": "request",
                           "ts": ts, "dur": max(0.0, cut - ts),
                           "pid": _PID_SERVE, "tid": tid,
                           "args": {"rid": r.rid}})
            events.append({"ph": "X", "name": "batched", "cat": "request",
                           "ts": cut, "dur": max(0.0, ts + dur - cut),
                           "pid": _PID_SERVE, "tid": tid,
                           "args": {"rid": r.rid}})
    return events


def chrome_trace(spans: Optional[Iterable] = None, profile=None,
                 requests: Optional[Iterable] = None) -> Dict[str, Any]:
    """Assemble the Trace-Event JSON dict from any subset of the three
    sources: an iterable of :class:`~repro_torch.obs.trace.Span`, a
    :class:`~repro_torch.obs.rounds.RoundProfile`, an iterable of serve
    requests (anything with the JAX package's ``SolveRequest`` fields:
    ``rid``, ``skey``, ``status``, ``submitted``, ``batched_at``,
    ``completed``)."""
    events: List[Dict[str, Any]] = []
    if spans is not None:
        events += _span_events(spans)
    if profile is not None:
        events += _round_events(profile)
    if requests is not None:
        events += _serve_events(requests)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str, spans: Optional[Iterable] = None, profile=None,
                requests: Optional[Iterable] = None) -> str:
    """Write :func:`chrome_trace` to ``path`` (conventionally
    ``*.trace.json``); returns the path."""
    doc = chrome_trace(spans=spans, profile=profile, requests=requests)
    with open(path, "w") as f:
        json.dump(doc, f, indent=None, separators=(",", ":"),
                  default=float)
    return path
