"""The port's tracing of the sweep graph and the host prepare, on the CPU:
the phase marks of the overlapped sweep against its tables, the walk
that labels a captured chain, the attribution of a profiler trace
(``obs/graphmap.py``) on synthetic traces, the spans as profiler ranges,
and the prepare's step counters."""
import itertools

import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import exec_ir, sparse
from repro_torch.core.capture import chain_order, label_chain
from repro_torch.core.engine import Grid, PSelInvEngine, stack_values
from repro_torch.core.pselinv_dist import COMPUTE_PHASES
from repro_torch.obs import graphmap
from repro_torch.obs.registry import REGISTRY
from repro_torch.obs.trace import TRACER, Tracer


def _session(name):
    if name == "lap":
        A = sp.csr_matrix(sparse.laplacian_2d(16, 8))
    else:
        A = sparse.make_numeric(sparse.fem3d_like_matrix(4, 4, 4, 2)[0],
                                symmetric_values=True)
    eng = PSelInvEngine.analyze(A, b=8, grid=Grid(4, 2), device="cpu")
    return A, eng


def _expected_marks(tabs):
    out = [("arena.init", -1)]
    nrounds = len(tabs.comm)
    for t in range(nrounds + 1):
        out += [(COMPUTE_PHASES[kind], t) for kind, _ in tabs.compute_at[t]]
        if t == nrounds:
            break
        if tabs.local[t] is not None:
            out.append(("lanes.local", t))
        if tabs.comm[t] is not None:
            out += [("lanes.gather", t), ("lanes.permute", t),
                    ("lanes.land", t)]
    return out + [("arena.finish", nrounds)]


@pytest.mark.parametrize("name", ["lap", "fem"])
def test_marks_follow_the_schedule(name):
    """Under a recording hook an eager overlapped sweep marks, round by
    round, the compute ops of ``compute_at``, the local lanes and the
    permute's three phases, between ``arena.init`` and
    ``arena.finish``; a batched sweep marks the same, and without a
    marker a record sees no mark."""
    A, eng = _session(name)
    vals = eng.prepare_values(A)
    want = _expected_marks(eng.tables)
    assert want[0] == ("arena.init", -1)
    assert want[-1] == ("arena.finish", len(eng.tables.comm))
    assert {p for p, _ in want} <= set(graphmap.PHASES)
    for batched, args in ((False, vals),
                          (True, stack_values([vals, vals]))):
        marks = []
        with exec_ir.record() as rec:
            rec.marker = lambda p, t: marks.append((p, t))
            out = eng.sweep(batched)(*args)
        assert marks == want
    with exec_ir.record() as rec:
        plain = eng.sweep()(*vals)
    assert rec.marker is None and torch.equal(plain, out[0])


def test_chain_walk_labels_each_device_node():
    """A chain's nodes take the last mark before them; a fork, a join or
    two roots are no chain; a mark that saw two frontier nodes leaves
    nothing labelled."""
    order = chain_order([5, 3, 9, 7, 1],
                        [(3, 9), (9, 7), (5, 3), (7, 1)])
    assert order == [5, 3, 9, 7, 1]
    assert chain_order([1, 2, 3], [(1, 2), (1, 3)]) is None
    assert chain_order([1, 2, 3], [(1, 3), (2, 3)]) is None
    assert chain_order([1, 2, 3], [(1, 2)]) is None
    kinds = {5: ("kernel", "k_init"), 3: ("memset", ""),
             9: (None, ""), 7: ("kernel", "gemm_x"), 1: ("memcpy", "")}
    marks = [((), "arena.init", -1), ((3,), "gemm", 0),
             ((9,), "lanes.gather", 0), ((7,), "lanes.permute", 0),
             ((7,), "arena.finish", 1)]
    nodes = label_chain(order, marks, kinds.__getitem__)
    assert [(n.phase, n.round, n.kind, n.name) for n in nodes] == [
        ("arena.init", -1, "kernel", "k_init"),
        ("arena.init", -1, "memset", ""),
        ("lanes.gather", 0, "kernel", "gemm_x"),
        ("arena.finish", 1, "memcpy", "")]
    assert nodes[2].product and not nodes[0].product
    assert label_chain(order, marks + [((3, 9), "gemm", 1)],
                       kinds.__getitem__) is None
    unmarked = label_chain(order, [((9,), "gemm", 2)], kinds.__getitem__)
    assert [n.phase for n in unmarked] == ["unmarked", "unmarked", "gemm",
                                           "gemm"]


_gids = itertools.count(10_000)


def _map():
    gid = next(_gids)
    nodes = (graphmap.Node("arena.init", -1, "memset", ""),
             graphmap.Node("gemm", 0, "kernel", "void mask_kernel()"),
             graphmap.Node("gemm", 0, "kernel",
                           "void block_gemm_kernel<double, 96>()"),
             graphmap.Node("lanes.gather", 0, "kernel", "void gather()"),
             graphmap.Node("update.diag_sum", 1, "kernel",
                           "sm90_xmma_gemm_f64f64"),
             graphmap.Node("arena.finish", 1, "memcpy", ""))
    return graphmap.register(graphmap.PhaseMap(gid, nodes, {0: 4096}))


_CAT = {"kernel": "kernel", "memcpy": "gpu_memcpy", "memset": "gpu_memset"}


class _Trace:
    """A Chrome trace as torch.profiler writes it, built by hand."""

    def __init__(self):
        self.events = []
        self.corr = itertools.count(1)

    def range(self, name, ts, dur, tid=7):
        self.events.append({"ph": "X", "cat": "user_annotation",
                            "name": name, "ts": ts, "dur": dur, "pid": 1,
                            "tid": tid})

    def call(self, api, ts, ops, tid=7):
        """A runtime call at ``ts`` and the device ops it started, each
        (kind, name, dur), back to back from ``ts + 10``."""
        c = next(self.corr)
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": api,
                            "ts": ts, "dur": 2, "pid": 1, "tid": tid,
                            "args": {"correlation": c}})
        t = ts + 10
        for kind, name, dur in ops:
            self.events.append({"ph": "X", "cat": _CAT[kind],
                                "name": name or "Memcpy DtoD", "ts": t,
                                "dur": dur, "pid": 0, "tid": 7,
                                "args": {"correlation": c}})
            t += dur + 1

    def replay(self, pm, ts, durs, tid=7, names=None, as_kernels=False):
        """One replay of ``pm``'s graph; ``as_kernels``: its copies and
        fills run as kernels of their own (``memcpy32_post``)."""
        self.range(f"graph.replay graph={pm.gid}", ts, 5, tid)
        keys = names or [n.name for n in pm.nodes]
        ops = [("kernel", f"{n.kind}32_post", d)
               if as_kernels and n.kind != "kernel" else (n.kind, k, d)
               for n, k, d in zip(pm.nodes, keys, durs)]
        self.call("cudaGraphLaunch", ts + 1, ops, tid)


DURS = [(1.0, 2.0, 30.0, 4.0, 5.0, 6.0), (2.0, 3.0, 40.0, 5.0, 6.0, 7.0)]


def _two_replays(pm):
    tr = _Trace()
    tr.range("bench.window", 0, 10_000)
    tr.range("graph.copy_in", 10, 5)
    tr.call("cudaMemcpyAsync", 11, [("memcpy", "", 8.0)])
    tr.replay(pm, 100, DURS[0])
    tr.range("graph.clone", 500, 5)
    tr.call("cudaMemcpyAsync", 501, [("memcpy", "", 9.0)])
    tr.call("cudaLaunchKernel", 900, [("kernel", "void other()", 3.0)])
    tr.replay(pm, 1000, DURS[1], as_kernels=True)
    tr.call("cudaLaunchKernel", 20_000,           # outside the window
            [("kernel", "void late()", 50.0)])
    return tr


def test_attribution_of_two_replays_is_exact():
    pm = _map()
    tr = _two_replays(pm)
    att = graphmap.attribute(tr.events, "bench.window")
    assert att["replays"] == 2 and att["unmatched"] == 0
    assert att["graphs"] == {pm.gid: 2}
    us = [sum(d[i] for d in DURS) for i in range(6)]
    s = [x * 1e-6 for x in us]
    ph = att["phase"]
    assert ph["arena.init"] == {"product": 0.0, "rest": s[0]}
    assert ph["gemm"] == {"product": s[2], "rest": s[1]}
    assert ph["lanes.gather"] == {"product": 0.0, "rest": s[3]}
    assert ph["update.diag_sum"] == {"product": s[4], "rest": 0.0}
    assert ph["arena.finish"] == {"product": 0.0, "rest": s[5]}
    rnd = att["round"]
    assert list(rnd) == [-1, 0, 1]
    assert rnd[0] == {"product": s[2], "rest": (us[1] + us[3]) * 1e-6}
    assert rnd[1] == {"product": s[4], "rest": s[5]}
    assert att["copy"] == 17e-6 and att["other"] == 3e-6
    assert att["permute_bytes"] == {0: 4096}
    # the whole trace: the late kernel joins the rest
    assert graphmap.attribute(tr.events)["other"] == 53e-6
    # the phases lane and the rounds lane
    lanes = graphmap.lanes(tr.events, pid=9, window="bench.window")
    xs = [e for e in lanes if e["ph"] == "X"]
    assert [e["name"] for e in xs if e["tid"] == 1] == [
        "round -1", "round 0", "round 1"] * 2
    assert [e["name"] for e in xs if e["tid"] == 0][:5] == [
        "arena.init", "gemm", "lanes.gather", "update.diag_sum",
        "arena.finish"]
    assert sum(e["args"]["device_us"] for e in xs if e["tid"] == 0) == \
        sum(map(sum, DURS))
    assert [e["args"]["permute_bytes"] for e in xs
            if e["tid"] == 1][:3] == [0, 4096, 0]


@pytest.mark.parametrize("window,other", [("bench.window", 3e-6),
                                          (None, 53e-6)])
def test_split_holds_every_second_of_the_trace(window, other):
    """The groups of the non-product seconds and the products make up
    the device time of the window (or of the whole trace)."""
    pm = _map()
    tr = _two_replays(pm)
    got = graphmap.split(graphmap.attribute(tr.events, window))
    us = [sum(d[i] for d in DURS) for i in range(6)]
    want = {"products": us[2] + us[4], "lanes": us[3], "operands": us[1],
            "updates": 0.0, "arena": us[0] + us[5], "copy": 17.0}
    assert got == pytest.approx(
        {**{k: v * 1e-6 for k, v in want.items()}, "other": other},
        rel=1e-12)
    assert sum(got.values()) == pytest.approx(
        1e-6 * sum(map(sum, DURS)) + 17e-6 + other, rel=1e-12)
    assert graphmap.split(None) is None


def test_an_operation_at_the_window_edge_counts_its_part_inside():
    """As the benchmark's trace summary does: the device time of the
    window, not of whole operations."""
    pm = _map()
    tr = _Trace()
    tr.range("w", 100, 1000)
    tr.replay(pm, 110, DURS[0])
    tr.range("graph.clone", 1080, 5)
    tr.call("cudaMemcpyAsync", 1081, [("memcpy", "", 40.0)])  # 1091-1131
    tr.call("cudaLaunchKernel", 60, [("kernel", "void k()", 60.0)])
    att = graphmap.attribute(tr.events, "w")
    assert att["replays"] == 1
    assert att["copy"] == 9 * 1e-6 and att["other"] == 30 * 1e-6


def test_a_replay_that_differs_is_left_out():
    pm = _map()
    tr = _two_replays(pm)
    # one op too many
    extra = graphmap.PhaseMap(pm.gid, pm.nodes + pm.nodes[-1:], {})
    tr.range(f"graph.replay graph={pm.gid}", 3000, 5)
    tr.call("cudaGraphLaunch", 3001,
            [(n.kind, n.name, 1.0) for n in extra.nodes])
    # two names swapped
    names = [n.name for n in pm.nodes]
    names[1], names[3] = names[3], names[1]
    tr.replay(pm, 4000, DURS[0], names=names)
    att = graphmap.attribute(tr.events, "bench.window")
    assert att["replays"] == 2 and att["unmatched"] == 2
    assert att["unattributed"] == (7.0 + sum(DURS[0])) * 1e-6
    # nothing matches: no result
    bad = _Trace()
    bad.range("w", 0, 10_000)
    bad.replay(pm, 10, DURS[0], names=names)
    assert graphmap.attribute(bad.events, "w") is None
    assert graphmap.attribute(tr.events, "no such window") is None
    # a replay of a graph with no map, or with no chain, matches nothing
    other = _Trace()
    other.replay(graphmap.PhaseMap(next(_gids), pm.nodes), 10, DURS[0])
    assert graphmap.attribute(other.events) is None
    gone = graphmap.register(graphmap.PhaseMap(next(_gids), None))
    assert not gone.chain
    other = _Trace()
    other.replay(graphmap.PhaseMap(gone.gid, pm.nodes), 10, DURS[0])
    assert graphmap.attribute(other.events) is None


def test_a_trace_without_ranges_needs_the_graph_named():
    """A trace of device activity only has no ``graph.replay`` range:
    the caller names the graph it replayed."""
    pm = _map()
    tr = _Trace()
    tr.call("cudaGraphLaunch", 1, [(n.kind, n.name, d) for n, d
                                   in zip(pm.nodes, DURS[0])])
    assert graphmap.attribute(tr.events) is None
    att = graphmap.attribute(tr.events, graph=pm.gid)
    assert att["replays"] == 1 and att["copy"] == 0.0


def test_the_map_table_is_bounded():
    first = _map()
    for _ in range(graphmap.MAX_MAPS):
        last = _map()
    assert graphmap.lookup(first.gid) is None
    assert graphmap.lookup(last.gid) is last


def test_demangled_names_read_as_the_trace_prints_them():
    assert graphmap.demangle("_Z17block_gemm_kernelIdLi96EEvv") == \
        "void block_gemm_kernel<double, 96>()"
    assert graphmap.demangle("block_gemm_kernel") == "block_gemm_kernel"


def _range_names(prof, prefix):
    return [e.name for e in prof.events()
            if e.name.startswith(prefix)]


def test_spans_are_profiler_ranges_with_the_tracer_off():
    """Under a recording profiler a disabled tracer still opens each
    span's range; with no profiler it hands back the shared null span;
    an enabled tracer records the span and opens the range, and its
    children share the solve's call id."""
    A, eng = _session("lap")
    assert not TRACER.enabled
    vals = eng.prepare_values(A)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.solve(vals, dtype=torch.float64)
        eng.prepare_values(A)
        with TRACER.span("graph.replay", graph=42):
            pass
    names = _range_names(prof, ("engine.", "prepare.", "graph."))
    assert names.count("engine.solve") == 1
    assert {"engine.prepare_values", "prepare.factor", "prepare.layout",
            "prepare.upload", "graph.replay graph=42"} <= set(names)
    user = [e for e in prof.events() if e.name == "engine.solve"]
    assert user and all(e.device_type == torch.autograd.DeviceType.CPU
                        for e in user)
    assert TRACER.span("a") is TRACER.span("b", x=1)
    assert len(TRACER) == 0

    t = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("engine.solve", B=1, call=5):
            with t.span("graph.replay", graph=3):
                with t.span("inner", call=6):
                    pass
    spans = {s.name: s for s in t.spans()}
    assert spans["graph.replay"].attrs == {"graph": 3, "call": 5}
    assert spans["inner"].attrs == {"call": 6}
    assert {"engine.solve", "graph.replay graph=3", "inner"} <= set(
        _range_names(prof, ("engine.", "graph.", "inner")))


def test_spans_land_in_the_exported_trace_as_user_annotations(tmp_path):
    import json
    A, eng = _session("lap")
    vals = eng.prepare_values(A)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.solve(vals, dtype=torch.float64)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    solve = [e for e in events if e.get("name") == "engine.solve"]
    assert len(solve) == 1 and solve[0]["cat"] == "user_annotation"


def _prepare_counters():
    sec = REGISTRY.get("selinv_prepare_seconds_total")
    steps = {k[0]: c.value for k, c in sec.children()}
    return steps, REGISTRY.get("selinv_prepare_calls_total").value


def test_prepare_counters_move_once_a_call():
    """Each prepare call moves the call counter once and each step's
    seconds; the steps add up to the call's wall."""
    A, eng = _session("fem")
    eng.prepare_values(A)               # warm
    for call in (lambda: eng.prepare_values(A),
                 lambda: eng.prepare_values_many([A, 2 * A])):
        steps0, calls0 = _prepare_counters()
        call()
        steps1, calls1 = _prepare_counters()
        assert calls1 - calls0 == 1
        moved = {k: steps1[k] - steps0.get(k, 0.0) for k in steps1}
        assert set(moved) == {"factor", "layout", "upload"}
        assert all(v > 0 for v in moved.values())
        wall = eng._last_prepare_us * 1e-6
        assert sum(moved.values()) <= wall
        assert sum(moved.values()) >= 0.9 * wall - 2e-3
