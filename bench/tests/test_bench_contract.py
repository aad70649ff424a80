"""BENCHMARK.json against the rules it is held to, and every part it
names found under ``bench/`` with matching declarations."""
import json
import math
import re

import pytest

from benchtiny import ROOT

from pselbench.cells import NAME, Bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = Bench(ROOT)
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    named = [w for w in cmd if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"])
               for w in named)
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43 200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    e2e = metric in SPEC["end_to_end"]
    keys = ({"name", "unit", "better", "source", "bound"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.fullmatch(metric["name"])
    assert UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert metric["bound"] >= 0.01
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        moved = [m for m in SPEC["end_to_end"] if m["name"] == metric["moves"]]
        assert moved
        # every cell it names reports the metric it moves
        for cell in metric.get("workloads", CELLS):
            assert cell in moved[0].get("workloads", CELLS)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
    # its reader declares the same unit, direction and source
    reader = BENCH.metric(metric["name"])
    assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (
        metric["unit"], metric["better"], metric["source"])
    if not e2e:
        assert (reader.LAYER, reader.MOVES) == (metric["layer"],
                                                metric["moves"])


def test_names_are_unique_and_layers_consistent():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert "setup_s" in names
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(config["name"])
    assert _line(config["source"]) and _line(config["why"])
    assert config["file"].startswith("bench/")
    cfg = BENCH.config(config["name"])
    assert (ROOT / config["file"]).resolve() == (
        ROOT / "bench" / "configs" / f"{config['name']}.json").resolve()
    assert cfg["source"] == config["source"]
    assert len(config["reduced"]) <= 16
    assert all(NAME.fullmatch(k) for k in config["reduced"])
    assert sorted(config["reduced"]) == sorted(cfg["reduced"])
    for key in config["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size"))
        assert key in cfg and cfg[key] == cfg["reduced"][key]["here"]
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(cell[key])
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] in (1, 4)
    assert _line(cell["why"])
    wl = BENCH.workload(cell["name"])
    assert callable(BENCH.driver(wl["driver"]).drive)
    e2e = BENCH.metrics(cell["name"], trace=False)
    per_layer = BENCH.metrics(cell["name"], trace=True)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert per_layer


def test_pairs_and_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(0.25 * len(SPEC["workloads"])))


def test_files_are_named_from_names():
    for path in (ROOT / "bench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel
