"""Find the benchmark's parts by name: a cell's workload file, its
configuration, its traffic driver and its metric readers.

    BENCHMARK.json                      cells and metrics, at the root
    bench/workloads/<cell>.json         config, traffic, driver, parameters
    bench/configs/<config>.json         matrix, supernode width, grid, dtype
    bench/drivers/<driver>.py           ``drive(solve, workload, ...)``
    bench/metrics/<metric>.py           ``read(run)`` and its declarations

Adding a cell, a configuration or a metric adds files and entries of
``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = ["NAME", "Bench"]

#: what a name of a cell, configuration, traffic or metric may be
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")

_WORKLOAD_KEYS = {"config", "traffic", "driver", "batch", "value_sets",
                  "clients", "trace_calls"}
_CONFIG_KEYS = {"name", "source", "generator", "params", "n", "b",
                "process_grid", "options", "dtype", "checks", "reduced",
                "assumed"}
_METRIC_DECLS = ("UNIT", "BETTER", "SOURCE")


class Bench:
    """The benchmark found under the checkout ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "bench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self._modules: Dict[Path, ModuleType] = {}

    def _file(self, kind: str, name: str, suffix: str) -> Path:
        if not NAME.fullmatch(name):
            raise ValueError(f"{name!r} is not a valid {kind} name")
        path = self.dir / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is "
                                    "missing")
        return path

    def _json(self, kind: str, name: str, keys: set) -> dict:
        with open(self._file(kind, name, ".json")) as f:
            data = json.load(f)
        missing = keys - set(data)
        if missing:
            raise ValueError(f"{kind[:-1]} {name!r} lacks {sorted(missing)}")
        return data

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self._file(kind, name, ".py")
        mod = self._modules.get(path)
        if mod is None:
            tag = re.sub(r"\W", "_", name)
            spec = importlib.util.spec_from_file_location(
                f"pselbench_{kind}_{tag}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def entry(self, cell: str) -> dict:
        """The cell's entry of ``BENCHMARK.json``'s ``workloads``."""
        for w in self.spec["workloads"]:
            if w["name"] == cell:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")

    def workload(self, cell: str) -> dict:
        """The cell's workload file, held to its ``BENCHMARK.json`` entry."""
        entry = self.entry(cell)
        wl = self._json("workloads", cell, _WORKLOAD_KEYS)
        for key in ("config", "traffic"):
            if wl[key] != entry[key]:
                raise ValueError(f"workload {cell!r}: {key} {wl[key]!r} in "
                                 f"its file, {entry[key]!r} in "
                                 "BENCHMARK.json")
        return wl

    def config(self, name: str) -> dict:
        cfg = self._json("configs", name, _CONFIG_KEYS)
        if cfg["name"] != name:
            raise ValueError(f"config file {name!r} names {cfg['name']!r}")
        return cfg

    def driver(self, name: str) -> ModuleType:
        mod = self._module("drivers", name)
        if not callable(getattr(mod, "drive", None)):
            raise TypeError(f"driver {name!r} has no drive()")
        return mod

    def metric(self, name: str) -> ModuleType:
        mod = self._module("metrics", name)
        for decl in _METRIC_DECLS:
            if not hasattr(mod, decl):
                raise TypeError(f"metric reader {name!r} lacks {decl}")
        if not callable(getattr(mod, "read", None)):
            raise TypeError(f"metric reader {name!r} has no read()")
        return mod

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The ``BENCHMARK.json`` metrics a run of ``cell`` prints: the
        per-layer ones when traced, the end-to-end ones otherwise, each
        unless its ``workloads`` leaves the cell out."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]
