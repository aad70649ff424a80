"""The port's dry run (``python -m repro_torch.launch.dryrun``), the twin
of ``tests/test_dryrun.py``: one step traced on fake tensors over a fake
process group of the mesh's size. granite-3-2b ``train_4k`` and
``decode_32k`` on a 4×4 mesh and ``train_4k`` on 2×2×4 (the folded pod
axis), and one cell of each recurrent or encoder-decoder family on 4×4
(jamba-1.5-large-398b ``decode_32k``, xlstm-125m ``long_500k``,
seamless-m4t-large-v2 ``decode_32k``, its cache a dict), come back ok
with FLOPs and collective bytes, their argument bytes equal to the local
shard bytes the specs give, and ``long_500k`` on a quadratic arch is
skipped. Each cell is its own process (the fake group would outlive a
test in this one); the traced cells run at once.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.launch import steps
from repro_torch.models import get_model
from repro_torch.runtime import sharding as sh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"train_4x4": ("granite-3-2b", "train_4k", "4x4", False),
         "decode_4x4": ("granite-3-2b", "decode_32k", "4x4", False),
         "train_2x2x4": ("granite-3-2b", "train_4k", "2x2x4", True),
         "long_4x4": ("granite-3-2b", "long_500k", "4x4", False),
         "jamba_decode_4x4": ("jamba-1.5-large-398b", "decode_32k", "4x4",
                              False),
         "xlstm_long_4x4": ("xlstm-125m", "long_500k", "4x4", False),
         "seamless_decode_4x4": ("seamless-m4t-large-v2", "decode_32k",
                                 "4x4", False)}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Start every cell's dry run at once; their results by name."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for key, (arch, shape, mesh, mp) in CELLS.items():
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   REPRO_DRYRUN_MESH=mesh)
        args = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--out",
                str(d / f"{key}.json")] + (["--multi-pod"] if mp else [])
        procs[key] = subprocess.Popen(args, env=env, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE)
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=400)
            assert p.returncode == 0, stdout + stderr[-3000:]
            out[key] = json.load(open(d / f"{key}.json"))[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _arg_bytes(arch, shape_name, sizes, names):
    """Local bytes of the step's arguments from the specs alone."""
    mesh = sh.MeshAxes(names, sizes)
    cfg = tconfig.get_config(arch)
    shape = tconfig.SHAPES[shape_name]
    api = get_model(cfg)
    ins = steps.input_specs(cfg, shape)

    def local(t, spec):
        return math.prod(sh.local_shape(tuple(t.shape), spec, mesh)) * \
            t.element_size()

    p = api.param_shapes()
    pspecs = sh.param_specs(p, cfg, mesh)
    if shape.mode == "train":
        params = p
        total = sum(local(w, pspecs[k]) for k, w in params.named_parameters())
        state = steps.state_dtype_of(cfg)
        total += 2 * sum(local(torch.empty(w.shape, dtype=state,
                                           device="meta"), pspecs[k])
                         for k, w in params.named_parameters())
        total += 4                                       # the step counter
        bspecs = sh.batch_specs(ins["batch"], mesh)
        return total + sum(local(t, bspecs[k])
                           for k, t in ins["batch"].items())
    served = api.serving_params(p)
    total = sum(local(w, pspecs[k]) for k, w in served.named_parameters())
    cache = ins["cache"]
    for entry in ([cache] if isinstance(cache, dict) else cache):
        total += sum(local(t, sh.cache_pspec(tuple(t.shape), mesh))
                     for t in entry.values())
    tspec = sh.batch_specs({"t": ins["token"]}, mesh)["t"]
    return total + 2 * local(ins["token"], tspec)


@pytest.mark.parametrize("key", ["train_4x4", "decode_4x4", "train_2x2x4",
                                 "jamba_decode_4x4", "xlstm_long_4x4",
                                 "seamless_decode_4x4"])
def test_dryrun_cell(cells, key):
    arch, shape, mesh, mp = CELLS[key]
    r = cells[key]
    sizes = tuple(int(d) for d in mesh.split("x"))
    names = ("pod", "data", "model")[-len(sizes):]
    assert r["status"] == "ok" and r["multi_pod"] == mp
    assert r["ndev"] == math.prod(sizes) and tuple(r["mesh"]) == sizes
    assert r["flops"] > 0
    assert sum(r["collective_bytes"].values()) > 0
    assert set(r["collective_bytes"]) <= {
        "all-gather", "reduce-scatter", "all-reduce", "all-to-all",
        "collective-permute"}
    assert r["memory"]["argument_size_in_bytes"] == \
        _arg_bytes(arch, shape, sizes, names)
    assert r["fits_80gb"] == (r["memory"]["argument_size_in_bytes"]
                              < 80 * 2 ** 30)


def test_dryrun_long500k_skip_rule(cells):
    r = cells["long_4x4"]
    assert r["status"] == "skipped"
    assert "sub-quadratic" in r["reason"]
