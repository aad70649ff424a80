"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's ``repro.launch.roofline``: ``param_count``, ``model_flops`` and
``flops_model`` equal the JAX functions exactly, float for float, for
every config × shape, and ``roofline_row`` differs only by the H100's
constants. The twins of ``tests/test_roofline.py``: ``param_count`` within
6 % of the port's actual reduced parameter tree, and the analytic FLOPs
of a two-layer, one-group forward within 35 % of what
``FlopCounterMode`` counts on the port's forward.

    PYTHONPATH=src python -m pytest -q tests/test_torch_roofline.py
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import config as jconfig
from repro.launch import roofline as jroof

from repro_torch import config as tconfig
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import roofline as troof
from repro_torch.models import get_model
from repro_torch.models import transformer as tfm


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_roofline_functions_equal_jax_exactly(arch):
    jcfg, tcfg = jconfig.get_config(arch), tconfig.get_config(arch)
    assert troof.param_count(tcfg) == jroof.param_count(jcfg)
    for name, shape in jconfig.SHAPES.items():
        tshape = tconfig.SHAPES[name]
        assert troof.model_flops(tcfg, tshape) == \
            jroof.model_flops(jcfg, shape), name
        assert troof.flops_model(tcfg, tshape) == \
            jroof.flops_model(jcfg, shape), name
        cell = {"arch": arch, "shape": name,
                "collective_bytes": {"all-gather": 3.0e9},
                "memory": {"argument_size_in_bytes": 2 ** 30}}
        for chips in (1, 256):
            got, ref = troof.roofline_row(cell, chips), \
                jroof.roofline_row(cell, chips)
            for k in ("model_flops", "useful_ratio", "hbm_gb_per_dev"):
                assert got[k] == ref[k], (name, k)
            assert got["compute_s"] * troof.PEAK_FLOPS == pytest.approx(
                ref["compute_s"] * jroof.PEAK_FLOPS, rel=1e-15)
            assert got["memory_s"] * troof.HBM_BW == pytest.approx(
                ref["memory_s"] * jroof.HBM_BW, rel=1e-15)
            assert got["collective_s"] * troof.LINK_BW == pytest.approx(
                ref["collective_s"] * jroof.LINK_BW, rel=1e-15)


def test_h100_constants_and_one_card_row():
    """The H100 SXM5 datasheet's rates; one card's granite-3-2b training
    step at (2, 4096) against the row: the bound is the compute term, and
    a step of the bound's length reads a share of 1."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    shape = tconfig.ShapeConfig("train_4k", 4096, 2, "train")
    row = troof.roofline_row({"arch": "granite-3-2b", "shape": shape},
                             chips=1)
    assert row["dominant"] == "compute" and row["collective_s"] == 0.0
    fl = troof.flops_model(tconfig.get_config("granite-3-2b"), shape)
    assert row["compute_s"] == fl["flops"] / 989e12
    sh = troof.measured_shares(row, row["bound_s"])
    assert sh["bound_share"] == 1.0
    assert sh["mfu"] == pytest.approx(row["roofline_fraction"], rel=1e-12)


@pytest.mark.parametrize("arch", ["granite-3-2b", "dbrx-132b",
                                  "xlstm-125m"])
def test_param_count_matches_actual_tree(arch):
    r = tconfig.reduced_config(tconfig.get_config(arch))
    actual = sum(w.numel() for w in get_model(r).param_shapes().parameters())
    total, active = troof.param_count(r)
    assert total == pytest.approx(actual, rel=0.06)
    assert active <= total


def test_analytic_flops_vs_flop_counter():
    """A config whose forward is two layers in one group: the analytic
    model lands within 35 % of ``FlopCounterMode``'s count of the port's
    prefill forward (the plain attention on the CPU counts the full S×S
    products, as the model does)."""
    base = tconfig.reduced_config(tconfig.get_config("granite-3-2b"))
    cfg = dataclasses.replace(base, n_layers=2, layer_group=2, remat="none")
    shape = tconfig.ShapeConfig("tiny", seq_len=64, global_batch=2,
                                mode="prefill")
    params = get_model(cfg).init(0, device="cpu")
    tokens = torch.zeros((2, 64), dtype=torch.int64)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        tfm.lm_forward(params, cfg, tokens)
    anal = troof.flops_model(cfg, shape)["flops"]
    counted = counter.get_total_flops()
    assert anal == pytest.approx(counted, rel=0.35), (anal, counted)
