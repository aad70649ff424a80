"""On the card: a tiny cell through the harness is correct, its control
(the f32 path) is not, and a traced run reads device time. Skips
without a card (decided in the fixture); run on the card with
``python3 -m pytest -m cuda bench/tests``."""
import time

import pytest
import torch

from benchtiny import tiny_root

from pselbench import harness
from pselbench.cells import Bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card, tmp_path):
    bench = Bench(tiny_root(tmp_path))
    for cell in ("tiny-fem.solve", "tiny-fem.poles4"):
        run = harness.run_cell(bench, cell, seed=5, seconds=0.5, trace=True,
                               device=card, t_start=time.perf_counter())
        res = harness.result(bench, run)
        assert res["correct"] is True
        assert res["device"]["busy_s"] > 0
        assert 0 < res["metrics"]["products_roofline"]["value"] <= 100
        ctl = harness.run_cell(bench, cell, seed=5, seconds=0.5,
                               trace=False, device=card,
                               t_start=time.perf_counter(),
                               solve_dtype=torch.float32)
        assert harness.result(bench, ctl)["correct"] is False
