"""The check fails what it must: a run of a tiny cell on the CPU, past
the harness's look for a card, with the timed path broken underneath —
and with the control, the port's own f32 path — comes out not
``correct``; the sound run comes out ``correct``."""
import time

import pytest
import torch

from benchtiny import tiny_root

from pselbench import harness
from pselbench.cells import Bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Bench(tiny_root(tmp_path_factory.mktemp("bench")))


def _run(bench, cell, solve_dtype=None):
    run = harness.run_cell(bench, cell, seed=2 ** 32 + 9, seconds=0.3,
                           trace=False, device=torch.device("cpu"),
                           t_start=time.perf_counter(),
                           solve_dtype=solve_dtype)
    return harness.result(bench, run)


def _unchanged(monkeypatch):
    """The solve hands back its input state (D⁻¹) as A⁻¹."""
    from repro_torch.core.engine import PSelInvEngine
    monkeypatch.setattr(PSelInvEngine, "solve",
                        lambda self, values, dtype=None, **kw:
                        values.Dinv.to(dtype or values.Dinv.dtype))


def _no_exchange(monkeypatch):
    """The permutes between the virtual ranks deliver nothing."""
    from repro_torch.core import pselinv_dist
    monkeypatch.setattr(pselinv_dist, "_permute_lanes",
                        lambda payload, ln: torch.zeros_like(payload))


def _altered(monkeypatch):
    """One entry of A⁻¹ altered where the sweep produces it."""
    from repro_torch.core import pselinv_dist
    finish = pselinv_dist._finish

    def altered(*args):
        out = finish(*args)
        out[:, 0, 0, 0, 0, 0] += 1e-6 * out.abs().max()
        return out
    monkeypatch.setattr(pselinv_dist, "_finish", altered)


def _half_batch(monkeypatch):
    """The second half of a batch's lanes left out of the sweep."""
    from repro_torch.core import pselinv_dist
    finish = pselinv_dist._finish

    def half(*args):
        out = finish(*args)
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(pselinv_dist, "_finish", half)


@pytest.mark.parametrize("cell", ["tiny-fem.solve", "tiny-fem.poles4"])
def test_sound_run_is_correct(bench, cell):
    res = _run(bench, cell)
    assert res["correct"] is True
    assert res["checks"]["rel_gap"]["value"] < 1e-13


@pytest.mark.parametrize("cell", ["tiny-fem.solve", "tiny-fem.poles4"])
def test_control_f32_is_not_correct(bench, cell):
    res = _run(bench, cell, solve_dtype=torch.float32)
    assert res["correct"] is False
    gap = res["checks"]["rel_gap"]["value"]
    assert 1e-9 < gap < 1e-5     # f32 rounding, not a broken run


@pytest.mark.parametrize("fault", [_unchanged, _no_exchange, _altered])
@pytest.mark.parametrize("cell", ["tiny-fem.solve", "tiny-fem.poles4"])
def test_fault_is_not_correct(bench, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(bench, cell)
    assert res["correct"] is False and res["failed"] > 0


def test_half_batch_left_out_is_not_correct(bench, monkeypatch):
    _half_batch(monkeypatch)
    res = _run(bench, "tiny-fem.poles4")
    assert res["correct"] is False and res["failed"] > 0
