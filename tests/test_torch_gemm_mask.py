"""The level product's struct mask, on the CPU: ``blocked_gemm(...,
cmask=)`` and ``pselinv_round_gemm`` against the plain product of the
masked Û for every form of mask the sweep hands them — a (P, nk, nbc)
table over a (B, P) lead, a full-lead mask, 0/1 values, k rows that keep
nothing, and a strided slice of an NK-padded table, which reaches the
kernel's entry as the view it is. The CUDA kernel's masked K loop is
held bitwise to the dense kernel on the card by
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_gemm as bg
from repro_torch.kernels import ops


def _operands(seed, B, P, nk, nbr, nbc, b):
    g = np.random.default_rng(seed)
    A = torch.from_numpy(g.standard_normal((B, P, nbr, nbc, b, b)))
    U = torch.from_numpy(g.standard_normal((B, P, nk, nbc, b, b)))
    return A, U


def _reference(A, U, keep):
    """partial[..., k, i] = Σ_j keep[..., k, j] · A[..., i, j] @ U[..., k,
    j]ᵀ, block by block, in f64; ``keep`` broadcast over the lead."""
    keep = torch.as_tensor(keep).to(torch.float64).expand(
        U.shape[:-2]).contiguous()
    return torch.einsum("...ijab,...kjcb,...kj->...kiac", A, U, keep)


def _mask(seed, shape, share=0.3):
    return torch.from_numpy(np.random.default_rng(seed).random(shape)
                            < share)


MASKS = ["rank_table", "full_lead", "float01", "empty_rows",
         "padded_slice"]


def _mask_case(case, B, P, nk, nbc):
    """The mask of ``case`` over a (B, P) lead, and the bool it means."""
    if case == "rank_table":
        m = _mask(1, (P, nk, nbc))
        return m, m
    if case == "full_lead":
        m = _mask(2, (B, P, nk, nbc))
        return m, m
    if case == "float01":
        m = _mask(3, (P, nk, nbc))
        return m.to(torch.float64), m
    if case == "empty_rows":
        m = _mask(4, (P, nk, nbc))
        m[:, 0] = False
        m[P - 1] = False
        return m, m
    # the stream's NK-padded level table, cut to the level's nk
    NK = nk + 2
    table = _mask(5, (3, P, NK, nbc))
    table[:, :, nk:] = False
    m = table[1, :, :nk]
    assert not m.is_contiguous()
    return m, m


@pytest.mark.parametrize("case", MASKS)
@pytest.mark.parametrize("nk", [1, 3])
def test_round_gemm_is_the_masked_product(case, nk):
    B, P, nbr, nbc, b = 2, 4, 3, 5, 4
    A, U = _operands(nk, B, P, nk, nbr, nbc, b)
    cm, keep = _mask_case(case, B, P, nk, nbc)
    want = _reference(A, U, keep)
    got = ops.pselinv_round_gemm(A, U, cm)
    assert got.shape == (B, P, nk, nbr, b, b)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    out = torch.full((B, P, nk, nbr, b, b), 7.0, dtype=torch.float64)
    assert ops.pselinv_round_gemm(A, U, cm, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", MASKS)
def test_blocked_gemm_takes_the_mask_over_its_batch(case):
    """``blocked_gemm`` over the flattened (B·P) batch: item z takes row
    z % Pm of a (Pm, nk, nbc) mask, Pm = P or Pm = B·P; the result is
    the dense product of the masked Û."""
    B, P, nk, nbr, nbc, b = 3, 2, 2, 2, 4, 3
    A, U = _operands(7, B, P, nk, nbr, nbc, b)
    cm, keep = _mask_case(case, B, P, nk, nbc)
    cm = cm.reshape((-1, nk, nbc))
    a, u = A.reshape(-1, nbr, nbc, b, b), U.reshape(-1, nk, nbc, b, b)
    masked = torch.where(keep.expand(B, P, nk, nbc).reshape(
        -1, nk, nbc)[..., None, None], u, 0.0)
    want = bg.blocked_gemm_plain(a, masked)
    assert torch.equal(bg.blocked_gemm(a, u, cmask=cm), want)
    assert torch.equal(bg.mask_uh(u, cm != 0), masked)
    torch.testing.assert_close(
        want, _reference(A, U, keep).reshape(-1, nk, nbr, b, b),
        rtol=0, atol=1e-12)


def test_blocked_gemm_refuses_a_mask_that_does_not_fit():
    a = torch.zeros(6, 2, 4, 3, 3, dtype=torch.float64)
    u = torch.zeros(6, 2, 4, 3, 3, dtype=torch.float64)
    for bad in [torch.ones(4, 2, 4, dtype=torch.bool),     # 4 ∤ 6
                torch.ones(3, 2, 5, dtype=torch.bool),     # nbc
                torch.ones(3, 1, 4, dtype=torch.bool),     # nk
                torch.ones(2, 4, dtype=torch.bool)]:       # rank 2
        with pytest.raises(ValueError, match="cmask"):
            bg.blocked_gemm(a, u, cmask=bad)


def test_the_sweeps_mask_reaches_the_kernel_entry_as_a_view(monkeypatch):
    """A (P, nk, nbc) table over a (B, P) lead — the stream's strided,
    NK-padded slice included — is handed to ``blocked_gemm`` as the view
    it is (no copy on the sweep's path), and a full-lead mask as the
    (B·P, nk, nbc) view of itself."""
    seen = []

    def spy(a, u, out=None, cmask=None):
        seen.append(cmask)
        return bg.blocked_gemm(a, u, out=out, cmask=cmask)

    monkeypatch.setattr(ops, "blocked_gemm", spy)
    B, P, nk, nbr, nbc, b = 2, 4, 3, 2, 5, 2
    A, U = _operands(3, B, P, nk, nbr, nbc, b)
    for case in ("padded_slice", "rank_table", "full_lead"):
        cm, keep = _mask_case(case, B, P, nk, nbc)
        got = ops.pselinv_round_gemm(A, U, cm)
        torch.testing.assert_close(got, _reference(A, U, keep), rtol=0,
                                   atol=1e-12)
        m = seen[-1]
        assert m.data_ptr() == cm.data_ptr()
        assert m.shape == (cm.numel() // (nk * nbc), nk, nbc)
        assert m.stride()[1:] == cm.stride()[-2:]


@pytest.mark.parametrize("nbc", [33, 64])
@pytest.mark.parametrize("rows", ["straddle", "high_only", "random"])
def test_round_gemm_masks_past_the_first_32_column_blocks(rows, nbc):
    """Masks wider than one 32-column word (the main path's nbc is 64):
    rows that keep blocks on both sides of j = 32, rows that keep only
    j ≥ 32, and random rows, each the plain product of the masked Û."""
    B, P, nk, nbr, b = 2, 4, 3, 2, 2
    A, U = _operands(nbc, B, P, nk, nbr, nbc, b)
    if rows == "random":
        cm = _mask(nbc, (P, nk, nbc), share=0.1)
    else:
        cm = torch.zeros(P, nk, nbc, dtype=torch.bool)
        keep = [32, nbc - 1] if rows == "high_only" else [0, 31, 32,
                                                           nbc - 1]
        cm[:, :, keep] = True
        cm[1, 2] = False
    got = ops.pselinv_round_gemm(A, U, cm)
    torch.testing.assert_close(got, _reference(A, U, cm), rtol=0,
                               atol=1e-12)
    a, u = A.reshape(-1, nbr, nbc, b, b), U.reshape(-1, nk, nbc, b, b)
    assert torch.equal(bg.blocked_gemm(a, u, cmask=cm),
                       bg.blocked_gemm_plain(a, bg.mask_uh(u, cm)))
