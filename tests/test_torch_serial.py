"""The serial supernodal path of the port — ``factorize`` + ``selinv`` with
the ``torch`` and ``cuda`` backends — on the CPU, against the dense
oracle, the port's numpy backend and the JAX package's ``jax`` backend.

One subprocess runs the JAX package under x64 and saves its factors and
its selected inverse; the port's ``selinv`` on those very factors
(``lu_from_numpy``) must match the JAX ``selinv`` on them. With
``device="cpu"`` the ``cuda`` backend runs its kernels' plain versions;
the kernels themselves run on the card in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from conftest import run_sub

from repro_torch.core import sparse
from repro_torch.core import supernodal_lu as slu
from repro_torch.core.engine import lu_from_numpy
from repro_torch.core.selinv import (compare_with_oracle, selected_inverse,
                                     selinv)
from repro_torch.core.symbolic import symbolic_factorize
from repro_torch.kernels import ops

BACKENDS = ["torch", "cuda"]
TOL = 1e-12


def _matrix():
    return sparse.laplacian_2d(12, 8)


def _max_diff(a, b):
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


@pytest.fixture(scope="module")
def jax_serial(tmp_path_factory):
    """The JAX package's factors and selected inverse (``jax`` backend,
    f64), saved from one x64 subprocess."""
    path = tmp_path_factory.mktemp("jaxserial") / "serial.npz"
    run_sub(f"""
        import numpy as np
        from repro.core import sparse
        from repro.core.selinv import selinv
        from repro.core.supernodal_lu import factorize
        from repro.core.symbolic import symbolic_factorize
        A = sparse.laplacian_2d(12, 8)
        bs = symbolic_factorize(A, max_supernode=6)
        lu = factorize(A, bs=bs, backend="jax")
        out = {{"offsets": np.asarray(bs.offsets)}}
        for name in ("Ldiag", "Udiag", "L", "U"):
            for key, blk in getattr(lu, name).items():
                key = key if isinstance(key, tuple) else (key,)
                out["_".join([name] + [str(i) for i in key])] = \\
                    np.asarray(blk)
        for (I, J), blk in selinv(lu).items():
            out[f"Ainv_{{I}}_{{J}}"] = np.asarray(blk)
        assert out["Ainv_0_0"].dtype == np.float64
        np.savez({str(path)!r}, **out)
    """, ndev=1, x64=True)
    z = np.load(path)
    blocks = {"Ldiag": {}, "Udiag": {}, "L": {}, "U": {}, "Ainv": {}}
    for name in z.files:
        if name == "offsets":
            continue
        kind, *idx = name.split("_")
        idx = tuple(int(i) for i in idx)
        blocks[kind][idx[0] if kind in ("Ldiag", "Udiag") else idx] = z[name]
    blocks["offsets"] = z["offsets"]
    return blocks


@pytest.mark.parametrize("backend", BACKENDS)
def test_f32_matches_dense_oracle(backend):
    A = _matrix()
    Ainv, bs = selected_inverse(A, max_supernode=6, backend=backend,
                                device="cpu", dtype=torch.float32)
    assert Ainv[(0, 0)].dtype == np.float32
    assert compare_with_oracle(Ainv, bs, A) < 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_f64_matches_numpy_backend(backend):
    A = _matrix()
    ref, bs = selected_inverse(A, max_supernode=6, backend="numpy")
    got, _ = selected_inverse(A, max_supernode=6, backend=backend,
                              device="cpu", dtype=torch.float64)
    assert _max_diff(got, ref) <= TOL
    assert compare_with_oracle(got, bs, A) <= 1e-9


@pytest.mark.parametrize("backend", BACKENDS)
def test_f64_matches_jax_backend(jax_serial, backend):
    A = _matrix()
    bs = symbolic_factorize(A, max_supernode=6)
    np.testing.assert_array_equal(bs.offsets, jax_serial["offsets"])
    # the whole path, each package on its own factors
    lu = slu.factorize(A, bs=bs, backend=backend, device="cpu",
                       dtype=torch.float64)
    for name in ("Ldiag", "Udiag", "L", "U"):
        mine, theirs = getattr(lu, name), jax_serial[name]
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k], rtol=0,
                                       atol=TOL)
    assert _max_diff(selinv(lu), jax_serial["Ainv"]) <= TOL
    # selinv on the JAX package's own factors
    jlu = slu.LUFactors(bs=bs, Ldiag=jax_serial["Ldiag"],
                        Udiag=jax_serial["Udiag"], L=jax_serial["L"],
                        U=jax_serial["U"])
    mine = lu_from_numpy(jlu, backend, device="cpu", dtype=torch.float64)
    assert (mine.backend, mine.device, mine.dtype) == (
        backend, torch.device("cpu"), torch.float64)
    assert all(isinstance(v, torch.Tensor) for v in mine.L.values())
    assert _max_diff(selinv(mine), jax_serial["Ainv"]) <= TOL


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_host_conversion_through_np_asarray(monkeypatch, backend):
    """``np.asarray`` works on a CPU tensor but raises on a CUDA one; with
    ``Tensor.__array__`` made to raise, the CPU run stands in for the
    card: every host copy must go through the backend's ``to_numpy``."""
    A = _matrix()

    def refuse(self, *a, **k):
        raise AssertionError("np.asarray of a backend tensor")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "__array__", refuse)
        with pytest.raises(AssertionError, match="np.asarray"):
            np.asarray(torch.zeros(2))
        lu = slu.factorize(A, max_supernode=6, backend=backend,
                           device="cpu", dtype=torch.float64)
        Ainv = selinv(lu)
    assert compare_with_oracle(Ainv, lu.bs, A) <= 1e-9


def test_cuda_backend_goes_through_the_kernel_entry_points(monkeypatch):
    """The ``cuda`` backend's GEMMs reach ``ops.block_gemm[_acc]``, once
    per call of the host loop, and its right-side solves ``ops.trsm``,
    once per supernode with a non-empty struct (all of struct(K) stacked),
    each with the row-major operands the card's kernels take."""
    calls = {"block_gemm": 0, "block_gemm_acc": 0, "trsm": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            assert all(t.is_contiguous() for t in a
                       if isinstance(t, torch.Tensor)), _name
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    A = _matrix()
    lu = slu.factorize(A, max_supernode=6, backend="cuda", device="cpu")
    selinv(lu)
    sizes = [len(s) for s in lu.bs.struct]
    with_struct = sum(1 for c in sizes if c)
    assert calls == {"trsm": with_struct,
                     "block_gemm_acc": sum(c * c for c in sizes)
                     + with_struct,
                     "block_gemm": 2 * with_struct}


def test_stacked_supernode_solve_equals_per_block_solves(monkeypatch):
    """The ``cuda`` backend solves all of struct(K) in one stacked trsm;
    on the CPU each block of it equals that block's own solve within
    1e-14·max|X| in f64, and comes back contiguous."""
    cls = slu._CudaBackend
    stacked = cls.solve_tri_right_upper_many
    seen = []

    def check(self, bs, u):
        xs = stacked(self, bs, u)
        for b, x in zip(bs, xs, strict=True):
            want = ops.trsm(b, u)
            assert x.is_contiguous() and x.shape == b.shape
            assert (x - want).abs().max().item() <= \
                1e-14 * want.abs().max().item()
        seen.append(len(bs))
        return xs
    monkeypatch.setattr(cls, "solve_tri_right_upper_many", check)
    lu = slu.factorize(_matrix(), max_supernode=6, backend="cuda",
                       device="cpu", dtype=torch.float64)
    sizes = [len(s) for s in lu.bs.struct]
    assert seen == sizes and max(sizes) > 1
    assert _max_diff(lu.L, slu.factorize(_matrix(), max_supernode=6,
                                         backend="numpy").L) <= TOL


def test_backend_cache_and_factor_records():
    be = slu.get_backend("torch", "cpu", torch.float32)
    assert be is slu.get_backend("torch", torch.device("cpu"),
                                 torch.float32)
    assert be is not slu.get_backend("torch", "cpu")
    assert slu.get_backend("torch", "cpu").dtype == torch.float64
    assert slu.get_backend("cuda", "cpu") is not slu.get_backend("torch",
                                                                  "cpu")
    lu = slu.factorize(_matrix(), max_supernode=6, backend="torch",
                       device="cpu", dtype=torch.float32)
    assert (lu.device, lu.dtype) == (torch.device("cpu"), torch.float32)
    assert lu.L[next(iter(lu.L))].dtype == torch.float32
    np_lu = slu.factorize(_matrix(), max_supernode=6, backend="numpy")
    assert (np_lu.backend, np_lu.device, np_lu.dtype) == ("numpy", None,
                                                          None)
    with pytest.raises(ValueError):
        slu.get_backend("numpy", device="cuda")
    with pytest.raises(ValueError):
        slu.get_backend("pallas")


@pytest.mark.parametrize("backend", BACKENDS)
def test_gemm_takes_only_the_schur_sign(backend):
    be = slu.get_backend(backend, "cpu")
    a = torch.ones(2, 2, dtype=torch.float64)
    assert torch.equal(be.gemm(a, a, a), -a)
    with pytest.raises(ValueError, match="alpha"):
        be.gemm(a, a, a, alpha=1.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_default_device_raises_without_a_card(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slu.get_backend(backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selected_inverse(_matrix(), max_supernode=6, backend=backend)


def test_serial_entry_points_default_to_the_card(monkeypatch):
    """``selected_inverse`` and ``factorize`` run on the card unless asked
    for the host: without one, their default raises ``resolve_device``'s
    error instead of falling back to numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selected_inverse(_matrix(), max_supernode=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slu.factorize(_matrix(), max_supernode=6)
