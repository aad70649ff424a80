"""The port's tree-collective library (``repro_torch.comm``) on 8 gloo
rank processes against the JAX package's ``repro.comm`` on 8 host
devices, in f64.

One JAX subprocess (8 host devices, x64) runs the collective cases of
``tests/test_distributed.py`` — subset broadcast and reduce, the tree
all-reduce, the hierarchical all-reduce and the tree gradient sync — on
an integer-valued and a seeded random input each, plus ``batched_rounds``
and the int8 compression of a 1000-element f32 array, and writes an
``.npz``. One group of 8 gloo processes (``p2p.spawn``, CPU tensors)
computes the same collectives with the port. Integer-valued results
must be equal, random ones within 1e-12·|members|·max|x|; the
quantization equal and the error-feedback residual within 1e-7."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_sub

from repro_torch.comm import (batched_rounds, compression, p2p,
                              subset_broadcast, subset_reduce,
                              tree_allreduce)
from repro_torch.comm.hierarchical import hierarchical_allreduce, mesh_groups
from repro_torch.core.trees import TreeKind, build_tree

N = 8
MEMBERS = [1, 3, 4, 6]
KINDS = ("int", "rand")
ALL_TREE = dict(root=2, receivers=[0, 1, 3, 4, 5, 6, 7], tag=13)
BATCHED = [("shifted", 0, [1, 2, 3], 5, 0), ("binary", 1, [0, 2, 3], 0, 4)]


def _inputs():
    """(8, 4) per-rank rows, (2, 4, 8) hierarchical inputs and (2, 4, 16)
    gradient-sync batches: the JAX test's integer values and seeded
    random f64 ones."""
    rng = np.random.default_rng(17)
    return {
        "int": (np.arange(8.0 * 4).reshape(8, 4),
                np.arange(8.0 * 8).reshape(2, 4, 8),
                np.arange(2.0 * 4 * 16).reshape(2, 4, 16)),
        "rand": (rng.standard_normal((8, 4)),
                 rng.standard_normal((2, 4, 8)),
                 0.1 * rng.standard_normal((2, 4, 16))),
    }


def _compress_inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal(1000).astype(np.float32),
            (0.01 * rng.standard_normal(1000)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("commref") / "ref.npz"
    inputs = tmp_path_factory.getbasetemp() / "comm_inputs.npz"
    flat = {f"{k}_{i}": a for k, v in _inputs().items()
            for i, a in enumerate(v)}
    g, e = _compress_inputs()
    np.savez(inputs, grad=g, err=e, **flat)
    run_sub(f"""
        import jax, numpy as np
        import jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import shard_map
        from repro.core.trees import TreeKind, build_tree
        from repro.comm.treecomm import (tree_allreduce, subset_broadcast,
                                         subset_reduce, batched_rounds)
        from repro.comm.hierarchical import hierarchical_allreduce
        from repro.comm.compression import quantize_int8, ef_compress
        inp = dict(np.load({str(inputs)!r}))
        out = {{}}
        mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))
        mesh2 = Mesh(np.array(jax.devices()).reshape(2, 4), ("pod", "data"))

        def run(fn, x):
            return np.asarray(jax.jit(shard_map(
                fn, mesh=mesh, in_specs=P("x"), out_specs=P("x")))(x))

        tree = build_tree(TreeKind.SHIFTED, 2, [0, 1, 3, 4, 5, 6, 7], tag=13)
        w = jnp.ones((16,), jnp.float64) * 0.5

        def loss(w, xb):
            return jnp.sum(jnp.tanh(xb @ w))

        # each device's own gradient, taken outside shard_map: inside it
        # the gradient of the replicated w would arrive already summed
        def grads(x):
            return jax.vmap(lambda xb: jax.grad(loss)(w, xb.reshape(1, 16)))(
                x.reshape(8, 16)).reshape(2, 4, 16)

        def step_tree(g):
            g = hierarchical_allreduce(g.reshape(16), "pod", "data", 2, 4,
                                       tag=0)
            return g.reshape(1, 1, 16)

        def step_psum(g):
            return jax.lax.psum(g.reshape(16),
                                ("pod", "data")).reshape(1, 1, 16)

        def ha(xs):
            return hierarchical_allreduce(
                xs.reshape(8), "pod", "data", 2, 4, tag=3).reshape(1, 1, 8)

        def run2(fn, x):
            return np.asarray(jax.jit(shard_map(
                fn, mesh=mesh2, in_specs=P("pod", "data"),
                out_specs=P("pod", "data")))(x))

        for k in ("int", "rand"):
            x = jnp.asarray(inp[k + "_0"])
            out[k + "_bcast"] = run(lambda v: subset_broadcast(
                v, "x", 3, [1, 3, 4, 6], TreeKind.SHIFTED, tag=7), x)
            out[k + "_reduce"] = run(lambda v: subset_reduce(
                v, "x", 4, [1, 3, 4, 6], TreeKind.BINARY), x)
            out[k + "_allreduce"] = run(
                lambda v: tree_allreduce(v, "x", tree), x)
            out[k + "_hier"] = run2(ha, jnp.asarray(inp[k + "_1"]))
            g = grads(jnp.asarray(inp[k + "_2"]))
            out[k + "_gtree"] = run2(step_tree, g)
            out[k + "_gpsum"] = run2(step_psum, g)
        kinds = {{"shifted": TreeKind.SHIFTED, "binary": TreeKind.BINARY}}
        trees = [(build_tree(kinds[kd], r, rc, tag=t), off)
                 for kd, r, rc, t, off in {BATCHED!r}]
        for op in ("bcast", "reduce"):
            out["batched_" + op] = np.array(
                [[s, d, i] for i, rnd in enumerate(batched_rounds(trees, op))
                 for s, d in rnd])
        q, s = quantize_int8(jnp.asarray(inp["grad"]))
        out["q"], out["scale"] = np.asarray(q), np.asarray(s)
        q, s, e = ef_compress(jnp.asarray(inp["grad"]),
                              jnp.asarray(inp["err"]))
        out["ef_q"], out["ef_scale"] = np.asarray(q), np.asarray(s)
        out["ef_err"] = np.asarray(e)
        np.savez({str(path)!r}, **out)
    """, ndev=8, x64=True)
    return dict(np.load(path))


def _grad(xb):
    """d/dw Σ tanh(xb @ w) at w = 0.5, as the JAX test's loss."""
    w = torch.full((16,), 0.5, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.tanh(xb.reshape(1, 16) @ w).sum(), w)
    return g


def _port_rank(rank):
    """Every collective case on this rank; returns its rows."""
    torch.set_num_threads(1)
    pod_group, inner_group = mesh_groups(2, 4)
    pod, inner = divmod(rank, 4)
    tree = build_tree(TreeKind.SHIFTED, ALL_TREE["root"],
                      ALL_TREE["receivers"], tag=ALL_TREE["tag"])
    out = {}
    for k, (x, xh, xg) in _inputs().items():
        v = torch.from_numpy(x[rank].copy())
        out[k + "_bcast"] = subset_broadcast(
            v, None, 3, MEMBERS, TreeKind.SHIFTED, tag=7).numpy()
        out[k + "_reduce"] = subset_reduce(
            v, None, 4, MEMBERS, TreeKind.BINARY).numpy()
        out[k + "_allreduce"] = tree_allreduce(v, None, tree).numpy()
        out[k + "_hier"] = hierarchical_allreduce(
            torch.from_numpy(xh[pod, inner].copy()), pod_group, inner_group,
            2, 4, tag=3).numpy()
        g = _grad(torch.from_numpy(xg[pod, inner].copy()))
        out[k + "_gtree"] = hierarchical_allreduce(
            g, pod_group, inner_group, 2, 4, tag=0).numpy()
        plain = g.clone()
        dist.all_reduce(plain)
        out[k + "_gplain"] = plain.numpy()
    # the send log of one subset broadcast: one message per tree edge
    p2p.LOG.clear()
    subset_broadcast(torch.zeros(5, dtype=torch.float64), None, 3, MEMBERS)
    out["log"] = (p2p.LOG.rounds, p2p.LOG.sent(), p2p.LOG.received(),
                  p2p.LOG.staged_bytes)
    # the collective-permute rule, checked before anything moves
    bad = []
    for perm in ([(0, 1), (0, 2)], [(0, 2), (1, 2)], [(3, 3)], [(0, 8)]):
        try:
            p2p.ppermute(torch.zeros(1), perm)
        except ValueError:
            bad.append(perm)
    out["rejected"] = len(bad)
    return out


@pytest.fixture(scope="module")
def port():
    rows = p2p.spawn(_port_rank, N, timeout=300)
    return {k: ([r[k] for r in rows] if k in ("log", "rejected")
                else np.stack([r[k] for r in rows])) for k in rows[0]}


def _tol(x, members):
    return 1e-12 * members * np.abs(x).max()


def _check(got, ref, x, members, kind):
    if kind == "int":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= _tol(x, members)


@pytest.mark.parametrize("kind", KINDS)
def test_subset_broadcast_matches_jax(jax_ref, port, kind):
    x = _inputs()[kind][0]
    _check(port[kind + "_bcast"], jax_ref[kind + "_bcast"], x, 1, kind)
    exp = np.array([x[3] if r in MEMBERS else x[r] for r in range(N)])
    np.testing.assert_array_equal(port[kind + "_bcast"], exp)


@pytest.mark.parametrize("kind", KINDS)
def test_subset_reduce_matches_jax(jax_ref, port, kind):
    x = _inputs()[kind][0]
    _check(port[kind + "_reduce"][4], jax_ref[kind + "_reduce"][4], x,
           len(MEMBERS), kind)
    assert np.abs(port[kind + "_reduce"][4] - x[MEMBERS].sum(0)).max() \
        <= _tol(x, len(MEMBERS))


@pytest.mark.parametrize("kind", KINDS)
def test_tree_allreduce_matches_jax(jax_ref, port, kind):
    x = _inputs()[kind][0]
    _check(port[kind + "_allreduce"], jax_ref[kind + "_allreduce"], x, N,
           kind)
    assert np.abs(port[kind + "_allreduce"] - x.sum(0)).max() \
        <= _tol(x, N)


@pytest.mark.parametrize("kind", KINDS)
def test_hierarchical_allreduce_matches_jax(jax_ref, port, kind):
    xh = _inputs()[kind][1]
    got = port[kind + "_hier"].reshape(2, 4, 8)
    _check(got, jax_ref[kind + "_hier"], xh, N, kind)
    assert np.abs(got - xh.sum((0, 1))).max() <= _tol(xh, N)


@pytest.mark.parametrize("kind", KINDS)
def test_grad_sync_tree_equals_plain_sum(jax_ref, port, kind):
    """The manual data-parallel gradient sync over the hierarchical tree
    equals the plain all-reduce sum, and the JAX package's tree sync."""
    got = port[kind + "_gtree"].reshape(2, 4, 16)
    g = np.abs(port[kind + "_gplain"]).max()
    assert np.abs(got - port[kind + "_gplain"].reshape(2, 4, 16)).max() \
        <= 1e-12 * N * g
    assert np.abs(got - jax_ref[kind + "_gtree"]).max() <= 1e-12 * N * g
    assert np.abs(got - jax_ref[kind + "_gpsum"]).max() <= 1e-12 * N * g


def test_send_log_counts_tree_edges(port):
    """One subset broadcast of 5 f64 values: one round per tree round,
    one message per edge, sent by its parent and received by its child;
    CPU tensors stage nothing."""
    tree = build_tree(TreeKind.SHIFTED, 3, [1, 4, 6])
    edges = [e for rnd in tree.bcast_rounds() for e in rnd]
    for rank, (rounds, sent, recv, staged) in enumerate(port["log"]):
        assert rounds == len(tree.bcast_rounds())
        assert sent == (sum(s == rank for s, _ in edges),
                        40 * sum(s == rank for s, _ in edges))
        assert recv == (sum(d == rank for _, d in edges),
                        40 * sum(d == rank for _, d in edges))
        assert staged == 0


def test_ppermute_enforces_the_permute_rule(port):
    assert port["rejected"] == [4] * N


@pytest.mark.parametrize("op", ["bcast", "reduce"])
def test_batched_rounds_match_jax(jax_ref, op):
    kinds = {"shifted": TreeKind.SHIFTED, "binary": TreeKind.BINARY}
    trees = [(build_tree(kinds[k], r, rc, tag=t), off)
             for k, r, rc, t, off in BATCHED]
    got = [[s, d, i] for i, rnd in enumerate(batched_rounds(trees, op))
           for s, d in rnd]
    np.testing.assert_array_equal(np.array(got), jax_ref["batched_" + op])


def test_batched_rounds_reject_overlapping_trees():
    t = build_tree(TreeKind.BINARY, 0, [1, 2, 3])
    with pytest.raises(ValueError, match="not disjoint"):
        batched_rounds([(t, 0), (t, 0)], "bcast")


def test_quantize_int8_matches_jax(jax_ref):
    g, _ = _compress_inputs()
    q, scale = compression.quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jax_ref["q"])
    np.testing.assert_array_equal(scale.numpy(), jax_ref["scale"])
    back = compression.dequantize_int8(q, scale, g.shape)
    assert np.abs(back.numpy() - g).max() <= scale.max().item() / 2 + 1e-7


def test_ef_compress_matches_jax(jax_ref):
    g, e = _compress_inputs()
    q, scale, err = compression.ef_compress(torch.from_numpy(g),
                                            torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), jax_ref["ef_q"])
    np.testing.assert_array_equal(scale.numpy(), jax_ref["ef_scale"])
    assert np.abs(err.numpy() - jax_ref["ef_err"]).max() <= 1e-7
    restored = compression.ef_restore(q, scale, g.shape)
    assert np.abs(restored.numpy() + err.numpy() - (g + e)).max() <= 1e-6


def test_all_zero_block_gets_unit_scale():
    q, scale = compression.quantize_int8(torch.zeros(300))
    assert scale.flatten().tolist() == [1.0, 1.0]
    assert not q.any()


def _fails_on_rank_one(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def test_spawn_fails_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        p2p.spawn(_fails_on_rank_one, 2, timeout=120)


def test_nccl_backend_is_not_supported():
    """This host has no NCCL (and no card): ``backend="nccl"`` raises,
    naming it, before any rank starts."""
    with pytest.raises(RuntimeError, match="NCCL"):
        p2p.spawn(_fails_on_rank_one, 2, backend="nccl")
