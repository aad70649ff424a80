"""xlstm-125m's teacher-forced decode against its prefill, at full size on
the CPU, in the JAX package and in the port, on the weights and tokens
that phase 11 of ``chip_smoke.py`` runs on the card.

xlstm-125m's mLSTM input gate is stabilised by its max over the whole
tensor (``repro/models/xlstm.py:104``): over every position and head of
a (1, 2048) prefill, over one step's heads in decode. The normaliser's
floor (``max(|q·n|, 1)``) does not scale with it, so a decode step departs
from the prefill's logits by design, and the JAX package's own decode
does not reproduce its own forward. This script measures that gap on:

- the port's seeded init, ``ModelAPI.init(0, device="cpu")`` — the draws
  ``chip_smoke.py`` makes on the host for xlstm-125m — served in bf16 and
  carried into a JAX parameter tree, every leaf once;
- tokens ``np.random.default_rng(10).integers(0, vocab, (1, 2048))``;
- 16 teacher-forced decode steps against the prefill's first 16
  positions, in units of the tolerance rtol 5e-2 + atol 5e-2 ·
  max(1, max|ref|) over the real vocab (``chip_smoke.lm_close``).

It prints the JAX package's gap (the bound ``chip_smoke.py`` holds the
card's decode to is 1.1 × it), the port's own gap on the CPU (the
kernels' plain versions), the port's prefill and decode against the JAX
package's, the same decode layer-forced (each block's step on the JAX
package's own hidden state and state: the largest reading of a block's
output or new state, and of the logits), and the weights' fingerprint
(the sum of every served weight, in f64), then one JSON line of them.
It runs in well under a minute and under 2 GB.

    PYTHONPATH=src python tests/xlstm_decode_gap.py
"""
import json
import resource
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import config as jconfig
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import config as tconfig
from repro_torch.models import get_model
from repro_torch.models import transformer as ttfm

ARCH, SEED, TOKENS_SEED, S, STEPS, TOL = "xlstm-125m", 0, 10, 2048, 16, 5e-2


def reads(out, ref, vocab):
    """The share of the tolerance ``out`` uses against ``ref`` (logits
    over the real vocab, ``vocab``; None: every column), as
    ``chip_smoke.lm_close`` reads it."""
    out = np.asarray(out, np.float32)[..., :vocab]
    ref = np.asarray(ref, np.float32)[..., :vocab]
    real = ref > -1e29                # the sLSTM stabiliser's −1e30 start
    out, ref = out[real], ref[real]
    atol = TOL * max(1.0, float(np.abs(ref).max()))
    return float((np.abs(out - ref) / (atol + TOL * np.abs(ref))).max())


def fingerprint(model) -> float:
    return float(sum(w.double().sum().item() for w in model.parameters()))


def jax_tree(model, cfg, shapes):
    """The JAX parameter tree (structure and dtypes of ``shapes``) holding
    ``model``'s values: block ``l`` goes to group ``l // layer_group`` of
    position ``l % layer_group`` (the inverse of
    ``repro_torch.models.convert.params_from_jax``)."""
    g = cfg.layer_group
    state = {k: v.float().numpy() for k, v in model.state_dict().items()}
    used = set()

    def fill(path, leaf):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] == "blocks":
            gp, rest = int(keys[1]), ".".join(keys[2:])
            names = [f"blocks.{gp + i * g}.{rest}"
                     for i in range(cfg.n_layers // g)]
            arr = np.stack([state[n] for n in names])
        else:
            names = [".".join(keys)]
            arr = state[names[0]]
        used.update(names)
        assert arr.shape == leaf.shape, (keys, arr.shape, leaf.shape)
        return jnp.asarray(arr).astype(leaf.dtype)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    assert used == set(state), sorted(set(state) - used)
    return tree


def layer_forced_decode(sp, cfg, jp, jcfg, japi, toks):
    """(the largest reading of a block's output or new state, of the
    logits) over STEPS decode steps, each block of the port on the JAX
    package's own hidden state and state at its input."""
    g, jit = cfg.layer_group, {}
    cache = list(japi.init_cache(1, STEPS))
    blocks = logits = 0.0

    def bf16(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                                ).to(torch.bfloat16)

    def close(out, ref):
        out = out.float().numpy() if isinstance(out, torch.Tensor) else out
        return reads(out, np.asarray(jnp.asarray(ref).astype(jnp.float32)),
                     None)

    for t in range(STEPS):
        h = jlayers.embed(jp["embed"], jnp.asarray(toks[:, t])[:, None],
                          jnp.bfloat16)
        pos = jnp.full((1,), t, jnp.int32)
        for l, kind in enumerate(ttfm.layer_kinds(cfg)):
            lp = jax.tree_util.tree_map(lambda a: a[l // g],
                                        jp["blocks"][l % g])
            st = {k: v[l // g] for k, v in cache[l % g].items()}
            if kind not in jit:
                jit[kind] = jax.jit(lambda p, x, q, s, kind=kind:
                                    jtfm.block_decode(p, jcfg, kind, x, q, s))
            hj, new = jit[kind](lp, h, pos, st)
            ht, tnew = ttfm.block_decode(
                sp.blocks[l], cfg, bf16(h), torch.full((1,), t),
                {k: bf16(v).to(ttfm.cache_dtype(k, cfg)) if
                 ttfm.cache_dtype(k, cfg) == torch.bfloat16 else
                 torch.from_numpy(np.array(v, np.float32))
                 for k, v in st.items()})
            blocks = max(blocks, close(ht, hj),
                         *(close(tnew[k], new[k]) for k in tnew))
            cache[l % g] = {k: v.at[l // g].set(new[k])
                            for k, v in cache[l % g].items()}
            h = hj
        logits = max(logits, reads(
            ttfm._logits(sp, cfg, bf16(h)).float().numpy(),
            np.asarray(jtfm._logits(jp, jcfg, h).astype(jnp.float32)),
            cfg.vocab))
    return blocks, logits


def main() -> int:
    t0 = time.perf_counter()
    cfg = tconfig.get_config(ARCH)
    jcfg = jconfig.get_config(ARCH)
    api, japi = get_model(cfg), jget_model(jcfg)
    sp = api.serving_params(api.init(SEED, device="cpu"))
    fp = fingerprint(sp)
    jp = jax_tree(sp, cfg, jax.eval_shape(japi.init, jax.random.key(0)))
    toks = np.random.default_rng(TOKENS_SEED).integers(
        0, cfg.vocab, (1, S)).astype(np.int32)

    jfull = jax.jit(lambda p, t: jtfm.lm_forward(p, jcfg, t)[0])(
        jp, jnp.asarray(toks))
    jfull = np.asarray(jfull[:, :STEPS].astype(jnp.float32))
    jstep = jax.jit(japi.decode_step)
    cache, jdec = japi.init_cache(1, S), []
    for t in range(STEPS):
        lg, cache = jstep(jp, jnp.asarray(toks[:, t]),
                          jnp.full((1,), t, jnp.int32), cache)
        jdec.append(np.asarray(lg.astype(jnp.float32)))
    jdec = np.stack(jdec, 1)

    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        tfull = ttfm.lm_forward(sp, cfg, tt)[0][:, :STEPS].float().numpy()
        cache, tdec = api.init_cache(1, S, device="cpu"), []
        for t in range(STEPS):
            lg, cache = api.decode_step(sp, tt[:, t], torch.full((1,), t),
                                        cache)
            tdec.append(lg.float().numpy())
    tdec = np.stack(tdec, 1)

    with torch.no_grad():
        forced_blocks, forced_logits = layer_forced_decode(sp, cfg, jp, jcfg,
                                                           japi, toks)
    V = cfg.vocab
    out = dict(arch=ARCH, init_seed=SEED, tokens_seed=TOKENS_SEED, S=S,
               steps=STEPS, weights_fingerprint=fp,
               jax_decode_vs_prefill=reads(jdec, jfull, V),
               port_decode_vs_prefill=reads(tdec, tfull, V),
               port_vs_jax_prefill=reads(tfull, jfull, V),
               port_vs_jax_decode=reads(tdec, jdec, V),
               layer_forced_decode_blocks=forced_blocks,
               layer_forced_decode_logits=forced_logits,
               seconds=time.perf_counter() - t0,
               peak_rss_gb=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2**20)
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
