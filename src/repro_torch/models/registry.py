"""Model registry — the port of ``repro/models/registry.py``: one uniform
set of entry points (init, prefill, decode) per config, so the launcher
and the serving engine treat every arch alike.

Every family serves: the decoder-only configs through
:mod:`.transformer` (parameters an :class:`~.transformer.LM`), the
encoder-decoder through :mod:`.encdec` (an :class:`~.encdec.EncDec`,
whose cache comes from ``encdec_init_cache`` with the encoder's frames —
:meth:`ModelAPI.init_cache` raises for it, as the JAX one does).
``loss`` waits for the training slice. Entry points run on the card
unless given ``device="cpu"``."""
from __future__ import annotations

from typing import Dict

import torch

from ..core.device import resolve_device
from . import encdec as encdec_mod
from . import transformer as tfm

__all__ = ["ModelAPI", "get_model"]

_TRAINING = "ROADMAP Queue 1, item 5 (training)"


def _device_of(params) -> torch.device:
    return params.embed.table.device


class ModelAPI:
    """Family-dispatched model functions."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.is_encdec = cfg.enc_layers > 0

    # -- params ------------------------------------------------------------
    def _module(self):
        return encdec_mod.EncDec if self.is_encdec else tfm.LM

    def init(self, generator=0, device="cuda"):
        """Seeded parameters in the config's ``param_dtype`` on
        ``device`` (``transformer.init_weights``): ``generator`` is a
        ``torch.Generator`` on that device or an int seed. ``ServeEngine``
        serves :meth:`serving_params` of them."""
        dev = resolve_device(device)
        if isinstance(generator, int):
            generator = torch.Generator(device=dev).manual_seed(generator)
        return tfm.init_weights(self._module()(self.cfg, device=dev),
                                generator)

    def param_shapes(self):
        """The parameter module on the ``meta`` device: shapes and dtypes,
        no memory."""
        return self._module()(self.cfg, device="meta")

    def serving_params(self, params):
        return tfm.serving_params(params)

    # -- training ------------------------------------------------------------
    def loss(self, params, batch: Dict):
        raise NotImplementedError(
            f"the LM loss and its backward pass come with the training "
            f"slice; {_TRAINING}")

    # -- prefill (forward, last-position logits) ----------------------------
    def prefill(self, params, batch: Dict) -> torch.Tensor:
        dev = _device_of(params)
        frontend = batch.get("frontend")
        if self.is_encdec:
            return encdec_mod.encdec_forward(
                params, self.cfg, torch.as_tensor(batch["tokens"],
                                                  device=dev),
                torch.as_tensor(frontend, device=dev), last_only=True)
        if frontend is not None:
            frontend = torch.as_tensor(frontend, device=dev)
        logits, _ = tfm.lm_forward(
            params, self.cfg, torch.as_tensor(batch["tokens"], device=dev),
            frontend=frontend, last_only=True)
        return logits

    # -- decode ---------------------------------------------------------------
    def cache_spec(self, batch: int, seq: int):
        if self.is_encdec:
            return encdec_mod.encdec_cache_spec(self.cfg, batch, seq,
                                                enc_seq=seq)
        return tfm.cache_spec(self.cfg, batch, seq)

    def init_cache(self, batch: int, seq: int, device="cuda"):
        if self.is_encdec:
            raise NotImplementedError(
                "enc-dec cache needs encoder output; use encdec_init_cache")
        return tfm.init_cache(self.cfg, batch, seq, resolve_device(device))

    def decode_step(self, params, token, pos, cache):
        dev = _device_of(params)
        step = (encdec_mod.encdec_decode_step if self.is_encdec
                else tfm.lm_decode_step)
        return step(params, self.cfg, torch.as_tensor(token, device=dev),
                    torch.as_tensor(pos, device=dev), cache)


def get_model(cfg) -> ModelAPI:
    return ModelAPI(cfg)
