"""Batched serving loop — the port of ``repro/runtime/serve_loop.py``:
continuous batching over a request queue.

Slots hold independent requests; every engine step decodes one token for
every active slot (the whole batch shares one decode step). Free slots
are refilled from the queue each step, and a new request's prompt is fed
token by token through the same step (prefill-as-decode: the JAX engine
has no fused prefill either), with per-slot positions so requests of
different lengths coexist in one KV cache.

The decode step is an eager call (the JAX engine jits it); the engine
serves :meth:`ModelAPI.serving_params` of the parameters it is given, so
every weight is in the compute dtype once, before the first step.
``step_s`` keeps each step's wall time on the host clock, the step's
copy of the next tokens to the host included.

With a ``mesh`` the engine serves the sharded decode step
(``launch.steps.build_decode_step(..., mesh=)``): the weights laid out
by ``param_specs``, the cache by ``cache_pspec``, and the logits, hence
the next tokens, whole on every rank. Every rank of the mesh runs the
same engine on the same requests."""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, api, params, batch_slots: int, max_seq: int,
                 greedy: bool = True, mesh=None):
        self.api = api
        self.params = api.serving_params(params)
        self.device = self.params.embed.table.device
        self.B = batch_slots
        self.S = max_seq
        self.cache = api.init_cache(batch_slots, max_seq, device=self.device)
        self._step = api.decode_step
        if mesh is not None:
            from ..launch import steps
            if self.params is params:       # never shard the caller's
                self.params = type(params)(api.cfg, device="meta")
                self.params.load_state_dict(params.state_dict(),
                                            assign=True)
            steps.shard_params(self.params, api.cfg, mesh)
            self.cache = steps.shard_cache(self.cache, mesh)
            self._step = steps.build_decode_step(api.cfg, None, mesh=mesh)
        self.pos = np.zeros(batch_slots, np.int32)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.last_token = np.zeros(batch_slots, np.int32)
        self.step_s: List[float] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # feed the prompt token by token (prefill-as-decode)
                self.pos[i] = 0
                req._feed = list(req.prompt)
                self.last_token[i] = req._feed.pop(0)

    def step(self):
        """One engine iteration: decode one token for every active slot."""
        self._fill_slots()
        if all(s is None for s in self.slots):
            return False
        t0 = time.perf_counter()
        logits, self.cache = self._step(
            self.params,
            torch.from_numpy(self.last_token).to(self.device),
            torch.from_numpy(self.pos).to(self.device), self.cache)
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self.step_s.append(time.perf_counter() - t0)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            if getattr(req, "_feed", None):
                self.last_token[i] = req._feed.pop(0)   # still prefilling
                continue
            req.out.append(int(nxt[i]))
            self.last_token[i] = nxt[i]
            if len(req.out) >= req.max_new or self.pos[i] >= self.S - 1:
                req.done = True
                self.slots[i] = None
        return True

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                break
