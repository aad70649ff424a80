"""Deterministic synthetic token pipeline — the port of
``repro/data/pipeline.py`` (numpy only; its batches are the JAX
package's, bit for bit).

Sequences are Zipf-ish ngram-correlated token streams, generated
per-(step, shard) from a counter-based RNG: any host can regenerate any
step independently, which is what restarts need (no data state in a
checkpoint beyond the step counter). A prefetch thread keeps the host
ahead of the device steps."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["SyntheticTokens", "make_batch_specs"]


@dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0
    prefetch: int = 2

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Regenerable batch for a global step (host-independent)."""
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        # correlated stream: random walk over vocab with Zipf jumps
        base = rng.zipf(1.4, size=(B, S)).astype(np.int64)
        tokens = (np.cumsum(base, axis=1) % (self.vocab - 1)) + 1
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        out = {"tokens": tokens.astype(np.int32),
               "labels": labels.astype(np.int32),
               "loss_mask": mask}
        if self.frontend_tokens and self.d_model:
            out["frontend"] = rng.standard_normal(
                (B, self.frontend_tokens, self.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = 0
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_batch_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """Stand-ins for one training batch: ``meta`` tensors of each input's
    shape and dtype (no memory)."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    specs = {"tokens": meta((B, S), torch.int32),
             "labels": meta((B, S), torch.int32),
             "loss_mask": meta((B, S), torch.float32)}
    if cfg.frontend == "vision":
        specs["frontend"] = meta((B, cfg.n_frontend_tokens, cfg.d_model),
                                 torch.float32)
    elif cfg.frontend == "audio" or cfg.enc_layers:
        specs["frontend"] = meta((B, S, cfg.d_model), torch.float32)
    return specs
