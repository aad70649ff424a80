"""LR schedules — the port of ``repro/optim/schedules.py``: pure
functions of the step counter, in f32."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1, device=None) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor · peak_lr`` at ``total``. ``step`` is an int or a
    tensor; returns an f32 scalar tensor (on ``step``'s device, or on
    ``device`` for an int)."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, device=device)
    step = step.to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
