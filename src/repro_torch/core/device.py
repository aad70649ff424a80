"""Where the port's entry points run."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) raises on a host without a card: nothing falls
    back to the CPU unless the caller asks for it. ``"meta"`` — shapes
    and dtypes, no memory and no arithmetic — serves the verifier
    (``exec_verify.lint_program``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
