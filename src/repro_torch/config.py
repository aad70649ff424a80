"""Config system: frozen dataclasses + registry + CLI resolution — a copy
of ``repro/config.py`` (plain data, no JAX), kept here so the port
imports nothing of the JAX package.

One :class:`ModelConfig` per assigned architecture lives in
``repro_torch/configs/<id>.py``; shapes are global (the assignment pairs
every LM arch with the same four shapes). ``--arch <id>`` resolves through
:func:`get_config`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "MeshConfig", "SHAPES",
           "register", "get_config", "list_configs", "reduced_config"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | encdec | ssm | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"              # mlp activation (silu => SwiGLU)

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # every k-th layer uses MoE FFN
    capacity_factor: float = 1.25

    # -- hybrid (jamba): attention every `attn_every`, else mamba ----------
    attn_every: int = 0            # 0 -> all layers attention
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # -- ssm (xlstm) --------------------------------------------------------
    xlstm_pattern: Tuple[str, ...] = ()   # e.g. ("m","m","s") repeating
    xlstm_chunk: int = 64

    # -- encoder-decoder -----------------------------------------------------
    enc_layers: int = 0            # >0 => enc-dec; n_layers = decoder layers
    frontend: str = ""             # "" | "audio" | "vision" (stub embeddings)
    n_frontend_tokens: int = 0     # stub embedding count per example

    # -- training policy -----------------------------------------------------
    param_dtype: str = "float32"   # giant MoE archs use bfloat16 (+SR note)
    remat: str = "block"           # "none" | "block" (remat each scanned block)
    layer_group: int = 1           # scan over groups of this many layers

    # paper-technique integration: cross-pod gradient reduction scheme
    grad_comm: str = "hierarchical-shifted"   # or "flat-psum"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/logits can
        always shard over the model axis (padding logits are masked to
        -inf before the loss/sampling)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def supports_shape(self, shape: "ShapeConfig") -> Tuple[bool, str]:
        """Assignment rules: long_500k only for sub-quadratic archs."""
        if shape.name == "long_500k" and not self.is_subquadratic:
            return False, ("pure full-attention arch: 500k-context decode "
                           "skipped per assignment (needs sub-quadratic "
                           "attention); see DESIGN.md §5")
        return True, ""


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def ndev(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers everything)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """CPU-smoke-test reduction: tiny widths, few layers/experts, same
    family/topology so every code path is exercised."""
    base = dict(
        n_layers=max(2, cfg.layer_group if cfg.layer_group > 1 else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        head_dim=16,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        enc_layers=2 if cfg.enc_layers else 0,
        n_frontend_tokens=8 if cfg.frontend else 0,
        param_dtype="float32",
        layer_group=1,
    )
    if cfg.attn_every:
        base["n_layers"] = cfg.attn_every  # one full hybrid period
        base["layer_group"] = cfg.attn_every
    if cfg.xlstm_pattern:
        base["n_layers"] = len(cfg.xlstm_pattern)
        base["layer_group"] = len(cfg.xlstm_pattern)
    if cfg.moe_every > 1:
        base["n_layers"] = max(base["n_layers"], 2 * cfg.moe_every)
        base["layer_group"] = base.get("layer_group", 1)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
