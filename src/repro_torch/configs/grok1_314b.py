"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1; unverified].
bf16 params+optimizer states (with stochastic-rounding note in DESIGN.md)
so the 314B total fits 256 chips at 16 GB."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, top_k=2, moe_every=1,
    rope=True, param_dtype="bfloat16",
))
