"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887; hf]. Period-8 layer groups (1 attention + 7 Mamba),
MoE FFN on every other layer. bf16 params+opt states to fit 16 GB chips."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, layer_group=8,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope=False, param_dtype="bfloat16",
))
