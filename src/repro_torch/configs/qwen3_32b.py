"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]. Qwen3 uses an
explicit head_dim=128 (n_heads*head_dim != d_model)."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128,
    qk_norm=True, rope=True, rope_theta=1e6,
    # §Perf iter 7: bf16 params+opt states (f32 update math) — f32
    # storage put train_4k 2% over the 16 GB budget
    param_dtype="bfloat16",
))
