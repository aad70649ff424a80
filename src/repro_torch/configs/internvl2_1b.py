"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655, InternViT + InternLM2 backbone [arXiv:2404.16821; hf].
The InternViT-300M vision tower is a STUB per assignment: input_specs()
provides 256 precomputed patch embeddings per image, prepended to the
text sequence."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, head_dim=64,
    rope=True, rope_theta=1e6, frontend="vision", n_frontend_tokens=256,
    tie_embeddings=True,
))
