"""seamless-m4t-large-v2 [audio] — enc-dec, 24L each side, d_model=1024
16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]. The speech
frontend (w2v-BERT conformer feature extractor) is a STUB per assignment:
input_specs() provides precomputed frame embeddings."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    rope=False, frontend="audio", n_frontend_tokens=0,  # = seq_len frames
    act="gelu",
))
