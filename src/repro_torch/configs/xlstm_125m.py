"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304, sLSTM +
mLSTM blocks [arXiv:2405.04517; unverified]. Pattern m,m,s repeating
(mLSTM-dominant with periodic sLSTM, xLSTM[7:1]-style mix); block-internal
projections replace the FFN (d_ff=0)."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
    rope=False, xlstm_pattern=("m", "m", "s"), layer_group=3,
    tie_embeddings=True,
))
