"""Assigned architecture configs (importing this package registers all)."""
from . import (internlm2_20b, starcoder2_15b, granite_3_2b, qwen3_32b,
               grok1_314b, dbrx_132b, seamless_m4t_large_v2, xlstm_125m,
               internvl2_1b, jamba_1_5_large_398b)

ALL_ARCHS = (
    "internlm2-20b", "starcoder2-15b", "granite-3-2b", "qwen3-32b",
    "grok-1-314b", "dbrx-132b", "seamless-m4t-large-v2", "xlstm-125m",
    "internvl2-1b", "jamba-1.5-large-398b",
)
