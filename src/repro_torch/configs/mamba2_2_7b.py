"""mamba2-2.7b [ssm]: 64L, d_model=2560, attention-free, SSD state=128,
vocab=50280 [arXiv:2405.21060].  80 SSM heads of 64 (d_inner 5120), no
FFN.

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,              # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                   # no FFN: mamba2 block only
    vocab_size=50280,
    attention="none",
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,
        expand=2,
        conv_width=4,
        chunk_size=256,
    ),
    norm="rmsnorm",
))
