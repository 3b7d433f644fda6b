"""hymba-1.5b [hybrid]: 32L, d_model=1600, 25 attn heads (GQA kv=5) fused in
PARALLEL with SSM heads (state=16) in every block; SWA in all but 3 global
layers; d_ff=5504, vocab=32001 [arXiv:2411.13676].

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="hybrid",
    sliding_window=1024,
    global_attn_every=16,     # layers 0, 16, 31 -> 3 global layers
    ssm=SSMConfig(
        state_dim=16,
        head_dim=64,
        expand=2,
        conv_width=4,
        chunk_size=256,
    ),
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
))
