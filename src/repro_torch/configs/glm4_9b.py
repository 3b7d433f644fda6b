"""glm4-9b [dense]: 40L, d_model=4096, 32H (GQA kv=2), d_ff=13696,
vocab=151552, RoPE [hf:THUDM/glm-4-9b].

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    attention="gqa",
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
))
