"""h2o-danube-1.8b [dense]: 24L, d_model=2560, 32H (GQA kv=8), d_ff=6912,
vocab=32000; llama+mistral mix with sliding-window attention
[arXiv:2401.16818].  SWA makes long_500k decodable with a window KV cache.

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attention="gqa",
    mlp="swiglu",
    norm="rmsnorm",
    sliding_window=4096,
    rope_theta=10_000.0,
))
