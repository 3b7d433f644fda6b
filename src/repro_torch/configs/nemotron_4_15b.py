"""nemotron-4-15b [dense]: 32L, d_model=6144, 48H (GQA kv=8), d_ff=24576,
vocab=256000, squared-ReLU MLP (non-gated) [arXiv:2402.16819].

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    attention="gqa",
    mlp="squared_relu",
    norm="layernorm",
    rope_theta=10_000.0,
))
