"""olmo-1b [dense]: 16L, d_model=2048, 16H (GQA kv=16 == MHA), d_ff=8192,
vocab=50304, non-parametric LayerNorm, tied embeddings [arXiv:2402.00838].

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    attention="gqa",
    mlp="swiglu",
    norm="nonparametric_ln",
    tie_embeddings=True,
    rope_theta=10_000.0,
))
