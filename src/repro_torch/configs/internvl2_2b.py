"""internvl2-2b [vlm]: InternViT-300M frontend (stub) + InternLM2-1.8B LM.

24L, d_model=2048, 16H (GQA kv=8), d_ff=8192, vocab=92553
[arXiv:2404.16821; hf].

The published numbers, as the reference's config states them.  The vision
tower is a stub there and here: the model takes precomputed patch
embeddings (``frontend_embeds``, (B, frontend_len, d_model)), projects them
by ``frontend_proj`` and puts them in place of the first ``frontend_len``
token embeddings of the prompt.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    attention="gqa",
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    frontend_len=256,         # stub: 256 visual tokens (one 448^2 tile)
))
