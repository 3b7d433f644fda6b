"""seamless-m4t-medium [audio]: encoder-decoder multimodal transformer.

12L, d_model=1024, 16H (GQA kv=16 == MHA), d_ff=4096, vocab=256206
[arXiv:2308.11596; hf].

The published numbers, as the reference's config states them.  The speech
frontend (w2v-BERT conformer) is a stub there and here: the model takes
precomputed frame embeddings (``frontend_embeds``, (B, frontend_len,
d_model)), projects them by ``frontend_proj`` and runs the non-causal
encoder over them; each decoder layer cross-attends to the encoder's
states.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,        # text/speech encoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    attention="gqa",
    mlp="gelu",               # m4t uses relu/gelu FFN, non-gated
    norm="layernorm",
    frontend="audio_frames",
    frontend_len=1024,        # stub: 1024 speech frames per utterance
))
