"""qwen3-moe-30b-a3b [moe]: 48L, d_model=2048, 32H (GQA kv=4, head_dim=128),
128 experts top-8, expert d_ff=768, vocab=151936 [hf:Qwen/Qwen3-30B-A3B].

The published numbers, as the reference's config states them.
"""

from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,                # unused (all layers MoE); kept for completeness
    vocab_size=151936,
    attention="gqa",
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        d_ff_expert=768,
        num_shared_experts=0,
        first_k_dense=0,
        placement_slack_slots=2,
    ),
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
))
