"""deepseek-v3-671b [moe]: 61L, d_model=7168, 128H, MLA, MoE 256 routed
(top-8) + 1 shared expert, expert d_ff=2048, first 3 layers dense
(d_ff=18432), vocab=129280, 1 MTP head [arXiv:2412.19437].

The published numbers, as the reference's config states them.  The
attention is multi-head latent attention (MLA), served in its absorbed
form (``models/attention.py``); the MTP group is built but serving never
reads it.
"""

from .base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: KV heads == heads post-decompression
    head_dim=128,
    d_ff=18432,                # dense layers (first_k_dense=3)
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_k_dense=3,
        placement_slack_slots=2,
    ),
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    mtp_depth=1,
))
