"""Model configuration dataclasses and the architecture registry.

A copy of the JAX package's ``configs/base.py`` as plain data (the port
keeps its own so that it imports nothing of the reference).  One file per
ported architecture lives next to this module; each exposes
``CONFIG = ModelConfig(...)`` with the published numbers and registers
itself.  ``MLAConfig`` holds the latent ranks of multi-head latent
attention (deepseek-v3-671b), which ``models/attention.py`` serves in its
absorbed form.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = [
    "MoEConfig", "MLAConfig", "SSMConfig", "ModelConfig", "ShapeConfig",
    "SHAPE_GRID", "register", "get_config", "list_configs", "reduce_config",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 0
    router_noise: float = 0.0
    capacity_factor: float = 1.25
    placement_slack_slots: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    # number of SSM heads = d_model * expand // head_dim unless overridden
    num_heads: int | None = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None            # default d_model // num_heads
    attention: Literal["gqa", "mla", "none", "hybrid"] = "gqa"
    mlp: Literal["swiglu", "squared_relu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm", "nonparametric_ln"] = "rmsnorm"
    rope_theta: float = 10_000.0
    sliding_window: int | None = None      # SWA width where used
    global_attn_every: int | None = None   # hybrid SWA/global layer pattern
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder_layers: int = 0
    frontend: Literal[None, "audio_frames", "vision_patches"] = None
    frontend_len: int = 0
    mtp_depth: int = 0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context without a dense KV cache?"""
        if self.attention == "none":
            return True
        if self.attention == "hybrid":
            return True  # SSM state + (mostly) windowed attention
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), the reference's
        formula."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d
        if not self.tie_embeddings:
            total += v * d

        def attn_params():
            if self.attention == "mla" and self.mla:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_hd
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                p += self.num_heads * m.v_head_dim * d
                return p
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def mlp_params(ff):
            mult = 3 if self.mlp == "swiglu" else 2
            return mult * d * ff

        def ssm_params():
            s = self.ssm
            d_in = d * s.expand
            nh = s.num_heads or d_in // s.head_dim
            p = d * (2 * d_in + 2 * s.state_dim + nh)
            p += (d_in + 2 * s.state_dim) * s.conv_width
            p += nh * 2
            p += d_in * d
            return p

        blocks = 0
        for layer in range(self.num_layers):
            if self.attention == "none":
                blocks += ssm_params()
            elif self.attention == "hybrid":
                blocks += attn_params() + ssm_params() + mlp_params(self.d_ff)
            else:
                blocks += attn_params()
                if self.moe and layer >= self.moe.first_k_dense:
                    m = self.moe
                    blocks += (m.num_experts + m.num_shared_experts) * \
                        mlp_params(m.d_ff_expert)
                    blocks += d * m.num_experts
                else:
                    blocks += mlp_params(self.d_ff)
        total += blocks
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            xattn = self.num_layers * attn_params()
            total += enc + xattn
        return int(total)


_REGISTRY: dict[str, ModelConfig] = {}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_GRID = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_loaded = False


def _load_all():
    """Import every sibling config module once, so each registers itself
    (an arch module imported on its own beforehand registers only its
    own config)."""
    global _loaded
    if _loaded:
        return
    import importlib
    import pkgutil

    from .. import configs as pkg

    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name != "base":
            importlib.import_module(f"{pkg.__name__}.{m.name}")
    _loaded = True


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized variant of an architecture: same family and wiring,
    tiny dims (the reference's reduction, field for field)."""
    small = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 4) * 4
                         // max(cfg.num_heads, 4)) or 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend else 0,
        name=cfg.name + "-smoke",
    )
    if small["num_heads"] % small["num_kv_heads"]:
        small["num_kv_heads"] = 1
    if cfg.moe:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1), capacity_factor=8.0,
        )
    if cfg.mla:
        small["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.ssm:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=32, num_heads=None,
        )
    if cfg.sliding_window:
        small["sliding_window"] = 64
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
