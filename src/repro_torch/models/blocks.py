"""Blocks: init + apply for one layer.

Ported family: hybrid (hymba) — pre-norm, then GQA attention AND mamba2
in PARALLEL on the same input, each path RMS-normalized, averaged, added
to the residual, then the pre-norm SwiGLU FFN (the reference's
``models/blocks.py``).  The other families raise NotImplementedError.
"""

from __future__ import annotations

from . import attention as attn
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

__all__ = ["init_block", "apply_block", "init_block_cache"]


def _require_hybrid(cfg) -> None:
    if cfg.attention == "hybrid" and not cfg.moe and not cfg.encoder_layers:
        return
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}, attention={cfg.attention!r}): only the "
        "hybrid GQA+mamba2 block is ported; dense-GQA, pure-SSM, MoE, MLA "
        "and encoder-decoder blocks wait in ROADMAP Queue 1 item 12")


def init_block(gen, cfg, dtype, device=None) -> dict:
    _require_hybrid(cfg)
    d = cfg.d_model
    return {
        "ln_attn": init_norm(cfg.norm, d, dtype, device),
        "attn": attn.init_gqa(gen, cfg, dtype, device),
        # the reference creates ln_ssm for every SSM-carrying block; the
        # hybrid branch does not read it
        "ln_ssm": init_norm(cfg.norm, d, dtype, device),
        "ssm": ssm_mod.init_mamba2(gen, cfg, dtype, device),
        "out_norm_attn": init_norm("rmsnorm", d, dtype, device),
        "out_norm_ssm": init_norm("rmsnorm", d, dtype, device),
        "ln_mlp": init_norm(cfg.norm, d, dtype, device),
        "mlp": init_mlp(gen, cfg.mlp, d, cfg.d_ff, dtype, device),
    }


def apply_block(params: dict, cfg, x, positions, *, window=None,
                cache: dict | None = None):
    """x (B, S, d), positions (B, S).  Returns (y, new_cache)."""
    _require_hybrid(cfg)
    h = apply_norm(cfg.norm, params["ln_attn"], x)
    a_out, c_attn = attn.gqa_attention(
        params["attn"], cfg, h, positions, window=window,
        kv_cache=cache["attn"] if cache else None)
    s_out, c_ssm = ssm_mod.apply_mamba2(
        params["ssm"], cfg, h, cache=cache["ssm"] if cache else None)
    a_n = apply_norm("rmsnorm", params["out_norm_attn"], a_out)
    s_n = apply_norm("rmsnorm", params["out_norm_ssm"], s_out)
    x = x + 0.5 * (a_n + s_n)
    h = apply_norm(cfg.norm, params["ln_mlp"], x)
    x = x + apply_mlp(cfg.mlp, params["mlp"], h)
    new_cache = dict(attn=c_attn, ssm=c_ssm) if cache is not None else None
    return x, new_cache


def init_block_cache(cfg, batch: int, max_len: int, dtype, *, window=None,
                     device=None) -> dict:
    _require_hybrid(cfg)
    return {
        "attn": attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                    window=window, device=device),
        "ssm": ssm_mod.init_ssm_cache(cfg, batch, dtype, device=device),
    }
