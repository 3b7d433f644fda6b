"""Blocks: init + apply for one layer.

Ported families (the reference's ``models/blocks.py``):

* dense (glm4, olmo, h2o-danube, nemotron): pre-norm attention ->
  residual -> pre-norm MLP (SwiGLU or non-gated) -> residual;
* MoE (qwen3-moe, deepseek-v3): the same with the MLP replaced by the MoE
  block (``models/moe.py``) from layer ``first_k_dense`` on; the first
  ``first_k_dense`` layers keep a dense MLP at ``d_ff``.  The attention of
  both is GQA, or MLA where ``cfg.attention == "mla"`` (deepseek-v3);
* hybrid (hymba): pre-norm, then GQA attention AND mamba2 in PARALLEL on
  the same input, each path RMS-normalized, averaged, added to the
  residual, then the pre-norm SwiGLU FFN;
* pure SSM (mamba2): pre-norm mamba2 -> residual, no FFN;
* encoder-decoder (seamless-m4t): encoder layers are dense blocks run
  non-causal; a decoder layer adds pre-norm cross-attention over the
  encoder states (``ln_cross``, ``cross``) between self-attention and the
  MLP.  The VLM (internvl2) runs dense blocks; its frontend is
  ``models/model.py``'s.
"""

from __future__ import annotations

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

__all__ = ["init_block", "apply_block", "init_block_cache", "block_kind"]


def block_kind(cfg) -> str:
    """"hybrid", "ssm", "moe" or "dense" (the last two with GQA or MLA;
    the encoder-decoder's and the VLM's blocks are dense)."""
    if cfg.moe:
        return "moe"
    if cfg.attention == "hybrid":
        return "hybrid"
    if cfg.attention == "none":
        return "ssm"
    return "dense"


def _is_moe_layer(cfg, layer_idx: int) -> bool:
    return cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense


def init_block(gen, cfg, dtype, device=None, *, layer_idx: int = 0,
               force_dense: bool = False, moe_dispatch=None,
               cross_attention: bool = False) -> dict:
    """One layer's parameters.  In an MoE config, layer ``layer_idx`` gets
    the MoE block (slot-major under ``moe_dispatch``) unless it is one of
    the first ``first_k_dense`` or ``force_dense`` is set; then a dense MLP
    at ``cfg.d_ff``.  ``cross_attention`` adds an encoder-decoder's
    decoder groups ``ln_cross`` and ``cross``."""
    kind = block_kind(cfg)
    d = cfg.d_model
    p = {}
    if kind != "ssm":
        p["ln_attn"] = init_norm(cfg.norm, d, dtype, device)
        init_attn = attn.init_mla if cfg.attention == "mla" else attn.init_gqa
        p["attn"] = init_attn(gen, cfg, dtype, device)
    if kind in ("hybrid", "ssm"):
        # the reference creates ln_ssm for every SSM-carrying block; only
        # the pure-SSM branch reads it
        p["ln_ssm"] = init_norm(cfg.norm, d, dtype, device)
        p["ssm"] = ssm_mod.init_mamba2(gen, cfg, dtype, device)
    if kind == "hybrid":
        p["out_norm_attn"] = init_norm("rmsnorm", d, dtype, device)
        p["out_norm_ssm"] = init_norm("rmsnorm", d, dtype, device)
    if cross_attention:
        p["ln_cross"] = init_norm(cfg.norm, d, dtype, device)
        p["cross"] = attn.init_gqa(gen, cfg, dtype, device)
    if kind != "ssm":
        p["ln_mlp"] = init_norm(cfg.norm, d, dtype, device)
        if _is_moe_layer(cfg, layer_idx) and not force_dense:
            p["moe"] = moe_mod.init_moe(gen, cfg, dtype, moe_dispatch,
                                        device)
        else:
            p["mlp"] = init_mlp(gen, cfg.mlp, d, cfg.d_ff, dtype, device)
    return p


def apply_block(params: dict, cfg, x, positions, *, causal=True,
                window=None, cache: dict | None = None, cross_kv=None,
                moe_dispatch=None):
    """x (B, S, d), positions (B, S).  ``causal=False`` runs an encoder
    layer; ``cross_kv`` (the encoder's k, v and positions) runs a
    decoder layer's cross-attention.  Returns (y, new_cache, aux): aux is
    the MoE block's ``lb_loss``, ``z_loss`` and ``drop_frac`` in a layer
    that has one, else empty."""
    kind = block_kind(cfg)
    aux = {}
    if kind == "ssm":
        h = apply_norm(cfg.norm, params["ln_ssm"], x)
        s_out, c_ssm = ssm_mod.apply_mamba2(
            params["ssm"], cfg, h, cache=cache["ssm"] if cache else None)
        return (x + s_out, (dict(ssm=c_ssm) if cache is not None else None),
                aux)
    h = apply_norm(cfg.norm, params["ln_attn"], x)
    kv_cache = cache["attn"] if cache else None
    if cfg.attention == "mla":
        a_out, c_attn = attn.mla_attention(params["attn"], cfg, h, positions,
                                           kv_cache=kv_cache)
    else:
        a_out, c_attn = attn.gqa_attention(params["attn"], cfg, h,
                                           positions, window=window,
                                           causal=causal, kv_cache=kv_cache)
    new_cache = dict(attn=c_attn) if cache is not None else None
    if kind == "hybrid":
        s_out, c_ssm = ssm_mod.apply_mamba2(
            params["ssm"], cfg, h, cache=cache["ssm"] if cache else None)
        a_n = apply_norm("rmsnorm", params["out_norm_attn"], a_out)
        s_n = apply_norm("rmsnorm", params["out_norm_ssm"], s_out)
        x = x + 0.5 * (a_n + s_n)
        if new_cache is not None:
            new_cache["ssm"] = c_ssm
    else:
        x = x + a_out
    if cross_kv is not None:
        h = apply_norm(cfg.norm, params["ln_cross"], x)
        c_out, _ = attn.gqa_attention(params["cross"], cfg, h, positions,
                                      cross_kv=cross_kv)
        x = x + c_out
    h = apply_norm(cfg.norm, params["ln_mlp"], x)
    if "moe" in params:
        m_out, aux = moe_mod.apply_moe(params["moe"], cfg, h, moe_dispatch)
    else:
        m_out = apply_mlp(cfg.mlp, params["mlp"], h)
    return x + m_out, new_cache, aux


def init_block_cache(cfg, batch: int, max_len: int, dtype, *, window=None,
                     device=None) -> dict:
    kind = block_kind(cfg)
    c = {}
    if cfg.attention == "mla":
        c["attn"] = attn.init_mla_cache(cfg, batch, max_len, dtype,
                                        device=device)
    elif kind != "ssm":
        c["attn"] = attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                        window=window, device=device)
    if kind in ("hybrid", "ssm"):
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, dtype, device=device)
    return c
