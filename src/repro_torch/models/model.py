"""Full model assembly: init, forward, train loss, prefill, decode.

The reference (``models/model.py``) stores parameters layer-stacked and
scans over them; the port keeps a Python list of per-layer dicts and loops
(PyTorch runs eagerly, so there is nothing to trace).  Each layer carries
its own cache (hymba's global layers and window layers may differ in
shape), as the reference's unrolled serving path does; for the dense and
pure-SSM families the reference scans over layer-stacked caches instead,
which hold the same numbers slice by slice.  A tied-embedding model (olmo) has no
``unembed`` group and unembeds with the embedding table.  An MoE model's
first ``first_k_dense`` layers are dense (the reference's
``dense_blocks`` group, which runs before ``blocks``); every MoE entry
point takes ``moe_dispatch`` (None: the identity dispatch).  A config
with ``mtp_depth`` (deepseek-v3) also gets the reference's ``mtp`` group
(``proj``, one dense block, ``norm``), which serving never reads.

The frontends are the reference's stubs: the model takes precomputed
embeddings ``frontend_embeds`` (B, F, d_model) and projects them by
``frontend_proj`` as JAX promotes the product (f32 frames times a bf16
weight in f32), then casts them to the model dtype.  A VLM
(``frontend="vision_patches"``, internvl2) puts the projected patches in
place of the first F token embeddings.  An encoder-decoder
(``encoder_layers`` > 0, seamless-m4t) runs the projected frames through
its non-causal encoder stack (``enc_blocks``, ``enc_final_norm``); each
decoder layer cross-attends to the encoder states, its k / v computed
from them at every call, as the reference does.

Cache layout: {"layers": [block cache per layer], "encoder": None, or
(enc_hidden, enc_pos) for an encoder-decoder: prefill runs the encoder
once and decode reuses its states}.

Training: ``train_loss`` is the reference's (``models/model.py``
``train_loss``): the masked-mean cross entropy of the cache-free forward
with remat, plus ``0.01 lb_loss + 1e-4 z_loss`` summed over an MoE
model's layers and, with an ``mtp`` group, ``0.3`` times the
multi-token-prediction loss (one dense block predicts token t + 2 from the
final-normed hidden state at t and the embedding of token t + 1).
``remat=True`` runs each decoder block under ``torch.utils.checkpoint``
(non-reentrant), the counterpart of the reference's per-layer
``jax.checkpoint``: the block's activations are recomputed in the
backward, which changes no number.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as device_mod
from . import blocks
from .layers import (apply_norm, dense_init, embed_lookup, init_embed,
                     init_norm, unembed)

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache",
           "layer_windows", "softmax_xent", "train_loss"]


def _torch_dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def layer_windows(cfg) -> list:
    """Per-layer attention window (None = full attention)."""
    out = []
    for i in range(cfg.num_layers):
        if cfg.attention == "hybrid" and cfg.global_attn_every:
            is_global = (i % cfg.global_attn_every == 0) or \
                (i == cfg.num_layers - 1)
            out.append(None if is_global else cfg.sliding_window)
        else:
            out.append(cfg.sliding_window)
    return out


def init_params(cfg, seed: int = 0, device=None, moe_dispatch=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default "cuda"; raises without CUDA unless "cpu" is given); MoE
    expert weights are stored by the slots of ``moe_dispatch``."""
    dev = device_mod.resolve(device)
    dtype = _torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: dict = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, dev)
    p["final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    cross = cfg.encoder_layers > 0
    p["blocks"] = [blocks.init_block(gen, cfg, dtype, dev, layer_idx=i,
                                     moe_dispatch=moe_dispatch,
                                     cross_attention=cross)
                   for i in range(cfg.num_layers)]
    if cfg.encoder_layers:
        p["enc_blocks"] = [blocks.init_block(gen, cfg, dtype, dev)
                           for _ in range(cfg.encoder_layers)]
        p["enc_final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    if cfg.frontend:
        p["frontend_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                        dtype, device=dev)
    if cfg.mtp_depth:
        # the reference's multi-token-prediction group; serving never reads
        # it (its loss is training's, ROADMAP Queue 1 item 9.5)
        p["mtp"] = {
            "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype,
                               device=dev),
            "block": blocks.init_block(gen, cfg, dtype, dev, layer_idx=0,
                                       force_dense=True),
            "norm": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        }
    return p


def _param_device(params) -> torch.device:
    return params["embed"]["table"].device


def init_cache(cfg, batch: int, max_len: int, *, window_only: bool = False,
               device=None):
    """window_only=True sizes window-layer caches at the window width (ring
    buffers that one-token decode fills from empty) instead of ``max_len``.
    A pure-SSM model (mamba2) has no KV slots: its caches hold only the
    conv window and the SSD state, so ``max_len`` sizes nothing."""
    dev = device_mod.resolve(device)
    dtype = _torch_dtype(cfg)
    layers = [
        blocks.init_block_cache(
            cfg, batch, max_len, dtype,
            window=(w if (window_only and w) else None), device=dev)
        for w in layer_windows(cfg)
    ]
    return {"layers": layers, "encoder": None}


def _project_frontend(params, frontend_embeds, dtype) -> torch.Tensor:
    """(B, F, d) embeddings through ``frontend_proj`` in the dtype that JAX
    promotes the two to (f32 for f32 frames and a bf16 weight), then cast
    to ``dtype``."""
    w = params["frontend_proj"]
    pt = torch.promote_types(frontend_embeds.dtype, w.dtype)
    return (frontend_embeds.to(pt) @ w.to(pt)).to(dtype)


def _embed_inputs(cfg, params, tokens, frontend_embeds):
    """Token embeddings; a VLM's projected patches replace the first F
    positions.  Raises ValueError when the prompt is shorter than F."""
    patches = cfg.frontend == "vision_patches" and frontend_embeds is not None
    f = frontend_embeds.shape[1] if patches else 0
    if tokens.shape[1] < f:
        raise ValueError(
            f"a prompt of {tokens.shape[1]} tokens cannot hold the {f} "
            "visual tokens that replace its first positions")
    x = embed_lookup(params["embed"], tokens)
    if patches:
        vis = _project_frontend(params, frontend_embeds, x.dtype)
        x = torch.cat([vis, x[:, f:]], dim=1)
    return x


def _run_encoder(cfg, params, frontend_embeds):
    """The audio stub's frame embeddings -> the non-causal encoder stack
    -> ``enc_final_norm``.  Returns (enc_h (B, F, d), enc_pos (B, F))."""
    x = _project_frontend(params, frontend_embeds, _torch_dtype(cfg))
    b, f = x.shape[:2]
    pos = torch.arange(f, dtype=torch.int32,
                       device=x.device).expand(b, f).contiguous()
    for layer_params in params["enc_blocks"]:
        x, _, _ = blocks.apply_block(layer_params, cfg, x, pos, causal=False)
    return apply_norm(cfg.norm, params["enc_final_norm"], x), pos


def _cross_kv_from(cfg, layer_params, enc_states):
    """A decoder layer's cross-attention k / v from the encoder states."""
    enc_h, enc_pos = enc_states
    b, f, _ = enc_h.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cross = layer_params["cross"]
    return ((enc_h @ cross["wk"]).reshape(b, f, kv, hd),
            (enc_h @ cross["wv"]).reshape(b, f, kv, hd), enc_pos)


def _hidden(cfg, params, tokens, positions, cache, moe_dispatch,
            frontend_embeds=None, remat=False):
    """Final-normed hidden states (B, S, d), the updated cache and the MoE
    aux terms summed over the layers (0-d device tensors; empty without
    MoE layers).  ``remat`` (cache-free only) checkpoints each decoder
    block."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    enc_states = None
    if cfg.encoder_layers:
        if cache is not None and cache.get("encoder") is not None:
            enc_states = cache["encoder"]
        elif frontend_embeds is not None:
            enc_states = _run_encoder(cfg, params, frontend_embeds)
        else:
            raise ValueError("encoder-decoder model needs frontend_embeds "
                             "or cached encoder states")
        x = embed_lookup(params["embed"], tokens)
    else:
        x = _embed_inputs(cfg, params, tokens, frontend_embeds)
    new_layers, aux = [], {}
    for i, w in enumerate(layer_windows(cfg)):
        lp = params["blocks"][i]
        lc = cache["layers"][i] if cache is not None else None
        cross_kv = (_cross_kv_from(cfg, lp, enc_states)
                    if enc_states is not None and "cross" in lp else None)
        if remat and cache is None:
            x, nc, a = checkpoint(
                blocks.apply_block, lp, cfg, x, positions, window=w,
                cross_kv=cross_kv, moe_dispatch=moe_dispatch,
                use_reentrant=False)
        else:
            x, nc, a = blocks.apply_block(lp, cfg, x, positions, window=w,
                                          cache=lc, cross_kv=cross_kv,
                                          moe_dispatch=moe_dispatch)
        new_layers.append(nc)
        for key, v in a.items():
            aux[key] = aux[key] + v if key in aux else v
    h = apply_norm(cfg.norm, params["final_norm"], x)
    new_cache = ({"layers": new_layers, "encoder": enc_states}
                 if cache is not None else None)
    return h, new_cache, aux


def _head(params):
    return params["unembed"] if "unembed" in params else params["embed"]


def forward(cfg, params, tokens, *, positions=None, frontend_embeds=None,
            cache=None, moe_dispatch=None, return_aux=False, remat=False):
    """Returns (logits fp32 (B, S, V), new_cache), and the summed MoE aux
    terms third with ``return_aux``.  ``frontend_embeds`` (B, F, d): a
    VLM's patches or an encoder-decoder's frames (which it needs unless
    ``cache`` holds the encoder states).  ``remat`` checkpoints each
    decoder block of a cache-free forward."""
    h, new_cache, aux = _hidden(cfg, params, tokens, positions, cache,
                                moe_dispatch, frontend_embeds, remat)
    logits = unembed(_head(params), h)
    return (logits, new_cache, aux) if return_aux else (logits, new_cache)


def softmax_xent(logits, targets, mask=None):
    """Mean cross entropy of fp32 logits (B, S, V) at int targets (B, S);
    with a mask (B, S), the mean over the masked positions (at least one).
    The reference picks the target's logit by a one-hot product; a gather
    picks the same value."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - picked
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def train_loss(cfg, params, batch, *, moe_dispatch=None):
    """(loss, metrics) of ``batch``: tokens (B, S), targets (B, S),
    optional frontend (B, F, d) and mask (B, S).  Metrics are 0-d tensors:
    ``xent``, ``lb_loss`` / ``z_loss`` for an MoE model, ``mtp_loss`` with
    an ``mtp`` group, and ``loss``."""
    h, _, aux = _hidden(cfg, params, batch["tokens"], None, None,
                        moe_dispatch, batch.get("frontend"), remat=True)
    head = _head(params)
    loss = softmax_xent(unembed(head, h), batch["targets"],
                        batch.get("mask"))
    metrics = {"xent": loss}
    if cfg.moe:
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        lb, z = aux.get("lb_loss", zero), aux.get("z_loss", zero)
        loss = loss + 0.01 * lb + 1e-4 * z
        metrics.update(lb_loss=lb, z_loss=z)
    if cfg.mtp_depth and "mtp" in params:
        mtp = params["mtp"]
        emb_next = embed_lookup(params["embed"], batch["targets"])
        mtp_in = torch.cat([h, emb_next.to(h.dtype)], dim=-1) @ mtp["proj"]
        b, s = mtp_in.shape[:2]
        pos = torch.arange(s, dtype=torch.int32,
                           device=mtp_in.device).expand(b, s)
        mh, _, _ = blocks.apply_block(mtp["block"], cfg, mtp_in, pos)
        mh = apply_norm(cfg.norm, mtp["norm"], mh)
        mtp_loss = softmax_xent(unembed(head, mh[:, :-1]),
                                batch["targets"][:, 1:])
        loss = loss + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def prefill(cfg, params, batch, *, max_len=None, moe_dispatch=None,
            return_aux=False):
    """Run the whole prompt ``batch["tokens"]`` (B, S), building the serving
    cache with ``max_len`` slots in every layer.  Returns (last-token logits
    (B, V), cache).  Only the last position is unembedded: the reference
    computes every position's logits and keeps the last, which is the same
    numbers.  ``return_aux`` adds the MoE aux terms summed over the layers
    (``drop_frac`` among them) third.  ``batch["frontend"]`` (B, F, d):
    a VLM's patches, or an encoder-decoder's frames, whose encoder states
    go into ``cache["encoder"]`` before the decoder runs."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    frontend = batch.get("frontend")
    cache = init_cache(cfg, b, max_len or s, device=_param_device(params))
    if cfg.encoder_layers and frontend is not None:
        cache["encoder"] = _run_encoder(cfg, params, frontend)
    h, cache, aux = _hidden(cfg, params, tokens, None, cache, moe_dispatch,
                            frontend)
    logits = unembed(_head(params), h[:, -1])
    return (logits, cache, aux) if return_aux else (logits, cache)


def decode_step(cfg, params, cache, tokens, positions, *, moe_dispatch=None):
    """One serving step: tokens (B, 1) at positions (B, 1).  Returns
    (logits (B, V), cache); the cache is updated in place (an
    encoder-decoder's encoder states are read from it, never recomputed)."""
    h, new_cache, _ = _hidden(cfg, params, tokens, positions, cache,
                              moe_dispatch)
    return unembed(_head(params), h[:, -1]), new_cache
