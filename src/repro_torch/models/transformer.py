"""Decoder-only LM transformer (PyTorch), dense family, serving entries.

Counterpart of ``repro.models.transformer``.  The JAX package stacks the
layers and runs ``lax.scan``; here ``params["layers"]`` is a list of
per-layer dicts and the layers run in a Python loop (eager PyTorch has no
compile-time cost to bound).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.fqt import QuantConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (QCtx, attn_apply, attn_params,
                                       dense_init, embed_init, make_kv_cache,
                                       mlp_apply, mlp_params, rmsnorm)


def _check_family(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with the breadth families "
            f"(ROADMAP Queue 1); slice 1 serves the dense family")


def init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
         device=None):
    """Parameter layout of ``repro.models.transformer.init`` with per-layer
    dicts.  Values come from ``gen`` (torch's normal stream, not
    ``jax.random``'s: a declared divergence)."""
    _check_family(cfg)

    def layer():
        return {
            "attn": attn_params(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, dtype,
                                qk_norm=cfg.use_qk_norm, device=device),
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                              device=device),
        }

    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device=device),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype, device=device)
    return params


def _layer_apply(cfg: ModelConfig, lp, x, *, cache, qcfg: QuantConfig):
    ctx = QCtx(qcfg)
    h, cache = attn_apply(
        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), ctx,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope_theta=cfg.rope_theta, window=cfg.sliding_window, cache=cache,
        norm_eps=cfg.norm_eps)
    x = x + h
    y = mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), ctx,
                  cfg.act)
    return x + y, cache


def apply_layers(params, cfg: ModelConfig, qcfg: QuantConfig, x, *,
                 caches=None):
    """Run the layers in order; caches (one per layer) update in place."""
    for i, lp in enumerate(params["layers"]):
        x, _ = _layer_apply(cfg, lp, x, qcfg=qcfg,
                            cache=None if caches is None else caches[i])
    return x, caches


def _logits(params, cfg: ModelConfig, qcfg: QuantConfig, x):
    head_cfg = qcfg if cfg.quantize_lm_head else QuantConfig()
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = QCtx(head_cfg).dense(x, w)
    if cfg.padded_vocab != cfg.vocab_size:        # mask padded ids
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_format: str = "bf16",
               device=None) -> List:
    buf = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)
    return [make_kv_cache(batch, buf, cfg.n_kv_heads, cfg.hd, dtype,
                          kv_format, device=device)
            for _ in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches):
    """Run the prompt through the model, filling the (empty) caches;
    returns (last-token logits (B, 1, V), caches)."""
    x = params["embed"][tokens]
    x, caches = apply_layers(params, cfg, qcfg, x, caches=caches)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x), caches


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches):
    """One new token per sequence.  tokens: (B, 1).  Returns (logits,
    caches)."""
    x = params["embed"][tokens]
    x, caches = apply_layers(params, cfg, qcfg, x, caches=caches)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x), caches
