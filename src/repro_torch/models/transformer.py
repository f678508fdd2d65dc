"""Decoder-only LM transformer (PyTorch), dense family: training and
serving entries.

Counterpart of ``repro.models.transformer``.  The JAX package stacks the
layers and runs ``lax.scan``; here ``params["layers"]`` is a list of
per-layer dicts and the layers run in a Python loop (eager PyTorch has no
compile-time cost to bound).  Remat is ``torch.utils.checkpoint`` around
each layer body (the reference's ``nothing_saveable`` policy).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (TRASH_PAGE, PagedKVCache, QCtx,
                                       attn_apply, attn_params, dense_init,
                                       dyn_rows, embed_init, embed_lookup,
                                       make_kv_cache,
                                       mlp_apply, mlp_params, rmsnorm)

_SEED_STRIDE = 0x9E3779B9                   # per-layer SR seed stride


def _check_family(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with the breadth families "
            f"(ROADMAP Queue 1); the port runs the dense family")


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


def _layer_apply(cfg: ModelConfig, lp, x, seed: int, *, cache,
                 qcfg: QuantConfig, slot=None, plen=None, pfx=None,
                 write_mask=None):
    ctx = QCtx(qcfg, seed)
    h, cache = attn_apply(
        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), ctx,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope_theta=cfg.rope_theta, window=cfg.sliding_window,
        chunk=cfg.attn_chunk, cache=cache, slot=slot, plen=plen, pfx=pfx,
        write_mask=write_mask, norm_eps=cfg.norm_eps)
    x = x + h
    y = mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), ctx,
                  cfg.act)
    return x + y, cache


def apply_layers(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed=0, *,
                 caches=None, remat: bool = False, slot=None, plen=None,
                 pfx=None, write_mask=None):
    """Run the layers in order; caches (one per layer) update in place.

    ``remat``: each layer body runs under ``torch.utils.checkpoint`` and
    is recomputed in the backward; its QCtx is built inside the body, so
    the recompute draws the same SR streams.  ``slot``/``plen``/``pfx``/
    ``write_mask``: the paged-cache operands of ``layers.attn_apply``."""
    for i, lp in enumerate(params["layers"]):
        s = (int(seed) + i * _SEED_STRIDE) & M32
        cache = None if caches is None else caches[i]
        if remat and cache is None and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp, s=s: _layer_apply(cfg, lp, h, s, cache=None,
                                                   qcfg=qcfg)[0],
                x, use_reentrant=False)
        else:
            x, _ = _layer_apply(cfg, lp, x, s, qcfg=qcfg, cache=cache,
                                slot=slot, plen=plen, pfx=pfx,
                                write_mask=write_mask)
    return x, caches


def _logits(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed=0):
    head_cfg = qcfg if cfg.quantize_lm_head else QuantConfig()
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = QCtx(head_cfg, (int(seed) + 0xABCDEF) & M32).dense(x, w)
    if cfg.padded_vocab != cfg.vocab_size:        # mask padded ids
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return logits


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, *,
            seed: int = 0, remat: bool = True):
    """Full-sequence forward (training).  Returns (logits, aux_loss); the
    dense family has no auxiliary loss."""
    x = embed_lookup(params["embed"], tokens)
    x, _ = apply_layers(params, cfg, qcfg, x, seed, remat=remat)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, qcfg, x, seed), aux


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True):
    """Next-token cross-entropy.  batch: {"tokens": (B, S + 1) ints}.
    Returns (loss, {"nll", "aux"})."""
    tokens = batch["tokens"].long()
    logits, aux = forward(params, cfg, qcfg, tokens[:, :-1], seed=seed,
                          remat=remat)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    loss = torch.mean(nll)
    return loss + cfg.router_aux_weight * aux, {"nll": loss, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_format: str = "bf16",
               page_size: Optional[int] = None,
               total_pages: Optional[int] = None, device=None) -> List:
    """One cache per layer.  With ``page_size``: ``PagedKVCache``s over one
    pool per layer, the slot buffer rounded up to whole pages; every layer
    shares ONE page-table tensor, and each layer's lengths are a row of
    one (L, B) tensor."""
    buf = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)
    shared = [{} for _ in range(cfg.n_layers)]
    if page_size:
        buf = -(-buf // page_size) * page_size
        table = torch.full((batch, buf // page_size), TRASH_PAGE,
                           dtype=torch.int32, device=device)
        lengths = torch.zeros((cfg.n_layers, batch), dtype=torch.int32,
                              device=device)
        shared = [{"page_table": table, "lengths": lengths[i]}
                  for i in range(cfg.n_layers)]
    return [make_kv_cache(batch, buf, cfg.n_kv_heads, cfg.hd, dtype,
                          kv_format, page_size=page_size,
                          total_pages=total_pages, device=device, **sh)
            for sh in shared]


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches):
    """Run the prompt through the model, filling the (empty) caches;
    returns (last-token logits (B, 1, V), caches)."""
    x = params["embed"][tokens]
    x, caches = apply_layers(params, cfg, qcfg, x, caches=caches)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x), caches


def _token_at(x, i):
    """x[:, i:i + 1] for a host int or int32 device scalar ``i``."""
    return x.index_select(1, dyn_rows(i, 1, x.device))


def prefill_slot(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                 caches, slot, plen, *, seed=0):
    """Prefill ONE paged slot from a right-padded (1, Sp) prompt; ``plen``
    is the true prompt length.  ``slot`` and ``plen`` are host ints or
    int32 device scalars (dynamic operands).  Returns (logits at the last
    prompt token (1, V), caches)."""
    x = params["embed"][tokens]
    x, caches = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                             slot=slot, plen=plen)
    x = rmsnorm(_token_at(x, plen - 1), params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed)[:, 0], caches


def prefill_suffix(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                   caches, slot, plen, pfx, *, seed=0):
    """Prefill ONE paged slot from a right-padded (1, Sp) prompt SUFFIX
    whose first ``pfx`` tokens are already cached in the slot's pages;
    ``plen`` is the TOTAL prompt length.  The suffix rows are written at
    [pfx, plen) and the queries attend through the paged cache (K5).
    ``slot``, ``plen`` and ``pfx``: host ints or int32 device scalars.
    Returns (logits at the last prompt token (1, V), caches)."""
    x = params["embed"][tokens]
    x, caches = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                             slot=slot, plen=plen, pfx=pfx)
    x = rmsnorm(_token_at(x, plen - pfx - 1), params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed)[:, 0], caches


def prefill_chunk(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                  caches, slot, off, *, seed=0):
    """Write ONE full intermediate (1, C) chunk of a prompt into a paged
    slot at [off, off + C), attending through the paged cache (the suffix
    machinery: chunking cannot change any value).  ``slot`` and ``off``:
    host ints or int32 device scalars.  No logits.  Returns the caches."""
    x = params["embed"][tokens]
    C = x.shape[1]
    _, caches = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                             slot=slot, plen=off + C, pfx=off)
    return caches


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches,
                *, seed=0, write_mask=None):
    """One new token per sequence.  tokens: (B, 1).  Returns (logits,
    caches).  ``write_mask`` ((B,) bool, paged caches): slots mid-chunked-
    prefill write to the trash page and keep their length."""
    x = params["embed"][tokens]
    x, caches = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                             write_mask=write_mask)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed), caches


def verify_k(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches,
             *, seed=0, write_mask=None):
    """Teacher-forced verify over a speculative block: ``tokens`` (B, k),
    written at each slot's [len, len + k) and attended with per-slot causal
    positions, so row j's logits equal a sequential decode's.  Returns
    (logits (B, k, V), caches); the caller rolls rejected rows back with
    ``PagedKVCache.truncate_to``."""
    return decode_step(params, cfg, qcfg, tokens, caches, seed=seed,
                       write_mask=write_mask)


def draft_view(params, caches, draft_layers: int):
    """Self-draft view: the SAME weights and page pools truncated to the
    first ``draft_layers`` layers.  The reference drafts on a copy of the
    caches it then discards; here the draft shares the pools and page
    table, and each layer gets its own clone of ``lengths``, so drafting
    never advances the real lengths.  The rows it writes at [len, len +
    k - 1) lie past every real length and are overwritten by the verify
    pass before any read.  Returns (draft_params, draft_caches)."""
    dp = dict(params)
    dp["layers"] = params["layers"][:draft_layers]
    if caches is None:
        return dp, None
    dc = [dataclasses.replace(c, lengths=c.lengths.clone())
          if isinstance(c, PagedKVCache) else c
          for c in caches[:draft_layers]]
    return dp, dc
