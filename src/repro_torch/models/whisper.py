"""Whisper-style encoder-decoder (PyTorch), the encdec family: training and
serving entries.

Counterpart of ``repro.models.whisper``, the reference's backbone and no
more: the conv/mel frontend is a stub (the caller supplies frame
embeddings (B, enc_seq, d)), norms are RMSNorm, positions are learned
tables (``pos_enc``, and ``pos_dec`` with 32768 rows), every attention
projection has a bias, the MLPs are the tanh GELU and the head is the tied
``embed.T``.  The encoder is bidirectional; each decoder layer runs causal
self-attention (a KV cache when serving), cross-attention to the encoder
output and the MLP.  Cross-attention K/V are recomputed from ``enc_out``
at every decode step, as the reference does (no cross-KV cache).

``enc`` and ``dec`` are lists of per-layer dicts (the reference stacks
them and runs ``lax.scan``).  The serving entries (``prefill``,
``prefill_slot``, ``decode_step`` and ``encode(serving=True)``) attend
without a cache -- the encoder and every cross-attention -- through K7;
training keeps ``layers.attention_core``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import refnum, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PagedKVCache, QCtx, attn_apply,
                                       attn_params, dyn_rows, embed_init,
                                       embed_lookup, mlp_apply, mlp_params,
                                       rmsnorm)

_SEED_STRIDE = 0x9E3779B9          # per-layer SR seed stride
_DEC_SEED = 0x777                  # the decoder's seeds start here
POS_DEC_ROWS = 32768               # the reference's largest decoder context


def _block_params(gen, cfg: ModelConfig, cross: bool, dtype, device):
    p = {
        "attn": attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, bias=True, dtype=dtype, device=device),
        "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                          device=device),
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cross:
        p["xattn"] = attn_params(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, bias=True,
                                 dtype=dtype, device=device)
        p["lnx"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return p


def init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
         device=None, finish=None):
    """Parameter layout of ``repro.models.whisper.init`` with per-layer
    ``enc`` and ``dec`` dicts.  Values from ``gen`` (torch's stream, a
    declared divergence) in the order embed, pos_dec, pos_enc, the encoder
    layers, the decoder layers; ``finish`` (e.g. the serving packer) is
    applied to each layer as soon as it is drawn."""
    finish = finish if finish is not None else (lambda tree: tree)
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device=device),
        "pos_dec": embed_init(gen, POS_DEC_ROWS, cfg.d_model, dtype,
                              device=device),
        "pos_enc": embed_init(gen, cfg.enc_seq, cfg.d_model, dtype,
                              device=device),
        "enc": [finish(_block_params(gen, cfg, False, dtype, device))
                for _ in range(cfg.enc_layers)],
        "dec": [finish(_block_params(gen, cfg, True, dtype, device))
                for _ in range(cfg.n_layers)],
        "ln_enc": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def _run(body, layers, seeds, x, remat: bool):
    """x through ``body(lp, seed, x)`` layer by layer; with ``remat`` (and
    autograd on) each layer is recomputed in the backward, its QCtx built
    inside the body so the recompute draws the same SR streams."""
    for lp, s in zip(layers, seeds):
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp, s=s: body(lp, s, h), x,
                use_reentrant=False)
        else:
            x = body(lp, s, x)
    return x


def encode(params, cfg: ModelConfig, qcfg: QuantConfig, frames, *,
           seed: int = 0, remat: bool = False, serving: bool = False):
    """frames: (B, T, d) precomputed frame embeddings (the frontend stub).
    ``serving``: self-attention through K7 (the serving entries), else
    ``attention_core``."""
    x = frames + params["pos_enc"][None, :frames.shape[1]]

    def body(lp, s, x):
        ctx = QCtx(qcfg, s)
        h, _ = attn_apply(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                          ctx, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                          hd=cfg.hd, rope_theta=cfg.rope_theta, causal=False,
                          chunk=cfg.attn_chunk, use_rope=False,
                          serving=serving)
        x = x + h
        return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                             ctx, "gelu")

    seeds = [(int(seed) + i * _SEED_STRIDE) & M32
             for i in range(len(params["enc"]))]
    x = _run(body, params["enc"], seeds, x, remat)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _decoder(params, cfg: ModelConfig, qcfg: QuantConfig, x, enc_out, seed,
             *, caches=None, remat: bool = False, slot=None, plen=None,
             serving: bool = False):
    """The decoder layers over x; ``caches`` (one per layer) update in
    place.  ``ctx.dense`` order a layer: self-attention wq, wk, wv, wo,
    cross-attention wq, wk, wv, wo, then w_in, w_out."""
    def body(lp, s, x, cache=None):
        ctx = QCtx(qcfg, s)
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                  rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                  use_rope=False)
        h, _ = attn_apply(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                          ctx, cache=cache, slot=slot, plen=plen, **kw)
        x = x + h
        h, _ = attn_apply(lp["xattn"], rmsnorm(x, lp["lnx"], cfg.norm_eps),
                          ctx, xkv=enc_out, serving=serving, **kw)
        x = x + h
        return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                             ctx, "gelu")

    seeds = [(int(seed) + _DEC_SEED + i * _SEED_STRIDE) & M32
             for i in range(len(params["dec"]))]
    if caches is None:
        return _run(body, params["dec"], seeds, x, remat)
    for lp, s, c in zip(params["dec"], seeds, caches):
        x = body(lp, s, x, c)
    return x


def _logits(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed=0):
    """The tied head: x @ embed.T through ``fqt.dense`` (K1 on the card:
    ``embed`` is no packable leaf), padded ids masked."""
    return transformer.head(cfg, qcfg, x, params["embed"].T, seed)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, *,
            frames=None, seed: int = 0, remat: bool = True):
    """Teacher-forced training forward.  tokens (B, S); frames (B, T, d),
    zeros when None.  Returns (logits, a zero aux loss)."""
    B, S = tokens.shape
    dev = tokens.device
    if frames is None:
        frames = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=dev)
    enc_out = encode(params, cfg, qcfg, frames, seed=seed, remat=remat)
    x = embed_lookup(params["embed"], tokens) + params["pos_dec"][None, :S]
    x = _decoder(params, cfg, qcfg, x, enc_out, seed, remat=remat)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (_logits(params, cfg, qcfg, x, seed),
            torch.zeros((), dtype=torch.float32, device=dev))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_format: str = "bf16",
               page_size: Optional[int] = None,
               total_pages: Optional[int] = None, device=None) -> List:
    """The decoder's self-attention caches, one a layer
    (``transformer.init_cache``'s layout)."""
    return transformer.init_cache(cfg, batch, max_len, dtype, kv_format,
                                  page_size, total_pages, device=device)


def prefill_slot(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                 enc_slot, caches, slot, plen, *, seed: int = 0):
    """Prefill ONE paged decoder slot from a right-padded (1, Sp) prompt
    against that request's encoder output (1, enc_seq, d).  ``slot`` and
    ``plen``: host ints or int32 device scalars.  Returns (logits at the
    last prompt token (1, V), caches)."""
    S = tokens.shape[1]
    x = params["embed"][tokens] + params["pos_dec"][None, :S]
    x = _decoder(params, cfg, qcfg, x, enc_slot, seed, caches=caches,
                 slot=slot, plen=plen, serving=True)
    x = rmsnorm(transformer._token_at(x, plen - 1), params["ln_f"],
                cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed)[:, 0], caches


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, enc_out,
            caches, *, seed: int = 0):
    """Run the prompt through the decoder, filling the (empty) caches.
    Returns (last-token logits (B, 1, V), (enc_out, caches))."""
    S = tokens.shape[1]
    x = params["embed"][tokens] + params["pos_dec"][None, :S]
    x = _decoder(params, cfg, qcfg, x, enc_out, seed, caches=caches,
                 serving=True)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed), (enc_out, caches)


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
                *, seed: int = 0):
    """carry = (enc_out, caches); tokens (B, 1).  The position row is
    ``pos_dec[length]`` of layer 0's cache: one for the lockstep batch, one
    per slot for a paged cache (device-index gathers, so a recorded graph
    serves every step)."""
    enc_out, caches = carry
    c0 = caches[0]
    if isinstance(c0, PagedKVCache):
        rows = params["pos_dec"].index_select(0, c0.lengths)[:, None]
    else:
        rows = params["pos_dec"].index_select(
            0, dyn_rows(c0.length, 1, tokens.device))[None]
    x = params["embed"][tokens] + rows
    x = _decoder(params, cfg, qcfg, x, enc_out, seed, caches=caches,
                 serving=True)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed), carry


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True):
    """Next-token cross-entropy.  batch: {"tokens": (B, S + 1), optional
    "frames": (B, T, d)}.  Returns (loss, {"nll", "aux"})."""
    tokens = batch["tokens"].long()
    logits, aux = forward(params, cfg, qcfg, tokens[:, :-1],
                          frames=batch.get("frames"), seed=seed, remat=remat)
    loss = refnum.mean_nll(logits, tokens[:, 1:])
    return loss, {"nll": loss, "aux": aux}
