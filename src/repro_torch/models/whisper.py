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

Under a mesh of more than one rank (``mesh=``: serving or training, the
weights this rank's shards) every attention runs on this rank's heads
(the Megatron path of ``layers.attn_apply``, the column biases sliced as
their weights), the GELU MLP adds its whole ``b_out`` after the row
reduce (``layers.mlp_apply``), the token embedding and both position
tables (``pos_enc``, ``pos_dec``: "vocab_d", positions over "model") are
vocab-parallel lookups (``layers.embed_lookup``), and the tied head is
column-parallel over the vocabulary with the whole table's tensor scale.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import refnum, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PagedKVCache, QCtx, _multi,
                                       attn_apply, attn_params, dyn_rows,
                                       embed_init, embed_lookup, mlp_apply,
                                       mlp_params, rmsnorm)

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
    params = finish({
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device=device),
        "pos_dec": embed_init(gen, POS_DEC_ROWS, cfg.d_model, dtype,
                              device=device),
        "pos_enc": embed_init(gen, cfg.enc_seq, cfg.d_model, dtype,
                              device=device)})
    params.update({
        "enc": [finish(_block_params(gen, cfg, False, dtype, device))
                for _ in range(cfg.enc_layers)],
        "dec": [finish(_block_params(gen, cfg, True, dtype, device))
                for _ in range(cfg.n_layers)],
        "ln_enc": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    })
    return params


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


def _positions(table, n: int, mesh=None):
    """Rows 0..n-1 of a position table as (1, n, d): a slice, or on a
    multi-rank mesh (positions over "model", d over "data") the
    vocab-parallel lookup of ``embed_lookup``."""
    if not _multi(mesh):
        return table[None, :n]
    pos = torch.arange(n, device=table.device)
    return embed_lookup(table, pos, mesh)[None]


def _heads(cfg: ModelConfig, mesh):
    """The attention's head arguments: this rank's query and KV heads."""
    n_heads, n_kv = transformer.local_heads(cfg, mesh)
    return dict(n_heads=n_heads, n_kv=n_kv, hd=cfg.hd,
                rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                use_rope=False)


def encode(params, cfg: ModelConfig, qcfg: QuantConfig, frames, *,
           seed: int = 0, remat: bool = False, serving: bool = False,
           mesh=None):
    """frames: (B, T, d) precomputed frame embeddings (the frontend stub).
    ``serving``: self-attention through K7 (the serving entries), else
    ``attention_core``.  ``mesh``: the mesh of the weights' shards."""
    x = frames + _positions(params["pos_enc"], frames.shape[1], mesh)

    def body(lp, s, x):
        ctx = QCtx(qcfg, s, mesh)
        h, _ = attn_apply(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                          ctx, causal=False, serving=serving,
                          **_heads(cfg, mesh))
        x = x + h
        return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                             ctx, "gelu")

    seeds = [(int(seed) + i * _SEED_STRIDE) & M32
             for i in range(len(params["enc"]))]
    x = _run(body, params["enc"], seeds, x, remat)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _decoder(params, cfg: ModelConfig, qcfg: QuantConfig, x, enc_out, seed,
             *, caches=None, remat: bool = False, slot=None, plen=None,
             serving: bool = False, mesh=None):
    """The decoder layers over x; ``caches`` (one per layer) update in
    place.  ``ctx.dense`` order a layer: self-attention wq, wk, wv, wo,
    cross-attention wq, wk, wv, wo, then w_in, w_out."""
    kw = _heads(cfg, mesh)

    def body(lp, s, x, cache=None):
        ctx = QCtx(qcfg, s, mesh)
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


def _logits(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed=0,
            mesh=None, serving: bool = False):
    """The tied head: x @ embed.T through ``fqt.dense`` (K1 on the card:
    ``embed`` is no packable leaf), padded ids masked.  On a multi-rank
    mesh column-parallel over the vocabulary (``embed``'s rows), its
    tensor scale the whole table's (K1's ``b_amax``, an all-reduced MAX),
    the logits gathered; ``serving``: x is the whole batch on every
    rank."""
    return transformer.head(cfg, qcfg, x, params["embed"].T, seed, mesh,
                            rows_whole=serving)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, *,
            frames=None, seed: int = 0, remat: bool = True, mesh=None):
    """Teacher-forced training forward.  tokens (B, S); frames (B, T, d),
    zeros when None.  Returns (logits, a zero aux loss).  ``mesh``: the
    training mesh of the parameters' shards (tokens and frames: this
    rank's rows)."""
    B, S = tokens.shape
    dev = tokens.device
    if frames is None:
        frames = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=dev)
    enc_out = encode(params, cfg, qcfg, frames, seed=seed, remat=remat,
                     mesh=mesh)
    x = embed_lookup(params["embed"], tokens, mesh) + _positions(
        params["pos_dec"], S, mesh)
    x = _decoder(params, cfg, qcfg, x, enc_out, seed, remat=remat,
                 mesh=mesh)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (_logits(params, cfg, qcfg, x, seed, mesh),
            torch.zeros((), dtype=torch.float32, device=dev))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_format: str = "bf16",
               page_size: Optional[int] = None,
               total_pages: Optional[int] = None, device=None,
               mesh=None) -> List:
    """The decoder's self-attention caches, one a layer
    (``transformer.init_cache``'s layout; under a serving ``mesh`` this
    rank's KV heads)."""
    return transformer.init_cache(cfg, batch, max_len, dtype, kv_format,
                                  page_size, total_pages, device=device,
                                  mesh=mesh)


def prefill_slot(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                 enc_slot, caches, slot, plen, *, seed: int = 0, mesh=None):
    """Prefill ONE paged decoder slot from a right-padded (1, Sp) prompt
    against that request's encoder output (1, enc_seq, d).  ``slot`` and
    ``plen``: host ints or int32 device scalars.  Returns (logits at the
    last prompt token (1, V), caches).  ``mesh``: the serving mesh of the
    shards (every serving entry below takes it)."""
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, mesh) + _positions(
        params["pos_dec"], S, mesh)
    x = _decoder(params, cfg, qcfg, x, enc_slot, seed, caches=caches,
                 slot=slot, plen=plen, serving=True, mesh=mesh)
    x = rmsnorm(transformer._token_at(x, plen - 1), params["ln_f"],
                cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed, mesh, True)[:, 0], caches


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, enc_out,
            caches, *, seed: int = 0, mesh=None):
    """Run the prompt through the decoder, filling the (empty) caches.
    Returns (last-token logits (B, 1, V), (enc_out, caches))."""
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, mesh) + _positions(
        params["pos_dec"], S, mesh)
    x = _decoder(params, cfg, qcfg, x, enc_out, seed, caches=caches,
                 serving=True, mesh=mesh)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed, mesh, True), (enc_out,
                                                             caches)


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
                *, seed: int = 0, mesh=None):
    """carry = (enc_out, caches); tokens (B, 1).  The position row is
    ``pos_dec[length]`` of layer 0's cache: one for the lockstep batch, one
    per slot for a paged cache (device-index gathers, so a recorded graph
    serves every step)."""
    enc_out, caches = carry
    c0 = caches[0]
    pos = (c0.lengths[:, None] if isinstance(c0, PagedKVCache)
           else dyn_rows(c0.length, 1, tokens.device)[None])
    if _multi(mesh):
        rows = embed_lookup(params["pos_dec"], pos, mesh)
    else:
        rows = params["pos_dec"].index_select(0, pos.reshape(-1)).reshape(
            pos.shape + (cfg.d_model,))
    x = embed_lookup(params["embed"], tokens, mesh) + rows
    x = _decoder(params, cfg, qcfg, x, enc_out, seed, caches=caches,
                 serving=True, mesh=mesh)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed, mesh, True), carry


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True, mesh=None):
    """Next-token cross-entropy.  batch: {"tokens": (B, S + 1), optional
    "frames": (B, T, d)}.  Returns (loss, {"nll", "aux"}).  ``mesh``: the
    training mesh (the batch this rank's rows, the loss its share:
    ``transformer.nll_count``)."""
    tokens = batch["tokens"].long()
    logits, aux = forward(params, cfg, qcfg, tokens[:, :-1],
                          frames=batch.get("frames"), seed=seed, remat=remat,
                          mesh=mesh)
    loss = refnum.mean_nll(logits, tokens[:, 1:],
                           count=transformer.nll_count(tokens, mesh))
    return loss, {"nll": loss, "aux": aux}
