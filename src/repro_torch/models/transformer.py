"""Decoder-only LM transformer (PyTorch), the dense, moe and vlm families:
training and serving entries.  The vlm family (InternVL2) is the dense LM
with a prefix of precomputed patch embeddings (the InternViT frontend is a
stub, as in the reference): ``prefix_embeds`` (B, P, d) go before the token
embeddings in ``forward``, ``loss_fn`` and ``prefill``.

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

from repro_torch.core import fqt
from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import refnum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (TRASH_PAGE, PagedKVCache, QCtx,
                                       attn_apply, attn_params, dense_init,
                                       dyn_rows, embed_init, embed_lookup,
                                       gather_from_tp, make_kv_cache,
                                       mlp_apply, mlp_params, rmsnorm)

_SEED_STRIDE = 0x9E3779B9                   # per-layer SR seed stride


def check_family(cfg: ModelConfig):
    """The transformer families: dense, moe (with experts) and vlm (the
    dense LM behind a patch-embedding prefix, no experts)."""
    if cfg.family not in ("dense", "moe", "vlm") or \
            bool(cfg.n_experts) != (cfg.family == "moe"):
        raise ValueError(
            f"family {cfg.family!r} with {cfg.n_experts} experts is no "
            f"transformer family (dense, moe with experts, vlm)")


def init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
         device=None, finish=None):
    """Parameter layout of ``repro.models.transformer.init`` with per-layer
    dicts.  Values come from ``gen`` (torch's normal stream, not
    ``jax.random``'s: a declared divergence), in the order embed, layer by
    layer (attn, then mlp or moe), lm_head.  ``finish`` (a dict -> dict
    map, e.g. the serving packer) is applied to each layer as soon as it is
    drawn, and to the lm_head, so a model whose whole bf16 tree would not
    fit is built one layer at a time."""
    check_family(cfg)
    finish = finish if finish is not None else (lambda tree: tree)

    def layer():
        p = {
            "attn": attn_params(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, dtype,
                                qk_norm=cfg.use_qk_norm, device=device),
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        }
        if cfg.n_experts:
            p["moe"] = moe_mod.moe_params(gen, cfg, dtype, device=device)
        else:
            p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                  device=device)
        return finish(p)

    params = finish({"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype, device=device)})
    params.update({
        "layers": [layer() for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    })
    if not cfg.tie_embeddings:
        params.update(finish({"lm_head": dense_init(
            gen, cfg.d_model, cfg.padded_vocab, dtype, device=device)}))
    return params


def local_heads(cfg: ModelConfig, mesh=None):
    """(query heads, KV heads) of this rank: the model's, split over the
    mesh's "model" axis (Megatron TP shards attention by heads)."""
    tp = 1 if mesh is None else mesh.axis_size("model")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads / {cfg.n_kv_heads} "
                         f"KV heads do not split over tp={tp}")
    return cfg.n_heads // tp, cfg.n_kv_heads // tp


def _layer_apply(cfg: ModelConfig, lp, x, seed: int, *, cache,
                 qcfg: QuantConfig, slot=None, plen=None, pfx=None,
                 write_mask=None, mesh=None, dp_rows: bool = False):
    """One layer: (x, cache, aux), aux the moe router's auxiliary loss (a
    zero f32 scalar for the dense family).  Under a ``mesh`` the layer's
    weights and cache are this rank's shards: its attention runs on the
    local heads, norms and the residual stay replicated over "model", and
    a moe layer routes as ``moe.moe_apply`` says (``dp_rows``: x holds this
    rank's rows of a training batch split over the DP axes; aux is then
    this rank's share)."""
    ctx = QCtx(qcfg, seed, mesh)
    n_heads, n_kv = local_heads(cfg, mesh)
    h, cache = attn_apply(
        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), ctx,
        n_heads=n_heads, n_kv=n_kv, hd=cfg.hd,
        rope_theta=cfg.rope_theta, window=cfg.sliding_window,
        chunk=cfg.attn_chunk, cache=cache, slot=slot, plen=plen, pfx=pfx,
        write_mask=write_mask, norm_eps=cfg.norm_eps)
    x = x + h
    hin = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        B, S, d = hin.shape
        y, aux = moe_mod.moe_apply(lp["moe"], hin.reshape(B * S, d), ctx,
                                   cfg, dp_rows=dp_rows)
        y = y.reshape(B, S, d)
    else:
        y = mlp_apply(lp["mlp"], hin, ctx, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, cache, aux


def apply_layers(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed=0, *,
                 caches=None, remat: bool = False, slot=None, plen=None,
                 pfx=None, write_mask=None, mesh=None,
                 dp_rows: bool = False):
    """Run the layers in order; caches (one per layer) update in place.
    Returns (x, caches, the sum of the layers' aux losses).

    ``remat``: each layer body runs under ``torch.utils.checkpoint`` and
    is recomputed in the backward; its QCtx is built inside the body, so
    the recompute draws the same SR streams.  ``slot``/``plen``/``pfx``/
    ``write_mask``: the paged-cache operands of ``layers.attn_apply``;
    ``mesh``: the mesh of the weights' shards (serving or training);
    ``dp_rows``: x holds this rank's rows of a training batch."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        s = (int(seed) + i * _SEED_STRIDE) & M32
        cache = None if caches is None else caches[i]
        if remat and cache is None and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp, s=s: _layer_apply(
                    cfg, lp, h, s, cache=None, qcfg=qcfg, mesh=mesh,
                    dp_rows=dp_rows)[::2],
                x, use_reentrant=False)
        else:
            x, _, a = _layer_apply(cfg, lp, x, s, qcfg=qcfg, cache=cache,
                                   slot=slot, plen=plen, pfx=pfx,
                                   write_mask=write_mask, mesh=mesh,
                                   dp_rows=dp_rows)
        aux = aux + a
    return x, caches, aux


def _logits(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed=0,
            mesh=None):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head(cfg, qcfg, x, w, seed, mesh)


def head(cfg: ModelConfig, qcfg: QuantConfig, x, w, seed=0, mesh=None,
         rows_whole: bool = False):
    """x @ w, the LM head, under ``qcfg`` where ``cfg.quantize_lm_head``
    (else bf16) with the head's SR seed; the padded vocabulary ids get
    -1e30.  Under a multi-rank ``mesh`` it is column-parallel over the
    vocabulary, and the logits are all-gathered (``gather_from_tp``): every
    rank picks from, and computes its loss on, the same full logits.
    ``rows_whole``: x is the whole batch on every rank, an unpacked ``w``
    served on a mesh (whisper's tied ``embed.T``): its sharded GEMM's
    layout says so (``fqt._ShardLayout``), as the moe layer's does."""
    head_cfg = qcfg if cfg.quantize_lm_head else QuantConfig()
    s = (int(seed) + 0xABCDEF) & M32
    if rows_whole and mesh is not None and mesh.size > 1:
        from repro_torch.distributed.sharding import weight_kind
        lay = fqt._ShardLayout(mesh, *weight_kind("d_vocab", mesh),
                               rows_whole=True)
        logits = fqt._ShardedFP4Matmul.apply(x, w, s, head_cfg, lay)
    else:
        logits = QCtx(head_cfg, s, mesh).dense(x, w, kind="d_vocab")
    logits = gather_from_tp(logits, mesh, dim=-1)
    if cfg.padded_vocab != cfg.vocab_size:        # mask padded ids
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return logits


def _with_prefix(x, prefix_embeds):
    """``prefix_embeds`` (B, P, d), cast to x's dtype, before x."""
    if prefix_embeds is None:
        return x
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, *,
            seed: int = 0, prefix_embeds=None, remat: bool = True,
            mesh=None):
    """Full-sequence forward (training).  Returns (logits, aux_loss): the
    moe routers' load-balancing loss summed over layers (0 for dense).
    ``prefix_embeds`` (B, P, d): the vlm prefix, attended at positions
    0..P-1; the logits are the S token rows'.  ``mesh``: the training
    mesh of the parameters' shards (``tokens`` and ``prefix_embeds``: this
    rank's rows; aux: this rank's share, ``moe.moe_apply``)."""
    x = _with_prefix(embed_lookup(params["embed"], tokens, mesh),
                     prefix_embeds)
    x, _, aux = apply_layers(params, cfg, qcfg, x, seed, remat=remat,
                             mesh=mesh, dp_rows=mesh is not None)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    return _logits(params, cfg, qcfg, x, seed, mesh), aux


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True, mesh=None):
    """Next-token cross-entropy.  batch: {"tokens": (B, S + 1) ints,
    optional "prefix_embeds" (B, P, d)}.  Returns (loss, {"nll", "aux"}).

    Under a multi-rank training ``mesh`` the batch is this rank's rows and
    the loss this rank's share of the mean: the sum of its tokens' nll
    over the token count of the DP axes the backward sums over
    (``sharding.grad_sum_axes``: the global batch's, or its pod's where the
    pods' gradients are averaged after), so the sum of the ranks'
    gradients over those axes is the mean gradient; the moe aux is this
    rank's share in the same sense (``moe.moe_apply``), so the ranks'
    losses and auxes sum over those axes to the 1-device ones."""
    tokens = batch["tokens"].long()
    logits, aux = forward(params, cfg, qcfg, tokens[:, :-1], seed=seed,
                          prefix_embeds=batch.get("prefix_embeds"),
                          remat=remat, mesh=mesh)
    # on the CPU the reference's gradient of the mean nll: one logit
    # gradient a bf16 ulp off changes the tensor scale the lm_head's SR
    # update GEMM quantizes with (refnum.mean_nll)
    loss = refnum.mean_nll(logits, tokens[:, 1:],
                           count=nll_count(tokens, mesh))
    return loss + cfg.router_aux_weight * aux, {"nll": loss, "aux": aux}


def nll_count(tokens, mesh=None):
    """The token count a rank's nll sum is divided by: None (its own
    tokens' mean) off a mesh; on a multi-rank training mesh the count of
    the DP axes the backward sums over (``sharding.grad_sum_axes``), so
    the ranks' losses sum to the mean (every family's ``loss_fn``)."""
    if mesh is None or mesh.size == 1:
        return None
    from repro_torch.distributed.sharding import grad_sum_axes
    return tokens[:, 1:].numel() * mesh.axes_size(grad_sum_axes(mesh))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_format: str = "bf16",
               page_size: Optional[int] = None,
               total_pages: Optional[int] = None, device=None,
               mesh=None) -> List:
    """One cache per layer.  With ``page_size``: ``PagedKVCache``s over one
    pool per layer, the slot buffer rounded up to whole pages; every layer
    shares ONE page-table tensor, and each layer's lengths are a row of
    one (L, B) tensor.  Under a serving ``mesh`` each holds this rank's KV
    heads only (the paged pools as the reference shards them; the lockstep
    caches too, which the reference replicates: the same values, a
    declared layout divergence)."""
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
    return [make_kv_cache(batch, buf, local_heads(cfg, mesh)[1], cfg.hd,
                          dtype,
                          kv_format, page_size=page_size,
                          total_pages=total_pages, device=device, **sh)
            for sh in shared]


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches,
            *, prefix_embeds=None, mesh=None):
    """Run the prompt (after ``prefix_embeds`` (B, P, d), if given) through
    the model, filling the (empty) caches; returns (last-token logits
    (B, 1, V), caches).  ``mesh``: the serving mesh of the shards (every
    serving entry below takes it)."""
    x = _with_prefix(embed_lookup(params["embed"], tokens, mesh),
                     prefix_embeds)
    x, caches, _ = apply_layers(params, cfg, qcfg, x, caches=caches,
                                mesh=mesh)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, mesh=mesh), caches


def _token_at(x, i):
    """x[:, i:i + 1] for a host int or int32 device scalar ``i``."""
    return x.index_select(1, dyn_rows(i, 1, x.device))


def prefill_slot(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                 caches, slot, plen, *, seed=0, mesh=None):
    """Prefill ONE paged slot from a right-padded (1, Sp) prompt; ``plen``
    is the true prompt length.  ``slot`` and ``plen`` are host ints or
    int32 device scalars (dynamic operands).  Returns (logits at the last
    prompt token (1, V), caches)."""
    x = embed_lookup(params["embed"], tokens, mesh)
    x, caches, _ = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                                slot=slot, plen=plen, mesh=mesh)
    x = rmsnorm(_token_at(x, plen - 1), params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed, mesh)[:, 0], caches


def prefill_suffix(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                   caches, slot, plen, pfx, *, seed=0, mesh=None):
    """Prefill ONE paged slot from a right-padded (1, Sp) prompt SUFFIX
    whose first ``pfx`` tokens are already cached in the slot's pages;
    ``plen`` is the TOTAL prompt length.  The suffix rows are written at
    [pfx, plen) and the queries attend through the paged cache (K5).
    ``slot``, ``plen`` and ``pfx``: host ints or int32 device scalars.
    Returns (logits at the last prompt token (1, V), caches)."""
    x = embed_lookup(params["embed"], tokens, mesh)
    x, caches, _ = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                                slot=slot, plen=plen, pfx=pfx, mesh=mesh)
    x = rmsnorm(_token_at(x, plen - pfx - 1), params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed, mesh)[:, 0], caches


def prefill_chunk(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                  caches, slot, off, *, seed=0, mesh=None):
    """Write ONE full intermediate (1, C) chunk of a prompt into a paged
    slot at [off, off + C), attending through the paged cache (the suffix
    machinery: chunking cannot change any value).  ``slot`` and ``off``:
    host ints or int32 device scalars.  No logits.  Returns the caches."""
    x = embed_lookup(params["embed"], tokens, mesh)
    C = x.shape[1]
    _, caches, _ = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                                slot=slot, plen=off + C, pfx=off, mesh=mesh)
    return caches


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches,
                *, seed=0, write_mask=None, mesh=None):
    """One new token per sequence.  tokens: (B, 1).  Returns (logits,
    caches).  ``write_mask`` ((B,) bool, paged caches): slots mid-chunked-
    prefill write to the trash page and keep their length."""
    x = embed_lookup(params["embed"], tokens, mesh)
    x, caches, _ = apply_layers(params, cfg, qcfg, x, seed, caches=caches,
                                write_mask=write_mask, mesh=mesh)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _logits(params, cfg, qcfg, x, seed, mesh), caches


def verify_k(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, caches,
             *, seed=0, write_mask=None, mesh=None):
    """Teacher-forced verify over a speculative block: ``tokens`` (B, k),
    written at each slot's [len, len + k) and attended with per-slot causal
    positions, so row j's logits equal a sequential decode's.  Returns
    (logits (B, k, V), caches); the caller rolls rejected rows back with
    ``PagedKVCache.truncate_to``."""
    return decode_step(params, cfg, qcfg, tokens, caches, seed=seed,
                       write_mask=write_mask, mesh=mesh)


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
