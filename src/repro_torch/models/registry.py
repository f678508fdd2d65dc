"""Uniform model API (PyTorch) over every family: the dense, moe and vlm
transformers, the recurrent hybrid (zamba2: Mamba2 + a shared attention
block) and ssm (xLSTM), and the encdec (whisper) encoder-decoder.

  init_params(cfg, seed=..., device=...)          -> params
  loss_fn(params, cfg, qcfg, batch, seed, remat)  -> (loss, aux)
  forward(params, cfg, qcfg, batch, seed, remat)  -> (logits, aux)
  make_decode_state(cfg, batch, max_len, ...)     -> the decode carry
  reset_decode_state(carry)                       -> the same, emptied in place
  prefill(params, cfg, qcfg, tokens, carry)       -> (last logits, carry)
  decode_step(params, cfg, qcfg, tokens, carry)   -> (logits, carry)
  prefill_slot / prefill_suffix / prefill_chunk   -> continuous batching
  verify_k, draft_view                            -> speculative decoding

Counterpart of ``repro.models.registry``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  The batch and the ``extras`` of
the serving entries carry the stub frontends' inputs: ``frames`` (B, T, d)
for encdec, ``prefix_embeds`` (B, P, d) for vlm.  The recurrent families
serve in lockstep only: they prefill by a loop of decode steps (the
reference's ``lax.scan``).  The continuous-batching entries serve dense and
moe, and ``prefill_slot`` the whisper decoder too; every other family
raises, with the reference's reasons.

Under a mesh of more than one rank (``mesh=``, this rank's view:
``distributed/mesh.py``) the serving entries and ``loss_fn`` (the training
mesh) run every family on this rank's shards, Megatron-style (each
module's docstring says how); ``check_mesh`` raises ``ValueError`` where a
family's heads do not split over "model".
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import mamba2, transformer, whisper, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dyn_rows

_RECURRENT = {"hybrid": mamba2, "ssm": xlstm}
# the families whose paged K/V are a pure function of the prompt: the ones
# a prefix cache, chunked prefill and speculative decoding can serve
PROMPT_PURE = ("dense", "moe")


def _module(cfg: ModelConfig):
    """The family's model module (``transformer.check_family`` guards the
    transformer families)."""
    if cfg.family in _RECURRENT:
        return _RECURRENT[cfg.family]
    if cfg.family == "encdec":
        return whisper
    transformer.check_family(cfg)
    return transformer


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """A multi-rank mesh serves and trains every family whose heads split
    evenly over "model": the query and KV heads (the hybrid family's
    shared block, whisper's three attentions; the ssm family's mLSTM
    heads are its ``n_heads``) and the hybrid family's SSM heads; any that
    do not raise ``ValueError`` naming them."""
    if mesh is None or mesh.size == 1:
        return
    transformer.local_heads(cfg, mesh)
    if cfg.family == "hybrid":
        mamba2.local_ssm_heads(cfg, mesh)


def _paged_only(cfg: ModelConfig, what: str, why: str):
    """The prompt-pure continuous-batching entries: dense and moe."""
    _module(cfg)
    if cfg.family not in PROMPT_PURE:
        raise NotImplementedError(f"{what}: family {cfg.family!r} {why}")


def _frames(cfg: ModelConfig, extras, batch: int, device):
    """``extras["frames"]``, or the reference's zero frames."""
    frames = (extras or {}).get("frames")
    if frames is None:
        frames = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=device)
    return frames


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None, finish=None):
    """Random parameters drawn from a seeded ``torch.Generator`` on
    ``device`` (default cuda).  ``finish``: applied to each layer's dict
    as it is drawn and to the lm_head (``transformer.init``; the recurrent
    families' also to their shared block)."""
    mod = _module(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return mod.init(cfg, generator, dtype, device=dev, finish=finish)


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True, mesh=None):
    """Next-token cross-entropy of ``batch["tokens"]``: (loss, aux).
    ``mesh``: the training mesh of the parameters' shards, the batch this
    rank's rows and the loss its share (``transformer.nll_count``)."""
    if mesh is not None and mesh.size > 1:
        check_mesh(cfg, mesh)
    else:
        mesh = None
    return _module(cfg).loss_fn(params, cfg, qcfg, batch, seed=seed,
                                remat=remat, mesh=mesh)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = False):
    """Full-sequence logits of ``batch["tokens"]``: (logits, aux); the
    batch's ``frames`` (encdec) or ``prefix_embeds`` (vlm) go with them."""
    mod = _module(cfg)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = batch.get("frames")
    elif mod is transformer:
        kw["prefix_embeds"] = batch.get("prefix_embeds")
    return mod.forward(params, cfg, qcfg, batch["tokens"], seed=seed,
                       remat=remat, **kw)


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, kv_cache_format: str = "bf16",
                      page_size: Optional[int] = None,
                      total_pages: Optional[int] = None, device=None,
                      mesh=None):
    """Empty per-layer KV caches: bf16, or block-quantized "nvfp4"/"fp8";
    with ``page_size``, ``PagedKVCache``s over a shared page pool with
    per-slot lengths (continuous batching; ``total_pages`` sizes the pool,
    default one full reservation per slot plus the trash page).

    hybrid: (the stacked Mamba states, one cache per application of the
    shared block); ssm: the per-layer recurrent states, which stay f32 (no
    KV cache); encdec: (the encoder output (B, enc_seq, d), the decoder's
    caches), allocated once and written in place by the prefills.  Under a
    serving ``mesh`` the caches hold this rank's KV heads, the SSM and
    mLSTM states this rank's heads (the conv, sLSTM and encoder states
    stay whole)."""
    check_mesh(cfg, mesh)
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return (torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                            device=dev),
                whisper.init_cache(cfg, batch, max_len, dtype,
                                   kv_cache_format, page_size, total_pages,
                                   device=dev, mesh=mesh))
    if cfg.family == "hybrid":
        return (mamba2.init_state(cfg, batch, dtype, device=dev, mesh=mesh),
                mamba2.init_cache(cfg, batch, max_len, dtype,
                                  kv_cache_format, page_size, total_pages,
                                  device=dev, mesh=mesh))
    if cfg.family == "ssm":
        return xlstm.init_state(cfg, batch, device=dev, mesh=mesh)
    transformer.check_family(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype,
                                  kv_cache_format, page_size, total_pages,
                                  device=dev, mesh=mesh)


def reset_decode_state(carry) -> None:
    """Empty ``make_decode_state``'s carry IN PLACE (zeroed pools and
    lengths, page tables on the trash page, recurrent states back to their
    initial values, the encoder output zeroed): the engines keep one carry
    at fixed addresses, which their recorded programs read and write.  The
    carry's kind is read off what it holds."""
    caches = carry
    if isinstance(carry, tuple):
        head, caches = carry
        if isinstance(head, torch.Tensor):       # encdec: (enc_out, caches)
            head.zero_()
        else:                                    # hybrid: (states, caches)
            mamba2.reset_state(head)
    elif carry and isinstance(carry[0], tuple):  # ssm: per-layer states
        xlstm.reset_state(carry)
        return
    for cache in caches:
        cache.reset()


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry, *,
            extras=None, mesh=None):
    """Fill the decode carry from a prompt.  Returns (last_logits, carry).
    The recurrent families run one decode step per prompt token (the
    reference's ``lax.scan`` of ``decode_step``; no chunk-parallel
    prefill), updating the carry in place.  encdec encodes
    ``extras["frames"]`` (zeros where none are given) into the carry's
    encoder output, in place; vlm prefills ``extras["prefix_embeds"]``
    before the prompt.  ``mesh``: the serving mesh of the shards (every
    serving entry below takes it; ``check_mesh``)."""
    check_mesh(cfg, mesh)
    extras = extras or {}
    if cfg.family in _RECURRENT:
        for t in range(tokens.shape[1]):
            logits, carry = decode_step(params, cfg, qcfg,
                                        tokens[:, t:t + 1], carry, mesh=mesh)
        return logits[:, -1], carry
    if cfg.family == "encdec":
        enc_out, caches = carry
        enc_out.copy_(whisper.encode(
            params, cfg, qcfg, _frames(cfg, extras, tokens.shape[0],
                                       tokens.device), serving=True,
            mesh=mesh))
        logits, _ = whisper.prefill(params, cfg, qcfg, tokens, enc_out,
                                    caches, mesh=mesh)
        return logits[:, -1], carry
    transformer.check_family(cfg)
    logits, carry = transformer.prefill(
        params, cfg, qcfg, tokens, carry,
        prefix_embeds=extras.get("prefix_embeds"), mesh=mesh)
    return logits[:, -1], carry


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
                *, seed: int = 0, write_mask=None, mesh=None):
    """``write_mask`` ((B,) bool): paged caches only -- slots mid-chunked-
    prefill write to the trash page and keep their length."""
    check_mesh(cfg, mesh)
    mod = _module(cfg)
    if write_mask is not None and mod is not transformer:
        raise NotImplementedError(
            f"decode_step write_mask: family {cfg.family!r} has no paged "
            f"cache write to mask (chunked prefill is dense/moe only)")
    if mod is not transformer:
        return mod.decode_step(params, cfg, qcfg, tokens, carry, seed=seed,
                               mesh=mesh)
    return transformer.decode_step(params, cfg, qcfg, tokens, carry,
                                   seed=seed, write_mask=write_mask,
                                   mesh=mesh)


def prefill_slot(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                 carry, slot, plen, *, seed: int = 0, extras=None,
                 mesh=None):
    """Prefill ONE slot of a paged carry from a right-padded (1, Sp)
    prompt.  ``slot``/``plen``: host ints or int32 device scalars, as the
    reference takes ints or traced values.  Returns (logits (1, V),
    carry).  encdec encodes ``extras["frames"]`` (1, T, d) (zeros where
    none are given) and writes it to ``enc_out[slot]`` in place.  The
    other families raise with the reference's reason: a right-padded
    static prefill would absorb the pad tokens into a recurrent state."""
    check_mesh(cfg, mesh)
    if cfg.family == "encdec":
        enc_out, caches = carry
        enc_slot = whisper.encode(params, cfg, qcfg, _frames(
            cfg, extras, 1, tokens.device), seed=seed, serving=True,
            mesh=mesh)
        enc_out.index_copy_(0, dyn_rows(slot, 1, enc_out.device),
                            enc_slot.to(enc_out.dtype))
        logits, _ = whisper.prefill_slot(params, cfg, qcfg, tokens,
                                         enc_slot, caches, slot, plen,
                                         seed=seed, mesh=mesh)
        return logits, carry
    _paged_only(cfg, "prefill_slot", "not supported (recurrent state "
                "cannot be prefilled from a right-padded static shape)")
    return transformer.prefill_slot(params, cfg, qcfg, tokens, carry, slot,
                                    plen, seed=seed, mesh=mesh)


def prefill_suffix(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                   carry, slot, plen, pfx, *, seed: int = 0, mesh=None):
    """Prefill ONE slot from a right-padded (1, Sp) prompt SUFFIX whose
    first ``pfx`` tokens are cached in shared prefix pages (``slot``/
    ``plen``/``pfx``: host ints or int32 device scalars).  Returns (logits
    (1, V), carry).  Dense and moe only: the whisper decoder's K/V mix in
    per-request frames, vlm's a per-request prefix, and the recurrent
    families have no pageable cache to share."""
    _paged_only(cfg, "prefill_suffix", "cannot share prefix pages (K/V "
                "are not a pure function of the prompt prefix)")
    check_mesh(cfg, mesh)
    return transformer.prefill_suffix(params, cfg, qcfg, tokens, carry,
                                      slot, plen, pfx, seed=seed, mesh=mesh)


def prefill_chunk(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                  carry, slot, off, *, seed: int = 0, mesh=None):
    """Write one FULL intermediate chunk (1, C) of a prompt into a paged
    slot at [off, off + C) (``slot``/``off``: host ints or int32 device
    scalars).  Returns the carry.  Dense and moe only."""
    _paged_only(cfg, "prefill_chunk", "cannot prefill through the paged "
                "cache (K/V are not a pure function of the prompt prefix)")
    check_mesh(cfg, mesh)
    return transformer.prefill_chunk(params, cfg, qcfg, tokens, carry, slot,
                                     off, seed=seed, mesh=mesh)


def verify_k(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
             *, seed: int = 0, write_mask=None, mesh=None):
    """Teacher-forced speculative verify of (B, k) tokens over the paged
    carry.  Returns (logits (B, k, V), carry).  Dense and moe only: a
    recurrent state absorbs drafted tokens irreversibly, and the other
    families have no exactly truncatable paged carry."""
    _paged_only(cfg, "verify_k", "cannot roll back rejected drafts (no "
                "exactly-truncatable paged cache)")
    check_mesh(cfg, mesh)
    return transformer.verify_k(params, cfg, qcfg, tokens, carry, seed=seed,
                                write_mask=write_mask, mesh=mesh)


def draft_view(params, carry, draft_layers: int):
    """Self-draft truncation of the SAME weights and page pools to the
    first ``draft_layers`` layers (the lengths are the draft's own).  Use
    with ``dataclasses.replace(cfg, n_layers=draft_layers)``."""
    return transformer.draft_view(params, carry, draft_layers)
