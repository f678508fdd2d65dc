"""Uniform model API (PyTorch), the dense and moe transformer families.

  init_params(cfg, seed=..., device=...)          -> params
  loss_fn(params, cfg, qcfg, batch, seed, remat)  -> (loss, aux)
  forward(params, cfg, qcfg, batch, seed, remat)  -> (logits, aux)
  make_decode_state(cfg, batch, max_len, ...)     -> per-layer caches
  reset_decode_state(carry)                       -> the same, emptied in place
  prefill(params, cfg, qcfg, tokens, carry)       -> (last logits, carry)
  decode_step(params, cfg, qcfg, tokens, carry)   -> (logits, carry)
  prefill_slot / prefill_suffix / prefill_chunk   -> continuous batching
  verify_k, draft_view                            -> speculative decoding

Counterpart of ``repro.models.registry``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  The hybrid, ssm, encdec and vlm
families arrive with ROADMAP Queue 1's breadth items.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None, finish=None):
    """Random parameters drawn from a seeded ``torch.Generator`` on
    ``device`` (default cuda).  ``finish``: applied to each layer's dict
    as it is drawn and to the lm_head (``transformer.init``)."""
    transformer.check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return transformer.init(cfg, generator, dtype, device=dev, finish=finish)


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True):
    """Next-token cross-entropy of ``batch["tokens"]``: (loss, aux)."""
    transformer.check_family(cfg)
    return transformer.loss_fn(params, cfg, qcfg, batch, seed=seed,
                               remat=remat)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = False):
    """Full-sequence logits of ``batch["tokens"]``: (logits, aux)."""
    transformer.check_family(cfg)
    return transformer.forward(params, cfg, qcfg, batch["tokens"],
                               seed=seed, remat=remat)


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, kv_cache_format: str = "bf16",
                      page_size: Optional[int] = None,
                      total_pages: Optional[int] = None, device=None):
    """Empty per-layer KV caches: bf16, or block-quantized "nvfp4"/"fp8";
    with ``page_size``, ``PagedKVCache``s over a shared page pool with
    per-slot lengths (continuous batching; ``total_pages`` sizes the pool,
    default one full reservation per slot plus the trash page)."""
    transformer.check_family(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype,
                                  kv_cache_format, page_size, total_pages,
                                  device=resolve_device(device))


def reset_decode_state(carry) -> None:
    """Empty ``make_decode_state``'s carry IN PLACE (zeroed pools and
    lengths, page tables on the trash page): the engines keep one carry
    at fixed addresses, which their recorded programs read and write."""
    for cache in carry:
        cache.reset()


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry):
    """Fill the decode carry from a prompt.  Returns (last_logits, carry)."""
    transformer.check_family(cfg)
    logits, carry = transformer.prefill(params, cfg, qcfg, tokens, carry)
    return logits[:, -1], carry


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
                *, seed: int = 0, write_mask=None):
    """``write_mask`` ((B,) bool): paged caches only -- slots mid-chunked-
    prefill write to the trash page and keep their length."""
    transformer.check_family(cfg)
    return transformer.decode_step(params, cfg, qcfg, tokens, carry,
                                   seed=seed, write_mask=write_mask)


def prefill_slot(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                 carry, slot, plen, *, seed: int = 0):
    """Prefill ONE slot of a paged carry from a right-padded (1, Sp)
    prompt.  ``slot``/``plen``: host ints or int32 device scalars, as the
    reference takes ints or traced values.  Returns (logits (1, V),
    carry)."""
    transformer.check_family(cfg)
    return transformer.prefill_slot(params, cfg, qcfg, tokens, carry, slot,
                                    plen, seed=seed)


def prefill_suffix(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                   carry, slot, plen, pfx, *, seed: int = 0):
    """Prefill ONE slot from a right-padded (1, Sp) prompt SUFFIX whose
    first ``pfx`` tokens are cached in shared prefix pages (``slot``/
    ``plen``/``pfx``: host ints or int32 device scalars).  Returns (logits
    (1, V), carry)."""
    transformer.check_family(cfg)
    return transformer.prefill_suffix(params, cfg, qcfg, tokens, carry,
                                      slot, plen, pfx, seed=seed)


def prefill_chunk(params, cfg: ModelConfig, qcfg: QuantConfig, tokens,
                  carry, slot, off, *, seed: int = 0):
    """Write one FULL intermediate chunk (1, C) of a prompt into a paged
    slot at [off, off + C) (``slot``/``off``: host ints or int32 device
    scalars).  Returns the carry."""
    transformer.check_family(cfg)
    return transformer.prefill_chunk(params, cfg, qcfg, tokens, carry, slot,
                                     off, seed=seed)


def verify_k(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
             *, seed: int = 0, write_mask=None):
    """Teacher-forced speculative verify of (B, k) tokens over the paged
    carry.  Returns (logits (B, k, V), carry)."""
    transformer.check_family(cfg)
    return transformer.verify_k(params, cfg, qcfg, tokens, carry, seed=seed,
                                write_mask=write_mask)


def draft_view(params, carry, draft_layers: int):
    """Self-draft truncation of the SAME weights and page pools to the
    first ``draft_layers`` layers (the lengths are the draft's own).  Use
    with ``dataclasses.replace(cfg, n_layers=draft_layers)``."""
    return transformer.draft_view(params, carry, draft_layers)
