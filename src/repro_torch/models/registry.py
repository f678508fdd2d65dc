"""Uniform model API (PyTorch), the dense family.

  init_params(cfg, seed=..., device=...)          -> params
  loss_fn(params, cfg, qcfg, batch, seed, remat)  -> (loss, aux)
  forward(params, cfg, qcfg, batch, seed, remat)  -> (logits, aux)
  make_decode_state(cfg, batch, max_len, ...)     -> per-layer caches
  prefill(params, cfg, qcfg, tokens, carry)       -> (last logits, carry)
  decode_step(params, cfg, qcfg, tokens, carry)   -> (logits, carry)

Counterpart of ``repro.models.registry``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  The moe, hybrid, ssm, encdec
and vlm families arrive with ROADMAP Queue 1's breadth items.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with the breadth families "
            f"(ROADMAP Queue 1); the port runs the dense family")


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None):
    """Random parameters drawn from a seeded ``torch.Generator`` on
    ``device`` (default cuda)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return transformer.init(cfg, generator, dtype, device=dev)


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True):
    """Next-token cross-entropy of ``batch["tokens"]``: (loss, aux)."""
    _dense_only(cfg)
    return transformer.loss_fn(params, cfg, qcfg, batch, seed=seed,
                               remat=remat)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = False):
    """Full-sequence logits of ``batch["tokens"]``: (logits, aux)."""
    _dense_only(cfg)
    return transformer.forward(params, cfg, qcfg, batch["tokens"],
                               seed=seed, remat=remat)


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, kv_cache_format: str = "bf16",
                      device=None):
    """Empty per-layer KV caches: bf16, or block-quantized "nvfp4"/"fp8"."""
    _dense_only(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype,
                                  kv_cache_format,
                                  device=resolve_device(device))


def prefill(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry):
    """Fill the decode carry from a prompt.  Returns (last_logits, carry)."""
    _dense_only(cfg)
    logits, carry = transformer.prefill(params, cfg, qcfg, tokens, carry)
    return logits[:, -1], carry


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry):
    _dense_only(cfg)
    return transformer.decode_step(params, cfg, qcfg, tokens, carry)
