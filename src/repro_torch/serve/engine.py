"""Lockstep serving engine (PyTorch): FP4 forward, prefill + decode.

Counterpart of ``repro.serve.engine.Engine``.  Every weight GEMM runs
NVFP4 RtN on the activation against weights packed once at engine build
(the K4 kernel); prefill attention is K7 and decode attention over the
nvfp4/fp8 cache K6.  Prompts are left-padded with token 0 and the pads are
attended unmasked, as in the reference.  Done/EOS bookkeeping stays on the
device and the host syncs once per ``decode_chunk`` steps.

``ContinuousEngine`` (paged cache, scheduler, K5) arrives with its own
slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import fqt
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve import packing


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    max_len: int = 2048
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => no top-k filtering
    eos_id: int = 2
    seed: int = 0
    # "nvfp4" (0.5625 B/elem), "fp8" (1.125 B/elem) or "bf16"
    kv_cache_format: str = "nvfp4"
    decode_chunk: int = 8         # decode steps per host sync


def _sample(logits: torch.Tensor, scfg: ServeConfig,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """logits (B, V) -> (B,) int32.  Greedy is argmax; temperature sampling
    draws from ``gen`` (torch's stream, not ``jax.random``'s categorical:
    a declared divergence)."""
    if scfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / scfg.temperature
    if scfg.top_k > 0:
        kth = torch.topk(logits, scfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def _greedy_margin(logits: torch.Tensor) -> torch.Tensor:
    """Top1 - top2 logit gap per row: how decisive the greedy pick is."""
    top2 = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


class Engine:
    """Single-model LOCKSTEP serving engine (dense family)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 qcfg: Optional[fqt.QuantConfig] = None,
                 pack_weights: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        self.qcfg = qcfg if qcfg is not None else fqt.qaf_config()
        spec = self.qcfg.fwd_w \
            if (pack_weights and self.qcfg.fwd_w is not None) else None
        params = _to_device(params, self.device)
        self.params = packing.pack_model_params(cfg, params, spec)
        self.margins: List[np.ndarray] = []   # per-step greedy margins
        self.steps = 0                        # decode steps of the last run

    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray],
                 max_new: int = 32) -> List[np.ndarray]:
        """Greedy/temperature generation for a batch of token prompts."""
        scfg, cfg, dev = self.scfg, self.cfg, self.device
        B = len(prompts)
        if B > scfg.batch_size:
            raise ValueError(f"{B} prompts > batch_size {scfg.batch_size}")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((scfg.batch_size, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p       # left-pad with token 0
        toks = torch.from_numpy(toks).to(dev)

        carry = registry.make_decode_state(
            cfg, scfg.batch_size, scfg.max_len,
            kv_cache_format=scfg.kv_cache_format, device=dev)
        last_logits, carry = registry.prefill(self.params, cfg, self.qcfg,
                                              toks, carry)
        gen = None
        if scfg.temperature > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(scfg.seed)
        margins = [_greedy_margin(last_logits)]
        nxt = _sample(last_logits, scfg, gen)
        done = torch.zeros((scfg.batch_size,), dtype=torch.bool, device=dev)
        eos = torch.full((), scfg.eos_id, dtype=torch.int32, device=dev)
        emitted = []                          # device tensors; no per-step sync
        sync = max(1, scfg.decode_chunk)
        for t in range(max_new):
            emit = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            logits, carry = registry.decode_step(
                self.params, cfg, self.qcfg, emit[:, None].to(torch.int64),
                carry)
            margins.append(_greedy_margin(logits[:, -1]))
            nxt = _sample(logits[:, -1], scfg, gen)
            emitted.append(emit)
            # transfer the done mask once per decode_chunk, not per token
            if (t + 1) % sync == 0 and bool(done.all()):
                break
        self.steps = len(emitted)
        # margins[t] belongs to the logits that picked emitted token t
        self.margins = list(torch.stack(margins[:len(emitted)], dim=1
                                        ).cpu().numpy()[:B])
        if not emitted:
            return [np.zeros((0,), np.int32) for _ in range(B)]
        out = torch.stack(emitted, dim=1).cpu().numpy()   # one transfer
        seen = np.cumsum(out == scfg.eos_id, axis=1) > 0
        alldone = seen.all(axis=0)
        if alldone.any():
            out = out[:, : int(np.argmax(alldone)) + 1]
        return [out[i] for i in range(B)]


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree
