"""The FP4 matmul at the paper's quantization points (PyTorch), forward only.

Counterpart of ``repro.core.fqt``.  ``QuantConfig`` names the
``BlockQuantSpec`` (or None = bf16) at each of the six GEMM points; the
presets are the same data.  Slice 1 serves, so only the forward exists:

  * packed weights (``PackedQuantizedTensor``): z = Q_rtn(a) @ dequant(w)
    through the K4 kernel ``packed_block_matmul`` (its plain version on
    the CPU) -- the quantize-once serving path;
  * unpacked weights under an enabled config: fake-quant of both operands
    (RtN) and an f32-accumulating matmul;
  * bf16: ``torch.matmul`` with f32 accumulation.

The training autograd ``Function`` (backward and update GEMMs, SR from
``counter_bits``) arrives with the training slice (ROADMAP Queue 1).
There is no jnp/pallas switch: on the card the packed GEMM is the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional

import torch

from repro_torch.core.quantize import (MXFP4, NVFP4, BlockQuantSpec,
                                       PackedQuantizedTensor, fake_quant)

POINTS = ("fwd_w", "fwd_a", "bwd_w", "bwd_g", "upd_g", "upd_a")
PAPER_SR_POINTS: FrozenSet[str] = frozenset({"bwd_g", "upd_g", "upd_a"})
_TRAINING = ("the FQT backward arrives with the training slice (ROADMAP "
             "Queue 1: K1 fused_quant_matmul and the autograd Function)")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Which BlockQuantSpec (or None = keep bf16) applies at each point."""

    fwd_w: Optional[BlockQuantSpec] = None
    fwd_a: Optional[BlockQuantSpec] = None
    bwd_w: Optional[BlockQuantSpec] = None
    bwd_g: Optional[BlockQuantSpec] = None
    upd_g: Optional[BlockQuantSpec] = None
    upd_a: Optional[BlockQuantSpec] = None

    @property
    def enabled(self) -> bool:
        return any(getattr(self, p) is not None for p in POINTS)


def bf16_config() -> QuantConfig:
    """BF16 baseline: no quantization anywhere."""
    return QuantConfig()


def fqt_config(base: BlockQuantSpec = NVFP4,
               sr_points: FrozenSet[str] = PAPER_SR_POINTS) -> QuantConfig:
    """Full FQT of all six points; ``sr_points`` use SR, the rest RtN."""
    return QuantConfig(**{p: base.with_rounding(stochastic=(p in sr_points))
                          for p in POINTS})


def nvfp4_paper_config() -> QuantConfig:
    """The paper's scheme: NVFP4 everywhere, split rounding (eqs. 4-6)."""
    return fqt_config(NVFP4, PAPER_SR_POINTS)


def mxfp4_config() -> QuantConfig:
    return fqt_config(MXFP4, PAPER_SR_POINTS)


def qaf_config() -> QuantConfig:
    """Quantization-aware finetuning: FP4 forward, BF16 backward+update
    (the serving default)."""
    return QuantConfig(fwd_w=NVFP4, fwd_a=NVFP4)


def _if_divisible(spec: Optional[BlockQuantSpec], dim: int):
    """Quantization applies only when the contraction dim is
    block-divisible; otherwise that GEMM stays bf16."""
    if spec is not None and dim % spec.block != 0:
        return None
    return spec


def _forward_spec(spec: Optional[BlockQuantSpec]):
    if spec is not None and spec.stochastic:
        raise NotImplementedError("SR in the forward: " + _TRAINING)
    return spec


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation (bf16 operands are exact in f32)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _packed_forward(x: torch.Tensor, w: PackedQuantizedTensor,
                    cfg: QuantConfig) -> torch.Tensor:
    """z = Q_rtn(a) @ dequant(w_packed): only the activation is quantized
    per GEMM, its tensor scale over the whole (B*S, K) activation."""
    from repro_torch.kernels.fp4_matmul import packed_matmul
    K, N = w.shape
    fwd_a = _forward_spec(_if_divisible(cfg.fwd_a, K))
    if fwd_a is None:
        y = _matmul_f32(x, w.dequant())
        return y.to(x.dtype)
    y = packed_matmul(x.reshape(-1, K).contiguous(), w, fwd_a,
                      out_dtype=x.dtype)
    return y.reshape(tuple(x.shape[:-1]) + (N,))


def fp4_matmul(x: torch.Tensor, w, *, cfg: QuantConfig) -> torch.Tensor:
    """Forward FQT matmul (..., K) @ (K, N) -> (..., N)."""
    if w.ndim != 2:
        raise ValueError(f"weight must be 2D, got {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if isinstance(w, PackedQuantizedTensor):
        return _packed_forward(x, w, cfg)
    if not cfg.enabled:
        return _matmul_f32(x, w).to(x.dtype)
    K = w.shape[0]
    fwd_a = _forward_spec(_if_divisible(cfg.fwd_a, K))
    fwd_w = _forward_spec(_if_divisible(cfg.fwd_w, K))
    qx = x if fwd_a is None else fake_quant(x, fwd_a, axis=-1)
    qw = w if fwd_w is None else fake_quant(w, fwd_w, axis=0)
    return _matmul_f32(qx, qw).to(x.dtype)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
          cfg: QuantConfig) -> torch.Tensor:
    """Linear layer through the FP4 matmul (bias added in x's dtype)."""
    y = fp4_matmul(x, w, cfg=cfg)
    if b is not None:
        y = y + b
    return y
