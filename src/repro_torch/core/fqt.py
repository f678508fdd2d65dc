"""The FQT matmul at the paper's six quantization points (PyTorch).

Counterpart of ``repro.core.fqt``.  ``QuantConfig`` names the
``BlockQuantSpec`` (or None = bf16) at each point; the presets are the same
data.  ``fp4_matmul`` is a ``torch.autograd.Function`` (the reference's
``custom_vjp``):

  [Forward]   z  = Q_rtn(a) @ Q_rtn(W)          points fwd_a, fwd_w
  [Backward]  dX = Q_sr(g) @ Q_rtn(W)^T         points bwd_g, bwd_w
  [Update]    dW = Q_sr(a)^T @ Q_sr(g)          points upd_a, upd_g

with blocks along each GEMM's contraction axis.  A GEMM whose two operands
are both quantized with one block size runs the K1 kernel
``fused_quant_matmul`` (its plain version on the CPU); otherwise it is
fake-quant + an f32-accumulating ``torch.matmul``, as the reference computes
outside Pallas (the reference's ``_use_pallas`` rule without its ``impl``
switch: on the card the FQT GEMM is the kernel).  SR bits come from
``formats.counter_bits`` of a per-site seed, so both packages draw the same
streams; K1 hashes them inside its quantizer (its counter mode) instead of
reading a drawn tensor.  Packed weights (``PackedQuantizedTensor``) take the serving path:
z = Q_rtn(a) @ dequant(w) through the K4 kernel, forward only.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional

import torch

from repro_torch.core import formats
from repro_torch.core.quantize import (MXFP4, NVFP4, BlockQuantSpec,
                                       PackedQuantizedTensor, fake_quant)

POINTS = ("fwd_w", "fwd_a", "bwd_w", "bwd_g", "upd_g", "upd_a")
PAPER_SR_POINTS: FrozenSet[str] = frozenset({"bwd_g", "upd_g", "upd_a"})


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


def wang2025_config() -> QuantConfig:
    """[21] Wang et al.: FP4 weights+activations (forward only), BF16 grads."""
    return QuantConfig(fwd_w=NVFP4, fwd_a=NVFP4, bwd_w=NVFP4)


def tseng2025_config() -> QuantConfig:
    """[19] Tseng et al.: MXFP4+SR neural gradients only, BF16 W/A."""
    sr = MXFP4.with_rounding(stochastic=True)
    return QuantConfig(bwd_g=sr, upd_g=sr)


# ---- seed plumbing -----------------------------------------------------------------

M32 = formats.M32      # uint32 arithmetic on Python ints


def _site_seed32(seed: int, site: int) -> int:
    """Per-quantization-site 32-bit counter seed from the layer/step seed
    (uint32 arithmetic of the reference, on Python ints)."""
    return ((int(seed) & M32) * 0x9E3779B1 & M32) ^ ((site * 0x7FB5D329) & M32)


def _site_bits(shape, seed: int, site: int, device=None) -> torch.Tensor:
    """SR random bits of a site: ``counter_bits`` of the site seed (int32
    holding the uint32 patterns); K1's counter mode hashes the identical
    stream in its quantizer."""
    return formats.counter_bits(_site_seed32(seed, site), shape,
                                device=device)


def _maybe_q(x: torch.Tensor, spec: Optional[BlockQuantSpec], axis: int,
             seed: int, site: int) -> torch.Tensor:
    if spec is None:
        return x
    u = (formats.uniform_from_bits(_site_bits(x.shape, seed, site, x.device))
         if spec.stochastic else None)
    return fake_quant(x, spec, axis=axis, u=u)


def _k1_gemm(a2d, b2d, spec_a, spec_b, seed, site_a, site_b, out_dtype,
             a_strides=None):
    """One K1 launch (blocks: a along axis 1, b along axis 0).  Transposed
    operands arrive as contiguous copies.  SR operands go in K1's counter
    mode: the kernel hashes ``_site_bits`` of the site itself, at strides
    (cols, 1) of the operand, or ``a_strides`` where a is the transpose of
    the array the bits were drawn for."""
    from repro_torch.kernels.fp4_matmul import fused_quant_matmul
    a2d, b2d = a2d.contiguous(), b2d.contiguous()
    ca = ((_site_seed32(seed, site_a),) + (a_strides or (a2d.shape[1], 1))
          if spec_a.stochastic else None)
    cb = ((_site_seed32(seed, site_b), b2d.shape[1], 1)
          if spec_b.stochastic else None)
    return fused_quant_matmul(a2d, b2d, spec_a, spec_b, out_dtype=out_dtype,
                              a_counter=ca, b_counter=cb)


def _use_k1(spec_a, spec_b, k_dim: int) -> bool:
    """The reference's ``_use_pallas`` without its ``impl`` test."""
    return (spec_a is not None and spec_b is not None
            and spec_a.block == spec_b.block and k_dim % spec_a.block == 0)


def _if_divisible(spec: Optional[BlockQuantSpec], dim: int):
    """Quantization applies only when the contraction dim is
    block-divisible; otherwise that GEMM stays bf16."""
    if spec is not None and dim % spec.block != 0:
        return None
    return spec


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation (bf16 operands are exact in f32)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _forward(x, w, seed: int, cfg: QuantConfig) -> torch.Tensor:
    """[Forward] z = Q_rtn(a) @ Q_rtn(W); blocks along K for both."""
    K, N = w.shape
    fwd_a = _if_divisible(cfg.fwd_a, K)
    fwd_w = _if_divisible(cfg.fwd_w, K)
    if _use_k1(fwd_a, fwd_w, K):
        y = _k1_gemm(x.reshape(-1, K), w, fwd_a, fwd_w, seed, 0, 1, x.dtype)
        return y.reshape(tuple(x.shape[:-1]) + (N,))
    qx = _maybe_q(x, fwd_a, axis=-1, seed=seed, site=0)
    qw = _maybe_q(w, fwd_w, axis=0, seed=seed, site=1)
    return _matmul_f32(qx, qw).to(x.dtype)


def _backward_dx(x, w, g, seed: int, cfg: QuantConfig) -> torch.Tensor:
    """[Backward] dX = Q_sr(g) @ Q_rtn(W)^T; contraction over N."""
    K, N = w.shape
    bwd_g = _if_divisible(cfg.bwd_g, N)
    bwd_w = _if_divisible(cfg.bwd_w, N)
    if _use_k1(bwd_g, bwd_w, N):
        return _k1_gemm(g.reshape(-1, N), w.T, bwd_g, bwd_w, seed, 2, 3,
                        x.dtype).reshape(x.shape)
    qg_b = _maybe_q(g, bwd_g, axis=-1, seed=seed, site=2)
    qw_b = _maybe_q(w, bwd_w, axis=1, seed=seed, site=3)  # blocks on N
    return _matmul_f32(qg_b, qw_b.T).to(x.dtype)


def _backward_dw(x, w, g, seed: int, cfg: QuantConfig) -> torch.Tensor:
    """[Update] dW = Q_sr(a)^T @ Q_sr(g); contraction over tokens M."""
    K, N = w.shape
    xf = x.reshape(-1, K)
    gf = g.reshape(-1, N)
    M = xf.shape[0]
    # a token count not divisible by the block keeps the update GEMM bf16
    upd_a = _if_divisible(cfg.upd_a, M)
    upd_g = _if_divisible(cfg.upd_g, M)
    if _use_k1(upd_a, upd_g, M):
        # x^T's bits are those drawn for x (M, K), as the fake-quant path
        # aligns them: element (k, m) of x^T takes index m * K + k
        dw = _k1_gemm(xf.T, gf, upd_a, upd_g, seed, 4, 5, w.dtype,
                      a_strides=(1, K))
    else:
        qx_u = _maybe_q(xf, upd_a, axis=0, seed=seed, site=4)
        qg_u = _maybe_q(gf, upd_g, axis=0, seed=seed, site=5)
        dw = _matmul_f32(qx_u.T, qg_u).to(w.dtype)
    return dw


class _FP4Matmul(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_fp4_matmul``: the backward
    differentiates the unquantized matmul and re-quantizes its operands
    (the straight-through estimator, eqs. 5-6)."""

    @staticmethod
    def forward(ctx, x, w, seed: int, cfg: QuantConfig):
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.cfg = seed, cfg
        return _forward(x, w, seed, cfg)

    @staticmethod
    def backward(ctx, g):
        """dX and dW of the reference's ``_bwd_rule`` (fqt.py:198-238),
        each only where autograd needs it (JAX drops the other under
        jit)."""
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = (_backward_dx(x, w, g, ctx.seed, ctx.cfg)
              if ctx.needs_input_grad[0] else None)
        dw = (_backward_dw(x, w, g, ctx.seed, ctx.cfg)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None, None


def _packed_forward(x: torch.Tensor, w: PackedQuantizedTensor, seed: int,
                    cfg: QuantConfig) -> torch.Tensor:
    """z = Q(a) @ dequant(w_packed): only the activation is quantized per
    GEMM, its tensor scale over the whole (B*S, K) activation.  Inference
    only (no autograd Function; serving never backprops)."""
    from repro_torch.kernels.fp4_matmul import packed_matmul
    K, N = w.shape
    fwd_a = _if_divisible(cfg.fwd_a, K)
    if fwd_a is not None and w.axis == -2 and fwd_a.block == w.block:
        rb = (_site_bits(x.shape, seed, 0, x.device).reshape(-1, K)
              if fwd_a.stochastic else None)
        y = packed_matmul(x.reshape(-1, K).contiguous(), w, fwd_a,
                          a_rbits=rb, out_dtype=x.dtype)
        return y.reshape(tuple(x.shape[:-1]) + (N,))
    qx = _maybe_q(x, fwd_a, axis=-1, seed=seed, site=0)
    return _matmul_f32(qx, w.dequant()).to(x.dtype)


def _sharded_forward(x: torch.Tensor, w, seed: int, cfg: QuantConfig,
                     mesh, kind: str) -> torch.Tensor:
    """The forward on this rank's shard of a weight of sharding rule
    ``kind`` ("io", "oi", "d_vocab"; ``distributed/sharding.py``) under a
    multi-rank ``mesh``: column-parallel where the rule splits N over
    "model", row-parallel where it splits K, the "data" (FSDP) split
    gathered first, through ``tp_fp4_matmul``.  The weight must be packed:
    an unpacked shard's fwd_w tensor scale would be the shard's, not the
    weight's."""
    from repro_torch.distributed.sharding import weight_kind
    from repro_torch.kernels.fp4_matmul import tp_fp4_matmul
    if not isinstance(w, PackedQuantizedTensor):
        raise NotImplementedError(
            "a multi-rank mesh serves packed weights (Engine(pack_weights="
            "True) under a config with fwd_w); unpacked GEMM weights are "
            "served on one rank")
    k_ax, n_ax = weight_kind(kind, mesh)
    return tp_fp4_matmul(x, w, cfg=cfg, mesh=mesh, seed=seed,
                         parallel="row" if k_ax == "model" else "column",
                         gather_axis="data" if "data" in (k_ax, n_ax)
                         else None,
                         gather_dim=0 if k_ax == "data" else -1)


def fp4_matmul(x: torch.Tensor, w, *, cfg: QuantConfig,
               seed: Optional[int] = None, mesh=None,
               kind: Optional[str] = None) -> torch.Tensor:
    """FQT matmul (..., K) @ (K, N) -> (..., N) per the paper's scheme.

    ``seed``: the uint32 SR seed of this call (a Python int; the layer and
    step seeds of ``models.layers.QCtx``).  ``mesh`` and ``kind``: ``w``
    is this rank's shard of a weight of sharding rule ``kind`` under a
    serving mesh (``_sharded_forward``); a 1-rank mesh, or no kind, is the
    1-device matmul."""
    if mesh is not None and mesh.size > 1 and kind is not None:
        return _sharded_forward(x, w, 0 if seed is None else int(seed) & M32,
                                cfg, mesh, kind)
    if w.ndim != 2:
        raise ValueError(f"weight must be 2D, got {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    seed = 0 if seed is None else int(seed) & M32
    if isinstance(w, PackedQuantizedTensor):
        return _packed_forward(x, w, seed, cfg)
    if not cfg.enabled:
        return _matmul_f32(x, w).to(x.dtype)
    return _FP4Matmul.apply(x, w, seed, cfg)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
          cfg: QuantConfig, seed: Optional[int] = None, mesh=None,
          kind: Optional[str] = None) -> torch.Tensor:
    """Linear layer through the FP4 matmul (bias added in x's dtype; on a
    column-parallel shard, this rank's slice of it)."""
    y = fp4_matmul(x, w, cfg=cfg, seed=seed, mesh=mesh, kind=kind)
    if b is not None:
        y = y + b
    return y
