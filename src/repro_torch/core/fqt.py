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

On a multi-rank mesh (``distributed/``) an unpacked weight is this rank's
shard and ``_ShardedFP4Matmul`` computes, on it, what ``_FP4Matmul``
computes on the whole weight (the training mesh; see its docstring).
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
    """The FQT matmul on this rank's shard of a weight of sharding rule
    ``kind`` ("io", "oi", "d_vocab"; ``distributed/sharding.py``) under a
    multi-rank ``mesh``: column-parallel where the rule splits N over
    "model", row-parallel where it splits K, the "data" (FSDP) split
    gathered first.  A packed weight is served through ``tp_fp4_matmul``
    (forward only); an unpacked one is trained through
    ``_ShardedFP4Matmul``."""
    from repro_torch.distributed.sharding import weight_kind
    k_ax, n_ax = weight_kind(kind, mesh)
    if not isinstance(w, PackedQuantizedTensor):
        return _ShardedFP4Matmul.apply(x, w, seed, cfg,
                                       _ShardLayout(mesh, k_ax, n_ax))
    from repro_torch.kernels.fp4_matmul import tp_fp4_matmul
    return tp_fp4_matmul(x, w, cfg=cfg, mesh=mesh, seed=seed,
                         parallel="row" if k_ax == "model" else "column",
                         gather_axis="data" if "data" in (k_ax, n_ax)
                         else None,
                         gather_dim=0 if k_ax == "data" else -1)


# ---- the training mesh: the FQT matmul on shards ----------------------------------
#
# Under GSPMD the reference's sharded step computes the 1-device function,
# so the port's is held to ``_FP4Matmul`` on the whole operands.  Per GEMM
# of the three, each operand is a shard of a global tensor:
#
#   x (M, K): rows over the DP axes ("pod", "data"); K over "model" for a
#     row-parallel weight.  w (K, N): N ("io", "d_vocab": column) or K
#     ("oi": row) over "model", the other dim over "data" (FSDP: gathered
#     in bf16 just before the GEMM, freed after).  g (M, N) as x's rows and
#     the output's columns.
#
# and the shard quantizes as the whole operand does: its tensor scale from
# the GLOBAL |max| (all-reduced MAX over the axes that shard it, K1's
# ``a_amax`` / ``b_amax``), its SR bits the whole operand's
# (``formats.counter_at`` of its first global flat index), its blocks the
# whole operand's (every split of a blocked axis falls on a block
# boundary, else ``ValueError``; the block rule ``_if_divisible`` is
# decided on the global dims, as the reference decides it).
#
# A contraction split over "model" (the row forward, the column dX: the
# Megatron pair's collective) sums the ranks' f32 partial products in one
# all-reduce, then rounds once to the output dtype; the ranks' GEMMs run in
# parallel.  The sum is the 1-device GEMM's up to the order of its f32
# additions, and at llama2-7b's width that order matters: the training
# GEMMs' operands span many binades (the logits' gradient over 32000
# columns), one ulp flips a bf16 rounding, and the next GEMM's FP4
# re-quantization turns it into flipped codes that grow through the
# backward.  The sharded step is therefore another draw of the same noise
# as the 1-device step, not its bits (``chip_smoke.py`` phase
# ``train_mesh`` holds it to the spread between two SR streams).  The
# token axis is summed for dW in f32 over the DP axes: a reduce-scatter
# onto this rank's FSDP shard (over "data") and an all-reduce over "pod"
# (``sharding.grad_sum_axes``: a step that compresses the pods'
# all-reduce sums "data" only and averages the pods after,
# ``distributed/compression.pod_mean_grads``); dW is a leaf, so its
# partial sums' order moves its last bits only.


class _ShardLayout:
    """The static facts of one sharded GEMM: the weight's split axes (from
    ``sharding.weight_kind``), this rank's coordinates, the DP axes.

    ``rows_whole``: x's rows are the whole operand's on every rank (the
    moe layer's "replicated" dispatch route, or a serving mesh), not this
    rank's share of them: no DP axis in the row maxima, ``row0`` 0, and
    dW, computed whole on every rank, is neither summed over the DP axes
    nor reduce-scattered but cut to this rank's FSDP shard."""

    def __init__(self, mesh, k_ax, n_ax, rows_whole: bool = False):
        self.mesh = mesh
        self.row = k_ax == "model"           # K split over "model"
        self.fsdp_dim = 0 if k_ax == "data" else 1 if n_ax == "data" \
            else None
        self.tp = mesh.axis_size("model")
        self.r = mesh.axis_index("model")
        self.rows_whole = rows_whole
        self.dp = () if rows_whole else tuple(
            a for a in ("pod", "data") if mesh.axis_size(a) > 1)
        from repro_torch.distributed.sharding import grad_sum_axes
        self.sum_axes = () if rows_whole else grad_sum_axes(mesh)
        self.dp_size = mesh.axes_size(self.dp)
        self.dp_index = mesh.axes_index(self.dp)
        self.model = ("model",) if self.tp > 1 else ()

    def gather(self, w: torch.Tensor) -> torch.Tensor:
        if self.fsdp_dim is None:
            return w
        return self.mesh.all_gather(w, "data", dim=self.fsdp_dim,
                                    op="fsdp_gather")

    def fsdp_slice(self, dw: torch.Tensor) -> torch.Tensor:
        """This rank's FSDP shard of a whole dW (``rows_whole``)."""
        if self.fsdp_dim is None:
            return dw
        n = dw.shape[self.fsdp_dim] // self.mesh.axis_size("data")
        return dw.narrow(self.fsdp_dim, self.mesh.axis_index("data") * n,
                         n).contiguous()

    def amax(self, t: torch.Tensor, spec, axes) -> Optional[torch.Tensor]:
        """The global |max| of ``t`` over ``axes`` (K1's a_amax/b_amax),
        or None where K1's own pass gives it (no split, or no tensor
        scale)."""
        if spec is None or not spec.two_level or not axes:
            return None
        m = torch.amax(torch.abs(t)).to(torch.float32).reshape(1)
        return self.mesh.all_reduce(m, axes, op="max")


def _check_split(spec, local: int, what: str):
    if spec is not None and local % spec.block:
        raise ValueError(
            f"{what}: the shard's {local} rows/columns on the blocked axis "
            f"are no multiple of the block {spec.block}, so a block would "
            f"straddle two ranks")


def _shard_gemm(lay: _ShardLayout, a, b, spec_a, spec_b, seed, sites,
                ctr_a, ctr_b, amax_a, amax_b, out_dtype, k_glob: int,
                split: bool = False):
    """One GEMM of shards: K1 with the given global maxima and offset
    counters ``ctr_* = (offset, row_stride, col_stride)`` of each operand's
    bits in the whole operand's ``counter_bits`` stream, or the f32 product
    where the GEMM stays bf16.  ``split``: the contraction is split over
    "model": the ranks' f32 partial products are all-reduced, then rounded
    to ``out_dtype``."""
    if spec_a is None and spec_b is None:
        y = _matmul_f32(a, b)
        if split:
            y = lay.mesh.all_reduce(y, "model")
        return y.to(out_dtype)
    if not _use_k1(spec_a, spec_b, k_glob):
        raise NotImplementedError(
            "a GEMM quantizing one operand only, or its operands in two "
            "block sizes, on a multi-rank mesh (the presets quantize both "
            "or neither)")
    from repro_torch.kernels.fp4_matmul import fused_quant_matmul

    def counter(spec, site, c):
        if not spec.stochastic:
            return None
        off, rs, cs = c
        return (formats.counter_at(_site_seed32(seed, site), off), rs, cs)

    y = fused_quant_matmul(
        a.contiguous(), b.contiguous(), spec_a, spec_b,
        out_dtype=torch.float32 if split else out_dtype,
        a_counter=counter(spec_a, sites[0], ctr_a),
        b_counter=counter(spec_b, sites[1], ctr_b), a_amax=amax_a,
        b_amax=amax_b)
    if not split:
        return y
    return lay.mesh.all_reduce(y, "model").to(out_dtype)


class _ShardedFP4Matmul(torch.autograd.Function):
    """``_FP4Matmul`` on this rank's shards (see the comment above): x
    (..., K or K/tp), w this rank's shard, the output (..., N/tp) for a
    column-parallel weight and (..., N) for a row-parallel one."""

    @staticmethod
    def forward(ctx, x, w, seed: int, cfg: QuantConfig, lay: _ShardLayout):
        K_t, N_t = w.shape
        if lay.fsdp_dim is not None:          # the shape after the gather
            K_t, N_t = ((K_t * lay.mesh.axis_size("data"), N_t)
                        if lay.fsdp_dim == 0 else
                        (K_t, N_t * lay.mesh.axis_size("data")))
        if x.shape[-1] != K_t:
            raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                             f"({K_t}, {N_t})")
        K = K_t * lay.tp if lay.row else K_t
        N = N_t if lay.row else N_t * lay.tp
        M_loc = x.numel() // K_t
        M = M_loc * lay.dp_size
        specs = {"fwd_a": _if_divisible(cfg.fwd_a, K),
                 "fwd_w": _if_divisible(cfg.fwd_w, K),
                 "bwd_g": _if_divisible(cfg.bwd_g, N),
                 "bwd_w": _if_divisible(cfg.bwd_w, N),
                 "upd_a": _if_divisible(cfg.upd_a, M),
                 "upd_g": _if_divisible(cfg.upd_g, M)}
        # every blocked axis this rank holds a part of splits on a block
        # boundary (checked before any collective)
        if lay.row:
            _check_split(specs["fwd_a"], K_t, "forward K")
        else:
            _check_split(specs["bwd_g"], N_t, "backward dX N")
        _check_split(specs["upd_a"], M_loc, "update dW tokens")
        wg = lay.gather(w)
        row0 = lay.dp_index * M_loc
        kx0 = lay.r * K_t if lay.row else 0
        nw0 = 0 if lay.row else lay.r * N_t
        x2 = x.reshape(M_loc, K_t)
        fa, fw = specs["fwd_a"], specs["fwd_w"]
        amax_x = lay.amax(x2, fa, lay.dp + (lay.model if lay.row else ()))
        y = _shard_gemm(lay, x2, wg, fa, fw, seed, (0, 1),
                        (row0 * K + kx0, K, 1), (kx0 * N + nw0, N, 1),
                        amax_x, lay.amax(wg, fw, lay.model), x.dtype, K,
                        split=lay.row)
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.lay, ctx.specs = seed, lay, specs
        ctx.dims = (M, K, N, row0, kx0, nw0)
        ctx.amax_x = amax_x
        return y.reshape(tuple(x.shape[:-1]) + (N_t,))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        lay, sp, seed = ctx.lay, ctx.specs, ctx.seed
        M, K, N, row0, kx0, nw0 = ctx.dims
        wg = lay.gather(w)
        K_t, N_t = wg.shape
        M_loc = x.numel() // K_t
        x2 = x.reshape(M_loc, K_t)
        g2 = g.to(x.dtype).reshape(M_loc, N_t)
        ng0 = nw0
        g_axes = lay.dp + (() if lay.row else lay.model)
        amax_g = {}

        def g_amax(spec):
            key = spec is not None and spec.two_level
            if key not in amax_g:
                amax_g[key] = lay.amax(g2, spec, g_axes)
            return amax_g[key]

        dx = dw = None
        if ctx.needs_input_grad[0]:
            bg, bw = sp["bwd_g"], sp["bwd_w"]
            dx = _shard_gemm(lay, g2, wg.T, bg, bw, seed, (2, 3),
                             (row0 * N + ng0, N, 1), (nw0 * K + kx0, K, 1),
                             g_amax(bg), lay.amax(wg, bw, lay.model),
                             x.dtype, N, split=not lay.row)
            dx = dx.reshape(x.shape)
        if ctx.needs_input_grad[1]:
            ua, ug = sp["upd_a"], sp["upd_g"]
            amax_x = ctx.amax_x
            if ua is not None and ua.two_level and (
                    sp["fwd_a"] is None or not sp["fwd_a"].two_level):
                amax_x = lay.amax(x2, ua,
                                  lay.dp + (lay.model if lay.row else ()))
            summed = not lay.rows_whole and (bool(lay.sum_axes)
                                             or lay.fsdp_dim is not None)
            dw = _shard_gemm(lay, x2.T, g2, ua, ug, seed, (4, 5),
                             (row0 * K + kx0, 1, K), (row0 * N + ng0, N, 1),
                             amax_x if ua is not None else None, g_amax(ug),
                             torch.float32 if summed else w.dtype, M)
            if lay.rows_whole:
                dw = lay.fsdp_slice(dw)
            elif lay.fsdp_dim is not None:
                dw = lay.mesh.reduce_scatter(dw, "data", dim=lay.fsdp_dim)
            elif "data" in lay.sum_axes:
                dw = lay.mesh.all_reduce(dw, "data")
            if "pod" in lay.sum_axes:
                dw = lay.mesh.all_reduce(dw, "pod")
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None


def fp4_matmul(x: torch.Tensor, w, *, cfg: QuantConfig,
               seed: Optional[int] = None, mesh=None,
               kind: Optional[str] = None) -> torch.Tensor:
    """FQT matmul (..., K) @ (K, N) -> (..., N) per the paper's scheme.

    ``seed``: the uint32 SR seed of this call (a Python int; the layer and
    step seeds of ``models.layers.QCtx``).  ``mesh`` and ``kind``: ``w``
    is this rank's shard of a weight of sharding rule ``kind`` under a
    multi-rank mesh (``_sharded_forward``: packed, the serving mesh;
    unpacked, the training mesh); a 1-rank mesh, or no kind, is the
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
