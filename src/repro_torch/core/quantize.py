"""Block (micro-scaled) quantization: NVFP4, MXFP4, packed storage (PyTorch).

The counterpart of ``repro.core.quantize``.  Per contiguous block of
``block`` elements along the blocking axis a tensor stores E2M1 codes and
one scale (E4M3 for NVFP4, E8M0 for MXFP4); NVFP4 adds one power-of-two
tensor scale, so ``codes * block_scale * tensor_scale`` is exact in bf16.
Every function here reproduces the reference's codes, scales and packed
bytes bit for bit (``tests/test_torch_quant.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import formats
from repro_torch.core.formats import FloatFormat, get_format


@dataclasses.dataclass(frozen=True)
class BlockQuantSpec:
    """How to block-quantize one GEMM operand."""

    data_fmt: str = "e2m1"
    scale_fmt: str = "e4m3"
    block: int = 16
    two_level: bool = True
    stochastic: bool = False

    @property
    def data(self) -> FloatFormat:
        return get_format(self.data_fmt)

    @property
    def scale(self) -> FloatFormat:
        return get_format(self.scale_fmt)

    def with_rounding(self, stochastic: bool) -> "BlockQuantSpec":
        return dataclasses.replace(self, stochastic=stochastic)


NVFP4 = BlockQuantSpec(data_fmt="e2m1", scale_fmt="e4m3", block=16,
                       two_level=True)
MXFP4 = BlockQuantSpec(data_fmt="e2m1", scale_fmt="e8m0", block=32,
                       two_level=False)


class QuantizedTensor(NamedTuple):
    """codes * scales (block-broadcast) * tscale reconstructs the tensor."""

    codes: torch.Tensor
    scales: torch.Tensor
    tscale: torch.Tensor
    axis: int
    block: int

    def dequant(self) -> torch.Tensor:
        s = torch.repeat_interleave(self.scales, self.block, dim=self.axis)
        return (self.codes * s * self.tscale).to(self.codes.dtype)


def _blocked(x: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Reshape so the blocking axis becomes (..., nblocks, block, ...)."""
    axis = axis % x.ndim
    if x.shape[axis] % block != 0:
        raise ValueError(
            f"axis {axis} of shape {tuple(x.shape)} not divisible by block "
            f"{block}")
    shape = (tuple(x.shape[:axis]) + (x.shape[axis] // block, block)
             + tuple(x.shape[axis + 1:]))
    return x.reshape(shape)


def _block_scales(absmax: torch.Tensor, spec: BlockQuantSpec,
                  tscale: torch.Tensor) -> torch.Tensor:
    """Quantized per-block scales from per-block absmax (f32 in/out)."""
    if spec.scale_fmt == "e8m0":
        scale = formats.e8m0_floor(absmax) / (2.0 ** spec.data.emax)
        return torch.where(absmax > 0, scale, torch.ones_like(scale))
    raw = absmax / (spec.data.max * tscale)
    scale = formats.quantize_rtn(raw, spec.scale)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _tensor_scale(x_abs_max: torch.Tensor, spec: BlockQuantSpec
                  ) -> torch.Tensor:
    """Power-of-two tensor scale 2^ceil(log2(amax / (6 * 448))), 1 for a
    zero tensor.  Stays on the device: no host sync."""
    x_abs_max = x_abs_max.to(torch.float32)
    one = torch.ones_like(x_abs_max)
    if not spec.two_level:
        return one
    raw = x_abs_max / (spec.data.max * spec.scale.max)
    _, k = torch.frexp(raw)                       # raw = m * 2^k, m in [.5,1)
    return torch.where(x_abs_max > 0, formats.pow2(k), one)


def block_quantize(x: torch.Tensor, spec: BlockQuantSpec, *, axis: int = -1,
                   u: Optional[torch.Tensor] = None,
                   seed: Optional[int] = None) -> QuantizedTensor:
    """Quantize x to (codes, scales, tscale) along ``axis``.  SR takes
    uniforms ``u`` of x's shape, or draws them from ``counter_bits(seed)``
    (threefry keys of the reference are not reproducible here).

    A bf16 or f32 CUDA tensor blocked along its last axis, RtN or SR from
    ``seed``, goes through K2 (``kernels/nvfp4_quant.block_quantize``) on
    its 2-D reshape, the SR bits hashed in the kernel in counter mode: the
    same codes, scales and tensor scale bit for bit, without drawing the
    bits tensor.  Everything else is the torch code below."""
    axis = axis % x.ndim
    if _takes_k2(x, spec, axis, u, seed):
        return _block_quantize_k2(x, spec, seed)
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    xb = _blocked(xf, axis, spec.block)
    baxis = axis + 1
    absmax = torch.amax(torch.abs(xb), dim=baxis)
    tscale = _tensor_scale(torch.amax(torch.abs(xf)), spec)
    scales = _block_scales(absmax, spec, tscale)
    denom = scales.unsqueeze(baxis) * tscale
    if spec.stochastic:
        if u is None:
            if seed is None:
                raise ValueError("stochastic rounding requires uniforms u "
                                 "or a counter_bits seed")
            u = formats.uniform_from_bits(
                formats.counter_bits(seed, x.shape, device=x.device))
        codes = formats.quantize_sr_with_u(
            xb / denom, spec.data,
            _blocked(u.to(torch.float32), axis, spec.block))
    else:
        codes = formats.quantize_rtn(xb / denom, spec.data)
    codes = codes.reshape(x.shape).to(orig_dtype)
    return QuantizedTensor(codes=codes, scales=scales.to(orig_dtype),
                           tscale=tscale, axis=axis, block=spec.block)


def _takes_k2(x: torch.Tensor, spec: BlockQuantSpec, axis: int,
              u: Optional[torch.Tensor], seed: Optional[int]) -> bool:
    """``block_quantize`` runs K2: a bf16 or f32 CUDA tensor blocked along
    its last axis (``axis`` already taken mod ndim), RtN or SR from a seed
    (K2 takes bits, not uniforms)."""
    return (x.device.type == "cuda" and axis == x.ndim - 1 and u is None
            and x.dtype in (torch.float32, torch.bfloat16)
            and (not spec.stochastic or seed is not None))


def _block_quantize_k2(x: torch.Tensor, spec: BlockQuantSpec,
                       seed: Optional[int]) -> QuantizedTensor:
    """``block_quantize`` along the last axis of a CUDA tensor through K2:
    the tensor scale as the torch code computes it (|x| and its max are
    exact in bf16, so no f32 copy is made), then K2 on the (-1, K) reshape
    with that scale given and, for SR, counter (seed, K, 1), which names
    ``counter_bits(seed, x.shape)``'s flat indices."""
    from repro_torch.kernels import nvfp4_quant    # the kernels import us
    K = x.shape[-1]
    tscale = _tensor_scale(torch.amax(torch.abs(x)), spec)
    counter = ((int(seed) & formats.M32, K, 1) if spec.stochastic
               else None)
    codes, scales = nvfp4_quant.block_quantize(
        x.contiguous().reshape(-1, K), spec, tscale=tscale, counter=counter)
    return QuantizedTensor(
        codes=codes.reshape(x.shape),
        scales=scales.reshape(tuple(x.shape[:-1]) + (K // spec.block,)
                              ).to(x.dtype),
        tscale=tscale, axis=x.ndim - 1, block=spec.block)


def fake_quant(x: torch.Tensor, spec: BlockQuantSpec, *, axis: int = -1,
               u: Optional[torch.Tensor] = None,
               seed: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize in one step."""
    return block_quantize(x, spec, axis=axis, u=u, seed=seed).dequant()


def scale_health(x: torch.Tensor, spec: BlockQuantSpec, *,
                 axis: int = -1, amax: Optional[torch.Tensor] = None,
                 counts: bool = False):
    """Block-scale saturation/underflow counts for telemetry.

    Replays ``_block_scales``' rounding on ``x`` (torch, on its device) and
    counts blocks whose raw scale exceeds the scale format's max (E4M3:
    448; the two-level tensor scale should make this impossible, so a
    nonzero count flags an overflowing tensor) and blocks whose nonzero
    absmax rounds to a zero scale (underflow: ``_block_scales`` clamps it
    to 1, quantizing the block to zero).  Returns plain ints: one host
    read, so call it outside a step.  ``amax``: the tensor scale's |max|
    where ``x`` is one rank's shard of a larger tensor (the global one);
    ``counts=True`` returns the three counts as an int64 device vector
    (blocks, saturated, underflow), with no host read: the training
    mesh's ``Trainer._scale_health`` sums it over the ranks."""
    axis = axis % x.ndim
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(_blocked(xf, axis, spec.block)),
                        dim=axis + 1)
    if spec.scale_fmt == "e8m0":
        scale = formats.e8m0_floor(absmax) / (2.0 ** spec.data.emax)
        saturated = torch.zeros((), dtype=torch.int64, device=x.device)
    else:
        tscale = _tensor_scale(torch.amax(torch.abs(xf)) if amax is None
                               else amax.reshape(()), spec)
        raw = absmax / (spec.data.max * tscale)
        scale = formats.quantize_rtn(raw, spec.scale)
        saturated = torch.sum(raw > spec.scale.max)
    underflow = torch.sum((scale <= 0) & (absmax > 0))
    if counts:
        return torch.stack([torch.full_like(underflow, absmax.numel()),
                            saturated, underflow])
    sat, under = torch.stack([saturated, underflow]).tolist()
    return {"blocks": absmax.numel(), "saturated": int(sat),
            "underflow": int(under)}


# ---- packed storage -------------------------------------------------------------

# E2M1 magnitudes indexed by the 3 low nibble bits (float4_e2m1fn layout)
E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


@functools.lru_cache(maxsize=None)
def _e2m1_grid(device: torch.device) -> torch.Tensor:
    """The grid as a tensor on ``device``, made once: building it per call
    is a pageable host-to-device copy, which waits for the whole stream."""
    return torch.tensor(E2M1_GRID, dtype=torch.float32, device=device)


def pack_e2m1(codes: torch.Tensor) -> torch.Tensor:
    """Pack E2M1 grid values into nibbles, two per uint8 along the last
    axis: column 2j is the LOW nibble of byte j; nibble = sign<<3 | index."""
    if codes.shape[-1] % 2:
        raise ValueError(f"last axis must be even to pack, got "
                         f"{tuple(codes.shape)}")
    cf = codes.to(torch.float32)
    grid = _e2m1_grid(codes.device)
    idx = torch.searchsorted(grid, torch.abs(cf).contiguous()).to(torch.uint8)
    sign = (cf < 0).to(torch.uint8)
    nib = (sign << 3) | idx
    return nib[..., 0::2] | (nib[..., 1::2] << 4)


def unpack_e2m1(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``pack_e2m1``: uint8 nibble pairs -> exact grid values."""
    grid = _e2m1_grid(packed.device)
    lo = (packed & 0x7).long()
    hi = ((packed >> 4) & 0x7).long()
    vlo = torch.where((packed & 0x8) != 0, -grid[lo], grid[lo])
    vhi = torch.where((packed & 0x80) != 0, -grid[hi], grid[hi])
    flat = torch.stack([vlo, vhi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)
    return flat.to(dtype)


@dataclasses.dataclass(frozen=True)
class PackedQuantizedTensor:
    """Quantize-once packed NVFP4 storage: nibble codes packed along the
    LAST axis, block scales (float8_e4m3fn for E4M3, else the source
    dtype) blocked along ``axis`` (negative), and the pow2 ``tscale``."""

    packed: torch.Tensor
    scales: torch.Tensor
    tscale: torch.Tensor
    axis: int
    block: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def shape(self):
        return tuple(self.packed.shape[:-1]) + (self.packed.shape[-1] * 2,)

    @property
    def ndim(self) -> int:
        return self.packed.ndim

    def nbytes(self) -> int:
        """Stored bytes (codes + scales + tscale)."""
        return int(self.packed.numel() * self.packed.element_size()
                   + self.scales.numel() * self.scales.element_size()
                   + self.tscale.numel() * 4)

    def wire_nbytes(self) -> int:
        """Bytes an FSDP-style all-gather of this tensor moves: the codes
        and block scales (~4.5 bits a parameter for NVFP4); the tensor
        scale is replicated and never travels."""
        return int(self.packed.numel() * self.packed.element_size()
                   + self.scales.numel() * self.scales.element_size())

    def dequant(self) -> torch.Tensor:
        """codes * block_scales * tscale, bit-identical to the fake-quant
        reconstruction of the same tensor."""
        dt = self.dtype
        codes = unpack_e2m1(self.packed, dtype=dt)
        s = torch.repeat_interleave(self.scales.to(dt), self.block,
                                    dim=self.axis)
        t = self.tscale.reshape(
            tuple(self.tscale.shape) + (1,) * (codes.ndim - self.tscale.ndim))
        return (codes * s * t).to(dt)


def _pack_scales(scales: torch.Tensor, spec: BlockQuantSpec) -> torch.Tensor:
    """E4M3 block scales are stored as float8 (exact: they lie on the grid)."""
    if spec.scale_fmt == "e4m3":
        return scales.to(torch.float8_e4m3fn)
    return scales


def pack_quantize(x: torch.Tensor, spec: BlockQuantSpec = NVFP4, *,
                  axis: int = -2, batch_dims: int = 0
                  ) -> PackedQuantizedTensor:
    """Quantize-once packing of a weight (RtN), optionally batched: the
    ``batch_dims`` leading axes are independent tensors with one tensor
    scale each."""
    if spec.data_fmt != "e2m1":
        raise ValueError("packed storage is E2M1-only")
    if spec.stochastic:
        raise ValueError("packed weight store is RtN (forward) only")
    nd = x.ndim
    ax = axis % nd
    if ax < batch_dims:
        raise ValueError(f"blocking axis {ax} inside batch dims {batch_dims}")
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    xb = _blocked(xf, ax, spec.block)
    absmax = torch.amax(torch.abs(xb), dim=ax + 1)
    red = tuple(range(batch_dims, nd))
    tmax = torch.amax(torch.abs(xf), dim=red) if red else torch.abs(xf)
    tscale = torch.broadcast_to(_tensor_scale(tmax, spec), tmax.shape)
    ts_b = tscale.reshape(tuple(tscale.shape)
                          + (1,) * (absmax.ndim - tscale.ndim))
    scales = _block_scales(absmax, spec, ts_b)
    denom = scales.unsqueeze(ax + 1) * ts_b.unsqueeze(ax + 1)
    codes = formats.quantize_rtn(xb / denom, spec.data)
    codes = codes.reshape(x.shape).to(orig_dtype)
    return PackedQuantizedTensor(
        packed=pack_e2m1(codes),
        scales=_pack_scales(scales.to(orig_dtype), spec),
        tscale=tscale.to(torch.float32).contiguous(),
        axis=ax - nd, block=spec.block, dtype=orig_dtype)


# ---- KV-cache row quantization ----------------------------------------------------
#
#   nvfp4: E2M1 nibble codes + one float8_e4m3fn scale per block (0.5625 B/elem)
#   fp8:   float8_e4m3fn codes + one bf16 scale per block        (1.125 B/elem)
#   bf16:  unquantized escape hatch (models/layers.KVCache)

KV_CACHE_FORMATS = ("bf16", "nvfp4", "fp8")


def kv_quant_rows(x: torch.Tensor, fmt: str, block: int = 16):
    """Quantize cache rows along the last (head) dim, RtN, no tensor scale.
    Returns (codes, scales) in storage dtypes."""
    if fmt not in ("nvfp4", "fp8"):
        raise ValueError(f"kv_quant_rows: unknown format {fmt!r}")
    e4m3 = formats.E4M3
    xf = x.to(torch.float32)
    xb = _blocked(xf, -1, block)
    absmax = torch.amax(torch.abs(xb), dim=-1)
    if fmt == "nvfp4":
        scales = formats.quantize_rtn(absmax / formats.E2M1.max, e4m3)
        scales = torch.where(scales > 0, scales, torch.ones_like(scales))
        codes = formats.quantize_rtn(xb / scales.unsqueeze(-1), formats.E2M1)
        return (pack_e2m1(codes.reshape(x.shape)),
                scales.to(torch.float8_e4m3fn))
    scales = torch.where(absmax > 0, absmax / e4m3.max,
                         torch.ones_like(absmax)).to(torch.bfloat16)
    codes = formats.quantize_rtn(
        xb / scales.to(torch.float32).unsqueeze(-1), e4m3)
    return codes.reshape(x.shape).to(torch.float8_e4m3fn), scales


def kv_dequant(codes: torch.Tensor, scales: torch.Tensor, fmt: str,
               block: int = 16, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``kv_quant_rows``: reconstruct (..., D) rows in ``dtype``."""
    if fmt == "nvfp4":
        vals = unpack_e2m1(codes, dtype=torch.float32)
    elif fmt == "fp8":
        vals = codes.to(torch.float32)
    else:
        raise ValueError(f"kv_dequant: unknown format {fmt!r}")
    s = torch.repeat_interleave(scales.to(torch.float32), block, dim=-1)
    return (vals * s).to(dtype)
