"""Arithmetic-only minifloat helpers: the plain PyTorch versions of the K0
helpers (``repro.kernels.common``) that the CUDA kernels carry as
``__device__`` functions in ``csrc/fp4_common.cuh``.

Everything works on float32 bit patterns (shifts, masks, rint, floor), so
the plain versions and the device versions compute the same bits; both are
held to ``repro.kernels.common`` and ``repro.core.formats`` bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.formats import FloatFormat


class FmtParams(NamedTuple):
    """Static per-format constants passed into kernels."""
    man_bits: int
    emin: int
    emax: int
    max: float

    @classmethod
    def of(cls, fmt: FloatFormat) -> "FmtParams":
        return cls(fmt.man_bits, fmt.emin, fmt.emax, fmt.max)


def _ulp_from_bits(a: torch.Tensor, p: FmtParams) -> torch.Tensor:
    """Grid spacing at a >= 0 (float32) from the exponent field:
    2^(clip(floor(log2 a), emin, emax) - man_bits)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    e = torch.clamp(e, p.emin, p.emax)
    return ((e - p.man_bits + 127) << 23).view(torch.float32)


def quantize_rtn_k(x: torch.Tensor, p: FmtParams) -> torch.Tensor:
    """Round-to-nearest-even onto the grid (float32 in/out), saturating."""
    a = torch.clamp(torch.abs(x), max=p.max)
    ulp = _ulp_from_bits(a, p)
    q = torch.round(a / ulp) * ulp
    return torch.copysign(torch.clamp(q, max=p.max), x)


def quantize_sr_k(x: torch.Tensor, p: FmtParams,
                  u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding with uniforms u in [0,1): floor(|x|/ulp + u)*ulp."""
    a = torch.clamp(torch.abs(x), max=p.max)
    ulp = _ulp_from_bits(a, p)
    q = torch.floor(a / ulp + u) * ulp
    return torch.copysign(torch.clamp(q, max=p.max), x)


def uniform_from_bits_k(rbits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (held in any integer dtype) -> [0,1) float32."""
    hi = (rbits.to(torch.int64) & 0xFFFFFFFF) >> 8
    return hi.to(torch.float32) * (2.0 ** -24)


def _decode_e2m1_nibble_k(nib: torch.Tensor) -> torch.Tensor:
    """4-bit E2M1 code (s eem) -> float32 grid value: normals assemble the
    f32 bit pattern (exponent e-1+127, mantissa bit 22 = m), subnormals are
    m * 0.5."""
    n = nib.to(torch.int32) & 0xF
    e = (n >> 1) & 0x3
    m = n & 0x1
    normal = (((e + 126) << 23) | (m << 22)).view(torch.float32)
    mag = torch.where(e == 0, m.to(torch.float32) * 0.5, normal)
    return torch.where((n & 0x8) != 0, -mag, mag)


def unpack_e2m1_k(packed: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs -> f32 E2M1 values, interleaved on the last axis."""
    lo = _decode_e2m1_nibble_k(packed & 0xF)
    hi = _decode_e2m1_nibble_k(packed >> 4)
    return torch.stack([lo, hi], dim=-1).reshape(
        tuple(packed.shape[:-1]) + (packed.shape[-1] * 2,))


def decode_e4m3_byte_k(byte: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn bit pattern (uint8) -> float32, arithmetic only:
    normals assemble the f32 bits (exponent e-7+127, mantissa m<<20),
    subnormals are m * 2^-9, 0x7F/0xFF are NaN."""
    b = byte.to(torch.int32) & 0xFF
    e = (b >> 3) & 0xF
    m = b & 0x7
    normal = (((e + 120) << 23) | (m << 20)).view(torch.float32)
    mag = torch.where(e == 0, m.to(torch.float32) * (2.0 ** -9), normal)
    mag = torch.where((b & 0x7F) == 0x7F, torch.full_like(mag, float("nan")),
                      mag)
    return torch.where((b & 0x80) != 0, -mag, mag)


def e8m0_block_scale_k(absmax: torch.Tensor, data_emax: int) -> torch.Tensor:
    """OCP MX rule: 2^(floor(log2 amax) - emax_elem); 1.0 for amax = 0."""
    bits = absmax.to(torch.float32).contiguous().view(torch.int32)
    e = torch.clamp(((bits >> 23) & 0xFF) - 127, -127, 127)
    p2 = ((e + 127) << 23).view(torch.float32)
    scale = p2 / (2.0 ** data_emax)
    return torch.where(absmax > 0, scale, torch.ones_like(scale))


def generic_block_scale_k(absmax: torch.Tensor, data_max: float,
                          scale_p: FmtParams,
                          tscale: torch.Tensor) -> torch.Tensor:
    """RtN block scale: Q_rtn(amax / (data_max * tscale)); 1.0 for zero."""
    raw = absmax / (data_max * tscale)
    scale = quantize_rtn_k(raw, scale_p)
    return torch.where(scale > 0, scale, torch.ones_like(scale))
