"""Generic low-precision floating-point formats and quantizers (PyTorch).

The PyTorch counterpart of ``repro.core.formats``: the same ``FloatFormat``
table and the same grid-exact quantizers, so that every code and scale the
port produces equals the reference bit for bit.

  * E2M1 (FP4 data): no NaN/Inf, saturating, max 6.0.
  * E4M3 (NVFP4 scale): OCP e4m3fn, max 448.
  * E8M0 (MXFP4 scale): unsigned exponent-only.

RtN rounds half to even (``torch.round``).  Powers of two are built from
their bit patterns, never with ``pow``/``exp2``, whose results are not
guaranteed exact on every device.  ``counter_bits`` is the reference's
splitmix32 hash of (seed, flat index), the SR stream of the training GEMMs,
held bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A generic signed/unsigned minifloat format with subnormals."""

    name: str
    exp_bits: int
    man_bits: int
    signed: bool = True
    bias: Optional[int] = None
    finite_max: Optional[float] = None

    @property
    def ebias(self) -> int:
        if self.bias is not None:
            return self.bias
        return (1 << (self.exp_bits - 1)) - 1 if self.exp_bits > 0 else 0

    @property
    def emax(self) -> int:
        """Largest normal exponent (of the leading bit)."""
        if self.finite_max is not None:
            return int(np.floor(np.log2(self.finite_max)))
        return (1 << self.exp_bits) - 1 - self.ebias

    @property
    def emin(self) -> int:
        """Smallest normal exponent; subnormal ulp is 2^(emin - man_bits)."""
        return 1 - self.ebias

    @property
    def max(self) -> float:
        if self.finite_max is not None:
            return self.finite_max
        return float(2.0 ** self.emax * (2.0 - 2.0 ** (-self.man_bits)))


E2M1 = FloatFormat("e2m1", exp_bits=2, man_bits=1, finite_max=6.0)
E4M3 = FloatFormat("e4m3", exp_bits=4, man_bits=3, finite_max=448.0)
E8M0 = FloatFormat("e8m0", exp_bits=8, man_bits=0, signed=False,
                   finite_max=float(2.0 ** 127))
BF16 = FloatFormat("bf16", exp_bits=8, man_bits=7, finite_max=float(
    2.0 ** 127 * (2.0 - 2.0 ** -7)))
E3M4 = FloatFormat("e3m4", exp_bits=3, man_bits=4, finite_max=15.5)

FORMATS = {f.name: f for f in (E2M1, E3M4, E4M3, E8M0, BF16)}


def get_format(name: str) -> FloatFormat:
    try:
        return FORMATS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown float format {name!r}; have {sorted(FORMATS)}")


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for integer e in [-149, 127], from the bit pattern
    (subnormal results through a normal value times 2^-24)."""
    e = e.to(torch.int32)
    normal = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    sub = ((e.clamp(-149, -103) + 151) << 23).view(torch.float32) \
        * (2.0 ** -24)
    return torch.where(e < -126, sub, normal)


def _ulp(absx: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Grid spacing at |x|: 2^(clip(floor(log2 |x|), emin, emax) - M).
    Exact powers of two belong to the upper binade (frexp)."""
    _, k = torch.frexp(absx)
    e = torch.clamp(k - 1, fmt.emin, fmt.emax)
    return pow2(e - fmt.man_bits)


def quantize_rtn(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Round-to-nearest-even onto fmt's grid, saturating at fmt.max.
    The sign follows ``jnp.sign`` (which keeps -0.0), hence ``copysign``."""
    orig_dtype = x.dtype
    x = x.to(torch.float32)
    absx = torch.clamp(torch.abs(x), max=fmt.max)
    ulp = _ulp(absx, fmt)
    q = torch.round(absx / ulp) * ulp
    q = torch.clamp(q, max=fmt.max)
    out = torch.copysign(q, x)
    if not fmt.signed:                    # jnp.maximum(-0.0, 0.0) is +0.0
        out = torch.where(out > 0, out, torch.zeros_like(out))
    return out.to(orig_dtype)


def quantize_sr_with_u(x: torch.Tensor, fmt: FloatFormat,
                       u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding with explicit uniforms u in [0, 1):
    floor(|x|/ulp + u) * ulp, saturating."""
    orig_dtype = x.dtype
    x = x.to(torch.float32)
    absx = torch.clamp(torch.abs(x), max=fmt.max)
    ulp = _ulp(absx, fmt)
    q = torch.floor(absx / ulp + u) * ulp
    q = torch.clamp(q, max=fmt.max)
    out = torch.copysign(q, x)
    if not fmt.signed:                    # jnp.maximum(-0.0, 0.0) is +0.0
        out = torch.where(out > 0, out, torch.zeros_like(out))
    return out.to(orig_dtype)


def uniform_from_bits(rbits: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (held in int64 or uint32) -> uniform [0, 1)
    float32 at 24-bit resolution: (bits >> 8) * 2^-24."""
    hi = (rbits.to(torch.int64) & 0xFFFFFFFF) >> 8
    return hi.to(torch.float32) * (2.0 ** -24)


def e8m0_floor(x: torch.Tensor) -> torch.Tensor:
    """Largest power of two <= x (x > 0), clipped to the E8M0 range."""
    x = x.to(torch.float32)
    _, k = torch.frexp(x)
    e = torch.clamp(k - 1, -127, 127)
    return pow2(e)


M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for int64 z in [0, 2^32): the product is split at
    bit 16 so no partial product reaches int64's sign bit (a full 32 x 32
    bit product would overflow it)."""
    lo = (z & 0xFFFF) * c                        # < 2^48
    hi = ((z >> 16) * c) & 0xFFFF                # only 16 bits survive << 16
    return (lo + (hi << 16)) & M32


def counter_bits(seed: int, shape: Sequence[int],
                 device=None) -> torch.Tensor:
    """Counter-based random bits: the splitmix32-style hash of (seed, flat
    index) of ``repro.core.formats.counter_bits``, bit for bit.

    Returns int32 holding the uint32 patterns (``uniform_from_bits`` and the
    kernels read them as uint32)."""
    n = math.prod(int(d) for d in shape)
    return counter_bits_at(seed, torch.arange(
        n, dtype=torch.int64, device=device)).reshape(
            tuple(int(d) for d in shape))


def counter_at(seed: int, off: int) -> int:
    """The seed whose ``counter_bits`` stream starts ``off`` places into
    ``seed``'s: ``counter_bits`` hashes ``index * 0x9E3779B9 + seed``
    (mod 2^32) before its mixing, so ``counter_bits(counter_at(seed,
    off))[i] == counter_bits(seed)[i + off]``.  A shard whose element (r,
    c) sits at the global flat index ``r * row_stride + c * col_stride +
    off`` therefore draws the whole tensor's bits with the counter
    ``(counter_at(seed, off), row_stride, col_stride)``."""
    return (int(seed) + int(off) * 0x9E3779B9) & M32


def counter_bits_at(seed: int, index: torch.Tensor) -> torch.Tensor:
    """``counter_bits`` of ``seed`` at the given int64 indices in [0, 2^32),
    as int32 of index's shape: what K1's counter mode hashes in the kernel.

    Computed in int64 holding uint32 values: every product goes through
    ``_mul32`` (masked to 32 bits) and every value is masked before it is
    shifted right, since torch's ``>>`` on int64 is arithmetic."""
    z = _mul32(index, 0x9E3779B9)
    del index         # a temporary index (counter_bits' arange) goes here
    z = (z + (int(seed) & M32)) & M32
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    z = z ^ (z >> 16)
    # second mix round decorrelates consecutive indices fully
    z = (z + 0x9E3779B9) & M32
    z = _mul32(z ^ (z >> 15), 0x2C1B3C6D)
    z = _mul32(z ^ (z >> 12), 0x297A2D39)
    z = z ^ (z >> 15)
    z = z - ((z >> 31) << 32)                    # uint32 pattern as int32
    return z.to(torch.int32)
