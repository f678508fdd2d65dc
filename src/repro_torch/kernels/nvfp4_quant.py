"""K2 ``block_quantize``: the standalone NVFP4/MXFP4 block quantizer.

Replaces ``repro/kernels/nvfp4_quant.py::block_quantize_pallas``; CUDA
source ``csrc/block_quantize.cu``.  A 2-D tensor is quantized along its
last axis: per block of ``spec.block`` values the absmax, a block scale
(E4M3/E3M4 RtN, or E8M0) and E2M1 codes (RtN, or SR from uint32 bits:
given as a tensor, or, port-internal, hashed in the kernel from a
``Counter`` as K1 does).  ``quant_blocks`` is that arithmetic in plain
PyTorch, shared with K1's and K4's plain versions (``fp4_matmul.py``).

On the card ``k2_route`` picks one of two kernels from static facts:
"vec" (16-byte lanes, a block's absmax reduced by warp shuffles) where a
block is a power-of-two number of 16-byte lanes and every pointer is
16-byte aligned, "scalar" (one thread per block) for anything else.
``core/quantize.block_quantize`` reaches K2 in counter mode for the
sigma_q probe of the train step.

The wrapper launches a kernel on CUDA tensors and takes its plain version
(``block_quantize_plain``) only for CPU tensors -- there is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import formats
from repro_torch.core.quantize import BlockQuantSpec, _tensor_scale
from repro_torch.kernels import common as c
from repro_torch.kernels import counters

NAME = "block_quantize"
_P = ctypes.c_void_p
_I = ctypes.c_int

# Counter mode of one SR operand (K1's and K2's): (seed32, row_stride,
# col_stride).  Element (r, c) takes formats.counter_bits(seed32) at the
# flat index r * row_stride + c * col_stride (mod 2^32): (cols, 1) is the
# operand's own counter_bits stream, (1, rows) that of its transpose.
Counter = Tuple[int, int, int]


def counter_rbits(shape, counter: Counter, device=None) -> torch.Tensor:
    """The bits counter mode hashes for an operand of ``shape`` (int32
    holding the uint32 patterns)."""
    seed, rs, cs = counter
    R, C = shape
    idx = (torch.arange(R, dtype=torch.int64, device=device)[:, None] * rs
           + torch.arange(C, dtype=torch.int64, device=device)[None, :] * cs)
    return formats.counter_bits_at(seed, idx & formats.M32)


def quant_blocks(xf: torch.Tensor, spec: BlockQuantSpec, ts: torch.Tensor,
                 rbits: Optional[torch.Tensor] = None) -> tuple:
    """(codes (R, C/B, B), scales (R, C/B)) of an f32 (R, C) tensor blocked
    along C under tensor scale ``ts``, in the TPU kernels' order of
    operations (nvfp4_quant.py:28-45): absmax -> block scale -> codes =
    Q(x / (scale * ts)).  SR reads uint32 ``rbits`` of xf's shape."""
    R, C = xf.shape
    B = spec.block
    xb = xf.reshape(R, C // B, B)
    absmax = torch.amax(torch.abs(xb), dim=-1)
    data_p = c.FmtParams.of(spec.data)
    if spec.scale_fmt == "e8m0":
        scales = c.e8m0_block_scale_k(absmax, data_p.emax)
    else:
        scales = c.generic_block_scale_k(absmax, data_p.max,
                                         c.FmtParams.of(spec.scale), ts)
    scaled = xb / (scales.unsqueeze(-1) * ts)
    if spec.stochastic:
        u = c.uniform_from_bits_k(rbits).reshape(R, C // B, B)
        codes = c.quantize_sr_k(scaled, data_p, u)
    else:
        codes = c.quantize_rtn_k(scaled, data_p)
    return codes, scales


def _check(x, spec, rbits, counter) -> tuple:
    if x.ndim != 2:
        raise ValueError(f"expected 2D input, got {tuple(x.shape)}")
    M, K = x.shape
    if K % spec.block:
        raise ValueError(f"K={K} not divisible by block={spec.block}")
    if counter is not None:
        if rbits is not None or len(counter) != 3:
            raise ValueError("counter is (seed32, row_stride, col_stride) "
                             "in place of rbits")
        if not spec.stochastic:
            raise ValueError("counter draws SR bits: the spec is RtN")
    elif spec.stochastic and (rbits is None
                              or tuple(rbits.shape) != (M, K)):
        raise ValueError("SR requires rbits with the same shape as x, or a "
                         "counter")
    return M, K


def block_quantize_plain(x: torch.Tensor, spec: BlockQuantSpec, *,
                         rbits: Optional[torch.Tensor] = None,
                         tscale: Optional[torch.Tensor] = None,
                         counter: Optional[Counter] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: (codes in x.dtype,
    f32 scales (M, K/block)).  Counter mode draws ``counter_rbits``."""
    M, K = _check(x, spec, rbits, counter)
    if counter is not None:
        rbits = counter_rbits((M, K), counter, x.device)
    xf = x.to(torch.float32)
    if tscale is None:
        ts = _tensor_scale(torch.amax(torch.abs(xf)), spec)
    else:
        ts = tscale.to(device=x.device, dtype=torch.float32).reshape(())
    codes, scales = quant_blocks(xf, spec, ts, rbits)
    return codes.reshape(M, K).to(x.dtype), scales


class _QuantParams(ctypes.Structure):
    """``fp4::QuantParams`` of csrc/fp4_common.cuh: one operand's spec."""
    _fields_ = [("data_man_bits", _I), ("data_emin", _I), ("data_emax", _I),
                ("data_max", ctypes.c_float), ("scale_man_bits", _I),
                ("scale_emin", _I), ("scale_emax", _I),
                ("scale_max", ctypes.c_float), ("e8m0", _I),
                ("two_level", _I), ("ts_denom", ctypes.c_float)]

    @classmethod
    @functools.lru_cache(maxsize=None)
    def of(cls, spec: BlockQuantSpec) -> "_QuantParams":
        """The constants of ``spec``, built once per spec (the kernels copy
        them at each launch)."""
        d, s = spec.data, spec.scale
        return cls(d.man_bits, d.emin, d.emax, d.max, s.man_bits, s.emin,
                   s.emax, s.max, int(spec.scale_fmt == "e8m0"),
                   int(spec.two_level), d.max * s.max)


class _SrBits(ctypes.Structure):
    """``fp4::SrBits`` of csrc/fp4_common.cuh: one operand's SR source."""
    _fields_ = [("rbits", _P), ("seed", ctypes.c_uint32),
                ("row_stride", ctypes.c_uint32),
                ("col_stride", ctypes.c_uint32), ("counter", _I)]


def rbits_ptr(name: str, rbits: torch.Tensor, dev: torch.device) -> int:
    """Device pointer of SR bits (int32 or uint32 holding the same 32-bit
    patterns), checked for what the kernels take."""
    if rbits.dtype not in (torch.int32, torch.uint32) \
            or not rbits.is_contiguous() or rbits.device != dev:
        raise ValueError(f"{name} must be contiguous 32-bit on {dev}")
    return rbits.data_ptr()


def sr_source(name: str, spec: BlockQuantSpec,
              rbits: Optional[torch.Tensor], counter: Optional[Counter],
              dev: torch.device) -> _SrBits:
    """The ``fp4::SrBits`` of one operand: none (RtN), its counter, or the
    pointer of its bits tensor."""
    if not spec.stochastic:
        return _SrBits(None, 0, 0, 0, 0)
    if counter is not None:
        seed, rs, cs = (int(v) & formats.M32 for v in counter)
        return _SrBits(None, seed, rs, cs, 1)
    return _SrBits(rbits_ptr(name, rbits, dev), 0, 0, 0, 0)


LANE_BYTES = 16          # one vector load or store of a "vec" lane


def k2_route(block: int, dtype: torch.dtype, aligned: bool) -> str:
    """K2's kernel on the card, from static facts: "vec" where a block of
    ``block`` values of ``dtype`` spans a power-of-two number of 16-byte
    lanes, at most 32 (f32 blocks of 4-128, bf16 of 8-256), and x, the
    codes and any bits tensor are 16-byte aligned (``aligned``); "scalar"
    for anything else."""
    nbytes = block * dtype.itemsize
    lanes = nbytes // LANE_BYTES
    if (aligned and nbytes % LANE_BYTES == 0 and 0 < lanes <= 32
            and lanes & (lanes - 1) == 0):
        return "vec"
    return "scalar"


def _lib():
    from repro_torch.kernels import _build
    fn = _build.library("block_quantize").fp4_block_quantize
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, ctypes.POINTER(_SrBits), _I, _I, _I,
                       ctypes.POINTER(_QuantParams), _P, _P, _P, _P, _I, _P]
        fn.restype = _I
    return fn


def block_quantize(x: torch.Tensor, spec: BlockQuantSpec, *,
                   rbits: Optional[torch.Tensor] = None,
                   tscale: Optional[torch.Tensor] = None,
                   counter: Optional[Counter] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a 2-D tensor along its last axis; returns (codes, scales).

    codes: x.shape in x.dtype, values on the E2M1 grid; scales: (M,
    K/block) f32; codes * repeat(scales) * tscale dequantizes.  ``tscale``
    is an f32 scalar tensor, or None for ``ref.tensor_scale_ref`` (1 when
    the spec is not two-level); on the card a computed one never leaves
    the device.  An SR spec takes exactly one of uint32 bits of x's shape
    (int32 or uint32 tensors holding the same patterns) and, port-internal,
    a ``Counter`` that the kernel hashes itself (``counter_rbits`` gives
    the same bits).
    """
    M, K = _check(x, spec, rbits, counter)
    if x.device.type == "cpu":
        return block_quantize_plain(x, spec, rbits=rbits, tscale=tscale,
                                    counter=counter)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    # ---- what the CUDA kernel takes ----
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16 or f32")
    sr = sr_source("rbits", spec, rbits, counter, dev)
    ts = None
    if tscale is not None:
        if tscale.dtype != torch.float32 or tscale.numel() != 1 \
                or tscale.device != dev:
            raise ValueError(f"tscale must be one f32 value on {dev}")
        ts = tscale.data_ptr()
    codes = torch.empty((M, K), dtype=x.dtype, device=dev)
    scales = torch.empty((M, K // spec.block), dtype=torch.float32,
                         device=dev)
    amax_ws = torch.empty(1, dtype=torch.int32, device=dev)
    ptrs = (x.data_ptr(), codes.data_ptr(), sr.rbits or 0)
    route = k2_route(spec.block, x.dtype,
                     all(p % LANE_BYTES == 0 for p in ptrs))
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 ctypes.byref(sr), M, K, spec.block,
                 ctypes.byref(_QuantParams.of(spec)), ts, amax_ws.data_ptr(),
                 codes.data_ptr(), scales.data_ptr(), int(route == "vec"),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: cudaError_t {err}")
    counters.bump(NAME)
    return codes, scales
