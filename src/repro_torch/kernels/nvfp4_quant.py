"""K2 ``block_quantize``: the standalone NVFP4/MXFP4 block quantizer.

Replaces ``repro/kernels/nvfp4_quant.py::block_quantize_pallas``; CUDA
source ``csrc/block_quantize.cu``.  A 2-D tensor is quantized along its
last axis: per block of ``spec.block`` values the absmax, a block scale
(E4M3/E3M4 RtN, or E8M0) and E2M1 codes (RtN, or SR from given uint32
bits).  ``quant_blocks`` is that arithmetic in plain PyTorch, shared with
K1's and K4's plain versions (``fp4_matmul.py``).

The wrapper launches the kernel on CUDA tensors and takes its plain
version (``block_quantize_plain``) only for CPU tensors -- there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import BlockQuantSpec, _tensor_scale
from repro_torch.kernels import common as c
from repro_torch.kernels import counters

NAME = "block_quantize"
_P = ctypes.c_void_p
_I = ctypes.c_int


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


def _check(x, spec, rbits) -> tuple:
    if x.ndim != 2:
        raise ValueError(f"expected 2D input, got {tuple(x.shape)}")
    M, K = x.shape
    if K % spec.block:
        raise ValueError(f"K={K} not divisible by block={spec.block}")
    if spec.stochastic and (rbits is None or tuple(rbits.shape) != (M, K)):
        raise ValueError("SR requires rbits with the same shape as x")
    return M, K


def block_quantize_plain(x: torch.Tensor, spec: BlockQuantSpec, *,
                         rbits: Optional[torch.Tensor] = None,
                         tscale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: (codes in x.dtype,
    f32 scales (M, K/block))."""
    M, K = _check(x, spec, rbits)
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


def rbits_ptr(name: str, rbits: torch.Tensor, dev: torch.device) -> int:
    """Device pointer of SR bits (int32 or uint32 holding the same 32-bit
    patterns), checked for what the kernels take."""
    if rbits.dtype not in (torch.int32, torch.uint32) \
            or not rbits.is_contiguous() or rbits.device != dev:
        raise ValueError(f"{name} must be contiguous 32-bit on {dev}")
    return rbits.data_ptr()


def _lib():
    from repro_torch.kernels import _build
    fn = _build.library("block_quantize").fp4_block_quantize
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _I, _I, ctypes.POINTER(_QuantParams),
                       _P, _P, _P, _P, _P]
        fn.restype = _I
    return fn


def block_quantize(x: torch.Tensor, spec: BlockQuantSpec, *,
                   rbits: Optional[torch.Tensor] = None,
                   tscale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a 2-D tensor along its last axis; returns (codes, scales).

    codes: x.shape in x.dtype, values on the E2M1 grid; scales: (M,
    K/block) f32; codes * repeat(scales) * tscale dequantizes.  ``tscale``
    is an f32 scalar tensor, or None for ``ref.tensor_scale_ref`` (1 when
    the spec is not two-level); on the card a computed one never leaves
    the device.  SR takes uint32 bits of x's shape (int32 or uint32
    tensors holding the same patterns).
    """
    M, K = _check(x, spec, rbits)
    if x.device.type == "cpu":
        return block_quantize_plain(x, spec, rbits=rbits, tscale=tscale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    # ---- what the CUDA kernel takes ----
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16 or f32")
    rb = rbits_ptr("rbits", rbits, dev) if spec.stochastic else None
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
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), rb, M, K,
                 spec.block, ctypes.byref(_QuantParams.of(spec)), ts,
                 amax_ws.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: cudaError_t {err}")
    counters.bump(NAME)
    return codes, scales
