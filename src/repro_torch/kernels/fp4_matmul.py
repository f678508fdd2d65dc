"""K4 ``packed_block_matmul``: quantize-A x packed-NVFP4-B GEMM.

The serving GEMM (every weight GEMM and the lm_head).  Replaces the TPU
kernel ``repro/kernels/fp4_matmul.py::packed_block_matmul``; the CUDA
source is ``csrc/fp4_matmul.cu``.  ``packed_block_matmul`` launches it on
CUDA tensors and takes the plain PyTorch version ``packed_block_matmul_
plain`` only for CPU tensors -- there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.quantize import (NVFP4, BlockQuantSpec,
                                       PackedQuantizedTensor, _tensor_scale)
from repro_torch.kernels import common as c
from repro_torch.kernels import counters

NAME = "packed_block_matmul"
_P = ctypes.c_void_p
_I = ctypes.c_int


def packed_block_matmul_plain(a: torch.Tensor, b_packed: torch.Tensor,
                              b_scales: torch.Tensor, b_tscale: torch.Tensor,
                              spec_a: BlockQuantSpec = NVFP4, *,
                              block_b: int = 16,
                              a_rbits: Optional[torch.Tensor] = None,
                              out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in the TPU kernel's order
    of operations (fp4_matmul.py:90-108, 242-254)."""
    M, K = a.shape
    N = b_packed.shape[1] * 2
    B = spec_a.block
    af = a.to(torch.float32)
    tsa = _tensor_scale(torch.amax(torch.abs(af)), spec_a)
    xb = af.reshape(M, K // B, B)
    absmax = torch.amax(torch.abs(xb), dim=-1)
    data_p = c.FmtParams.of(spec_a.data)
    if spec_a.scale_fmt == "e8m0":
        scales = c.e8m0_block_scale_k(absmax, data_p.emax)
    else:
        scales = c.generic_block_scale_k(absmax, data_p.max,
                                         c.FmtParams.of(spec_a.scale), tsa)
    scaled = xb / (scales.unsqueeze(-1) * tsa)
    if spec_a.stochastic:
        u = c.uniform_from_bits_k(a_rbits).reshape(M, K // B, B)
        codes = c.quantize_sr_k(scaled, data_p, u)
    else:
        codes = c.quantize_rtn_k(scaled, data_p)
    ad = (codes * scales.unsqueeze(-1)).reshape(M, K)
    if b_scales.dtype == torch.float8_e4m3fn:
        bsc = c.decode_e4m3_byte_k(b_scales.view(torch.uint8))
    else:
        bsc = b_scales.to(torch.float32)
    bcodes = c.unpack_e2m1_k(b_packed)
    bd = (bcodes.reshape(K // block_b, block_b, N)
          * bsc.unsqueeze(1)).reshape(K, N)
    tsb = b_tscale.to(torch.float32).reshape(())
    return (torch.matmul(ad, bd) * (tsa * tsb)).to(out_dtype)


def _lib():
    from repro_torch.kernels import _build
    lib = _build.library("fp4_matmul")
    fn = lib.fp4_packed_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _I, _P]
        fn.restype = _I
    return fn


def _check(a, b_packed, b_scales, spec_a, block_b, a_rbits, out_dtype):
    M, K = a.shape
    K2, half_n = b_packed.shape
    N = 2 * half_n
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"({K2}, {N})")
    if K % spec_a.block or K % block_b:
        raise ValueError(f"K={K} not divisible by blocks "
                         f"{spec_a.block}/{block_b}")
    if tuple(b_scales.shape) != (K // block_b, N):
        raise ValueError(f"b_scales shape {tuple(b_scales.shape)} != "
                         f"{(K // block_b, N)}")
    if spec_a.stochastic and (a_rbits is None
                              or tuple(a_rbits.shape) != (M, K)):
        raise ValueError("spec_a stochastic requires a_rbits of a.shape")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    return M, N, K


def packed_block_matmul(a: torch.Tensor, b_packed: torch.Tensor,
                        b_scales: torch.Tensor, b_tscale: torch.Tensor,
                        spec_a: BlockQuantSpec = NVFP4, *,
                        block_b: int = 16,
                        a_rbits: Optional[torch.Tensor] = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) activation x packed (K, N) weight -> (M, N) in ``out_dtype``.

    ``b_packed``: (K, N/2) uint8 nibble pairs packed along N; ``b_scales``:
    (K/block_b, N) float8_e4m3fn; ``b_tscale``: f32 scalar tensor.  A is
    quantized on the fly with ``spec_a`` (blocks along K); its tensor scale
    stays on the device.
    """
    M, N, K = _check(a, b_packed, b_scales, spec_a, block_b, a_rbits,
                     out_dtype)
    if a.device.type == "cpu":
        return packed_block_matmul_plain(
            a, b_packed, b_scales, b_tscale, spec_a, block_b=block_b,
            a_rbits=a_rbits, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    # ---- what the CUDA kernel takes ----
    dev = a.device
    if a.dtype not in (torch.bfloat16, torch.float32) or not a.is_contiguous():
        raise ValueError("a must be contiguous bf16 or f32")
    if b_packed.dtype != torch.uint8 or not b_packed.is_contiguous():
        raise ValueError("b_packed must be contiguous uint8")
    if b_scales.dtype != torch.float8_e4m3fn or not b_scales.is_contiguous():
        raise ValueError("b_scales must be contiguous float8_e4m3fn")
    if b_tscale.dtype != torch.float32 or b_tscale.numel() != 1:
        raise ValueError("b_tscale must be one f32 value")
    if spec_a.data_fmt != "e2m1" or spec_a.block not in (16, 32):
        raise ValueError(f"kernel takes E2M1 data with block 16/32, got "
                         f"{spec_a}")
    e8m0 = spec_a.scale_fmt == "e8m0"
    if not (e8m0 and not spec_a.two_level) and spec_a.scale_fmt != "e4m3":
        raise ValueError(f"kernel takes E4M3 or (one-level) E8M0 A scales, "
                         f"got {spec_a}")
    for t in (b_packed, b_scales, b_tscale):
        if t.device != dev:
            raise ValueError("all operands must be on the same device")
    rb_ptr = None
    if spec_a.stochastic:
        if a_rbits.dtype not in (torch.int32, torch.uint32) \
                or not a_rbits.is_contiguous() or a_rbits.device != dev:
            raise ValueError("a_rbits must be contiguous 32-bit on a's device")
        rb_ptr = a_rbits.data_ptr()
    amax_ws = torch.empty(1, dtype=torch.int32, device=dev)
    tsa_ws = torch.empty(1, dtype=torch.float32, device=dev)
    aq_ws = torch.empty((M, K), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(a.data_ptr(), int(a.dtype == torch.bfloat16),
                 b_packed.data_ptr(), b_scales.data_ptr(),
                 b_tscale.data_ptr(), rb_ptr, M, N, K, spec_a.block, block_b,
                 int(e8m0), int(spec_a.two_level), amax_ws.data_ptr(),
                 tsa_ws.data_ptr(), aq_ws.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: cudaError_t {err}")
    counters.bump(NAME)
    return out


def packed_matmul(a: torch.Tensor, w: PackedQuantizedTensor,
                  spec_a: BlockQuantSpec = NVFP4, *,
                  a_rbits: Optional[torch.Tensor] = None,
                  out_dtype=torch.float32) -> torch.Tensor:
    """``packed_block_matmul`` on a (K, N) ``PackedQuantizedTensor``."""
    if w.ndim != 2 or w.axis != -2:
        raise ValueError(f"packed weight must be (K, N) blocked along K, got "
                         f"shape {w.shape}, axis {w.axis}")
    return packed_block_matmul(a, w.packed, w.scales, w.tscale, spec_a,
                               block_b=w.block, a_rbits=a_rbits,
                               out_dtype=out_dtype)
