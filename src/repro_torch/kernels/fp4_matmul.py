"""The block-scaled FP4 GEMMs: K1 ``fused_quant_matmul`` and K4
``packed_block_matmul``.

  * K1, the training GEMM (forward, backward dX and update dW of
    ``core/fqt.py``): both raw operands are block-quantized on the fly.
    Replaces ``repro/kernels/fp4_matmul.py::fused_quant_matmul``; CUDA
    source ``csrc/fused_quant_matmul.cu``.
  * K4, the serving GEMM (every weight GEMM and the lm_head): quantize-A x
    packed-NVFP4-B.  Replaces ``repro/kernels/fp4_matmul.py::
    packed_block_matmul``; CUDA source ``csrc/fp4_matmul.cu``.

Each wrapper launches its kernel on CUDA tensors and takes its plain
PyTorch version (``*_plain``) only for CPU tensors -- there is no fallback
from one to the other.
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
FUSED_NAME = "fused_quant_matmul"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _quantized_operand(x: torch.Tensor, spec: BlockQuantSpec,
                       rbits: Optional[torch.Tensor],
                       along_rows: bool) -> tuple:
    """(code * scale in f32, tensor scale) of a 2-D operand blocked along
    its columns (A) or its rows (B), in the TPU kernel's order of operations
    (fp4_matmul.py:90-131)."""
    xf = x.to(torch.float32)
    if along_rows:
        xf = xf.T
    R, C = xf.shape
    B = spec.block
    ts = _tensor_scale(torch.amax(torch.abs(xf)), spec)
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
        u = c.uniform_from_bits_k(rbits.T if along_rows else rbits)
        qv = c.quantize_sr_k(scaled, data_p, u.reshape(R, C // B, B))
    else:
        qv = c.quantize_rtn_k(scaled, data_p)
    deq = (qv * scales.unsqueeze(-1)).reshape(R, C)
    return (deq.T if along_rows else deq), ts


class _QuantParams(ctypes.Structure):
    """``fp4::QuantParams`` of csrc/fp4_common.cuh: one operand's spec."""
    _fields_ = [("data_man_bits", _I), ("data_emin", _I), ("data_emax", _I),
                ("data_max", ctypes.c_float), ("scale_man_bits", _I),
                ("scale_emin", _I), ("scale_emax", _I),
                ("scale_max", ctypes.c_float), ("e8m0", _I),
                ("two_level", _I), ("ts_denom", ctypes.c_float)]

    @classmethod
    def of(cls, spec: BlockQuantSpec) -> "_QuantParams":
        d, s = spec.data, spec.scale
        return cls(d.man_bits, d.emin, d.emax, d.max, s.man_bits, s.emin,
                   s.emax, s.max, int(spec.scale_fmt == "e8m0"),
                   int(spec.two_level), d.max * s.max)


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
    ad, tsa = _quantized_operand(a, spec_a, a_rbits, along_rows=False)
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
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       ctypes.POINTER(_QuantParams), _P, _P, _P, _P, _I, _P]
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
                 ctypes.byref(_QuantParams.of(spec_a)), amax_ws.data_ptr(),
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


# ---- K1: fused_quant_matmul ------------------------------------------------------


def fused_quant_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                             spec_a: BlockQuantSpec, spec_b: BlockQuantSpec,
                             *, a_rbits: Optional[torch.Tensor] = None,
                             b_rbits: Optional[torch.Tensor] = None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: Q(A) (blocks along axis 1)
    @ Q(B) (blocks along axis 0), f32, times tsA * tsB."""
    ad, tsa = _quantized_operand(a, spec_a, a_rbits, along_rows=False)
    bd, tsb = _quantized_operand(b, spec_b, b_rbits, along_rows=True)
    return (torch.matmul(ad, bd) * (tsa * tsb)).to(out_dtype)


def _fused_lib():
    from repro_torch.kernels import _build
    fn = _build.library("fused_quant_matmul").fp4_fused_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                       ctypes.POINTER(_QuantParams),
                       ctypes.POINTER(_QuantParams), _P, _P, _P, _P, _P, _I,
                       _P]
        fn.restype = _I
    return fn


def _check_fused(a, b, spec_a, spec_b, a_rbits, b_rbits, out_dtype):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"operands must be 2-D, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if spec_a.block != spec_b.block:
        raise ValueError("operand block sizes must match")
    if K % spec_a.block:
        raise ValueError(f"K={K} not divisible by block={spec_a.block}")
    for name, spec, rb, shape in (("a", spec_a, a_rbits, (M, K)),
                                  ("b", spec_b, b_rbits, (K, N))):
        if spec.stochastic and (rb is None or tuple(rb.shape) != shape):
            raise ValueError(f"spec_{name} stochastic requires {name}_rbits "
                             f"of {name}.shape")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    return M, N, K


def fused_quant_matmul(a: torch.Tensor, b: torch.Tensor,
                       spec_a: BlockQuantSpec, spec_b: BlockQuantSpec, *,
                       a_rbits: Optional[torch.Tensor] = None,
                       b_rbits: Optional[torch.Tensor] = None,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Quantize-A (blocks along axis 1) x quantize-B (blocks along axis 0):
    (M, K) @ (K, N) -> (M, N) in ``out_dtype``.

    SR operands come with uint32 bits of their own shape (int32 or uint32
    tensors holding the same patterns).  Both tensor scales stay on the
    device.  On the card every operand must be contiguous: transposed
    operands are passed as contiguous copies.
    """
    M, N, K = _check_fused(a, b, spec_a, spec_b, a_rbits, b_rbits, out_dtype)
    if a.device.type == "cpu":
        return fused_quant_matmul_plain(a, b, spec_a, spec_b,
                                        a_rbits=a_rbits, b_rbits=b_rbits,
                                        out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    # ---- what the CUDA kernel takes ----
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in (torch.bfloat16, torch.float32) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous bf16 or f32 on "
                             f"{dev}")
    rb_ptrs = []
    for name, spec, rb in (("a", spec_a, a_rbits), ("b", spec_b, b_rbits)):
        if not spec.stochastic:
            rb_ptrs.append(None)
            continue
        if rb.dtype not in (torch.int32, torch.uint32) \
                or not rb.is_contiguous() or rb.device != dev:
            raise ValueError(f"{name}_rbits must be contiguous 32-bit on "
                             f"{dev}")
        rb_ptrs.append(rb.data_ptr())
    ws_amax = torch.empty(2, dtype=torch.int32, device=dev)
    ws_ts = torch.empty(2, dtype=torch.float32, device=dev)
    aq_ws = torch.empty((M, K), dtype=torch.float32, device=dev)
    bq_ws = torch.empty((K, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    qa, qb = _QuantParams.of(spec_a), _QuantParams.of(spec_b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fused_lib()(
        a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
        int(b.dtype == torch.bfloat16), rb_ptrs[0], rb_ptrs[1], M, N, K,
        spec_a.block, ctypes.byref(qa), ctypes.byref(qb), ws_amax.data_ptr(),
        ws_ts.data_ptr(), aq_ws.data_ptr(), bq_ws.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{FUSED_NAME} kernel launch failed: cudaError_t "
                           f"{err}")
    counters.bump(FUSED_NAME)
    return out
