"""The block-scaled FP4 GEMMs: K1 ``fused_quant_matmul``, K3
``block_matmul`` and K4 ``packed_block_matmul``.

  * K1, the training GEMM (forward, backward dX and update dW of
    ``core/fqt.py``): both raw operands are block-quantized on the fly,
    SR bits read from tensors or hashed in the kernel (counter mode).
    Replaces ``repro/kernels/fp4_matmul.py::fused_quant_matmul``; CUDA
    source ``csrc/fused_quant_matmul.cu``.
  * K3, the GEMM of pre-quantized operands (codes and f32 block scales, as
    K2 ``nvfp4_quant.block_quantize`` writes them), reached through
    ``ops.block_matmul``.  Replaces ``repro/kernels/fp4_matmul.py::
    block_matmul``; CUDA source ``csrc/block_matmul.cu``.
  * K4, the serving GEMM (every weight GEMM and the lm_head): quantize-A x
    packed-NVFP4-B.  Replaces ``repro/kernels/fp4_matmul.py::
    packed_block_matmul``; CUDA source ``csrc/fp4_matmul.cu``.

K1 (on bf16-exact specs, ``k1_route``), K3 and K4 above the GEMV rows
(``k4_route``) run their product on one tensor-core GEMM core,
``csrc/fp4_gemm.cuh`` (TMA + wgmma on bf16 operands code x block scale, f32
accumulation); K4 up to 32 rows is a split-K GEMV on mma.sync.

Each wrapper launches its kernel on CUDA tensors and takes its plain
PyTorch version (``*_plain``) only for CPU tensors -- there is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import (NVFP4, BlockQuantSpec,
                                       PackedQuantizedTensor, _tensor_scale)
from repro_torch.kernels import common as c
from repro_torch.kernels import counters
from repro_torch.kernels.nvfp4_quant import (Counter, _QuantParams, _SrBits,
                                             counter_rbits, quant_blocks,
                                             rbits_ptr, sr_source)

NAME = "packed_block_matmul"
FUSED_NAME = "fused_quant_matmul"
BLOCK_NAME = "block_matmul"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _quantized_operand(x: torch.Tensor, spec: BlockQuantSpec,
                       rbits: Optional[torch.Tensor], along_rows: bool,
                       amax: Optional[torch.Tensor] = None) -> tuple:
    """(code * scale in f32, tensor scale) of a 2-D operand blocked along
    its columns (A) or its rows (B), in the TPU kernel's order of operations
    (fp4_matmul.py:90-131); the tensor scale from ``amax`` where given, else
    from the operand's own |max|."""
    xf = x.to(torch.float32)
    if along_rows:
        xf = xf.T
        rbits = None if rbits is None else rbits.T
    if amax is None:
        amax = torch.amax(torch.abs(xf))
    ts = _tensor_scale(amax.to(torch.float32).reshape(()), spec)
    codes, scales = quant_blocks(xf, spec, ts, rbits)
    deq = (codes * scales.unsqueeze(-1)).reshape(xf.shape)
    return (deq.T if along_rows else deq), ts


def packed_block_matmul_plain(a: torch.Tensor, b_packed: torch.Tensor,
                              b_scales: torch.Tensor, b_tscale: torch.Tensor,
                              spec_a: BlockQuantSpec = NVFP4, *,
                              block_b: int = 16,
                              a_rbits: Optional[torch.Tensor] = None,
                              out_dtype=torch.float32,
                              a_amax: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in the TPU kernel's order
    of operations (fp4_matmul.py:90-108, 242-254); ``a_amax`` as in
    ``packed_block_matmul``."""
    M, K = a.shape
    N = b_packed.shape[1] * 2
    ad, tsa = _quantized_operand(a, spec_a, a_rbits, along_rows=False,
                                 amax=a_amax)
    if b_scales.dtype == torch.float8_e4m3fn:
        bsc = c.decode_e4m3_byte_k(b_scales.view(torch.uint8))
    else:
        bsc = b_scales.to(torch.float32)
    bcodes = c.unpack_e2m1_k(b_packed)
    bd = (bcodes.reshape(K // block_b, block_b, N)
          * bsc.unsqueeze(1)).reshape(K, N)
    tsb = b_tscale.to(torch.float32).reshape(())
    return (torch.matmul(ad, bd) * (tsa * tsb)).to(out_dtype)


# ---- K4: packed_block_matmul on the card ----------------------------------------

# K4's routes: "gemv" for at most this many rows of A (decode, the prefill
# programs' lm_head, verify), "core" above it.  Chosen from both routes'
# times at M 1-64 (chip_smoke.py phase `times`; PERF.md, Findings):
# the GEMV wins at M 32 on every llama2-7b weight, the core at M 64.
K4_GEMV_MAX_M = 32
K4_ROUTES = ("gemv", "core", "f32")
# the GEMV's tiling (csrc/fp4_matmul.cu): 256 output columns and 8 or 16
# rows of A per block, K ranges in multiples of 32 rows, at most 1024 rows
# (Q(A) of the range sits in shared memory), and enough blocks for 2 per SM
# of an H100's 132 (faster than 1 or 4 per SM at every decode shape timed)
K4_GEMV_COLS = 256
K4_GEMV_ROWS = 32
K4_GEMV_MAX_ROWS = 1024
K4_GEMV_BLOCKS = 2 * 132


def k4_route(M: int, spec_a: BlockQuantSpec) -> str:
    """K4's route on the card, from static shape and spec before the launch.
    Where A's code x block scale is ``bf16_exact`` (every preset; B's E2M1 x
    E4M3 always is): "gemv" (split-K GEMV on mma.sync) for M <=
    K4_GEMV_MAX_M, "core" (the tensor-core GEMM core) above it.  Any other
    A spec: "f32" (the f32 CUDA-core tile loop)."""
    if not bf16_exact(spec_a):
        return "f32"
    return "gemv" if M <= K4_GEMV_MAX_M else "core"


def k4_gemv_plan(N: int, K: int, block_a: int = 16,
                 plan_n: Optional[int] = None) -> Tuple[int, int]:
    """(splits, rows per split) of the GEMV's K dimension, from static
    shapes alone: enough splits that the column tiles x splits fill
    ``K4_GEMV_BLOCKS`` blocks, ranges of at most ``K4_GEMV_MAX_ROWS`` rows
    in multiples of ``K4_GEMV_ROWS`` and of A's block (a block of A
    quantizes its own slice).  ``plan_n``: plan for that many columns
    instead of N -- a column-parallel shard of N/tp columns takes the full
    N's plan, so each of its columns sums in the 1-device order."""
    unit = K4_GEMV_ROWS * block_a // math.gcd(K4_GEMV_ROWS, block_a)
    tiles = -(-(N if plan_n is None else plan_n) // K4_GEMV_COLS)
    want = max(-(-K4_GEMV_BLOCKS // tiles), -(-K // K4_GEMV_MAX_ROWS))
    want = min(want, -(-K // unit))
    ks = -(-(-(-K // want)) // unit) * unit
    return -(-K // ks), ks


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _lib():
    from repro_torch.kernels import _build
    lib = _build.library("fp4_matmul")
    fn = lib.fp4_packed_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       ctypes.POINTER(_QuantParams), _I, _I, _I, _P, _P, _P,
                       _P, _I, _P]
        fn.restype = _I
    return fn


def _check(a, b_packed, b_scales, spec_a, block_b, a_rbits, out_dtype,
           a_amax=None, plan_n=None):
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
    if a_amax is not None and (a_amax.dtype != torch.float32
                               or a_amax.numel() != 1
                               or a_amax.device != a.device):
        raise ValueError("a_amax must be one f32 value on a's device")
    if plan_n is not None and plan_n < N:
        raise ValueError(f"plan_n={plan_n} < N={N}")
    return M, N, K


def packed_block_matmul(a: torch.Tensor, b_packed: torch.Tensor,
                        b_scales: torch.Tensor, b_tscale: torch.Tensor,
                        spec_a: BlockQuantSpec = NVFP4, *,
                        block_b: int = 16,
                        a_rbits: Optional[torch.Tensor] = None,
                        out_dtype=torch.float32,
                        a_amax: Optional[torch.Tensor] = None,
                        plan_n: Optional[int] = None) -> torch.Tensor:
    """(M, K) activation x packed (K, N) weight -> (M, N) in ``out_dtype``.

    ``b_packed``: (K, N/2) uint8 nibble pairs packed along N; ``b_scales``:
    (K/block_b, N) float8_e4m3fn; ``b_tscale``: f32 scalar tensor.  A is
    quantized on the fly with ``spec_a`` (blocks along K); its tensor scale
    stays on the device.  On the card the route is ``k4_route(M, spec_a)``.

    The tensor-parallel forms (``tp_fp4_matmul``): ``a_amax``, a one-value
    f32 tensor on a's device holding the |A| max to take A's tensor scale
    from (a row-parallel shard's GLOBAL max; A's block scales stay its own,
    K a multiple of A's block), in place of the route's own absmax pass;
    ``plan_n``: the GEMV route splits K as for ``plan_n`` columns
    (``k4_gemv_plan``).  Absent, neither changes a result or a route.
    """
    M, N, K = _check(a, b_packed, b_scales, spec_a, block_b, a_rbits,
                     out_dtype, a_amax, plan_n)
    if a.device.type == "cpu":
        return packed_block_matmul_plain(
            a, b_packed, b_scales, b_tscale, spec_a, block_b=block_b,
            a_rbits=a_rbits, out_dtype=out_dtype, a_amax=a_amax)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    return _k4_launch(a, b_packed, b_scales, b_tscale, spec_a, block_b,
                      a_rbits, out_dtype, k4_route(M, spec_a), a_amax,
                      plan_n)


def _k4_launch(a, b_packed, b_scales, b_tscale, spec_a, block_b, a_rbits,
               out_dtype, route: str, a_amax=None,
               plan_n: Optional[int] = None) -> torch.Tensor:
    """K4 on CUDA tensors by ``route``, on operands that passed ``_check``:
    what ``packed_block_matmul`` runs after ``k4_route``; chip_smoke.py
    times both routes through it to find the crossover."""
    (M, K), N = a.shape, 2 * b_packed.shape[1]
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
    if route == "gemv" and (block_b < 2 or K % 16):
        raise ValueError(f"K={K}, block_b={block_b}: the GEMV route needs "
                         f"K % 16 == 0 and block_b >= 2")
    if route == "core" and K % 8:
        raise ValueError(f"K={K}: the tensor-core route needs K % 8 == 0")
    rb_ptr = rbits_ptr("a_rbits", a_rbits, dev) if spec_a.stochastic \
        else None
    # one workspace, carved into (a, b, c) as csrc/fp4_matmul.cu documents
    splits = ks = 0
    if route == "gemv":
        splits, ks = k4_gemv_plan(N, K, spec_a.block, plan_n)
        ctr = -(-N // K4_GEMV_COLS) * -(-M // 16)
        sizes = (256, _round_up(4 * ctr, 16), 4 * splits * M * N)
    elif route == "core":
        sizes = (256, _round_up(2 * M * K, 256), 2 * N * K)
    else:
        sizes = (256, 4 * M * K, 0)
    ws = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    p0 = ws.data_ptr()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(a.data_ptr(), int(a.dtype == torch.bfloat16),
                 b_packed.data_ptr(), b_scales.data_ptr(),
                 b_tscale.data_ptr(), rb_ptr,
                 None if a_amax is None else a_amax.data_ptr(), M, N, K,
                 spec_a.block, block_b,
                 ctypes.byref(_QuantParams.of(spec_a)),
                 K4_ROUTES.index(route), splits, ks, p0, p0 + sizes[0],
                 p0 + sizes[0] + sizes[1], out.data_ptr(),
                 int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: cudaError_t {err}")
    counters.bump(NAME)
    return out


def packed_matmul(a: torch.Tensor, w: PackedQuantizedTensor,
                  spec_a: BlockQuantSpec = NVFP4, *,
                  a_rbits: Optional[torch.Tensor] = None,
                  out_dtype=torch.float32,
                  a_amax: Optional[torch.Tensor] = None,
                  plan_n: Optional[int] = None) -> torch.Tensor:
    """``packed_block_matmul`` on a (K, N) ``PackedQuantizedTensor``."""
    if w.ndim != 2 or w.axis != -2:
        raise ValueError(f"packed weight must be (K, N) blocked along K, got "
                         f"shape {w.shape}, axis {w.axis}")
    return packed_block_matmul(a, w.packed, w.scales, w.tscale, spec_a,
                               block_b=w.block, a_rbits=a_rbits,
                               out_dtype=out_dtype, a_amax=a_amax,
                               plan_n=plan_n)


# ---- the tensor-parallel form (mesh-native serving) -------------------------------
#
# The explicit Megatron decomposition of the packed FQT matmul, the
# counterpart of ``repro/kernels/fp4_matmul.py::tp_fp4_matmul`` (:351-412).
# The reference writes it as a shard_map over full operands; here every rank
# is a process holding its own shards (``distributed/sharding.py``):
#
#   column: W sharded on N -- K4 on the full activation and the local N
#     columns, with the full N's GEMV plan (so every column sums in the
#     1-device order), no collective;
#   row: activation and W sharded on K -- K4 on the local K columns with
#     the GLOBAL |A| max (the reference quantizes outside its shard_map, over
#     the full K), f32 out, one all-reduce of the partial products, the cast.
#
# ``gather_axis``: the weight is also sharded over that axis (FSDP) and its
# packed wire format is all-gathered first (``allgather_packed``).


def tp_fp4_matmul(x: torch.Tensor, w: PackedQuantizedTensor, *, cfg, mesh,
                  seed: Optional[int] = None, parallel: str = "column",
                  axis: str = "model", gather_axis: Optional[str] = None,
                  gather_dim: int = 0, a_amax: Optional[torch.Tensor] = None,
                  reduce: bool = True) -> torch.Tensor:
    """Tensor-parallel packed FQT matmul on this rank's shards.

    column: x (..., K) full, w this rank's (K, N/tp) -> (..., N/tp).
    row: x (..., K/tp) and w (K/tp, N) this rank's -> (..., N), the sum over
    the ``axis`` ranks, the same bits on each of them.  ``w`` is a 2-D
    ``PackedQuantizedTensor`` (blocked along K); with ``gather_axis`` it is
    also split on its ``gather_dim`` over that axis and gathered first.
    ``seed``: the call's SR seed; an SR ``fwd_a`` draws the bits of the
    full activation and takes this rank's columns (row).

    The row form batched over many GEMMs (the moe layer's experts): with
    ``a_amax`` (a one-value f32 tensor, the GLOBAL |x| max over ``axis``,
    which the caller all-reduced together with the other GEMMs') no
    all-reduce of the max is made, and with ``reduce=False`` the f32
    partial product is returned for the caller to sum over ``axis`` (one
    all-reduce of all the GEMMs' partials) and round."""
    from repro_torch.core import fqt
    from repro_torch.distributed.compression import allgather_packed
    if not isinstance(w, PackedQuantizedTensor) or w.ndim != 2:
        raise ValueError("tp_fp4_matmul needs a 2D PackedQuantizedTensor")
    if parallel not in ("column", "row"):
        raise ValueError(f"parallel={parallel!r}")
    if gather_axis:
        w = allgather_packed(w, mesh, gather_axis, dim=gather_dim)
    K_loc, N_loc = w.shape
    if x.shape[-1] != K_loc:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    tp = mesh.axis_size(axis)
    K = K_loc * tp if parallel == "row" else K_loc
    seed = 0 if seed is None else int(seed) & fqt.M32
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, K_loc).contiguous()
    fwd_a = fqt._if_divisible(cfg.fwd_a, K)
    if fwd_a is not None and (w.axis != -2 or fwd_a.block != w.block
                              or K_loc % fwd_a.block):
        raise ValueError(f"fwd_a block {fwd_a.block} does not fit the "
                         f"packed weight (block {w.block}) and the shard's "
                         f"K={K_loc}")
    if parallel == "column":
        if fwd_a is None:
            y = fqt._matmul_f32(x2, w.dequant())
        else:
            rb = (fqt._site_bits(x.shape, seed, 0, x.device).reshape(-1, K)
                  if fwd_a.stochastic else None)
            y = packed_matmul(x2, w, fwd_a, a_rbits=rb, out_dtype=x.dtype,
                              plan_n=N_loc * mesh.axis_size(axis))
        return y.to(x.dtype).reshape(lead + (N_loc,))
    if fwd_a is None:
        y = fqt._matmul_f32(x2, w.dequant())
    else:
        amax = a_amax
        if amax is None:
            amax = torch.amax(torch.abs(x2.to(torch.float32))).reshape(1)
            mesh.all_reduce(amax, axis, op="max")
        rb = None
        if fwd_a.stochastic:
            r = mesh.axis_index(axis)
            full = fqt._site_bits(lead + (K,), seed, 0, x.device)
            rb = full.reshape(-1, K)[:, r * K_loc:(r + 1) * K_loc] \
                .contiguous()
        y = packed_matmul(x2, w, fwd_a, a_rbits=rb, out_dtype=torch.float32,
                          a_amax=amax)
    if not reduce:
        return y.reshape(lead + (N_loc,))
    mesh.all_reduce(y, axis, op="sum")
    return y.to(x.dtype).reshape(lead + (N_loc,))


# ---- K1: fused_quant_matmul ------------------------------------------------------
#
# An SR operand's ``Counter`` and ``counter_rbits`` live in nvfp4_quant.py:
# K2 takes the same counter mode.


def bf16_exact(spec: BlockQuantSpec) -> bool:
    """code x block scale is exact in bf16 (8 significant bits, f32's
    exponent range): the data and scale formats' mantissa bits sum to <= 6
    (E2M1 x E4M3: 1 + 3, E2M1 x E8M0: 1 + 0, E2M1 x E3M4: 1 + 4)."""
    return spec.data.man_bits + spec.scale.man_bits <= 6


def k1_route(spec_a: BlockQuantSpec, spec_b: BlockQuantSpec) -> str:
    """K1's route on the card, chosen from the specs before the launch:
    "core" (bf16 operands on the tensor-core GEMM core) where both
    operands are ``bf16_exact`` -- every preset of ``core/fqt.py`` -- else
    "f32" (f32 operands on the f32 CUDA-core tile loop)."""
    return "core" if bf16_exact(spec_a) and bf16_exact(spec_b) else "f32"


def _sr_bits(spec, rbits, counter, ref):
    """(uint32 bits tensor or None) of one operand in the plain version."""
    if not spec.stochastic or counter is None:
        return rbits
    return counter_rbits(ref.shape, counter, ref.device)


def fused_quant_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                             spec_a: BlockQuantSpec, spec_b: BlockQuantSpec,
                             *, a_rbits: Optional[torch.Tensor] = None,
                             b_rbits: Optional[torch.Tensor] = None,
                             out_dtype=torch.float32,
                             a_counter: Optional[Counter] = None,
                             b_counter: Optional[Counter] = None,
                             a_amax: Optional[torch.Tensor] = None,
                             b_amax: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: Q(A) (blocks along axis 1)
    @ Q(B) (blocks along axis 0), f32, times tsA * tsB.  A counter-mode
    operand draws ``counter_rbits`` first; ``a_amax`` / ``b_amax`` as in
    ``fused_quant_matmul``."""
    a_rbits = _sr_bits(spec_a, a_rbits, a_counter, a)
    b_rbits = _sr_bits(spec_b, b_rbits, b_counter, b)
    ad, tsa = _quantized_operand(a, spec_a, a_rbits, along_rows=False,
                                 amax=a_amax)
    bd, tsb = _quantized_operand(b, spec_b, b_rbits, along_rows=True,
                                 amax=b_amax)
    return (torch.matmul(ad, bd) * (tsa * tsb)).to(out_dtype)


def _fused_lib():
    from repro_torch.kernels import _build
    fn = _build.library("fused_quant_matmul").fp4_fused_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, ctypes.POINTER(_SrBits),
                       ctypes.POINTER(_SrBits), _I, _I, _I, _I,
                       ctypes.POINTER(_QuantParams),
                       ctypes.POINTER(_QuantParams), _I, _P, _P, _P, _P, _P,
                       _P, _P, _I, _P]
        fn.restype = _I
    return fn


def _check_fused(a, b, spec_a, spec_b, a_rbits, b_rbits, a_counter,
                 b_counter, out_dtype, a_amax=None, b_amax=None):
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
    for name, spec, rb, ctr, shape in (
            ("a", spec_a, a_rbits, a_counter, (M, K)),
            ("b", spec_b, b_rbits, b_counter, (K, N))):
        if ctr is not None and (rb is not None or len(ctr) != 3):
            raise ValueError(f"{name}_counter is (seed32, row_stride, "
                             f"col_stride) in place of {name}_rbits")
        if spec.stochastic and ctr is None and (
                rb is None or tuple(rb.shape) != shape):
            raise ValueError(f"spec_{name} stochastic requires {name}_rbits "
                             f"of {name}.shape or {name}_counter")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    for name, amax in (("a_amax", a_amax), ("b_amax", b_amax)):
        if amax is not None and (amax.dtype != torch.float32
                                 or amax.numel() != 1
                                 or amax.device != a.device):
            raise ValueError(f"{name} must be one f32 value on a's device")
    return M, N, K


def fused_quant_matmul(a: torch.Tensor, b: torch.Tensor,
                       spec_a: BlockQuantSpec, spec_b: BlockQuantSpec, *,
                       a_rbits: Optional[torch.Tensor] = None,
                       b_rbits: Optional[torch.Tensor] = None,
                       out_dtype=torch.float32,
                       a_counter: Optional[Counter] = None,
                       b_counter: Optional[Counter] = None,
                       a_amax: Optional[torch.Tensor] = None,
                       b_amax: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Quantize-A (blocks along axis 1) x quantize-B (blocks along axis 0):
    (M, K) @ (K, N) -> (M, N) in ``out_dtype``.

    ``a_amax`` / ``b_amax``: where the operand is one rank's shard of a
    larger tensor (``core/fqt.py``'s tensor-parallel GEMMs), a one-value
    f32 tensor on its device holding the whole tensor's |max|: the tensor
    scale is derived from it and the operand's own absmax pass is skipped;
    the block scales stay the shard's own.  Absent, the operand's own
    |max| (nothing changes: result, route, launch count).

    SR operands come with uint32 bits of their own shape (int32 or uint32
    tensors holding the same patterns) or, port-internal, with a
    ``Counter`` that the kernel hashes itself (``counter_rbits`` gives the
    same bits).  Both tensor scales stay on the device.  On the card every
    operand must be contiguous (transposed operands are passed as
    contiguous copies), and the tensor-core route (``k1_route``) needs
    K % 8 == 0.
    """
    M, N, K = _check_fused(a, b, spec_a, spec_b, a_rbits, b_rbits,
                           a_counter, b_counter, out_dtype, a_amax, b_amax)
    if a.device.type == "cpu":
        return fused_quant_matmul_plain(
            a, b, spec_a, spec_b, a_rbits=a_rbits, b_rbits=b_rbits,
            out_dtype=out_dtype, a_counter=a_counter, b_counter=b_counter,
            a_amax=a_amax, b_amax=b_amax)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    # ---- what the CUDA kernel takes ----
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in (torch.bfloat16, torch.float32) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous bf16 or f32 on "
                             f"{dev}")
    core = k1_route(spec_a, spec_b) == "core"
    if core and K % 8:
        raise ValueError(f"K={K}: the tensor-core route needs K % 8 == 0")
    srcs = [sr_source(f"{name}_rbits", spec, rb, ctr, dev)
            for name, spec, rb, ctr in (("a", spec_a, a_rbits, a_counter),
                                        ("b", spec_b, b_rbits, b_counter))]
    ws_amax = torch.empty(2, dtype=torch.int32, device=dev)
    ws_ts = torch.empty(2, dtype=torch.float32, device=dev)
    if core:     # bf16 A' (M, K) and B' transposed to (N, K)
        aq_ws = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
        bq_ws = torch.empty((N, K), dtype=torch.bfloat16, device=dev)
    else:        # f32 A' (M, K) and B' (K, N)
        aq_ws = torch.empty((M, K), dtype=torch.float32, device=dev)
        bq_ws = torch.empty((K, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    qa, qb = _QuantParams.of(spec_a), _QuantParams.of(spec_b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fused_lib()(
        a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
        int(b.dtype == torch.bfloat16), ctypes.byref(srcs[0]),
        ctypes.byref(srcs[1]), M, N, K, spec_a.block, ctypes.byref(qa),
        ctypes.byref(qb), int(core), ws_amax.data_ptr(), ws_ts.data_ptr(),
        None if a_amax is None else a_amax.data_ptr(),
        None if b_amax is None else b_amax.data_ptr(),
        aq_ws.data_ptr(), bq_ws.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{FUSED_NAME} kernel launch failed: cudaError_t "
                           f"{err}")
    counters.bump(FUSED_NAME)
    return out


# ---- K3: block_matmul ------------------------------------------------------------


def block_matmul_plain(a_codes: torch.Tensor, a_scales: torch.Tensor,
                       b_codes: torch.Tensor, b_scales: torch.Tensor,
                       tscale, *, block: int = 16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: (codes * repeated block
    scales) of each operand, f32 matmul, times ``tscale``.  (The kernel
    rounds code * scale to bf16, which is exact for every operand K2
    writes under a spec the repository has: see ``block_matmul``.)"""
    ad = a_codes.to(torch.float32) * torch.repeat_interleave(
        a_scales.to(torch.float32), block, dim=1)
    bd = b_codes.to(torch.float32) * torch.repeat_interleave(
        b_scales.to(torch.float32), block, dim=0)
    ts = torch.as_tensor(tscale, dtype=torch.float32, device=ad.device)
    return torch.matmul(ad, bd) * ts


def _check_block(a_codes, a_scales, b_codes, b_scales, block):
    if a_codes.ndim != 2 or b_codes.ndim != 2:
        raise ValueError(f"operands must be 2-D, got {tuple(a_codes.shape)} "
                         f"@ {tuple(b_codes.shape)}")
    M, K = a_codes.shape
    K2, N = b_codes.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a_codes.shape)} @ "
                         f"{tuple(b_codes.shape)}")
    if K % block:
        raise ValueError(f"K={K} not divisible by block={block}")
    for name, t, shape in (("a_scales", a_scales, (M, K // block)),
                           ("b_scales", b_scales, (K // block, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    return M, N, K


def _block_lib():
    from repro_torch.kernels import _build
    fn = _build.library("block_matmul").fp4_block_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                       _P, _P]
        fn.restype = _I
    return fn


def block_matmul(a_codes: torch.Tensor, a_scales: torch.Tensor,
                 b_codes: torch.Tensor, b_scales: torch.Tensor,
                 tscale: torch.Tensor, *, block: int = 16) -> torch.Tensor:
    """(M, K) @ (K, N) of pre-quantized operands -> f32 (M, N) * tscale.

    A codes (M, K) with f32 scales (M, K/block), B codes (K, N) with f32
    scales (K/block, N), both blocked along K; codes f32 or bf16.  On the
    card ``tscale`` is an f32 device scalar that the kernel reads in its
    epilogue (no host sync), every operand must be contiguous and K % 8 ==
    0.  There the kernel writes code * scale as bf16 operands for the
    tensor-core core: exact, so equal to this function's f32 reference up
    to summation order, for every operand K2 writes under a spec whose data
    and scale mantissa bits sum to <= 6 (``bf16_exact``: every spec in the
    repository); codes off that grid are rounded to bf16 first.
    """
    M, N, K = _check_block(a_codes, a_scales, b_codes, b_scales, block)
    if a_codes.device.type == "cpu":
        return block_matmul_plain(a_codes, a_scales, b_codes, b_scales,
                                  tscale, block=block)
    if a_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {a_codes.device}")
    # ---- what the CUDA kernel takes ----
    dev = a_codes.device
    for name, t in (("a_codes", a_codes), ("b_codes", b_codes)):
        if t.dtype not in (torch.bfloat16, torch.float32) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous bf16 or f32 on {dev}")
    for name, t in (("a_scales", a_scales), ("b_scales", b_scales)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name} must be contiguous f32 on {dev}")
    if not isinstance(tscale, torch.Tensor) or tscale.dtype != torch.float32 \
            or tscale.numel() != 1 or tscale.device != dev:
        raise ValueError(f"tscale must be one f32 value on {dev}")
    if K % 8:
        raise ValueError(f"K={K}: the tensor-core core needs K % 8 == 0")
    a_ws = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    b_ws = torch.empty((N, K), dtype=torch.bfloat16, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _block_lib()(
        a_codes.data_ptr(), int(a_codes.dtype == torch.bfloat16),
        a_scales.data_ptr(), b_codes.data_ptr(),
        int(b_codes.dtype == torch.bfloat16), b_scales.data_ptr(),
        tscale.data_ptr(), M, N, K, block, a_ws.data_ptr(), b_ws.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BLOCK_NAME} kernel launch failed: cudaError_t "
                           f"{err}")
    counters.bump(BLOCK_NAME)
    return out
