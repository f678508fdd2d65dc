"""K6 ``flash_attention_packed`` and K7 ``flash_attention``.

K6 is decode attention over the contiguous block-quantized KV cache
(``PackedKVCache``); K7 is bf16 prefill attention.  They replace the TPU
kernels ``repro/kernels/flash_attn.py::flash_attention_packed`` and
``::flash_attention``; the CUDA source is ``csrc/flash_attn.cu``.  Each
wrapper launches its kernel on CUDA tensors and takes its plain PyTorch
version only for CPU tensors.

The plain versions run the same online softmax over the same 32-key tiles
as the kernels (``TILE_KV``), so the kernel's p rounding (K7 rounds p to
V's dtype before the pv product) happens against the same running max.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import common as c
from repro_torch.kernels import counters

NEG_INF = -1e30
TILE_KV = 32                      # keys per tile, kernels and plain versions
PACKED_NAME = "flash_attention_packed"
DENSE_NAME = "flash_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _sm_scale(d: int) -> float:
    """D^-0.5 rounded to f32, as the TPU kernels multiply by it."""
    return float(np.float32(d ** -0.5))


def _online_softmax(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                    valid: torch.Tensor, p_dtype) -> torch.Tensor:
    """Plain online softmax over TILE_KV-key tiles.

    qf: (B, Sq, KVH, G, D) f32; kf/vf: (B, Sk, KVH, D) f32; valid: bool
    (Sq, Sk).  ``p_dtype``: dtype p is rounded to before the pv product
    (None keeps f32).  Returns (B, Sq, KVH, G, D) f32."""
    B, Sq, KVH, G, D = qf.shape
    Sk = kf.shape[1]
    scale = _sm_scale(D)
    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32,
                      device=qf.device)
    for t0 in range(0, Sk, TILE_KV):
        kt, vt = kf[:, t0:t0 + TILE_KV], vf[:, t0:t0 + TILE_KV]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * scale
        s = torch.where(valid[:, t0:t0 + TILE_KV], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new.unsqueeze(-1))
        l = l * corr + torch.sum(p, dim=-1)
        if p_dtype is not None:
            p = p.to(p_dtype).to(torch.float32)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vt)
        acc = acc * corr.unsqueeze(-1) + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30).unsqueeze(-1)
    return o.permute(0, 3, 1, 2, 4)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, kv_len, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    valid = (kpos < kv_len)[None, :].expand(qpos.shape[0], -1)
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    return valid


def _dequant_cache(codes, scales, fmt: str, block: int) -> torch.Tensor:
    """(B, Sk, KVH, Dc) codes + scales -> (B, Sk, KVH, D) f32, arithmetic."""
    if fmt == "nvfp4":
        vals = c.unpack_e2m1_k(codes)
        s = c.decode_e4m3_byte_k(scales.view(torch.uint8))
    else:
        vals = c.decode_e4m3_byte_k(codes.view(torch.uint8))
        s = scales.to(torch.float32)
    return vals * torch.repeat_interleave(s, block, dim=-1)


# ---- K6 ------------------------------------------------------------------------


def flash_attention_packed_plain(q, k_codes, k_scales, v_codes, v_scales,
                                 pos, *, fmt: str = "nvfp4", block: int = 16,
                                 causal: bool = True,
                                 window: Optional[int] = None):
    """Plain version of K6; ``pos`` is the int32 (q_offset, kv_len) pair."""
    B, Sq, H, D = q.shape
    Sk, KVH = k_codes.shape[1], k_codes.shape[2]
    kf = _dequant_cache(k_codes, k_scales, fmt, block)
    vf = _dequant_cache(v_codes, v_scales, fmt, block)
    pos = pos.to(q.device)
    qpos = pos[0] + torch.arange(Sq, dtype=torch.int32, device=q.device)
    kpos = torch.arange(Sk, dtype=torch.int32, device=q.device)
    valid = _mask(qpos, kpos, pos[1], causal, window)
    qf = q.to(torch.float32).reshape(B, Sq, KVH, H // KVH, D)
    o = _online_softmax(qf, kf, vf, valid, None)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _check_packed(q, k_codes, k_scales, v_codes, v_scales, pos, fmt, block):
    B, Sq, H, D = q.shape
    if fmt not in ("nvfp4", "fp8"):
        raise ValueError(f"unknown packed KV format {fmt!r}")
    Dc = D // 2 if fmt == "nvfp4" else D
    if k_codes.shape[-1] != Dc or D % block:
        raise ValueError(f"bad packed layout: codes last dim "
                         f"{k_codes.shape[-1]}, head dim {D}, block {block}")
    KVH = k_codes.shape[2]
    if H % KVH:
        raise ValueError(f"GQA: H={H} not a multiple of KVH={KVH}")
    for t in (k_codes, v_codes):
        if t.shape[0] != B or t.shape[-1] != Dc:
            raise ValueError(f"codes shape {tuple(t.shape)} does not match q")
    want_s = tuple(k_codes.shape[:3]) + (D // block,)
    for t in (k_scales, v_scales):
        if tuple(t.shape) != want_s:
            raise ValueError(f"scales shape {tuple(t.shape)} != {want_s}")
    if tuple(pos.shape) != (2,):
        raise ValueError("pos must be the (q_offset, kv_len) pair")


def flash_attention_packed(q: torch.Tensor, k_codes: torch.Tensor,
                           k_scales: torch.Tensor, v_codes: torch.Tensor,
                           v_scales: torch.Tensor, pos: torch.Tensor, *,
                           fmt: str = "nvfp4", block: int = 16,
                           causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over a block-quantized KV cache.

    nvfp4: codes (B, Sk, KVH, D/2) uint8 + scales (B, Sk, KVH, D/block)
    float8_e4m3fn; fp8: codes (B, Sk, KVH, D) float8_e4m3fn + bf16 scales.
    ``pos``: int32 tensor (q_offset, kv_len) on q's device -- a device
    operand, so a decode loop never syncs on the cache length.
    """
    _check_packed(q, k_codes, k_scales, v_codes, v_scales, pos, fmt, block)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(
            q, k_codes, k_scales, v_codes, v_scales, pos, fmt=fmt,
            block=block, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    B, Sq, H, D = q.shape
    Sk, KVH = k_codes.shape[1], k_codes.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("q must be bf16 or f32")
    code_dt = torch.uint8 if fmt == "nvfp4" else torch.float8_e4m3fn
    scale_dt = torch.float8_e4m3fn if fmt == "nvfp4" else torch.bfloat16
    for t, dt in ((k_codes, code_dt), (v_codes, code_dt),
                  (k_scales, scale_dt), (v_scales, scale_dt)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{fmt} cache operand must be {dt} on {dev}")
    if pos.dtype != torch.int32 or pos.device != dev:
        raise ValueError("pos must be int32 on q's device")
    if block % 2 or D % 32 or D > 256:
        raise ValueError(f"kernel takes even blocks and D in 32..256, "
                         f"got block {block}, D {D}")
    tensors = [t.contiguous() for t in (q, k_codes, k_scales, v_codes,
                                        v_scales, pos)]
    out = torch.empty_like(tensors[0])
    from repro_torch.kernels import _build
    fn = _build.library("flash_attn").flash_attention_packed_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P] + [_I] * 10 + \
            [ctypes.c_float, _P]
        fn.restype = _I
    err = fn(tensors[0].data_ptr(), int(q.dtype == torch.bfloat16),
             *(t.data_ptr() for t in tensors[1:]), out.data_ptr(),
             B, Sq, H, KVH, D, Sk, int(fmt == "nvfp4"), block, int(causal),
             int(window or 0), _sm_scale(D),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{PACKED_NAME} kernel launch failed: "
                           f"cudaError_t {err}")
    counters.bump(PACKED_NAME)
    return out


# ---- K7 ------------------------------------------------------------------------


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version of K7: p is rounded to V's dtype before pv."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qpos = torch.arange(Sq, dtype=torch.int32, device=q.device)
    kpos = torch.arange(Sk, dtype=torch.int32, device=q.device)
    valid = _mask(qpos, kpos, Sk, causal, window)
    qf = q.to(torch.float32).reshape(B, Sq, KVH, H // KVH, D)
    p_dtype = None if v.dtype == torch.float32 else v.dtype
    o = _online_softmax(qf, k.to(torch.float32), v.to(torch.float32), valid,
                        p_dtype)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention forward.  q: (B, Sq, H, D); k/v: (B, Sk, KVH, D); any Sq
    and Sk (the ragged edge is masked)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"GQA: H={H} not a multiple of KVH={KVH}")
    if tuple(k.shape) != (B, Sk, KVH, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, bf16 or f32")
    if D not in (32, 64, 96, 128):
        raise ValueError(f"kernel takes head dims 32/64/96/128, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    from repro_torch.kernels import _build
    fn = _build.library("flash_attn").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _P] + [_I] * 8 + [ctypes.c_float, _P]
        fn.restype = _I
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             int(q.dtype == torch.bfloat16), out.data_ptr(), B, Sq, Sk, H,
             KVH, D, int(causal), int(window or 0), _sm_scale(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{DENSE_NAME} kernel launch failed: "
                           f"cudaError_t {err}")
    counters.bump(DENSE_NAME)
    return out
