"""K5 ``flash_attention_paged``, K6 ``flash_attention_packed`` and K7
``flash_attention``.

K5 is attention over the PAGED block-quantized KV pool of continuous
batching (``PagedKVCache``), read through a page table with per-slot
(q_offset, kv_len); K6 is decode attention over the contiguous
block-quantized KV cache (``PackedKVCache``); K7 is prefill attention.
They replace the TPU kernels ``repro/kernels/flash_attn.py::
flash_attention_paged``, ``::flash_attention_packed`` and
``::flash_attention``; the CUDA sources are ``csrc/flash_attn_paged.cu``
(K5 and K6: one split-KV body, the contiguous cache read as one page per
slot) and ``csrc/flash_attn.cu`` (K7, on ``mma.sync``).  Each wrapper
launches its kernel on CUDA tensors and takes its plain PyTorch version only
for CPU tensors.

The plain versions of K6 and K7 run the same online softmax over 32-key
tiles (``TILE_KV``); K7's kernel uses that tile width, so its p rounding
(p to V's dtype before the pv product) happens against the same running
max.  K5's plain version steps one page at a time, as the TPU kernel's grid
does; p stays f32 in K5 and K6, so their kernels' tile grouping moves only
f32 rounding.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import common as c
from repro_torch.kernels import counters

NEG_INF = -1e30
TILE_KV = 32                      # keys per tile: plain versions and K7
PAGED_NAME = "flash_attention_paged"
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
          window: Optional[int], rows: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """(Sq, Sk) validity: the row below kv_len (``rows``: each key's row in
    the buffer, default its position) and the causal and window rules on
    the positions."""
    rows = kpos if rows is None else rows
    valid = ((rows < kv_len) & (kpos >= 0))[None, :].expand(
        qpos.shape[0], -1)
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

PAGED_FORMATS = ("nvfp4", "fp8", "bf16")   # the kernel's fmt codes 0, 1, 2
PACKED_FORMATS = PAGED_FORMATS[:2]


def flash_attention_packed_plain(q, k_codes, k_scales, v_codes, v_scales,
                                 pos, *, fmt: str = "nvfp4", block: int = 16,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 rolling: bool = False):
    """Plain version of K6; ``pos`` is the int32 (q_offset, kv_len) pair.
    ``rolling``: row j holds the latest position with pos % Sk == j,
    relative to the last query row (``swa_kpos``)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k_codes.shape[1], k_codes.shape[2]
    kf = _dequant_cache(k_codes, k_scales, fmt, block)
    vf = _dequant_cache(v_codes, v_scales, fmt, block)
    pos = pos.to(q.device)
    qpos = pos[0] + torch.arange(Sq, dtype=torch.int32, device=q.device)
    rows = torch.arange(Sk, dtype=torch.int32, device=q.device)
    kpos = swa_kpos((pos[0] + Sq).reshape(1), Sk)[0] if rolling else rows
    valid = _mask(qpos, kpos, pos[1], causal, window, rows)
    qf = q.to(torch.float32).reshape(B, Sq, KVH, H // KVH, D)
    o = _online_softmax(qf, kf, vf, valid, None)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _check_packed(q, k_codes, k_scales, v_codes, v_scales, pos, fmt, block):
    B, Sq, H, D = q.shape
    if fmt not in PACKED_FORMATS:
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
    if tuple(pos.shape) != (2,) or pos.dtype != torch.int32:
        raise ValueError("pos must be the int32 (q_offset, kv_len) pair")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("q must be bf16 or f32")
    code_dt = torch.uint8 if fmt == "nvfp4" else torch.float8_e4m3fn
    scale_dt = torch.float8_e4m3fn if fmt == "nvfp4" else torch.bfloat16
    for t, dt in ((k_codes, code_dt), (v_codes, code_dt),
                  (k_scales, scale_dt), (v_scales, scale_dt)):
        if t.dtype != dt:
            raise ValueError(f"{fmt} cache operand must be {dt}, got "
                             f"{t.dtype}")


def flash_attention_packed(q: torch.Tensor, k_codes: torch.Tensor,
                           k_scales: torch.Tensor, v_codes: torch.Tensor,
                           v_scales: torch.Tensor, pos: torch.Tensor, *,
                           fmt: str = "nvfp4", block: int = 16,
                           causal: bool = True,
                           window: Optional[int] = None,
                           rolling: bool = False) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over a block-quantized KV cache.

    nvfp4: codes (B, Sk, KVH, D/2) uint8 + scales (B, Sk, KVH, D/block)
    float8_e4m3fn; fp8: codes (B, Sk, KVH, D) float8_e4m3fn + bf16 scales.
    ``pos``: int32 tensor (q_offset, kv_len) on q's device -- a device
    operand, so a decode loop never syncs on the cache length.  The window
    runs over linear positions (row = position), or, with ``rolling``,
    over a sliding-window buffer written at row pos % Sk (K5's rolling
    rule; needs a window).
    """
    _check_packed(q, k_codes, k_scales, v_codes, v_scales, pos, fmt, block)
    if rolling and window is None:
        raise ValueError("a rolling cache needs a window")
    if q.device.type == "cpu":
        return flash_attention_packed_plain(
            q, k_codes, k_scales, v_codes, v_scales, pos, fmt=fmt,
            block=block, causal=causal, window=window, rolling=rolling)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    B, Sq, H, D = q.shape
    Sk, KVH = k_codes.shape[1], k_codes.shape[2]
    if any(t.device != dev for t in (k_codes, k_scales, v_codes, v_scales,
                                     pos)):
        raise ValueError(f"the cache and pos must be on {dev}")
    if block % 2 or D % 32 or D > 256:
        raise ValueError(f"kernel takes even blocks and D in 32..256, "
                         f"got block {block}, D {D}")
    tensors = [t.contiguous() for t in (q, k_codes, k_scales, v_codes,
                                        v_scales, pos)]
    if any(t.data_ptr() % 16 for t in tensors[1:5]):
        raise ValueError("the cache must start on 16-byte boundaries")
    qv, keys = k6_plan(Sq, H, KVH, D, Sk)
    out = torch.empty_like(tensors[0])
    from repro_torch.kernels import _build
    fn = _build.library("flash_attn_paged").flash_attention_packed_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _I] + [_P] * 6 + [_I] * 12 + [ctypes.c_float] \
            + [_I] * 2 + [_P]
        fn.restype = _I
    err = fn(tensors[0].data_ptr(), int(q.dtype == torch.bfloat16),
             *(t.data_ptr() for t in tensors[1:]), out.data_ptr(),
             B, Sq, H, KVH, D, Sk, k_scales.shape[-1],
             PAGED_FORMATS.index(fmt), block, int(causal), int(window or 0),
             int(rolling), _sm_scale(D), qv, keys,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{PACKED_NAME} kernel launch failed: "
                           f"cudaError_t {err}")
    counters.bump(PACKED_NAME)
    return out


# ---- K5 ------------------------------------------------------------------------


def _dequant_pages(codes, scales, fmt: str, block: int) -> torch.Tensor:
    """Pages (..., page, KVH, Dc) -> (..., page, KVH, D) f32; the bf16 pool
    passes through unscaled (its scales are a placeholder)."""
    if fmt == "bf16":
        return codes.to(torch.float32)
    return _dequant_cache(codes, scales, fmt, block)


def swa_kpos(lengths: torch.Tensor, buf: int) -> torch.Tensor:
    """Absolute position held by each logical slot of a rolling buffer:
    slot j holds the most recent token with pos % buf == j.  (B,) lengths
    -> (B, buf); unwritten slots come out negative (Python floor modulo,
    as the TPU kernel)."""
    last = lengths[:, None] - 1
    slot = torch.arange(buf, dtype=lengths.dtype, device=lengths.device)
    return last - torch.remainder(torch.remainder(last, buf) - slot[None, :],
                                  buf)


def flash_attention_paged_plain(q, k_codes, k_scales, v_codes, v_scales,
                                page_table, lengths, q_offsets, *,
                                fmt: str = "nvfp4", block: int = 16,
                                causal: bool = True,
                                window: Optional[int] = None):
    """Plain version of K5: one page per step for every slot, gathered
    through ``page_table`` and dequantized, f32 online softmax.  A page
    runs for a slot only where the TPU kernel runs it (some logical slot
    below kv_len and, for a linear cache under the causal mask, at or
    before the slot's last query position); a skipped page leaves the
    running (m, l, acc) as they are."""
    B, Sq, H, D = q.shape
    _, psz, KVH, _ = k_codes.shape
    n_pages = page_table.shape[1]
    buf = n_pages * psz
    G = H // KVH
    dev = q.device
    scale = _sm_scale(D)
    pt = page_table.to(device=dev, dtype=torch.int64)
    kv_len = torch.clamp(lengths.to(device=dev, dtype=torch.int32), max=buf)
    q_off = q_offsets.to(device=dev, dtype=torch.int32)
    qpos = q_off[:, None] + torch.arange(Sq, dtype=torch.int32, device=dev)
    qf = q.to(torch.float32).reshape(B, Sq, KVH, G, D)
    # absolute position of every logical slot: itself for a linear cache,
    # the rolling rule relative to the block's last query row for a window
    kpos_all = (torch.arange(buf, dtype=torch.int32, device=dev)[None, :]
                .expand(B, -1) if window is None else swa_kpos(q_off + Sq,
                                                               buf))
    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32, device=dev)
    for ki in range(n_pages):
        j = ki * psz + torch.arange(psz, dtype=torch.int32, device=dev)
        run = ki * psz < kv_len                                   # (B,)
        if window is None and causal:
            run = run & (ki * psz <= q_off + Sq - 1)
        phys = pt[:, ki]
        kf = _dequant_pages(k_codes[phys], k_scales[phys], fmt, block)
        vf = _dequant_pages(v_codes[phys], v_scales[phys], fmt, block)
        kpos = kpos_all[:, ki * psz:(ki + 1) * psz]               # (B, psz)
        valid = ((j[None, :] < kv_len[:, None]) & (kpos >= 0))[:, None, :]
        if causal:
            valid = valid & (kpos[:, None, :] <= qpos[:, :, None])
        if window is not None:
            valid = valid & (kpos[:, None, :] > qpos[:, :, None] - window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
        s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new.unsqueeze(-1))
        l_new = l * corr + torch.sum(p, dim=-1)
        acc_new = acc * corr.unsqueeze(-1) + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vf)
        r = run[:, None, None, None]
        m = torch.where(r, m_new, m)
        l = torch.where(r, l_new, l)
        acc = torch.where(r[..., None], acc_new, acc)
    o = acc / torch.clamp(l, min=1e-30).unsqueeze(-1)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _check_paged(q, k_codes, k_scales, v_codes, v_scales, page_table,
                 lengths, q_offsets, fmt, block):
    if q.ndim != 4 or k_codes.ndim != 4:
        raise ValueError(f"q must be (B, Sq, H, D) and the pools "
                         f"(P, page, KVH, Dc), got {tuple(q.shape)} and "
                         f"{tuple(k_codes.shape)}")
    B, Sq, H, D = q.shape
    P, psz, KVH, Dc = k_codes.shape
    if fmt not in PAGED_FORMATS:
        raise ValueError(f"unknown paged KV format {fmt!r}")
    want_dc = D // 2 if fmt == "nvfp4" else D
    if Dc != want_dc or D % block:
        raise ValueError(f"bad paged layout: codes last dim {Dc}, head dim "
                         f"{D}, block {block}")
    if H % KVH:
        raise ValueError(f"GQA: H={H} not a multiple of KVH={KVH}")
    if tuple(v_codes.shape) != tuple(k_codes.shape):
        raise ValueError(f"v pool {tuple(v_codes.shape)} != k pool "
                         f"{tuple(k_codes.shape)}")
    for t in (k_scales, v_scales):
        nb = t.shape[-1] if t.ndim == 4 else -1
        if tuple(t.shape[:3]) != (P, psz, KVH) or \
                (fmt != "bf16" and nb != D // block):
            raise ValueError(f"scales shape {tuple(t.shape)} does not match "
                             f"the pool {(P, psz, KVH)} x D/block")
    if page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B={B}, n_pages), got "
                         f"{tuple(page_table.shape)}")
    for name, t in (("lengths", lengths), ("q_offsets", q_offsets)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")


# K5's split plan on the card (csrc/flash_attn_paged.cu): a block holds up to
# k5_qmax(D) query vectors (heads of a GQA group x query rows) and one split
# of K5_TILE-key tiles (one key per lane of 4 warps) of a slot's logical key
# range; enough splits that the blocks number about K5_BLOCKS.
K5_TILE = 128
K5_BLOCKS = 2048


def k5_qmax(D: int) -> int:
    """Query vectors one K5 block holds: each lane keeps D/32 dims of each
    in registers (min(8, 32 / (D / 32)))."""
    return min(8, 1024 // D)


def k5_plan(B: int, Sq: int, H: int, KVH: int, D: int, page_size: int,
            n_pages: int) -> Tuple[int, int, int]:
    """(query vectors per block, keys per split, splits) of K5, from static
    shapes alone -- never from ``lengths`` or ``q_offsets``: the slot's
    logical range n_pages * page_size is cut into equal splits, multiples
    of K5_TILE keys, enough for about K5_BLOCKS blocks over (split, kv
    head, query-vector group, slot)."""
    nqv = Sq * (H // KVH)
    qv = min(nqv, k5_qmax(D))
    base = B * KVH * -(-nqv // qv)
    buf = n_pages * page_size
    want = min(max(1, -(-K5_BLOCKS // base)), -(-buf // K5_TILE))
    keys = -(-(-(-buf // want)) // K5_TILE) * K5_TILE
    return qv, keys, -(-buf // keys)


# K6's plan on the card: K5's split-KV body over the contiguous cache (one
# page of Sk rows per slot), always in one split.  At the lockstep decode
# B * KVH blocks already cover the SMs and K5's combine launch alone costs
# more than K6's byte bound; no workload has a cache long enough to measure
# where more splits would pay.


def k6_plan(Sq: int, H: int, KVH: int, D: int, Sk: int) -> Tuple[int, int]:
    """(query vectors per block, keys of the one split) of K6, from static
    shapes alone -- never from ``pos``: the split covers Sk in whole
    K5_TILE-key tiles."""
    qv = min(Sq * (H // KVH), k5_qmax(D))
    return qv, -(-Sk // K5_TILE) * K5_TILE


def flash_attention_paged(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scales: torch.Tensor, v_codes: torch.Tensor,
                          v_scales: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, q_offsets: torch.Tensor, *,
                          fmt: str = "nvfp4", block: int = 16,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over a PAGED block-quantized KV pool.

    Pools (P, page, KVH, Dc): nvfp4 uint8 nibble pairs + float8_e4m3fn
    scales (P, page, KVH, D/block); fp8 float8_e4m3fn codes + bf16 scales;
    bf16 codes with the scales ignored.  ``page_table`` (B, n_pages) int32
    physical page per logical page; ``lengths`` (B,) valid tokens per slot
    (kv_len, clamped to the slot buffer); ``q_offsets`` (B,) absolute
    position of each slot's q row 0.  All three are device operands, so
    the host never syncs on a length.  ``window``: sliding window over a
    ROLLING buffer (slot j holds the latest pos with pos % buf == j).
    Output in q's dtype.
    """
    _check_paged(q, k_codes, k_scales, v_codes, v_scales, page_table,
                 lengths, q_offsets, fmt, block)
    if q.device.type == "cpu":
        return flash_attention_paged_plain(
            q, k_codes, k_scales, v_codes, v_scales, page_table, lengths,
            q_offsets, fmt=fmt, block=block, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    B, Sq, H, D = q.shape
    _, psz, KVH, _ = k_codes.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("q must be bf16 or f32")
    code_dt = {"nvfp4": torch.uint8, "fp8": torch.float8_e4m3fn,
               "bf16": torch.bfloat16}[fmt]
    scale_dt = {"nvfp4": torch.float8_e4m3fn, "fp8": torch.bfloat16,
                "bf16": torch.bfloat16}[fmt]
    for t, dt in ((k_codes, code_dt), (v_codes, code_dt),
                  (k_scales, scale_dt), (v_scales, scale_dt)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{fmt} pool operand must be {dt} on {dev}")
    for t in (page_table, lengths, q_offsets):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError("page_table, lengths and q_offsets must be "
                             "int32 on q's device")
    if block % 2 or D % 32 or D > 256:
        raise ValueError(f"kernel takes even blocks and D in 32..256, "
                         f"got block {block}, D {D}")
    tensors = [t.contiguous() for t in (q, k_codes, k_scales, v_codes,
                                        v_scales, page_table, lengths,
                                        q_offsets)]
    if any(t.data_ptr() % 16 for t in tensors[1:5]):
        raise ValueError("the pools must start on 16-byte boundaries")
    n_pages = page_table.shape[1]
    qv, keys, splits = k5_plan(B, Sq, H, KVH, D, psz, n_pages)
    out = torch.empty_like(tensors[0])
    ws_ml = torch.empty((B, Sq, H, splits, 2), dtype=torch.float32,
                        device=dev)
    ws_acc = torch.empty((B, Sq, H, splits, D), dtype=torch.float32,
                         device=dev)
    from repro_torch.kernels import _build
    fn = _build.library("flash_attn_paged").flash_attention_paged_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _I] + [_P] * 10 + [_I] * 12 + [ctypes.c_float] \
            + [_I] * 3 + [_P]
        fn.restype = _I
    err = fn(tensors[0].data_ptr(), int(q.dtype == torch.bfloat16),
             *(t.data_ptr() for t in tensors[1:]), out.data_ptr(),
             ws_ml.data_ptr(), ws_acc.data_ptr(), B, Sq, H, KVH, D, psz,
             n_pages, k_scales.shape[-1], PAGED_FORMATS.index(fmt), block,
             int(causal), int(window or 0), _sm_scale(D), qv, keys, splits,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{PAGED_NAME} kernel launch failed: "
                           f"cudaError_t {err}")
    counters.bump(PAGED_NAME)
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


def _check_dense(q, k, v):
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"GQA: H={H} not a multiple of KVH={KVH}")
    if tuple(k.shape) != (B, Sk, KVH, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, bf16 or f32")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention forward.  q: (B, Sq, H, D); k/v: (B, Sk, KVH, D), all bf16
    or all f32; any Sq and Sk (the ragged edge is masked)."""
    _check_dense(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    D = q.shape[3]
    if D not in (32, 64, 96, 128):
        raise ValueError(f"kernel takes head dims 32/64/96/128, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    B, Sq, H, _ = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    # the kernel copies rows in 16-byte pieces; with D % 32 == 0 every row
    # is 16-byte aligned where the tensor's start is
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
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
