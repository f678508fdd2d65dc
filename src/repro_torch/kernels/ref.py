"""Plain PyTorch oracles of the kernels: the port's copy of
``repro/kernels/ref.py``, on any device, no kernel.

They mirror the kernels' semantics exactly (same scale rules, same uniform-
bits convention for SR), so a kernel or its plain version is held to them
bit for bit (quantizers) or to summation order (products, attention).
``fused_quant_matmul_ref`` is K1's plain version itself, which computes
the same function with the same arguments; ``block_matmul_ref`` calls
K3's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import formats
from repro_torch.core.quantize import (BlockQuantSpec, _tensor_scale,
                                       kv_dequant)
from repro_torch.kernels.flash_attn import swa_kpos
from repro_torch.kernels.fp4_matmul import (block_matmul_plain,
                                            fused_quant_matmul_plain)
from repro_torch.models.layers import _kv_dequant_any, attention_core

fused_quant_matmul_ref = fused_quant_matmul_plain

_FAR = 2 ** 30                 # a key position above any query position


def tensor_scale_ref(x: torch.Tensor, spec: BlockQuantSpec) -> torch.Tensor:
    """Per-tensor pow2 scale (a device scalar: no host sync)."""
    return _tensor_scale(torch.amax(torch.abs(x.to(torch.float32))), spec)


def block_quant_ref(x: torch.Tensor, spec: BlockQuantSpec, *,
                    rbits: Optional[torch.Tensor] = None,
                    tscale: Optional[torch.Tensor] = None,
                    axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block quantization along ``axis``; returns (codes, scales).

    ``codes`` are E2M1 grid values in x.dtype; reconstruct with codes *
    repeat(scales, B, axis) * tscale.  SR reads uint32 ``rbits`` of x's
    shape.
    """
    axis = axis % x.ndim
    B = spec.block
    xf = x.to(torch.float32)
    if tscale is None:
        tscale = tensor_scale_ref(x, spec)
    tscale = torch.as_tensor(tscale, dtype=torch.float32, device=x.device)
    moved = torch.movedim(xf, axis, -1)
    nb = moved.shape[-1] // B
    xb = moved.reshape(-1, nb, B)
    absmax = torch.amax(torch.abs(xb), dim=-1)                  # (R, nb)
    if spec.scale_fmt == "e8m0":
        scales = formats.e8m0_floor(absmax) / (2.0 ** spec.data.emax)
        scales = torch.where(absmax > 0, scales, torch.ones_like(scales))
    else:
        raw = absmax / (spec.data.max * tscale)
        scales = formats.quantize_rtn(raw, spec.scale)
        scales = torch.where(scales > 0, scales, torch.ones_like(scales))
    scaled = xb / (scales.unsqueeze(-1) * tscale)
    if spec.stochastic:
        if rbits is None:
            raise ValueError("SR requires rbits")
        rb = torch.movedim(rbits, axis, -1).reshape(-1, nb, B)
        u = formats.uniform_from_bits(rb)
        codes = formats.quantize_sr_with_u(scaled, spec.data, u)
    else:
        codes = formats.quantize_rtn(scaled, spec.data)

    def _restore(a, last):
        return torch.movedim(a.reshape(tuple(moved.shape[:-1]) + (last,)),
                             -1, axis)
    return (_restore(codes, nb * B).to(x.dtype),
            _restore(scales, nb).to(torch.float32))


def block_matmul_ref(a_codes: torch.Tensor, a_scales: torch.Tensor,
                     b_codes: torch.Tensor, b_scales: torch.Tensor,
                     tscale, block: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) x (K, N) block-scaled matmul, f32 accumulation: K3's plain
    version, cast to ``out_dtype``.

    a blocked along K (scales (M, K/B)); b blocked along K (scales (K/B,
    N)); ``tscale`` = tscale_a * tscale_b applied at the end.
    """
    return block_matmul_plain(a_codes, a_scales, b_codes, b_scales, tscale,
                              block=block).to(out_dtype)


def _below(kpos: torch.Tensor, kv_len) -> torch.Tensor:
    """kpos with the slots at or past ``kv_len`` pushed above any query."""
    j = torch.arange(kpos.shape[-1], dtype=torch.int32, device=kpos.device)
    return torch.where(j < kv_len, kpos, torch.full_like(kpos, _FAR))


def packed_attention_ref(q: torch.Tensor, k_codes: torch.Tensor,
                         k_scales: torch.Tensor, v_codes: torch.Tensor,
                         v_scales: torch.Tensor, *, fmt: str = "nvfp4",
                         block: int = 16, causal: bool = True,
                         window: Optional[int] = None, kv_len=None,
                         q_offset: int = 0) -> torch.Tensor:
    """Oracle of K6 and the packed decode read: dequantize the WHOLE cache,
    then dense softmax, with the same storage grid and masks."""
    Sq, Sk = q.shape[1], k_codes.shape[1]
    dev = q.device
    k = kv_dequant(k_codes, k_scales, fmt, block, torch.float32)
    v = kv_dequant(v_codes, v_scales, fmt, block, torch.float32)
    qpos = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)
    kpos = torch.arange(Sk, dtype=torch.int32, device=dev)
    if kv_len is not None:
        kpos = _below(kpos, torch.as_tensor(kv_len, dtype=torch.int32,
                                            device=dev))
    return attention_core(q.to(torch.float32), k, v, qpos=qpos, kpos=kpos,
                          causal=causal, window=window,
                          chunk=_FAR).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_codes: torch.Tensor,
                        k_scales: torch.Tensor, v_codes: torch.Tensor,
                        v_scales: torch.Tensor, page_table, lengths,
                        q_offsets, *, fmt: str = "nvfp4", block: int = 16,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Oracle of K5 and the paged decode read: gather every slot's logical
    buffer through the page table, dequantize the WHOLE cache, then dense
    softmax PER SLOT with that slot's own (q_offset, kv_len).

    q: (B, Sq, H, D); codes/scales: the page-pool layout (P, page, KVH, .);
    page_table: (B, n_pages); lengths/q_offsets: (B,).
    """
    B, Sq = q.shape[:2]
    dev = q.device
    psz = k_codes.shape[1]
    pt = torch.as_tensor(page_table, device=dev).to(torch.int64)
    buf = pt.shape[1] * psz

    def gather(pool):
        return pool[pt].reshape((B, buf) + tuple(pool.shape[2:]))

    k = _kv_dequant_any(gather(k_codes), gather(k_scales), fmt, block,
                        torch.float32)
    v = _kv_dequant_any(gather(v_codes), gather(v_scales), fmt, block,
                        torch.float32)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    q_offsets = torch.as_tensor(q_offsets, device=dev).to(torch.int32)
    outs = []
    for i in range(B):                         # per-slot dense attention
        qpos = q_offsets[i] + torch.arange(Sq, dtype=torch.int32, device=dev)
        if window is None:
            kpos = torch.arange(buf, dtype=torch.int32, device=dev)
        else:
            kpos = swa_kpos((q_offsets[i] + Sq)[None], buf)[0]
            kpos = torch.where(kpos >= 0, kpos, torch.full_like(kpos, _FAR))
        kpos = _below(kpos, torch.clamp(lengths[i], max=buf))
        outs.append(attention_core(
            q[i:i + 1].to(torch.float32), k[i:i + 1], v[i:i + 1], qpos=qpos,
            kpos=kpos, causal=causal, window=window, chunk=_FAR))
    return torch.cat(outs, dim=0).to(q.dtype)
