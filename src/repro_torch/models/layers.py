"""Shared neural building blocks (PyTorch): the serving and training paths.

Counterpart of ``repro.models.layers``.  Every weight GEMM goes through
``QCtx.dense`` -> ``fqt.dense``: the K1 kernel in training, the K4 kernel
for packed serving weights.  Serving prefill attention is the K7 kernel,
decode attention over a ``PackedKVCache`` the K6 kernel.  Training
attention (no cache) is ``attention_core``: dense f32 softmax for short
sequences, else the chunked flash attention with its own backward, both in
plain PyTorch as the reference has no Pallas kernel there.  KV-cache writes
quantize rows with ``kv_quant_rows`` in plain PyTorch, as the reference does
in jnp, and write them into the preallocated cache IN PLACE
(``index_copy_``) where JAX returns a new array.  The cache length and the
(q_offset, kv_len) pair stay device tensors, so a decode step never syncs
with the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import fqt
from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.core.quantize import kv_quant_rows
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_packed)

NEG_INF = -1e30
_ROLLING = ("sliding-window (rolling) KV caches arrive with the "
            "ContinuousEngine slice (ROADMAP Queue 1: K5 "
            "flash_attention_paged and the rolling kpos rule)")


class QCtx:
    """Quantization context: the static QuantConfig and a per-call SR seed
    stream.  A fresh QCtx is made per (layer, step); each ``dense`` call
    gets its own seed ``seed + n * 40503`` (uint32), in call order, so a
    recomputed (rematerialised) layer draws the same streams."""

    def __init__(self, qcfg: QuantConfig, seed: int = 0):
        self.qcfg = qcfg
        self.seed = int(seed) & M32
        self._n = 0

    def fold(self, idx: int) -> "QCtx":
        """Child context for layer/expert ``idx``."""
        return QCtx(self.qcfg, (self.seed + int(idx) * 2654435761) & M32)

    def dense(self, x: torch.Tensor, w, b: Optional[torch.Tensor] = None):
        s = (self.seed + self._n * 40503) & M32
        self._n += 1
        return fqt.dense(x, w, b, cfg=self.qcfg, seed=s)


# ---- initializers -------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---- norms / activations ---------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """f32 statistics, cast to x's dtype, THEN scaled by w."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype) \
        * up


def smooth_swiglu(gate: torch.Tensor, up: torch.Tensor,
                  smooth: torch.Tensor) -> torch.Tensor:
    """Smooth-SwiGLU: ``up`` is divided by the per-channel factor before
    the product (the factor is folded into w_down)."""
    z = torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype)
    return z * (up / smooth)


# ---- rotary embeddings ---------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for absolute positions: (..., head_dim // 2)."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(float(theta), expo)     # no host-to-device copy
    ang = positions.unsqueeze(-1).to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---- training attention (plain PyTorch, as the reference's jnp) -----------------


def _attn_dense(q, k, v, qpos, kpos, causal, window):
    """Dense-softmax attention in f32 for short sequences.
    q: (B, Sq, KVH, G, D); k/v: (B, Sk, KVH, D); *pos: (Sq,)/(Sk,)."""
    f32 = torch.float32
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(f32), k.to(f32)) \
        * (q.shape[-1] ** -0.5)
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(f32))


def _flash_mask(qpch, kp, causal, window):
    """(nq, qc, kc) mask, broadcast to (B, nq, h, g, q, k)."""
    mask = torch.ones((qpch.shape[0], qpch.shape[1], kp.shape[0]),
                      dtype=torch.bool, device=qpch.device)
    if causal:
        mask = mask & (kp[None, None, :] <= qpch[:, :, None])
    if window is not None:
        mask = mask & (kp[None, None, :] > qpch[:, :, None] - window)
    return mask[None, :, None, None, :, :]


def _dot32(eq, a, b):
    """einsum of bf16 (or f32) operands with f32 accumulation."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _flash_fwd_impl(q, k, v, qpos, kpos, causal, window, qc, kc):
    """q blocks as a leading dim, kv chunks in a loop with running (max,
    denom, acc).  Returns (out, m, l) blocked as (B, nq, qc, KVH, G, .)."""
    B, Sq, KVH, G, D = q.shape
    nq, nk = Sq // qc, k.shape[1] // kc
    scale = D ** -0.5
    qch = q.reshape(B, nq, qc, KVH, G, D)
    qpch = qpos.reshape(nq, qc)
    f32 = torch.float32
    m = torch.full((B, nq, KVH, G, qc), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, nq, KVH, G, qc), dtype=f32, device=q.device)
    acc = torch.zeros((B, nq, qc, KVH, G, D), dtype=f32, device=q.device)
    for j in range(nk):
        ki, vi = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
        kp = kpos[j * kc:(j + 1) * kc]
        s = _dot32("bnqhgd,bkhd->bnhgqk", qch, ki) * scale
        s = torch.where(_flash_mask(qpch, kp, causal, window), s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        pv = _dot32("bnhgqk,bkhd->bnqhgd", p.to(ki.dtype), vi)
        acc = acc * corr.permute(0, 1, 4, 2, 3)[..., None] + pv
        m = m_new
    denom = torch.clamp(l, min=1e-30).permute(0, 1, 4, 2, 3)[..., None]
    return acc / denom, m, l


class _AttnFlash(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_attn_flash``: the backward
    recomputes s and p per kv chunk from the saved (q, k, v, out, m, l)
    (the flash-attention backward, O(B*S*H*D) residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window, qc, kc):
        out, m, l = _flash_fwd_impl(q, k, v, qpos, kpos, causal, window,
                                    qc, kc)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, m, l)
        ctx.cfg = (causal, window, qc, kc)
        return out.reshape(q.shape)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, out, m, l = ctx.saved_tensors
        causal, window, qc, kc = ctx.cfg
        B, Sq, KVH, G, D = q.shape
        Sk = k.shape[1]
        nq, nk = Sq // qc, Sk // kc
        scale = D ** -0.5
        f32 = torch.float32
        qch = q.reshape(B, nq, qc, KVH, G, D)
        qpch = qpos.reshape(nq, qc)
        do = dout.reshape(B, nq, qc, KVH, G, D).to(f32)
        l_safe = torch.clamp(l, min=1e-30)                   # (B,nq,h,g,qc)
        dsum = torch.sum(do * out, dim=-1).permute(0, 1, 3, 4, 2)
        dob = do.to(q.dtype)
        dq = torch.zeros((B, nq, qc, KVH, G, D), dtype=f32, device=q.device)
        dks, dvs = [], []
        for j in range(nk):
            ki, vi = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
            kp = kpos[j * kc:(j + 1) * kc]
            s = _dot32("bnqhgd,bkhd->bnhgqk", qch, ki) * scale
            s = torch.where(_flash_mask(qpch, kp, causal, window), s,
                            torch.full_like(s, NEG_INF))
            p = torch.exp(s - m[..., None]) / l_safe[..., None]
            pb = p.to(q.dtype)
            dvs.append(_dot32("bnhgqk,bnqhgd->bkhd", pb, dob))
            dp = _dot32("bnqhgd,bkhd->bnhgqk", dob, vi)
            dsb = (p * (dp - dsum[..., None]) * scale).to(q.dtype)
            dq = dq + _dot32("bnhgqk,bkhd->bnqhgd", dsb, ki)
            dks.append(_dot32("bnhgqk,bnqhgd->bkhd", dsb, qch))
        dq = dq.reshape(B, Sq, KVH, G, D).to(q.dtype)
        dk = torch.cat(dks, dim=1).to(k.dtype)
        dv = torch.cat(dvs, dim=1).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   qpos: torch.Tensor, kpos: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   chunk: int = 1024) -> torch.Tensor:
    """GQA training attention.  q: (B, Sq, H, D), k/v: (B, Sk, KVH, D).
    Dense f32 softmax when Sq * Sk <= chunk^2 (or the lengths do not tile),
    else the chunked flash attention; the reference's dispatch."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, D)
    Sk = k.shape[1]
    if Sq * Sk <= chunk * chunk or Sq % min(chunk, Sq) != 0 \
            or Sk % chunk != 0:
        o = _attn_dense(qg, k, v, qpos, kpos, causal, window)
    else:
        o = _AttnFlash.apply(qg, k, v, qpos, kpos, causal, window,
                             min(chunk, Sq), chunk)
    return o.reshape(B, Sq, H, D).to(q.dtype)


# ---- serving attention ----------------------------------------------------------


def _attn_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Attention of a fresh prompt (positions 0..S-1) into a cache: the K7
    kernel.  q: (B, Sq, H, D), k/v: (B, Sk, KVH, D).

    The reference's serving prefill keeps p in f32 (``_attn_dense``), so
    K7 gets f32 operands (the bf16 upcast is exact) and then has no
    lower-precision V to round p to; the result is cast back to q's dtype
    as the reference casts it.  FP4 re-quantization of the next GEMM's
    input turns a bf16-rounded p into flipped codes, so this keeps the
    served tokens on the reference's."""
    f32 = torch.float32
    o = flash_attention(q.to(f32), k.to(f32), v.to(f32), causal=causal,
                        window=window)
    return o.to(q.dtype)


def _attn_decode_dense(q, k, v, pos, *, causal, window) -> torch.Tensor:
    """Decode read of a bf16 cache: the dense f32 softmax with the kv_len
    and causal masks (the jnp ``_attn_dense`` of the reference, no
    kernel); rows at or past kv_len get a key position above any query."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qpos = pos[0] + torch.arange(Sq, dtype=torch.int32, device=q.device)
    kpos = torch.arange(Sk, dtype=torch.int32, device=q.device)
    kpos = torch.where(kpos < pos[1], kpos, torch.full_like(kpos, 2 ** 30))
    o = _attn_dense(q.reshape(B, Sq, KVH, H // KVH, D), k, v, qpos, kpos,
                    causal, window)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def attn_params(gen, d_model: int, n_heads: int, n_kv: int, hd: int,
                bias: bool = False, dtype=torch.bfloat16, qk_norm=False,
                device=None):
    p = {
        "wq": dense_init(gen, d_model, n_heads * hd, dtype, device=device),
        "wk": dense_init(gen, d_model, n_kv * hd, dtype, device=device),
        "wv": dense_init(gen, d_model, n_kv * hd, dtype, device=device),
        "wo": dense_init(gen, n_heads * hd, d_model, dtype, device=device),
    }
    if bias:
        for name, n in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    if qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


@dataclasses.dataclass
class KVCache:
    """Per-layer bf16 KV cache (the unquantized escape hatch)."""
    k: torch.Tensor          # (B, S_buf, KVH, D)
    v: torch.Tensor
    length: torch.Tensor     # int32 scalar on the device: tokens written

    @staticmethod
    def init(batch: int, buf: int, n_kv: int, hd: int, dtype=torch.bfloat16,
             device=None) -> "KVCache":
        z = torch.zeros((batch, buf, n_kv, hd), dtype=dtype, device=device)
        return KVCache(z, torch.zeros_like(z),
                       torch.zeros((), dtype=torch.int32, device=device))

    @property
    def buf(self) -> int:
        return self.k.shape[1]


@dataclasses.dataclass
class PackedKVCache:
    """Block-quantized per-layer KV cache: nvfp4 (uint8 nibble pairs +
    float8_e4m3fn scales, 0.5625 B/elem) or fp8 (float8_e4m3fn codes +
    bf16 scales, 1.125 B/elem), rows quantized along the head dim."""

    k_codes: torch.Tensor    # (B, S_buf, KVH, D/2) u8 | (B, S_buf, KVH, D) f8
    k_scales: torch.Tensor   # (B, S_buf, KVH, D/block) f8e4m3 | bf16
    v_codes: torch.Tensor
    v_scales: torch.Tensor
    length: torch.Tensor     # int32 scalar on the device
    fmt: str = "nvfp4"
    block: int = 16

    @staticmethod
    def init(batch: int, buf: int, n_kv: int, hd: int, fmt: str = "nvfp4",
             block: int = 16, device=None) -> "PackedKVCache":
        if hd % block or hd % 2:
            raise ValueError(
                f"packed KV cache needs head_dim divisible by block={block} "
                f"(and even), got head_dim={hd}")
        if fmt == "nvfp4":
            codes = torch.zeros((batch, buf, n_kv, hd // 2), dtype=torch.uint8,
                                device=device)
            scales = torch.ones((batch, buf, n_kv, hd // block),
                                device=device).to(torch.float8_e4m3fn)
        elif fmt == "fp8":
            codes = torch.zeros((batch, buf, n_kv, hd), device=device
                                ).to(torch.float8_e4m3fn)
            scales = torch.ones((batch, buf, n_kv, hd // block),
                                dtype=torch.bfloat16, device=device)
        else:
            raise ValueError(f"unknown packed KV format {fmt!r}")
        return PackedKVCache(codes, scales, codes.clone(), scales.clone(),
                             torch.zeros((), dtype=torch.int32, device=device),
                             fmt, block)

    @property
    def buf(self) -> int:
        return self.k_codes.shape[1]

    def nbytes(self) -> int:
        """Stored cache bytes (codes + scales, k and v)."""
        return int(sum(a.numel() * a.element_size() for a in
                       (self.k_codes, self.k_scales,
                        self.v_codes, self.v_scales)))


def make_kv_cache(batch: int, buf: int, n_kv: int, hd: int,
                  dtype=torch.bfloat16, kv_format: str = "bf16",
                  device=None):
    """bf16 ``KVCache`` or block-quantized ``PackedKVCache``."""
    if kv_format == "bf16":
        return KVCache.init(batch, buf, n_kv, hd, dtype, device=device)
    return PackedKVCache.init(batch, buf, n_kv, hd, fmt=kv_format,
                              device=device)


def _storage_view(t: torch.Tensor) -> torch.Tensor:
    """float8 storage as its bytes (a bit-preserving view for copies)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _write_cache(cache, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Write S new rows at [length, length + S) IN PLACE; returns the
    (old) length tensor.  Linear caches only."""
    S, buf = k.shape[1], cache.buf
    if S > buf:
        raise ValueError(f"{S} new tokens exceed the cache buffer {buf}")
    start = cache.length
    idx = (start + torch.arange(S, dtype=torch.int32, device=k.device)) % buf
    idx = idx.to(torch.int64)
    if isinstance(cache, PackedKVCache):
        kcod, ksc = kv_quant_rows(k, cache.fmt, cache.block)
        vcod, vsc = kv_quant_rows(v, cache.fmt, cache.block)
        for dst, src in ((cache.k_codes, kcod), (cache.k_scales, ksc),
                         (cache.v_codes, vcod), (cache.v_scales, vsc)):
            _storage_view(dst).index_copy_(1, idx, _storage_view(src))
    else:
        cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
    cache.length = start + S
    return start


def attn_apply(p, x: torch.Tensor, ctx: QCtx, *, n_heads: int, n_kv: int,
               hd: int, rope_theta: float, causal: bool = True,
               window: Optional[int] = None, chunk: int = 1024, cache=None,
               norm_eps: float = 1e-5):
    """Self-attention with an optional KV cache update (updated in place).

    Without a cache (training) the sequence attends itself through
    ``attention_core``.  With a cache, x is the NEW tokens written at
    [cache.length, cache.length + S): prefill (S > 1, from an empty cache)
    attends within the fresh sequence through K7; decode (S == 1) attends
    the cache -- K6 for a ``PackedKVCache``, a dense read for the bf16
    cache.  Returns (out, cache)."""
    B, S, _ = x.shape
    q = ctx.dense(x, p["wq"], p.get("bq")).reshape(B, S, n_heads, hd)
    k = ctx.dense(x, p["wk"], p.get("bk")).reshape(B, S, n_kv, hd)
    v = ctx.dense(x, p["wv"], p.get("bv")).reshape(B, S, n_kv, hd)
    base = cache.length if cache is not None else torch.zeros(
        (), dtype=torch.int32, device=x.device)
    positions = base + torch.arange(S, dtype=torch.int32, device=x.device)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], norm_eps)
        k = rmsnorm(k, p["k_norm"], norm_eps)
    cos, sin = rope_tables(positions, hd, rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])

    if cache is None:
        o = attention_core(q, k, v, qpos=positions, kpos=positions,
                           causal=causal, window=window, chunk=chunk)
    elif S > 1:
        if window is not None:
            raise NotImplementedError(_ROLLING)
        _write_cache(cache, k, v)
        o = _attn_prefill(q, k, v, causal=causal, window=window)
    else:
        if window is not None:
            raise NotImplementedError(_ROLLING)
        start = _write_cache(cache, k, v)
        kv_len = torch.clamp(cache.length, max=cache.buf)
        pos = torch.stack([start, kv_len]).to(torch.int32)
        if isinstance(cache, PackedKVCache):
            o = flash_attention_packed(
                q, cache.k_codes, cache.k_scales, cache.v_codes,
                cache.v_scales, pos, fmt=cache.fmt, block=cache.block,
                causal=causal, window=window)
        else:
            o = _attn_decode_dense(q, cache.k, cache.v, pos, causal=causal,
                                   window=window)
    out = ctx.dense(o.reshape(B, S, n_heads * hd), p["wo"])
    return out, cache


# ---- MLP block ------------------------------------------------------------------


def mlp_params(gen, d_model: int, d_ff: int, act: str, dtype=torch.bfloat16,
               device=None):
    if act not in ("swiglu", "smooth_swiglu"):
        raise NotImplementedError(
            f"activation {act!r} arrives with the breadth families (ROADMAP "
            f"Queue 1)")
    p = {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device=device),
    }
    if act == "smooth_swiglu":
        p["smooth"] = torch.ones((d_ff,), dtype=dtype, device=device)
    return p


def mlp_apply(p, x: torch.Tensor, ctx: QCtx, act: str) -> torch.Tensor:
    g = ctx.dense(x, p["w_gate"])
    u = ctx.dense(x, p["w_up"])
    if act == "smooth_swiglu":
        return ctx.dense(smooth_swiglu(g, u, p["smooth"]), p["w_down"])
    if act == "swiglu":
        return ctx.dense(swiglu(g, u), p["w_down"])
    raise NotImplementedError(
        f"activation {act!r} arrives with the breadth families (ROADMAP "
        f"Queue 1)")
