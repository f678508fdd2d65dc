"""Shared neural building blocks (PyTorch): the serving and training paths.

Counterpart of ``repro.models.layers``.  Every weight GEMM goes through
``QCtx.dense`` -> ``fqt.dense``: the K1 kernel in training, the K4 kernel
for packed serving weights.  Serving prefill attention is the K7 kernel,
decode attention over a ``PackedKVCache`` the K6 kernel.  Training
attention (no cache) is ``attention_core``: dense f32 softmax for short
sequences, else the chunked flash attention with its own backward, both in
plain PyTorch as the reference has no Pallas kernel there; a serving caller
of the cacheless paths (whisper's encoder and cross-attention) asks for K7
instead.  The MLPs are SwiGLU or the reference's tanh GELU (``refnum``).  KV-cache writes
quantize rows with ``kv_quant_rows`` in plain PyTorch, as the reference does
in jnp, and write them into the preallocated cache IN PLACE
(``index_copy_``/``index_put_``) where JAX returns a new array.  The cache
length and the (q_offset, kv_len) pair stay device tensors, so a decode step
never syncs with the host.

The paged half (continuous batching): ``PagedKVCache`` keeps the physical
page pool, a page table and per-slot lengths; every read of it -- batched
decode, speculative verify, suffix and chunked prefill -- goes through the
K5 kernel (``flash_attention_paged``), which the reference computes with jnp
over ``gather_slots`` (``_attn_decode_paged``).  Cold prefill-into-slot
attends within the fresh prompt through K7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import fqt
from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.core.quantize import kv_dequant, kv_quant_rows
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_packed,
                                            flash_attention_paged)
from repro_torch.models import refnum
# the rolling-window position rule lives beside K5 and K6, which apply it;
# it is public here too, where the reference's models/layers.py keeps it
from repro_torch.kernels.flash_attn import swa_kpos

NEG_INF = -1e30


class QCtx:
    """Quantization context: the static QuantConfig and a per-call SR seed
    stream.  A fresh QCtx is made per (layer, step); each ``dense`` call
    gets its own seed ``seed + n * 40503`` (uint32), in call order, so a
    recomputed (rematerialised) layer draws the same streams.

    ``mesh``: the serving mesh whose shards the weights are
    (``distributed/mesh.py``); ``dense(..., kind=)`` names the weight's
    sharding rule ("io" column-parallel, "oi" row-parallel, "d_vocab" the
    lm_head), which picks the Megatron form on a multi-rank mesh."""

    def __init__(self, qcfg: QuantConfig, seed: int = 0, mesh=None):
        self.qcfg = qcfg
        self.seed = int(seed) & M32
        self.mesh = mesh
        self._n = 0

    def fold(self, idx: int) -> "QCtx":
        """Child context for layer/expert ``idx``."""
        return QCtx(self.qcfg, (self.seed + int(idx) * 2654435761) & M32,
                    self.mesh)

    def next_seed(self) -> int:
        """The SR seed of the next ``dense`` call (which it consumes): for
        a caller that runs that GEMM itself (the moe layer's batched
        experts on a serving mesh)."""
        s = (self.seed + self._n * 40503) & M32
        self._n += 1
        return s

    def dense(self, x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
              kind: Optional[str] = None):
        return fqt.dense(x, w, b, cfg=self.qcfg, seed=self.next_seed(),
                         mesh=self.mesh, kind=kind)

    def hp_weight(self, w: torch.Tensor, kind: Optional[str] = None,
                  shape: Optional[tuple] = None) -> torch.Tensor:
        """``w`` as ``dense_hp`` multiplies it: on a multi-rank mesh the
        whole weight from this rank's shard -- its d axis's "data" (FSDP)
        split gathered, its gradient reduce-scattered (``fsdp_gather``)
        and summed over "pod" where the backward sums the pods
        (``sharding.grad_sum_axes``), as the embedding table's is; for
        ``kind="io"`` (xLSTM's ``w_if`` and ``r_gates``, whose N the rule
        table splits over "model") its columns gathered too
        (``gather_from_tp``).  A loop that multiplies by ``w`` at every
        step (the sLSTM's ``r_gates``) gathers it once, before the loop.
        ``shape``: the whole weight's; a ``w`` of that shape (a serving
        tree holds xLSTM's whole, ``packing.ENGINE_WHOLE``) is not
        gathered."""
        if kind not in (None, "d_rep", "io"):
            raise ValueError(f"dense_hp: rule {kind!r} (the router's is "
                             f"'d_rep', xLSTM's gate projections' 'io')")
        if kind is not None and _multi(self.mesh):
            w = _dp_summed(w, self.mesh)
            if shape is None or tuple(w.shape) != tuple(shape):
                w = fsdp_gather(w, self.mesh, dim=w.ndim - 2)
                if kind == "io":
                    w = gather_from_tp(w, self.mesh, dim=-1)
        return w

    def dense_hp(self, x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 kind: Optional[str] = None) -> torch.Tensor:
        """High-precision dense (routers, xLSTM's gate projections; never
        quantized): the f32 product of x and w (bf16 products are exact in
        f32), plus b, rounded to x's dtype.  No call counter: it draws no
        SR stream.

        On a multi-rank mesh ``w`` is this rank's shard of rule ``kind``,
        gathered whole by ``hp_weight`` (a weight the caller gathered is
        passed with no kind), and every rank computes the whole product on
        its (replicated) input: the 1-device bits on any GEMM backend (a
        product of half the columns may take another kernel, summing in
        another order), its gradients whole on every rank, so nothing sums
        them over "model"."""
        w = self.hp_weight(w, kind)
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
        if b is not None:
            y = y + b
        return y.to(x.dtype)


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


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` with a deterministic backward.  The gradient of the
    gather sums g over repeated tokens.  torch's own backward,
    ``index_put_(accumulate=True)``, adds them one by one in token order on
    the CPU (as the reference's scatter-add does there), but with atomics
    on CUDA, in an order that changes from run to run.  On CUDA it is
    therefore one GEMM, one-hot(tokens)^T @ g in g's dtype with f32
    accumulation: the same sums in a fixed order, so a restarted run repeats
    an uninterrupted one bit for bit."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        flat = tokens.reshape(-1)
        g2 = g.reshape(flat.numel(), -1)
        if not g.is_cuda:
            return g.new_zeros((ctx.vocab, g2.shape[1])).index_put_(
                (flat,), g2, accumulate=True), None
        onehot = (flat[:, None] == torch.arange(
            ctx.vocab, device=flat.device)).to(g.dtype)
        return onehot.T @ g2, None


# ---- the Megatron pair and the FSDP gather (autograd over Mesh collectives) ----
#
# On a multi-rank mesh every rank runs the layer on its shards.  The
# collectives that autograd must see are these Functions (``torch.
# distributed.nn`` is not used: its all_gather's backward sums over ranks):
#
#   copy_to_tp       identity forward, all-reduce over "model" backward: a
#                    replicated tensor entering a "model"-local computation
#                    (a replicated weight applied to local heads);
#   reduce_from_tp   all-reduce over "model" forward, identity backward (the
#                    vocab-parallel embedding's rows);
#   gather_from_tp   all-gather over "model" forward, this rank's slice
#                    backward (the logits: every rank computes the same loss
#                    from the same full logits, so a sum would count the
#                    head's gradient tp times);
#   scatter_to_tp    this rank's slice forward, all-gather backward: a
#                    replicated tensor of which each rank's local
#                    computation takes its own part (the recurrent
#                    families' heads, a row-parallel GEMM's input);
#   fsdp_gather      all-gather over "data" forward, reduce-scatter (f32
#                    sum, this rank's slice) backward.
#
# The column- and row-parallel GEMMs carry their own "model" collective
# inside ``core/fqt._ShardedFP4Matmul`` (the column dX's sum is copy_to_tp's
# backward, the row forward's reduce_from_tp's): one accumulation continued
# across the ranks in K order, so each output is the 1-device GEMM's bit
# for bit.


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum32(ctx.mesh, g, "model"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, "model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.axis_index("model")
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.axis_size("model")
        return x.narrow(dim, mesh.axis_index("model") * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), "model",
                                   dim=ctx.dim), None, None


class _GradSum(torch.autograd.Function):
    """Identity forward; the gradient summed (f32) over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum32(ctx.mesh, g, ctx.axes), None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(w, "data", dim=dim, op="fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        out = ctx.mesh.reduce_scatter(g.to(torch.float32), "data",
                                      dim=ctx.dim)
        return out.to(g.dtype), None, None


def _sum32(mesh, t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over ``axis`` in f32, back in its dtype."""
    if mesh.axes_size((axis,) if isinstance(axis, str) else axis) == 1:
        return t
    return mesh.all_reduce(t.to(torch.float32), axis).to(t.dtype)


def _multi(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh) if _multi(mesh) else x


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh) if _multi(mesh) else x


def gather_from_tp(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    if not _multi(mesh) or mesh.axis_size("model") == 1:
        return x
    return _GatherFromTP.apply(x, mesh, dim % x.ndim)


def scatter_to_tp(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` over "model" (its
    heads or columns); ``x`` itself off a mesh.  A part that does not
    divide raises ``ValueError``."""
    if not _multi(mesh) or mesh.axis_size("model") == 1:
        return x
    dim %= x.ndim
    if x.shape[dim] % mesh.axis_size("model"):
        raise ValueError(f"{x.shape[dim]} along dim {dim} do not split over "
                         f"tp={mesh.axis_size('model')}")
    return _ScatterToTP.apply(x, mesh, dim)


def fsdp_gather(w: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    if not _multi(mesh) or mesh.axis_size("data") == 1:
        return w
    return _FSDPGather.apply(w, mesh, dim)


def _dp_summed(w: torch.Tensor, mesh) -> torch.Tensor:
    """``w`` with its gradient summed over "pod" where the backward sums
    the pods (``sharding.grad_sum_axes``): a weight whose "data" sum is
    its FSDP gather's reduce-scatter, and whose gradient no later step
    sums (``train/step._SUMMED_IN_BACKWARD``)."""
    from repro_torch.distributed.sharding import grad_sum_axes
    pods = tuple(a for a in grad_sum_axes(mesh) if a == "pod")
    if pods and w.requires_grad and torch.is_grad_enabled():
        return _GradSum.apply(w, mesh, pods)
    return w


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Rows of the embedding ``table`` (V, d) at ``tokens``; differentiable
    in ``table`` with a deterministic backward (``_EmbedLookup``).

    Under a multi-rank ``mesh`` the table is this rank's shard (vocab on
    "model", d on "data": the rule "vocab_d"): the d split is gathered
    (``fsdp_gather``), then each rank looks up the tokens of its vocabulary
    range (zeros for the others) and the rows are summed over "model"
    (``reduce_from_tp``) -- exact, as every other rank adds zeros.  The
    backward scatters the rows' gradient into the local vocabulary rows
    only, and sums it over the DP axes: "data" in ``fsdp_gather``'s
    backward, "pod" where the backward sums it
    (``sharding.grad_sum_axes``)."""
    if _multi(mesh):
        table = fsdp_gather(_dp_summed(table, mesh), mesh, dim=1)
        v_loc = table.shape[0]
        local = tokens - mesh.axis_index("model") * v_loc
        mine = (local >= 0) & (local < v_loc)
        idx = torch.clamp(local, 0, v_loc - 1)
        rows = (_EmbedLookup.apply(table, idx)
                if table.requires_grad and torch.is_grad_enabled()
                else table[idx])
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return reduce_from_tp(rows, mesh)
    if table.requires_grad and torch.is_grad_enabled():
        return _EmbedLookup.apply(table, tokens)
    return table[tokens]


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
    kernel); rows at or past kv_len get a key position above any query.
    Under a window the buffer rolls: row j holds the latest position with
    pos % buf == j (``swa_kpos`` of the length after the write)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qpos = pos[0] + torch.arange(Sq, dtype=torch.int32, device=q.device)
    rows = torch.arange(Sk, dtype=torch.int32, device=q.device)
    kpos = rows if window is None else swa_kpos(
        (pos[0] + Sq).reshape(1), Sk)[0]
    kpos = torch.where(rows < pos[1], kpos, torch.full_like(kpos, 2 ** 30))
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

    def reset(self) -> None:
        """Back to ``init``'s state, in place."""
        for t in (self.k, self.v, self.length):
            t.zero_()

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

    def reset(self) -> None:
        """Back to ``init``'s state, in place."""
        for t in (self.k_codes, self.v_codes, self.length):
            t.zero_()
        for t in (self.k_scales, self.v_scales):
            t.fill_(1.0)

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
                  page_size: Optional[int] = None,
                  total_pages: Optional[int] = None, device=None,
                  page_table: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None):
    """bf16 ``KVCache``, block-quantized ``PackedKVCache``, or (``page_size``
    set) a ``PagedKVCache`` over a shared page pool (``page_table`` and
    ``lengths``: tensors shared with other layers, see
    ``PagedKVCache.init``)."""
    if page_size:
        return PagedKVCache.init(batch, buf, n_kv, hd, fmt=kv_format,
                                 page_size=page_size,
                                 total_pages=total_pages, device=device,
                                 page_table=page_table, lengths=lengths)
    if kv_format == "bf16":
        return KVCache.init(batch, buf, n_kv, hd, dtype, device=device)
    return PackedKVCache.init(batch, buf, n_kv, hd, fmt=kv_format,
                              device=device)


def _storage_view(t: torch.Tensor) -> torch.Tensor:
    """float8 storage as its bytes (a bit-preserving view for copies)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def dyn_rows(start, n: int, device) -> torch.Tensor:
    """int64 indices ``start + [0, n)``.  ``start`` is a host int or an
    int32 device scalar: the start operand of ``lax.dynamic_slice``, so one
    recorded program (a CUDA graph) serves every value."""
    return torch.arange(n, dtype=torch.int64, device=device) + start


# ---- paged (continuous-batching) KV cache -----------------------------------------

# Physical page 0 is reserved as the TRASH page: freed slots' page-table
# rows point at it, so the batched decode can keep writing for inactive
# slots without corrupting pages reallocated to other requests.
TRASH_PAGE = 0


def _kv_quant_any(x: torch.Tensor, fmt: str, block: int):
    """``kv_quant_rows`` plus the bf16 passthrough (codes = values, scales a
    (..., 1) placeholder) so paged caches treat all formats uniformly."""
    if fmt == "bf16":
        return (x.to(torch.bfloat16),
                torch.ones(x.shape[:-1] + (1,), dtype=torch.bfloat16,
                           device=x.device))
    return kv_quant_rows(x, fmt, block)


def _kv_dequant_any(codes, scales, fmt: str, block: int,
                    dtype=torch.bfloat16) -> torch.Tensor:
    if fmt == "bf16":
        return codes.to(dtype)
    return kv_dequant(codes, scales, fmt, block, dtype)


@dataclasses.dataclass
class PagedKVCache:
    """Paged per-layer KV cache: pages allocated from a shared pool.

      * ``k_codes``/``v_codes``: the PHYSICAL page pool (P, page, KVH, Dc),
        Dc following ``fmt`` (nvfp4: D/2 uint8 nibble pairs, fp8: D float8
        codes, bf16: D bf16 -- the escape hatch);
      * ``k_scales``/``v_scales``: per-row block scales (P, page, KVH, nb);
      * ``page_table``: (B, n_pages_slot) int32 physical page per logical
        page of each slot; rows of freed slots point at ``TRASH_PAGE``;
      * ``lengths``: (B,) int32 tokens written per slot.

    Counterpart of ``repro.models.layers.PagedKVCache``, updated IN PLACE:
    every writer mutates the pool and ``lengths`` and returns ``self``.
    One ``page_table`` tensor serves every layer (the host writes all
    layers' rows alike), and ``lengths`` may be a row of an (L, B) tensor.
    A rolling (SWA) cache writes at logical ``pos % buf``.
    """

    k_codes: torch.Tensor
    k_scales: torch.Tensor
    v_codes: torch.Tensor
    v_scales: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    fmt: str = "nvfp4"
    block: int = 16
    page_size: int = 16

    # the pools' KV-heads axis, which a serving mesh splits over "model"
    # (distributed/sharding.serve_cache_shardings): each rank holds the
    # pages of the heads it attends with
    HEADS_AXIS = -2

    @property
    def n_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def buf(self) -> int:
        """Logical per-slot capacity in tokens."""
        return self.page_table.shape[1] * self.page_size

    @staticmethod
    def init(slots: int, buf: int, n_kv: int, hd: int, fmt: str = "nvfp4",
             block: int = 16, page_size: int = 16,
             total_pages: Optional[int] = None, device=None,
             page_table: Optional[torch.Tensor] = None,
             lengths: Optional[torch.Tensor] = None) -> "PagedKVCache":
        if buf % page_size:
            raise ValueError(f"slot buffer {buf} not a multiple of "
                             f"page_size {page_size}")
        if fmt in ("nvfp4", "fp8") and (hd % block or hd % 2):
            raise ValueError(
                f"packed KV cache needs head_dim divisible by block={block} "
                f"(and even), got head_dim={hd}")
        n_pages_slot = buf // page_size
        if total_pages is None:
            total_pages = 1 + slots * n_pages_slot    # +1: the trash page
        shape = (total_pages, page_size, n_kv)
        if fmt == "nvfp4":
            codes = torch.zeros(shape + (hd // 2,), dtype=torch.uint8,
                                device=device)
            scales = torch.ones(shape + (hd // block,), device=device
                                ).to(torch.float8_e4m3fn)
        elif fmt == "fp8":
            codes = torch.zeros(shape + (hd,), device=device
                                ).to(torch.float8_e4m3fn)
            scales = torch.ones(shape + (hd // block,), dtype=torch.bfloat16,
                                device=device)
        elif fmt == "bf16":
            codes = torch.zeros(shape + (hd,), dtype=torch.bfloat16,
                                device=device)
            scales = torch.ones(shape + (1,), dtype=torch.bfloat16,
                                device=device)
        else:
            raise ValueError(f"unknown paged KV format {fmt!r}")
        if page_table is None:
            page_table = torch.full((slots, n_pages_slot), TRASH_PAGE,
                                    dtype=torch.int32, device=device)
        if lengths is None:
            lengths = torch.zeros((slots,), dtype=torch.int32, device=device)
        if tuple(page_table.shape) != (slots, n_pages_slot) or \
                tuple(lengths.shape) != (slots,):
            raise ValueError("shared page_table/lengths do not match the "
                             "slot layout")
        return PagedKVCache(codes, scales, codes.clone(), scales.clone(),
                            page_table, lengths, fmt, block, page_size)

    def reset(self) -> None:
        """Back to ``init``'s state, in place: empty pools, every length 0
        and every page-table row on the trash page (the shared table and
        lengths too)."""
        for t in (self.k_codes, self.v_codes, self.lengths):
            t.zero_()
        for t in (self.k_scales, self.v_scales):
            t.fill_(1.0)
        self.page_table.fill_(TRASH_PAGE)

    # ---- writes (in place) ------------------------------------------------

    def _scatter(self, phys: torch.Tensor, off: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> None:
        """Quantize rows k/v (idx..., KVH, D) and store them at pool rows
        (phys, off).  Duplicate indices occur only on the trash page."""
        idx = (phys.to(torch.int64), off.to(torch.int64))
        kcod, ksc = _kv_quant_any(k, self.fmt, self.block)
        vcod, vsc = _kv_quant_any(v, self.fmt, self.block)
        for dst, src in ((self.k_codes, kcod), (self.k_scales, ksc),
                         (self.v_codes, vcod), (self.v_scales, vsc)):
            _storage_view(dst).index_put_(idx, _storage_view(src))

    def write_prompt(self, slot, k: torch.Tensor, v: torch.Tensor,
                     plen) -> "PagedKVCache":
        """Prefill-into-slot: write a fresh (1, Sp, KVH, D) sequence at
        logical positions [0, Sp) of ``slot`` and set its length to
        ``plen`` (rows in [plen, Sp) are right-pad, masked at read).
        ``slot`` and ``plen``: host ints or int32 device scalars."""
        if k.shape[1] > self.buf:
            raise ValueError(f"prefill length {k.shape[1]} exceeds slot "
                             f"capacity {self.buf}")
        return self.write_prompt_at(slot, k, v, 0, plen)

    def write_prompt_at(self, slot, k: torch.Tensor, v: torch.Tensor,
                        start, plen) -> "PagedKVCache":
        """Suffix prefill: write a fresh (1, Sp, KVH, D) sequence at logical
        positions [start, start + Sp) of ``slot`` and set its length to
        ``plen`` (the TOTAL length).  Right-pad positions past the slot
        buffer go to the trash page.  ``slot``, ``start`` and ``plen``:
        host ints or int32 device scalars (gathers and a select, never a
        host read)."""
        Sp, dev = k.shape[1], k.device
        t = dyn_rows(start, Sp, dev).to(torch.int32)
        page = torch.clamp(t // self.page_size, 0,
                           self.page_table.shape[1] - 1)
        row = self.page_table.index_select(0, dyn_rows(slot, 1, dev))[0]
        phys = row[page.to(torch.int64)]
        phys = torch.where(t < self.buf, phys,
                           torch.full_like(phys, TRASH_PAGE))
        self._scatter(phys, t % self.page_size, k[0], v[0])
        mine = torch.arange(self.lengths.shape[0], device=dev) == slot
        self.lengths.copy_(torch.where(mine, plen, self.lengths))
        return self

    def write_token(self, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> "PagedKVCache":
        """Batched decode write: one (B, 1, KVH, D) token per slot at each
        slot's own length, ROLLING (logical ``length % buf``).  ``mask``
        ((B,) bool): slots with False write to the trash page and keep
        their length."""
        posl = self.lengths % self.buf
        page = (posl // self.page_size).to(torch.int64)
        phys = torch.gather(self.page_table, 1, page[:, None])[:, 0]
        if mask is not None:
            phys = torch.where(mask, phys, torch.full_like(phys, TRASH_PAGE))
        self._scatter(phys, posl % self.page_size, k[:, 0], v[:, 0])
        if mask is None:
            self.lengths.add_(1)
        else:
            self.lengths.add_(mask.to(torch.int32))
        return self

    def write_tokens(self, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> "PagedKVCache":
        """Batched multi-token write: S tokens per slot at [len, len + S),
        linear addressing; positions past the slot buffer AND every row of
        masked-off slots go to the trash page, and masked slots keep their
        length.  Rejected rows are later hidden by ``truncate_to``."""
        B, S = k.shape[0], k.shape[1]
        t = self.lengths[:, None] + torch.arange(S, dtype=torch.int32,
                                                 device=k.device)[None, :]
        page = torch.clamp(t // self.page_size, 0,
                           self.page_table.shape[1] - 1).to(torch.int64)
        phys = torch.gather(self.page_table, 1, page)
        trash = torch.full_like(phys, TRASH_PAGE)
        phys = torch.where(t < self.buf, phys, trash)
        if mask is not None:
            phys = torch.where(mask[:, None], phys, trash)
        self._scatter(phys, t % self.page_size, k, v)
        if mask is None:
            self.lengths.add_(S)
        else:
            self.lengths.add_(mask.to(torch.int32) * S)
        return self

    def truncate_to(self, slot: Optional[int], new_len) -> "PagedKVCache":
        """Exact rollback of rejected appends: shrink length(s) to
        ``new_len`` without touching the pool.  ``slot=None``: batched,
        ``new_len`` a (B,) tensor.  Never extends a slot."""
        if slot is None:
            self.lengths.copy_(torch.minimum(self.lengths, new_len))
        elif isinstance(new_len, torch.Tensor):
            self.lengths[slot] = torch.minimum(self.lengths[slot], new_len)
        else:
            self.lengths[slot:slot + 1].clamp_(max=int(new_len))
        return self

    # ---- reads (test oracles; the serving path reads through K5) ------------

    def gather_slots(self):
        """The logical (B, buf, KVH, .) packed views through the page
        table."""
        pt = self.page_table.to(torch.int64)

        def g(pool):
            return pool[pt].reshape((pt.shape[0], -1) + tuple(pool.shape[2:]))

        return (g(self.k_codes), g(self.k_scales),
                g(self.v_codes), g(self.v_scales))

    def gather_slot(self, slot: int):
        """ONE slot's logical (1, buf, KVH, .) packed views."""
        row = self.page_table[slot].to(torch.int64)

        def g(pool):
            return pool[row].reshape((1, -1) + tuple(pool.shape[2:]))

        return (g(self.k_codes), g(self.k_scales),
                g(self.v_codes), g(self.v_scales))

    def dequant(self, dtype=torch.bfloat16):
        """Full logical (B, buf, KVH, D) reconstruction (test oracle)."""
        kc, ks, vc, vs = self.gather_slots()
        return (_kv_dequant_any(kc, ks, self.fmt, self.block, dtype),
                _kv_dequant_any(vc, vs, self.fmt, self.block, dtype))

    def nbytes(self) -> int:
        """Stored pool bytes (codes + scales, k and v)."""
        return int(sum(a.numel() * a.element_size() for a in
                       (self.k_codes, self.k_scales,
                        self.v_codes, self.v_scales)))


def _attn_decode_paged(q: torch.Tensor, cache: PagedKVCache, *,
                       q_offsets: torch.Tensor, kv_len: torch.Tensor,
                       causal: bool, window: Optional[int],
                       page_table: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Attention over a PAGED cache with per-slot (q_offset, kv_len): the
    K5 kernel, reading the pool through the page table at packed width
    (the reference's jnp ``_attn_decode_paged`` gathers the slots and runs
    its fused scan; the port routes that read through K5)."""
    pt = cache.page_table if page_table is None else page_table
    return flash_attention_paged(
        q, cache.k_codes, cache.k_scales, cache.v_codes, cache.v_scales, pt,
        kv_len, q_offsets, fmt=cache.fmt, block=cache.block, causal=causal,
        window=window)


def _write_cache(cache, k: torch.Tensor, v: torch.Tensor,
                 rolling: bool = False) -> torch.Tensor:
    """Write S new rows at positions [length, length + S) IN PLACE and
    advance the length by S; returns the (old) length tensor.  A linear
    cache writes row = position; a ``rolling`` (sliding-window) buffer
    writes position p at row p % buf and, where S > buf, keeps only the
    last buf rows (the reference's rolling write)."""
    S, buf = k.shape[1], cache.buf
    start = cache.length.clone()
    if S > buf:
        if not rolling:
            raise ValueError(f"{S} new tokens exceed the cache buffer {buf}")
        k, v = k[:, S - buf:], v[:, S - buf:]
    first = start + max(S - buf, 0)
    idx = (first + torch.arange(k.shape[1], dtype=torch.int32,
                                device=k.device)) % buf
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
    cache.length.add_(S)          # in place: a graph replay reads it anew
    return start


def attn_apply(p, x: torch.Tensor, ctx: QCtx, *, n_heads: int, n_kv: int,
               hd: int, rope_theta: float, causal: bool = True,
               window: Optional[int] = None, chunk: int = 1024, cache=None,
               slot: Optional[int] = None, plen=None,
               pfx: Optional[int] = None,
               write_mask: Optional[torch.Tensor] = None,
               norm_eps: float = 1e-5, xkv: Optional[torch.Tensor] = None,
               use_rope: bool = True, serving: bool = False):
    """Self-attention with an optional KV cache update (updated in place),
    or cross-attention to ``xkv``.

    Without a cache the sequence attends itself through ``attention_core``
    (training), or through K7 where a ``serving`` caller asks for it
    (whisper's encoder under the serving entries).  With a lockstep cache,
    x is the NEW tokens written at [cache.length, cache.length + S):
    prefill (S > 1, from an empty cache) attends within the fresh sequence
    through K7; decode (S == 1) attends the cache -- K6 for a
    ``PackedKVCache``, a dense read for the bf16 cache.  Under a ``window``
    the lockstep buffer rolls (position p at row p % buf, the reference's
    rolling write) and the decode read takes the rolling key positions.

    With a ``PagedKVCache`` each batch row is a SLOT with its own length:
      * ``slot`` and ``pfx`` (suffix or chunked prefill, B == 1): write the
        rows at [pfx, pfx + S), set the length to ``plen`` and attend
        THROUGH the paged cache (K5);
      * ``slot`` only (prefill-into-slot): write at [0, S), length
        ``plen``, attend within the fresh prompt (K7);
      * S == 1 (batched decode): one token per slot at its own length,
        ``write_mask`` freezing mid-prefill slots; K5 with per-slot
        (q_offset, kv_len), the rolling kpos under a window;
      * S > 1 (batched verify): S teacher-forced rows per slot, K5.
    ``slot``, ``plen`` and ``pfx`` are host ints or int32 device scalars
    (dynamic operands: the serving programs pass device scalars, so one
    recorded CUDA graph serves every slot and length).

    ``xkv`` (B, Sk, d): cross-attention (whisper's decoder), K and V
    projected from ``xkv``, no rope, key positions 0..Sk-1, non-causal, no
    cache written; ``attention_core``, or K7 for a ``serving`` caller.
    ``use_rope=False``: no rotary embedding (whisper's learned positions).
    Returns (out, cache)."""
    B, S, _ = x.shape
    dev = x.device
    src = x if xkv is None else xkv
    Sk = src.shape[1]
    q = ctx.dense(x, p["wq"], p.get("bq"), "io").reshape(B, S, n_heads, hd)
    k = ctx.dense(src, p["wk"], p.get("bk"), "io").reshape(B, Sk, n_kv, hd)
    v = ctx.dense(src, p["wv"], p.get("bv"), "io").reshape(B, Sk, n_kv, hd)
    if "q_norm" in p:
        # replicated weights on this rank's heads: their gradient is the
        # sum over "model" (copy_to_tp)
        q = rmsnorm(q, copy_to_tp(p["q_norm"], ctx.mesh), norm_eps)
        k = rmsnorm(k, copy_to_tp(p["k_norm"], ctx.mesh), norm_eps)
    if xkv is not None:
        if cache is not None:
            raise ValueError("cross-attention writes no KV cache")
        o = _attn_fresh(q, k, v, causal=False, window=window, chunk=chunk,
                        serving=serving)
        return ctx.dense(o.reshape(B, S, n_heads * hd), p["wo"],
                         kind="oi"), None
    paged = isinstance(cache, PagedKVCache)
    if paged and slot is not None:
        positions = dyn_rows(0 if pfx is None else pfx, S, dev).to(
            torch.int32)
    elif paged:             # per-slot positions, (B, S)
        positions = cache.lengths[:, None] + torch.arange(
            S, dtype=torch.int32, device=dev)[None, :]
    else:
        base = cache.length if cache is not None else torch.zeros(
            (), dtype=torch.int32, device=dev)
        positions = base + torch.arange(S, dtype=torch.int32, device=dev)
    if use_rope:
        cos, sin = rope_tables(positions, hd, rope_theta)
        if positions.ndim == 1:
            cos, sin = cos[None], sin[None]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        o = _attn_fresh(q, k, v, causal=causal, window=window, chunk=chunk,
                        serving=serving)
    elif paged:
        o = _attn_paged(q, k, v, cache, positions, causal=causal,
                        window=window, slot=slot, plen=plen, pfx=pfx,
                        write_mask=write_mask)
    elif S > 1:
        # prefill (from an empty cache): every query's window lies inside
        # the fresh K/V, also where S > buf and only the last buf rows stay
        _write_cache(cache, k, v, rolling=window is not None)
        o = _attn_prefill(q, k, v, causal=causal, window=window)
    else:
        start = _write_cache(cache, k, v, rolling=window is not None)
        kv_len = torch.clamp(cache.length, max=cache.buf)
        pos = torch.stack([start, kv_len]).to(torch.int32)
        if isinstance(cache, PackedKVCache):
            o = flash_attention_packed(
                q, cache.k_codes, cache.k_scales, cache.v_codes,
                cache.v_scales, pos, fmt=cache.fmt, block=cache.block,
                causal=causal, window=window, rolling=window is not None)
        else:
            o = _attn_decode_dense(q, cache.k, cache.v, pos, causal=causal,
                                   window=window)
    out = ctx.dense(o.reshape(B, S, n_heads * hd), p["wo"], kind="oi")
    return out, cache


def _attn_fresh(q, k, v, *, causal, window, chunk, serving) -> torch.Tensor:
    """Attention with no cache, both sides at positions 0, 1, ...: K7 for a
    serving caller (f32 operands, ``_attn_prefill``), else the training
    ``attention_core``."""
    if serving:
        return _attn_prefill(q, k, v, causal=causal, window=window)
    pos_q = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    pos_k = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return attention_core(q, k, v, qpos=pos_q, kpos=pos_k, causal=causal,
                          window=window, chunk=chunk)


def _attn_paged(q, k, v, cache: PagedKVCache, positions, *, causal, window,
                slot, plen, pfx, write_mask) -> torch.Tensor:
    """The four paged branches of ``attn_apply`` (write, then read)."""
    S = q.shape[1]
    if slot is not None and pfx is not None:
        # suffix / chunked prefill (B == 1): the slot's pages already hold
        # [0, pfx); write the fresh rows at [pfx, pfx + S) and attend
        # through the cache (right-pad rows land masked or on the trash
        # page)
        if window is not None:
            raise NotImplementedError(
                "shared-prefix suffix prefill needs a linear cache; SWA "
                "rolling buffers rewrite shared pages")
        cache.write_prompt_at(slot, k, v, pfx, S if plen is None else plen)
        row = dyn_rows(slot, 1, q.device)
        return _attn_decode_paged(
            q, cache, q_offsets=positions[:1],
            kv_len=cache.lengths.index_select(0, row), causal=causal,
            window=None, page_table=cache.page_table.index_select(0, row))
    if slot is not None:
        # prefill-into-slot (B == 1): attend within the fresh tokens (right-
        # pad rows are garbage queries whose outputs the caller drops)
        cache.write_prompt(slot, k, v, S if plen is None else plen)
        return _attn_prefill(q, k, v, causal=causal, window=window)
    buf = cache.buf
    if S == 1:
        # batched decode.  A linear cache writes through ``write_tokens``,
        # which sends a position past the slot buffer to the trash page:
        # identical while lengths < buf (the scheduler's invariant), and a
        # speculative draft writing ahead near the buffer end never wraps
        # onto the slot's first page of the SHARED pool.
        if window is None:
            cache.write_tokens(k, v, mask=write_mask)
        else:
            cache.write_token(k, v, mask=write_mask)
    else:
        # batched verify (speculative decode, S == k): causal masking gives
        # query row j exactly rows [0, len + j]
        if window is not None:
            raise NotImplementedError(
                "speculative verify needs a linear paged cache; SWA "
                "rolling buffers cannot roll back exactly")
        cache.write_tokens(k, v, mask=write_mask)
    kv_len = torch.clamp(cache.lengths, max=buf)
    return _attn_decode_paged(q, cache, q_offsets=positions[:, 0],
                              kv_len=kv_len, causal=causal, window=window)


# ---- MLP block ------------------------------------------------------------------


def mlp_params(gen, d_model: int, d_ff: int, act: str, dtype=torch.bfloat16,
               device=None):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``; the smooth variant adds its
    per-channel factor) or, for ``act="gelu"``, ``w_in``/``b_in``,
    ``w_out``/``b_out`` with zero biases."""
    if act == "gelu":
        return {
            "w_in": dense_init(gen, d_model, d_ff, dtype, device=device),
            "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_out": dense_init(gen, d_ff, d_model, dtype, device=device),
            "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
        }
    if act not in ("swiglu", "smooth_swiglu"):
        raise ValueError(f"unknown activation {act!r}")
    p = {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device=device),
    }
    if act == "smooth_swiglu":
        p["smooth"] = torch.ones((d_ff,), dtype=dtype, device=device)
    return p


def mlp_apply(p, x: torch.Tensor, ctx: QCtx, act: str) -> torch.Tensor:
    """The GELU MLP is the reference's: the biased ``w_in`` GEMM, the tanh
    GELU in f32 as XLA computes it (``refnum.Gelu``), cast to x's dtype,
    then the biased ``w_out`` GEMM."""
    if act == "gelu":
        h = refnum.Gelu.apply(ctx.dense(x, p["w_in"], p["b_in"], "io").to(
            torch.float32))
        # ``b_out`` splits its d over "model" ("vec_out"), but the row-
        # parallel output is whole: the whole bias is added once, after
        # the reduce
        return ctx.dense(h.to(x.dtype), p["w_out"],
                         gather_from_tp(p["b_out"], ctx.mesh, dim=0), "oi")
    g = ctx.dense(x, p["w_gate"], kind="io")
    u = ctx.dense(x, p["w_up"], kind="io")
    if act == "smooth_swiglu":
        return ctx.dense(smooth_swiglu(g, u, p["smooth"]), p["w_down"],
                         kind="oi")
    if act == "swiglu":
        return ctx.dense(swiglu(g, u), p["w_down"], kind="oi")
    raise ValueError(f"unknown activation {act!r}")
