"""Mixture-of-Experts FFN (PyTorch): top-k routing, capacity-bounded
sort-based dispatch, a loop over the experts and an ordered combine.

Counterpart of ``repro.models.moe``.  The router runs in high precision
(``QCtx.dense_hp``); each expert's three GEMMs go through ``QCtx.dense``
(K1 in training, K4 on packed serving weights) with the expert's own SR
seed stream ``ctx.fold(e)``, as the reference's scan over the stacked
expert weights draws them.  Group-limited dispatch (``cfg.moe_groups``,
used where it divides the token count) routes each group on its own with
capacity C per group.

These points keep the port on the reference's bits:
  * the router's softmax, the gates' renormalisation and their gradients
    compute as XLA does (``refnum``: its exp, its orders of addition);
  * top-k is the first K of a STABLE descending sort, so tied
    probabilities go to the lower expert id as ``jax.lax.top_k`` sends
    them (``torch.topk`` does not promise that);
  * the combine adds each token's K weighted expert outputs one by one in
    its dtype, in rising expert id, as the reference's scatter-add adds the
    sorted entries: a gather and K adds, the same order on every device and
    run (no atomics);
  * the dispatch's backward sums a token's K gradient rows in that same
    order (``_Dispatch``), so the gradient is deterministic on the card too.
The rows of empty or padded decode slots are routed like any other token and
take their share of capacity, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quantize import PackedQuantizedTensor
from repro_torch.models import refnum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (QCtx, dense_init, smooth_swiglu,
                                       swiglu)


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None):
    """Router (d, E) and stacked expert weights (E, d, f) / (E, f, d),
    drawn from ``gen`` in this order: router, then w_gate, w_up and w_down,
    expert by expert."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    if cfg.act not in ("swiglu", "smooth_swiglu"):
        raise NotImplementedError(
            f"activation {cfg.act!r} arrives with the breadth families "
            f"(ROADMAP Queue 1)")

    def stack(din, dout):
        return torch.stack([dense_init(gen, din, dout, dtype, device=device)
                            for _ in range(E)])

    p = {
        "router": dense_init(gen, d, E, dtype, scale=0.02, device=device),
        "w_gate": stack(d, f),
        "w_up": stack(d, f),
        "w_down": stack(f, d),
    }
    if cfg.act == "smooth_swiglu":
        p["smooth"] = torch.ones((E, f), dtype=dtype, device=device)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cfg.top_k, (c + 3) // 4 * 4)


def _token_entries(st: torch.Tensor, K: int) -> torch.Tensor:
    """(Tg, K) positions, in the expert-sorted entry order, of each token's
    K entries, rising: ``st`` holds each sorted entry's token, and a stable
    sort by token keeps the expert order within a token."""
    return torch.sort(st, stable=True).indices.reshape(-1, K)


def _token_sum(rows: torch.Tensor, js: torch.Tensor) -> torch.Tensor:
    """(Tg, d): for each token t, 0 + rows[js[t, 0]] + rows[js[t, 1]] + ...
    added one by one in rows' dtype (the reference's scatter-add)."""
    acc = torch.zeros((js.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for k in range(js.shape[1]):
        acc = acc + rows.index_select(0, js[:, k])
    return acc


class _Renorm(torch.autograd.Function):
    """v / max(sum(v), 1e-9) over the last axis (the top-k gates
    renormalised), with the reference's backward (``refnum.div_sum_grad``;
    no gradient through the sum below its floor)."""

    @staticmethod
    def forward(ctx, v):
        s = refnum.row_sum(v)[..., None]
        ctx.save_for_backward(v, s)
        return v / torch.clamp(s, min=1e-9)

    @staticmethod
    def backward(ctx, g):
        v, s = ctx.saved_tensors
        sc = torch.clamp(s, min=1e-9)
        return torch.where(s > 1e-9, refnum.div_sum_grad(g, v, sc), g / sc)


class _Gate(torch.autograd.Function):
    """rows (N, d) * gates (N,) in rows' dtype.  The gates' gradient sums
    each row's d products in the reference's order (``refnum.row_sum``);
    torch's order would move the router's gradient by ulps."""

    @staticmethod
    def forward(ctx, rows, gates):
        ctx.save_for_backward(rows, gates)
        return rows * gates[:, None]

    @staticmethod
    def backward(ctx, g):
        rows, gates = ctx.saved_tensors
        return g * gates[:, None], refnum.row_sum(g * rows)


class _Dispatch(torch.autograd.Function):
    """buf[slot[j]] = x[st[j]] for every sorted entry j (dropped entries land
    on the dustbin row E*C); returns buf[:E*C].  The backward gives each
    token the sum of its K entries' gradient rows in expert order
    (``_token_sum``), where autograd's scatter-add would use atomics on the
    card."""

    @staticmethod
    def forward(ctx, x, st, slot, n_slots: int, K: int):
        buf = x.new_zeros((n_slots + 1, x.shape[1]))
        buf.index_put_((slot,), x.index_select(0, st))
        ctx.save_for_backward(st, slot)
        ctx.K = K
        return buf[:n_slots]

    @staticmethod
    def backward(ctx, g):
        st, slot = ctx.saved_tensors
        gbuf = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        rows = gbuf.index_select(0, slot)
        return (_token_sum(rows, _token_entries(st, ctx.K)), None, None,
                None, None)


def _dispatch(x: torch.Tensor, logits: torch.Tensor, cfg: ModelConfig,
              C: int):
    """Per-group routing.  x: (Tg, d), logits: (Tg, E) f32.  Returns (xe
    (E, C, d), (slot, st, sg, keep), aux loss)."""
    Tg, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = x.device
    probs = refnum.Softmax.apply(logits)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :K], idx[:, :K]
    gate_vals = _Renorm.apply(gate_vals)                       # renorm

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(torch.nn.functional.one_hot(
        expert_idx, E).to(torch.float32), dim=1), dim=0)
    aux = E * torch.sum(me * ce)

    # sort-based dispatch (local to the group)
    flat_e = expert_idx.reshape(-1)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)
    flat_g = gate_vals.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # rank within expert = position - first position of that expert
    first = torch.searchsorted(se, torch.arange(E, dtype=se.dtype,
                                                device=dev))
    rank = torch.arange(Tg * K, device=dev) - first[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, torch.full_like(se, E * C))
    xe = _Dispatch.apply(x, st, slot, E * C, K).reshape(E, C, d)
    return xe, (slot, st, sg, keep), aux


def _combine(ye: torch.Tensor, meta, Tg: int) -> torch.Tensor:
    """ye: (E, C, d) -> y: (Tg, d) from the dispatch metadata: each token's
    kept entries weighted by their gates, added in expert order."""
    slot, st, sg, keep = meta
    E_C, d = ye.shape[0] * ye.shape[1], ye.shape[2]
    ye_flat = torch.cat([ye.reshape(E_C, d), ye.new_zeros((1, d))])
    contrib = _Gate.apply(ye_flat.index_select(0, slot), sg.to(ye.dtype))
    contrib = torch.where(keep[:, None], contrib,
                          torch.zeros_like(contrib))
    return _token_sum(contrib, _token_entries(st, st.shape[0] // Tg))


def _expert(w, e: int):
    """Expert e's (K, N) weight: a row of the stacked bf16 leaf, or of a
    packed one (codes, block scales and the expert's own tensor scale; views,
    no copy)."""
    if isinstance(w, PackedQuantizedTensor):
        return PackedQuantizedTensor(w.packed[e], w.scales[e], w.tscale[e],
                                     w.axis, w.block, w.dtype)
    return w[e]


def moe_apply(p, x: torch.Tensor, ctx: QCtx,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (y: (T, d), aux_loss f32 scalar)."""
    T, d = x.shape
    E = cfg.n_experts
    G = cfg.moe_groups if (cfg.moe_groups and T % cfg.moe_groups == 0) else 1
    Tg = T // G
    C = _capacity(Tg, cfg)

    # ---- routing (high-precision router) ----
    logits = ctx.dense_hp(x, p["router"]).to(torch.float32)       # (T, E)
    xg, lg = x.reshape(G, Tg, d), logits.reshape(G, Tg, E)
    routed = [_dispatch(xg[g], lg[g], cfg, C) for g in range(G)]
    aux = torch.mean(torch.stack([r[2] for r in routed]))
    # (G, E, C, d) -> (E, G*C, d): per-expert GEMMs over all groups
    xe = torch.stack([r[0] for r in routed]).transpose(0, 1).reshape(
        E, G * C, d)

    # ---- expert FFN, expert by expert (FQT dense) ----
    smooth = p.get("smooth")
    ys = []
    for e in range(E):
        ectx = ctx.fold(e)
        xi = xe[e]
        g = ectx.dense(xi, _expert(p["w_gate"], e))
        u = ectx.dense(xi, _expert(p["w_up"], e))
        h = (smooth_swiglu(g, u, smooth[e]) if smooth is not None
             else swiglu(g, u))
        ys.append(ectx.dense(h, _expert(p["w_down"], e)))

    # ---- combine (per group) ----
    ye = torch.stack(ys).reshape(E, G, C, d).transpose(0, 1)   # (G,E,C,d)
    y = torch.cat([_combine(ye[g], routed[g][1], Tg) for g in range(G)])
    return y.to(x.dtype), aux
