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

On a multi-rank mesh the stacked expert leaves are this rank's shards,
split as the reference's rule table splits any stacked weight (``w_gate`` /
``w_up`` (E, d, f) over ("data", "model"), ``w_down`` the other way, the
router's d over "data"): no expert parallelism, which the reference does
not have either.  A serving mesh routes the same tokens on every rank and
batches the experts' collectives (``_experts_serving_mesh``); a training
mesh takes groups and capacity from the GLOBAL batch and dispatches by the
"local" or "replicated" route (``dispatch_route``,
``_apply_training_mesh``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from repro_torch.core import fqt
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


def _dispatch_ids(x: torch.Tensor, logits: torch.Tensor, cfg: ModelConfig,
                  C: int):
    """Per-group routing.  x: (Tg, d), logits: (Tg, E) f32.  Returns (xe
    (E, C, d), (slot, st, sg, keep), aux loss, (expert ids (Tg, K), slot,
    st, keep): the routing that ``recording`` logs)."""
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
    return xe, (slot, st, sg, keep), aux, (expert_idx, slot, st, keep)


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


def groups(cfg: ModelConfig, tokens: int) -> Tuple[int, int, int]:
    """(G, Tg, C) of a moe layer over ``tokens`` tokens: G dispatch groups
    (``cfg.moe_groups`` where it divides the tokens, else 1) of Tg tokens,
    capacity C per expert and group."""
    G = cfg.moe_groups if (cfg.moe_groups and tokens % cfg.moe_groups == 0) \
        else 1
    return G, tokens // G, _capacity(tokens // G, cfg)


def dispatch_route(G: int, dp: int, C: int, block: Optional[int],
                   pods: int = 1) -> str:
    """The dispatch route of a moe layer on a training mesh whose DP axes
    split its G groups' tokens over ``dp`` ranks, decided on the host from
    static facts: "local" where every rank holds whole groups (G % dp ==
    0) and its capacity rows of each expert, (G/dp)·C, split the update
    GEMM's blocks nowhere (``block``: the update GEMM's block, None where
    it stays bf16, which it also does where the expert GEMM's rows, G·C
    over the ``pods`` routing domains its row layout stacks -- each pod
    routes its own tokens under the compressed pod mean -- are no multiple
    of it); else "replicated".  One rank is "local"."""
    if G % dp:
        return "replicated"
    if block and (G * C * pods) % block == 0 and (G // dp * C) % block:
        return "replicated"
    return "local"


def _update_block(qcfg) -> Optional[int]:
    spec = qcfg.upd_a or qcfg.upd_g
    return None if spec is None else spec.block


# ---- the routing record (tests and chip_smoke.py compare ranks' routing) ----

_RECORD: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_routing", default=None)


@contextlib.contextmanager
def recording():
    """Within the block every ``moe_apply`` appends its routing to the
    yielded list: {"route", "G", "C", "groups": [(expert ids (Tg, K),
    slot, st, keep) of each group this rank dispatched], "first": the
    index of its first group among the layer's G}."""
    log: list = []
    tok = _RECORD.set(log)
    try:
        yield log
    finally:
        _RECORD.reset(tok)


def _record(route, G, C, first, routed):
    log = _RECORD.get()
    if log is not None:
        log.append({"route": route, "G": G, "C": C, "first": first,
                    "groups": [tuple(t.detach() for t in r[3])
                               for r in routed]})


def _route_groups(x, logits, cfg: ModelConfig, n: int, C: int):
    """Dispatch ``n`` groups of x's rows (x (n·Tg, d), logits f32):
    (xe (E, n·C, d), [(xe_g, meta, aux, ids) per group])."""
    d, E = x.shape[1], cfg.n_experts
    Tg = x.shape[0] // n
    xg, lg = x.reshape(n, Tg, d), logits.reshape(n, Tg, E)
    routed = [_dispatch_ids(xg[g], lg[g], cfg, C) for g in range(n)]
    # (n, E, C, d) -> (E, n*C, d): per-expert GEMMs over all groups
    xe = torch.stack([r[0] for r in routed]).transpose(0, 1).reshape(
        E, n * C, d)
    return xe, routed


def _combine_groups(ye, routed, C: int, Tg: int):
    """ye (E, n·C, d) -> (n·Tg, d): each group's combine, in group order."""
    E, d = ye.shape[0], ye.shape[2]
    n = len(routed)
    ye = ye.reshape(E, n, C, d).transpose(0, 1)               # (n,E,C,d)
    return torch.cat([_combine(ye[g], routed[g][1], Tg) for g in range(n)])


def _per_expert(w, E: int):
    """Each expert's (K, N) weight of a stacked leaf: the packed leaf's
    rows (``_expert``), or views of the bf16 leaf whose backward stacks
    the E gradients once (``w[e]``'s would add E leaf-sized zero
    tensors)."""
    if isinstance(w, PackedQuantizedTensor):
        return [_expert(w, e) for e in range(E)]
    return w.unbind(0)


def _experts(p, xe, ctx: QCtx, rows_whole: bool = False, smooth=None):
    """Each expert's three GEMMs on its capacity rows ``xe[e]`` with its own
    SR seed stream ``ctx.fold(e)`` (K1 in training, K4 on a packed view in
    serving): (E, rows, d).  On a training mesh the stacked leaves are
    this rank's shards, each expert's gathered over "data" just before its
    GEMM (``fqt._ShardedFP4Matmul``; ``rows_whole``: xe's rows are whole
    on every rank, the two ``_ShardLayout``s built here say so)."""
    E = xe.shape[0]
    smooth = p.get("smooth") if smooth is None else smooth
    wg, wu, wd = (_per_expert(p[k], E) for k in ("w_gate", "w_up", "w_down"))
    layouts = None
    if rows_whole:
        from repro_torch.distributed.sharding import weight_kind
        layouts = {k: fqt._ShardLayout(ctx.mesh, *weight_kind(k, ctx.mesh),
                                       rows_whole=True) for k in ("io", "oi")}

    def gemm(ectx, x, w, kind):
        if layouts is None:
            return ectx.dense(x, w, kind=kind)
        return fqt._ShardedFP4Matmul.apply(x, w, ectx.next_seed(),
                                           ectx.qcfg, layouts[kind])

    ys = []
    for e in range(E):
        ectx = ctx.fold(e)
        xi = xe[e]
        g = gemm(ectx, xi, wg[e], "io")
        u = gemm(ectx, xi, wu[e], "io")
        h = (smooth_swiglu(g, u, smooth[e]) if smooth is not None
             else swiglu(g, u))
        ys.append(gemm(ectx, h, wd[e], "oi"))
    return torch.stack(ys)


def _kept_rows(routed, C: int) -> torch.Tensor:
    """The rows of the experts' stacked output (E, n·C, d), flattened, that
    the combine reads: each group's kept entries' slots (expert e, group g,
    capacity row c at e·n·C + g·C + c)."""
    n = len(routed)
    rows = []
    for g, r in enumerate(routed):
        slot, keep = r[1][0], r[1][3]
        s = slot[keep]
        rows.append(s // C * (n * C) + g * C + s % C)
    return torch.cat(rows)


def _experts_serving_mesh(p, xe, ctx: QCtx, cfg: ModelConfig,
                          rows: torch.Tensor):
    """The experts on a serving mesh (packed shards; every rank holds the
    same rows): per expert, ``w_gate``/``w_up`` column-parallel (K4 with
    the whole f's plan) and ``w_down`` row-parallel (K4 with the GLOBAL
    |h| max, f32 partial products), as ``tp_fp4_matmul`` computes one
    GEMM -- but with the layer's collectives batched over the experts:
    ONE all-reduce (max) of the E maxima of the down-projection inputs and
    ONE f32 all-reduce of the stacked (E, rows, d) partial products, so
    their count does not grow with E.  That sum covers only the ``rows``
    the combine reads (``_kept_rows``: the same on every rank, as the
    routing is): an empty capacity row's partial is 0 on every rank, and
    is left 0.  Under a "data" axis each stacked leaf is gathered once
    (``allgather_packed``).  Each expert keeps its own tensor scale, the
    whole expert's (``_expert``)."""
    from repro_torch.core.fqt import _if_divisible
    from repro_torch.distributed.compression import allgather_packed
    from repro_torch.kernels.fp4_matmul import tp_fp4_matmul
    mesh, qcfg = ctx.mesh, ctx.qcfg
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if mesh.axis_size("data") > 1:
        wg = allgather_packed(wg, mesh, "data", dim=1)
        wu = allgather_packed(wu, mesh, "data", dim=1)
        wd = allgather_packed(wd, mesh, "data", dim=-1)
    smooth = p.get("smooth")
    hs, seeds = [], []
    for e in range(cfg.n_experts):
        ectx = ctx.fold(e)
        g, u = (tp_fp4_matmul(xe[e], _expert(w, e), cfg=qcfg, mesh=mesh,
                              seed=ectx.next_seed(), parallel="column")
                for w in (wg, wu))
        hs.append(smooth_swiglu(g, u, smooth[e]) if smooth is not None
                  else swiglu(g, u))
        seeds.append(ectx.next_seed())
    amax = [None] * cfg.n_experts
    if _if_divisible(qcfg.fwd_a, cfg.d_ff) is not None:
        m = torch.stack([torch.amax(torch.abs(h.to(torch.float32)))
                         for h in hs])
        mesh.all_reduce(m, "model", op="max", label="moe_amax")
        amax = [m[e:e + 1] for e in range(cfg.n_experts)]
    y = torch.stack([tp_fp4_matmul(h, _expert(wd, e), cfg=qcfg, mesh=mesh,
                                   seed=s, parallel="row", a_amax=a,
                                   reduce=False)
                     for e, (h, s, a) in enumerate(zip(hs, seeds, amax))])
    flat = y.reshape(-1, y.shape[-1])
    kept = flat.index_select(0, rows)
    mesh.all_reduce(kept, "model", label="moe_partials")
    return torch.zeros_like(flat).index_copy_(0, rows, kept).reshape(
        y.shape).to(xe.dtype)


# ---- the training mesh's autograd collectives --------------------------------


class _GatherRows(torch.autograd.Function):
    """Every rank's rows (dim 0) of x over the DP ``axes`` (the first
    major: the global batch order); the backward keeps this rank's rows of
    the gradient, which is whole and the same on every rank (``_KeepRows``'
    backward), so no sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, x.shape[0]
        for a in reversed(axes):
            x = mesh.all_gather(x, a, dim=0, op="moe_gather")
        return x

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axes_index(ctx.axes)
        return g.narrow(0, i * ctx.n, ctx.n).contiguous(), None, None


class _KeepRows(torch.autograd.Function):
    """This rank's rows of a whole y; the backward all-gathers the rows'
    gradients over the DP ``axes``, so every rank holds the whole output
    gradient before the experts' backward (their update GEMMs quantize it
    with one tensor scale and 16-row blocks over every rank's tokens)."""

    @staticmethod
    def forward(ctx, y, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        n = y.shape[0] // mesh.axes_size(axes)
        return y.narrow(0, mesh.axes_index(axes) * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for a in reversed(ctx.axes):
            g = ctx.mesh.all_gather(g, a, dim=0, op="moe_gather")
        return g, None, None


class _OwnerGrad(torch.autograd.Function):
    """Identity; the gradient kept on the first rank of ``axes`` and zero
    on the others: a leaf whose whole gradient every rank computes, which
    the step then sums over the DP axes (``train/step._sync_dp_grads``),
    so it enters once."""

    @staticmethod
    def forward(ctx, w, mesh, axes):
        ctx.first = mesh.axes_index(axes) == 0
        return w

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None, None


class _ValueShare(torch.autograd.Function):
    """v / n in value, v in gradient: a term every rank holds whole, whose
    reported value the DP sum of the ranks' losses adds n times."""

    @staticmethod
    def forward(ctx, v, n: int):
        return v / n

    @staticmethod
    def backward(ctx, g):
        return g, None


def _apply_training_mesh(p, x, ctx: QCtx, cfg: ModelConfig, dp_rows: bool):
    """``moe_apply`` on a multi-rank mesh with unpacked weight shards:
    the training mesh (``dp_rows``: x holds this rank's rows of the tokens,
    split over the DP axes that ``sharding.grad_sum_axes`` sums), or a
    serving mesh's unpacked weights (every rank the same rows).

    Groups and capacity are the GLOBAL batch's (``groups`` of T = the
    rank's rows x dp).  "local" route (``dispatch_route``): each rank
    routes its own G/dp groups with no collective; each expert's rows are
    its groups' capacity rows, contiguous in the 1-device (E, G·C, d)
    order, which ``fqt._ShardLayout`` puts at ``dp_index · M_loc``; the
    aux share is the sum of its groups' aux over G.  "replicated" route:
    x and the router logits are all-gathered over the DP axes, every rank
    dispatches every group and runs the experts and the combine on them
    (``rows_whole``), then keeps its own rows; the aux is whole on every
    rank (its gradient whole, its reported value a 1/dp share) and a
    smoothing factor's whole gradient enters once (``_OwnerGrad``)."""
    mesh = ctx.mesh
    from repro_torch.distributed.sharding import dp_axes, grad_sum_axes
    axes = grad_sum_axes(mesh) if dp_rows else ()
    dp = mesh.axes_size(axes)
    T_loc = x.shape[0]
    G, Tg, C = groups(cfg, T_loc * dp)
    pods = mesh.axes_size(dp_axes(mesh)) // dp if dp_rows else 1
    route = dispatch_route(G, dp, C, _update_block(ctx.qcfg), pods)
    logits = ctx.dense_hp(x, p["router"], kind="d_rep").to(torch.float32)
    if route == "local":
        n = G // dp
        xe, routed = _route_groups(x, logits, cfg, n, C)
        _record(route, G, C, mesh.axes_index(axes) * n, routed)
        aux = torch.sum(torch.stack([r[2] for r in routed])) / G
        ye = _experts(p, xe, ctx, rows_whole=not dp_rows)
        return _combine_groups(ye, routed, C, Tg).to(x.dtype), aux
    xa = _GatherRows.apply(x, mesh, axes)
    la = _GatherRows.apply(logits, mesh, axes)
    xe, routed = _route_groups(xa, la, cfg, G, C)
    _record(route, G, C, 0, routed)
    aux = _ValueShare.apply(torch.mean(torch.stack([r[2] for r in routed])),
                            dp)
    smooth = p.get("smooth")
    if smooth is not None:
        smooth = _OwnerGrad.apply(smooth, mesh, axes)
    ye = _experts(p, xe, ctx, rows_whole=True, smooth=smooth)
    y = _combine_groups(ye, routed, C, Tg)
    return _KeepRows.apply(y, mesh, axes).to(x.dtype), aux


def moe_apply(p, x: torch.Tensor, ctx: QCtx, cfg: ModelConfig,
              dp_rows: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (y: (T, d), aux_loss f32 scalar).

    On a multi-rank mesh (``ctx.mesh``) the weights are this rank's shards:
    packed ones are the serving mesh's (routing replicated on every rank,
    the experts batched, ``_experts_serving_mesh``); unpacked ones go
    through ``_apply_training_mesh`` (``dp_rows``: x holds this rank's rows
    of the training batch; the aux returned is then this rank's share)."""
    mesh = ctx.mesh
    if mesh is not None and mesh.size > 1 and not isinstance(
            p["w_gate"], PackedQuantizedTensor):
        return _apply_training_mesh(p, x, ctx, cfg, dp_rows)
    T, d = x.shape
    G, Tg, C = groups(cfg, T)

    # ---- routing (high-precision router) ----
    serving_mesh = mesh is not None and mesh.size > 1
    logits = ctx.dense_hp(x, p["router"], kind="d_rep").to(
        torch.float32)                                         # (T, E)
    xe, routed = _route_groups(x, logits, cfg, G, C)
    _record("local", G, C, 0, routed)
    aux = torch.mean(torch.stack([r[2] for r in routed]))

    # ---- expert FFN, expert by expert (FQT dense) ----
    ye = (_experts_serving_mesh(p, xe, ctx, cfg, _kept_rows(routed, C))
          if serving_mesh else _experts(p, xe, ctx))

    # ---- combine (per group) ----
    return _combine_groups(ye, routed, C, Tg).to(x.dtype), aux
