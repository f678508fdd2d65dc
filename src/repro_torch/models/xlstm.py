"""xLSTM: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar memory,
sequential) blocks (PyTorch).

Counterpart of ``repro.models.xlstm``: every ``slstm_every``-th block is
sLSTM, the rest mLSTM.  The projections are FQT GEMMs (``QCtx.dense``: K1 in
training, K4 on packed serving weights); the gates' projections
(``w_if``, the recurrent ``r_gates``) are high-precision (``dense_hp``, no
SR stream), and the cells are plain PyTorch in f32, as the reference keeps
them in jnp.  The mLSTM trains in a chunk-parallel form (gated linear
attention with a scalar per-head decay) and decodes one recurrent step per
token; the sLSTM runs a time loop in both, with its stabiliser state.  The
exponential input gate is clamped (``IGATE_CLAMP``) as in the reference.

Layout: ``params["layers"]`` is the reference's list of per-layer dicts,
``{"mlstm": ...}`` or ``{"slstm": ...}``: heterogeneous, so
``checkpoint.ckpt`` numbers its leaves per layer.  The decode state is a
list of per-layer tuples ((C, n) or (c, n, h, m)), allocated once and
updated IN PLACE by every decode step (``serve/graphs.py``).

Under a mesh of more than one rank (``mesh=``: serving or training, the
weights this rank's shards by the reference's rule table) the blocks run
Megatron-style.  A concatenated column-parallel projection's output is
all-gathered (exact: every output's contraction is whole), as its split
over "model" is no rank's heads: ``w_up`` = [x arm | gate arm] (at tp=2
rank 0 holds the whole x arm) and the sLSTM's ``w_gates`` (four gates
stacked).  The high-precision gate projections ``w_if`` = [i | f] (at
tp=2 rank 0 holds every input gate) and the sLSTM's recurrent
``r_gates`` are small: their columns are gathered instead and every rank
computes the whole product (``QCtx.hp_weight``; ``r_gates`` once a call,
before the time loop; a serving tree holds both whole,
``packing.ENGINE_WHOLE``).  The mLSTM's ``w_q`` / ``w_k`` / ``w_v`` split
into whole heads: each rank runs the cell on its heads (its (C, n) state
holds them), y is all-gathered for the norm over the whole d_inner (the
1-device bits), and each rank's columns of the gated y enter the
row-parallel ``w_down``.  The sLSTM's carry (c, n, h, m) stays
replicated; its FFN is the Megatron pair (``w_ff_gate`` / ``w_ff_up``
column, ``w_ff_down`` row).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import refnum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (QCtx, dense_init, embed_init,
                                       embed_lookup, gather_from_tp,
                                       rmsnorm, scatter_to_tp, swiglu)
from repro_torch.models.transformer import nll_count

_SEED_STRIDE = 0x9E3779B9
_HEAD_SEED = 0xABCDEF
IGATE_CLAMP = 3.0
M_INIT = -10.0                   # the sLSTM stabiliser's initial value


def _dims(cfg: ModelConfig):
    d_inner = int(cfg.proj_factor * cfg.d_model)
    H = cfg.n_heads
    P = d_inner // H
    return d_inner, H, P


def local_heads(cfg: ModelConfig, mesh=None) -> int:
    """This rank's mLSTM heads: the model's, split over "model"."""
    tp = 1 if mesh is None else mesh.axis_size("model")
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} mLSTM heads do not "
                         f"split over tp={tp}")
    return cfg.n_heads // tp


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x), softplus as logaddexp."""
    return -(torch.clamp(-x, min=0) + torch.log1p(torch.exp(-torch.abs(x))))


# ---- mLSTM ----------------------------------------------------------------------


def mlstm_params(gen: torch.Generator, cfg: ModelConfig,
                 dtype=torch.bfloat16, device=None):
    d = cfg.d_model
    d_inner, H, P = _dims(cfg)
    return {
        "w_up": dense_init(gen, d, 2 * d_inner, dtype, device=device),
        "w_q": dense_init(gen, d_inner, d_inner, dtype, device=device),
        "w_k": dense_init(gen, d_inner, d_inner, dtype, device=device),
        "w_v": dense_init(gen, d_inner, d_inner, dtype, device=device),
        "w_if": dense_init(gen, d_inner, 2 * H, dtype, scale=0.01,
                           device=device),
        "b_if": torch.cat([torch.zeros((H,), device=device),
                           3.0 * torch.ones((H,), device=device)]),
        "w_down": dense_init(gen, d_inner, d, dtype, device=device),
        "norm": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def _per_head(t: torch.Tensor) -> torch.Tensor:
    """(B, nc, c, H, X) -> (B, nc, H, c, X)."""
    return t.permute(0, 1, 3, 2, 4)


def _mlstm_chunked(q, k, v, li, lf, chunk: int):
    """q, k, v: (B, S, H, P); li/lf: (B, S, H) log input / log forget gates.

      C_t = f_t C_{t-1} + i_t v_t k_t^T      (C: (P_v, P_k))
      n_t = f_t n_{t-1} + i_t k_t
      y_t = (C_t q_t) / max(|n_t . q_t|, 1)

    Chunk-parallel: intra-chunk masked-decay attention and a scan over the
    chunk states.  Returns (y, (C_T, n_T))."""
    B, S, H, P = q.shape
    nc = S // chunk
    f32 = torch.float32
    qc = q.reshape(B, nc, chunk, H, P).to(f32) * (P ** -0.5)
    kc = k.reshape(B, nc, chunk, H, P).to(f32)
    vc = v.reshape(B, nc, chunk, H, P).to(f32)
    lic = li.reshape(B, nc, chunk, H)
    lfc = lf.reshape(B, nc, chunk, H)
    F = torch.cumsum(lfc, dim=2)                         # log prod f_1..s

    # intra-chunk weights w[s,t] = exp(F_s - F_t + li_t), s >= t
    logw = (F[:, :, :, None, :] - F[:, :, None, :, :]
            + lic[:, :, None, :, :])                     # (B,nc,s,t,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    w = torch.exp(torch.where(mask[None, None, :, :, None], logw,
                              torch.full_like(logw, -1e30)))
    wh = w.permute(0, 1, 4, 2, 3)                        # (B,nc,H,s,t)
    scores = torch.matmul(_per_head(qc), _per_head(kc).transpose(-1, -2))
    # bcsth,bcsth,bcthp: (scores * w) first, then the sum over t with v
    y_intra = torch.matmul(scores * wh, _per_head(vc))   # (B,nc,H,s,P)
    n_intra = torch.matmul(wh, _per_head(kc))

    # chunk summaries: the contribution of chunk c to the state after it
    dec_end = torch.exp(F[:, :, -1:, :] - F + lic)       # (B,nc,t,H)
    # bcth,bcthv,bcthk: (dec * v) first, then the sum over t with k
    C_sum = torch.matmul(_per_head(dec_end[..., None] * vc).transpose(-1, -2),
                         _per_head(kc))                  # (B,nc,H,Pv,Pk)
    n_sum = torch.matmul(dec_end.permute(0, 1, 3, 2)[:, :, :, None, :],
                         _per_head(kc))[:, :, :, 0]      # (B,nc,H,Pk)
    chunk_dec = torch.exp(F[:, :, -1, :])                # (B,nc,H)

    C = torch.zeros((B, H, P, P), dtype=f32, device=q.device)
    n = torch.zeros((B, H, P), dtype=f32, device=q.device)
    C_in, n_in = [], []
    for ci in range(nc):
        C_in.append(C)
        n_in.append(n)
        dec = chunk_dec[:, ci]
        C = C * dec[:, :, None, None] + C_sum[:, ci]
        n = n * dec[:, :, None] + n_sum[:, ci]
    C_in = torch.stack(C_in, dim=1)                      # (B,nc,H,Pv,Pk)
    n_in = torch.stack(n_in, dim=1)                      # (B,nc,H,Pk)

    decf = torch.exp(F)                                  # (B,nc,s,H)
    # bcshk,bchvk,bcsh: C_in . q over k first, then the decay
    y_inter = torch.matmul(_per_head(qc), C_in.transpose(-1, -2)) \
        * decf.permute(0, 1, 3, 2)[..., None]            # (B,nc,H,s,Pv)
    n_vec = _per_head(n_intra) + n_in[:, :, None, :, :] * decf[..., None]
    qn = torch.matmul(qc[..., None, :], n_vec[..., :, None])[..., 0, 0]
    denom = torch.clamp(torch.abs(qn), min=1.0)          # (B,nc,s,H)
    y = _per_head(y_intra + y_inter) / denom[..., None]
    return y.reshape(B, S, H, P), (C, n)


def mlstm_step(state, q, k, v, li, lf):
    """One recurrent mLSTM step, written into ``state`` = (C, n) IN PLACE.
    q, k, v: (B, H, P); li/lf: (B, H).  Returns y (B, H, P)."""
    C, n = state
    P = q.shape[-1]
    i = torch.exp(li)
    f = torch.exp(lf)
    q0 = q.to(torch.float32) * (P ** -0.5)
    k0 = k.to(torch.float32)
    v0 = v.to(torch.float32)
    C.copy_(C * f[..., None, None]
            + i[..., None, None] * (v0[..., :, None] * k0[..., None, :]))
    n.copy_(n * f[..., None] + i[..., None] * k0)
    num = torch.matmul(C, q0[..., None])[..., 0]         # bhk,bhvk->bhv
    qn = torch.matmul(q0[..., None, :], n[..., None])[..., 0, 0]
    return num / torch.clamp(torch.abs(qn), min=1.0)[..., None]


def mlstm_apply(p, x, ctx: QCtx, cfg: ModelConfig, *, state=None,
                chunk: int = 64):
    """Pre-up-projected mLSTM block.  ``state``: None (training) or the
    layer's (C, n), updated in place (decode, S == 1).  On a multi-rank
    ``ctx.mesh`` the cell runs on this rank's heads (the module
    docstring); the state holds them."""
    B, S, d = x.shape
    d_inner, H, P = _dims(cfg)
    mesh = ctx.mesh
    Hl = local_heads(cfg, mesh)
    up = gather_from_tp(ctx.dense(x, p["w_up"], kind="io"), mesh)
    xa, ga = torch.split(up, d_inner, dim=-1)
    q = ctx.dense(xa, p["w_q"], kind="io").reshape(B, S, Hl, P)
    k = ctx.dense(xa, p["w_k"], kind="io").reshape(B, S, Hl, P)
    v = ctx.dense(xa, p["w_v"], kind="io").reshape(B, S, Hl, P)
    gif = ctx.dense_hp(xa, ctx.hp_weight(p["w_if"], "io", (d_inner, 2 * H))
                       ).to(torch.float32) + p["b_if"]
    gi, gf = torch.split(gif, H, dim=-1)                 # (B,S,H)
    li = scatter_to_tp(torch.clamp(gi, max=IGATE_CLAMP), mesh)  # log i
    lf = scatter_to_tp(log_sigmoid(gf), mesh)            # log f

    if state is None:
        c = min(chunk, S)
        if S % c:
            raise ValueError(f"seq {S} not divisible by mlstm chunk {c}")
        y, _ = _mlstm_chunked(q, k, v, li, lf, c)
    else:
        if S != 1:
            raise ValueError(f"a recurrent decode step takes one token, "
                             f"got {S}")
        y = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                       lf[:, 0])[:, None]

    y = gather_from_tp(y.reshape(B, S, Hl * P).to(x.dtype), mesh)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    y = y * torch.nn.functional.silu(ga.to(torch.float32)).to(x.dtype)
    return ctx.dense(scatter_to_tp(y, mesh), p["w_down"], kind="oi")


# ---- sLSTM ----------------------------------------------------------------------


def slstm_params(gen: torch.Generator, cfg: ModelConfig,
                 dtype=torch.bfloat16, device=None):
    """The reference draws ``w_ff_gate`` and ``w_ff_up`` from one key, so
    they start equal: one draw here, two tensors."""
    d = cfg.d_model
    f = int(cfg.proj_factor * d)
    w_gates = dense_init(gen, d, 4 * d, dtype, device=device)
    r_gates = dense_init(gen, d, 4 * d, dtype, scale=0.01, device=device)
    w_ff = dense_init(gen, d, f, dtype, device=device)
    return {
        "w_gates": w_gates,
        "r_gates": r_gates,
        "b_gates": torch.zeros((4 * d,), device=device),
        "w_ff_gate": w_ff,
        "w_ff_up": w_ff.clone(),
        "w_ff_down": dense_init(gen, f, d, dtype, device=device),
        "norm": torch.ones((d,), dtype=dtype, device=device),
    }


def slstm_cell(p, gin, carry, ctx: QCtx, dtype, r_gates):
    """One sLSTM time step: gin (B, 4d) the input GEMM's row, carry (c, n,
    h, m), ``r_gates`` the recurrent weight as ``ctx.hp_weight`` gives it.
    Returns the new carry."""
    c, n, h, m = carry
    pre = (gin.to(torch.float32) + p["b_gates"]
           + ctx.dense_hp(h.to(dtype), r_gates).to(torch.float32))
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = log_sigmoid(f)
    m_new = torch.maximum(logf + m, i)                   # stabiliser
    ip = torch.exp(i - m_new)
    fp = torch.exp(logf + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h = o * (c / torch.clamp(n, min=1.0))
    return c, n, h, m_new


def slstm_apply(p, x, ctx: QCtx, cfg: ModelConfig, *, state=None):
    """Sequential sLSTM with exponential gating and a stabiliser state.
    The input GEMM runs once over the sequence (FQT); the recurrent matvec
    (``dense_hp``, no SR stream) runs in the time loop.  ``state``: None
    (training, from zeros and m = M_INIT) or the layer's (c, n, h, m),
    updated in place (decode).  On a multi-rank ``ctx.mesh`` the carry is
    replicated and ``r_gates`` gathered whole once (the module
    docstring)."""
    B, S, d = x.shape
    mesh = ctx.mesh
    gates_in = gather_from_tp(ctx.dense(x, p["w_gates"], kind="io"),
                              mesh)                      # (B,S,4d)
    r_gates = ctx.hp_weight(p["r_gates"], "io", (d, 4 * d))
    if state is None:
        z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (z, z, z, z + M_INIT)
    else:
        carry = state
    hs = []
    for t in range(S):
        carry = slstm_cell(p, gates_in[:, t], carry, ctx, x.dtype,
                           r_gates)
        hs.append(carry[2])
    if state is not None:
        for dst, src in zip(state, carry):
            dst.copy_(src)
    y = torch.stack(hs, dim=1).to(x.dtype)               # (B,S,d)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    g = ctx.dense(y, p["w_ff_gate"], kind="io")
    u = ctx.dense(y, p["w_ff_up"], kind="io")
    return ctx.dense(swiglu(g, u), p["w_ff_down"], kind="oi")


# ---- backbone ---------------------------------------------------------------------


def is_slstm(cfg: ModelConfig, layer: int) -> bool:
    return bool(cfg.slstm_every) and (layer + 1) % cfg.slstm_every == 0


def init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
         device=None, finish=None):
    """Parameter layout of ``repro.models.xlstm.init``.  Values from
    ``gen`` (torch's stream, a declared divergence) in the order embed, the
    layers, lm_head; ``finish`` (e.g. the serving packer) is applied to each
    layer and the lm_head as soon as they are drawn."""
    finish = finish if finish is not None else (lambda tree: tree)
    params = finish({"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype, device=device)})
    params["layers"] = [
        finish({"slstm": slstm_params(gen, cfg, dtype, device)}
               if is_slstm(cfg, l) else
               {"mlstm": mlstm_params(gen, cfg, dtype, device)})
        for l in range(cfg.n_layers)]
    params["ln"] = torch.ones((cfg.n_layers, cfg.d_model), dtype=dtype,
                              device=device)
    params["ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    params.update(finish({"lm_head": dense_init(
        gen, cfg.d_model, cfg.padded_vocab, dtype, device=device)}))
    return params


def init_state(cfg: ModelConfig, batch: int, device=None, mesh=None):
    """Per-layer decode states: (C, n) for mLSTM (under a serving ``mesh``
    this rank's heads), (c, n, h, m) for sLSTM (replicated)."""
    d_inner, _, P = _dims(cfg)
    H = local_heads(cfg, mesh)
    f32 = dict(dtype=torch.float32, device=device)
    states = []
    for l in range(cfg.n_layers):
        if is_slstm(cfg, l):
            states.append(tuple(torch.zeros((batch, cfg.d_model), **f32)
                                for _ in range(3))
                          + (torch.full((batch, cfg.d_model), M_INIT,
                                        **f32),))
        else:
            states.append((torch.zeros((batch, H, P, P), **f32),
                           torch.zeros((batch, H, P), **f32)))
    return states


def reset_state(states) -> None:
    """Back to ``init_state``'s values, in place."""
    for st in states:
        for t in st[:3]:
            t.zero_()
        if len(st) == 4:
            st[3].fill_(M_INIT)


def _block(cfg, qcfg, lp, ln_w, seed, x, state, chunk, mesh=None):
    ctx = QCtx(qcfg, seed, mesh)
    xin = rmsnorm(x, ln_w, cfg.norm_eps)
    if "slstm" in lp:
        y = slstm_apply(lp["slstm"], xin, ctx, cfg, state=state)
    else:
        y = mlstm_apply(lp["mlstm"], xin, ctx, cfg, state=state, chunk=chunk)
    return x + y


def _backbone(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed, *,
              states=None, remat: bool = False, chunk: int = 64, mesh=None):
    """The blocks in order; layer l's QCtx takes seed + l * 0x9E3779B9.
    ``remat`` (training): each block under ``torch.utils.checkpoint``, its
    QCtx made inside so the recompute draws the same SR streams.
    ``mesh``: the mesh of the weights' shards."""
    for l, lp in enumerate(params["layers"]):
        s = (int(seed) + l * _SEED_STRIDE) & M32
        ln_w = params["ln"][l]
        st = states[l] if states is not None else None
        if remat and st is None and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp, ln_w=ln_w, s=s: _block(
                    cfg, qcfg, lp, ln_w, s, h, None, chunk, mesh),
                x, use_reentrant=False)
        else:
            x = _block(cfg, qcfg, lp, ln_w, s, x, st, chunk, mesh)
    return x


def _logits(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed,
            mesh=None):
    """The lm_head (column-parallel over the vocabulary on a multi-rank
    mesh, its logits gathered); the padded ids are not masked, as in the
    reference."""
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    ctx = QCtx(qcfg if cfg.quantize_lm_head else QuantConfig(),
               (int(seed) + _HEAD_SEED) & M32, mesh)
    return gather_from_tp(ctx.dense(x, params["lm_head"], kind="d_vocab"),
                          mesh)


def forward(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, *,
            seed: int = 0, remat: bool = True, chunk: int = 64, mesh=None):
    """Full-sequence forward (training).  Returns (logits, 0).  ``mesh``:
    the training mesh of the parameters' shards (tokens: this rank's
    rows)."""
    x = embed_lookup(params["embed"], tokens, mesh)
    x = _backbone(params, cfg, qcfg, x, seed, remat=remat, chunk=chunk,
                  mesh=mesh)
    return (_logits(params, cfg, qcfg, x, seed, mesh),
            torch.zeros((), dtype=torch.float32, device=x.device))


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, states,
                *, seed: int = 0, mesh=None):
    """One token per sequence (tokens (B, 1)); ``states`` updated in place.
    Returns (logits, states).  ``mesh``: the serving mesh of the shards."""
    x = embed_lookup(params["embed"], tokens, mesh)
    x = _backbone(params, cfg, qcfg, x, seed, states=states, mesh=mesh)
    return _logits(params, cfg, qcfg, x, seed, mesh), states


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True, chunk: int = 64, mesh=None):
    """Next-token cross-entropy.  Returns (loss, {"nll", "aux"}).
    ``mesh``: the training mesh (``transformer.nll_count``)."""
    tokens = batch["tokens"].long()
    logits, aux = forward(params, cfg, qcfg, tokens[:, :-1], seed=seed,
                          remat=remat, chunk=chunk, mesh=mesh)
    loss = refnum.mean_nll(logits, tokens[:, 1:],
                           count=nll_count(tokens, mesh))
    return loss, {"nll": loss, "aux": aux}
