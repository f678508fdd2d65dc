"""Mamba2 (SSD) blocks and the zamba2-style hybrid backbone (PyTorch).

Counterpart of ``repro.models.mamba2``.  The in/out projections are FQT
GEMMs (``QCtx.dense``: K1 in training, K4 on packed serving weights); the
SSD recurrence is plain PyTorch in f32, as the reference keeps it in jnp:
chunk-parallel in training (an intra-chunk masked-decay term, chunk states,
an inter-chunk scan) and one recurrent step per token in decode.  One
shared attention + SwiGLU block runs after every full group of
``attn_every`` Mamba layers, each application with its own KV cache (K6
reads it in decode).

Layout: ``params["mamba"]`` is a list of per-layer dicts (the reference
stacks them, ``checkpoint.ckpt`` writes one stacked leaf per name);
``mamba_ln`` stays one (n_layers, d) tensor.  The decode state is the
reference's stacked ``{"conv": (L, B, K-1, C), "ssm": (L, B, H, P, N)}``,
allocated once and updated IN PLACE by every decode step, so a recorded
serving program (``serve/graphs.py``) reads and writes fixed addresses.

Three-operand einsums run as the pairwise products the reference's
``jnp.einsum`` chooses (its contraction path depends on the sizes: the
state dim N against the head dim P, ``_outer_first``); f32 sums inside a
product run in torch's order, not XLA's.

Under a mesh of more than one rank (``mesh=``: serving or training, the
weights this rank's shards by the reference's rule table) a Mamba block
runs Megatron-style on this rank's SSM heads.  ``in_proj`` is column-
parallel, but its columns [z | x | B | C | dt] split over "model" are no
rank's heads (at zamba2's width rank 0 of 2 holds all of z and 96 columns
of x), so its output is all-gathered (exact: a column split leaves every
output's contraction whole); the depthwise conv runs on all channels with
the gathered ``conv_w`` (whose "vec_out" split is no head split either;
a serving tree holds it whole, ``packing.ENGINE_WHOLE``), its state
replicated; each rank takes its heads' x, dt, A and D and all of
B and C, and runs the SSD on them (the SSM state holds its heads, as the
reference's ``cache_specs`` splits it); y is all-gathered for the gated
norm over the whole d_inner (the 1-device bits: an all-reduced sum of
squares would round otherwise), and each rank's columns of the gated y
enter the row-parallel ``out_proj``, whose rows are head-major.  The
shared attention block is the dense Megatron block on local heads, its
KV caches this rank's heads; the lm_head is column-parallel, its logits
gathered.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.formats import M32
from repro_torch.core.fqt import QuantConfig
from repro_torch.models import refnum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (QCtx, attn_apply, attn_params,
                                       copy_to_tp, dense_init, embed_init,
                                       embed_lookup, gather_from_tp,
                                       make_kv_cache, mlp_apply, mlp_params,
                                       rmsnorm, scatter_to_tp)
from repro_torch.models.transformer import local_heads, nll_count

_SEED_STRIDE = 0x9E3779B9                   # per-layer SR seed stride
_SHARED_SEED = 0x51ED2701                   # + group: the shared block's seed
_HEAD_SEED = 0xABCDEF


# ---- Mamba2 block ---------------------------------------------------------------


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.n_ssm_heads or max(1, d_inner // 64)
    P = d_inner // H                       # head dim
    N = cfg.ssm_state                      # state dim
    return d_inner, H, P, N


def local_ssm_heads(cfg: ModelConfig, mesh=None) -> int:
    """This rank's SSM heads: the model's, split over "model"."""
    H = mamba_dims(cfg)[1]
    tp = 1 if mesh is None else mesh.axis_size("model")
    if H % tp:
        raise ValueError(f"{cfg.name}: {H} SSM heads do not split over "
                         f"tp={tp}")
    return H // tp


def mamba_params(gen: torch.Generator, cfg: ModelConfig,
                 dtype=torch.bfloat16, device=None):
    """One layer: in_proj emits [z, x, B, C, dt] (d_inner, d_inner, N, N,
    H columns)."""
    d_inner, H, P, N = mamba_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv = torch.randn((cfg.ssm_conv, d_inner + 2 * N), generator=gen, **f32)
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner + 2 * N + H,
                              dtype, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype,
                               device=device),
        "conv_w": (conv * 0.2).to(dtype),
        "A_log": torch.zeros((H,), **f32),        # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  x: (B, S, C); w: (K, C).  The K
    products are added in x's dtype in the reference's Python order.
    Returns (y, new_state), the state the last K-1 inputs."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return (torch.nn.functional.silu(y.to(torch.float32)).to(x.dtype),
            new_state)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (torch's own switches to x above a threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _outer_first(n: int, p: int) -> bool:
    """Whether ``jnp.einsum``'s optimal path for the SSD's chunk-state and
    decode-update sites (bcth,bctn,bcthp and bh,bn,bhp) multiplies the
    decay by B first, then by x: its costs are n(1 + 2p) and p(1 + 2n)
    flops a term, and a tie goes to the first pair."""
    return n <= p


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunk-parallel SSD.  xh: (B, S, H, P); dt: (B, S, H); A: (H,);
    Bm/Cm: (B, S, N), all f32.

        y[t] = C[t] . h[t],  h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] x[t]^T

    (per head; B and C shared across heads).  Returns (y, final state
    (B, H, P, N))."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    la = dtc * A                                       # (B,nc,c,H) log-decay
    csum = torch.cumsum(la, dim=2)

    # intra-chunk: L[s,t] = exp(csum[s] - csum[t]) for s >= t, masked
    # before exp (above the diagonal the difference is positive)
    diff = csum[:, :, :, None, :] - csum[:, :, None, :, :]   # (B,nc,s,t,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    Ldec = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                 torch.full_like(diff, -1e30)))
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))          # (B,nc,s,t)
    W = scores[..., None] * Ldec * dtc[:, :, None, :, :]     # (B,nc,s,t,H)
    # bcsth,bcthp->bcshp: per head, W (s, t) @ x (t, p)
    y_intra = torch.matmul(W.permute(0, 1, 4, 2, 3),
                           xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states: sum_t exp(csum[last] - csum[t]) dt[t] B[t] x[t]^T
    a = torch.exp(csum[:, :, -1:, :] - csum) * dtc           # (B,nc,c,H)
    xt = xc.permute(0, 1, 3, 4, 2)                           # (B,nc,H,P,c)
    if _outer_first(N, P):
        aB = a[..., :, None] * Bc[:, :, :, None, :]          # (B,nc,c,H,N)
        sbx = torch.matmul(xt, aB.permute(0, 1, 3, 2, 4))
    else:
        ax = (a[..., None] * xc).permute(0, 1, 3, 4, 2)      # (B,nc,H,P,c)
        sbx = torch.matmul(ax, Bc[:, :, None])               # (B,nc,H,P,N)

    # inter-chunk scan over the chunk states
    chunk_decay = torch.exp(csum[:, :, -1, :])               # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + sbx[:, ci]
    h_in = torch.stack(h_in, dim=1)                          # (B,nc,H,P,N)

    # the entering state's contribution, bcsn,bchpn,bcsh->bcshp: the
    # einsum's path contracts h with C first unless N < P (costs p(2n + 1)
    # and n(2p + 1) a term)
    dfs = torch.exp(csum)                                    # (B,nc,c,H)
    if not N < P:
        hc = torch.matmul(h_in, Cc[:, :, None].transpose(-1, -2))  # b c h p s
        y_inter = dfs.permute(0, 1, 3, 2)[:, :, :, None, :] * hc
        y_inter = y_inter.permute(0, 1, 4, 2, 3)
    else:
        dC = dfs[..., None] * Cc[:, :, :, None, :]           # (B,nc,s,H,N)
        y_inter = torch.matmul(dC.permute(0, 1, 3, 2, 4),
                               h_in.transpose(-1, -2))       # (B,nc,H,s,P)
        y_inter = y_inter.permute(0, 1, 3, 2, 4)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def ssd_step(h, dt, A, Bm, Cm, xh):
    """One recurrent SSD step, written into ``h`` (B, H, P, N) IN PLACE.
    dt: (B, H); Bm/Cm: (B, N); xh: (B, H, P).  Returns y (B, H, P)."""
    N, P = Bm.shape[-1], xh.shape[-1]
    dec = torch.exp(dt * A[None, :])                          # (B,H)
    if _outer_first(N, P):             # bh,bn,bhp->bhpn
        upd = (dt[:, :, None] * Bm[:, None, :])[:, :, None, :] \
            * xh[..., None]
    else:
        upd = (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
    h.copy_(h * dec[:, :, None, None] + upd)
    return torch.matmul(h, Cm[:, None, :, None])[..., 0]      # bn,bhpn->bhp


def mamba_apply(p, x, ctx: QCtx, cfg: ModelConfig, *, state=None,
                chunk: int = 64):
    """One Mamba2 block.  ``state``: None (training: the chunked SSD) or
    {"conv", "ssm"} tensors of one layer (decode, S == 1: one recurrent
    step), written IN PLACE.  Returns the block's output.  On a multi-rank
    ``ctx.mesh`` the SSD runs on this rank's heads (the module docstring);
    the SSM state holds them."""
    B, S, d = x.shape
    d_inner, H, P, N = mamba_dims(cfg)
    mesh = ctx.mesh
    zxbcdt = gather_from_tp(ctx.dense(x, p["in_proj"], kind="io"), mesh)
    z, xr, Bm, Cm, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H],
                                    dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_w = p["conv_w"]                  # a serving tree's is whole
    if conv_w.shape[-1] != conv_in.shape[-1]:
        conv_w = gather_from_tp(conv_w, mesh)
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_state)
    xr, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)

    dt = softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,S,H)
    A = -torch.exp(p["A_log"])                                     # (H,)
    # this rank's heads (all of them off a mesh); B and C enter every
    # rank's heads, so their gradients are summed over "model"
    Hl = local_ssm_heads(cfg, mesh)
    dt = scatter_to_tp(dt, mesh, dim=2)
    A = scatter_to_tp(A, mesh, dim=0)
    xh = scatter_to_tp(xr.reshape(B, S, H, P), mesh, dim=2).to(torch.float32)
    Bm32 = copy_to_tp(Bm.to(torch.float32), mesh)
    Cm32 = copy_to_tp(Cm.to(torch.float32), mesh)

    if state is None:
        c = min(chunk, S)
        if S % c:
            raise ValueError(f"seq {S} not divisible by ssm chunk {c}")
        y, _ = _ssd_chunked(xh, dt, A, Bm32, Cm32, c)
    else:
        if S != 1:
            raise ValueError(f"a recurrent decode step takes one token, "
                             f"got {S}")
        state["conv"].copy_(new_conv)
        y = ssd_step(state["ssm"], dt[:, 0], A, Bm32[:, 0], Cm32[:, 0],
                     xh[:, 0])[:, None]

    y = y + xh * scatter_to_tp(p["D"], mesh, dim=0)[None, None, :, None]
    y = gather_from_tp(y.reshape(B, S, Hl * P).to(x.dtype), mesh)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    y = y * torch.nn.functional.silu(z.to(torch.float32)).to(x.dtype)
    return ctx.dense(scatter_to_tp(y, mesh), p["out_proj"], kind="oi")


# ---- zamba2 hybrid backbone --------------------------------------------------------


def init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
         device=None, finish=None):
    """Parameter layout of ``repro.models.mamba2.init`` with per-layer
    ``mamba`` dicts.  Values from ``gen`` (torch's stream, a declared
    divergence) in the order embed, the Mamba layers, the shared block,
    lm_head; ``finish`` (e.g. the serving packer) is applied to each layer,
    the shared block and the lm_head as soon as they are drawn."""
    finish = finish if finish is not None else (lambda tree: tree)
    params = finish({"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype, device=device)})
    params.update({
        "mamba": [finish(mamba_params(gen, cfg, dtype, device))
                  for _ in range(cfg.n_layers)],
        "mamba_ln": torch.ones((cfg.n_layers, cfg.d_model), dtype=dtype,
                               device=device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    })
    if cfg.attn_every:
        params["shared_attn"] = finish({
            "attn": attn_params(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, dtype=dtype,
                                device=device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, "swiglu", dtype,
                              device=device),
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        })
    params.update(finish({"lm_head": dense_init(
        gen, cfg.d_model, cfg.padded_vocab, dtype, device=device)}))
    return params


def n_attn(cfg: ModelConfig) -> int:
    """Applications of the shared block: one after each full group."""
    return (cfg.n_layers // cfg.attn_every) if cfg.attn_every else 0


def _mamba_layer(cfg, qcfg, lp, ln_w, seed, x, state, chunk, mesh=None):
    ctx = QCtx(qcfg, seed, mesh)
    return x + mamba_apply(lp, rmsnorm(x, ln_w, cfg.norm_eps), ctx, cfg,
                           state=state, chunk=chunk)


def _apply_backbone(params, cfg: ModelConfig, qcfg: QuantConfig, x, seed,
                    *, states=None, caches=None, remat: bool = False,
                    ssm_chunk: int = 64, mesh=None):
    """The Mamba layers in groups of ``attn_every``, the shared attention
    and SwiGLU block after each full group with its own cache.  Decode
    (``states`` given) updates the states and caches in place.

    Seeds: Mamba layer l takes seed + l * 0x9E3779B9; the shared block at
    group g one context of seed + 0x51ED2701 + g, whose MLP continues the
    attention's call counter.  ``remat``: each Mamba layer under
    ``torch.utils.checkpoint`` (its QCtx made inside, so the recompute
    draws the same SR streams); the shared block is not rematerialised, as
    in the reference.  ``mesh``: the mesh of the weights' shards (the
    module docstring)."""
    L = cfg.n_layers
    ae = cfg.attn_every or L
    for l, lp in enumerate(params["mamba"]):
        s = (int(seed) + l * _SEED_STRIDE) & M32
        ln_w = params["mamba_ln"][l]
        if states is not None:
            st = {"conv": states["conv"][l], "ssm": states["ssm"][l]}
            x = _mamba_layer(cfg, qcfg, lp, ln_w, s, x, st, ssm_chunk, mesh)
        elif remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp, ln_w=ln_w, s=s: _mamba_layer(
                    cfg, qcfg, lp, ln_w, s, h, None, ssm_chunk, mesh),
                x, use_reentrant=False)
        else:
            x = _mamba_layer(cfg, qcfg, lp, ln_w, s, x, None, ssm_chunk,
                             mesh)
        if cfg.attn_every and (l + 1) % ae == 0 and "shared_attn" in params:
            g = l // ae
            sp = params["shared_attn"]
            ctx = QCtx(qcfg, (int(seed) + _SHARED_SEED + g) & M32, mesh)
            n_heads, n_kv = local_heads(cfg, mesh)
            h, _ = attn_apply(
                sp["attn"], rmsnorm(x, sp["ln1"], cfg.norm_eps), ctx,
                n_heads=n_heads, n_kv=n_kv, hd=cfg.hd,
                rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                cache=caches[g] if caches is not None else None)
            x = x + h
            x = x + mlp_apply(sp["mlp"], rmsnorm(x, sp["ln2"], cfg.norm_eps),
                              ctx, "swiglu")
    return x


def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device=None, mesh=None):
    """The stacked per-layer conv and SSM states of decode (under a
    serving ``mesh`` the SSM states of this rank's heads; the conv state
    whole, replicated)."""
    d_inner, H, P, N = mamba_dims(cfg)
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((L, batch, local_ssm_heads(cfg, mesh), P, N),
                           dtype=torch.float32, device=device),
    }


def reset_state(states) -> None:
    """Back to ``init_state``'s zeros, in place."""
    for t in states.values():
        t.zero_()


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_format: str = "bf16",
               page_size: Optional[int] = None,
               total_pages: Optional[int] = None, device=None, mesh=None):
    """One KV cache per application of the shared block (paged with
    ``page_size``, the buffer rounded up to whole pages; under a serving
    ``mesh`` this rank's KV heads)."""
    buf = max_len
    if page_size:
        buf = -(-buf // page_size) * page_size
    return [make_kv_cache(batch, buf, local_heads(cfg, mesh)[1], cfg.hd,
                          dtype,
                          kv_format, page_size=page_size,
                          total_pages=total_pages, device=device)
            for _ in range(n_attn(cfg))]


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
            seed: int = 0, remat: bool = True, ssm_chunk: int = 64,
            mesh=None):
    """Full-sequence forward (training).  Returns (logits, 0).  ``mesh``:
    the training mesh of the parameters' shards (tokens: this rank's
    rows)."""
    x = embed_lookup(params["embed"], tokens, mesh)
    x = _apply_backbone(params, cfg, qcfg, x, seed, remat=remat,
                        ssm_chunk=ssm_chunk, mesh=mesh)
    return (_logits(params, cfg, qcfg, x, seed, mesh),
            torch.zeros((), dtype=torch.float32, device=x.device))


def decode_step(params, cfg: ModelConfig, qcfg: QuantConfig, tokens, carry,
                *, seed: int = 0, mesh=None):
    """carry = (states, caches), both updated in place.  tokens: (B, 1).
    Returns (logits, carry).  ``mesh``: the serving mesh of the shards."""
    states, caches = carry
    x = embed_lookup(params["embed"], tokens, mesh)
    x = _apply_backbone(params, cfg, qcfg, x, seed, states=states,
                        caches=caches, mesh=mesh)
    return _logits(params, cfg, qcfg, x, seed, mesh), carry


def loss_fn(params, cfg: ModelConfig, qcfg: QuantConfig, batch, *,
            seed: int = 0, remat: bool = True, ssm_chunk: int = 64,
            mesh=None):
    """Next-token cross-entropy.  Returns (loss, {"nll", "aux"}).
    ``mesh``: the training mesh (``transformer.nll_count``)."""
    tokens = batch["tokens"].long()
    logits, aux = forward(params, cfg, qcfg, tokens[:, :-1], seed=seed,
                          remat=remat, ssm_chunk=ssm_chunk, mesh=mesh)
    loss = refnum.mean_nll(logits, tokens[:, 1:],
                           count=nll_count(tokens, mesh))
    return loss, {"nll": loss, "aux": aux}
