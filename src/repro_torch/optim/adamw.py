"""AdamW with FP32 master weights, the FQT training optimizer (PyTorch).

Counterpart of ``repro.optim.adamw``: bf16 compute weights (quantized to FP4
per GEMM), f32 master weights and moments, global-norm clipping (the clipped
gradient is cast back to its dtype, as the reference does) and decoupled
weight decay.  The arithmetic follows the reference expression by
expression in f32.

Trees are the port's parameter layout (dicts, ``layers`` a list of per-layer
dicts).  ``apply`` updates the master weights and moments IN PLACE, leaf by
leaf: the state passed in is consumed, as the reference's donated train
state is, and no second copy of the optimizer state is ever allocated.

On a multi-rank training mesh (``mesh=``) the trees are this rank's shards
(``distributed/sharding.place_train_state``): the global norm sums each
leaf's squares over the ranks that hold distinct parts of it, a replicated
leaf counted once (``sharding.mesh_sum``), and the update is elementwise on
the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: Any = torch.float32     # bf16 for very large models
    master_dtype: Any = torch.float32


@dataclasses.dataclass
class AdamWState:
    step: int          # updates applied so far
    master: Any        # f32 master weights (a tree like params)
    m: Any
    v: Any


def tree_map(fn: Callable, tree, *rest):
    """Map over the leaves of dict/list trees of the same structure (the
    port's parameter layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order (dict insertion order, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def init(params, cfg: AdamWConfig) -> AdamWState:
    return AdamWState(
        0, tree_map(lambda p: p.to(cfg.master_dtype, copy=True), params),
        tree_map(lambda p: torch.zeros_like(p, dtype=cfg.moment_dtype),
                 params),
        tree_map(lambda p: torch.zeros_like(p, dtype=cfg.moment_dtype),
                 params))


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2) in f32 (a device scalar).
    ``mesh``: the leaves are this rank's shards; the sum is the whole
    tree's, the same bits on every rank."""
    sqs = [torch.sum(torch.square(g.to(torch.float32)))
           for g in tree_leaves(tree)]
    if mesh is not None and mesh.size > 1:
        from repro_torch.distributed import sharding
        owners = [sharding.is_owner(sp, mesh) for sp in
                  tree_leaves(sharding.tree_specs(tree, mesh))]
        sqs = list(sharding.mesh_sum(torch.stack(sqs), owners, mesh))
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g scaled in f32 and cast back to its dtype, as the reference clips."""
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float, mesh=None, norm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm (``norm``: the norm already computed for ``grads``)."""
    norm = global_norm(grads, mesh) if norm is None else norm
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), norm


# elements of a leaf updated at once (f32 temporaries of ~256 MB each)
_UPDATE_CHUNK = 1 << 26


def apply(grads, state: AdamWState, cfg: AdamWConfig, lr: torch.Tensor,
          mesh=None, gnorm: Optional[torch.Tensor] = None):
    """One AdamW step.  Returns (new compute-dtype params, new state,
    metrics); ``state``'s master weights and moments are updated in place.
    ``lr``: an f32 scalar tensor (``schedule.lr_at``); ``mesh``: the trees
    are this rank's shards (``global_norm``); ``gnorm``: ``grads``'s global
    norm where the caller has it already (on a mesh, an all-reduce
    saved).

    Each leaf is clipped (``clip_by_global_norm``'s bits) as it is
    updated, a run of its leading dim at a time (``_UPDATE_CHUNK``
    elements; one run for most leaves, several for a moe layer's stacked
    experts or a large vocabulary's rows): no second gradient tree, and
    f32 temporaries of one run, not of the whole leaf, elementwise the
    same bits."""
    if gnorm is None:
        gnorm = global_norm(grads, mesh)
    scale = (None if cfg.clip_norm is None
             else _clip_scale(gnorm, cfg.clip_norm))
    step = state.step + 1
    b1, b2 = cfg.betas
    f32 = torch.float32
    stepf = torch.tensor(float(step), dtype=f32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32), stepf)

    def upd_part(g, master, m, v):
        if scale is not None:
            g = _clipped(g, scale)
        g32 = g.to(f32)
        m32 = m.to(f32) * b1 + (1 - b1) * g32
        v32 = v.to(f32) * b2 + (1 - b2) * g32 * g32
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps) \
            + cfg.weight_decay * master.to(f32)
        master.copy_(master.to(f32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
        # compute weights follow the gradient's (= the parameter's) dtype
        return master.to(g.dtype)

    def upd(g, master, m, v):
        if g.ndim == 0:
            return upd(g[None], master[None], m[None], v[None])[0]
        out = torch.empty_like(g)
        n = max(1, _UPDATE_CHUNK // max(1, g[0].numel()))
        for i in range(0, g.shape[0], n):
            s = slice(i, i + n)
            out[s] = upd_part(g[s], master[s], m[s], v[s])
        return out

    new_params = tree_map(upd, grads, state.master, state.m, state.v)
    state.step = step
    return new_params, state, {"grad_norm": gnorm, "lr": lr}
