"""Pipeline parallelism: the GPipe schedule over a "pipe" mesh axis.

Counterpart of ``repro.distributed.pipeline``.  The layer stack is split
into ``pipe`` stages, each rank holding ``L/S`` layers (its slice of the
stacked parameters' leading L axis), and microbatches stream through: the
hop between stages is a point-to-point transfer of one microbatch's
activations (``Mesh.send`` / ``Mesh.recv``, the reference's
``collective_permute``) instead of an all-gather of weights.

The reference runs a ``lax.scan`` over the ``M + S - 1`` ticks of the GPipe
diagonal inside a ``shard_map``: at tick t stage s processes microbatch
t - s, and the bubble ticks compute garbage that is masked on collection.
Here every stage is a process of its own and skips its bubble ticks; each
transfer is tagged with its microbatch.  The last stage's outputs are
broadcast to every stage, as the reference's masked ``psum``.

The backward is autograd through the point-to-point Functions: a stage's
received activation sends its gradient back to the previous stage, and its
sent activation receives its gradient from the next, which reproduces the
reverse schedule, as the reference's docstring says of ``ppermute``.
Sends are non-blocking (every rank waits only on the stage before it in
the forward and after it in the backward, so nothing waits in a cycle):
they wait in ``Mesh.pending`` until ``Mesh.wait_sends``, which
``pipeline_apply`` calls on entry and a caller calls after the backward.

Nothing in ``train.Trainer`` calls it, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed.mesh import make_pipeline_mesh  # noqa: F401

@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    axis: str = "pipe"


class _RecvPrev(torch.autograd.Function):
    """The activation of microbatch ``tag`` from the previous stage; its
    gradient goes back there."""

    @staticmethod
    def forward(ctx, anchor, like, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        return mesh.recv(like, axis, step=-1, tag=tag)

    @staticmethod
    def backward(ctx, g):
        ctx.mesh.pending.append(ctx.mesh.send(g, ctx.axis, step=-1,
                                              tag=ctx.tag))
        return None, None, None, None, None


class _SendNext(torch.autograd.Function):
    """Send ``h`` of microbatch ``tag`` to the next stage; returns a 0-d
    token that keeps the send in the graph, whose backward receives the
    gradient of ``h`` from the next stage."""

    @staticmethod
    def forward(ctx, h, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        ctx.like = torch.empty_like(h)
        mesh.pending.append(mesh.send(h.detach(), axis, step=1, tag=tag))
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return (ctx.mesh.recv(ctx.like, ctx.axis, step=1, tag=ctx.tag),
                None, None, None)


class _FromLast(torch.autograd.Function):
    """The last stage's ``out`` on every stage (a masked sum over the
    axis); the gradient returns to the last stage's ``out`` alone: every
    stage holds the same cotangent, so a sum would count it S times."""

    @staticmethod
    def forward(ctx, out, mesh, axis, last, *tokens):
        ctx.is_last = mesh.axis_index(axis) == last
        ctx.n_tokens = len(tokens)
        buf = out.detach().clone() if ctx.is_last else torch.zeros_like(out)
        return mesh.all_reduce(buf, axis)

    @staticmethod
    def backward(ctx, g):
        # the tokens' zero gradients still run each send's backward
        zero = g.new_zeros(())
        return ((g if ctx.is_last else None), None, None, None,
                *((zero,) * ctx.n_tokens))


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _slice(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _n_layers(tree) -> int:
    if isinstance(tree, dict):
        return _n_layers(next(iter(tree.values())))
    return tree.shape[0]


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, cfg: PipelineConfig) -> torch.Tensor:
    """Run ``x`` through the L stacked layers split over ``cfg.n_stages``
    stages of ``mesh``'s ``cfg.axis``.

    ``layer_fn(per_layer_params, h) -> h``; ``stacked_params``: a dict tree
    of tensors with a leading L axis, the whole stack (each stage applies
    its slice, and its gradients land in that slice); x: (B, ...) with B
    divisible by ``n_microbatches``, the same on every stage.  Returns the
    transformed activations, same shape as x, on every stage."""
    S, M, axis = cfg.n_stages, cfg.n_microbatches, cfg.axis
    if mesh.axis_size(axis) != S:
        raise ValueError(f"mesh axis {axis!r} has {mesh.axis_size(axis)} "
                         f"ranks, the config {S} stages")
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    L = _n_layers(stacked_params)
    if L % S:
        raise ValueError(f"{L} layers not divisible into {S} stages")
    mesh.wait_sends()
    s, per = mesh.axis_index(axis), L // S
    stage = _slice(stacked_params, s * per, (s + 1) * per)
    xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    anchor = x.new_zeros((), requires_grad=True)
    outs, tokens = [None] * M, []
    for t in range(M + S - 1):
        m = t - s                      # this stage's microbatch at tick t
        if not 0 <= m < M:
            continue                   # a bubble tick
        h = xs[m] if s == 0 else _RecvPrev.apply(anchor, xs[m], mesh, axis,
                                                 m)
        for j in range(per):
            h = layer_fn(_index(stage, j), h)
        if s < S - 1:
            tokens.append(_SendNext.apply(h, mesh, axis, m))
        else:
            outs[m] = h
    local = torch.stack(outs) if s == S - 1 else torch.zeros_like(xs)
    out = _FromLast.apply(local, mesh, axis, S - 1, *tokens)
    return out.reshape(x.shape)
