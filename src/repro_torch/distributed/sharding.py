"""Sharding rules of the serving mesh, and this rank's shards.

Counterpart of ``repro.distributed.sharding`` (its serving half).  The rule
table and its spec derivation are the reference's, on tuples of mesh-axis
names (the tuples a JAX ``PartitionSpec`` holds), so the port's specs
compare with the reference's leaf for leaf: TP shards the hidden / ffn /
head / vocab dimension of every weight on "model", FSDP its d_model
dimension on "data".

Where the reference hands the specs to GSPMD, which places each shard on
its device, here every rank is a process of its own: ``place_serve_params``
returns THIS rank's local shard of every leaf (a packed leaf's codes, block
scales and replicated tensor scale sliced congruently), and the model code
runs the Megatron decomposition on those shards (``core/fqt.py``,
``models/layers.py``).  That plan needs every split it names, so where
``_divisible`` would drop an axis from a leaf under a multi-rank mesh the
placement raises ``ValueError`` naming the leaf; the reference replicates
the leaf and carries on (a declared divergence).

``constrain``/``activation_sharding_scope`` (GSPMD layout annotations),
``cache_specs``, ``batch_shardings`` and ``opt_state_shardings`` belong to
the training mesh and are not here.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import PackedQuantizedTensor
from repro_torch.distributed import specs as pspecs

logger = logging.getLogger(__name__)


# ---- axis helpers -----------------------------------------------------------


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel (batch) mesh axes: ('pod','data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axis(mesh) -> Optional[str]:
    return "data" if "data" in mesh.axis_names else None


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def _mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


# ---- parameter rules (the reference's table, sharding.py:70-107) ------------

_PARAM_RULES = (
    (r"(^|/)(wq|wk|wv|w_gate|w_up|w_in|w_ff_gate|w_ff_up|in_proj|w_gates"
     r"|r_gates|w_q|w_k|w_v|w_if)$", "io"),
    (r"(^|/)(wo|w_down|w_out|out_proj|w_ff_down)$", "oi"),
    (r"(^|/)router$", "d_rep"),          # (..., d, E): router stays tiny
    (r"(^|/)(embed|pos_dec|pos_enc)$", "vocab_d"),
    (r"(^|/)lm_head$", "d_vocab"),
    (r"(^|/)(bq|bk|bv|b_in|b_out|smooth)$", "vec_out"),
    (r"(^|/)(conv_w)$", "vec_out"),      # (..., K, C): C is hidden-like
    (r".*", "rep"),                      # norms, gates, A_log, dt_bias, ...
)


def _spec_for(kind: str, ndim: int, mesh) -> tuple:
    fsdp, tp = fsdp_axis(mesh), tp_axis(mesh)
    lead = (None,) * (ndim - 2)
    if kind == "io":
        return (*lead, fsdp, tp) if ndim >= 2 else (tp,)
    if kind == "oi":
        return (*lead, tp, fsdp) if ndim >= 2 else (tp,)
    if kind == "d_rep":
        return (*lead, fsdp) if ndim >= 2 else ()
    if kind == "vocab_d":
        return (tp, fsdp)
    if kind == "d_vocab":
        return (fsdp, tp)
    if kind == "vec_out":
        return (*((None,) * (ndim - 1)), tp)
    return ()


def param_spec(path: str, ndim: int, mesh) -> tuple:
    for pat, kind in _PARAM_RULES:
        if re.search(pat, path):
            return _spec_for(kind, ndim, mesh)
    return ()


def _divisible(spec, shape, mesh, path: str = "",
               strict: bool = False) -> tuple:
    """Drop mesh axes that do not divide their dim (and normalise size-1
    axes and trailing Nones away).  A named leaf's every drop is
    diagnosed: logged, or raised with ``strict=True``; anonymous calls stay
    silent (the reference's ``_divisible``)."""
    drops: list = [] if path else None
    fixed = pspecs.divisible_axes(tuple(spec), tuple(shape),
                                  _mesh_axis_sizes(mesh), path=path,
                                  drops=drops)
    if drops:
        if strict:
            raise ValueError("; ".join(drops))
        for d in drops:
            logger.warning("sharding: %s", d)
    return fixed


def _walk(tree, fn, path=""):
    """``fn(path, leaf)`` over dicts and lists/tuples, slash-joined paths
    (list indices as numbers); a ``PackedQuantizedTensor`` is one leaf."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def params_specs(params, mesh):
    """The spec tree of a parameter tree (rank+name rules, divisibility
    diagnosed); a packed leaf gets ``spec_for_packed``'s dict."""
    def one(path, x):
        if isinstance(x, PackedQuantizedTensor):
            return spec_for_packed(path, x, mesh)
        if not isinstance(x, torch.Tensor):
            return x
        return _divisible(param_spec(path, x.ndim, mesh), x.shape, mesh,
                          path=path)

    return _walk(params, one)


def spec_for_packed(path: str, leaf: PackedQuantizedTensor, mesh,
                    strict: bool = False) -> dict:
    """Specs of the three leaves of one packed weight: the code spec from
    the rule table that shards the unpacked weight, re-validated on the
    nibble-halved and scale-blocked shapes; the scale and tensor-scale
    specs DERIVED from it (``specs.packed_leaf_specs``), so they are
    congruent by construction.  Returns {"packed", "scales", "tscale"}."""
    base = param_spec(path, leaf.ndim, mesh)
    drops: list = []
    out = pspecs.packed_leaf_specs(tuple(base), tuple(leaf.shape), leaf.axis,
                                   leaf.block, _mesh_axis_sizes(mesh),
                                   path=path, drops=drops)
    if drops and strict:
        raise ValueError("; ".join(drops))
    for d in drops:
        logger.warning("sharding: %s", d)
    return out


# ---- this rank's shards -----------------------------------------------------


def _shard_index(ax, mesh) -> Tuple[int, int]:
    """(number of shards, this rank's shard) of a dim sharded on ``ax`` (one
    axis or a tuple of axes, the first major)."""
    axes = ax if isinstance(ax, tuple) else (ax,)
    n, idx = 1, 0
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return n, idx


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a tensor of its own, so
    the full tensor can be freed); ``x`` itself where nothing is split."""
    out = x
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, idx = _shard_index(ax, mesh)
        size = x.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def place_serve_params(params, mesh):
    """This rank's local shard of every leaf of a (possibly packed) tree.

    Packed leaves are sliced by ``spec_for_packed`` (codes, block scales
    and the replicated tensor scale congruently), tensors by
    ``param_spec``.  On a 1-rank mesh this is the identity.  Under a larger
    mesh a leaf whose planned split does not divide raises ``ValueError``
    naming it."""
    def one(path, leaf):
        if isinstance(leaf, PackedQuantizedTensor):
            sh = spec_for_packed(path, leaf, mesh, strict=True)
            return dataclasses.replace(
                leaf, packed=local_shard(leaf.packed, sh["packed"], mesh),
                scales=local_shard(leaf.scales, sh["scales"], mesh),
                tscale=local_shard(leaf.tscale, sh["tscale"], mesh))
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = _divisible(param_spec(path, leaf.ndim, mesh), leaf.shape, mesh,
                          path=path, strict=True)
        return local_shard(leaf, spec, mesh)

    if mesh.size == 1:
        return params
    return _walk(params, one)


def local_dims(kind: str, shape, mesh) -> tuple:
    """The local shape of a leaf of rule ``kind`` and full ``shape``."""
    spec = pspecs.divisible_axes(_spec_for(kind, len(shape), mesh), shape,
                                 _mesh_axis_sizes(mesh))
    return tuple(s // (_shard_index(ax, mesh)[0] if ax else 1)
                 for s, ax in zip(shape, spec + (None,) * len(shape)))


def is_placed(params, cfg, mesh) -> bool:
    """Whether ``params`` (a transformer tree) already holds this rank's
    shards: read off its embedding table, which every multi-rank mesh
    splits.  Raises where the table is neither full nor local."""
    full = (cfg.padded_vocab, cfg.d_model)
    have = tuple(params["embed"].shape)
    if mesh.size == 1 or have == full:
        return False
    if have == local_dims("vocab_d", full, mesh):
        return True
    raise ValueError(f"embedding table {have} is neither the full {full} "
                     f"nor this rank's shard under {mesh.axis_names}="
                     f"{mesh.shape}")


def weight_kind(kind: str, mesh) -> Tuple[Optional[str], Optional[str]]:
    """(axis of K, axis of N) of a 2-D (K, N) weight of rule ``kind`` under
    ``mesh``: "model", "data" or None (size-1 axes are None)."""
    spec = _spec_for(kind, 2, mesh)
    sizes = _mesh_axis_sizes(mesh)
    return tuple(ax if ax is not None and sizes.get(ax, 1) > 1 else None
                 for ax in spec)


# ---- serving decode state ---------------------------------------------------


def serve_cache_shardings(cache_struct, mesh):
    """Specs of serving decode state (the reference's): a ``PagedKVCache``'s
    physical pools shard their KV-heads axis (``HEADS_AXIS``) over "model",
    page table and lengths replicated; every other cache leaf replicated.
    (The port's lockstep caches hold their local heads all the same:
    ``registry.make_decode_state``.)"""
    from repro_torch.models.layers import PagedKVCache
    tp = tp_axis(mesh)

    def pool_spec(x, path):
        spec = [None] * x.ndim
        if tp is not None and x.ndim >= 2:
            spec[PagedKVCache.HEADS_AXIS] = tp
            return _divisible(spec, x.shape, mesh, path=path)
        return tuple(spec)

    def one(path, leaf):
        if isinstance(leaf, PagedKVCache):
            return dataclasses.replace(
                leaf, **{f: pool_spec(getattr(leaf, f), f"{path}/{f}")
                         for f in ("k_codes", "k_scales", "v_codes",
                                   "v_scales")},
                page_table=(), lengths=())
        return ()

    if isinstance(cache_struct, (list, tuple)):
        return type(cache_struct)(one(str(i), c)
                                  for i, c in enumerate(cache_struct))
    return one("", cache_struct)


def place_serve_cache(cache, mesh):
    """This rank's share of a full serving cache: the paged pools' local
    KV heads (``serve_cache_shardings``); everything else as it is."""
    from repro_torch.models.layers import PagedKVCache
    if mesh.size == 1:
        return cache
    specs = serve_cache_shardings(cache, mesh)

    def one(c, s):
        if not isinstance(c, PagedKVCache):
            return c
        return dataclasses.replace(c, **{
            f: local_shard(getattr(c, f), getattr(s, f), mesh)
            for f in ("k_codes", "k_scales", "v_codes", "v_scales")})

    if isinstance(cache, (list, tuple)):
        return type(cache)(one(c, s) for c, s in zip(cache, specs))
    return one(cache, specs)
