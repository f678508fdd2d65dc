"""Sharding rules of the serving and training meshes, and this rank's
shards.

Counterpart of ``repro.distributed.sharding``.  The rule table and its spec
derivation are the reference's, on tuples of mesh-axis names (the tuples a
JAX ``PartitionSpec`` holds), so the port's specs compare with the
reference's leaf for leaf: TP shards the hidden / ffn / head / vocab
dimension of every weight on "model", FSDP its d_model dimension on "data",
DP the batch over ("pod", "data"); AdamW's master weights and moments follow
their parameter (``opt_state_shardings``).

Where the reference hands the specs to GSPMD, which places each shard on
its device, here every rank is a process of its own: ``place_serve_params``
returns THIS rank's local shard of every leaf (a packed leaf's codes, block
scales and replicated tensor scale sliced congruently), and the model code
runs the Megatron decomposition on those shards (``core/fqt.py``,
``models/layers.py``).  That plan needs every split it names, so where
``_divisible`` would drop an axis from a leaf under a multi-rank mesh the
placement raises ``ValueError`` naming the leaf; the reference replicates
the leaf and carries on (a declared divergence).

Rules are name+rank based, so a moe layer's stacked experts need no rule
of their own: ``w_gate`` / ``w_up`` (E, d, f) take ("data", "model") on
their last two dims and ``w_down`` the other way, the expert axis
replicated (the reference has no expert parallelism); the router (d, E) is
"d_rep", a smoothing factor (E, f) "vec_out".

``place_train_state`` is the training counterpart of
``place_serve_params``: this rank's shard of every parameter and of its
master weights and moments, the step counters and the threshold state
replicated.

``params_shardings``, ``batch_shardings``, ``opt_state_shardings``,
``cache_specs`` and ``train/step.state_shardings`` return the reference's
spec trees, for comparison with it (the tests hold them leaf for leaf);
nothing on the port's path reads them: it places by the ``place_*``
functions and reads a placed leaf's spec with ``placed_spec``.

``activation_sharding_scope`` / ``constrain`` keep the reference's API:
under GSPMD they pin the activation layout; here the layout is what the
Megatron decomposition computes, which is the reference's "replicated"
mode (the residual stream replicated over "model", the batch over the DP
axes), so ``constrain`` is the identity.  The sequence-parallel mode "sp"
raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import contextvars
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


def param_kind(path: str) -> str:
    """The rule-table kind of a leaf path ("io", "oi", "vocab_d", ...)."""
    for pat, kind in _PARAM_RULES:
        if re.search(pat, path):
            return kind
    return "rep"


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


def params_shardings(params, mesh):
    """The spec tree of a parameter tree (the reference's
    ``params_shardings``, whose ``NamedSharding``s hold these specs)."""
    return params_specs(params, mesh)


def placed_spec(path: str, ndim: int, mesh) -> tuple:
    """The spec of a leaf that ``place_train_state`` / ``place_serve_params``
    placed: the planned rule with size-1 axes dropped (placement raised
    where a split does not divide, so nothing else was dropped).  Read off
    the leaf's path and rank only, as a local shard's shape no longer
    tells divisibility."""
    sizes = _mesh_axis_sizes(mesh)
    spec = []
    for ax in param_spec(path, ndim, mesh):
        axes = pspecs._axes_of(ax)
        spec.append(ax if axes and all(a in sizes for a in axes)
                    and pspecs._axes_size(ax, sizes) > 1 else None)
    return pspecs.strip_trailing_none(spec)


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec names, in order."""
    return tuple(a for ax in spec for a in pspecs._axes_of(ax))


def tree_specs(tree, mesh):
    """``placed_spec`` of every tensor leaf of a placed tree (a tree of
    spec tuples of the same structure)."""
    return _walk(tree, lambda path, x: placed_spec(path, x.ndim, mesh)
                 if isinstance(x, torch.Tensor) else ())


def is_owner(spec, mesh) -> bool:
    """Whether this rank counts a leaf of ``spec`` in a sum over the whole
    mesh: every rank holds a distinct shard along the axes the spec names,
    and along the others (where the leaf is replicated) only index 0
    counts, so no value is counted twice."""
    named = set(spec_axes(spec))
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names
               if a not in named)


def mesh_sum(values: torch.Tensor, owners, mesh) -> torch.Tensor:
    """Per-leaf partial sums (an f32 vector, one entry a leaf) summed over
    the whole mesh, each leaf's over its owners only (``is_owner``): the
    same bits on every rank."""
    if mesh.size == 1:
        return values
    mask = torch.tensor([1.0 if o else 0.0 for o in owners],
                        dtype=torch.float32, device=values.device)
    return mesh.all_reduce(values * mask, mesh.axis_names)


# ---- activations / batch / optimizer ----------------------------------------


def _as_p(spec) -> tuple:
    """A spec in the form a JAX ``PartitionSpec`` holds its entries: an
    empty tuple of axes is None, a one-axis tuple the bare name."""
    return tuple(None if isinstance(ax, tuple) and not ax else
                 ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def batch_spec(mesh) -> tuple:
    """(B, S) token batches: the batch over the DP axes."""
    return _as_p((dp_axes(mesh),))


def _axes_size(mesh, axes) -> int:
    sizes = _mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return max(n, 1)


def _map_shaped(tree, fn):
    """``fn(leaf)`` over every leaf with a ``shape`` of dicts, lists,
    tuples and dataclasses (the port's batch and cache structures)."""
    if isinstance(tree, dict):
        return {k: _map_shaped(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_shaped(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_shaped(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init})
    if hasattr(tree, "shape"):
        return fn(tree)
    return tree


def batch_shardings(batch_struct, mesh):
    """Specs of a batch: the leading dim over the DP axes where they divide
    it, else replicated (the reference's ``batch_shardings``)."""
    dp = dp_axes(mesh)

    def one(x):
        return _as_p((dp,)) if x.shape and \
            x.shape[0] % _axes_size(mesh, dp) == 0 else ()

    return _map_shaped(batch_struct, one)


def opt_state_shardings(opt_state, params_shards, mesh):
    """AdamW state: master / m / v follow the parameter specs; the step
    counter replicated."""
    return dataclasses.replace(opt_state, step=(), master=params_shards,
                               m=params_shards, v=params_shards)


def cache_specs(cache_struct, mesh, batch: int):
    """Specs of serving state (the reference's ``cache_specs``, specs
    only): KV caches (B, S, KVH, D) batch on the DP axes when divisible,
    the longest other dim on "model" when divisible (SP for the sequence,
    head-parallel for SSM states); stacked (L, B, ...) caches keep the
    layer axis whole."""
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    dp_ok = batch % _axes_size(mesh, dp) == 0

    def one(x):
        shape = tuple(x.shape)
        bspec = dp if (dp_ok and len(shape) and shape[0] in (batch,)) \
            else None
        bdim = 0
        if len(shape) >= 2 and shape[0] != batch and shape[1] == batch:
            bdim = 1
        spec = [None] * len(shape)
        if bspec is not None and len(shape) > bdim and shape[bdim] == batch:
            spec[bdim] = dp
        if tp is not None and len(shape) > bdim + 1:
            rest = [(d, n) for d, n in enumerate(shape) if d > bdim]
            d_best, s_best = max(rest, key=lambda t: t[1])
            if s_best % _axes_size(mesh, (tp,)) == 0 and s_best > 1:
                spec[d_best] = tp
        return _as_p(spec)

    return _map_shaped(cache_struct, one)


# ---- which DP axes the backward sums over -----------------------------------
#
# Under GSPMD the reference's gradient is the global batch's: every DP axis,
# "pod" included, is summed in the backward.  A step that compresses the
# inter-pod all-reduce instead leaves each pod the mean of its own tokens
# (``compression.pod_mean_grads`` averages them after): inside
# ``per_pod_gradients()`` the backward sums over "data" only.

_PER_POD: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_per_pod_grads", default=False)


@contextlib.contextmanager
def per_pod_gradients(active: bool = True):
    tok = _PER_POD.set(bool(active))
    try:
        yield
    finally:
        _PER_POD.reset(tok)


def grad_sum_axes(mesh) -> Tuple[str, ...]:
    """The DP axes (of size > 1) the backward sums the gradients over:
    ("pod", "data"), or ("data",) inside ``per_pod_gradients``."""
    axes = ("data",) if _PER_POD.get() else ("pod", "data")
    return tuple(a for a in axes if mesh.axis_size(a) > 1)


# ---- activation layout (the reference's GSPMD constraints) ------------------

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)
_SP_TODO = ("activation mode 'sp' (the sequence-parallel residual stream: "
            "an all-gather before and a reduce-scatter after every TP "
            "block in models/layers.py) is not yet ported; the port runs "
            "mode 'replicated'")


@contextlib.contextmanager
def activation_sharding_scope(mesh, mode: str = "sp"):
    """The reference's scope of activation constraints.  "replicated" is
    the layout the port's Megatron decomposition computes, so the scope
    only records it; "sp" raises ``NotImplementedError``."""
    if mode not in ("replicated", "sp"):
        raise ValueError(mode)
    if mode == "sp":
        raise NotImplementedError(_SP_TODO)
    tok = _ACT_CTX.set((mesh, mode))
    try:
        yield
    finally:
        _ACT_CTX.reset(tok)


def _constrain_spec(kind: str, shape, mesh, mode: str) -> tuple:
    """The reference's activation spec of ``kind`` ("res", "hidden",
    "heads", "logits", "tokens", "experts", "groups", "qblocks")."""
    dp, tp = dp_axes(mesh), tp_axis(mesh)
    nd = len(shape)
    if kind == "res":
        seq = tp if (mode == "sp" and nd >= 3) else None
        spec = (dp, seq) + (None,) * (nd - 2)
    elif kind == "hidden":
        spec = (dp,) + (None,) * (nd - 2) + (tp,)
    elif kind == "heads":
        spec = (dp,) + (None,) * (nd - 3) + (tp, None)
    elif kind == "logits":
        spec = (dp,) + (None,) * (nd - 2) + (tp,)
    elif kind == "tokens":
        spec = (dp,) + (None,) * (nd - 1)
    elif kind == "experts":
        spec = (None, dp) + (None,) * (nd - 2)
    elif kind == "groups":
        spec = (dp,) + (None,) * (nd - 1)
    elif kind == "qblocks":
        tp_size = _axes_size(mesh, (tp,)) if tp else 1
        if nd == 6 and tp and (shape[3] * shape[4]) % tp_size == 0:
            if shape[3] % tp_size == 0:
                spec = (dp, None, None, tp, None, None)
            elif shape[4] % tp_size == 0:
                spec = (dp, None, None, None, tp, None)
            else:
                spec = (dp, tp, None, None, None, None)
        else:
            spec = (dp, tp) + (None,) * (nd - 2)
    else:
        raise ValueError(f"unknown constraint kind {kind!r}")
    return _as_p(_divisible(spec, shape, mesh))


def constrain(x, kind: str):
    """The identity: under the "replicated" scope the Megatron
    decomposition already computes the layout ``_constrain_spec`` names
    (the kind is still checked)."""
    ctx = _ACT_CTX.get()
    if ctx is None or not hasattr(x, "shape") or x.ndim < 2:
        return x
    _constrain_spec(kind, x.shape, ctx[0], ctx[1])
    return x


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


def place_train_state(state, mesh):
    """This rank's share of a full ``train.TrainState``: its shard of every
    parameter leaf and of AdamW's master weights and moments (each the
    parameter's spec, ``opt_state_shardings``), ``step`` and the threshold
    state replicated.  On a 1-rank mesh the state itself.  Where a planned
    split does not divide, ``ValueError`` names the leaf."""
    if mesh.size == 1:
        return state
    place = place_train_params
    opt = dataclasses.replace(state.opt, master=place(state.opt.master, mesh),
                              m=place(state.opt.m, mesh),
                              v=place(state.opt.v, mesh))
    return dataclasses.replace(state, params=place(state.params, mesh),
                               opt=opt)


def place_train_params(params, mesh):
    """This rank's shard of every leaf of a full parameter tree (the
    training placement of ``place_train_state``); ``ValueError`` names a
    leaf whose planned split does not divide."""
    if mesh.size == 1:
        return params

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = _divisible(param_spec(path, leaf.ndim, mesh), leaf.shape,
                          mesh, path=path, strict=True)
        return local_shard(leaf, spec, mesh)

    return _walk(params, one)


def map_paths(tree, fn, path: str = ""):
    """``fn(path, leaf)`` over dicts, lists/tuples and dataclasses (a
    ``TrainState`` and its ``AdamWState``: field names in the path), as
    ``_walk``; a ``PackedQuantizedTensor`` is one leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) \
            and not isinstance(tree, PackedQuantizedTensor):
        return dataclasses.replace(tree, **{
            f.name: map_paths(getattr(tree, f.name), fn,
                              f"{path}/{f.name}" if path else f.name)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_paths(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The logical tensor of this rank's shard ``x`` placed under
    ``spec``: all-gathered along every split dim (a dim split over a tuple
    of axes gathers its inner axis first)."""
    for d, ax in enumerate(spec):
        for a in reversed(pspecs._axes_of(ax)):
            x = mesh.all_gather(x, a, dim=d)
    return x


def gather_tree(tree, mesh, keep: bool = True):
    """Every tensor leaf of a placed tree gathered to its logical tensor
    (``gather_leaf`` by ``placed_spec``); each rank takes part in every
    gather.  ``keep=False``: the gathered tensors are dropped (a rank that
    only serves the collectives), the leaves returned as ``None``."""
    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        full = gather_leaf(x, placed_spec(path, x.ndim, mesh), mesh)
        return full if keep else None
    return map_paths(tree, one)


def shard_offsets(spec, local_shape, mesh) -> Tuple[Tuple[int, ...],
                                                     Tuple[int, ...]]:
    """(full shape, this rank's offset per dim) of a local shard placed
    under ``spec``."""
    full, off = [], []
    for d, n in enumerate(local_shape):
        ax = spec[d] if d < len(spec) else None
        k, idx = _shard_index(ax, mesh) if ax is not None else (1, 0)
        full.append(n * k)
        off.append(n * idx)
    return tuple(full), tuple(off)


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
