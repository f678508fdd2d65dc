"""Pure partition-spec logic for packed serving tensors (the port's own
copy of ``repro.distributed.specs``, which it may not import).

This is the spec *derivation* layer under ``distributed/sharding.py``:
everything here works on plain tuples -- mesh-axis names (or ``None``) per
tensor dimension -- the same tuples a JAX ``PartitionSpec`` holds, so the
port's specs compare with the reference's leaf for leaf.

The core problem it solves: a ``PackedQuantizedTensor`` stores one logical
weight as THREE arrays whose shapes disagree with the logical shape —

  * ``packed``  : uint8 nibble codes, logical shape with the LAST axis
                  halved (two E2M1 values per byte);
  * ``scales``  : f8 block scales, logical shape with the BLOCKING axis
                  divided by ``block``;
  * ``tscale``  : f32 per-batch-slice tensor scales (leading dims only).

A partition spec written against the logical shape must therefore be
re-validated per leaf (the halved/blocked dims change divisibility), and —
crucially — the scale leaf must shard **congruently** with the code leaf:
a mesh axis shards logical dim ``d`` of the scales iff it shards logical
dim ``d`` of the codes.  ``packed_leaf_specs`` derives the scale spec FROM
the code spec, so the two can never diverge; any dim that cannot shard on
every leaf it touches is replicated on all of them, and the drop is
reported as a diagnostic instead of happening silently.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

Axis = Optional[object]          # None | str | tuple[str, ...]
SpecTuple = Tuple[Axis, ...]

# CLI mesh-spec axes -> mesh axis names used by the sharding rule tables.
MESH_AXIS_FOR = {"tp": "model", "dp": "data", "fsdp": "data"}


def parse_mesh_spec(spec: Optional[str]) -> Dict[str, int]:
    """Parse a ``--mesh`` CLI spec like ``"tp=2"`` or ``"dp=2,tp=4"``.

    Returns ``{mesh_axis_name: size}`` (e.g. ``{"model": 2}``); ``None``
    or ``""`` mean the degenerate single-device mesh ``{"model": 1}``.
    """
    out: Dict[str, int] = {}
    if spec:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            m = re.fullmatch(r"(\w+)\s*=\s*(\d+)", part)
            if not m or m.group(1) not in MESH_AXIS_FOR:
                raise ValueError(
                    f"bad mesh spec {spec!r}: expected comma-separated "
                    f"{sorted(MESH_AXIS_FOR)} entries like 'tp=2'")
            name = MESH_AXIS_FOR[m.group(1)]
            size = int(m.group(2))
            if size < 1:
                raise ValueError(f"mesh axis {m.group(1)}={size} < 1")
            out[name] = max(out.get(name, 1), size)
    out.setdefault("model", 1)
    return out


def _axes_of(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


def _axes_size(ax: Axis, axis_sizes: Dict[str, int]) -> Optional[int]:
    """Product of mesh-axis sizes, or None if any axis is absent."""
    total = 1
    for a in _axes_of(ax):
        if a not in axis_sizes:
            return None
        total *= axis_sizes[a]
    return total


def divisible_axes(spec: Sequence[Axis], shape: Sequence[int],
                   axis_sizes: Dict[str, int], path: str = "",
                   drops: Optional[List[str]] = None) -> SpecTuple:
    """Drop spec entries that do not evenly divide ``shape``.

    Pure-tuple version of ``sharding._divisible``: each dropped entry is
    recorded in ``drops`` as a human-readable diagnostic naming the leaf
    ``path`` — silent replication under nibble packing is a correctness-
    adjacent perf bug (a "sharded" deploy quietly holding full replicas).
    """
    fixed: List[Axis] = []
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, ax in enumerate(padded):
        if ax is None or (isinstance(ax, tuple) and not ax):
            fixed.append(None)       # empty dp-axes tuple == replicated
            continue
        total = _axes_size(ax, axis_sizes)
        if total is None or total == 1:
            # absent axis: benign; size-1 axis: sharding over it IS
            # replication — normalize to None so specs match what GSPMD
            # reports back (jit-output shardings on a 1-device mesh
            # normalize to P(), and spec equality keys the compile cache)
            fixed.append(None)
            continue
        if shape[d] % total == 0:
            fixed.append(ax)
        else:
            fixed.append(None)
            if drops is not None:
                drops.append(
                    f"{path or '<leaf>'}: dim {d} (size {shape[d]}) not "
                    f"divisible by mesh axis {ax!r} (size {total}) — "
                    f"replicating that dim")
    return strip_trailing_none(fixed)


def strip_trailing_none(spec: Sequence[Axis]) -> SpecTuple:
    """Canonical spec form: ``(None, None)`` == ``()`` to GSPMD, but NOT
    to the jit compile cache's sharding equality — always strip."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def packed_leaf_specs(base_spec: Sequence[Axis], logical_shape: Sequence[int],
                      axis: int, block: int, axis_sizes: Dict[str, int],
                      path: str = "",
                      drops: Optional[List[str]] = None
                      ) -> Dict[str, SpecTuple]:
    """Derive congruent leaf specs for one ``PackedQuantizedTensor``.

    ``base_spec`` is the logical-shape partition spec (the same rule table
    that shards the unpacked bf16 weight).  Returns specs for the three
    leaves, with the invariant that a mesh axis appears on logical dim
    ``d`` of EVERY leaf that carries dim ``d``, or on none of them:

      * codes shard dim d only if it also divides the nibble-packed size
        (d == last: ``logical[-1] // 2``);
      * scales shard dim d only if it also divides the blocked size
        (d == axis: ``logical[axis] // block``);
      * tscale carries only the leading batch dims (``tscale_ndim``).

    The scale spec is DERIVED from the code spec — never computed from a
    separate rule — so the two cannot diverge.
    """
    nd = len(logical_shape)
    axis = axis % nd
    base = tuple(base_spec) + (None,) * (nd - len(base_spec))

    packed_shape = tuple(logical_shape[:-1]) + (logical_shape[-1] // 2,)
    scales_shape = tuple(s // block if d == axis else s
                         for d, s in enumerate(logical_shape))

    code_spec: List[Axis] = []
    for d, ax in enumerate(base):
        if ax is None:
            code_spec.append(None)
            continue
        total = _axes_size(ax, axis_sizes)
        if total is None or total == 1:  # see divisible_axes: size-1 ==
            code_spec.append(None)       # replicated, normalized to None
            continue
        # keep the axis only if EVERY leaf carrying this logical dim
        # shards evenly (congruence by construction)
        ok = packed_shape[d] % total == 0 and scales_shape[d] % total == 0 \
            and logical_shape[d] % total == 0
        if ok:
            code_spec.append(ax)
        else:
            code_spec.append(None)
            if drops is not None:
                drops.append(
                    f"{path or '<leaf>'}: logical dim {d} "
                    f"(size {logical_shape[d]}, packed {packed_shape[d]}, "
                    f"scales {scales_shape[d]}) not divisible by mesh axis "
                    f"{ax!r} (size {total}) on every packed leaf — "
                    f"replicating that dim")

    scale_spec = strip_trailing_none(code_spec)   # derived: congruent
    tscale_ndim = nd - 2                 # pack_quantize(batch_dims=ndim-2)
    tscale_spec = strip_trailing_none(code_spec[:tscale_ndim])
    return {"packed": strip_trailing_none(code_spec), "scales": scale_spec,
            "tscale": tscale_spec}


def congruent(code_spec: Sequence[Axis], scale_spec: Sequence[Axis]) -> bool:
    """True iff the two specs name the same mesh axes per logical dim
    (trailing Nones ignored) — the invariant ``packed_leaf_specs`` keeps."""
    n = max(len(code_spec), len(scale_spec))
    a = tuple(code_spec) + (None,) * (n - len(code_spec))
    b = tuple(scale_spec) + (None,) * (n - len(scale_spec))
    return all(_axes_of(x) == _axes_of(y) for x, y in zip(a, b))


# Wire-format accounting for packed-weight collectives: an FSDP-style
# all-gather of a PackedQuantizedTensor moves uint8 nibble codes (4 bits
# per logical param) plus f8 block scales (8 bits per ``block`` params) —
# ~4.5 bits/param for NVFP4 (block 16) vs 16 for a bf16 gather.
def packed_wire_bits_per_param(block: int = 16, code_bits: int = 4,
                               scale_bits: int = 8) -> float:
    return code_bits + scale_bits / block


def packed_gather_ratio(block: int = 16, src_bits: int = 16) -> float:
    """bf16-gather bytes / packed-gather bytes (~3.56x for NVFP4)."""
    return src_bits / packed_wire_bits_per_param(block)
