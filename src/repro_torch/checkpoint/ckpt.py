"""Atomic checkpoints in the reference's on-disk format (PyTorch).

Counterpart of ``repro.checkpoint.ckpt``, with the same layout:

    <dir>/step_<N:08d>/
        meta.json        step, leaf count, each leaf's dtype name
        shard_0.npz      the leaves, ``leaf_<i>``
    <dir>/LATEST         the name of the newest step directory

A save is written to ``step_<N>.tmp`` and ``os.replace``d into place, and
``LATEST`` is updated last, so a crash mid-save never corrupts the restore
point; a step that exists already is not written again; ``keep`` bounds the
number of steps kept.

Leaves are numbered in the reference's pytree order, so either package
restores what the other wrote:

  * dicts by sorted key, dataclasses (``TrainState``, ``AdamWState``,
    ``ThresholdState``) in field order, which is the reference's
    NamedTuple order;
  * a list of per-layer dicts of one structure (the transformers'
    ``layers``, zamba2's ``mamba``) is one stacked ``(n_layers, ...)`` leaf
    per name, as the reference holds it; a list whose dicts differ
    (xLSTM's mLSTM and sLSTM blocks, a Python list in the reference too)
    is numbered per layer, ``['layers'][i]...``;
  * a ``PackedQuantizedTensor`` is three leaves, ``packed``, ``scales``,
    ``tscale`` (the reference's data fields); stacked layers give
    ``tscale`` the shape ``(n_layers,)``;
  * a Python int (the port's step counters) is a 0-d int32 array, as JAX
    writes them.

``bfloat16`` and float8 leaves are stored as a same-width unsigned view,
with the dtype name in ``meta.json`` (``_VIEW_DTYPES``), and read back by
viewing the raw bits.  ``meta["treedef"]``, which the reference writes and
never reads, holds the leaf names here.

On a multi-rank training mesh (``mesh=``) the tree holds this rank's shards
(``distributed/sharding.place_train_state``): ``save`` gathers each leaf to
its logical array, one leaf at a time, rank 0 writes the one
``shard_0.npz`` (the format is the same) and every rank waits for it;
``restore`` reads the logical arrays and keeps this rank's slice -- the
reference's elastic restore
(``repro/checkpoint/ckpt.py:105-139``), so a checkpoint saved on any mesh
restores on any other, on one rank, or in the JAX reader.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import zipfile
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from repro_torch.core.quantize import PackedQuantizedTensor

# dtypes np.savez cannot hold, stored as the unsigned view of the same width
# with their name in meta.json (the reference's _VIEW_DTYPES): name ->
# (torch dtype, torch view of that width, stored numpy dtype, the numpy
# dtype torch reads it through)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_VIEW_OF = {v[0]: (name,) + v[1:3] for name, v in _VIEW_DTYPES.items()}

# one leaf of the reference's order: (name, parts, stacked); parts are the
# per-layer tensors of a stacked leaf, else the one tensor or int
Leaf = Tuple[str, list, bool]


def reference_leaves(tree, name: str = "") -> List[Leaf]:
    """A port tree's leaves in the reference's order, each named as
    ``jax.tree_util.keystr`` names the reference's leaf."""
    if isinstance(tree, PackedQuantizedTensor):
        return [(f"{name}.{f}", [getattr(tree, f)], False)
                for f in ("packed", "scales", "tscale")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [lf for f in dataclasses.fields(tree) for lf in
                reference_leaves(getattr(tree, f.name), f"{name}.{f.name}")]
    if isinstance(tree, dict):
        return [lf for k in sorted(tree)
                for lf in reference_leaves(tree[k], f"{name}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        per = _stacked_layers(tree, name)
        if per is not None:
            return [(per[0][j][0], [p[j][1][0] for p in per], True)
                    for j in range(len(per[0]))]
        return [lf for i, t in enumerate(tree)
                for lf in reference_leaves(t, f"{name}[{i}]")]
    return [(name, [tree], False)]


def _layout(leaves: List[Leaf]) -> list:
    return [(n, tuple(p[0].shape) if isinstance(p[0], torch.Tensor)
             else None) for n, p, _ in leaves]


def _stacked_layers(tree, name: str = "") -> Optional[List[List[Leaf]]]:
    """Each layer's leaves where ``tree`` is a list of per-layer dicts of
    one structure (the same leaf names and shapes): the layers the
    reference stacks.  None for any other sequence."""
    if not tree or not all(isinstance(t, dict) for t in tree):
        return None
    per = [reference_leaves(t, name) for t in tree]
    first = _layout(per[0])
    if any(_layout(p) != first for p in per[1:]):
        return None
    return per


def _rebuild(like, nxt: Callable[[], Any]):
    """``like``'s structure with each leaf taken from ``nxt()`` in the
    order of ``reference_leaves``; a stacked leaf's ``nxt()`` is its list
    of per-layer parts."""
    if isinstance(like, PackedQuantizedTensor):
        return dataclasses.replace(like, packed=nxt(), scales=nxt(),
                                   tscale=nxt())
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), nxt)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        got = {k: _rebuild(like[k], nxt) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (list, tuple)):
        if _stacked_layers(like) is not None:
            stacked = [nxt() for _ in reference_leaves(like[0])]
            return type(like)(
                _rebuild(lp, iter([s[i] for s in stacked]).__next__)
                for i, lp in enumerate(like))
        return type(like)(_rebuild(t, nxt) for t in like)
    return nxt()


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name) of a tensor or an int; one
    synchronized copy to the host."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x, np.int32), "int32"
    t = x.detach()
    if t.dtype in _VIEW_OF:
        name, tview, nview = _VIEW_OF[t.dtype]
        return t.view(tview).cpu().numpy().view(nview), name
    a = t.cpu().numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """A loaded array (C-contiguous, as ``np.load`` and its slices along
    the first axis give it) as a tensor on ``device``, without a copy on
    the host."""
    if dtype_name in _VIEW_DTYPES:
        tdtype, _, stored, readable = _VIEW_DTYPES[dtype_name]
        t = torch.from_numpy(a.view(stored).view(readable)).view(tdtype)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _multi(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, mesh=None) -> str:
    """Write ``tree`` as step ``step`` (atomic, idempotent) and keep the
    newest ``keep`` steps.  Returns the step's directory.  Leaves go to the
    host and into ``shard_0.npz`` one at a time.  ``mesh``: the tree is
    this rank's shards; every rank calls ``save`` and takes part in
    gathering each leaf, and rank 0 copies the gathered leaf to the host
    and writes it before the next gather, so a card holds one logical leaf
    (a stacked leaf's layer) at most beyond its own shards."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.isdir(final):             # idempotent re-save of a step
        return final
    multi = _multi(mesh)
    writer = not multi or mesh.rank == 0
    gather = _leaf_gather(tree, mesh) if multi else None
    leaves = reference_leaves(tree)
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    meta_leaves = []
    with (_NpzWriter(os.path.join(tmp, "shard_0.npz")) if writer
          else contextlib.nullcontext()) as npz:
        for i, (_, parts, stacked) in enumerate(leaves):
            host = []
            for p in parts:
                if gather is not None and isinstance(p, torch.Tensor):
                    p = gather(p)        # a collective: every rank
                if writer:
                    host.append(_to_numpy(p))
                del p
            if writer:
                npz.write(f"leaf_{i}", np.stack([a for a, _ in host])
                          if stacked else host[0][0])
                meta_leaves.append({"dtype": host[0][1]})
    if writer:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(leaves),
                       "leaves": meta_leaves,
                       "treedef": "repro_torch: "
                       + " ".join(name for name, _, _ in leaves)}, f)
        os.replace(tmp, final)
        latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
        _gc(ckpt_dir, keep)
    if multi:
        torch.distributed.barrier()      # the step exists for every rank
    return final


class _NpzWriter:
    """``np.savez``'s archive (uncompressed zip, one ``<name>.npy`` member
    a leaf) written one array at a time."""

    def __init__(self, path: str):
        self.zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                  allowZip64=True)

    def write(self, name: str, a: np.ndarray) -> None:
        with self.zf.open(name + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(a),
                                      allow_pickle=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.zf.close()


def _leaf_gather(tree, mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The logical tensor of one of ``tree``'s placed shards
    (``sharding.gather_leaf`` under its ``placed_spec``)."""
    from repro_torch.distributed import sharding
    specs = {}

    def one(path, x):
        if isinstance(x, torch.Tensor):
            specs[id(x)] = sharding.placed_spec(path, x.ndim, mesh)
        return x

    sharding.map_paths(tree, one)
    return lambda x: sharding.gather_leaf(x, specs[id(x)], mesh)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _shape(part, stacked_n: Optional[int]) -> tuple:
    s = tuple(part.shape) if isinstance(part, torch.Tensor) else ()
    return s if stacked_n is None else (stacked_n,) + s


def _logical_like(like, mesh):
    """``like`` with each tensor replaced by a meta tensor of its logical
    shape, and {id(meta tensor): (this rank's slices, device)}."""
    from repro_torch.distributed import sharding
    place = {}

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = sharding.placed_spec(path, x.ndim, mesh)
        full, off = sharding.shard_offsets(spec, x.shape, mesh)
        meta = torch.empty(full, dtype=x.dtype, device="meta")
        place[id(meta)] = (tuple(slice(o, o + n) for o, n in
                                 zip(off, x.shape)), x.device)
        return meta

    return sharding.map_paths(like, one), place


def restore(ckpt_dir: str, step: int, like, *, mesh=None):
    """Restore into the structure of ``like`` (a port tree), each tensor on
    the device of ``like``'s tensor in its place; ints come back as ints.
    A leaf count or shape that does not match raises ``ValueError``.
    ``mesh``: ``like`` holds this rank's shards; each comes back as this
    rank's slice of the saved logical array."""
    place = None
    if _multi(mesh):
        like, place = _logical_like(like, mesh)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = reference_leaves(like)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, target structure "
            f"has {len(leaves)} — architecture mismatch")
    out = []
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        for i, (_, parts, stacked) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            want = _shape(parts[0], len(parts) if stacked else None)
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i}: shape {arr.shape} != {want}")
            dt = meta["leaves"][i]["dtype"]
            got = []
            for j, ref in enumerate(parts):
                a = arr[j, ...] if stacked else arr     # 0-d stays an array
                if not isinstance(ref, torch.Tensor):
                    got.append(int(a))
                elif place is not None:
                    sl, dev = place[id(ref)]
                    got.append(_from_numpy(a[sl].copy() if sl else a, dt,
                                           dev))
                else:
                    got.append(_from_numpy(a, dt, ref.device))
            out.append(got if stacked else got[0])
    return _rebuild(like, iter(out).__next__)


def restore_latest(ckpt_dir: str, like, *, mesh=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like, mesh=mesh)
