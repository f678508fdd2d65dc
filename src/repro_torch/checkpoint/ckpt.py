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
  * a list of per-layer dicts (the port's ``layers``) is one stacked
    ``(n_layers, ...)`` leaf per name, as the reference holds it;
  * a ``PackedQuantizedTensor`` is three leaves, ``packed``, ``scales``,
    ``tscale`` (the reference's data fields); stacked layers give
    ``tscale`` the shape ``(n_layers,)``;
  * a Python int (the port's step counters) is a 0-d int32 array, as JAX
    writes them.

``bfloat16`` and float8 leaves are stored as a same-width unsigned view,
with the dtype name in ``meta.json`` (``_VIEW_DTYPES``), and read back by
viewing the raw bits.  ``meta["treedef"]``, which the reference writes and
never reads, holds the leaf names here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

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
        if tree and all(isinstance(t, dict) for t in tree):
            per = [reference_leaves(t, name) for t in tree]   # the layers
            return [(per[0][j][0], [p[j][1][0] for p in per], True)
                    for j in range(len(per[0]))]
        return [lf for i, t in enumerate(tree)
                for lf in reference_leaves(t, f"{name}[{i}]")]
    return [(name, [tree], False)]


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
        if like and all(isinstance(t, dict) for t in like):
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


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` (atomic, idempotent) and keep the
    newest ``keep`` steps.  Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.isdir(final):             # idempotent re-save of a step
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = reference_leaves(tree)
    arrays, meta_leaves = {}, []
    for i, (_, parts, stacked) in enumerate(leaves):
        host = [_to_numpy(p) for p in parts]
        arrays[f"leaf_{i}"] = (np.stack([a for a, _ in host]) if stacked
                               else host[0][0])
        meta_leaves.append({"dtype": host[0][1]})
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    del arrays
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
    return final


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


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (a port tree), each tensor on
    the device of ``like``'s tensor in its place; ints come back as ints.
    A leaf count or shape that does not match raises ``ValueError``."""
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
                got.append(_from_numpy(a, dt, ref.device)
                           if isinstance(ref, torch.Tensor) else int(a))
            out.append(got if stacked else got[0])
    return _rebuild(like, iter(out).__next__)


def restore_latest(ckpt_dir: str, like):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like)
