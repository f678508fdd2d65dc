"""The serving mesh over ``torch.distributed``: one process per rank (SPMD).

Counterpart of ``jax.sharding.Mesh`` and ``repro.launch.mesh``.  The
reference drives every device of its mesh from one controller; here every
rank is a process of its own that runs the same engine code on its own
shard, and the mesh gives it its coordinates and one process group per
axis.  Ranks lie row-major over the axes ("data", then "model"): rank =
data_index * model_size + model_index, as ``np.reshape`` lays devices out
in the reference's ``make_serve_mesh``.

The backend is explicit: ``nccl`` by default where the ranks run on CUDA
(each rank owning a card), ``gloo`` on the CPU; ranks that share ONE card
pass ``backend="gloo"``, whose collectives take CUDA tensors by staging them
through the host (NCCL refuses two ranks on one device with its own error,
which is left to surface).  ``torch.distributed.device_mesh`` is not used:
it makes NCCL groups for ``"cuda"``.

Every collective of the port goes through ``Mesh.all_reduce`` /
``Mesh.all_gather``, which skip an axis of size 1 and count the calls, the
bytes this rank contributes and their host seconds (``Mesh.stats``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.distributed import specs as pspecs

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes only, no ranks or groups: what
    ``make_production_mesh`` / ``make_host_mesh`` give here, and the stand-in
    every spec function of ``distributed/sharding.py`` takes."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


class Mesh:
    """This rank's view of the serving mesh: ``axis_names``, ``shape``,
    ``size``, ``rank`` and its ``coords`` per axis, one process ``groups``
    entry per axis of size > 1, the ``device`` the rank computes on and the
    collectives' ``backend``.  A 1-rank mesh has no group and needs no
    initialised process group: its collectives are the identity."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: torch.device, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.rank = int(rank)
        self.device = device
        self.backend = backend
        self.groups = dict(groups or {})
        coords, r = {}, self.rank
        for name, n in reversed(tuple(zip(self.axis_names, self.shape))):
            coords[name] = r % n
            r //= n
        self.coords = {a: coords[a] for a in self.axis_names}
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """Size of axis ``name`` (1 where the mesh has no such axis)."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's index along ``name`` (0 where absent)."""
        return self.coords.get(name, 0)

    # ---- collectives --------------------------------------------------------

    def _timed(self, fn, nbytes: int):
        t0 = time.perf_counter()
        out = fn()
        self.stats["calls"] += 1
        self.stats["bytes"] += int(nbytes)
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` IN PLACE (op "sum" or "max"); every
        rank of the axis holds the same bits after it."""
        if self.axis_size(axis) == 1:
            return t
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._timed(lambda: dist.all_reduce(t, rop, group=self.groups[axis]),
                    t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The axis' shards of ``t`` concatenated along ``dim`` in rank
        order (the reference's ``all_gather(tiled=True)``)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._timed(lambda: dist.all_gather(parts, t,
                                            group=self.groups[axis]),
                    t.numel() * t.element_size())
        return torch.cat(parts, dim=dim)


def _axis_groups(shape, axis_names, axis: str):
    """Rank lists of the groups along ``axis``: ranks that differ only in
    their index on that axis, in a fixed order every rank agrees on."""
    k = axis_names.index(axis)
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    others = [range(n) if i != k else range(1)
              for i, n in enumerate(shape)]
    out = []
    for base in _product(others):
        r0 = sum(c * s for c, s in zip(base, strides))
        out.append([r0 + j * strides[k] for j in range(shape[k])])
    return out


def _product(ranges):
    if not ranges:
        yield ()
        return
    for i in ranges[0]:
        for rest in _product(ranges[1:]):
            yield (i,) + rest


def make_serve_mesh(spec: Optional[str] = None, *, device=None,
                    backend: Optional[str] = None) -> Mesh:
    """The serving mesh of a ``--mesh`` spec ("tp=2", "dp=2,tp=2", ...),
    after ``repro.distributed.sharding.make_serve_mesh``.  ``None`` / ""
    / a spec of size 1 is the 1-rank mesh: the identity placement, no
    process group needed.  A larger spec needs an initialised world of
    exactly that many ranks (each running this call), else ``ValueError``.
    ``device``: the rank's device (default cuda; see ``resolve_device``);
    ``backend``: the groups' (default "nccl" on CUDA, "gloo" on the CPU)."""
    sizes = pspecs.parse_mesh_spec(spec)
    axes = tuple(a for a in AXES if a in sizes)
    shape = tuple(sizes[a] for a in axes)
    need = math.prod(shape)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if need == 1:
        return Mesh(shape, axes, device=dev)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(
            f"mesh spec {spec!r} needs {need} ranks, the world has {have}; "
            f"run one process per rank (distributed.mesh.spawn, "
            f"launch.serve --mesh, or torchrun)")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank = dist.get_rank()
    groups = {}
    for axis, n in zip(axes, shape):
        if n == 1:
            continue
        for ranks in _axis_groups(shape, axes, axis):
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape, axes, device=dev, rank=rank, groups=groups,
                backend=backend)


def describe(mesh) -> str:
    return f"mesh{dict(zip(mesh.axis_names, mesh.shape))}"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh, shape and axes only: 16 x 16
    ("data", "model") per pod, an outer "pod" axis of 2 for multi-pod."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh() -> MeshShape:
    """Whatever this world has, as (n, 1) ("data", "model")."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return MeshShape((n, 1), ("data", "model"))


def _rank_main(rank: int, fn: Callable, world: int, backend: str, device,
               init_method: str, args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str, device,
          init_method: str, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``world`` processes, one rank each,
    started with the SPAWN method (a fork after CUDA initialisation breaks
    the child's CUDA), each inside an initialised process group
    (``init_method``: a ``file://`` or ``tcp://127.0.0.1:<port>``
    rendezvous).  A CPU rank runs torch on one thread.  Raises if a rank
    fails; ``fn`` must be importable (a module-level function)."""
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, str(device), init_method,
                          tuple(args)),
        nprocs=world, join=True, start_method="spawn")
