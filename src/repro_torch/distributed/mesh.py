"""The process mesh over ``torch.distributed``: one process per rank (SPMD).

Counterpart of ``jax.sharding.Mesh``, ``jax.make_mesh`` and
``repro.launch.mesh``.  The reference drives every device of its mesh from
one controller; here every rank is a process of its own that runs the same
code on its own shard, and the mesh gives it its coordinates and one
process group per axis.  Axes have any names, in row-major order: serving
uses ("data", "model"), training ("pod", "data", "model") and the pipeline
("pipe", "data").  rank = sum of index * (product of the later axes'
sizes), as ``np.reshape`` lays devices out in the reference.

The backend is explicit: ``nccl`` by default where the ranks run on CUDA
(each rank owning a card), ``gloo`` on the CPU; ranks that share ONE card
pass ``backend="gloo"``, whose collectives take CUDA tensors by staging them
through the host (NCCL refuses two ranks on one device with its own error,
which is left to surface).  ``torch.distributed.device_mesh`` is not used:
it makes NCCL groups for ``"cuda"``.

Every collective of the port goes through ``Mesh``: ``all_reduce`` (sum or
max), ``all_gather``, ``reduce_scatter`` and the point-to-point ``send`` /
``recv`` (the pipeline's transfers).  Each skips an axis of size 1 and counts its
calls, the bytes this rank contributes and their host seconds, in total and
per operation (``Mesh.stats``).  Where the backend lacks an operation for
the tensor's device (gloo has no reduce-scatter of CUDA tensors, and no
point-to-point transfer of them) the explicit equivalent runs -- an
all-to-all of the shards through host memory, summed in rank order; a
transfer staged through host memory -- and is counted as the operation it
implements.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.distributed import specs as pspecs

AXES = ("data", "model")                    # the serving mesh's axes


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
    """This rank's view of a mesh: ``axis_names``, ``shape``, ``size``,
    ``rank`` and its ``coords`` per axis, one process ``groups`` entry per
    axis of size > 1 (with ``group_ranks``, the global ranks of this rank's
    group on it, in axis order), the ``device`` the rank computes on and the
    collectives' ``backend``.  A 1-rank mesh has no group and needs no
    initialised process group: its collectives are the identity."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: torch.device, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None,
                 group_ranks: Optional[Dict[str, List[int]]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} do not pair up")
        self.rank = int(rank)
        self.device = device
        self.backend = backend
        self.groups = dict(groups or {})
        self.group_ranks = dict(group_ranks or {})
        coords, r = {}, self.rank
        for name, n in reversed(tuple(zip(self.axis_names, self.shape))):
            coords[name] = r % n
            r //= n
        self.coords = {a: coords[a] for a in self.axis_names}
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "ops": {}}
        self.pending = []            # (work, buffer) of sends in flight

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """Size of axis ``name`` (1 where the mesh has no such axis)."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's index along ``name`` (0 where absent)."""
        return self.coords.get(name, 0)

    def axes_size(self, axes: Sequence[str]) -> int:
        """Product of the sizes of ``axes`` (absent axes count 1)."""
        return math.prod(self.axis_size(a) for a in axes)

    def axes_index(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes`` taken together, the first
        major (the order a spec's tuple of axes splits a dim in)."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.axis_index(a)
        return idx

    # ---- collectives --------------------------------------------------------

    def _timed(self, op: str, fn, nbytes: int):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["bytes"] += int(nbytes)
        self.stats["seconds"] += dt
        per = self.stats["ops"].setdefault(
            op, {"calls": 0, "bytes": 0, "seconds": 0.0})
        per["calls"] += 1
        per["bytes"] += int(nbytes)
        per["seconds"] += dt
        return out

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "ops": {}}

    def all_reduce(self, t: torch.Tensor, axis, op: str = "sum",
                   label: Optional[str] = None) -> torch.Tensor:
        """``t`` reduced over ``axis`` (a name, or a sequence of names
        reduced one after the other) IN PLACE, op "sum" or "max"; every
        rank of the axes holds the same bits after it.  ``label`` names
        the purpose in ``stats`` (default "all_reduce_<op>"; the moe
        layer's batched reductions count as "moe_amax" and
        "moe_partials")."""
        for a in ((axis,) if isinstance(axis, str) else tuple(axis)):
            if self.axis_size(a) == 1:
                continue
            rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            self._timed(label or f"all_reduce_{op}",
                        lambda: dist.all_reduce(t, rop, group=self.groups[a]),
                        t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   op: str = "all_gather") -> torch.Tensor:
        """The axis' shards of ``t`` concatenated along ``dim`` in rank
        order (the reference's ``all_gather(tiled=True)``); ``op`` names
        the purpose in ``stats`` (the FSDP weight gathers count as
        "fsdp_gather")."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._timed(op, lambda: dist.all_gather(parts, t,
                                                group=self.groups[axis]),
                    t.numel() * t.element_size())
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0
                       ) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, cut along ``dim`` into the
        axis' shards: this rank's shard (a tensor of its own).  ``t``'s
        ``dim`` must divide by the axis size.  On gloo it is an all-to-all
        of the shards staged through host memory (each rank sends the
        others their shards: half an all-reduce's traffic at two ranks),
        summed in rank order; counted as "reduce_scatter" with the bytes of
        the whole tensor."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)}"
                             f" does not split over {axis}={n}")
        size = t.shape[dim] // n
        idx = self.axis_index(axis)
        if self.backend == "gloo":
            src = t.movedim(dim, 0).to("cpu", copy=True).contiguous()
            got = torch.empty_like(src)
            self._timed("reduce_scatter", lambda: dist.all_to_all_single(
                got, src, group=self.groups[axis]),
                src.numel() * src.element_size())
            del src
            parts = got.split(size)
            out = parts[0].clone()
            for part in parts[1:]:
                out += part
            return out.movedim(0, dim).to(t.device).contiguous()
        parts = [p.contiguous() for p in t.split(size, dim=dim)]
        out = torch.empty_like(parts[idx])
        self._timed("reduce_scatter", lambda: dist.reduce_scatter(
            out, parts, op=dist.ReduceOp.SUM, group=self.groups[axis]),
            t.numel() * t.element_size())
        return out

    def _peer(self, axis: str, step: int) -> int:
        """Global rank of the rank ``step`` places along ``axis`` (mod its
        size)."""
        ranks = self.group_ranks[axis]
        return ranks[(self.axis_index(axis) + step) % len(ranks)]

    def send(self, t: torch.Tensor, axis: str, step: int = 1,
             tag: int = 0):
        """Send ``t`` to the rank ``step`` places along ``axis``
        (non-blocking: returns the pending work; the caller keeps ``t``
        alive and waits on it).  CUDA tensors over gloo are staged through
        host memory."""
        src = t.contiguous()
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()
        peer = self._peer(axis, step)
        work = self._timed("send", lambda: dist.isend(
            src, dst=peer, group=self.groups[axis], tag=tag),
            src.numel() * src.element_size())
        return work, src

    def wait_sends(self) -> None:
        """Complete the sends kept in ``pending``."""
        while self.pending:
            work, _ = self.pending.pop(0)
            work.wait()

    def recv(self, like: torch.Tensor, axis: str, step: int = -1,
             tag: int = 0) -> torch.Tensor:
        """Receive a tensor of ``like``'s shape, dtype and device from the
        rank ``step`` places along ``axis`` (blocking)."""
        stage = self.backend == "gloo" and like.is_cuda
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if stage else like.device)
        peer = self._peer(axis, step)
        self._timed("recv", lambda: dist.recv(
            buf, src=peer, group=self.groups[axis], tag=tag),
            buf.numel() * buf.element_size())
        return buf.to(like.device) if stage else buf


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


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh ``shape`` over ``axis_names`` (row-major) on the
    initialised world, the counterpart of ``jax.make_mesh``; each rank of
    the world calls it.  A shape of size 1 is the 1-rank mesh (no process
    group needed); any other must have exactly the world's number of
    ranks, else ``ValueError``.  ``device``: the rank's device (default
    cuda; see ``resolve_device``); ``backend``: the groups' (default
    "nccl" on CUDA, "gloo" on the CPU)."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axis_names)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not pair up")
    need = math.prod(shape)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if need == 1:
        return Mesh(shape, axes, device=dev)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks, the world "
            f"has {have}; run one process per rank (distributed.mesh.spawn, "
            f"launch.serve --mesh, or torchrun)")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank = dist.get_rank()
    groups, group_ranks = {}, {}
    for axis, n in zip(axes, shape):
        if n == 1:
            continue
        for ranks in _axis_groups(shape, axes, axis):
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[axis], group_ranks[axis] = g, ranks
    return Mesh(shape, axes, device=dev, rank=rank, groups=groups,
                backend=backend, group_ranks=group_ranks)


def make_serve_mesh(spec: Optional[str] = None, *, device=None,
                    backend: Optional[str] = None) -> Mesh:
    """The serving mesh of a ``--mesh`` spec ("tp=2", "dp=2,tp=2", ...),
    after ``repro.distributed.sharding.make_serve_mesh``: ``make_mesh``
    over ("data", "model").  ``None`` / "" / a spec of size 1 is the
    1-rank mesh; a larger spec needs an initialised world of exactly that
    many ranks (each running this call), else ``ValueError``."""
    sizes = pspecs.parse_mesh_spec(spec)
    axes = tuple(a for a in AXES if a in sizes)
    shape = tuple(sizes[a] for a in axes)
    try:
        return make_mesh(shape, axes, device=device, backend=backend)
    except ValueError as e:
        raise ValueError(f"mesh spec {spec!r}: {e}") from None


def make_pipeline_mesh(n_stages: int, world: Optional[int] = None, *,
                       device=None, backend: Optional[str] = None) -> Mesh:
    """A ("pipe", "data") mesh of ``n_stages`` stages over ``world`` ranks
    (default: the initialised world's), after the reference's
    ``make_pipeline_mesh`` (pipeline.py:110-117)."""
    n = world if world is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if n % n_stages:
        raise ValueError(f"{n} ranks not divisible into {n_stages} stages")
    return make_mesh((n_stages, n // n_stages), ("pipe", "data"),
                     device=device, backend=backend)


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
