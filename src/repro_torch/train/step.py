"""The FQT train step: loss, grads, the paper's section 4 monitor, AdamW.

Counterpart of ``repro.train.step``:

  1. loss and grads through ``registry.loss_fn`` -- every weight GEMM is
     ``fqt.fp4_matmul``, whose autograd Function runs the K1 kernel at the
     three GEMMs with SR seeds derived from the step counter
     (deterministic, replayable);
  2. the gradient-to-noise monitor: sigma_q from the SR quantization
     residual of the gradients themselves, EMA-tracked in
     ``ThresholdState``;
  3. AdamW with f32 master weights and warmup/cosine LR.

Declared divergence: the reference's sigma_q probe draws its SR bits with
threefry keys (``jax.random.fold_in(PRNGKey(step), leaf)``), which cannot be
reproduced without jax.  The port draws them with ``counter_bits`` from a
seed of (step, leaf index); the probe's draws differ, its RMS does not.

On a multi-rank training mesh (``make_train_step(..., mesh=)``; every rank
runs the same step on its shards, SPMD) the step computes the 1-device
step, as the reference's GSPMD step does: the batch is this rank's rows
over the DP axes, the model runs the Megatron decomposition
(``core/fqt._ShardedFP4Matmul``, ``models/layers``), the gradients are
summed over the DP axes (the GEMM weights' and the table's in the
backward, the other leaves' after it), and the norm, the sigma_q probe
(K2 on each shard with the leaf's global tensor scale and its global SR
indices) and every metric are reduced over the mesh, so every rank holds
the same host values.
Where ``TrainConfig.compression`` is set and the mesh has pods, each pod
takes the mean of its own tokens and the pods' gradients are averaged by
the compressed all-reduce (``compression.pod_mean_grads``), the
reference's per-pod local means.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import reference_leaves
from repro_torch.core import fqt, threshold
from repro_torch.core.formats import M32, counter_at
from repro_torch.core.quantize import NVFP4, _tensor_scale, block_quantize
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt: adamw.AdamWState
    thr: threshold.ThresholdState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    sched: schedule.ScheduleConfig = schedule.ScheduleConfig()
    thr: threshold.ThresholdConfig = threshold.ThresholdConfig()
    remat: bool = True
    probe_sigma: bool = True     # estimate sigma_q each step
    sigma_spec: Any = None       # spec of the sigma_q probe (NVFP4-SR)
    layer_stats: bool = False    # per-leaf ||g|| in metrics (telemetry:
                                 # the trainer's per-layer sqrt(3) series)
    # inter-pod gradient compression (distributed/compression.py)
    compression: Optional[comp.CompressionConfig] = None


def init_state(cfg: ModelConfig, tcfg: TrainConfig, *, seed: int = 0,
               device=None) -> TrainState:
    """Fresh state: parameters from a seeded ``torch.Generator`` on
    ``device`` (default cuda)."""
    return state_from_params(
        registry.init_params(cfg, seed=seed, device=device), tcfg)


def state_from_params(params, tcfg: TrainConfig) -> TrainState:
    """Step-0 state around given parameters (optimizer state on their
    device)."""
    dev = tree_leaves(params)[0].device
    return TrainState(0, params, adamw.init(params, tcfg.opt),
                      threshold.init(dev))


def n_params(params, mesh=None) -> int:
    """The parameter count (on a mesh, of the whole tree, not the
    shards)."""
    if mesh is None or mesh.size == 1:
        return sum(x.numel() for x in tree_leaves(params))
    return sum(math.prod(shd.shard_offsets(sp, x.shape, mesh)[0])
               for x, sp in zip(tree_leaves(params),
                                tree_leaves(shd.tree_specs(params, mesh))))


def step_seed(step: int) -> int:
    """The step's SR seed: step * 0x9E3779B1 + 1 (uint32)."""
    return (int(step) * 0x9E3779B1 + 1) & M32


def _reference_leaves(tree) -> List[Tuple[List[torch.Tensor], bool]]:
    """The leaves in the reference's tree order (dict keys sorted), each as
    (tensors, stacked): the per-layer leaves of one name form one group,
    which the reference holds as one (n_layers, ...) leaf, and a layer list
    of mixed blocks (xLSTM's) is numbered per layer
    (``checkpoint.ckpt.reference_leaves`` without the names)."""
    return [(parts, stacked) for _, parts, stacked in reference_leaves(tree)]


def probe_seed(step: int, leaf: int) -> int:
    """Seed of the sigma_q probe's SR bits for one reference leaf."""
    return (step_seed(step) ^ ((leaf + 1) * 0x632BE5AB)) & M32


def _residual_sq(g32: torch.Tensor, spec, seed: int) -> torch.Tensor:
    """sum((fake_quant(g32) - g32)^2), blocks along the last axis, with the
    dequantization done in the codes' own storage (codes x block scale x
    tensor scale, the order of ``QuantizedTensor.dequant``): the same bits
    as the out-of-place expression with two leaf-sized buffers instead of
    six (a Mixtral expert stack is 3.8 GB in f32)."""
    qt = block_quantize(g32, spec, axis=-1, seed=seed)
    q = qt.codes.contiguous()
    nb = q.shape[-1] // qt.block
    q.view(-1, nb, qt.block).mul_(
        qt.scales.reshape(-1, nb, 1)).mul_(qt.tscale)
    return torch.sum(q.sub_(g32).square_())


def _estimate_sigma_q(grads, step: int, spec=None) -> torch.Tensor:
    """sigma_q from the SR residual of quantizing the gradients with the
    paper's NVFP4-SR spec (the noise the update GEMM injects), over the
    reference's leaves: stacked per-layer leaves, blocks along the last
    axis, leaves of fewer than 2 dims or a ragged last axis skipped."""
    spec = spec if spec is not None else NVFP4.with_rounding(stochastic=True)
    num, den = None, 0.0
    for i, (group, stacked) in enumerate(_reference_leaves(grads)):
        g = torch.stack(group) if stacked else group[0]
        if g.ndim < 2 or g.shape[-1] % spec.block:
            continue
        g32 = g.to(torch.float32)
        del g
        sq = _residual_sq(g32, spec, probe_seed(step, i))
        num = sq if num is None else num + sq
        den += float(g32.numel())
    if num is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(num / max(den, 1.0) + 1e-30)


def _leaf_key(name: str) -> str:
    """The last key of a reference leaf name (``['layers']['attn']['wq']``
    -> ``wq``): all the rule table reads (its patterns end in the name)."""
    return name.rstrip("]").rsplit("[", 1)[-1].strip("'")


def _probe_parts(group, stacked: bool, spec, mesh):
    """K2 calls of the sigma_q probe on this rank's shards of one reference
    leaf: [(2-D f32 operand, global flat offset, global row stride)].  A
    leaf whose shard splits only its last dim (or nothing) is one call on
    the (stacked) shard, as one device makes it; where it splits another
    dim the shard's rows are no arithmetic progression of the whole
    leaf's, and each layer -- and in a layer of more than 2 dims (a moe
    layer's stacked experts) each index of its leading dims -- is a call
    of its own at its offset."""
    part = group[0]
    full, off = shd.shard_offsets(spec, part.shape, mesh)
    C, Cf = part.shape[-1], full[-1]
    if not any(off[:-1]) and full[:-1] == part.shape[:-1]:
        g = torch.stack(group) if stacked else part
        return [(g.to(torch.float32).reshape(-1, C), off[-1], Cf)]
    # per layer, and per index of the dims before the last two (a moe
    # leaf's experts): each (rows, C) block is a progression
    n = math.prod(full)
    out = []
    for l, p in enumerate(group):
        for idx in itertools.product(*(range(k) for k in p.shape[:-2])):
            pos = tuple(o + i for o, i in zip(off, idx)) + tuple(off[-2:])
            first = l * n + sum(o * math.prod(full[d + 1:])
                                for d, o in enumerate(pos))
            out.append((p[idx].to(torch.float32).reshape(-1, C), first, Cf))
    return out


def _estimate_sigma_q_mesh(grads, step: int, spec, mesh) -> torch.Tensor:
    """``_estimate_sigma_q`` of the whole gradient from this rank's shards:
    each reference leaf's residual through K2 (its plain version on the
    CPU) with the leaf's GLOBAL tensor scale (|max| all-reduced over the
    axes that shard it) and the 1-device SR bits (the leaf's global flat
    indices, ``formats.counter_at``), so every code and block scale is
    the 1-device probe's; the residual sums are added over the mesh, each
    leaf's by its owners only (``sharding.mesh_sum``)."""
    from repro_torch.kernels.nvfp4_quant import block_quantize as k2
    sums, owners, den = [], [], 0.0
    for i, (name, group, stacked) in enumerate(reference_leaves(grads)):
        part = group[0]
        pspec = shd.placed_spec(_leaf_key(name), part.ndim, mesh)
        full = shd.shard_offsets(pspec, part.shape, mesh)[0]
        if part.ndim + int(stacked) < 2 or full[-1] % spec.block:
            continue
        if part.shape[-1] % spec.block:
            raise ValueError(f"{name}: the shard's last dim {part.shape[-1]}"
                             f" splits a block of {spec.block}")
        amax = torch.amax(torch.stack([torch.amax(torch.abs(
            p.to(torch.float32))) for p in group])).reshape(1)
        mesh.all_reduce(amax, shd.spec_axes(pspec), op="max")
        ts = _tensor_scale(amax, spec).reshape(1)
        seed = probe_seed(step, i)
        sq = None
        for x2, first, rs in _probe_parts(group, stacked, pspec, mesh):
            codes, scales = k2(x2.contiguous(), spec, tscale=ts, counter=(
                counter_at(seed, first), rs, 1) if spec.stochastic else None)
            nb = x2.shape[1] // spec.block
            q = codes.view(-1, nb, spec.block).mul_(
                scales.reshape(-1, nb, 1)).mul_(ts).view(x2.shape)
            r = torch.sum(q.sub_(x2).square_())
            sq = r if sq is None else sq + r
        sums.append(sq)
        owners.append(shd.is_owner(pspec, mesh))
        den += float(math.prod(full) * (len(group) if stacked else 1))
    if not sums:
        return torch.zeros((), dtype=torch.float32)
    num = torch.sum(shd.mesh_sum(torch.stack(sums), owners, mesh))
    return torch.sqrt(num / max(den, 1.0) + 1e-30)


# the rules whose leaves (of 2+ dims) the backward already summed over the
# DP axes: the GEMM weights (fqt._ShardedFP4Matmul; a moe layer's stacked
# experts too, whose gradients its "replicated" route computes whole on
# every rank), the embedding table (layers.embed_lookup) and the moe
# router (layers.QCtx.dense_hp)
_SUMMED_IN_BACKWARD = ("io", "oi", "d_vocab", "vocab_d", "d_rep")


def _sync_dp_grads(grads, mesh, per_pod: bool = False):
    """Sum over the DP axes the backward sums (``sharding.grad_sum_axes``;
    ``per_pod``: "data" only) the gradients of the leaves no collective of
    the backward summed: norms, biases, smoothing factors (each DP rank
    holds its tokens' part)."""
    with shd.per_pod_gradients(per_pod):
        axes = shd.grad_sum_axes(mesh)
    if not axes:
        return grads

    def one(path, g):
        if shd.param_kind(path) in _SUMMED_IN_BACKWARD and g.ndim >= 2:
            return g
        return mesh.all_reduce(g.to(torch.float32, copy=True),
                               axes).to(g.dtype)

    return shd.map_paths(grads, one)


def loss_and_grads(params, cfg: ModelConfig, qcfg: fqt.QuantConfig, batch,
                   *, seed: int, remat: bool, mesh=None
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, aux, grads): grads a tree like params, in their dtype.
    ``mesh``: the training mesh of the parameters' shards, the batch this
    rank's rows (the loss this rank's share, ``transformer.loss_fn``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = registry.loss_fn(params, cfg, qcfg, batch, seed=seed,
                                     remat=remat, mesh=mesh)
        flat = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def local_batch(batch, mesh):
    """This rank's rows of a global batch (``sharding.batch_spec``: the
    leading dim over the DP axes); the batch itself on one rank.  A batch
    the DP axes do not divide raises ``ValueError`` (the reference would
    replicate it, and every DP rank count its rows)."""
    if mesh is None or mesh.size == 1:
        return batch
    dp = shd.dp_axes(mesh)
    n, idx = mesh.axes_size(dp), mesh.axes_index(dp)

    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"global batch of {x.shape[0]} rows does not "
                             f"split over the DP axes {dp} ({n} ranks)")
        b = x.shape[0] // n
        return x[idx * b:(idx + 1) * b]

    return {k: one(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, qcfg: fqt.QuantConfig,
                    tcfg: TrainConfig, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics).  ``batch``:
    {"tokens": (B, S + 1) integer tensor on the parameters' device}.  The
    step consumes ``state`` (its optimizer state is updated in place).

    ``mesh``: a multi-rank training mesh (``distributed/mesh.make_mesh``);
    ``state`` is this rank's (``sharding.place_train_state``) and ``batch``
    this rank's rows (``local_batch``); the metrics are the whole step's,
    the same on every rank."""
    multi = mesh is not None and mesh.size > 1
    if multi:
        registry.check_mesh(cfg, mesh)
    m = mesh if multi else None
    # the pods' gradients averaged after the backward, compressed; else
    # "pod" is summed in the backward as every DP axis (the global mean)
    per_pod = (multi and mesh.axis_size("pod") > 1
               and tcfg.compression is not None
               and tcfg.compression.enabled)

    def train_step(state: TrainState, batch):
        step = state.step
        seed = step_seed(step)
        with shd.per_pod_gradients(per_pod):
            loss, aux, grads = loss_and_grads(state.params, cfg, qcfg, batch,
                                              seed=seed, remat=tcfg.remat,
                                              mesh=m)
        with torch.no_grad():
            if multi:
                grads = _sync_dp_grads(grads, mesh, per_pod)
                if per_pod:
                    grads = comp.pod_mean_grads(grads, seed, mesh,
                                                tcfg.compression)
                # this rank's share of the (its pod's) mean -> the mean
                lossv = torch.stack([loss, aux["nll"], aux["aux"]]).to(
                    torch.float32)
                lossv = mesh.all_reduce(lossv, ("data", "pod"))
                if per_pod:
                    lossv = lossv / mesh.axis_size("pod")
                loss, nll, aux_loss = lossv[0], lossv[1], lossv[2]
            else:
                nll, aux_loss = aux["nll"], aux["aux"]
            # section 4 monitor: ||grad L|| / (sigma_q sqrt(d)) vs sqrt(3)
            gnorm = adamw.global_norm(grads, m)
            if tcfg.probe_sigma:
                spec = tcfg.sigma_spec if tcfg.sigma_spec is not None \
                    else NVFP4.with_rounding(stochastic=True)
                sigma_q = (_estimate_sigma_q_mesh(grads, step, spec, mesh)
                           if multi else _estimate_sigma_q(
                               grads, step, tcfg.sigma_spec)
                           ).to(gnorm.device)
            else:
                sigma_q = state.thr.sigma_q
            thr_state = threshold.update(state.thr, gnorm,
                                         n_params(grads, m), sigma_q,
                                         tcfg.thr)
            lr = schedule.lr_at(step, tcfg.sched)
            params, opt, opt_metrics = adamw.apply(grads, state.opt,
                                                   tcfg.opt, lr, m, gnorm)
        metrics = {
            "loss": loss.to(torch.float32),
            "nll": nll.to(torch.float32),
            "aux": aux_loss.to(torch.float32),   # the moe routers' (0 dense)
            "grad_norm": opt_metrics["grad_norm"],
            "lr": lr,
            "sigma_q": sigma_q,
            "gnr": thr_state.ratio_ema,          # gradient-to-noise ratio
            "thr_crossed": thr_state.crossed.to(torch.float32),
        }
        if tcfg.layer_stats:
            # one f32 norm per reference leaf (a stacked group's over all
            # its layers), in reference order, left on the device: the
            # trainer reads it with the other metrics in one transfer
            metrics["layer_gnorms"] = _layer_gnorms(grads, m)
        return TrainState(step + 1, params, opt, thr_state), metrics

    return train_step


def _layer_gnorms(grads, mesh=None) -> torch.Tensor:
    """||g|| of each reference leaf, in reference order (on a mesh, of the
    whole leaf: squares summed over the ranks holding its parts)."""
    leaves = reference_leaves(grads)
    sqs = torch.stack([sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in group) for _, group, _ in leaves])
    if mesh is not None:
        owners = [shd.is_owner(shd.placed_spec(_leaf_key(name),
                                               group[0].ndim, mesh), mesh)
                  for name, group, _ in leaves]
        sqs = shd.mesh_sum(sqs, owners, mesh)
    return torch.sqrt(sqs)


def state_shardings(state: TrainState, mesh):
    """The spec tree of a full ``TrainState`` (the reference's
    ``state_shardings``; ``sharding.place_train_state`` places by it):
    params FSDP x TP, AdamW's master / m / v following them, the step
    counters and the threshold state replicated."""
    pspecs = shd.params_shardings(state.params, mesh)
    thr = dataclasses.replace(state.thr, **{
        f.name: () for f in dataclasses.fields(state.thr)})
    return TrainState(step=(), params=pspecs,
                      opt=shd.opt_state_shardings(state.opt, pspecs, mesh),
                      thr=thr)
