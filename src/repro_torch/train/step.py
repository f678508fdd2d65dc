"""The FQT train step: loss, grads, the paper's section 4 monitor, AdamW.

Counterpart of ``repro.train.step`` without a mesh:

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import fqt, threshold
from repro_torch.core.formats import M32
from repro_torch.core.quantize import NVFP4, fake_quant
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


def n_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def step_seed(step: int) -> int:
    """The step's SR seed: step * 0x9E3779B1 + 1 (uint32)."""
    return (int(step) * 0x9E3779B1 + 1) & M32


def _reference_leaves(tree) -> List[Tuple[List[torch.Tensor], bool]]:
    """The leaves in the reference's tree order (dict keys sorted), each as
    (tensors, stacked): the per-layer leaves of one name form one group,
    which the reference holds as one (n_layers, ...) leaf."""
    def walk(t):
        if isinstance(t, dict):
            return [g for k in sorted(t) for g in walk(t[k])]
        return [t]
    out = []
    for k in sorted(tree):
        if k == "layers":
            per_layer = [walk(lp) for lp in tree[k]]
            out += [([pl[j] for pl in per_layer], True)
                    for j in range(len(per_layer[0]))]
        else:
            out += [([t], False) for t in walk(tree[k])]
    return out


def probe_seed(step: int, leaf: int) -> int:
    """Seed of the sigma_q probe's SR bits for one reference leaf."""
    return (step_seed(step) ^ ((leaf + 1) * 0x632BE5AB)) & M32


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
        q = fake_quant(g32, spec, axis=-1, seed=probe_seed(step, i))
        sq = torch.sum(torch.square(q - g32))
        num = sq if num is None else num + sq
        den += float(g.numel())
    if num is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(num / max(den, 1.0) + 1e-30)


def loss_and_grads(params, cfg: ModelConfig, qcfg: fqt.QuantConfig, batch,
                   *, seed: int, remat: bool
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, aux, grads): grads a tree like params, in their dtype."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = registry.loss_fn(params, cfg, qcfg, batch, seed=seed,
                                     remat=remat)
        flat = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg: ModelConfig, qcfg: fqt.QuantConfig,
                    tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).  ``batch``:
    {"tokens": (B, S + 1) integer tensor on the parameters' device}.  The
    step consumes ``state`` (its optimizer state is updated in place)."""

    def train_step(state: TrainState, batch):
        step = state.step
        loss, aux, grads = loss_and_grads(state.params, cfg, qcfg, batch,
                                          seed=step_seed(step),
                                          remat=tcfg.remat)
        with torch.no_grad():
            # section 4 monitor: ||grad L|| / (sigma_q sqrt(d)) vs sqrt(3)
            gnorm = adamw.global_norm(grads)
            if tcfg.probe_sigma:
                sigma_q = _estimate_sigma_q(grads, step, tcfg.sigma_spec
                                            ).to(gnorm.device)
            else:
                sigma_q = state.thr.sigma_q
            thr_state = threshold.update(state.thr, gnorm, n_params(grads),
                                         sigma_q, tcfg.thr)
            lr = schedule.lr_at(step, tcfg.sched)
            params, opt, opt_metrics = adamw.apply(grads, state.opt,
                                                   tcfg.opt, lr)
        metrics = {
            "loss": loss.to(torch.float32),
            "nll": aux["nll"].to(torch.float32),
            "grad_norm": opt_metrics["grad_norm"],
            "lr": lr,
            "sigma_q": sigma_q,
            "gnr": thr_state.ratio_ema,          # gradient-to-noise ratio
            "thr_crossed": thr_state.crossed.to(torch.float32),
        }
        return TrainState(step + 1, params, opt, thr_state), metrics

    return train_step
