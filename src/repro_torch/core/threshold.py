"""The paper's section 4 gradient-to-noise monitor and sqrt(3) precision
switch (PyTorch counterpart of ``repro.core.threshold``).

With SR gradient quantization (noise std sigma_q per coordinate) the
expected loss decrease stalls once ||grad L|| / (sigma_q * sqrt(d)) < sqrt(3).
The monitor tracks an EMA of that ratio and recommends switching the
backward/update GEMMs to higher precision (the QAF phase) when it crosses.
The state's scalars stay device tensors: no host sync inside a step.
"""
from __future__ import annotations

import dataclasses

import torch

SQRT3 = 1.7320508075688772


@dataclasses.dataclass(frozen=True)
class ThresholdConfig:
    ema: float = 0.9
    threshold: float = SQRT3
    min_steps: int = 10      # ignore the noisy first steps


@dataclasses.dataclass
class ThresholdState:
    ratio_ema: torch.Tensor   # f32: EMA of ||g|| / (sigma_q sqrt(d))
    sigma_q: torch.Tensor     # f32: last noise-std estimate
    step: int
    crossed: torch.Tensor     # bool: EMA below threshold (switch advised)


def init(device=None) -> ThresholdState:
    return ThresholdState(
        torch.tensor(1e9, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device), 0,
        torch.zeros((), dtype=torch.bool, device=device))


def update(state: ThresholdState, grad_norm: torch.Tensor, n_params: int,
           sigma_q: torch.Tensor, cfg: ThresholdConfig) -> ThresholdState:
    """grad_norm: global ||grad L|| (f32); n_params: d; sigma_q: probe
    estimate."""
    sqrt_d = torch.sqrt(torch.tensor(float(n_params), dtype=torch.float32))
    ratio = grad_norm / (sigma_q * sqrt_d + 1e-30)
    if state.step < 1:
        ema = ratio
    else:
        ema = cfg.ema * state.ratio_ema + (1 - cfg.ema) * ratio
    step = state.step + 1
    crossed = (ema < cfg.threshold) & (step >= cfg.min_steps)
    return ThresholdState(ema, sigma_q, step, crossed)
