"""LR schedules: linear warmup + cosine decay, and the paper's QAF re-warm
(reset LR, 40-iteration warmup, cosine decay from a fresh peak, section 5).
Counterpart of ``repro.optim.schedule``, computed in f32 as the reference
computes it."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # phase offset: the schedule is relative to this global step (the QAF
    # re-warm starts its fresh warmup+cosine at the switch step)
    start_step: int = 0


def lr_at(step: int, cfg: ScheduleConfig) -> torch.Tensor:
    """Warmup + cosine at ``step`` (relative to cfg.start_step): an f32
    scalar tensor on the CPU (usable beside tensors on any device)."""
    f32 = torch.float32
    step = torch.clamp(torch.tensor(float(step), dtype=f32)
                       - cfg.start_step, min=0.0)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    mincoef = cfg.min_lr_ratio
    cos = cfg.peak_lr * (mincoef + (1 - mincoef) * 0.5
                         * (1 + torch.cos(torch.tensor(math.pi, dtype=f32)
                                          * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def qaf_schedule(base: ScheduleConfig, qaf_steps: int,
                 peak_scale: float = 0.5,
                 start_step: int = 0) -> ScheduleConfig:
    """The paper's QAF phase: fresh 40-step warmup + cosine over the QAF
    budget, peak reset to a fraction of the pretrain peak."""
    return ScheduleConfig(peak_lr=base.peak_lr * peak_scale,
                          warmup_steps=min(40, max(qaf_steps // 4, 1)),
                          total_steps=qaf_steps,
                          min_lr_ratio=0.0, start_step=start_step)
