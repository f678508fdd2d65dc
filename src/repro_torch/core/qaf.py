"""Quantization-Aware Finetuning (QAF) phase orchestration (paper section
5; counterpart of ``repro.core.qaf``).

When FP4 pretraining stalls (the section 4 threshold crosses sqrt(3), or a
fixed step is reached), training continues with the forward GEMMs still in
FP4 while backward and update GEMMs run in BF16; the LR is re-warmed (40
steps) and cosine-decayed from a reduced peak.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import fqt
from repro_torch.optim.schedule import ScheduleConfig, qaf_schedule


@dataclasses.dataclass(frozen=True)
class QAFConfig:
    enabled: bool = True
    auto_switch: bool = True        # switch on the section 4 crossing
    fixed_switch_step: int = 0      # >0: switch at this step regardless
    qaf_steps: int = 1000
    peak_scale: float = 0.5


def qaf_quant_config(pretrain_cfg: fqt.QuantConfig) -> fqt.QuantConfig:
    """FP4 forward / BF16 backward+update, keeping the forward specs."""
    return fqt.QuantConfig(fwd_w=pretrain_cfg.fwd_w, fwd_a=pretrain_cfg.fwd_a)


def qaf_lr_schedule(base: ScheduleConfig, cfg: QAFConfig,
                    start_step: int = 0) -> ScheduleConfig:
    return qaf_schedule(base, cfg.qaf_steps, cfg.peak_scale, start_step)


def should_switch(step: int, threshold_crossed: bool, cfg: QAFConfig) -> bool:
    if not cfg.enabled:
        return False
    if cfg.fixed_switch_step and step >= cfg.fixed_switch_step:
        return True
    return cfg.auto_switch and bool(threshold_crossed)
