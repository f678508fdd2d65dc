"""Trainer: the training loop (PyTorch counterpart of
``repro.train.trainer``).

  * the loop over a step-indexed data stream (``data.pipeline``), so a run
    consumes exactly the tokens the reference would;
  * straggler accounting: a step slower than ``straggler_factor`` x the
    running median is recorded as an event;
  * the QAF switch (the paper's section 4 -> 5 pipeline): when the
    gradient-to-noise EMA crosses sqrt(3), or at a fixed step, the step
    function is rebuilt with the QAF QuantConfig (FP4 forward, BF16
    backward) and a re-warmed LR, continuing from the same state;
  * ``history`` (per-step metrics) and ``summary``.

Checkpoint/restart and the packed serving export, the quant-health tracer
and the mesh arrive with later slices (ROADMAP Queue 1); asking for them
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import fqt, qaf
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.train import step as step_mod

_CKPT = ("checkpoint/restart and the packed serving export arrive with a "
         "later slice (ROADMAP Queue 1: checkpoint/ckpt.py)")
_TRACER = ("the trainer's quant-health telemetry arrives with a later slice "
           "(ROADMAP Queue 1: obs/trace.py and scale_health)")
_MESH = ("mesh training arrives with the distributed slice (ROADMAP Queue "
         "1: distributed/sharding.py, compression.py)")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None    # checkpoint/restart: a later slice
    straggler_factor: float = 3.0
    seed: int = 0                     # parameter seed when run() gets none
    qaf: qaf.QAFConfig = dataclasses.field(default_factory=qaf.QAFConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, qcfg: fqt.QuantConfig,
                 tcfg: step_mod.TrainConfig, run_cfg: TrainerConfig,
                 data_cfg: DataConfig, mesh=None, tracer=None, device=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        if tracer is not None:
            raise NotImplementedError(_TRACER)
        if run_cfg.ckpt_dir:
            raise NotImplementedError(_CKPT)
        self.cfg, self.qcfg, self.tcfg = cfg, qcfg, tcfg
        self.run_cfg, self.data_cfg = run_cfg, data_cfg
        self.device = resolve_device(device)
        self.data = SyntheticLM(data_cfg)
        self.history: List[Dict[str, float]] = []
        self.events: List[Dict[str, Any]] = []
        self.in_qaf = False
        self._step_fn = None

    def _build_step(self, start_step: int = 0):
        qcfg = qaf.qaf_quant_config(self.qcfg) if self.in_qaf else self.qcfg
        tcfg = self.tcfg
        if self.in_qaf:
            tcfg = dataclasses.replace(
                tcfg, sched=qaf.qaf_lr_schedule(self.tcfg.sched,
                                                self.run_cfg.qaf,
                                                start_step))
        self._step_fn = step_mod.make_train_step(self.cfg, qcfg, tcfg)

    def run(self, state: Optional[step_mod.TrainState] = None
            ) -> step_mod.TrainState:
        """Train from ``state`` (default: fresh parameters from
        ``run_cfg.seed``) up to ``total_steps``."""
        if state is None:
            state = step_mod.init_state(self.cfg, self.tcfg,
                                        seed=self.run_cfg.seed,
                                        device=self.device)
        self._build_step()
        durations: List[float] = []
        for step in range(state.step, self.run_cfg.total_steps):
            batch = {"tokens": torch.from_numpy(
                self.data.batch(step)["tokens"]).to(self.device)}
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # host sync
            dt = time.perf_counter() - t0

            # straggler accounting (skip the first steps of a phase)
            if len(durations) >= 5:
                med = float(np.median(durations[-50:]))
                if dt > self.run_cfg.straggler_factor * med:
                    self.events.append({"kind": "straggler", "step": step,
                                        "dt": dt, "median": med})
            durations.append(dt)

            metrics["step"] = step
            metrics["dt"] = dt
            self.history.append(metrics)

            # QAF switch (paper section 5): threshold crossing or fixed step
            if not self.in_qaf and qaf.should_switch(
                    step, metrics["thr_crossed"] > 0.5, self.run_cfg.qaf):
                self.in_qaf = True
                self.events.append({"kind": "qaf_switch", "step": step,
                                    "gnr": metrics["gnr"]})
                self._build_step(start_step=step + 1)
        return state

    def summary(self) -> Dict[str, Any]:
        h = self.history
        return {
            "steps": len(h),
            "final_loss": h[-1]["loss"] if h else None,
            "final_gnr": h[-1]["gnr"] if h else None,
            "qaf": self.in_qaf,
            "events": self.events,
        }
