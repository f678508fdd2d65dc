"""Trainer: the fault-tolerant training loop (PyTorch counterpart of
``repro.train.trainer``).

  * **checkpoint/restart**: atomic checkpoints (``checkpoint/ckpt.py``, the
    reference's on-disk format) every ``ckpt_every`` steps and at the end
    of ``run``; a run resumes from the latest checkpoint in ``ckpt_dir``.
    The data stream is step-indexed and the SR seeds come from the step, so
    a restarted run repeats an uninterrupted one bit for bit;
  * **preemption safety**: SIGTERM sets a flag, and the loop records a
    ``preempt`` event and stops at the next step boundary, then checkpoints
    and exports as at the end of any run;
  * **the packed serving export**: the final parameters packed to NVFP4
    with the QAF forward weight spec, saved under
    ``<ckpt_dir>/serve_packed`` for ``serve.Engine(..., pack_weights=False)``;
  * **quant-health telemetry** (``obs/trace.py``, clock = optimizer step,
    every ``log_every`` steps): loss, grad norm, sigma_q and the
    gradient-to-noise ratio, each reference leaf's ||g_i|| / (sigma_q
    sqrt(d_i)) and how many fall under sqrt(3), block-scale saturation and
    underflow of a probe weight, and the SR/RtN tallies of the six
    quantization points;
  * straggler accounting against the running median step time;
  * the QAF switch (the paper's section 4 -> 5 pipeline): when the
    gradient-to-noise EMA crosses sqrt(3), or at a fixed step, the step
    function is rebuilt with the QAF QuantConfig (FP4 forward, BF16
    backward) and a re-warmed LR.  As in the reference, ``in_qaf`` is not
    checkpointed: a run restored after the switch takes its first step
    with the pre-switch config, then switches again.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.core import fqt, qaf, quantize, threshold
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.train import step as step_mod

_MESH = ("mesh training arrives with the distributed slice (ROADMAP Queue "
         "1: distributed/sharding.py, compression.py)")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0                     # parameter seed when run() gets none
    qaf: qaf.QAFConfig = dataclasses.field(default_factory=qaf.QAFConfig)
    # save the quantize-once packed NVFP4 serving artifact at the end of a
    # run (<ckpt_dir>/serve_packed)
    export_packed: bool = True


class Trainer:
    def __init__(self, cfg: ModelConfig, qcfg: fqt.QuantConfig,
                 tcfg: step_mod.TrainConfig, run_cfg: TrainerConfig,
                 data_cfg: DataConfig, mesh=None, tracer=None, device=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        # a live tracer turns on the step's per-leaf gradient norms
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled and not tcfg.layer_stats:
            tcfg = dataclasses.replace(tcfg, layer_stats=True)
        self.cfg, self.qcfg, self.tcfg = cfg, qcfg, tcfg
        self.run_cfg, self.data_cfg = run_cfg, data_cfg
        self.device = resolve_device(device)
        self.data = SyntheticLM(data_cfg)
        self.history: List[Dict[str, float]] = []
        self.events: List[Dict[str, Any]] = []
        self.in_qaf = False
        self._stop = False
        self._step_fn = None
        self._leaf_info = None          # [(name, size)] of reference leaves

    # ---- lifecycle -------------------------------------------------------

    def _install_sigterm(self):
        """Returns the handler it replaced (None off the main thread)."""
        try:
            return signal.signal(signal.SIGTERM, lambda *_: setattr(
                self, "_stop", True))
        except ValueError:
            return None     # not on the main thread

    def _build_step(self, start_step: int = 0):
        qcfg = qaf.qaf_quant_config(self.qcfg) if self.in_qaf else self.qcfg
        tcfg = self.tcfg
        if self.in_qaf:
            tcfg = dataclasses.replace(
                tcfg, sched=qaf.qaf_lr_schedule(self.tcfg.sched,
                                                self.run_cfg.qaf,
                                                start_step))
        self._step_fn = step_mod.make_train_step(self.cfg, qcfg, tcfg)

    def init_or_restore(self, state: Optional[step_mod.TrainState] = None
                        ) -> step_mod.TrainState:
        """``state`` (default: fresh parameters from ``run_cfg.seed``), or
        the latest checkpoint in ``ckpt_dir`` restored into its structure
        and device."""
        if state is None:
            state = step_mod.init_state(self.cfg, self.tcfg,
                                        seed=self.run_cfg.seed,
                                        device=self.device)
        if self.run_cfg.ckpt_dir:
            step, restored = ckpt.restore_latest(self.run_cfg.ckpt_dir, state)
            if restored is not None:
                self.events.append({"kind": "restore", "step": int(step)})
                return restored
        return state

    # ---- the loop --------------------------------------------------------

    def run(self, state: Optional[step_mod.TrainState] = None
            ) -> step_mod.TrainState:
        """Train from the latest checkpoint, else from ``state`` (default:
        fresh parameters), up to ``total_steps``."""
        previous = self._install_sigterm()
        try:
            return self._run(self.init_or_restore(state))
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, state: step_mod.TrainState) -> step_mod.TrainState:
        rc = self.run_cfg
        self._build_step()
        durations: List[float] = []
        for step in range(state.step, rc.total_steps):
            if self._stop:
                self.events.append({"kind": "preempt", "step": step})
                break
            batch = {"tokens": torch.from_numpy(
                self.data.batch(step)["tokens"]).to(self.device)}
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, batch)
            metrics, layer_gnorms = _read_metrics(metrics)   # host sync
            dt = time.perf_counter() - t0

            if self.tracer.enabled and step % rc.log_every == 0:
                self._emit_telemetry(step, metrics, layer_gnorms, state)

            # straggler accounting (skip the first steps of a phase)
            if len(durations) >= 5:
                med = float(np.median(durations[-50:]))
                if dt > rc.straggler_factor * med:
                    self.events.append({"kind": "straggler", "step": step,
                                        "dt": dt, "median": med})
            durations.append(dt)

            metrics["step"] = step
            metrics["dt"] = dt
            self.history.append(metrics)

            # QAF switch (paper section 5): threshold crossing or fixed step
            if not self.in_qaf and qaf.should_switch(
                    step, metrics["thr_crossed"] > 0.5, rc.qaf):
                self.in_qaf = True
                self.events.append({"kind": "qaf_switch", "step": step,
                                    "gnr": metrics["gnr"]})
                self._build_step(start_step=step + 1)

            if rc.ckpt_dir and (step + 1) % rc.ckpt_every == 0:
                ckpt.save(rc.ckpt_dir, step + 1, state, keep=rc.keep_ckpts)

        if rc.ckpt_dir:
            ckpt.save(rc.ckpt_dir, state.step, state, keep=rc.keep_ckpts)
            if rc.export_packed:
                self.export_serving_artifact(state)
        return state

    # ---- quant-health telemetry ------------------------------------------

    def _emit_telemetry(self, step: int, metrics: Dict[str, float],
                        layer_gnorms: Optional[np.ndarray], state) -> None:
        """One trace entry per logged step (clock = optimizer step), the
        reference's events on its tracks: the ``loss``, ``grad_norm``,
        ``sigma_q`` and ``gnr`` gauges; per reference leaf a ``ratio<path>``
        gauge on track ``layers`` and the ``layers_below_sqrt3`` counter;
        the block-scale ``scale_blocks`` / ``scale_saturated`` /
        ``scale_underflow`` counters of the largest blockable weight
        quantized with the active forward spec; and the
        ``rounding_sr_points`` / ``rounding_rtn_points`` tallies of the six
        quantization points."""
        trc = self.tracer
        trc.set_time(step)
        trc.gauge("loss", metrics["loss"])
        trc.gauge("grad_norm", metrics["grad_norm"])
        trc.gauge("sigma_q", metrics["sigma_q"])
        trc.gauge("gnr", metrics["gnr"])
        if metrics["thr_crossed"] > 0.5:
            trc.counter("sqrt3_crossed_steps")

        qcfg = qaf.qaf_quant_config(self.qcfg) if self.in_qaf else self.qcfg
        specs = [getattr(qcfg, p) for p in fqt.POINTS]
        trc.counter("rounding_sr_points",
                    sum(1 for s in specs if s is not None and s.stochastic))
        trc.counter("rounding_rtn_points",
                    sum(1 for s in specs
                        if s is not None and not s.stochastic))

        leaves = ckpt.reference_leaves(state.params)
        if layer_gnorms is not None:
            if self._leaf_info is None:
                self._leaf_info = [(name, sum(p.numel() for p in parts))
                                   for name, parts, _ in leaves]
            below = 0
            for (name, size), g in zip(self._leaf_info, layer_gnorms):
                r = threshold.layer_ratio(float(g), metrics["sigma_q"],
                                          size)
                trc.gauge(f"ratio{name}", r, track="layers")
                below += r < threshold.SQRT3
            if below:
                trc.counter("layers_below_sqrt3", below)

        spec = qcfg.fwd_w
        if spec is not None:
            probe, size = None, 0
            for _, parts, stacked in leaves:
                ndim = parts[0].ndim + int(stacked)
                n = sum(p.numel() for p in parts)
                if ndim >= 2 and parts[0].shape[-1] % spec.block == 0 \
                        and (probe is None or n > size):
                    probe, size = (parts, stacked), n
            if probe is not None:
                parts, stacked = probe
                h = quantize.scale_health(
                    torch.stack(parts) if stacked else parts[0], spec)
                trc.counter("scale_blocks", h["blocks"])
                trc.counter("scale_saturated", h["saturated"])
                trc.counter("scale_underflow", h["underflow"])

    def export_serving_artifact(self, state) -> Optional[str]:
        """Quantize-once export: every GEMM weight packed with this run's QAF
        forward weight spec (``serve/packing.pack_model_params``) and saved
        under ``<ckpt_dir>/serve_packed``, 4-bit on disk, for
        ``serve.Engine(..., pack_weights=False)``.  A run with no quantized
        forward (the bf16 baseline) exports nothing."""
        if not self.run_cfg.ckpt_dir:
            return None
        spec = qaf.qaf_quant_config(self.qcfg).fwd_w
        if spec is None:
            return None
        from repro_torch.serve.packing import pack_model_params
        packed = pack_model_params(self.cfg, state.params, spec)
        path = ckpt.save(os.path.join(self.run_cfg.ckpt_dir, "serve_packed"),
                         state.step, packed, keep=self.run_cfg.keep_ckpts)
        self.events.append({"kind": "export_packed", "step": state.step})
        return path

    # ---- reporting -------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        h = self.history
        return {
            "steps": len(h),
            "final_loss": h[-1]["loss"] if h else None,
            "final_gnr": h[-1]["gnr"] if h else None,
            "qaf": self.in_qaf,
            "events": self.events,
        }


def _read_metrics(metrics: Dict[str, torch.Tensor]):
    """The step's metrics with one device-to-host transfer (those on the
    CPU, such as the LR, are read as they are): ({name: float}, the
    per-leaf gradient norms or None)."""
    names = [k for k in metrics
             if k != "layer_gnorms" and metrics[k].device.type != "cpu"]
    out = {k: float(v) for k, v in metrics.items()
           if k != "layer_gnorms" and k not in names}
    parts = [metrics[k].reshape(1).to(torch.float32) for k in names]
    if "layer_gnorms" in metrics:
        parts.append(metrics["layer_gnorms"].to(torch.float32))
    host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0)
    out.update((k, float(v)) for k, v in zip(names, host))
    return ({k: out[k] for k in metrics if k != "layer_gnorms"},
            host[len(names):] if "layer_gnorms" in metrics else None)
