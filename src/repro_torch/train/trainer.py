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

``Trainer(mesh=)`` trains on a multi-rank training mesh
(``distributed/mesh.make_mesh``: "pod", "data", "model"), SPMD: every rank
builds the same Trainer and runs the same loop on its shards of the state
(``sharding.place_train_state``) and its rows of the step-indexed global
batch (``step.local_batch``).  Every host decision comes from values the
ranks agree on: the QAF switch reads the all-reduced gradient-to-noise
ratio, the SIGTERM flag and the step time are all-reduced (MAX) together
after each step, so every rank stops, and flags a straggler, at the same
step.  Checkpoints gather the state and rank 0 writes them (a checkpoint
restores on any mesh); rank 0 alone writes the telemetry and the packed
export, which it packs from the gathered final parameters.  Every
family whose heads split over "model" (``registry.check_mesh``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.core import fqt, qaf, quantize, threshold
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.train import step as step_mod


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
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            registry.check_mesh(cfg, self.mesh)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # on a mesh every rank computes the telemetry (its reductions are
        # collectives) and rank 0 writes it
        self._telemetry = bool(self._agree(float(self.tracer.enabled))[0])
        if self.mesh is not None and self.mesh.rank != 0:
            self.tracer = NULL_TRACER
        # live telemetry turns on the step's per-leaf gradient norms
        if self._telemetry and not tcfg.layer_stats:
            tcfg = dataclasses.replace(tcfg, layer_stats=True)
        self.cfg, self.qcfg, self.tcfg = cfg, qcfg, tcfg
        self.run_cfg, self.data_cfg = run_cfg, data_cfg
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.data = SyntheticLM(data_cfg)
        self.history: List[Dict[str, float]] = []
        self.events: List[Dict[str, Any]] = []
        self.in_qaf = False
        self._stop = False
        self._step_fn = None
        self._leaf_info = None          # [(name, size)] of reference leaves

    # ---- lifecycle -------------------------------------------------------

    def _agree(self, *values: float) -> tuple:
        """Each value's maximum over the mesh's ranks, in one all-reduce
        (the values themselves on one rank): host decisions every rank
        takes alike."""
        if self.mesh is None:
            return values
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        if self.mesh.backend != "gloo":
            t = t.to(self.mesh.device)
        return tuple(self.mesh.all_reduce(t, self.mesh.axis_names,
                                          op="max").tolist())

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
        self._step_fn = step_mod.make_train_step(self.cfg, qcfg, tcfg,
                                                 self.mesh)

    def init_or_restore(self, state: Optional[step_mod.TrainState] = None
                        ) -> step_mod.TrainState:
        """``state`` (default: fresh parameters from ``run_cfg.seed``), or
        the latest checkpoint in ``ckpt_dir`` restored into its structure
        and device.  On a mesh the state is placed: this rank's shards (a
        given full state is placed, a placed one taken as it is; fresh
        parameters are drawn whole and cut, and AdamW's state is made on
        the shards)."""
        mesh = self.mesh
        if state is None:
            params = registry.init_params(self.cfg, seed=self.run_cfg.seed,
                                          device=self.device)
            if mesh is not None:
                params = shd.place_train_params(params, mesh)
            state = step_mod.state_from_params(params, self.tcfg)
        elif mesh is not None and not shd.is_placed(state.params, self.cfg,
                                                    mesh):
            state = shd.place_train_state(state, mesh)
        if self.run_cfg.ckpt_dir:
            step, restored = ckpt.restore_latest(self.run_cfg.ckpt_dir, state,
                                                 mesh=mesh)
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
        # one rank reads its SIGTERM flag at each step boundary; a mesh
        # reads the flag agreed with the last step's time
        agreed_stop = self._agree(float(self._stop))[0]
        for step in range(state.step, rc.total_steps):
            if self._stop if self.mesh is None else agreed_stop:
                self.events.append({"kind": "preempt", "step": step})
                break
            batch = step_mod.local_batch({"tokens": torch.from_numpy(
                self.data.batch(step)["tokens"]).to(self.device)}, self.mesh)
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, batch)
            metrics, layer_gnorms = _read_metrics(metrics)   # host sync
            agreed_stop, dt = self._agree(float(self._stop),
                                          time.perf_counter() - t0)

            if self._telemetry and step % rc.log_every == 0:
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
                ckpt.save(rc.ckpt_dir, step + 1, state, keep=rc.keep_ckpts,
                          mesh=self.mesh)

        if rc.ckpt_dir:
            ckpt.save(rc.ckpt_dir, state.step, state, keep=rc.keep_ckpts,
                      mesh=self.mesh)
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
                self._leaf_info = [(name, sum(self._numel(name, p)
                                              for p in parts))
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
            for name, parts, stacked in leaves:
                ndim = parts[0].ndim + int(stacked)
                n = sum(self._numel(name, p) for p in parts)
                if ndim >= 2 and self._full_shape(name, parts[0])[-1] \
                        % spec.block == 0 and (probe is None or n > size):
                    probe, size = (name, parts, stacked), n
            if probe is not None:
                h = self._scale_health(*probe, spec)
                trc.counter("scale_blocks", h["blocks"])
                trc.counter("scale_saturated", h["saturated"])
                trc.counter("scale_underflow", h["underflow"])

    def _full_shape(self, name: str, part) -> tuple:
        """The logical shape of a (per-layer) part of reference leaf
        ``name``: its own shape on one rank."""
        if self.mesh is None:
            return tuple(part.shape)
        spec = shd.placed_spec(step_mod._leaf_key(name), part.ndim,
                               self.mesh)
        return shd.shard_offsets(spec, part.shape, self.mesh)[0]

    def _numel(self, name: str, part) -> int:
        return int(np.prod(self._full_shape(name, part)))

    def _scale_health(self, name, parts, stacked, spec) -> Dict[str, int]:
        """``quantize.scale_health`` of the whole leaf: on a mesh, each
        rank's shard under the leaf's global |max|, the tallies summed
        over the ranks holding distinct parts."""
        x = torch.stack(parts) if stacked else parts[0]
        if self.mesh is None:
            return quantize.scale_health(x, spec)
        pspec = shd.placed_spec(step_mod._leaf_key(name), parts[0].ndim,
                                self.mesh)
        if x.shape[-1] % spec.block:
            raise ValueError(f"{name}: the shard's last dim {x.shape[-1]} "
                             f"splits a block of {spec.block}")
        amax = torch.amax(torch.abs(x.to(torch.float32))).reshape(1)
        self.mesh.all_reduce(amax, shd.spec_axes(pspec), op="max")
        c = quantize.scale_health(x, spec, amax=amax, counts=True)
        c = shd.mesh_sum(c.to(torch.float32), [shd.is_owner(pspec,
                                                           self.mesh)] * 3,
                         self.mesh)
        blocks, sat, under = (int(v) for v in c.tolist())
        return {"blocks": blocks, "saturated": sat, "underflow": under}

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
        base = os.path.join(self.run_cfg.ckpt_dir, "serve_packed")
        params = state.params
        if self.mesh is not None:
            # every rank gathers; rank 0 packs the whole parameters
            params = shd.gather_tree(params, self.mesh,
                                     keep=self.mesh.rank == 0)
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save(base, state.step, pack_model_params(
                self.cfg, params, spec), keep=self.run_cfg.keep_ckpts)
        del params
        if self.mesh is not None:
            torch.distributed.barrier()
        self.events.append({"kind": "export_packed", "step": state.step})
        return os.path.join(base, f"step_{state.step:08d}")

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
