"""Training launcher (PyTorch).

  python -m repro_torch.launch.train --arch llama2-60m --smoke --steps 20 \\
      --ckpt-dir runs/r1 --trace runs/r1/trace.json
  python -m repro_torch.launch.train --arch zamba2-1.2b --batch 4 --seq 1024
  python -m repro_torch.launch.train --arch xlstm-125m --smoke --device cpu
  python -m repro_torch.launch.train --arch whisper-base --smoke --device cpu

Trains under the paper's FQT scheme (``--quant nvfp4``: NVFP4 at all six
GEMM points, SR on the gradients and the update's activations) on the
step-indexed synthetic token stream, with the sqrt(3) monitor and the QAF
switch.  The batch holds tokens only, as the reference's: whisper's encoder
sees zero frames and InternVL2 trains without a patch prefix.  Parameters come from a seeded ``torch.Generator``.  With
``--ckpt-dir`` it checkpoints every ``--ckpt-every`` steps and at the end,
exports the packed NVFP4 serving artifact (``<ckpt-dir>/serve_packed``), and
resumes from the latest checkpoint: run the same command again after a kill
and the run continues bit for bit.  ``--trace PATH`` writes the quant-health
telemetry as Chrome trace events.  Runs on the GPU unless ``--device cpu``
is given.  ``--quant nvfp4_pallas`` is the same config as ``nvfp4``: the
port has no jnp/Pallas switch, on the card every FQT GEMM is the K1 kernel.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.core import fqt, qaf
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw, schedule
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

QUANT = {
    "nvfp4": fqt.nvfp4_paper_config,
    "mxfp4": fqt.mxfp4_config,
    "bf16": fqt.bf16_config,
    "qaf": fqt.qaf_config,
    "nvfp4_pallas": fqt.nvfp4_paper_config,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-350m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--quant", default="nvfp4", choices=sorted(QUANT))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, export the packed serving "
                         "artifact, and resume from the latest checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--qaf-at", type=int, default=0,
                    help=">0: fixed-step QAF switch; 0: sqrt(3)-threshold "
                         "auto")
    ap.add_argument("--no-qaf", action="store_true")
    ap.add_argument("--log-json", default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameter init")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome-trace-event JSON of quant-health "
                         "telemetry (optimizer-step clock: per-layer "
                         "sqrt(3)-floor ratios, E4M3 scale saturation/"
                         "underflow, SR/RtN rounding tallies, one entry per "
                         "log_every steps) to PATH; open it in Perfetto")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tcfg = TrainConfig(
        opt=adamw.AdamWConfig(lr_peak=args.lr),
        sched=schedule.ScheduleConfig(peak_lr=args.lr,
                                      warmup_steps=args.warmup,
                                      total_steps=args.steps),
        remat=not args.smoke,
    )
    run_cfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, seed=args.seed,
        qaf=qaf.QAFConfig(enabled=not args.no_qaf,
                          auto_switch=args.qaf_at == 0,
                          fixed_switch_step=args.qaf_at),
    )
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(clock="step", process="train")
    trainer = Trainer(cfg, QUANT[args.quant](), tcfg, run_cfg, data_cfg,
                      tracer=tracer, device=args.device)
    trainer.run()
    if tracer is not None:
        tracer.export(args.trace)
        print(f"trace: {tracer.n_events} events "
              f"(clock=step, every {run_cfg.log_every} steps) -> "
              f"{args.trace} (open in Perfetto: ui.perfetto.dev)")
    for h in trainer.history[:: max(1, len(trainer.history) // 20)]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnr {h['gnr']:.2f}  lr {h['lr']:.2e}  dt {h['dt']*1e3:.0f}ms")
    print("summary:", json.dumps(trainer.summary(), default=str)[:2000])
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump({"history": trainer.history,
                       "events": trainer.events}, f)
    return trainer


if __name__ == "__main__":
    main()
