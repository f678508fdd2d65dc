"""Run a test module's JAX reference writer in subprocesses.

The port's parity tests hold the port to the JAX package computing what its
source states: XLA's CPU compiler, under ``jit``, drops f32 -> bf16 -> f32
round trips unless ``--xla_allow_excess_precision=false`` is given, and the
next GEMM's FP4 re-quantization turns each dropped rounding into flipped
codes (see tests/test_torch_serve.py).  The flag must be set before jax
initialises, hence the subprocess: ``python <module> OUT PART PARTS`` writes
part PART of PARTS of the reference (``run_jobs``).  The parts run at once
and their arrays are merged; most of a reference's time is XLA compiling
programs that share nothing, so they split without repeating work.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np


class Reference:
    """A test module's JAX reference, written by ``parts`` subprocesses
    that start at once; ``result()`` waits for them and merges their
    arrays, so the module's tests that need no reference run meanwhile."""

    def __init__(self, module_file: str, out_dir: Path, parts: int = 1):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_allow_excess_precision=false").strip()
        env["JAX_PLATFORMS"] = "cpu"
        src = str(Path(__file__).resolve().parents[1] / "src")
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        self.outs = [out_dir / f"part{part}.npz" for part in range(parts)]
        self.procs = []
        for part, out in enumerate(self.outs):
            log = open(out_dir / f"part{part}.log", "w+")
            self.procs.append((subprocess.Popen(
                [sys.executable, module_file, str(out), str(part),
                 str(parts)], env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        self.ref = None

    def result(self, timeout: int = 900) -> dict:
        if self.ref is None:
            ref = {}
            for out, (proc, log) in zip(self.outs, self.procs):
                rc = proc.wait(timeout=timeout)
                log.seek(0)
                assert rc == 0, log.read()[-4000:]
                with np.load(out) as f:
                    ref.update(f)
            self.ref = ref
        return self.ref

    def close(self) -> None:
        for proc, log in self.procs:
            proc.kill()
            proc.wait()
            log.close()


def run_jobs(jobs, out_path, part: int, parts: int) -> None:
    """Run ``jobs`` (callables that fill a dict; the longest first) and save
    what they wrote to ``out_path``.  With several parts each job goes to
    the first part to claim it (a file created exclusively beside
    ``out_path``), so the parts stay busy until the last job is taken."""
    ref = {}
    for i, job in enumerate(jobs):
        if parts > 1:
            try:
                os.close(os.open(Path(out_path).parent / f"job{i}.claim",
                                 os.O_CREAT | os.O_EXCL))
            except FileExistsError:
                continue
        job(ref)
    np.savez(out_path, **ref)


def padded(prompts) -> np.ndarray:
    """Prompts left-padded with token 0 to one length, as ``Engine`` pads."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


def jax_engine_stream(cfg, params, fmt, weights, prompts, max_new, max_len,
                      extras=None):
    """A JAX ``Engine`` stream (packed NVFP4 weights under ``qaf_config``,
    or bf16 weights under ``bf16_config``) and the greedy margins behind
    it: its logits teacher-forced through the Engine's compiled prefill and
    the registry's decode step, as tests/test_torch_serve.py takes them.
    ``extras``: the prefill's (encdec ``frames``, vlm ``prefix_embeds``).
    Runs in the reference subprocess."""
    extras = extras or {}
    import jax
    import jax.numpy as jnp
    from repro import serve as jserve
    from repro.core import fqt as jfqt
    from repro.distributed import sharding as shd
    from repro.models import registry as jreg
    from repro.serve import packing as jpack
    qcfg = jfqt.qaf_config() if weights == "nvfp4" else jfqt.bf16_config()
    # the packer under jit: the same bits as its eager run on these
    # configs, without compiling each of its ops anew for every shape
    w = (jax.jit(lambda p: jpack.pack_model_params(cfg, p, qcfg.fwd_w))(
        params) if weights == "nvfp4" else params)
    eng = jserve.Engine(cfg, w, jserve.ServeConfig(
        batch_size=len(prompts), max_len=max_len, kv_cache_format=fmt,
        decode_chunk=4), qcfg=qcfg, pack_weights=False)
    stream = np.stack(eng.generate(prompts, max_new=max_new, extras=extras))
    decode = jax.jit(jreg.decode_step, static_argnums=(1, 2))
    carry = shd.place_serve_cache(jreg.make_decode_state(
        cfg, len(prompts), max_len, kv_cache_format=fmt), eng.mesh)
    logits, carry = eng._prefill(eng._replicate(jnp.asarray(padded(prompts))),
                                 carry, extras)
    steps = [np.asarray(logits, np.float32)]
    for t in range(stream.shape[1] - 1):
        lg, carry = decode(eng.params, cfg, qcfg,
                           jnp.asarray(stream[:, t:t + 1]), carry)
        steps.append(np.asarray(lg[:, -1], np.float32))
    top2 = np.sort(np.stack(steps, axis=1), axis=-1)[..., -2:]
    return stream.astype(np.int32), top2[..., 1] - top2[..., 0]


def assert_stream(got, want, margins, where, tol=0.02) -> bool:
    """Greedy streams equal, or first apart at a step whose reference
    margin is below ``tol`` (a near-tie; after it the histories part and
    nothing more is held).  Returns whether they are equal."""
    n = min(len(got), len(want))
    diff = np.nonzero(np.asarray(got[:n]) != np.asarray(want[:n]))[0]
    if diff.size:
        assert margins[diff[0]] < tol, \
            f"{where}: differs at decisive step {diff[0]}"
        return False
    assert len(got) == len(want), where
    return True


def port_leaf(tree, name):
    """The port's tensor behind a reference leaf path such as
    ``['layers']['attn']['wq']``, the per-layer leaves stacked."""
    import torch
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    if keys[0] != "layers":
        return tree[keys[0]]
    out = []
    for lp in tree["layers"]:
        for k in keys[1:]:
            lp = lp[k]
        out.append(lp)
    return torch.stack(out)


def assert_card_loss_within_one_ulp(logits, targets, where):
    """The card's loss (``refnum.torch_nll``: torch's log_softmax and its
    backward) against the reference's order (``refnum.MeanNLL``, held to
    JAX bit for bit) on the same logits: the same value, and logit
    gradients at most one ulp of the logits' dtype apart."""
    import torch
    from repro_torch.models import refnum
    out = []
    for nll in (refnum.MeanNLL.apply, refnum.torch_nll):
        x = logits.detach().clone().requires_grad_(True)
        loss = nll(x, targets)
        loss.backward()
        out.append((loss.detach(), x.grad))
    (want, gw), (got, gg) = out
    assert torch.equal(got, want), where
    assert gg.dtype == gw.dtype == logits.dtype, where
    itype = {2: torch.int16, 4: torch.int32}[gg.element_size()]
    # adjacent values of one sign are adjacent integers; -0 counts as 0
    bits = [torch.where(g == 0, 0, g.view(itype).long()) for g in (gg, gw)]
    ulps = (bits[0] - bits[1]).abs().max().item()
    assert ulps <= 1, f"{where}: logit gradients {ulps} ulps apart"
