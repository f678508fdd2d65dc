"""The port's training slice against the JAX package, on the CPU.

``llama2-60m.smoke()`` (2 layers, d 128, vocab 512, attn_chunk 64) from the
same JAX-initialised parameters, carried across with ``repro_torch.convert``:
the data stream, the LR schedules, AdamW, the sqrt(3) monitor, the loss and
per-leaf grads (dense attention at seq 32, flash attention at seq 128, remat
on and off), three train steps from a carried ``TrainState``, the sigma_q
probe and the trainer's QAF switch.

The JAX reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, as in
``tests/test_torch_serve.py``: without it the jitted reference skips bf16
roundings its source states, and the FP4 re-quantization of the next GEMM
turns each into flipped codes.  With it the loss and every GEMM-weight
gradient of the dense branch come out bit-identical.  Running this file as
a script writes that reference (``python tests/test_torch_train.py
OUT.npz``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import fqt as jfqt
from repro.core import threshold as jthr
from repro.data import pipeline as jdata
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_jax_numpy, tensor_from_numpy,
                                 train_state_from_jax_numpy)
from repro_torch.core import fqt, qaf, threshold
from repro_torch.data import pipeline
from repro_torch.kernels import counters
from repro_torch.optim import adamw, schedule
from repro_torch.train import step as step_mod
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "llama2-60m"
BATCH = 2
SEQS = (32, 128)          # dense attention (32 * 32 <= 64^2), then flash
SEED = 0x1234ABCD                   # the loss_fn's SR seed
STEPS = 3
STEP_SEQ = 32
PROBE_STEP = 7
# Tolerances, each with its reason:
#  * the dense branch (seq 32): the loss and every GEMM-weight gradient are
#    bit-identical (held at rtol 1e-6 and relative L2 1e-6); the 1-D leaves
#    (norm weights, smooth-SwiGLU factors) are sums over B*S tokens of bf16
#    products, which XLA and torch reduce in another order and precision
#    (~1% seen) -> relative L2 3e-2.
#  * the flash branch (seq 128): its scores and exp() differ from XLA's by
#    an f32 ulp (attention alone agrees to 1e-5, see
#    test_attention_core_vs_jax), but a bf16 rounding that flips becomes,
#    through the next GEMM's FP4 re-quantization, a flipped code in one
#    token row (here batch 0, position 55, whose logits move by 0.45), and
#    that row's backward moves whole gradient leaves: up to 12% relative L2
#    seen against JAX, 36% between the port's own dense and flash attention
#    on the same input, 50-55% for another SR seed.  Loss -> rtol 1e-3,
#    every leaf -> relative L2 0.25.
#  * train steps (seq 32): the loss as the dense branch, and the parameter
#    update (new - old) per leaf at relative L2 3e-2.
LOSS_RTOL = {32: 1e-6, 128: 1e-3}
REL_L2 = {32: 3e-2, 128: 0.25}
DENSE_GEMM_REL_L2 = 1e-6


def _cfg():
    return jax_get_config(ARCH).smoke()


def _tokens(seq, step=0):
    ds = jdata.SyntheticLM(jdata.DataConfig(vocab_size=_cfg().vocab_size,
                                            seq_len=seq, global_batch=BATCH))
    return ds.batch(step)["tokens"]


def _tcfg_jax(probe_sigma=False):
    from repro.train.step import TrainConfig
    return TrainConfig(sched=jsched.ScheduleConfig(warmup_steps=2,
                                                   total_steps=10),
                       remat=True, probe_sigma=probe_sigma)


def _tcfg_port(probe_sigma=False):
    return step_mod.TrainConfig(
        sched=schedule.ScheduleConfig(warmup_steps=2, total_steps=10),
        remat=True, probe_sigma=probe_sigma)


def _flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf,
                                                               np.float32)


def write_jax_reference(out_path):
    """Loss and grads per (seq, remat), three train steps from a fresh
    TrainState, and the sigma_q probe."""
    from repro.train import step as jstep
    cfg = _cfg()
    params = jreg.init_params(cfg, jax.random.PRNGKey(0))
    ref = {"checksum": _checksum(params)}
    qcfg = jfqt.nvfp4_paper_config()
    for seq in SEQS:
        # remat=True: jax.checkpoint recomputes the same ops, so the
        # reference's values do not depend on it (the port is held to them
        # with remat on and off)
        toks = jnp.asarray(_tokens(seq))
        fn = jax.jit(jax.value_and_grad(
            lambda p: jreg.loss_fn(p, cfg, qcfg, {"tokens": toks},
                                   seed=jnp.uint32(SEED), remat=True)[0]))
        loss, grads = fn(params)
        ref[f"loss/{seq}"] = np.float32(loss)
        _flat(f"grads/{seq}", grads, ref)
        if seq == SEQS[-1]:
            ref["sigma_q"] = np.float32(jax.jit(jstep._estimate_sigma_q)(
                grads, jnp.int32(PROBE_STEP)))
    # three steps from a fresh state (probe off: its threefry draws are a
    # declared divergence; the probe is held separately above)
    state = jstep.init_state(cfg, _tcfg_jax(), jax.random.PRNGKey(0))
    train_step = jstep.make_train_step(cfg, qcfg, _tcfg_jax())
    for i in range(STEPS):
        state, m = train_step(state, {"tokens": jnp.asarray(
            _tokens(STEP_SEQ, i))})
        for k in ("loss", "grad_norm", "lr"):
            ref[f"step{i}/{k}"] = np.float32(m[k])
    _flat("params", state.params, ref)
    np.savez(out_path, **ref)


def _checksum(params) -> float:
    return float(sum(np.asarray(leaf, np.float64).sum() for leaf in
                     jax.tree_util.tree_leaves(params)))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train_ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, __file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def jparams():
    return jreg.init_params(_cfg(), jax.random.PRNGKey(0))


def _port_params(jparams):
    return params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 get_config(ARCH).smoke(), device="cpu")


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _port_leaf(tree, name):
    """The port's tensor(s) behind a reference leaf path such as
    ``['layers']['attn']['wq']``, stacked over layers like the reference."""
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    if keys[0] == "layers":
        leaves = []
        for lp in tree["layers"]:
            t = lp
            for k in keys[1:]:
                t = t[k]
            leaves.append(t)
        return torch.stack(leaves)
    t = tree
    for k in keys:
        t = t[k]
    return t


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    g = got.detach().to(torch.float32).numpy()
    return float(np.linalg.norm(g - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---- host-side pieces, in-process -------------------------------------------------


def test_data_batches_bit_identical():
    for kw in ({}, {"seed": 7, "zipf_a": 1.1, "markov_mix": 0.5}):
        jc = jdata.DataConfig(vocab_size=512, seq_len=24, global_batch=4,
                              **kw)
        tc = pipeline.DataConfig(vocab_size=512, seq_len=24, global_batch=4,
                                 **kw)
        jd, td = jdata.SyntheticLM(jc), pipeline.SyntheticLM(tc)
        for step, host in ((0, 0), (5, 0), (3, 1), (-1, 0)):
            want = jd.batch(step, host_id=host, num_hosts=2)["tokens"]
            got = td.batch(step, host_id=host, num_hosts=2)["tokens"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qaf_phase", [False, True])
def test_lr_at_matches(qaf_phase):
    """f32 on both sides; cos() may differ by one f32 ulp -> rtol 1e-6."""
    jc = jsched.ScheduleConfig(peak_lr=3e-4, warmup_steps=5, total_steps=40)
    tc = schedule.ScheduleConfig(peak_lr=3e-4, warmup_steps=5, total_steps=40)
    if qaf_phase:
        jc = jsched.qaf_schedule(jc, 24, 0.5, start_step=13)
        tc = schedule.qaf_schedule(tc, 24, 0.5, start_step=13)
        assert jc == jsched.ScheduleConfig(**tc.__dict__)
    for step in range(0, 50, 3):
        want = np.float32(jsched.lr_at(step, jc))
        got = schedule.lr_at(step, tc)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_adamw_apply_matches():
    """Two clipped AdamW steps on a bf16 and an f32 leaf: the updated bf16
    params equal, master and moments to f32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(4)
    import ml_dtypes
    p = {"w": rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16),
         "b": rng.standard_normal((16,)).astype(np.float32)}
    jcfg = jadamw.AdamWConfig(clip_norm=1.0)
    tcfg = adamw.AdamWConfig(clip_norm=1.0)
    js = jadamw.init(jax.tree_util.tree_map(jnp.asarray, p), jcfg)
    tp = {k: tensor_from_numpy(v, "cpu") for k, v in p.items()}
    ts = adamw.init(tp, tcfg)
    for i, lr in enumerate((1e-3, 5e-4)):
        g = {"w": (rng.standard_normal((8, 16)) * 3).astype(
            ml_dtypes.bfloat16),
            "b": (rng.standard_normal((16,)) * 3).astype(np.float32)}
        jp, js, jm = jadamw.apply(jax.tree_util.tree_map(jnp.asarray, g), js,
                                  jcfg, jnp.float32(lr))
        tp, ts, tm = adamw.apply({k: tensor_from_numpy(v, "cpu")
                                  for k, v in g.items()}, ts, tcfg,
                                 torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in p:
            assert tp[k].dtype == tensor_from_numpy(p[k], "cpu").dtype
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=1e-6, atol=0)
            for got, want in ((ts.master[k], js.master[k]),
                              (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12)
    assert ts.step == int(js.step) == 2


def test_threshold_update_matches():
    """Twelve updates whose EMA falls under sqrt(3) before min_steps: the
    EMA to f32 rounding, the crossing at the same step."""
    cfg = jthr.ThresholdConfig()
    tcfg = threshold.ThresholdConfig()
    js, ts = jthr.init(), threshold.init("cpu")
    rng = np.random.default_rng(5)
    for i in range(12):
        gn = np.float32((3.0 if i < 2 else 0.05) + rng.random() * 0.01)
        sq = np.float32(0.03 * (1 + 0.01 * rng.random()))
        js = jthr.update(js, jnp.float32(gn), 1000, jnp.float32(sq), cfg)
        ts = threshold.update(ts, torch.tensor(gn), 1000, torch.tensor(sq),
                              tcfg)
        np.testing.assert_allclose(float(ts.ratio_ema), float(js.ratio_ema),
                                   rtol=1e-6)
        assert bool(ts.crossed) == bool(js.crossed) and ts.step == int(
            js.step)
    assert bool(ts.crossed)


def test_qaf_config_and_switch_rule():
    assert qaf.qaf_quant_config(fqt.nvfp4_paper_config()) == fqt.qaf_config()
    cfg = qaf.QAFConfig(auto_switch=False, fixed_switch_step=2)
    assert [qaf.should_switch(s, False, cfg) for s in range(4)] == \
        [False, False, True, True]
    assert qaf.should_switch(0, True, qaf.QAFConfig())
    assert not qaf.should_switch(9, True, qaf.QAFConfig(enabled=False))


@pytest.mark.parametrize("chunk", [64, 4096])
def test_attention_core_vs_jax(chunk):
    """Training attention alone, bf16 q/k/v (GQA): chunk 64 takes the flash
    branch and its custom backward, chunk 4096 the dense branch.  Output and
    dq/dk/dv within relative L2 1e-4 (f32 sums in another order, then one
    bf16 rounding: ~1e-5 seen)."""
    import ml_dtypes
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(6)
    B, S, H, KVH, D = 2, 128, 4, 2, 32
    q, g = (rng.standard_normal((B, S, H, D)).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    k, v = (rng.standard_normal((B, S, KVH, D)).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    pos = np.arange(S, dtype=np.int32)

    def jfn(q, k, v):
        return jlayers.attention_core(q, k, v, qpos=jnp.asarray(pos),
                                      kpos=jnp.asarray(pos), causal=True,
                                      chunk=chunk)
    out, pull = jax.vjp(jax.jit(jfn), jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    want = [out] + list(pull(jnp.asarray(g)))
    tq, tk, tv = (tensor_from_numpy(a, "cpu").requires_grad_(True)
                  for a in (q, k, v))
    o = layers.attention_core(tq, tk, tv, qpos=torch.from_numpy(pos),
                              kpos=torch.from_numpy(pos), causal=True,
                              chunk=chunk)
    got = [o] + list(torch.autograd.grad(o, (tq, tk, tv),
                                         tensor_from_numpy(g, "cpu")))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        err = _rel_l2(a, np.asarray(b, np.float32))
        assert err <= 1e-4, f"{name}: relative L2 {err:.3g}"


# ---- against the JAX reference subprocess ------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seq", SEQS)
def test_loss_and_grads_match_jax(jax_ref, jparams, seq, remat):
    """seq 32 takes the dense attention branch, seq 128 the flash branch
    with its custom backward; the port's remat is a torch.utils.checkpoint
    per layer."""
    assert jax_ref["checksum"] == _checksum(jparams), \
        "the reference subprocess initialised other parameters"
    cfg = get_config(ARCH).smoke()
    loss, _, grads = step_mod.loss_and_grads(
        _port_params(jparams), cfg, fqt.nvfp4_paper_config(),
        {"tokens": torch.from_numpy(_tokens(seq))}, seed=SEED, remat=remat)
    np.testing.assert_allclose(float(loss), jax_ref[f"loss/{seq}"],
                               rtol=LOSS_RTOL[seq])
    prefix = f"grads/{seq}"
    names = [k[len(prefix):] for k in jax_ref if k.startswith(prefix)]
    assert len(names) == 3 + 4 + 2 + 4      # embed lm_head ln_f; layers
    for name in names:
        got = _port_leaf(grads, name)
        want = jax_ref[prefix + name]
        assert tuple(got.shape) == want.shape, name
        err = _rel_l2(got, want)
        gemm_weight = want.ndim == 3       # stacked (L, K, N) weights
        tol = DENSE_GEMM_REL_L2 if (seq == 32 and gemm_weight) \
            else REL_L2[seq]
        assert err <= tol, f"{name}: relative L2 error {err:.3g} > {tol}"


def test_three_train_steps_match_jax(jax_ref, jparams):
    """Three steps from the reference's TrainState carried across with
    ``train_state_from_jax_numpy``: loss, grad_norm and lr per step, and
    each leaf's parameter update after the third step."""
    from repro.train import step as jstep
    cfg = get_config(ARCH).smoke()
    jstate = jstep.init_state(_cfg(), _tcfg_jax(), jax.random.PRNGKey(0))
    state = train_state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), cfg, device="cpu")
    assert state.step == 0 and state.opt.step == 0 and state.thr.step == 0
    start = _port_params(jparams)
    train_step = step_mod.make_train_step(cfg, fqt.nvfp4_paper_config(),
                                          _tcfg_port())
    for i in range(STEPS):
        state, m = train_step(state, {"tokens": torch.from_numpy(
            _tokens(STEP_SEQ, i))})
        np.testing.assert_allclose(float(m["loss"]), jax_ref[f"step{i}/loss"],
                                   rtol=LOSS_RTOL[STEP_SEQ])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   jax_ref[f"step{i}/grad_norm"],
                                   rtol=REL_L2[STEP_SEQ])
        np.testing.assert_allclose(float(m["lr"]), jax_ref[f"step{i}/lr"],
                                   rtol=1e-6)
    assert state.step == STEPS and state.opt.step == STEPS
    names = [k[len("params"):] for k in jax_ref if k.startswith("params")]
    assert len(names) == 13
    for name in names:
        old = _port_leaf(start, name).float()
        got = _port_leaf(state.params, name).float() - old
        want = jax_ref["params" + name] - old.numpy()
        err = _rel_l2(got, want)
        assert err <= REL_L2[STEP_SEQ], \
            f"{name}: update relative L2 {err:.3g}"


def test_sigma_q_probe_rms_matches_jax(jax_ref):
    """The probe's SR draws differ (counter_bits, not threefry: a declared
    divergence); its RMS residual over the same gradients agrees within
    2%."""
    prefix = f"grads/{SEQS[-1]}"
    cfg = get_config(ARCH).smoke()
    tree = {"embed": None, "lm_head": None, "ln_f": None,
            "layers": [{"attn": {}, "mlp": {}} for _ in range(cfg.n_layers)]}
    for key, a in jax_ref.items():
        if not key.startswith(prefix):
            continue
        keys = [k.strip("'") for k in key[len(prefix):].strip("[]")
                .split("][")]
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                node = tree["layers"][i]
                for k in keys[1:-1]:
                    node = node[k]
                node[keys[-1]] = torch.from_numpy(a[i].copy())
        else:
            tree[keys[0]] = torch.from_numpy(a.copy())
    got = float(step_mod._estimate_sigma_q(tree, PROBE_STEP))
    want = float(jax_ref["sigma_q"])
    assert abs(got - want) <= 0.02 * want, (got, want)


def test_trainer_qaf_switch_matches_jax():
    """A fixed QAF switch at step 2: the port's Trainer switches where the
    reference's Trainer does (its first step with ``qaf.should_switch``)
    and then follows the reference's re-warmed LR schedule."""
    from repro.core import qaf as jqaf
    jcfg = jqaf.QAFConfig(auto_switch=False, fixed_switch_step=2)
    want_switch = next(s for s in range(4)
                       if jqaf.should_switch(s, False, jcfg))
    jtc = _tcfg_jax()
    want_lr = [np.float32(jsched.lr_at(s, jtc.sched if s <= want_switch else
                                       jqaf.qaf_lr_schedule(
                                           jtc.sched, jcfg, want_switch + 1)))
               for s in range(4)]
    cfg = get_config(ARCH).smoke()
    trainer = Trainer(cfg, fqt.nvfp4_paper_config(), _tcfg_port(),
                      TrainerConfig(total_steps=4, qaf=qaf.QAFConfig(
                          auto_switch=False, fixed_switch_step=2)),
                      pipeline.DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=BATCH),
                      device="cpu")
    trainer.run()
    switches = [e["step"] for e in trainer.events if e["kind"] == "qaf_switch"]
    assert switches == [want_switch]
    np.testing.assert_allclose([h["lr"] for h in trainer.history], want_lr,
                               rtol=1e-6)
    s = trainer.summary()
    assert s["qaf"] and s["steps"] == 4 and np.isfinite(s["final_loss"])


def test_unported_trainer_options_raise():
    """Trainer(mesh=) trains every family (tests/test_torch_train_mesh.py,
    tests/test_torch_mesh_families.py,
    tests/test_torch_mesh_encdec_recurrent.py): the hybrid family, once
    refused a multi-rank mesh, builds its train step at tp=2; what the
    Trainer's gate still refuses, before any collective, is a mesh its
    heads do not split over (here 6 SSM heads at tp=4), naming them."""
    import dataclasses
    from repro_torch.distributed.mesh import Mesh
    cfg = get_config("zamba2-1.2b").smoke()
    cpu = torch.device("cpu")
    assert callable(step_mod.make_train_step(
        cfg, fqt.nvfp4_paper_config(), _tcfg_port(),
        Mesh((2,), ("model",), device=cpu)))
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                               global_batch=2)
    with pytest.raises(ValueError, match="6 SSM heads do not split"):
        Trainer(dataclasses.replace(cfg, n_ssm_heads=6),
                fqt.nvfp4_paper_config(), _tcfg_port(), TrainerConfig(),
                data, device="cpu", mesh=Mesh((4,), ("model",), device=cpu))


def test_train_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    cfg = get_config(ARCH).smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                               global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, fqt.nvfp4_paper_config(), _tcfg_port(), TrainerConfig(),
                data)
    with pytest.raises(RuntimeError, match="CUDA"):
        step_mod.init_state(cfg, _tcfg_port())
    from repro_torch.launch import train as launch
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "llama2-60m", "--smoke", "--steps", "1"])


def test_launch_train_on_cpu(capsys):
    from repro_torch.launch import train as launch
    trainer = launch.main(["--arch", "llama2-60m", "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--quant",
                           "nvfp4_pallas", "--device", "cpu"])
    assert len(trainer.history) == 2
    assert trainer.qcfg == fqt.nvfp4_paper_config()
    assert "summary:" in capsys.readouterr().out


if __name__ == "__main__":
    write_jax_reference(sys.argv[1])
