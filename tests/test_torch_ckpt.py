"""The port's checkpoint/restart, packed serving export and trainer
telemetry against the JAX package, on the CPU.

``llama2-60m.smoke()`` (2 layers, d 128, vocab 512) at batch 2 x seq 32
(the dense attention branch, where loss and GEMM-weight grads match the
reference bit for bit):

  * ``checkpoint.ckpt`` as ``tests/test_checkpoint.py`` holds the
    reference's: round trip, ``LATEST`` and GC, idempotent re-save,
    structure mismatch;
  * the on-disk format across packages, both ways, for a ``TrainState`` and
    a packed serving tree, bit for bit;
  * the port's restart (and its SIGTERM preemption) equal to its
    uninterrupted run bit for bit, as ``tests/test_system.py`` holds the
    reference's; the exported artifact serving the same greedy stream as
    ``Engine`` from the final parameters;
  * a restart across a fixed QAF switch, whose events and LRs equal the JAX
    ``Trainer``'s, with a tracer on the restarted run whose trace equals the
    JAX trainer's in names, tracks, timestamps and counter values, the
    gauges within the tolerances of ``tests/test_torch_train.py``;
  * ``export_serving_artifact`` from the same parameters equal to JAX's,
    and ``quantize.scale_health`` equal to JAX's;
  * ``launch.train --ckpt-dir --trace`` and ``launch.serve --ckpt-dir``.

The JAX side runs in one subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (see
``tests/test_torch_train.py``); running this file as a script writes its
results (``python tests/test_torch_ckpt.py OUT_DIR PORT_DIR``).
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.core import quantize as jquant
from repro.models import registry as jreg
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_jax_numpy,
                                 train_state_from_jax_numpy)
from repro_torch.core import fqt, qaf
from repro_torch.core import quantize as tquant
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import counters
from repro_torch.obs import Tracer, load_trace, validate_events
from repro_torch.optim import schedule
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.packing import pack_model_params
from repro_torch.train import TrainConfig, Trainer, TrainerConfig
from repro_torch.train import step as step_mod

torch.set_num_threads(1)

ARCH = "llama2-60m"
BATCH, SEQ = 2, 32
STATE_STEP = 5               # the step of the cross-package TrainState
# the QAF scenario: a fixed switch after step 1, the first run stops after
# two steps (checkpoint at 2), the restarted one runs to 4 with a tracer
QAF_AT, FIRST, TOTAL = 1, 2, 4
# tolerances of tests/test_torch_train.py: the loss of the dense branch to
# rtol 1e-6, grad norms (and so every ratio gauge and the EMA) to relative
# 3e-2; the sigma_q probe's RMS within 2% (its SR draws are a declared
# divergence)
LOSS_RTOL, REL, SIGMA_RTOL = 1e-6, 3e-2, 2e-2


def _jcfg():
    return jax_get_config(ARCH).smoke()


def _cfg():
    return get_config(ARCH).smoke()


def _data_kw():
    return dict(vocab_size=_cfg().vocab_size, seq_len=SEQ,
                global_batch=BATCH)


def _qaf_kw():
    return dict(auto_switch=False, fixed_switch_step=QAF_AT)


def _jax_state():
    """A reference TrainState with every leaf non-trivial: JAX-initialised
    parameters, master weights, seeded moments and a threshold state."""
    from repro.core import threshold as jthr
    from repro.train import step as jstep
    st = jstep.init_state(_jcfg(), jstep.TrainConfig(),
                          jax.random.PRNGKey(0))
    leaves, tdef = jax.tree_util.tree_flatten(st.opt.m)
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * len(leaves))
    m = [jax.random.normal(km, x.shape, x.dtype) * 1e-3
         for km, x in zip(keys, leaves)]
    v = [jnp.abs(jax.random.normal(kv, x.shape, x.dtype)) * 1e-6
         for kv, x in zip(keys[len(leaves):], leaves)]
    opt = st.opt._replace(step=jnp.int32(STATE_STEP),
                          m=jax.tree_util.tree_unflatten(tdef, m),
                          v=jax.tree_util.tree_unflatten(tdef, v))
    thr = jthr.ThresholdState(jnp.float32(2.5), jnp.float32(1e-4),
                              jnp.int32(STATE_STEP), jnp.asarray(True))
    return st._replace(step=jnp.int32(STATE_STEP), opt=opt, thr=thr)


MOE = "mixtral-8x7b"        # a moe tree: router, stacked experts, one per layer


def _jax_moe_params():
    return jreg.init_params(jax_get_config(MOE).smoke(),
                            jax.random.PRNGKey(2))


def _port_tree(name):
    """The port's tree behind a cross-package checkpoint ``name``."""
    if name.startswith("moe"):
        cfg = get_config(MOE).smoke()
        tree = params_from_jax_numpy(jax.tree_util.tree_map(
            np.asarray, _jax_moe_params()), cfg, device="cpu")
        return (pack_model_params(cfg, tree, tquant.NVFP4)
                if name == "moe packed" else tree)
    st = _port_state()
    return st if name == "state" else pack_model_params(
        _cfg(), st.params, tquant.NVFP4)


# the cross-package checkpoints: a TrainState, its packed params, and a moe
# model's params, plain and packed
CROSS = ("state", "packed", "moe", "moe packed")


def _jax_tcfg():
    from repro.optim import schedule as jsched
    from repro.train import TrainConfig as JTC
    return JTC(sched=jsched.ScheduleConfig(warmup_steps=2, total_steps=10),
               remat=False)


def _port_tcfg():
    return TrainConfig(sched=schedule.ScheduleConfig(warmup_steps=2,
                                                     total_steps=10),
                       remat=False)


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (float8 as uint8, bf16 as uint16)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "biu":
        return a.view(np.uint8)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _port_bits(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x, np.int32)
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        x = x.view(torch.uint8)
    elif x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.cpu().numpy()


def _jax_trees_equal(a, b) -> bool:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def assert_port_trees_equal(a, b):
    la, lb = ckpt.reference_leaves(a), ckpt.reference_leaves(b)
    assert [n for n, _, _ in la] == [n for n, _, _ in lb]
    for (name, pa, _), (_, pb, _) in zip(la, lb):
        for x, y in zip(pa, pb):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                assert x.device == y.device, name
            assert np.array_equal(_port_bits(x), _port_bits(y)), name


# ---- the JAX reference, in a subprocess ---------------------------------------


def write_jax_reference(out: Path, port: Path):
    """Checkpoints of the reference, the reference restoring the port's,
    the QAF restart scenario with its trace, and an export."""
    from repro.core import fqt as jfqt
    from repro.core import qaf as jqaf
    from repro.data.pipeline import DataConfig as JDC
    from repro.obs import Tracer as JTracer
    from repro.serve.packing import pack_model_params as jpack
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    cfg, st = _jcfg(), _jax_state()
    packed = jpack(cfg, st.params, jquant.NVFP4)
    moe = _jax_moe_params()
    report = {}
    for name, tree in (("state", st), ("packed", packed), ("moe", moe),
                       ("moe packed", jpack(jax_get_config(MOE).smoke(),
                                            moe, jquant.NVFP4))):
        jckpt.save(str(out / name), STATE_STEP, tree)
        report[f"port_{name}_restores"] = _jax_trees_equal(
            jckpt.restore(str(port / name), STATE_STEP, tree), tree)

    def trainer(total, tracer=None):
        return JTrainer(cfg, jfqt.nvfp4_paper_config(), _jax_tcfg(),
                        JTrainerConfig(total_steps=total, ckpt_every=100,
                                       ckpt_dir=str(out / "qaf"),
                                       log_every=1,
                                       qaf=jqaf.QAFConfig(**_qaf_kw())),
                        JDC(**_data_kw()), tracer=tracer)
    first = trainer(FIRST)
    first.run(jax.random.PRNGKey(0))
    trc = JTracer(clock="step", process="train")
    second = trainer(TOTAL, trc)
    second.run(jax.random.PRNGKey(0))
    trc.export(str(out / "trace.json"))
    report["runs"] = [{"events": t.events,
                       "lr": [h["lr"] for h in t.history],
                       "loss": [h["loss"] for h in t.history]}
                      for t in (first, second)]
    JTrainer(cfg, jfqt.nvfp4_paper_config(), _jax_tcfg(),
             JTrainerConfig(ckpt_dir=str(out / "export")), JDC(
                 **_data_kw())).export_serving_artifact(st)
    with open(out / "report.json", "w") as f:
        json.dump(report, f, default=float)


def _port_state():
    return train_state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, _jax_state()), _cfg(),
        device="cpu")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The port writes its checkpoints first; the subprocess writes the
    reference's and restores the port's."""
    out = tmp_path_factory.mktemp("jax_ckpt_ref")
    port = tmp_path_factory.mktemp("port_ckpt")
    for name in CROSS:
        ckpt.save(str(port / name), STATE_STEP, _port_tree(name))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, __file__, str(out), str(port)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out / "report.json") as f:
        return out, json.load(f)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


# ---- ckpt alone (tests/test_checkpoint.py) ------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 32), generator=g),
            "b": torch.zeros((32,), dtype=torch.bfloat16),
            "s": torch.randn((4, 16), generator=g).to(torch.float8_e4m3fn),
            "step": 7,
            "nested": {"m": torch.randn((4, 8), generator=g),
                       "flag": torch.ones((), dtype=torch.bool)},
            "layers": [{"a": torch.randn((3, 2), generator=g)}
                       for _ in range(3)]}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored = ckpt.restore(str(tmp_path), 5, _tree(seed=1))
    assert_port_trees_equal(restored, t)
    assert restored["step"] == 7 and list(restored) == list(t)
    with np.load(tmp_path / "step_00000005" / "shard_0.npz") as f:
        names = [n for n, _, _ in ckpt.reference_leaves(t)]
        assert names[:3] == ["['b']", "['layers']['a']", "['nested']['flag']"]
        assert f["leaf_1"].shape == (3, 3, 2)        # stacked layers
        assert f["leaf_0"].dtype == np.uint16        # bf16 as its bits
        assert f["leaf_5"].dtype == np.int32 and f["leaf_5"].shape == ()


def test_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, t, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.restore_latest(str(tmp_path / "none"), t) == (None, None)


def test_idempotent_resave(tmp_path):
    t = _tree()
    p1 = ckpt.save(str(tmp_path), 9, t)
    p2 = ckpt.save(str(tmp_path), 9, _tree(seed=3))  # end-of-run re-save
    assert p1 == p2 and ckpt.latest_step(str(tmp_path)) == 9
    assert_port_trees_equal(ckpt.restore(str(tmp_path), 9, t), t)


def test_structure_mismatch_raises(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, {"only": t["w"]})
    bad = dict(t, w=torch.zeros((16, 31)))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, bad)


# ---- across packages ------------------------------------------------------------


@pytest.mark.parametrize("name", CROSS)
def test_jax_checkpoint_restores_in_port(jax_ref, name):
    """The reference's checkpoints restore in the port bit for bit; a moe
    tree's router, stacked (E, d, f) experts and their packed form (one
    tensor scale per expert) take the reference's leaf order and names."""
    out, _ = jax_ref
    want = _port_tree(name)
    with open(out / name / f"step_{STATE_STEP:08d}" / "meta.json") as f:
        n = json.load(f)["n_leaves"]
    assert n == len(ckpt.reference_leaves(want))
    assert_port_trees_equal(
        ckpt.restore(str(out / name), STATE_STEP, want), want)


@pytest.mark.parametrize("name", CROSS)
def test_port_checkpoint_restores_in_jax(jax_ref, name):
    assert jax_ref[1][f"port_{name}_restores"]


def test_export_equals_jax_export(jax_ref):
    """export_serving_artifact from the same parameters: the same leaves,
    bit for bit, in the same files."""
    out, _ = jax_ref
    st = _port_state()
    d = out.parent / "port_export"
    tr = Trainer(_cfg(), fqt.nvfp4_paper_config(), _port_tcfg(),
                 TrainerConfig(ckpt_dir=str(d)), DataConfig(**_data_kw()),
                 device="cpu")
    tr.export_serving_artifact(st)
    assert tr.events == [{"kind": "export_packed", "step": STATE_STEP}]
    sub = f"serve_packed/step_{STATE_STEP:08d}"
    with np.load(d / sub / "shard_0.npz") as got, \
            np.load(out / "export" / sub / "shard_0.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(d / sub / "meta.json") as f, \
            open(out / "export" / sub / "meta.json") as g:
        assert json.load(f)["leaves"] == json.load(g)["leaves"]


# ---- restart, preemption, serving the export -------------------------------------


def _trainer(total, ckpt_dir=None, tracer=None, every=2, qaf_kw=None):
    return Trainer(_cfg(), fqt.nvfp4_paper_config(), _port_tcfg(),
                   TrainerConfig(total_steps=total, ckpt_every=every,
                                 ckpt_dir=ckpt_dir, log_every=1,
                                 qaf=qaf.QAFConfig(**(qaf_kw or {}))),
                   DataConfig(**_data_kw()), tracer=tracer, device="cpu")


@pytest.fixture(scope="module")
def straight():
    t = _trainer(4)
    return t.run(), t.history


def _assert_same_run(state, history, straight, steps):
    s_state, s_hist = straight
    assert_port_trees_equal(state, s_state)
    for h in history:
        want = s_hist[h["step"]]
        assert [h[k] for k in ("loss", "grad_norm")] == \
            [want[k] for k in ("loss", "grad_norm")]
    assert [h["step"] for h in history] == steps


def test_restart_equals_uninterrupted_run(straight, tmp_path):
    ck = str(tmp_path / "ck")
    first = _trainer(2, ck)
    first.run()
    assert first.events == [{"kind": "export_packed", "step": 2}]
    second = _trainer(4, ck)
    state = second.run()
    assert second.events[0] == {"kind": "restore", "step": 2}
    assert state.step == state.opt.step == state.thr.step == 4
    _assert_same_run(state, second.history, straight, [2, 3])
    assert sorted(os.listdir(ck)) == ["LATEST", "serve_packed",
                                      "step_00000002", "step_00000004"]


def test_sigterm_preempts_checkpoints_and_resumes(straight, tmp_path):
    """The installed SIGTERM handler, invoked during step 1: the loop stops
    at the next boundary with a preempt event, checkpoints step 2 and
    exports; the resumed run equals the uninterrupted one."""
    ck = str(tmp_path / "ck")
    tr = _trainer(4, ck, every=100)
    batch = tr.data.batch

    def batch_then_sigterm(step, *a, **kw):
        if step == 1:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler)
            handler(signal.SIGTERM, None)
        return batch(step, *a, **kw)
    tr.data.batch = batch_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    state = tr.run()
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 2
    assert tr.events == [{"kind": "preempt", "step": 2},
                         {"kind": "export_packed", "step": 2}]
    assert ckpt.latest_step(ck) == 2
    resumed = _trainer(4, ck, every=100)
    state = resumed.run()
    assert resumed.events[0] == {"kind": "restore", "step": 2}
    _assert_same_run(state, resumed.history, straight, [2, 3])


def test_exported_artifact_serves_the_final_params(straight, tmp_path):
    """The serve_packed checkpoint of a run restores into the packed tree
    of its final parameters bit for bit, and a pack_weights=False Engine on
    it serves the stream Engine serves from the final parameters, greedy
    margins included."""
    ck = str(tmp_path / "ck")
    state = _trainer(4, ck).run()
    cfg = _cfg()
    spec = qaf.qaf_quant_config(fqt.nvfp4_paper_config()).fwd_w
    want = pack_model_params(cfg, state.params, spec)
    step, artifact = ckpt.restore_latest(os.path.join(ck, "serve_packed"),
                                         want)
    assert step == 4
    assert_port_trees_equal(artifact, want)
    scfg = ServeConfig(batch_size=2, max_len=48, kv_cache_format="nvfp4")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(2)]
    served = Engine(cfg, artifact, scfg, pack_weights=False, device="cpu")
    direct = Engine(cfg, state.params, scfg, device="cpu")
    a = served.generate(prompts, max_new=8)
    b = direct.generate(prompts, max_new=8)
    assert [x.tolist() for x in a] == [x.tolist() for x in b]
    np.testing.assert_array_equal(np.asarray(served.margins),
                                  np.asarray(direct.margins))


# ---- the QAF restart and the trace, against the JAX Trainer ------------------------


@pytest.fixture(scope="module")
def qaf_runs(tmp_path_factory):
    """The QAF scenario of the reference subprocess, in the port, from the
    reference's initial state carried across."""
    from repro.train import step as jstep
    ck = str(tmp_path_factory.mktemp("port_qaf"))
    init = train_state_from_jax_numpy(jax.tree_util.tree_map(
        np.asarray, jstep.init_state(_jcfg(), _jax_tcfg(),
                                     jax.random.PRNGKey(0))), _cfg(),
        device="cpu")
    first = _trainer(FIRST, ck, every=100, qaf_kw=_qaf_kw())
    first.run(init)
    trc = Tracer(clock="step", process="train")
    second = _trainer(TOTAL, ck, tracer=trc, every=100, qaf_kw=_qaf_kw())
    assert second.tcfg.layer_stats           # turned on by the live tracer
    second.run(init)
    return first, second, trc


def test_qaf_restart_matches_jax_trainer(jax_ref, qaf_runs):
    """The switch is not checkpointed (the reference's in_qaf): the
    restarted run takes its first step with the pre-train config, switches
    again and re-warms the LR from there, event for event and LR for LR."""
    runs = jax_ref[1]["runs"]
    for want, got in zip(runs, qaf_runs[:2]):
        ev = [{k: v for k, v in e.items() if k != "gnr"} for e in got.events]
        assert ev == [{k: v for k, v in e.items() if k != "gnr"}
                      for e in want["events"]]
        for e, w in zip(got.events, want["events"]):
            if "gnr" in w:
                np.testing.assert_allclose(e["gnr"], w["gnr"], rtol=REL)
        np.testing.assert_allclose([h["lr"] for h in got.history],
                                   want["lr"], rtol=1e-6)
        np.testing.assert_allclose([h["loss"] for h in got.history],
                                   want["loss"], rtol=LOSS_RTOL)
    kinds = [e["kind"] for e in qaf_runs[1].events]
    assert kinds == ["restore", "qaf_switch", "export_packed"]


def _gauge_rtol(name: str) -> float:
    if name == "loss":
        return LOSS_RTOL
    return SIGMA_RTOL if name == "sigma_q" else REL


def test_trace_matches_jax_trainer(jax_ref, qaf_runs):
    want = load_trace(str(jax_ref[0] / "trace.json"))
    trc = qaf_runs[2]
    got = trc.trace_events()
    assert validate_events(got) == []
    key = [(e["ph"], e["name"], e["ts"], e.get("tid"), e.get("cat"))
           for e in want]
    assert [(e["ph"], e["name"], e["ts"], e.get("tid"), e.get("cat"))
            for e in got] == key
    n_leaves = len(ckpt.reference_leaves(_port_state().params))
    ratios = [e for e in got if e["name"].startswith("ratio")]
    assert len(ratios) == n_leaves * (TOTAL - FIRST)
    for g, w in zip(got, want):
        if g["ph"] != "C":
            assert g.get("args") == w.get("args"), g["name"]
        elif g["name"] in trc.gauges:
            np.testing.assert_allclose(g["args"][g["name"]],
                                       w["args"][w["name"]],
                                       rtol=_gauge_rtol(g["name"]),
                                       err_msg=g["name"])
        else:
            assert g["args"] == w["args"], g["name"]
    c = trc.counters
    assert c.get("rounding_sr_points") > 0 and c.get("scale_blocks") > 0


def test_tracer_off_keeps_layer_stats_off():
    tr = _trainer(1)
    assert not tr.tcfg.layer_stats
    batch = {"tokens": torch.from_numpy(tr.data.batch(0)["tokens"])}
    _, metrics = step_mod.make_train_step(
        _cfg(), fqt.nvfp4_paper_config(), _port_tcfg())(_port_state(), batch)
    assert "layer_gnorms" not in metrics


# ---- scale_health --------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(scale_fmt="e4m3", block=16, two_level=True),      # NVFP4
    dict(scale_fmt="e4m3", block=16, two_level=False),     # saturates
    dict(scale_fmt="e8m0", block=32, two_level=False)],    # MXFP4
    ids=["nvfp4", "e4m3-one-level", "mxfp4"])
def test_scale_health_equals_jax(kw):
    """Rows spanning 2^-58 .. 2^17 (all normal f32), a zero row, tiny and
    huge blocks: saturation (one-level E4M3) and underflow (NVFP4's tensor
    scale pushes small blocks under E4M3's range) as integers.  Subnormal
    inputs are left out: XLA's CPU flushes them to zero, torch does not."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 256))
         * np.exp(rng.uniform(-40, 12, (64, 1)))).astype(np.float32)
    x[3], x[5, :32], x[7, :16] = 0.0, 1e-30, 3e4
    want = jquant.scale_health(jnp.asarray(x), jquant.BlockQuantSpec(**kw))
    got = tquant.scale_health(torch.from_numpy(x),
                              tquant.BlockQuantSpec(**kw))
    assert got == want and all(type(v) is int for v in got.values())
    if not kw["two_level"] and kw["scale_fmt"] == "e4m3":
        assert got["saturated"] > 0
    if kw["two_level"]:
        assert got["underflow"] > 0
    bf = got if kw["scale_fmt"] == "e8m0" else tquant.scale_health(
        torch.from_numpy(x).to(torch.bfloat16).T, tquant.BlockQuantSpec(
            **kw), axis=0)
    assert bf["blocks"] == x.size // kw["block"]


# ---- the launchers --------------------------------------------------------------


def test_launch_train_resumes_and_traces(tmp_path, capsys):
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    ck, trace = tmp_path / "run", tmp_path / "trace.json"
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(ck), "--ckpt-every", "2",
            "--trace", str(trace), "--device", "cpu"]
    first = train_launch.main(argv)
    assert [e["kind"] for e in first.events] == ["export_packed"]
    assert ckpt.latest_step(str(ck)) == 3
    assert ckpt.latest_step(str(ck / "serve_packed")) == 3
    events = load_trace(str(trace))
    assert validate_events(events) == [] and any(
        e["name"] == "gnr" for e in events)
    assert "trace:" in capsys.readouterr().out
    argv[argv.index("--steps") + 1] = "4"
    second = train_launch.main(argv)
    assert second.events[0] == {"kind": "restore", "step": 3}
    assert [h["step"] for h in second.history] == [3]

    # launch.serve restores a params checkpoint over its seeded init
    from repro_torch.models import registry
    params = registry.init_params(_cfg(), seed=5, device="cpu")
    ckpt.save(str(tmp_path / "params"), 7, params)
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--max-new", "4", "--max-len", "32", "--device", "cpu"]
    restored = serve_launch.main(argv + ["--ckpt-dir",
                                         str(tmp_path / "params")])
    assert "restored step-7 checkpoint" in capsys.readouterr().out
    seeded = serve_launch.main(argv + ["--seed", "5"])
    assert [o.tolist() for o in restored] == [o.tolist() for o in seeded]


if __name__ == "__main__":
    write_jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
