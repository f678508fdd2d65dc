"""The encdec, hybrid and ssm families on the port's meshes against the JAX
package, on gloo CPU ranks (tests/_dist.py).

The plain smoke configs of whisper-base (2 + 2 layers, 4 query and 4 KV
heads, biased attention and GELU MLPs, a 32-frame encoder), zamba2-1.2b (4
Mamba2 layers of 4 SSM heads, the shared attention block after each pair)
and xlstm-125m (4 blocks of 4 mLSTM heads, the fourth an sLSTM):

  * Specs: every leaf's spec under the rule table, as ``params_specs`` and
    as the ``placed_spec`` the port's path reads, equals the reference's
    ``params_specs`` leaf for leaf (a stacked layer axis a leading None;
    xLSTM's mixed blocks numbered), and the packed leaves' specs its
    ``spec_for_packed``; the decode state's ``cache_specs`` equal the
    reference's, leaf for leaf (the port places its states by heads, a
    declared divergence: ``ROADMAP.md``); at tp=2, fsdp=2 and dp=2,tp=2.
  * ``registry.check_mesh`` lets every family of the catalog through where
    its heads split, and names the heads that do not.
  * Serving at tp=2 and dp=2,tp=2: every rank's lockstep ``Engine`` stream
    (whisper with its frames) equals the port's 1-rank stream and JAX's
    1-device ``Engine`` stream token for token; whisper's
    ``ContinuousEngine``, each request with its frames, gives every rank
    the 1-rank continuous stream, which is JAX's lockstep stream here.
    The decode carry holds this rank's heads: KV caches, SSM and mLSTM
    states; the conv, sLSTM and encoder states whole.
  * Training at tp=2, fsdp=2 and dp=2,tp=2 from JAX's initial state
    against the port's 1-rank step, with the rules of
    tests/test_torch_mesh_families.py: losses at rtol 1e-6, every GEMM
    weight's gradient at relative L2 1e-6, the other leaves' (norms,
    biases, the conv and SSM parameters, the gate projections, the
    embedding) at 3e-2, two steps' updates of AdamW's f32 master weights
    at 3e-2 (the bf16 parameters would not do: the recurrent families'
    conv and gate weights move less than a bf16 ulp a step, so their bf16
    updates are the few roundings a last-bit difference flips), sigma_q
    (the probe on the shards) at the file's ``SIGMA_RTOL``; every rank's
    metrics equal.
    Against JAX's ``jit_train_step`` at dp=2,tp=2 on 4 forced host devices
    (GSPMD: the 1-device step), each bound adds the port's own 1-rank
    distance from JAX (tests/test_torch_mamba2.py, test_torch_xlstm.py and
    test_torch_whisper.py hold the 1-rank gradients to JAX's).  Whisper
    trains on tokens alone (zero frames): the reference's jitted step
    shards a batch of tokens only.
  * A checkpoint of each family's final state at dp=2,tp=2
    (``ckpt.save(mesh=)``, a leaf at a time) is the reference's
    ``shard_0.npz``: JAX's ``ckpt.restore`` reads it, every leaf equal to
    the gathered parameters, and it restores bit for bit on the ranks and
    into one rank.

JAX's three jobs (one a family: the jitted step, then the lockstep
stream) run in subprocesses (``_jax_ref.Reference``; this file as a script
with excess precision off and 4 forced host devices), and one rank session
per mesh (``_dist.smoke_family_session``) starts beside them at the
module's first test.
"""
import os
import sys

if __name__ == "__main__":       # the reference's forced host devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=4")

import dataclasses
import functools
import math
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _dist import _flat_tree, _whole_shapes, family_train, run_ranks
from _dist import smoke_family_cfg
from _dist import smoke_family_session
from _jax_ref import Reference, run_jobs
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import Mesh, MeshShape
from repro_torch.kernels import counters
from repro_torch.models import registry
from repro_torch.serve import ContinuousEngine, Engine, Request, ServeConfig

torch.set_num_threads(1)

WHISPER, ZAMBA2, XLSTM = "whisper-base", "zamba2-1.2b", "xlstm-125m"
ARCHS = (WHISPER, ZAMBA2, XLSTM)
BATCH, SEQ, STEPS = 2, 32, 2
MAX_NEW = 8
FIELDS = dict(batch_size=2, max_len=64, kv_cache_format="nvfp4",
              page_size=16, eos_id=-1)
MESHES = {"tp2": ((2,), ("model",)), "fsdp2": ((2,), ("data",)),
          "dp2tp2": ((2, 2), ("data", "model"))}
SERVE = {"tp2": "tp=2", "dp2tp2": "dp=2,tp=2"}
CKPT_MESH = "dp2tp2"
SPEC_MESHES = [((2,), ("model",)), ((2,), ("data",)),
               ((2, 2), ("data", "model"))]
LOSS_RTOL = 1e-6
GEMM_REL_L2 = 1e-6
REL_L2 = 3e-2
SIGMA_RTOL = {"tp2": 1e-5, "fsdp2": 1e-2, "dp2tp2": 1e-2}
# the weights every GEMM of the three families runs K1 on
GEMM_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate", "w_up", "w_down",
    "in_proj", "out_proj", "w_q", "w_k", "w_v", "w_gates", "w_ff_gate",
    "w_ff_up", "w_ff_down", "lm_head"})


def _jcfg(arch):
    from repro.configs import get_config as jget
    return jget(arch).smoke()


def _batches(arch):
    """Two global token batches (numpy) (B, S + 1)."""
    cfg = smoke_family_cfg(arch)
    return [{"tokens": np.random.default_rng(100 + i).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)}
        for i in range(STEPS)]


def _prompts(arch):
    rng = np.random.default_rng(0)
    return [rng.integers(0, smoke_family_cfg(arch).vocab_size, 8)
            for _ in range(2)]


def _frames(arch):
    """Whisper's serving frames (2, enc_seq, d), bf16; None otherwise."""
    import ml_dtypes
    cfg = smoke_family_cfg(arch)
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(5).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32).astype(
        ml_dtypes.bfloat16)


def _jtcfg():
    from repro.optim import schedule as jsched
    from repro.train.step import TrainConfig
    return TrainConfig(sched=jsched.ScheduleConfig(warmup_steps=2,
                                                   total_steps=10),
                       remat=True, probe_sigma=False)


def _jax_state(arch):
    """JAX's initial TrainState, every leaf its own buffer: the reference's
    AdamW init aliases an f32 parameter (A_log, D, dt_bias, b_if, b_gates)
    as its master weight, which a donating jitted step refuses."""
    import jax
    import jax.numpy as jnp
    from repro.train import step as jstep
    return jax.tree_util.tree_map(
        lambda x: jnp.array(x, copy=True),
        jstep.init_state(_jcfg(arch), _jtcfg(), jax.random.PRNGKey(0)))


def _flat_jax(prefix, tree, out):
    import jax
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf,
                                                               np.float32)


# ---- the reference's jobs -------------------------------------------------------


def _job(arch, ref):
    """Two steps of ``jit_train_step`` at dp=2,tp=2 on 4 host devices from
    ``init_state(PRNGKey(0))`` (probe off: the losses and AdamW's master
    weights after each step), then JAX's 1-device lockstep ``Engine`` on
    packed NVFP4 weights (whisper with its frames)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from repro import serve as jserve
    from repro.core import fqt as jfqt
    from repro.serve import packing as jpack
    from repro.train import step as jstep
    assert len(jax.devices()) == 4
    cfg, qcfg = _jcfg(arch), jfqt.nvfp4_paper_config()
    mesh = JMesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    state = _jax_state(arch)
    params = jax.tree_util.tree_map(jnp.array, state.params)
    state = jax.device_put(state, jstep.state_shardings(state, mesh))
    fn = jstep.jit_train_step(cfg, jfqt.nvfp4_paper_config(), _jtcfg(),
                              mesh, state)
    with mesh:
        for i, b in enumerate(_batches(arch)):
            state, m = fn(state, {"tokens": jnp.asarray(b["tokens"])})
            ref[f"{arch}/step{i}/loss"] = np.float32(m["loss"])
            _flat_jax(f"{arch}/master{i}", state.opt.master, ref)
    sq = jfqt.qaf_config()
    w = jax.jit(lambda p: jpack.pack_model_params(cfg, p, sq.fwd_w))(params)
    eng = jserve.Engine(cfg, w, jserve.ServeConfig(
        batch_size=2, max_len=FIELDS["max_len"], kv_cache_format="nvfp4",
        decode_chunk=4), qcfg=sq, pack_weights=False)
    frames = _frames(arch)
    extras = {} if frames is None else {"frames": jnp.asarray(frames)}
    ref[f"{arch}/lock"] = np.stack(eng.generate(
        _prompts(arch), max_new=MAX_NEW, extras=extras)).astype(np.int32)


def write_jax_reference(out_path, part, parts):
    run_jobs([functools.partial(_job, a) for a in ARCHS], out_path, part,
             parts)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_mesh_edr"),
                    parts=len(ARCHS))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jstates():
    """JAX's initial TrainStates (numpy leaves)."""
    import jax
    return {a: jax.tree_util.tree_map(np.asarray, _jax_state(a))
            for a in ARCHS}


@pytest.fixture(scope="module", autouse=True)
def rank_jobs(tmp_path_factory, jax_ref, jstates):
    """Every rank session of the module, started at its first test beside
    JAX's jobs: per mesh the three families' train steps, then (tp=2,
    dp=2,tp=2) their serving; at ``CKPT_MESH`` each final state
    checkpointed."""
    tmp = tmp_path_factory.mktemp("edr_ranks")
    train = {a: (jstates[a], _batches(a)) for a in ARCHS}
    pool = ThreadPoolExecutor(len(MESHES))
    jobs = {}
    for name, (shape, names) in MESHES.items():
        serve = None
        if name in SERVE:
            serve = (SERVE[name], {
                a: (jstates[a].params, _prompts(a), MAX_NEW, FIELDS,
                    _frames(a)) for a in ARCHS})
        ckpt = ({a: str(tmp / f"ckpt_{a}") for a in ARCHS}
                if name == CKPT_MESH else None)
        jobs[name] = pool.submit(run_ranks, smoke_family_session,
                                 math.prod(shape), tmp / name, shape, names,
                                 train, serve, ckpt)
    jobs["ckpt"] = {a: tmp / f"ckpt_{a}" for a in ARCHS}
    yield jobs
    pool.shutdown()


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _leaf_key(name: str) -> str:
    return name.strip("[]").split("][")[-1].strip("'")


def _port_leaf_np(flat, name):
    """The port's gathered leaf (flat slash paths) behind a reference leaf
    name: a stacked leaf (``['dec']['attn']['wq']``, ``['mamba'][...]``)
    the per-layer leaves stacked, a numbered one (``['layers'][3]...``)
    as it is."""
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    path = "/" + "/".join(keys)
    if path in flat:
        return flat[path]
    head, tail = "/" + keys[0], "/" + "/".join(keys[1:])
    n = len([p for p in flat if p.startswith(head + "/")
             and p.endswith(tail)])
    return np.stack([flat[f"{head}/{i}{tail}"] for i in range(n)])


# ---- the rules that need no rank ------------------------------------------------


def _fake(shape, names):
    """The reference's stand-in mesh (axis names, device shape)."""
    return types.SimpleNamespace(axis_names=names, devices=types.
                                 SimpleNamespace(shape=shape,
                                                 size=math.prod(shape)))


@pytest.fixture(scope="module")
def spec_trees():
    """{arch: [(reference struct, port tree)]}: bf16 and packed NVFP4, the
    port's from zeros of the reference's shapes."""
    import jax
    from repro.core.quantize import NVFP4 as JNVFP4
    from repro.models import registry as jreg
    from repro.serve import packing as jpack
    from repro_torch.convert import params_from_jax_numpy
    from repro_torch.core.quantize import NVFP4
    from repro_torch.serve import packing
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _jcfg(arch), smoke_family_cfg(arch)
        st = jax.eval_shape(lambda: jreg.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        port = params_from_jax_numpy(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), st), cfg, device="cpu")
        out[arch] = [(st, port), (jax.eval_shape(
            lambda p: jpack.pack_model_params(jcfg, p, JNVFP4), st),
            packing.pack_model_params(cfg, port, NVFP4))]
    return out


def _flat_specs(tree, path=""):
    if isinstance(tree, dict) and set(tree) != {"packed", "scales",
                                                "tscale"}:
        for k, v in tree.items():
            yield from _flat_specs(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_specs(v, f"{path}/{i}")
    else:
        yield path, tree


def _port_paths(got, p):
    """The port's paths behind reference path ``p``: itself, or one a
    layer where the reference stacks a list of per-layer dicts (``dec``,
    ``enc``, ``mamba``); the second item says which."""
    if p in got:
        return [p], False
    head, tail = p.split("/", 1)
    n = len([q for q in got if q.startswith(head + "/")
             and q.endswith("/" + tail)])
    assert n, p
    return [f"{head}/{i}/{tail}" for i in range(n)], True


def _drop_layer(spec):
    if isinstance(spec, dict):
        return {k: _drop_layer(v) for k, v in spec.items()}
    return tuple(spec[1:])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,names", SPEC_MESHES)
def test_family_specs_equal_reference(spec_trees, arch, shape, names):
    import jax
    from repro.core.quantize import PackedQuantizedTensor as JPacked
    from repro.distributed import sharding as jshd
    from repro_torch.core.quantize import PackedQuantizedTensor
    jm, pm = _fake(shape, names), MeshShape(shape, names)
    rank = Mesh(shape, names, device=torch.device("meta"))
    for jtree, port in spec_trees[arch]:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jtree, is_leaf=lambda x: isinstance(x, JPacked))
        got = dict(_flat_specs(sharding.params_specs(port, pm)))
        leaves = dict(_flat_specs(sharding._walk(port, lambda p, x: x)))
        packed = isinstance(flat[0][1], JPacked) or any(
            isinstance(leaf, JPacked) for _, leaf in flat)
        n_packed = 0
        for path, leaf in flat:
            p = jshd._path_str(path)
            want = ({k: tuple(v) for k, v in jshd.spec_for_packed(
                p, leaf, jm).items()} if isinstance(leaf, JPacked)
                else tuple(jshd._divisible(jshd.param_spec(
                    p, leaf.ndim, jm), leaf.shape, jm, path=p)))
            qs, stacked = _port_paths(got, p)
            for q in qs:
                sp = _drop_layer(want) if stacked else want
                assert got[q] == sp, (arch, q, got[q], sp)
                x = leaves[q]
                if isinstance(x, PackedQuantizedTensor):
                    n_packed += 1
                else:
                    assert sharding.placed_spec(q, x.ndim, rank) == sp, q
        assert (n_packed > 0) == packed


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,names", SPEC_MESHES)
def test_cache_specs_equal_reference(monkeypatch, arch, shape, names):
    """``cache_specs`` (the reference's rule: the batch over the DP axes,
    the longest later dim over "model" -- an SSM state's heads at zamba2's
    width) on the reference's decode state of each family, leaf for leaf,
    the nvfp4 lockstep caches and whisper's paged pool alike.  The port
    places its own states by heads (``registry.make_decode_state``; the
    serving test holds their shapes), a declared divergence."""
    import jax
    from jax.sharding import PartitionSpec
    from repro.distributed import sharding as jshd
    from repro.models import registry as jreg
    # the stand-in mesh is no device mesh: the spec, unwrapped
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    jcfg = _jcfg(arch)
    jm, pm = _fake(shape, names), MeshShape(shape, names)
    for kw in ({}, {"page_size": 16}):
        if kw and jcfg.family != "encdec":
            continue
        js = jax.eval_shape(lambda: jreg.make_decode_state(
            jcfg, 4, 64, kv_cache_format="nvfp4", **kw))
        want = [tuple(sp) for sp in jax.tree_util.tree_leaves(
            jshd.cache_specs(js, jm, 4),
            is_leaf=lambda x: isinstance(x, PartitionSpec))]
        got = sharding.cache_specs(
            [torch.empty(tuple(x.shape), device="meta")
             for x in jax.tree_util.tree_leaves(js)], pm, 4)
        assert got == want, (arch, kw)
        assert any(s for s in want), want


@pytest.mark.parametrize("arch", ARCHS)
def test_check_mesh_lets_every_family_through(arch):
    """Every arch of the catalog (smoke configs, 2 KV heads where the
    smoke config's one would not split) passes at tp=2, fsdp=2 and
    dp=2,tp=2; heads that do not split are named."""
    from repro_torch.configs import _ALIASES
    cpu = torch.device("cpu")
    for name in _ALIASES:
        cfg = get_config(name).smoke()
        if cfg.n_kv_heads % 2:
            cfg = dataclasses.replace(cfg, n_kv_heads=2)
        for shape, names in SPEC_MESHES:
            registry.check_mesh(cfg, Mesh(shape, names, device=cpu))
    cfg = smoke_family_cfg(arch)
    two = Mesh((2,), ("model",), device=cpu)
    with pytest.raises(ValueError, match="KV heads do not split"):
        registry.check_mesh(dataclasses.replace(cfg, n_kv_heads=3), two)
    # whisper's attention heads, zamba2's SSM heads, xLSTM's mLSTM heads
    # (its config's n_heads)
    field = "n_ssm_heads" if arch == ZAMBA2 else "n_heads"
    bad = dataclasses.replace(cfg, **{field: 3})
    with pytest.raises(ValueError, match=r"3 (SSM )?heads.* do not split"):
        registry.check_mesh(bad, two)
    # the placement of a leaf whose planned split does not divide raises
    # naming it, where the reference would replicate it
    if arch == ZAMBA2:
        with pytest.raises(ValueError, match="mamba/0/conv_w"):
            sharding.place_train_params(
                {"mamba": [{"conv_w": torch.zeros(4, 33)}]}, two)


# ---- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_serve(jstates):
    """The port's 1-rank engines on the JAX-initialised params."""
    from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
    out = {}
    for arch in ARCHS:
        cfg = smoke_family_cfg(arch)
        params = params_from_jax_numpy(jstates[arch].params, cfg,
                                       device="cpu")
        scfg = ServeConfig(**FIELDS)
        frames = _frames(arch)
        extras = ({} if frames is None
                  else {"frames": tensor_from_numpy(frames, "cpu")})
        lock = Engine(cfg, params, scfg, device="cpu").generate(
            _prompts(arch), max_new=MAX_NEW, extras=extras)
        cont = None
        if frames is not None:
            res = ContinuousEngine(cfg, params, scfg, device="cpu").run(
                [Request(rid=i, prompt=np.asarray(p, np.int32),
                         max_new=MAX_NEW)
                 for i, p in enumerate(_prompts(arch))],
                extras={i: {"frames": extras["frames"][i:i + 1]}
                        for i in range(2)})
            cont = [res[i] for i in range(2)]
        out[arch] = (lock, cont)
    return out


def _local_heads_carry(arch, carry):
    """The decode carry's head dims of one rank at tp=2: every KV cache 2
    of 4 heads, the SSM and mLSTM states 2 of 4; the conv, sLSTM and
    encoder states whole."""
    cfg = smoke_family_cfg(arch)
    if arch == WHISPER:
        enc, caches = carry
        assert enc == (2, cfg.enc_seq, cfg.d_model)
        assert all(c["k_codes"][-2] == 2 for c in caches)
    elif arch == ZAMBA2:
        states, caches = carry
        from repro_torch.models import mamba2
        d_inner, H, P, N = mamba2.mamba_dims(cfg)
        assert states["ssm"] == (cfg.n_layers, 2, H // 2, P, N)
        assert states["conv"] == (cfg.n_layers, 2, cfg.ssm_conv - 1,
                                  d_inner + 2 * N)
        assert all(c["k_codes"][-2] == 2 for c in caches)
    else:
        for st in carry:
            if len(st) == 2:
                assert st[0][1] == cfg.n_heads // 2 == st[1][1]
            else:
                assert all(s == (2, cfg.d_model) for s in st)


@pytest.mark.parametrize("mesh_name", sorted(SERVE))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_streams_equal_one_device(jax_ref, jstates, rank_jobs,
                                          one_rank_serve, mesh_name, arch):
    outs = [o["serve"][arch] for o in rank_jobs[mesh_name].result()]
    ref = jax_ref.result()
    lock1, cont1 = one_rank_serve[arch]
    from repro_torch.convert import params_from_jax_numpy
    whole = _whole_shapes(params_from_jax_numpy(
        jstates[arch].params, smoke_family_cfg(arch), device="cpu"))
    assert bool(whole) == (arch != WHISPER)
    for i in range(2):
        np.testing.assert_array_equal(lock1[i], ref[f"{arch}/lock"][i])
        if cont1 is not None:
            np.testing.assert_array_equal(cont1[i], ref[f"{arch}/lock"][i])
    for r, o in enumerate(outs):
        for i in range(2):
            np.testing.assert_array_equal(o["lock"][i], lock1[i],
                                          err_msg=f"rank {r} lock {i}")
            if cont1 is not None:
                np.testing.assert_array_equal(o["cont"][i], cont1[i],
                                              err_msg=f"rank {r} cont {i}")
        assert o["launches"] == {k: 0 for k in counters.COUNTS}
        # the engine holds zamba2's conv_w and xLSTM's gate weights whole
        assert o["engine_whole"] == whole, (r, o["engine_whole"])
        _local_heads_carry(arch, o["carry"])
        if cont1 is not None:
            assert o["cont_heads"] == 2
        assert o["ops"]["all_gather"] > 0, o["ops"]


# ---- training -------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_train(jstates):
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh((1,), ("model",), device="cpu")
    return {a: family_train(mesh, a, jstates[a], _batches(a), masters=True,
                            n_kv_heads=smoke_family_cfg(a).n_kv_heads)
            for a in ARCHS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_one_rank_and_jax(jax_ref, jstates, rank_jobs,
                                            one_rank_train, mesh_name,
                                            arch):
    outs = [o["train"][arch] for o in rank_jobs[mesh_name].result()]
    ref = jax_ref.result()
    one = one_rank_train[arch]
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"], "ranks disagree"
    o = outs[0]
    assert set(o["grads"]) == set(one["grads"])
    for name, mine in one["grads"].items():
        got = o["grads"][name]
        assert got.shape == mine.shape, name
        tol = GEMM_REL_L2 if name.rsplit("/", 1)[-1] in GEMM_LEAVES \
            else REL_L2
        err = _rel_l2(got, mine)
        assert err <= tol, f"{mesh_name} grad {name} vs 1 rank: {err:.3g}"
    from repro_torch.convert import params_from_jax_numpy
    start = _flat_tree(params_from_jax_numpy(
        jstates[arch].opt.master, smoke_family_cfg(arch), device="cpu"))
    names_ = [k[len(f"{arch}/master0"):] for k in ref
              if k.startswith(f"{arch}/master0")]
    assert names_
    for i in range(STEPS):
        loss, mine = o["metrics"][i]["loss"], one["metrics"][i]["loss"]
        np.testing.assert_allclose(loss, mine, rtol=LOSS_RTOL)
        np.testing.assert_allclose(o["metrics"][i]["sigma_q"],
                                   one["metrics"][i]["sigma_q"],
                                   rtol=SIGMA_RTOL[mesh_name])
        jloss = float(ref[f"{arch}/step{i}/loss"])
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss) + abs(
            mine - jloss), (i, loss, jloss)
        for name in names_:
            old = _port_leaf_np(start, name)
            got = _port_leaf_np(o["masters"][i], name) - old
            mine = _port_leaf_np(one["masters"][i], name) - old
            want = ref[f"{arch}/master{i}" + name] - old
            err = _rel_l2(got, mine)
            assert err <= REL_L2, f"{mesh_name} step {i} {name}: {err:.3g}"
            err = _rel_l2(got, want)
            assert err <= REL_L2 + _rel_l2(mine, want), \
                f"{mesh_name} step {i} {name} vs JAX: {err:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_checkpoint_is_the_reference_format(rank_jobs, jstates,
                                                    arch):
    """dp=2,tp=2: ``ckpt.save(mesh=)`` writes the reference's format a leaf
    at a time (zamba2's per-layer ``mamba`` dicts stacked, xLSTM's mixed
    blocks numbered); the ranks restore their shards bit for bit, JAX's
    ``ckpt.restore`` reads the final state and one rank restores it, both
    equal to the gathered parameters."""
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro.train import step as jstep
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import train_state_from_jax_numpy
    outs = [o["train"][arch] for o in rank_jobs[CKPT_MESH].result()]
    assert all(o["ckpt_equal"] for o in outs)
    final = outs[0]["params"][-1]
    like = jax.eval_shape(lambda: jstep.init_state(
        _jcfg(arch), _jtcfg(), jax.random.PRNGKey(0)))
    path = str(rank_jobs["ckpt"][arch])
    got = jckpt.restore(path, STEPS, like)
    assert int(got.step) == STEPS
    n = 0
    for p, leaf in jax.tree_util.tree_leaves_with_path(got.params):
        name = jax.tree_util.keystr(p)
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      _port_leaf_np(final, name),
                                      err_msg=name)
        n += 1
    assert n > 10
    one = train_state_from_jax_numpy(jstates[arch], smoke_family_cfg(arch),
                                     device="cpu")
    back = ckpt.restore(path, STEPS, one)
    assert back.step == STEPS
    flat = _flat_tree(back.params)
    assert set(flat) == set(final)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, final[k], err_msg=k)


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
