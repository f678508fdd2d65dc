"""The moe and vlm families on the port's meshes against the JAX package,
on gloo CPU ranks (tests/_dist.py).

The smoke configs of mixtral-8x7b (one dispatch group: the "replicated"
route under DP), qwen3-moe-235b-a22b (16 groups at batch 2 x 32: the
"local" route) and internvl2-26b (the dense LM behind a 16-row prefix),
each with ``n_kv_heads=2`` on both sides: the smoke configs' one KV head
cannot split over "model", which the port refuses (a declared divergence
of its serving mesh: the reference replicates the head); one case keeps
the plain smoke config and asserts that refusal.

  * Specs: every leaf's spec under the rule table (the stacked experts
    (E, d, f) "io" / "oi", the router "d_rep", the prefix-free vlm tree),
    as ``params_specs`` and as the ``placed_spec`` the port's path reads,
    equals the reference's ``params_specs`` leaf for leaf (its stacked
    layer axis a leading None), and the packed leaves' specs its
    ``spec_for_packed``, on stand-in meshes at tp=2, fsdp=2, dp=2,tp=2 and
    (pod, data, model) = (2, 1, 1).
  * The dispatch route (``moe.dispatch_route``) from (G, dp, C, block).
  * Serving: both engines (vlm: the lockstep ``Engine``, as on one card)
    at tp=2 and at dp=2,tp=2 (packed weights gathered over "data") give
    every rank the streams of the port's 1-rank engines and of JAX's
    1-device ``Engine`` (which JAX's ``ContinuousEngine`` also gives on
    these prompts), token for token; the moe
    layer's collectives a program call are two (``moe_amax``,
    ``moe_partials``) whatever E.
  * Training at tp=2, fsdp=2 and dp=2,tp=2 from JAX's initial state,
    against the port's 1-rank step and JAX's 1-device step, with the rules
    of tests/test_torch_train_mesh.py: the losses at rtol 1e-6; every
    GEMM-weight gradient, the experts' included, at relative L2 1e-6; the
    other leaves (router, norms, embedding) at 3e-2; two steps' updates at
    3e-2.  Against JAX each bound adds the port's own 1-rank distance from
    JAX: the 1-rank step is not JAX's bit for bit everywhere here.  Its
    training attention sums dq, dk and dv's f32 products in torch's order,
    which rounds a few bf16 elements of them otherwise than XLA (of any
    GQA grouping), and under SR a flipped element moves a block's scale
    and its codes: Qwen3 at 2 KV heads on these tokens has its 1-rank
    wk / wv gradients 7e-2 from JAX's (layer 1's dv first parts), while
    Mixtral's and InternVL2's GEMM gradients are JAX's but for Mixtral's
    experts, whose update GEMM stays bf16 on 40 capacity rows and sums in
    torch's order (2.6e-5, tests/test_torch_moe.py).  Every rank's
    metrics are equal, its routing
    at step 0 (expert ids, slots, kept entries, G and the capacity C from
    the GLOBAL token count) equals the 1-rank routing of its groups bit for
    bit, and its aux share sums over the DP ranks to the 1-rank aux.  Qwen3
    at dp=2,tp=2 also against JAX's ``jit_train_step`` on 4 forced host
    devices (one step).
  * The compressed pods at (2, 1, 1) (Mixtral, ``GRAD_FP8``): each pod
    routes its own tokens, which is the 1-rank step with two dispatch
    groups (a group is a contiguous token range): step-0 loss at rtol
    1e-6 and each pod's routing bit for bit against that step, its
    gradients within relative L2 0.25 of it (the E4M3 SR noise, the rule
    of tests/test_torch_compression.py).
  * The compressed pod mean of moe leaves split over "model" at (2, 1, 2)
    equals the unsplit (2, 1, 1) one bit for bit; fsdp=2 Qwen3-MoE's
    final state checkpointed (``ckpt.save(mesh=)``) restores bit for bit
    on the ranks and through JAX's ``ckpt.restore``.
  * ``registry.check_mesh`` passes moe and vlm at every mesh above, and
    no family of the catalog is refused a mesh any more.

JAX's jobs run in subprocesses (``_jax_ref.Reference``; this file as a
script with excess precision off and 4 forced host devices), and one rank
session per mesh (``_dist.family_session``) starts beside them at the
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

from _dist import (family_cfg, family_session, family_train, pod_mean,
                   run_ranks)
from _jax_ref import Reference, run_jobs
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import Mesh, MeshShape
from repro_torch.kernels import counters
from repro_torch.models import moe, registry
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

torch.set_num_threads(1)

MIXTRAL, QWEN3, VLM = "mixtral-8x7b", "qwen3-moe-235b-a22b", "internvl2-26b"
ARCHS = (MIXTRAL, QWEN3, VLM)
KV_HEADS = 2
BATCH, SEQ, STEPS = 2, 32, 2
MAX_NEW = 8
FIELDS = dict(batch_size=2, max_len=64, kv_cache_format="nvfp4",
              page_size=16, eos_id=-1)
MESHES = {"tp2": ((2,), ("model",)), "fsdp2": ((2,), ("data",)),
          "dp2tp2": ((2, 2), ("data", "model"))}
SERVE = {"tp2": "tp=2", "dp2tp2": "dp=2,tp=2"}
PODS = ((2, 1, 1), ("pod", "data", "model"))
SPEC_MESHES = [((2,), ("model",)), ((2,), ("data",)),
               ((2, 2), ("data", "model")), PODS]
LOSS_RTOL = 1e-6
GEMM_REL_L2 = 1e-6
REL_L2 = 3e-2
COMPRESSED_REL_L2 = 0.25
SEED = 0x600DF00D
SIGMA_RTOL = {"tp2": 1e-5, "fsdp2": 1e-2, "dp2tp2": 1e-2}
GEMM_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                         "lm_head"})


def _jcfg(arch, **kw):
    from repro.configs import get_config as jget
    return dataclasses.replace(jget(arch).smoke(), n_kv_heads=KV_HEADS, **kw)


def _batches(arch):
    """Two global batches (numpy): tokens (B, S + 1), and for vlm a
    bf16 prefix (B, 16, d)."""
    import ml_dtypes
    cfg = family_cfg(arch)
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(100 + i)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
             .astype(np.int32)}
        if cfg.family == "vlm":
            b["prefix_embeds"] = rng.standard_normal(
                (BATCH, cfg.vision_tokens, cfg.d_model)).astype(
                np.float32).astype(ml_dtypes.bfloat16)
        out.append(b)
    return out


def _prompts(arch):
    rng = np.random.default_rng(0)
    return [rng.integers(0, family_cfg(arch).vocab_size, 8)
            for _ in range(2)]


def _extras(arch):
    import ml_dtypes
    cfg = family_cfg(arch)
    if cfg.family != "vlm":
        return {}
    rng = np.random.default_rng(5)
    return {"prefix_embeds": rng.standard_normal(
        (2, cfg.vision_tokens, cfg.d_model)).astype(np.float32).astype(
        ml_dtypes.bfloat16)}


def _moe_grads():
    """Two pods' gradients of a moe layer's leaves (f32), for the
    compressed pod mean: the stacked experts, the router, a smoothing
    factor."""
    out = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        out.append({k: rng.standard_normal(v).astype(np.float32)
                    for k, v in (("w_gate", (4, 64, 128)),
                                 ("w_down", (4, 128, 64)),
                                 ("router", (64, 32)), ("smooth", (4, 128)))})
    return out


def _jtcfg():
    from repro.optim import schedule as jsched
    from repro.train.step import TrainConfig
    return TrainConfig(sched=jsched.ScheduleConfig(warmup_steps=2,
                                                   total_steps=10),
                       remat=True, probe_sigma=False)


def _flat_jax(prefix, tree, out):
    import jax
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf,
                                                               np.float32)


# ---- the reference's jobs -------------------------------------------------------


def _job_train(arch, ref):
    """Grads at step 0 and two steps of the 1-device ``make_train_step``
    from ``init_state(PRNGKey(0))`` (probe off)."""
    import jax
    import jax.numpy as jnp
    from repro.core import fqt as jfqt
    from repro.models import registry as jreg
    from repro.train import step as jstep
    cfg, qcfg = _jcfg(arch), jfqt.nvfp4_paper_config()
    state = jstep.init_state(cfg, _jtcfg(), jax.random.PRNGKey(0))
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(arch)]
    (_, aux), grads = jax.jit(jax.value_and_grad(lambda p: jreg.loss_fn(
        p, cfg, qcfg, batches[0], seed=jnp.uint32(1), remat=True),
        has_aux=True))(state.params)
    ref[f"{arch}/aux0"] = np.float32(aux["aux"])
    _flat_jax(f"{arch}/grads", grads, ref)
    train_step = jstep.make_train_step(cfg, qcfg, _jtcfg())
    for i, b in enumerate(batches):
        state, m = train_step(state, b)
        ref[f"{arch}/step{i}/loss"] = np.float32(m["loss"])
        _flat_jax(f"{arch}/params{i}", state.params, ref)


def _job_jit(ref):
    """One step of Qwen3's ``jit_train_step`` at dp=2,tp=2 on 4 host
    devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from repro.core import fqt as jfqt
    from repro.train import step as jstep
    assert len(jax.devices()) == 4
    cfg, qcfg = _jcfg(QWEN3), jfqt.nvfp4_paper_config()
    mesh = JMesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    state = jstep.init_state(cfg, _jtcfg(), jax.random.PRNGKey(0))
    state = jax.device_put(state, jstep.state_shardings(state, mesh))
    fn = jstep.jit_train_step(cfg, qcfg, _jtcfg(), mesh, state)
    with mesh:
        state, m = fn(state, {k: jnp.asarray(v)
                              for k, v in _batches(QWEN3)[0].items()})
    ref["jit/loss"] = np.float32(m["loss"])
    _flat_jax("jit/params", state.params, ref)


def _job_serve(arch, ref):
    """JAX's 1-device lockstep ``Engine`` on packed NVFP4 weights: the
    stream both of the port's engines must give (JAX's own
    ``ContinuousEngine`` gives this stream too on these prompts, two
    8-token prompts, greedy: checked when this module was written)."""
    import jax
    import jax.numpy as jnp
    from repro.models import registry as jreg
    from repro import serve as jserve
    from repro.core import fqt as jfqt
    from repro.serve import packing as jpack
    cfg = _jcfg(arch)
    params = jreg.init_params(cfg, jax.random.PRNGKey(0))
    extras = {k: jnp.asarray(v) for k, v in _extras(arch).items()}
    # tests/_jax_ref.jax_engine_stream's Engine, without its margins
    qcfg = jfqt.qaf_config()
    w = jax.jit(lambda p: jpack.pack_model_params(cfg, p, qcfg.fwd_w))(
        params)
    eng = jserve.Engine(cfg, w, jserve.ServeConfig(
        batch_size=2, max_len=FIELDS["max_len"], kv_cache_format="nvfp4",
        decode_chunk=4), qcfg=qcfg, pack_weights=False)
    ref[f"{arch}/lock"] = np.stack(eng.generate(
        _prompts(arch), max_new=MAX_NEW, extras=extras)).astype(np.int32)


def write_jax_reference(out_path, part, parts):
    run_jobs([_job_jit] + [functools.partial(_job_train, a) for a in ARCHS]
             + [functools.partial(_job_serve, a) for a in ARCHS],
             out_path, part, parts)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_mesh_families"),
                    parts=7)
    yield ref
    ref.close()


def _jax_init(arch):
    """JAX's initial TrainState and params (numpy leaves)."""
    import jax
    from repro.train import step as jstep
    state = jstep.init_state(_jcfg(arch), _jtcfg(), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def jstates():
    return {a: _jax_init(a) for a in ARCHS}


@pytest.fixture(scope="module", autouse=True)
def rank_jobs(tmp_path_factory, jax_ref, jstates):
    """Every rank session of the module, started at its first test beside
    JAX's jobs: per mesh the three archs' train steps, then (tp=2,
    dp=2,tp=2) their serving; the pods' compressed Mixtral step."""
    tmp = tmp_path_factory.mktemp("family_ranks")
    train = {a: (jstates[a], _batches(a)) for a in ARCHS}
    pool = ThreadPoolExecutor(len(MESHES) + 3)
    jobs = {}
    for name, (shape, names) in MESHES.items():
        serve = None
        if name in SERVE:
            serve = (SERVE[name], {
                a: (jstates[a].params, _prompts(a), MAX_NEW, FIELDS,
                    _extras(a)) for a in ARCHS})
        ckpt = {QWEN3: str(tmp / "ckpt")} if name == "fsdp2" else None
        jobs[name] = pool.submit(run_ranks, family_session,
                                 math.prod(shape), tmp / name, shape, names,
                                 train, serve, {}, ckpt)
    jobs["pods"] = pool.submit(run_ranks, family_session, 2, tmp / "pods",
                               *PODS, {}, None,
                               {MIXTRAL: (jstates[MIXTRAL],
                                          _batches(MIXTRAL))})
    for name, shape in (("pod_mean", (2, 1, 2)), ("pod_mean_1", PODS[0])):
        jobs[name] = pool.submit(run_ranks, pod_mean, math.prod(shape),
                                 tmp / name, shape, PODS[1], _moe_grads(),
                                 SEED, ["fp8"])
    jobs["ckpt"] = tmp / "ckpt"
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
    """The port's gathered leaf (per-layer flat paths) behind a reference
    leaf name, the layers stacked."""
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    if keys[0] != "layers":
        return flat["/" + "/".join(keys)]
    tail = "/" + "/".join(keys[1:])
    n = len([p for p in flat if p.startswith("/layers/")
             and p.endswith(tail)])
    return np.stack([flat[f"/layers/{i}" + tail] for i in range(n)])


# ---- the rules that need no rank ------------------------------------------------


def _fake(shape, names):
    """The reference's stand-in mesh (axis names, device shape)."""
    return types.SimpleNamespace(axis_names=names, devices=types.
                                 SimpleNamespace(shape=shape,
                                                 size=math.prod(shape)))


@pytest.fixture(scope="module")
def spec_trees():
    """{arch: (reference bf16 struct, reference packed struct)}."""
    import jax
    from repro.core.quantize import NVFP4 as JNVFP4
    from repro.models import registry as jreg
    from repro.serve import packing as jpack
    out = {}
    for arch in ARCHS:
        cfg = _jcfg(arch)
        st = jax.eval_shape(lambda: jreg.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
        out[arch] = (st, jax.eval_shape(lambda p: jpack.pack_model_params(
            cfg, p, JNVFP4), st))
    return out


def _meta_tree(jtree):
    """The port's tree (per-layer dicts) of the reference's shape structs
    (stacked layers), as meta tensors; packed leaves as packed meta
    tensors."""
    from repro.core.quantize import PackedQuantizedTensor as JPacked
    from repro_torch.core.quantize import PackedQuantizedTensor
    dt = {"uint8": torch.uint8, "float8_e4m3fn": torch.float8_e4m3fn}

    def meta(s, stacked):
        shape = tuple(s.shape[1:] if stacked else s.shape)
        return torch.empty(shape, dtype=dt.get(str(s.dtype), torch.float32),
                           device="meta")

    def conv(v, stacked):
        if isinstance(v, dict):
            return {k: conv(x, stacked) for k, x in v.items()}
        if isinstance(v, JPacked):
            return PackedQuantizedTensor(
                meta(v.packed, stacked), meta(v.scales, stacked),
                meta(v.tscale, stacked), v.axis, v.block)
        return meta(v, stacked)

    n = next(iter(jtree["layers"]["attn"].values()))
    n = (n.packed if isinstance(n, JPacked) else n).shape[0]
    return {k: ([conv(v, True) for _ in range(n)] if k == "layers"
                else conv(v, False)) for k, v in jtree.items()}


def _flat(tree, path=""):
    if isinstance(tree, dict) and set(tree) != {"packed", "scales",
                                                "tscale"}:
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


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
    jm, pm = _fake(shape, names), MeshShape(shape, names)
    rank = Mesh(shape, names, device=torch.device("meta"))
    for jtree in spec_trees[arch]:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jtree, is_leaf=lambda x: isinstance(x, JPacked))
        want = {}
        for path, leaf in flat:
            p = jshd._path_str(path)
            want[p] = ({k: tuple(v) for k, v in jshd.spec_for_packed(
                p, leaf, jm).items()} if isinstance(leaf, JPacked)
                else tuple(jshd._divisible(jshd.param_spec(
                    p, leaf.ndim, jm), leaf.shape, jm, path=p)))
        port = _meta_tree(jtree)
        got = dict(_flat(sharding.params_specs(port, pm)))
        n_layers = len(port["layers"])
        for p, w in want.items():
            layers = range(n_layers) if p.startswith("layers/") \
                else [None]
            for i in layers:
                q = p if i is None else p.replace("layers/",
                                                  f"layers/{i}/", 1)
                sp = w if i is None else _drop_layer(w)
                assert got[q] == sp, (arch, q, got[q], sp)
                if not isinstance(sp, dict):
                    nd = len(_leaf_shape(jtree, p)) - (
                        i is not None)
                    assert sharding.placed_spec(q, nd, rank) == sp, q
        if arch != VLM:
            assert any("moe/w_gate" in p for p in want)


def _leaf_shape(jtree, path):
    node = jtree
    for k in path.split("/"):
        node = node[k]
    return node.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_check_mesh_lets_the_families_through(arch):
    cfg = family_cfg(arch)
    for shape, names in SPEC_MESHES:
        registry.check_mesh(cfg, Mesh(shape, names,
                                      device=torch.device("cpu")))
    registry.check_mesh(cfg, Mesh((2, 2), ("data", "model"),
                                  device=torch.device("cpu")))
    # no family is refused a mesh any more (the hybrid, ssm and encdec
    # families: tests/test_torch_mesh_encdec_recurrent.py), and no table
    # of modules still to port is left to name one
    assert not hasattr(registry, "_MESH_TODO")
    for other in ("zamba2-1.2b", "xlstm-125m", "whisper-base"):
        registry.check_mesh(get_config(other).smoke(), Mesh(
            (2,), ("model",), device=torch.device("cpu")))
    # the plain smoke config's one KV head does not split over "model"
    with pytest.raises(ValueError, match="KV heads do not split over tp=2"):
        registry.check_mesh(get_config(arch).smoke(), Mesh(
            (2,), ("model",), device=torch.device("cpu")))


# (name, arch, dp, block, the route): G and C from the smoke config at
# batch 2 x 32; Qwen3 at dp=8 holds 2 groups x 4 capacity rows a rank,
# which would split the update GEMM's 16-row blocks
ROUTE_CASES = (("mixtral dp2", MIXTRAL, 2, 16, "replicated"),
               ("mixtral dp1", MIXTRAL, 1, 16, "local"),
               ("qwen3 dp2", QWEN3, 2, 16, "local"),
               ("qwen3 dp8", QWEN3, 8, 16, "replicated"),
               ("qwen3 dp8 bf16 update", QWEN3, 8, None, "local"),
               ("qwen3 dp32", QWEN3, 32, 16, "replicated"))


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in
                                                   ROUTE_CASES])
def test_dispatch_route_rule(case):
    _, arch, dp, block, want = case
    cfg = family_cfg(arch)
    G, Tg, C = moe.groups(cfg, BATCH * SEQ)
    assert (G, Tg, C) == ({MIXTRAL: (1, 64, 40), QWEN3: (16, 4, 4)}[arch])
    got = moe.dispatch_route(G, dp, C, block)
    assert got == want
    # the rule: whole groups on every rank, and their capacity rows a
    # whole number of blocks wherever the global rows are
    local = G % dp == 0 and not (block and (G * C) % block == 0
                                 and (G // dp * C) % block)
    assert got == ("local" if local else "replicated")


# ---- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_serve(jstates):
    """The port's 1-rank engines on the JAX-initialised params."""
    from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
    out = {}
    for arch in ARCHS:
        cfg = family_cfg(arch)
        params = params_from_jax_numpy(jstates[arch].params, cfg,
                                       device="cpu")
        scfg = ServeConfig(**FIELDS)
        extras = {k: tensor_from_numpy(v, "cpu")
                  for k, v in _extras(arch).items()}
        lock = Engine(cfg, params, scfg, device="cpu").generate(
            _prompts(arch), max_new=MAX_NEW, extras=extras)
        cont = (ContinuousEngine(cfg, params, scfg, device="cpu").generate(
            _prompts(arch), max_new=MAX_NEW) if cfg.family == "moe"
            else None)
        out[arch] = (lock, cont)
    return out


@pytest.mark.parametrize("mesh_name", sorted(SERVE))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_streams_equal_one_device(jax_ref, rank_jobs, one_rank_serve,
                                          mesh_name, arch):
    outs = [o["serve"][arch] for o in rank_jobs[mesh_name].result()]
    ref = jax_ref.result()
    lock1, cont1 = one_rank_serve[arch]
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
        calls = o["decode_calls"] + o["prefill_calls"]
        n_layers = family_cfg(arch).n_layers
        if arch == VLM:
            assert "moe_amax" not in o["ops"]
        else:
            # two batched collectives a moe layer and program call,
            # whatever E
            assert o["ops"]["moe_amax"] == o["ops"]["moe_partials"] \
                == calls * n_layers, o["ops"]


# ---- training -------------------------------------------------------------------


def _one_rank_train(arch, state_np, batches, **overrides):
    """The port's 1-rank ``family_train`` (no mesh) on ``arch``'s config,
    its fields replaced by ``overrides``."""
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh((1,), ("model",), device="cpu")
    return family_train(mesh, arch, state_np, batches, **overrides)


@pytest.fixture(scope="module")
def one_rank_train(jstates):
    return {a: _one_rank_train(a, jstates[a], _batches(a)) for a in ARCHS}


def _assert_routing(got, want, where, first=None):
    """A rank's routing records against the 1-rank ones: per layer G and
    C, and each of its groups' expert ids, slots, sorted tokens and kept
    entries bit for bit (the rank's groups start at its ``first``, or at
    ``first`` where given: a pod's one group among the 1-rank step's
    two, whose G is then not compared)."""
    assert len(got) == len(want), where
    for li, (g, w) in enumerate(zip(got, want)):
        assert g["C"] == w["C"], (where, li)
        assert len(w["groups"]) == w["G"]
        if first is None:
            assert g["G"] == w["G"], (where, li)
        start = g["first"] if first is None else first
        for j, grp in enumerate(g["groups"]):
            for a, b, what in zip(grp, w["groups"][start + j],
                                  ("ids", "slot", "st", "keep")):
                np.testing.assert_array_equal(a, b, err_msg=f"{where} "
                                              f"layer {li} group {j} {what}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(jax_ref, jstates, rank_jobs, one_rank_train,
                               mesh_name, arch):
    outs = [o["train"][arch] for o in rank_jobs[mesh_name].result()]
    ref = jax_ref.result()
    one = one_rank_train[arch]
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"], "ranks disagree"
    o = outs[0]
    # routing: each rank's groups bit for bit; the global G and C
    if arch != VLM:
        shape, names = MESHES[mesh_name]
        dp = math.prod(n for n, a in zip(shape, names) if a == "data")
        want_route = "replicated" if arch == MIXTRAL and dp > 1 else "local"
        for r, rank in enumerate(outs):
            assert [x["route"] for x in rank["routing"]] == \
                [want_route] * family_cfg(arch).n_layers
            _assert_routing(rank["routing"], one["routing"],
                            f"{mesh_name} rank {r}")
    # the ranks' aux shares sum over the DP ranks to the 1-rank aux
    shares = {}
    for rank in outs:
        shares[rank["coords"]["data"]] = rank["aux_share"]
    np.testing.assert_allclose(sum(shares.values()), one["aux_share"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(o["metrics"][0]["aux"], ref[f"{arch}/aux0"],
                               rtol=LOSS_RTOL)
    names_ = [k[len(f"{arch}/grads"):] for k in ref
              if k.startswith(f"{arch}/grads")]
    assert names_
    for name in names_:
        want = ref[f"{arch}/grads" + name]
        got = _port_leaf_np(o["grads"], name)
        mine = _port_leaf_np(one["grads"], name)
        assert got.shape == want.shape, name
        tol = GEMM_REL_L2 if _leaf_key(name) in GEMM_LEAVES else REL_L2
        err = _rel_l2(got, mine)
        assert err <= tol, f"{mesh_name} grad {name} vs 1 rank: {err:.3g}"
        err = _rel_l2(got, want)
        assert err <= tol + _rel_l2(mine, want), \
            f"{mesh_name} grad {name} vs JAX: {err:.3g}"
    from _dist import _flat_tree
    from repro_torch.convert import params_from_jax_numpy
    start = _flat_tree(params_from_jax_numpy(jstates[arch].params,
                                             family_cfg(arch), device="cpu"))
    for i in range(STEPS):
        loss, mine = o["metrics"][i]["loss"], one["metrics"][i]["loss"]
        np.testing.assert_allclose(loss, mine, rtol=LOSS_RTOL)
        # the sigma_q probe on the shards (the experts' a call each where
        # a layer splits off its last dim)
        np.testing.assert_allclose(o["metrics"][i]["sigma_q"],
                                   one["metrics"][i]["sigma_q"],
                                   rtol=SIGMA_RTOL[mesh_name])
        jloss = float(ref[f"{arch}/step{i}/loss"])
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss) + abs(
            mine - jloss), (i, loss, jloss)
        for name in names_:
            old = _port_leaf_np(start, name)
            got = _port_leaf_np(o["params"][i], name) - old
            mine = _port_leaf_np(one["params"][i], name) - old
            want = ref[f"{arch}/params{i}" + name] - old
            err = _rel_l2(got, mine)
            assert err <= REL_L2, f"{mesh_name} step {i} {name}: {err:.3g}"
            err = _rel_l2(got, want)
            assert err <= REL_L2 + _rel_l2(mine, want), \
                f"{mesh_name} step {i} {name} vs JAX: {err:.3g}"
    if mesh_name == "dp2tp2" and arch == QWEN3:
        loss, jloss = o["metrics"][0]["loss"], float(ref["jit/loss"])
        mine = one["metrics"][0]["loss"]
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss) + abs(
            mine - jloss)
        for name in names_:
            old = _port_leaf_np(start, name)
            got = _port_leaf_np(o["params"][0], name) - old
            want = ref["jit/params" + name] - old
            err = _rel_l2(got, want)
            assert err <= REL_L2 + _rel_l2(
                _port_leaf_np(one["params"][0], name) - old, want), \
                f"jit_train_step {name}: {err:.3g}"


def test_compressed_pods_route_their_own_tokens(jstates, rank_jobs):
    """(pod, data, model) = (2, 1, 1) under ``GRAD_FP8``: each pod routes
    its own half of the batch, the 1-rank step with two dispatch groups."""
    outs = [o["pods"][MIXTRAL] for o in rank_jobs["pods"].result()]
    batches = _batches(MIXTRAL)
    two = _one_rank_train(MIXTRAL, jstates[MIXTRAL], batches, moe_groups=2)
    assert outs[0]["metrics"] == outs[1]["metrics"]
    np.testing.assert_allclose(outs[0]["metrics"][0]["loss"],
                               two["metrics"][0]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(outs[0]["metrics"][0]["aux"],
                               two["metrics"][0]["aux"], rtol=LOSS_RTOL)
    for r, o in enumerate(outs):
        assert [x["G"] for x in o["routing"]] == [1, 1]
        # pod p's one group is the 1-rank step's group p
        _assert_routing(o["routing"], two["routing"], f"pods rank {r}",
                        first=o["coords"]["pod"])
    for k, want in two["grads"].items():
        err = _rel_l2(outs[0]["grads"][k], want)
        assert err <= COMPRESSED_REL_L2, (k, err)


def test_pod_mean_over_expert_shards(rank_jobs):
    """``GRAD_FP8``'s compressed pod mean of the moe leaves at (pod, data,
    model) = (2, 1, 2), the experts split over "model" (a K2 call an
    expert where a shard splits off its last dim, at the leaf's global
    flat indices), equals the unsplit (2, 1, 1) run's bit for bit, and
    lies within SR noise of the exact mean."""
    split, whole = rank_jobs["pod_mean"].result(), \
        rank_jobs["pod_mean_1"].result()
    per_pod = _moe_grads()
    for o in split + whole:
        for k, got in o["fp8"].items():
            np.testing.assert_array_equal(got, whole[0]["fp8"][k],
                                          err_msg=k)
    for k in per_pod[0]:
        exact = (per_pod[0][k] + per_pod[1][k]) / 2
        # E4M3 + SR: one draw's noise is under 5% of the gradient
        # (tests/test_torch_compression.py), the mean of two the same share
        assert _rel_l2(whole[0]["fp8"][k], exact) < 0.05, k
    assert split[0]["stats"]["all_reduce_max"]["calls"] > 0


def test_checkpoint_of_sharded_experts(rank_jobs, jstates):
    """fsdp=2 Qwen3-MoE: ``ckpt.save(mesh=)`` gathers each stacked expert
    leaf a layer at a time into the reference's format; the ranks restore
    their shards bit for bit, and JAX's ``ckpt.restore`` reads the final
    state, parameters equal to the gathered ones."""
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro.train import step as jstep
    outs = [o["train"][QWEN3] for o in rank_jobs["fsdp2"].result()]
    assert all(o["ckpt_equal"] for o in outs)
    like = jax.eval_shape(lambda: jstep.init_state(
        _jcfg(QWEN3), _jtcfg(), jax.random.PRNGKey(0)))
    got = jckpt.restore(str(rank_jobs["ckpt"]), STEPS, like)
    assert int(got.step) == STEPS
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(got.params):
        flat[jax.tree_util.keystr(path)] = np.asarray(leaf, np.float32)
    assert any("moe" in k for k in flat)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(
            leaf, _port_leaf_np(outs[0]["params"][-1], name), err_msg=name)


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
