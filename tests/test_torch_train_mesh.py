"""The port's training mesh against the JAX package and its own 1-rank step,
on gloo CPU ranks (tests/_dist.py).

  * Specs: ``batch_spec`` / ``batch_shardings``, ``opt_state_shardings``,
    ``params_shardings``, ``cache_specs`` and ``_constrain_spec`` (every
    kind, both modes) equal the reference's leaf for leaf on stand-in
    meshes (tests/test_distributed.py's ``_FakeMesh``; the reference's
    ``NamedSharding`` unwrapped to its spec), for the llama2-60m smoke tree
    and llama2-7b's full shapes, at tp 2, fsdp=2, dp=2,tp=2 and (pod, data,
    model) = (2, 2, 2).
  * ``formats.counter_at``: a row, column or transposed (``a_strides``)
    shard's counter draws the whole operand's ``counter_bits`` slice, bit
    for bit.
  * The sharded FQT matmul (``fqt._ShardedFP4Matmul``) at tp=2 (column
    "io", row "oi", the lm_head "d_vocab"), fsdp=2 (the weight gathered,
    the tokens split: DP on M) and dp=2,tp=2: every K1 call's quantized
    operands (code x block scale, and the tensor scales) equal the 1-rank
    call's slice BIT FOR BIT; y, dx and dw within 1e-5 (relative to max
    |.|) of the port's 1-rank ``fp4_matmul`` and of JAX's.
  * Train steps of llama2-60m smoke under ``nvfp4_paper_config`` (batch 2 x
    seq 32, the dense attention branch, where the port's 1-rank gradients
    of the GEMM weights are JAX's bit for bit; the contractions split over
    "model" sum their ranks' f32 partial products in an all-reduce, which
    at this width rounds as the 1-device GEMM does -- at llama2-7b's it
    does not, see chip_smoke.py's phase train_mesh) at tp=2, fsdp=2 and
    dp=2,tp=2, from
    JAX's initial state through ``convert.train_state_from_jax_numpy`` and
    ``place_train_state``, against JAX's 1-device ``make_train_step``: the
    step-0 loss at rtol 1e-6, every GEMM-weight gradient at relative L2
    1e-6 and every other leaf at 3e-2, two steps' losses at rtol 1e-6 and
    each leaf's update at relative L2 3e-2 (tests/test_torch_train.py's
    rules and reasons: the 1-D leaves are token sums that XLA and torch
    reduce in another order, which the DP split changes again); dp=2,tp=2
    also against JAX's ``jit_train_step`` on 4 forced host devices (one
    step).  Every rank's metrics are equal; sigma_q equals the port's
    1-rank probe at rtol 1e-5 at tp=2, whose gradients are the 1-rank ones
    bit for bit (the f32 sums over ranks in another order), and at 1e-2
    under DP, where the 1-D leaves' gradients move by ~1e-3.
  * ``Trainer(mesh=)`` 2 steps at tp=2 with ``ckpt_every=2`` (the kill),
    restarted at fsdp=2 to step 3: the events are a 1-rank restart's, the
    losses within rtol 1e-4 of an uninterrupted 1-rank run, the
    checkpoint is read by JAX's ``ckpt.restore``, the export equals the
    1-rank export of the same parameters bit for bit.
  * Refusals: the families not yet ported to a mesh (hybrid, ssm, encdec;
    moe and vlm: tests/test_torch_mesh_families.py), mode "sp", an
    undividable split, a block that straddles a shard, a wrong rank count.

JAX's reference jobs run in 3 subprocesses (``_jax_ref.Reference``; this
file as a script with excess precision off and 4 forced host devices), and
every rank job of the module starts beside them at the module's first test
(``rank_jobs``): one session of ranks per mesh (the sharded matmul, then
the train steps) and the Trainer's kill and restart.
"""
import os
import sys

if __name__ == "__main__":       # the reference's forced host devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=4")

import dataclasses
import shutil
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _dist import (mesh_session, reduce_scatter_case, run_ranks, smoke_cfg,
                   trainer_run)
from _jax_ref import Reference, run_jobs
from repro_torch.core import fqt
from repro_torch.core import formats as tf
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import Mesh, MeshShape, make_mesh
from repro_torch.distributed.specs import strip_trailing_none
from repro_torch.kernels import counters
from repro_torch.kernels.nvfp4_quant import counter_rbits

torch.set_num_threads(1)

ARCH = "llama2-60m"
BATCH, SEQ, STEPS = 2, 32, 2
MM_SEED = 0x5EED1234
MESHES = {"tp2": ((2,), ("model",)), "fsdp2": ((2,), ("data",)),
          "dp2tp2": ((2, 2), ("data", "model"))}
LOSS_RTOL = 1e-6
GEMM_REL_L2 = 1e-6
REL_L2 = 3e-2
MM_TOL = 1e-5
SIGMA_RTOL = {"tp2": 1e-5, "fsdp2": 1e-2, "dp2tp2": 1e-2}
RESTART_LOSS_RTOL = 1e-4


def _jcfg():
    from repro.configs import get_config
    return get_config(ARCH).smoke()


def _tokens(step):
    from repro_torch.data import pipeline
    ds = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=smoke_cfg().vocab_size, seq_len=SEQ, global_batch=BATCH))
    return ds.batch(step)["tokens"]


def _mm_operands():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 16, 64)) * 2).astype(np.float32)
    w = (rng.standard_normal((64, 64)) * 64 ** -0.5).astype(np.float32)
    g = (rng.standard_normal((4, 16, 64)) * 1e-2).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return bf(x), bf(w), bf(g)


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


def _job_steps(ref):
    """Grads at step 0 and two steps of the 1-device ``make_train_step``
    from ``init_state(PRNGKey(0))`` (probe off: its threefry draws are a
    declared divergence and touch no parameter)."""
    import jax
    import jax.numpy as jnp
    from repro.core import fqt as jfqt
    from repro.models import registry as jreg
    from repro.train import step as jstep
    cfg, qcfg = _jcfg(), jfqt.nvfp4_paper_config()
    state = jstep.init_state(cfg, _jtcfg(), jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(0))
    _, grads = jax.jit(jax.value_and_grad(lambda p: jreg.loss_fn(
        p, cfg, qcfg, {"tokens": toks}, seed=jnp.uint32(1),
        remat=True)[0]))(state.params)
    _flat_jax("grads", grads, ref)
    train_step = jstep.make_train_step(cfg, qcfg, _jtcfg())
    for i in range(STEPS):
        state, m = train_step(state, {"tokens": jnp.asarray(_tokens(i))})
        ref[f"step{i}/loss"] = np.float32(m["loss"])
        ref[f"step{i}/grad_norm"] = np.float32(m["grad_norm"])
        _flat_jax(f"params{i}", state.params, ref)


def _job_jit(ref):
    """One step of ``jit_train_step`` at dp=2,tp=2 on 4 host devices."""
    import jax
    import jax.numpy as jnp
    from repro.core import fqt as jfqt
    from repro.train import step as jstep
    from jax.sharding import Mesh as JMesh
    assert len(jax.devices()) == 4
    cfg, qcfg = _jcfg(), jfqt.nvfp4_paper_config()
    # GSPMD (automatic) axes, as the reference's own meshes are built
    mesh = JMesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    state = jstep.init_state(cfg, _jtcfg(), jax.random.PRNGKey(0))
    state = jax.device_put(state, jstep.state_shardings(state, mesh))
    fn = jstep.jit_train_step(cfg, qcfg, _jtcfg(), mesh, state)
    with mesh:
        state, m = fn(state, {"tokens": jnp.asarray(_tokens(0))})
    ref["jit/loss"] = np.float32(m["loss"])
    _flat_jax("jit/params", state.params, ref)


def _job_matmul(ref):
    """JAX's ``fp4_matmul`` and its vjp at the sharded-matmul operands."""
    import jax
    import jax.numpy as jnp
    from repro.core import fqt as jfqt
    x, w, g = (jnp.asarray(a, jnp.bfloat16) for a in _mm_operands())
    y, pull = jax.vjp(lambda x, w: jfqt.fp4_matmul(
        x, w, cfg=jfqt.nvfp4_paper_config(), seed=jnp.uint32(MM_SEED)),
        x, w)
    dx, dw = pull(g)
    for k, v in (("y", y), ("dx", dx), ("dw", dw)):
        ref[f"mm/{k}"] = np.asarray(v, np.float32)


def write_jax_reference(out_path, part, parts):
    run_jobs([_job_steps, _job_jit, _job_matmul], out_path, part, parts)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_train_mesh"),
                    parts=3)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jstate_np():
    """JAX's initial TrainState with numpy leaves (the subprocesses draw
    the same from PRNGKey(0))."""
    import jax
    from repro.train import step as jstep
    state = jstep.init_state(_jcfg(), _jtcfg(), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state)


def _kinds(mesh_name):
    return ("io", "oi", "d_vocab") if mesh_name == "tp2" else ("io", "oi")


def _restart_chain(tmp):
    """``Trainer(mesh=)`` at tp=2 for 2 steps with ``ckpt_every=2`` (the
    kill), its checkpoint copied aside for the 1-rank restart, then the
    restart at fsdp=2 to step 3.  Returns both runs' rank outputs and the
    mesh runs' checkpoint directory."""
    d = tmp / "mesh"
    first = run_ranks(trainer_run, 2, tmp, (2,), ("model",), str(d), 2, 2)
    shutil.copytree(d, tmp / "solo")
    second = run_ranks(trainer_run, 2, tmp, (2,), ("data",), str(d), 3, 2)
    return first, second, d


@pytest.fixture(scope="module", autouse=True)
def rank_jobs(tmp_path_factory, jax_ref, jstate_np):
    """Every rank job of the module, started at its first test beside
    JAX's reference jobs (each rank a process on one thread): per mesh one
    session of its ranks (``_dist.mesh_session``), and ``_restart_chain``.
    Tests take their results from the futures."""
    tmp = tmp_path_factory.mktemp("rank_jobs")
    batches = [_tokens(i) for i in range(STEPS)]
    mm = _mm_operands() + (MM_SEED,)
    pool = ThreadPoolExecutor(len(MESHES) + 1)
    jobs = {name: pool.submit(run_ranks, mesh_session, int(np.prod(shape)),
                              tmp / name, shape, names, _kinds(name), mm,
                              jstate_np, batches)
            for name, (shape, names) in MESHES.items()}
    jobs["restart"] = pool.submit(_restart_chain, tmp / "restart")
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


# ---- specs against the reference --------------------------------------------


SPEC_MESHES = [((2,), ("model",)), ((2,), ("data",)),
               ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data",
                                                         "model"))]


def _fake(shape, names):
    """The reference's stand-in mesh (axis names, device shape)."""
    import math
    return types.SimpleNamespace(axis_names=names, devices=types.
                                 SimpleNamespace(shape=shape,
                                                 size=math.prod(shape)))


@pytest.fixture
def jshd(monkeypatch):
    """The reference's sharding module with ``NamedSharding(mesh, spec)``
    unwrapped to the spec (the stand-in mesh is no device mesh), in its
    train step's ``state_shardings`` too."""
    from repro.distributed import sharding as js
    from repro.train import step as jstep
    monkeypatch.setattr(js, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jstep, "NamedSharding", lambda mesh, spec: spec)
    return js


def _meta_tree(jtree):
    """The port's parameter tree (per-layer dicts) of the reference's
    shape structs (stacked layers), as meta tensors."""
    def meta(s):
        return torch.empty(tuple(s.shape), device="meta")

    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return torch.empty(tuple(t.shape[1:]), device="meta")

    out = {k: meta(v) for k, v in jtree.items() if k != "layers"}
    n = next(iter(jtree["layers"]["attn"].values())).shape[0]
    out["layers"] = [unstack(jtree["layers"], i) for i in range(n)]
    return out


@pytest.mark.parametrize("shape,names", SPEC_MESHES)
def test_training_specs_match_reference(jshd, shape, names):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import registry as jreg
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep
    from repro_torch.optim import adamw
    jm, pm = _fake(shape, names), MeshShape(shape, names)
    assert tuple(jshd.batch_spec(jm)) == sharding.batch_spec(pm)
    batch = {"tokens": (8, 33), "odd": (3, 5), "scalar": ()}
    jb = jshd.batch_shardings({k: jax.ShapeDtypeStruct(v, jnp.int32)
                               for k, v in batch.items()}, jm)
    pb = sharding.batch_shardings({k: torch.empty(v, device="meta")
                                   for k, v in batch.items()}, pm)
    assert {k: tuple(v) for k, v in jb.items()} == pb
    for arch in (ARCH, "llama2-7b"):
        jc = jget(arch).smoke() if arch == ARCH else jget(arch)
        jp = jax.eval_shape(lambda: jreg.init_params(jc,
                                                     jax.random.PRNGKey(0)))
        want = jshd.params_specs(jp, jm)
        pp = _meta_tree(jp)
        got = sharding.params_shardings(pp, pm)
        for lname in ("embed", "lm_head", "ln_f"):
            assert tuple(want[lname]) == got[lname], (arch, lname)
        for blk in ("attn", "mlp"):
            for k, v in want["layers"][blk].items():
                assert tuple(v) == strip_trailing_none(
                    (None,) + got["layers"][0][blk][k]), (arch, blk, k)
        jopt = jshd.opt_state_shardings(
            jax.eval_shape(lambda p: jadamw.init(p, jadamw.AdamWConfig()),
                           jp),
            want, jm)
        popt = sharding.opt_state_shardings(
            adamw.AdamWState(0, pp, pp, pp), got, pm)
        assert tuple(jopt.step) == popt.step == ()
        assert popt.master is got and popt.m is got and popt.v is got
        assert jopt.master is want and jopt.v is want
        # the whole TrainState's specs (train/step.py's state_shardings)
        from repro_torch.core import threshold
        from repro_torch.train import step as st
        jst = jstep.state_shardings(jax.eval_shape(
            lambda: jstep.init_state(jc, _jtcfg(), jax.random.PRNGKey(0))),
            jm)
        pst = st.state_shardings(st.TrainState(
            0, pp, adamw.AdamWState(0, pp, pp, pp), threshold.init("meta")),
            pm)
        assert tuple(jst.step) == pst.step == ()
        assert pst.params == got and pst.opt.master == got
        assert pst.opt.m == got and pst.opt.v == got
        assert tuple(jst.opt.step) == pst.opt.step == ()
        assert {f: tuple(getattr(jst.thr, f)) for f in jst.thr._fields} \
            == dataclasses.asdict(pst.thr)
    caches = {"kv": (4, 256, 8, 32), "stacked": (2, 4, 256, 8, 32),
              "ssm": (4, 8, 64, 16), "conv": (4, 3, 96), "len": (4,),
              "odd": (3, 7, 5)}
    for b in (4, 3):
        jc = jshd.cache_specs({k: jax.ShapeDtypeStruct(v, jnp.float32)
                               for k, v in caches.items()}, jm, b)
        pc = sharding.cache_specs({k: torch.empty(v, device="meta")
                                   for k, v in caches.items()}, pm, b)
        assert {k: tuple(v) for k, v in jc.items()} == pc, b
    shapes = {"res": [(4, 32, 128), (3, 5, 7)], "hidden": [(4, 32, 256)],
              "heads": [(4, 32, 8, 32), (4, 32, 3, 32)],
              "logits": [(4, 32, 512)], "tokens": [(128, 128), (7, 3)],
              "experts": [(8, 16, 128)], "groups": [(4, 8, 16)],
              "qblocks": [(4, 2, 16, 4, 2, 32), (4, 2, 16, 3, 2, 32),
                          (4, 2, 16, 1, 3, 32), (4, 2, 16, 3, 3, 32)]}
    for kind, ss in shapes.items():
        for s in ss:
            for mode in ("replicated", "sp"):
                assert tuple(jshd._constrain_spec(kind, s, jm, mode)) == \
                    sharding._constrain_spec(kind, s, pm, mode), \
                    (kind, s, mode)


def test_activation_scope_and_constrain():
    pm = MeshShape((2,), ("model",))
    x = torch.ones(4, 8, 16)
    assert sharding.constrain(x, "res") is x
    with sharding.activation_sharding_scope(pm, "replicated"):
        assert sharding._ACT_CTX.get() == (pm, "replicated")
        assert sharding.constrain(x, "res") is x
        with pytest.raises(ValueError, match="unknown constraint"):
            sharding.constrain(x, "nope")
    assert sharding._ACT_CTX.get() is None
    with pytest.raises(NotImplementedError, match="'sp'"):
        with sharding.activation_sharding_scope(pm):
            pass
    with pytest.raises(ValueError):
        with sharding.activation_sharding_scope(pm, "bogus"):
            pass


# ---- SR counters on shards ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 0xDEADBEEF, 12345])
def test_counter_at_draws_the_whole_operands_slice(seed):
    M, K = 48, 64
    full = tf.counter_bits(seed, (M, K))
    # a row block, a column block, a block of both
    for r0, r1, c0, c1 in ((16, 32, 0, K), (0, M, 32, 64), (16, 48, 16, 48)):
        got = counter_rbits((r1 - r0, c1 - c0),
                            (tf.counter_at(seed, r0 * K + c0), K, 1))
        assert torch.equal(got, full[r0:r1, c0:c1])
    # x^T's bits as dW reads them (a_strides (1, K)): element (k, m) at
    # m * K + k; a DP shard of tokens [m0, m1) and a K shard [k0, k1)
    for m0, m1, k0, k1 in ((16, 32, 0, K), (0, 16, 32, 64)):
        got = counter_rbits((k1 - k0, m1 - m0),
                            (tf.counter_at(seed, m0 * K + k0), 1, K))
        assert torch.equal(got, full.T[k0:k1, m0:m1])
    # offsets wrap mod 2^32 as the kernel's index does
    big = (1 << 32) - 5
    assert tf.counter_at(seed, big) == (seed + big * 0x9E3779B9) & tf.M32


# ---- the sharded FQT matmul ---------------------------------------------------


def _one_rank_matmul(kind):
    """The 1-rank fp4_matmul at the same operands, and its K1 calls'
    quantized operands."""
    from _dist import _record_k1
    x, w, g = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _mm_operands())
    x.requires_grad_(True)
    w.requires_grad_(True)
    calls = []
    undo = _record_k1(calls)
    try:
        y = fqt.fp4_matmul(x, w, cfg=fqt.nvfp4_paper_config(), seed=MM_SEED)
        dx, dw = torch.autograd.grad(y, (x, w), g)
    finally:
        undo()
    return ({"y": y.detach().float().numpy(), "dx": dx.float().numpy(),
             "dw": dw.float().numpy()}, calls)


def _slices(kind, coords, shape, names, M, K, N):
    """Each of the three K1 calls' operand slices of the 1-rank call on a
    rank at ``coords``: rows of the tokens, the model split's columns."""
    mesh = MeshShape(shape, names)
    sizes = dict(zip(names, shape))
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    di = coords["pod"] * sizes.get("data", 1) + coords["data"]
    ml = M // dp
    m = slice(di * ml, (di + 1) * ml)
    tp, r = sizes.get("model", 1), coords["model"]
    del mesh
    if kind == "oi":
        k = slice(r * K // tp, (r + 1) * K // tp)
        a = [(m, k), (m, slice(None)), (k, m)]
        b = [(k, slice(None)), (slice(None), k), (m, slice(None))]
    else:
        n = slice(r * N // tp, (r + 1) * N // tp)
        a = [(m, slice(None)), (m, n), (slice(None), m)]
        b = [(slice(None), n), (n, slice(None)), (m, n)]
    return a, b, m


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_fp4_matmul_bitwise_operands(jax_ref, rank_jobs, mesh_name):
    shape, names = MESHES[mesh_name]
    kinds = _kinds(mesh_name)
    x, w, g = _mm_operands()
    outs = [o["matmul"] for o in rank_jobs[mesh_name].result()]
    ref = jax_ref.result()
    M, K, N = x.shape[0] * x.shape[1], w.shape[0], w.shape[1]
    for kind in kinds:
        one, one_calls = _one_rank_matmul(kind)
        for k in ("y", "dx", "dw"):
            want = ref[f"mm/{k}"]
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(one[k], want, rtol=0,
                                       atol=MM_TOL * scale, err_msg=k)
        path = {"io": "wq", "oi": "wo", "d_vocab": "lm_head"}[kind]
        for rank, o in enumerate(outs):
            got = o[kind]
            assert len(got["calls"]) == len(one_calls) == 3
            sa, sb, m = _slices(kind, o["coords"], shape, names, M, K, N)
            for i, ((da, db, ta, tb), (fa, fb, wa, wb)) in enumerate(
                    zip(got["calls"], one_calls)):
                assert (ta, tb) == (wa, wb), (kind, rank, i)
                assert np.array_equal(da, fa[sa[i]]), (kind, rank, i, "a")
                assert np.array_equal(db, fb[sb[i]]), (kind, rank, i, "b")
            # outputs: this rank's block of the 1-rank results
            pmesh = Mesh(shape, names, device=torch.device("cpu"), rank=rank)
            tp, r = pmesh.axis_size("model"), pmesh.axis_index("model")
            y2, dx2 = one["y"].reshape(M, N), one["dx"].reshape(M, K)
            ny, kx = (slice(None), slice(r * K // tp, (r + 1) * K // tp)) \
                if kind == "oi" else (slice(r * N // tp, (r + 1) * N // tp),
                                      slice(None))
            spec = sharding.placed_spec(path, 2, pmesh)
            want_dw = sharding.local_shard(torch.from_numpy(one["dw"]), spec,
                                           pmesh).numpy()
            for k, a, b in (("y", got["y"].reshape(-1, got["y"].shape[-1]),
                             y2[m, ny]),
                            ("dx", got["dx"].reshape(-1, got["dx"].shape[-1]),
                             dx2[m, kx]),
                            ("dw", got["dw"], want_dw)):
                scale = float(np.abs(one[k]).max())
                np.testing.assert_allclose(a, b, rtol=0, atol=MM_TOL * scale,
                                           err_msg=f"{kind} {k} rank {rank}")
        if "data" in names:
            assert outs[0][kind]["stats"]["fsdp_gather"]["calls"] == 2
            assert outs[0][kind]["stats"]["reduce_scatter"]["calls"] == 1


# ---- train steps against JAX --------------------------------------------------


def _port_leaf_np(flat, name):
    """The port's gathered leaf (per-layer, flat paths) behind a reference
    leaf name, the layers stacked."""
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    if keys[0] != "layers":
        return flat["/" + "/".join(keys)]
    n = len([p for p in flat if p.startswith("/layers/")
             and p.endswith("/" + "/".join(keys[1:]))])
    return np.stack([flat[f"/layers/{i}/" + "/".join(keys[1:])]
                     for i in range(n)])


@pytest.fixture(scope="module")
def mesh_steps(rank_jobs):
    """Each mesh's train steps (probe on), from its rank session."""
    return {name: [o["steps"] for o in rank_jobs[name].result()]
            for name in MESHES}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_train_steps_match_jax(jax_ref, jstate_np, mesh_steps, mesh_name):
    outs = mesh_steps[mesh_name]
    ref = jax_ref.result()
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"], "ranks disagree"
    o = outs[0]
    names = [k[len("grads"):] for k in ref if k.startswith("grads")]
    assert len(names) == 13
    for name in names:
        want = ref["grads" + name]
        got = _port_leaf_np(o["grads"], name)
        assert got.shape == want.shape, name
        tol = GEMM_REL_L2 if want.ndim == 3 else REL_L2
        err = _rel_l2(got, want)
        assert err <= tol, f"{mesh_name} grad {name}: {err:.3g} > {tol}"
    start = {}
    from repro_torch.convert import params_from_jax_numpy
    start = params_from_jax_numpy(jstate_np.params, smoke_cfg(),
                                  device="cpu")
    from _dist import _flat_tree
    start = _flat_tree(start)
    for i in range(STEPS):
        np.testing.assert_allclose(o["metrics"][i]["loss"],
                                   ref[f"step{i}/loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(o["metrics"][i]["grad_norm"],
                                   ref[f"step{i}/grad_norm"], rtol=REL_L2)
        for name in names:
            old = _port_leaf_np(start, name)
            got = _port_leaf_np(o["params"][i], name) - old
            want = ref[f"params{i}" + name] - old
            err = _rel_l2(got, want)
            assert err <= REL_L2, f"{mesh_name} step {i} {name}: {err:.3g}"
    if mesh_name == "dp2tp2":
        np.testing.assert_allclose(o["metrics"][0]["loss"], ref["jit/loss"],
                                   rtol=LOSS_RTOL)
        for name in names:
            old = _port_leaf_np(start, name)
            err = _rel_l2(_port_leaf_np(o["params"][0], name) - old,
                          ref["jit/params" + name] - old)
            assert err <= REL_L2, f"jit_train_step {name}: {err:.3g}"


def test_train_steps_sigma_and_collectives(jstate_np, mesh_steps):
    """sigma_q (the probe on shards: global tensor scales and SR indices)
    against the port's 1-rank step; the collectives each mesh makes."""
    from repro_torch.convert import train_state_from_jax_numpy
    from repro_torch.optim import schedule
    from repro_torch.train import step as st
    cfg = smoke_cfg()
    state = train_state_from_jax_numpy(jstate_np, cfg, device="cpu")
    fn = st.make_train_step(cfg, fqt.nvfp4_paper_config(), st.TrainConfig(
        sched=schedule.ScheduleConfig(warmup_steps=2, total_steps=10)))
    want = []
    for i in range(STEPS):
        state, m = fn(state, {"tokens": torch.from_numpy(_tokens(i))})
        want.append(float(m["sigma_q"]))
    for name, outs in mesh_steps.items():
        got = [m["sigma_q"] for m in outs[0]["metrics"]]
        np.testing.assert_allclose(got, want, rtol=SIGMA_RTOL[name],
                                   err_msg=name)
        ops = outs[0]["stats"]["ops"]
        assert ops["all_reduce_max"]["calls"] > 0, name
        if "data" in MESHES[name][1]:
            assert ops["fsdp_gather"]["bytes"] > 0, name
            assert ops["reduce_scatter"]["bytes"] > 0, name
        else:
            assert "fsdp_gather" not in ops, name


# ---- Trainer(mesh=): kill, restart at another mesh, export ---------------------


def test_trainer_mesh_restart_checkpoint_and_export(tmp_path, rank_jobs):
    from repro.checkpoint import ckpt as jckpt
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import schedule
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import step as st
    cfg = smoke_cfg()

    def one_rank(ckpt_dir, total):
        tr = Trainer(cfg, fqt.nvfp4_paper_config(), st.TrainConfig(
            sched=schedule.ScheduleConfig(warmup_steps=2, total_steps=10)),
            TrainerConfig(total_steps=total, ckpt_every=2,
                          ckpt_dir=str(ckpt_dir), log_every=1),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                       global_batch=4), device="cpu")
        tr.run()
        return tr

    straight = one_rank(tmp_path / "straight", 3)
    first, second, d = rank_jobs["restart"].result()
    assert ckpt.latest_step(str(d.parent / "solo")) == 2
    solo = one_rank(d.parent / "solo", 3)
    for run in (first, second):
        assert all(r["events"] == run[0]["events"] for r in run)
        assert all(r["history"] == run[0]["history"] for r in run)
    assert second[0]["events"] == solo.events
    assert [e["kind"] for e in solo.events] == ["restore", "export_packed"]
    losses = [h["loss"] for h in first[0]["history"] + second[0]["history"]]
    np.testing.assert_allclose(losses, [h["loss"] for h in straight.history],
                               rtol=RESTART_LOSS_RTOL)
    assert first[0]["trace"] > 0 and first[1]["trace"] == 0
    # JAX reads the mesh's checkpoint
    import jax
    from repro.train import step as jstep
    like = jax.eval_shape(lambda: jstep.init_state(_jcfg(), _jtcfg(),
                                                   jax.random.PRNGKey(0)))
    jstate = jckpt.restore(str(d), 3, like)
    assert int(jstate.step) == 3
    # the export equals the 1-rank export of the same final parameters
    from repro_torch.train.step import TrainState, state_from_params
    from repro_torch.models import registry
    like = state_from_params(registry.init_params(cfg, device="cpu"),
                             st.TrainConfig())
    final = ckpt.restore(str(d), 3, like)
    assert isinstance(final, TrainState)
    tr = Trainer(cfg, fqt.nvfp4_paper_config(), st.TrainConfig(),
                 TrainerConfig(ckpt_dir=str(tmp_path / "export1")),
                 DataConfig(cfg.vocab_size, 8, 2), device="cpu")
    path = tr.export_serving_artifact(final)
    mine = d / "serve_packed" / "step_00000003" / "shard_0.npz"
    with np.load(mine) as a, np.load(os.path.join(
            path, "shard_0.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


# ---- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("shape,names", [((2,), ("data",)),
                                         ((4,), ("data",))])
def test_reduce_scatter_sums_in_rank_order(tmp_path, shape, names):
    """gloo's reduce-scatter (an all-to-all of the shards through the
    host): each rank's shard of the ranks' tensors summed in rank order,
    bit for bit (at two ranks the bits of an all-reduce and a slice),
    along dims 0 and 1, counted once with the whole tensor's bytes."""
    n, seed = shape[0], 7
    outs = run_ranks(reduce_scatter_case, n, tmp_path, shape, names, seed)
    ts = [torch.randn((8, 12, 4),
                      generator=torch.Generator().manual_seed(seed + r))
          for r in range(n)]
    total = ts[0].clone()
    for t in ts[1:]:
        total += t
    for r, out in enumerate(outs):
        i = out["coords"]["data"]
        for dim in (0, 1):
            size = total.shape[dim] // n
            assert torch.equal(out[dim], total.narrow(dim, i * size, size))
            assert out[dim].is_contiguous()
            assert out[f"stats{dim}"]["calls"] == 1
            assert out[f"stats{dim}"]["bytes"] == total.numel() * 4


def test_training_mesh_refusals():
    """The hybrid, ssm and encdec families, refused once, build a train
    step at tp=2 and place their state there (their steps are
    tests/test_torch_mesh_encdec_recurrent.py's); what still raises: an
    undividable split, a block straddling two ranks, too few ranks."""
    from repro_torch.configs import get_config
    from repro_torch.train import step as st
    from repro_torch.models import registry
    cpu = torch.device("cpu")
    two = Mesh((2,), ("model",), device=cpu)
    for arch in ("zamba2-1.2b", "xlstm-125m", "whisper-base"):
        cfg = get_config(arch).smoke()
        registry.check_mesh(cfg, two)
        assert callable(st.make_train_step(cfg, fqt.nvfp4_paper_config(),
                                           st.TrainConfig(), two))
        state = sharding.place_train_state(
            st.init_state(cfg, st.TrainConfig(), device="cpu"), two)
        assert state.params["embed"].shape == (cfg.padded_vocab // 2,
                                               cfg.d_model)
    # an undividable split names its leaf
    with pytest.raises(ValueError, match="mlp/w_up"):
        sharding.place_train_params({"mlp": {"w_up": torch.zeros(128, 33)}},
                                    two)
    # a block that straddles two ranks: N = 2 x 24 columns, blocks of 16
    w = torch.zeros(64, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="straddle"):
        fqt.fp4_matmul(torch.ones(32, 64, dtype=torch.bfloat16), w,
                       cfg=fqt.nvfp4_paper_config(), mesh=two, kind="io")
    # tokens split over "data" off the block
    dp = Mesh((2,), ("data",), device=cpu)
    with pytest.raises(ValueError, match="tokens"):
        fqt.fp4_matmul(torch.ones(8, 32, dtype=torch.bfloat16),
                       torch.zeros(32, 32, dtype=torch.bfloat16),
                       cfg=fqt.nvfp4_paper_config(), mesh=dp, kind="oi")
    # a batch the DP axes do not divide
    with pytest.raises(ValueError, match="DP axes"):
        st.local_batch({"tokens": torch.zeros(3, 9)}, dp)
    # a shape that needs another number of ranks
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    with pytest.raises(ValueError, match="do not pair"):
        make_mesh((2, 2), ("data",), device="cpu")


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
