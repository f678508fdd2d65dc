"""The gradient half of ``distributed/compression.py`` on the CPU: the
reference's own rules (tests/test_distributed.py:107-199) held in the port.

  * E4M3+SR compression (``GRAD_FP8``) through K2's plain version is
    unbiased and close, by the reference's 64-draw test with counter seeds
    in place of threefry keys: every element that is not clipped has a
    64-draw mean within half a grid gap (+ 1e-5) of the gradient, fewer
    than 2% are clipped, and one draw's noise std is under 5% of the
    gradient's; the block scales equal JAX's ``block_quantize``'s bit for
    bit (they take no random bits).
  * ``pod_mean_grads`` on gloo ranks at (pod, data, model) = (2, 1, 2),
    shards placed by the rule table (a column-sharded, a row-sharded and
    two replicated leaves): on the reference's own case (every pod holding
    its gradient, normal of PRNGKey(2), as its replicated leaf "w") the
    ``GRAD_FP8`` mean stays within SR noise of the exact mean, max |error|
    / std(g) < 0.2 (the reference's rule: it held for 96 of 100 SR seeds
    tried, the largest errors being the clipped block maxima, so it is
    checked on the reference's leaf only; its sharded copies, drawn with
    other leaf seeds, are held to the bound below); with two pods'
    different gradients, under
    ``GRAD_FP8`` and ``GRAD_FP4``, every element within the mean of the
    pods' grid gaps plus what the format clips; the same bits on every
    rank; with no config and with a disabled one the exact f32 mean bit
    for bit; at one pod the gradients themselves.
  * A train step with ``TrainConfig(compression=GRAD_FP8)`` at (pod, data,
    model) = (2, 1, 1) against the uncompressed one: the step-0 loss equal
    (rtol 1e-6: it precedes every update), the step-1 loss within rtol
    1e-3 and every leaf's update after two steps within relative L2 0.25
    of the uncompressed run's (E4M3 carries 3 mantissa bits: one SR draw
    moves an element by up to 1/8 of its value, more below the format's
    normal range, and AdamW's first steps normalise each element, so the
    noise reaches the update at its relative size: 0.16 seen); the
    uncompressed pod mean against the 1-rank step at the
    rules of tests/test_torch_train_mesh.py (loss rtol 1e-6, updates 3e-2).
  * A shard whose last dim splits a block is refused, naming the leaf.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _dist import pod_mean, run_ranks, smoke_cfg, train_steps
from repro_torch.core.quantize import _tensor_scale
from repro_torch.distributed import compression as comp
from repro_torch.kernels import counters
from repro_torch.kernels.nvfp4_quant import block_quantize

torch.set_num_threads(1)

POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
SEED = 0x600DF00D
REL_ERR = 0.2
STEP1_LOSS_RTOL = 1e-3
UPDATE_REL_L2 = 0.25


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def test_compressed_grads_unbiased_and_close():
    import jax.numpy as jnp
    from repro.core.quantize import block_quantize as jbq
    spec = comp.GRAD_FP8
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 512)).astype(np.float32))
    ts = _tensor_scale(torch.amax(torch.abs(g)), spec).reshape(1)
    draws = torch.stack([comp._fake_quant_rows(
        g.clone(), spec, ts, (comp.leaf_seed(SEED, 0, i), 512, 1))
        for i in range(64)])
    _, scales = block_quantize(g, spec, tscale=ts,
                               counter=(SEED, 512, 1))
    jqt = jbq(jnp.asarray(g.numpy()), spec.__class__(**{
        f: getattr(spec, f) for f in ("data_fmt", "scale_fmt", "block",
                                      "two_level")}), axis=-1)
    assert np.array_equal(np.asarray(jqt.scales, np.float32),
                          scales.numpy())
    assert float(jqt.tscale) == float(ts)
    denom = (scales.repeat_interleave(spec.block, 1) * ts).numpy()
    gn = g.numpy()
    ceil = spec.data.max * denom
    clipped = np.abs(gn) > ceil
    bias = np.abs(draws.mean(0).numpy() - gn)
    xhat = np.abs(gn) / denom
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(xhat, 2.0 ** -6)))
                  - spec.data.man_bits)
    ok = bias <= 0.5 * ulp * denom + 1e-5
    assert ok[~clipped].all(), bias[~clipped & ~ok].max()
    assert clipped.mean() < 0.02
    rel_noise = float(torch.std(draws[0] - g) / torch.std(g))
    assert 0 < rel_noise < 0.05


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"wq": rng.standard_normal((64, 64)).astype(np.float32),
            "wo": rng.standard_normal((64, 64)).astype(np.float32),
            "w": rng.standard_normal((64, 64)).astype(np.float32),
            "ln1": rng.standard_normal((64,)).astype(np.float32)}


def _reference_case():
    """The reference's own gradient (test_distributed.py: normal of
    PRNGKey(2), (64, 64)) as a replicated, a column-sharded and a
    row-sharded leaf."""
    import jax
    import jax.numpy as jnp
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64, 64),
                                     jnp.float32))
    return {"w": g, "wq": g.copy(), "wo": g.copy()}


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod_mean")
    per_pod = [_grads(1), _grads(2)]
    same = [_reference_case()] * 2
    shape, names = POD_MESH
    with ThreadPoolExecutor(2) as pool:
        a = pool.submit(run_ranks, pod_mean, 4, tmp, shape, names, per_pod,
                        SEED, [None, "off", "fp8", "fp4"])
        b = pool.submit(run_ranks, pod_mean, 4, tmp, shape, names, same,
                        SEED, ["fp8"])
        return per_pod, a.result(), b.result()


def test_pod_mean_exact_and_disabled_bitwise(pod_runs):
    per_pod, outs, _ = pod_runs
    for o in outs:
        for k in per_pod[0]:
            want = (per_pod[0][k] + per_pod[1][k]) / 2
            assert np.array_equal(o["None"][k], want), k
            assert np.array_equal(o["off"][k], want), k


def _sr_bound(g: np.ndarray, spec) -> np.ndarray:
    """Per element, how far one SR quantization of the leaf ``g`` can land
    from it: the grid gap at the element (its block scale x tensor scale
    times the data format's spacing there) plus what the format's maximum
    clips away."""
    x = torch.from_numpy(g.reshape(-1, g.shape[-1]))
    ts = _tensor_scale(torch.amax(torch.abs(x)), spec).reshape(1)
    _, scales = block_quantize(x, spec, tscale=ts, counter=(0, 1, 1))
    denom = (scales.repeat_interleave(spec.block, 1) * ts).numpy()
    xa = np.abs(x.numpy())
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(xa / denom,
                                              2.0 ** spec.data.emin)))
                  - spec.data.man_bits)
    clip = np.maximum(xa - spec.data.max * denom, 0)
    return (ulp * denom + clip).reshape(g.shape)


@pytest.mark.parametrize("spec", ["fp8", "fp4"])
def test_pod_mean_compressed_within_sr_noise(pod_runs, spec):
    per_pod, outs, same = pod_runs
    for o in outs[1:]:
        for k in per_pod[0]:
            assert np.array_equal(o[spec][k], outs[0][spec][k]), k
    qspec = {"fp8": comp.GRAD_FP8, "fp4": comp.GRAD_FP4}[spec]
    for k in per_pod[0]:
        want = (per_pod[0][k] + per_pod[1][k]) / 2
        err = np.abs(outs[0][spec][k] - want)
        bound = (_sr_bound(per_pod[0][k], qspec)
                 + _sr_bound(per_pod[1][k], qspec)) / 2
        assert (err <= bound + 1e-6).all(), (spec, k)
        assert err.max() > 0, (spec, k)
    if spec == "fp8":
        # the reference's rule on its own case (its replicated leaf "w"):
        # every pod holds the same gradient, max |error| / std < 0.2; the
        # sharded copies, quantized with other leaf seeds, within the SR
        # bound
        g = _reference_case()["w"]
        rel = np.abs(same[0]["fp8"]["w"] - g).max() / g.std()
        assert 0 < rel < REL_ERR, rel
        for k in ("wq", "wo"):
            err = np.abs(same[0]["fp8"][k] - g)
            assert (err <= _sr_bound(g, qspec) + 1e-6).all(), k
    assert outs[0]["stats"]["all_reduce_max"]["calls"] > 0


def test_pod_mean_refusals_and_one_pod():
    from repro_torch.distributed.mesh import Mesh
    one = Mesh((1, 1, 2), ("pod", "data", "model"),
               device=torch.device("cpu"))
    g = {"wq": torch.ones(64, 24)}
    assert comp.pod_mean_grads(g, SEED, one, comp.CompressionConfig()) is g
    two = Mesh((2, 1, 2), ("pod", "data", "model"),
               device=torch.device("cpu"))
    with pytest.raises(ValueError, match="wq"):
        comp.compressed_psum_mean(g, SEED, two, "pod", comp.GRAD_FP8, 2)


@pytest.fixture(scope="module")
def pod_steps(tmp_path_factory):
    import jax
    from repro.train import step as jstep
    from repro.configs import get_config
    from repro.optim import schedule as jsched
    tcfg = jstep.TrainConfig(sched=jsched.ScheduleConfig(
        warmup_steps=2, total_steps=10), probe_sigma=False)
    state = jax.tree_util.tree_map(np.asarray, jstep.init_state(
        get_config("llama2-60m").smoke(), tcfg, jax.random.PRNGKey(0)))
    from repro_torch.data import pipeline
    ds = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=smoke_cfg().vocab_size, seq_len=32, global_batch=2))
    batches = [ds.batch(i)["tokens"] for i in range(2)]
    tmp = tmp_path_factory.mktemp("pod_steps")
    shape, names = (2, 1, 1), ("pod", "data", "model")
    with ThreadPoolExecutor(2) as pool:
        plain, comp_ = (pool.submit(run_ranks, train_steps, 2, tmp, shape,
                                    names, state, batches, True, c)
                        for c in (False, True))
        return state, batches, plain.result(), comp_.result()


def test_compressed_train_step_against_uncompressed(pod_steps):
    state, batches, plain, comp_ = pod_steps
    for run in (plain, comp_):
        assert run[0]["metrics"] == run[1]["metrics"]
    np.testing.assert_allclose(comp_[0]["metrics"][0]["loss"],
                               plain[0]["metrics"][0]["loss"], rtol=1e-6)
    np.testing.assert_allclose(comp_[0]["metrics"][1]["loss"],
                               plain[0]["metrics"][1]["loss"],
                               rtol=STEP1_LOSS_RTOL)
    from _dist import _flat_tree
    from repro_torch.convert import params_from_jax_numpy
    start = _flat_tree(params_from_jax_numpy(state.params, smoke_cfg(),
                                             device="cpu"))
    for k, old in start.items():
        want = plain[0]["params"][-1][k] - old
        got = comp_[0]["params"][-1][k] - old
        # a leaf whose update is below a bf16 ulp (the norms at 1.0)
        # moves in neither run
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < UPDATE_REL_L2, (k, err)
    # the uncompressed pod mean is the 1-rank step
    from repro_torch.convert import train_state_from_jax_numpy
    from repro_torch.core import fqt
    from repro_torch.optim import schedule
    from repro_torch.train import step as st
    one = train_state_from_jax_numpy(state, smoke_cfg(), device="cpu")
    fn = st.make_train_step(smoke_cfg(), fqt.nvfp4_paper_config(),
                            st.TrainConfig(sched=schedule.ScheduleConfig(
                                warmup_steps=2, total_steps=10)))
    for i, tokens in enumerate(batches):
        one, m = fn(one, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(plain[0]["metrics"][i]["loss"],
                                   float(m["loss"]), rtol=1e-6)
    mine = _flat_tree(one.params)
    for k, old in start.items():
        want = mine[k] - old
        err = np.linalg.norm(plain[0]["params"][-1][k] - old - want) \
            / max(np.linalg.norm(want), 1e-30)
        assert err < 3e-2, (k, err)
