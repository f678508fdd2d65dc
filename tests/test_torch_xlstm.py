"""The port's ssm family (xLSTM: mLSTM and sLSTM blocks) against the JAX
package, on the CPU.

``xlstm-125m.smoke()`` (4 blocks, the fourth sLSTM, d 128, 4 heads of 64)
from the same JAX-initialised parameters, carried across with
``convert.params_from_jax_numpy`` (the reference's list of mixed blocks
stays a list).  The JAX reference runs in subprocesses with excess
precision off (``tests/_jax_ref.py``); ``python <this file> OUT PART PARTS``
writes a part of it.  The model-level cases are shared with
tests/test_torch_mamba2.py (``tests/_recurrent.py``, which states their
tolerances).

Held here at rtol = atol = 2e-5 (f32 sums and transcendentals in torch's
order): the chunked mLSTM core (``_mlstm_chunked``) and its final state; the
sLSTM's time loop (``slstm_apply`` over 16 tokens from a state) in its final
(c, n, h, m); three recurrent decode steps of an mLSTM and of an sLSTM block
in their states, with the blocks' bf16 outputs bit for bit; the port's
chunked mLSTM against its own S recurrent steps.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _recurrent as R
from _jax_ref import Reference, run_jobs
from repro.configs import get_config as jax_get_config
from repro.core import fqt as jfqt
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import fqt
from repro_torch.kernels import counters
from repro_torch.models import xlstm
from repro_torch.models.layers import QCtx

torch.set_num_threads(1)

ARCH = "xlstm-125m"
REF_PARTS = 3
CORE_TOL = 2e-5
# (name, S, chunk)
MLSTM_CASES = (("chunks", 64, 16), ("one chunk", 32, 32))
DECODE_STEPS = 3
SLSTM_SEQ = 16
SLSTM_LAYER = 3                  # the smoke config's sLSTM block


def _mlstm_inputs(S, H=4, P=64, seed=21):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, S, H, P)).astype(np.float32)
               for _ in range(3))
    li = np.minimum(rng.standard_normal((2, S, H)) * 2, 3.0).astype(
        np.float32)
    lf = -np.log1p(np.exp(-rng.standard_normal((2, S, H)) - 2)).astype(
        np.float32)
    return q, k, v, li, lf


def _block_inputs(cfg, S):
    """(x (S, B, 1, d) bf16, mLSTM state, sLSTM state)."""
    import ml_dtypes
    d_inner, H, P = xlstm._dims(cfg)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((S, 2, 1, cfg.d_model)).astype(
        ml_dtypes.bfloat16)
    mstate = (rng.standard_normal((2, H, P, P)).astype(np.float32) * 0.1,
              rng.standard_normal((2, H, P)).astype(np.float32))
    d = cfg.d_model
    sstate = tuple(rng.standard_normal((2, d)).astype(np.float32)
                   for _ in range(3)) + (
        rng.standard_normal((2, d)).astype(np.float32) - 2.0,)
    return x, mstate, sstate


def _ref_cores(ref):
    from repro.models import xlstm as jx
    from repro.models.layers import QCtx as JQCtx
    for name, S, chunk in MLSTM_CASES:
        ins = [jnp.asarray(a) for a in _mlstm_inputs(S)]
        y, (C, n) = jax.jit(lambda *a: jx._mlstm_chunked(*a, chunk))(*ins)
        ref[f"mlstm/{name}/y"] = np.asarray(y)
        ref[f"mlstm/{name}/C"], ref[f"mlstm/{name}/n"] = (np.asarray(C),
                                                          np.asarray(n))
    cfg = jax_get_config(ARCH).smoke()
    params = R.jax_params(ARCH)
    x, mstate, sstate = _block_inputs(cfg, max(DECODE_STEPS, SLSTM_SEQ))
    ctx = lambda: JQCtx(jfqt.qaf_config(), jnp.uint32(9))   # noqa: E731
    sp = params["layers"][SLSTM_LAYER]["slstm"]
    # the sLSTM's time loop over SLSTM_SEQ tokens from a state
    y, st = jax.jit(lambda p, a, s: jx.slstm_apply(p, a, ctx(), cfg,
                                                   state=s))(
        sp, jnp.asarray(x[:SLSTM_SEQ, :, 0].swapaxes(0, 1)),
        tuple(map(jnp.asarray, sstate)))
    ref["slstm/seq/y"] = np.asarray(y).view(np.uint16)
    for i, t in enumerate(st):
        ref[f"slstm/seq/state{i}"] = np.asarray(t)
    # decode steps of layer 0 (mLSTM) and of the sLSTM
    for name, fn, p, state in (
            ("mlstm", jx.mlstm_apply, params["layers"][0]["mlstm"], mstate),
            ("slstm", jx.slstm_apply, sp, sstate)):
        state = tuple(map(jnp.asarray, state))
        step = jax.jit(lambda p, a, s, fn=fn: fn(p, a, ctx(), cfg, state=s))
        for t in range(DECODE_STEPS):
            y, state = step(p, jnp.asarray(x[t]), state)
            ref[f"decode/{name}/{t}/y"] = np.asarray(y).view(np.uint16)
            for i, s in enumerate(state):
                ref[f"decode/{name}/{t}/state{i}"] = np.asarray(s)


def write_jax_reference(out_path, part=0, parts=1):
    run_jobs(R.ref_jobs(ARCH) + [_ref_cores], out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_xlstm"),
                    REF_PARTS)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(scope="module")
def model():
    return R.port_model(ARCH)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


# ---- tests that need no reference (they run while it is written) ----------------


@pytest.mark.parametrize("name,S,chunk", MLSTM_CASES,
                         ids=[c[0] for c in MLSTM_CASES])
def test_chunked_mlstm_equals_recurrent_steps(name, S, chunk):
    q, k, v, li, lf = (torch.from_numpy(a) for a in _mlstm_inputs(S))
    y, (C, n) = xlstm._mlstm_chunked(q, k, v, li, lf, chunk)
    H, P = q.shape[2], q.shape[3]
    state = (torch.zeros((2, H, P, P)), torch.zeros((2, H, P)))
    ys = [xlstm.mlstm_step(state, q[:, t], k[:, t], v[:, t], li[:, t],
                           lf[:, t]) for t in range(S)]
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=CORE_TOL, atol=CORE_TOL)
    for got, want in zip((C, n), state):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CORE_TOL,
                                   atol=CORE_TOL)


def test_slstm_ff_weights_start_equal(model):
    """The reference draws ``w_ff_gate`` and ``w_ff_up`` from one key; the
    port's own init keeps that equality (its draws are torch's)."""
    from repro_torch.models import registry
    params = registry.init_params(model[0], seed=1, device="cpu")
    sl = params["layers"][SLSTM_LAYER]["slstm"]
    assert torch.equal(sl["w_ff_gate"], sl["w_ff_up"])
    assert sl["w_ff_gate"].data_ptr() != sl["w_ff_up"].data_ptr()
    jl = R.jax_params(ARCH)["layers"][SLSTM_LAYER]["slstm"]
    assert np.array_equal(np.asarray(jl["w_ff_gate"], np.float32),
                          np.asarray(jl["w_ff_up"], np.float32))


def test_configs_match_reference():
    R.check_configs(ARCH)


def test_checkpoints_cross_both_ways(model, tmp_path):
    R.check_checkpoints(ARCH, model[0], tmp_path)


# ---- against the reference ---------------------------------------------------------


@pytest.mark.parametrize("name,S,chunk", MLSTM_CASES,
                         ids=[c[0] for c in MLSTM_CASES])
def test_mlstm_chunked(jax_ref, name, S, chunk):
    ins = [torch.from_numpy(a) for a in _mlstm_inputs(S)]
    y, (C, n) = xlstm._mlstm_chunked(*ins, chunk)
    for key, got in (("y", y), ("C", C), ("n", n)):
        np.testing.assert_allclose(got.numpy(),
                                   jax_ref[f"mlstm/{name}/{key}"],
                                   rtol=CORE_TOL, atol=CORE_TOL,
                                   err_msg=key)


def test_slstm_time_loop(model, jax_ref):
    cfg, params = model
    x, _, sstate = _block_inputs(cfg, max(DECODE_STEPS, SLSTM_SEQ))
    state = tuple(map(_t, sstate))
    with torch.no_grad():
        y = xlstm.slstm_apply(params["layers"][SLSTM_LAYER]["slstm"],
                              _t(x[:SLSTM_SEQ, :, 0].swapaxes(0, 1)),
                              QCtx(fqt.qaf_config(), 9), cfg, state=state)
    np.testing.assert_array_equal(_bits(y), jax_ref["slstm/seq/y"])
    for i, got in enumerate(state):
        np.testing.assert_allclose(got.numpy(),
                                   jax_ref[f"slstm/seq/state{i}"],
                                   rtol=CORE_TOL, atol=CORE_TOL)


@pytest.mark.parametrize("name", ("mlstm", "slstm"))
def test_decode_steps(model, jax_ref, name):
    cfg, params = model
    x, mstate, sstate = _block_inputs(cfg, max(DECODE_STEPS, SLSTM_SEQ))
    layer = 0 if name == "mlstm" else SLSTM_LAYER
    fn = xlstm.mlstm_apply if name == "mlstm" else xlstm.slstm_apply
    state = tuple(map(_t, mstate if name == "mlstm" else sstate))
    for t in range(DECODE_STEPS):
        with torch.no_grad():
            y = fn(params["layers"][layer][name], _t(x[t]),
                   QCtx(fqt.qaf_config(), 9), cfg, state=state)
        np.testing.assert_array_equal(
            _bits(y), jax_ref[f"decode/{name}/{t}/y"], err_msg=f"step {t}")
        for i, got in enumerate(state):
            np.testing.assert_allclose(
                got.numpy(), jax_ref[f"decode/{name}/{t}/state{i}"],
                rtol=CORE_TOL, atol=CORE_TOL)


@pytest.mark.parametrize("qn", ("bf16_config", "nvfp4_paper_config"))
def test_forward_logits(model, jax_ref, qn):
    R.check_forward(ARCH, model[1], model[0], jax_ref, qn)


def test_loss_and_grads(model, jax_ref):
    R.check_grads(ARCH, model[1], model[0], jax_ref)


def test_sigma_q_probe(model, jax_ref):
    R.check_probe(ARCH, model[1], jax_ref)


def test_engine_stream(model, jax_ref):
    R.check_stream(ARCH, model[1], model[0], jax_ref)


def test_trainer_matches_jax(model, jax_ref):
    R.check_trainer(ARCH, model[0], jax_ref)


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
