"""The port's hybrid family (zamba2: Mamba2 + a shared attention block)
against the JAX package, on the CPU.

``zamba2-1.2b.smoke()`` (4 Mamba layers, the shared block after layers 2
and 4, d 128, 4 SSM heads of 64, state 16) from the same JAX-initialised
parameters, carried across with ``convert.params_from_jax_numpy``.  The JAX
reference runs in subprocesses with excess precision off
(``tests/_jax_ref.py``); ``python <this file> OUT PART PARTS`` writes a part
of it.  The model-level cases are shared with tests/test_torch_xlstm.py
(``tests/_recurrent.py``, which states their tolerances).

Held here: the chunked SSD core in f32 (``_ssd_chunked``, both of the
reference's einsum paths) at rtol = atol = 2e-5; the causal conv and its
state bit for bit; three recurrent decode steps of a Mamba block
(``mamba_apply`` with a state) bit for bit in the output and the conv state,
the SSM state at 2e-5; the port's chunked SSD against its own S recurrent
steps at 2e-5.
"""
import functools
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
from repro_torch.models import mamba2
from repro_torch.models.layers import QCtx

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
REF_PARTS = 3
CORE_TOL = 2e-5
# (name, H, P, N, S, chunk): the smoke shape (N < P: the einsums' outer
# product first), a wide state (N > P: the contractions first), one chunk
SSD_CASES = (("smoke", 4, 64, 16, 64, 16), ("wide state", 4, 16, 64, 64, 16),
             ("one chunk", 4, 64, 16, 32, 32))
DECODE_STEPS = 3


def _ssd_inputs(H, P, N, S, seed=11):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((2, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, S, H)))).astype(
        np.float32) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((2, S, N)).astype(np.float32)
    Cm = rng.standard_normal((2, S, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _conv_inputs(cfg):
    import ml_dtypes
    d_inner, H, P, N = mamba2.mamba_dims(cfg)
    rng = np.random.default_rng(12)
    C = d_inner + 2 * N
    x = rng.standard_normal((2, 8, C)).astype(ml_dtypes.bfloat16)
    w = (rng.standard_normal((cfg.ssm_conv, C)) * 0.2).astype(
        ml_dtypes.bfloat16)
    st = rng.standard_normal((2, cfg.ssm_conv - 1, C)).astype(
        ml_dtypes.bfloat16)
    return x, w, st


def _decode_inputs(cfg):
    import ml_dtypes
    d_inner, H, P, N = mamba2.mamba_dims(cfg)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((DECODE_STEPS, 2, 1, cfg.d_model)).astype(
        ml_dtypes.bfloat16)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, d_inner + 2 * N)
                               ).astype(ml_dtypes.bfloat16)
    ssm = rng.standard_normal((2, H, P, N)).astype(np.float32)
    return x, conv, ssm


def _ref_cores(ref):
    from repro.models import mamba2 as jm
    for name, H, P, N, S, chunk in SSD_CASES:
        ins = [jnp.asarray(a) for a in _ssd_inputs(H, P, N, S)]
        y, hT = jax.jit(functools.partial(jm._ssd_chunked, chunk=chunk))(
            *ins)
        ref[f"ssd/{name}/y"], ref[f"ssd/{name}/h"] = (np.asarray(y),
                                                      np.asarray(hT))
    cfg = jax_get_config(ARCH).smoke()
    x, w, st = _conv_inputs(cfg)
    for name, state in (("zero", None), ("state", jnp.asarray(st))):
        y, ns = jax.jit(jm._causal_conv)(jnp.asarray(x), jnp.asarray(w),
                                         state)
        ref[f"conv/{name}/y"] = np.asarray(y).view(np.uint16)
        ref[f"conv/{name}/state"] = np.asarray(ns).view(np.uint16)
    # three decode steps of layer 0's block under qaf_config
    from repro.models.layers import QCtx as JQCtx
    layer = jax.tree_util.tree_map(lambda a: a[0],
                                   R.jax_params(ARCH)["mamba"])
    xs, conv, ssm = _decode_inputs(cfg)
    state = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    step = jax.jit(lambda p, a, s: jm.mamba_apply(
        p, a, JQCtx(jfqt.qaf_config(), jnp.uint32(9)), cfg, state=s))
    for t in range(DECODE_STEPS):
        y, state = step(layer, jnp.asarray(xs[t]), state)
        ref[f"decode/{t}/y"] = np.asarray(y).view(np.uint16)
        ref[f"decode/{t}/conv"] = np.asarray(state["conv"]).view(np.uint16)
        ref[f"decode/{t}/ssm"] = np.asarray(state["ssm"])


def write_jax_reference(out_path, part=0, parts=1):
    run_jobs(R.ref_jobs(ARCH) + [_ref_cores], out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_mamba2"),
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


@pytest.mark.parametrize("name,H,P,N,S,chunk", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_chunked_ssd_equals_recurrent_steps(name, H, P, N, S, chunk):
    """The port's chunk-parallel SSD against S of its own recurrent steps:
    outputs and final state at 2e-5."""
    xh, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(H, P, N,
                                                                   S))
    y, hT = mamba2._ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    h = torch.zeros((2, H, P, N))
    ys = [mamba2.ssd_step(h, dt[:, t], A, Bm[:, t], Cm[:, t], xh[:, t])
          for t in range(S)]
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=CORE_TOL, atol=CORE_TOL)
    np.testing.assert_allclose(hT.numpy(), h.numpy(), rtol=CORE_TOL,
                               atol=CORE_TOL)


def test_configs_match_reference():
    R.check_configs(ARCH)


def test_checkpoints_cross_both_ways(model, tmp_path):
    R.check_checkpoints(ARCH, model[0], tmp_path)


# ---- against the reference ---------------------------------------------------------


@pytest.mark.parametrize("name,H,P,N,S,chunk", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_ssd_chunked(jax_ref, name, H, P, N, S, chunk):
    ins = [torch.from_numpy(a) for a in _ssd_inputs(H, P, N, S)]
    y, hT = mamba2._ssd_chunked(*ins, chunk)
    np.testing.assert_allclose(y.numpy(), jax_ref[f"ssd/{name}/y"],
                               rtol=CORE_TOL, atol=CORE_TOL)
    np.testing.assert_allclose(hT.numpy(), jax_ref[f"ssd/{name}/h"],
                               rtol=CORE_TOL, atol=CORE_TOL)


@pytest.mark.parametrize("name", ("zero", "state"))
def test_causal_conv(model, jax_ref, name):
    x, w, st = _conv_inputs(model[0])
    y, ns = mamba2._causal_conv(_t(x), _t(w),
                                None if name == "zero" else _t(st))
    np.testing.assert_array_equal(_bits(y), jax_ref[f"conv/{name}/y"])
    np.testing.assert_array_equal(_bits(ns), jax_ref[f"conv/{name}/state"])


def test_decode_steps(model, jax_ref):
    cfg, params = model
    xs, conv, ssm = _decode_inputs(cfg)
    state = {"conv": _t(conv), "ssm": _t(ssm)}
    for t in range(DECODE_STEPS):
        with torch.no_grad():
            y = mamba2.mamba_apply(params["mamba"][0], _t(xs[t]),
                                   QCtx(fqt.qaf_config(), 9), cfg,
                                   state=state)
        np.testing.assert_array_equal(_bits(y), jax_ref[f"decode/{t}/y"],
                                      err_msg=f"step {t}")
        np.testing.assert_array_equal(_bits(state["conv"]),
                                      jax_ref[f"decode/{t}/conv"])
        np.testing.assert_allclose(state["ssm"].numpy(),
                                   jax_ref[f"decode/{t}/ssm"],
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
