"""The port's FQT matmul and its SR streams against the JAX package, on the
CPU.

  * ``counter_bits``, ``_site_seed32`` and ``_site_bits``: bit for bit.
  * K1's plain version (``fused_quant_matmul`` on CPU tensors) against the
    Pallas kernel ``ops.fused_quant_matmul`` in interpret mode, at rtol =
    atol = 1e-5: both quantize to the same codes and scales, only the f32
    summation order may differ (the products sum exactly in practice).
  * ``fp4_matmul``'s forward, dX and dW against ``jax.vjp`` of the JAX
    ``fp4_matmul`` -- under ``nvfp4_paper_config("pallas")`` in interpret
    mode for the K1 path, the jnp path for the configs K1 does not take --
    at 2e-5 (the FQT vjp tolerance of the port's conventions).

The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``; here every wrapper gets CPU tensors and the launch
counters stay 0.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import fqt as jfqt
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro_torch.core import formats as tf
from repro_torch.core import fqt as tfqt
from repro_torch.core import quantize as tq
from repro_torch.kernels import counters
from repro_torch.kernels.fp4_matmul import fused_quant_matmul

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
STEP_SEED = (7 * 0x9E3779B1 + 1) & M32          # train step 7's seed


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(autouse=True)
def _zero_counts():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}, \
        "a CPU tensor must never launch a kernel"


# ---- SR streams, bit for bit ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, M32, STEP_SEED])
@pytest.mark.parametrize("shape", [(1,), (7, 13), (64, 1024)])
def test_counter_bits_bit_exact(seed, shape):
    want = np.asarray(jf.counter_bits(jnp.uint32(seed), shape))
    got = tf.counter_bits(seed, shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1, M32, STEP_SEED])
def test_site_seed_and_bits_bit_exact(seed):
    for site in range(6):
        want = int(jfqt._site_seed32(jnp.uint32(seed), site))
        assert tfqt._site_seed32(seed, site) == want
    want = np.asarray(jfqt._site_bits((48, 40), jnp.uint32(seed), 4))
    got = tfqt._site_bits((48, 40), seed, 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_key_less_sr_draws_counter_bits():
    """fake_quant with a seed takes its uniforms from counter_bits: the same
    codes as the reference's fake_quant with those uniforms."""
    x = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    spec = jq.NVFP4.with_rounding(True)
    u = jf.uniform_from_bits(jf.counter_bits(jnp.uint32(9), x.shape))
    want = jq.fake_quant(jnp.asarray(x), spec, axis=-1, u=u)
    got = tq.fake_quant(_t(x), tq.NVFP4.with_rounding(True), axis=-1, seed=9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="seed"):
        tq.fake_quant(_t(x), tq.NVFP4.with_rounding(True), axis=-1)


# ---- K1: plain version vs the Pallas kernel in interpret mode ----------------------

_BASE = {"nvfp4": (jq.NVFP4, tq.NVFP4), "mxfp4": (jq.MXFP4, tq.MXFP4)}


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(64, 128, 64), (40, 96, 24)])
def test_fused_quant_matmul_plain_vs_pallas(fmt, sr, dtype, mkn):
    """(64, 128, 64) tiles evenly; (40, 96, 24) is not a tile multiple."""
    M, K, N = mkn                    # K is a multiple of both blocks
    rng = np.random.default_rng([M, K, N, int(sr), len(fmt), len(dtype)])
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    a = (rng.standard_normal((M, K)) * 2).astype(npdt)
    b = (rng.standard_normal((K, N)) * 0.1).astype(npdt)
    js, ts = _BASE[fmt]
    ra = np.asarray(jf.counter_bits(jnp.uint32(3), (M, K))) if sr else None
    rb = np.asarray(jf.counter_bits(jnp.uint32(4), (K, N))) if sr else None
    want = jops.fused_quant_matmul(
        jnp.asarray(a), jnp.asarray(b), js.with_rounding(sr),
        js.with_rounding(sr), a_rbits=None if ra is None else jnp.asarray(ra),
        b_rbits=None if rb is None else jnp.asarray(rb), interpret=True)
    got = fused_quant_matmul(
        _t(a), _t(b), ts.with_rounding(sr), ts.with_rounding(sr),
        a_rbits=None if ra is None else _t(ra),
        b_rbits=None if rb is None else _t(rb))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_quant_matmul_out_dtype_and_rejects():
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    out = fused_quant_matmul(a, b, tq.NVFP4, tq.NVFP4,
                             out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="contraction"):
        fused_quant_matmul(a, torch.randn(48, 16), tq.NVFP4, tq.NVFP4)
    with pytest.raises(ValueError, match="block sizes"):
        fused_quant_matmul(a, b, tq.NVFP4, tq.MXFP4)
    with pytest.raises(ValueError, match="divisible"):
        fused_quant_matmul(torch.randn(4, 40), torch.randn(40, 8), tq.NVFP4,
                           tq.NVFP4)
    with pytest.raises(ValueError, match="a_rbits"):
        fused_quant_matmul(a, b, tq.NVFP4.with_rounding(True), tq.NVFP4)


# ---- fp4_matmul: forward, dX and dW against jax.vjp --------------------------------


def _vjp_pair(x, w, g, jcfg, tcfg, seed):
    """(y, dx, dw) of both packages for the same numpy x, w, cotangent g."""
    y, pull = jax.vjp(lambda x, w: jfqt.fp4_matmul(
        x, w, cfg=jcfg, seed=jnp.uint32(seed)), jnp.asarray(x),
        jnp.asarray(w))
    dx, dw = pull(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    yt = tfqt.fp4_matmul(xt, wt, cfg=tcfg, seed=seed)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), _t(g))
    return [(np.asarray(a, np.float32), _np(b)) for a, b in
            ((y, yt), (dx, dxt), (dw, dwt))]


def _inputs(shape_x, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = (rng.standard_normal(shape_x + (K,)) * 2).astype(npdt)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(npdt)
    g = (rng.standard_normal(shape_x + (N,)) * 1e-2).astype(npdt)
    return x, w, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape_x,K,N", [((64,), 64, 48), ((2, 48), 96, 32)])
def test_fp4_matmul_vjp_vs_jax_pallas(dtype, shape_x, K, N):
    """The paper's config: all three GEMMs on K1 (both sides); the second
    case has a 3-D input (M = 96 tokens)."""
    x, w, g = _inputs(shape_x, K, N, dtype, seed=K + N)
    pairs = _vjp_pair(x, w, g, jfqt.nvfp4_paper_config("pallas"),
                      tfqt.nvfp4_paper_config(), STEP_SEED)
    for name, (want, got) in zip(("y", "dx", "dw"), pairs):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("config", ["qaf_config", "bf16_config",
                                    "tseng2025_config", "wang2025_config",
                                    "mxfp4_config"])
def test_fp4_matmul_vjp_other_configs(config):
    """QAF (bf16 backward), bf16, tseng2025-style mixed points (SR grads
    only: the fake-quant + matmul path) and MXFP4, against the JAX jnp path
    (f32 inputs: the bf16 GEMMs then differ only in summation order)."""
    x, w, g = _inputs((2, 32), 64, 32, "float32", seed=5)
    pairs = _vjp_pair(x, w, g, getattr(jfqt, config)(),
                      getattr(tfqt, config)(), 11)
    for name, (want, got) in zip(("y", "dx", "dw"), pairs):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{config} {name}")


def test_update_gemm_falls_back_when_tokens_do_not_tile():
    """M = 24 tokens is no multiple of 16: the update GEMM stays bf16 (the
    forward and dX still run K1), as the reference does."""
    x, w, g = _inputs((24,), 64, 32, "float32", seed=6)
    pairs = _vjp_pair(x, w, g, jfqt.nvfp4_paper_config("pallas"),
                      tfqt.nvfp4_paper_config(), 3)
    for name, (want, got) in zip(("y", "dx", "dw"), pairs):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_sr_seed_changes_backward_not_forward():
    x, w, g = _inputs((32,), 64, 32, "float32", seed=8)
    cfg = tfqt.nvfp4_paper_config()
    outs = []
    for seed in (1, 2):
        xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
        y = tfqt.fp4_matmul(xt, wt, cfg=cfg, seed=seed)
        outs.append((y.detach(), *torch.autograd.grad(y, (xt, wt), _t(g))))
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][2], outs[1][2])
