"""repro_torch quantizers and packers against repro, bit for bit.

Inputs come from ``np.random.default_rng`` and go through both packages;
every code, scale, tensor scale and packed byte is compared as uint8 views.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import quantize as jq
from repro.kernels import common as jc
from repro_torch.core import formats as tf
from repro_torch.core import quantize as tq
from repro_torch.kernels import common as tc

torch.set_num_threads(1)


def _bytes_j(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _bytes_t(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype == torch.bfloat16 or t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn \
            else t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).view(np.uint8)


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


_F32_TINY = np.finfo(np.float32).tiny


def _edge_values(fmt) -> np.ndarray:
    """Binade bounds, midpoints between grid points, saturation, the
    format's subnormals and signed zeros, plus values beyond its max.
    f32 subnormals are left out: XLA's CPU backend flushes them to zero,
    the port (like the CUDA kernels) keeps them."""
    g = fmt.grid()
    mids = (g[1:] + g[:-1]) / 2
    near = np.concatenate([g * (1 + 2.0 ** -20), g * (1 - 2.0 ** -20)])
    big = [m for m in (fmt.max * 1.01, fmt.max * 1.2, fmt.max * 100)
           if m < float(np.finfo(np.float32).max)]
    vals = np.concatenate([g, mids, near, big, [1e-30], g[1:3] / 4])
    vals = vals[(vals == 0) | (np.abs(vals) >= _F32_TINY * 4)]
    vals = np.concatenate([vals, -vals, [0.0, -0.0]])
    return vals.astype(np.float32)


@pytest.mark.parametrize("name", ["e2m1", "e4m3", "e8m0", "e3m4"])
def test_quantize_rtn_bit_exact(name):
    fj, ft = jf.get_format(name), tf.get_format(name)
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(4096) * fj.max / 3).astype(np.float32),
        _edge_values(fj)])
    got = tf.quantize_rtn(_t(x), ft)
    want = jf.quantize_rtn(jnp.asarray(x), fj)
    np.testing.assert_array_equal(_bytes_t(got), _bytes_j(want))


def test_quantize_rtn_bf16_input_bit_exact():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(2048) * 3).astype(ml_dtypes.bfloat16)
    got = tf.quantize_rtn(_t(x), tf.E2M1)
    want = jf.quantize_rtn(jnp.asarray(x), jf.E2M1)
    np.testing.assert_array_equal(_bytes_t(got), _bytes_j(want))


@pytest.mark.parametrize("name", ["e2m1", "e4m3"])
def test_quantize_sr_with_u_and_uniforms(name):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096) * 2).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    u_t = tf.uniform_from_bits(torch.from_numpy(bits.astype(np.int64)))
    u_j = jf.uniform_from_bits(jnp.asarray(bits))
    np.testing.assert_array_equal(_bytes_t(u_t), _bytes_j(u_j))
    got = tf.quantize_sr_with_u(_t(x), tf.get_format(name), u_t)
    want = jf.quantize_sr_with_u(jnp.asarray(x), jf.get_format(name), u_j)
    np.testing.assert_array_equal(_bytes_t(got), _bytes_j(want))


def test_e8m0_floor_and_pow2():
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal(1024) * 100).astype(np.float32) + 1e-38
    x = np.concatenate([x, [2.0 ** -126, 1.0, 2.0 ** 120]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(_bytes_t(tf.e8m0_floor(_t(x))),
                                  _bytes_j(jf.e8m0_floor(jnp.asarray(x))))
    e = torch.arange(-149, 128)
    np.testing.assert_array_equal(
        tf.pow2(e).numpy(), np.ldexp(np.float32(1), e.numpy()).astype(
            np.float32))


@pytest.mark.parametrize("spec_name", ["NVFP4", "MXFP4"])
def test_tensor_scale(spec_name):
    sj, st = getattr(jq, spec_name), getattr(tq, spec_name)
    vals = np.array([0.0, 1e-30, 1e-3, 0.7, 1.0, 2688.0, 2689.0, 5e4, 3e38],
                    np.float32)
    for v in vals:
        got = tq._tensor_scale(torch.tensor(v), st)
        want = jq._tensor_scale(jnp.float32(v), sj)
        np.testing.assert_array_equal(_bytes_t(got.reshape(1)),
                                      _bytes_j(np.asarray(want).reshape(1)))


def test_pack_unpack_e2m1():
    rng = np.random.default_rng(4)
    grid = np.array(tq.E2M1_GRID, np.float32)
    codes = grid[rng.integers(0, 8, (6, 32))] * \
        rng.choice([-1.0, 1.0], (6, 32)).astype(np.float32)
    codes[0, :4] = [0.0, -0.0, 6.0, -6.0]
    pj = jq.pack_e2m1(jnp.asarray(codes))
    pt = tq.pack_e2m1(_t(codes))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        _bytes_t(tq.unpack_e2m1(pt)), _bytes_j(jq.unpack_e2m1(pj)))
    np.testing.assert_array_equal(
        _bytes_t(tc.unpack_e2m1_k(pt)), _bytes_j(jc.unpack_e2m1_k(pj)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_pack_quantize_batched(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 64, 48)) * rng.uniform(0.01, 5, (3, 1, 1))
         ).astype(dtype)
    x[1] = 0                                     # an all-zero slice
    pj = jq.pack_quantize(jnp.asarray(x), jq.NVFP4, axis=-2, batch_dims=1)
    pt = tq.pack_quantize(_t(x), tq.NVFP4, axis=-2, batch_dims=1)
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(pj.packed))
    np.testing.assert_array_equal(_bytes_t(pt.scales), _bytes_j(pj.scales))
    np.testing.assert_array_equal(_bytes_t(pt.tscale), _bytes_j(pj.tscale))
    assert pt.axis == pj.axis and pt.nbytes() == pj.nbytes()
    np.testing.assert_array_equal(_bytes_t(pt.dequant()),
                                  _bytes_j(pj.dequant()))


@pytest.mark.parametrize("spec_name,stochastic", [
    ("NVFP4", False), ("MXFP4", False), ("NVFP4", True)])
def test_block_quantize_and_fake_quant(spec_name, stochastic):
    sj = getattr(jq, spec_name).with_rounding(stochastic)
    st = getattr(tq, spec_name).with_rounding(stochastic)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((16, 64)) * 3).astype(ml_dtypes.bfloat16)
    u = rng.random((16, 64), dtype=np.float32) if stochastic else None
    qj = jq.block_quantize(jnp.asarray(x), sj, axis=-1,
                           u=None if u is None else jnp.asarray(u))
    qt = tq.block_quantize(_t(x), st, axis=-1,
                           u=None if u is None else _t(u))
    for a, b in ((qt.codes, qj.codes), (qt.scales, qj.scales),
                 (qt.tscale.reshape(1), np.asarray(qj.tscale).reshape(1)),
                 (qt.dequant(), qj.dequant())):
        np.testing.assert_array_equal(_bytes_t(a), _bytes_j(b))


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8"])
def test_kv_quant_rows_bit_exact(fmt):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 3, 64)) * 4).astype(ml_dtypes.bfloat16)
    x[0, 0, 0] = 0
    cj, sj = jq.kv_quant_rows(jnp.asarray(x), fmt)
    ct, st = tq.kv_quant_rows(_t(x), fmt)
    np.testing.assert_array_equal(_bytes_t(ct), _bytes_j(cj))
    np.testing.assert_array_equal(_bytes_t(st), _bytes_j(sj))
    np.testing.assert_array_equal(
        _bytes_t(tq.kv_dequant(ct, st, fmt)), _bytes_j(jq.kv_dequant(cj, sj,
                                                                     fmt)))


@pytest.mark.parametrize("name", ["e2m1", "e4m3", "e3m4"])
def test_k0_helpers_bit_exact(name):
    fj = jf.get_format(name)
    pj, pt = jc.FmtParams.of(fj), tc.FmtParams.of(tf.get_format(name))
    rng = np.random.default_rng(8)
    x = np.concatenate([(rng.standard_normal(2048) * fj.max / 3),
                        _edge_values(fj)]).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, x.size, dtype=np.uint64).astype(
        np.uint32)
    xj, xt = jnp.asarray(x), _t(x)
    uj = jc.uniform_from_bits_k(jnp.asarray(bits))
    ut = tc.uniform_from_bits_k(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(_bytes_t(ut), _bytes_j(uj))
    a = np.abs(x)
    np.testing.assert_array_equal(
        _bytes_t(tc._ulp_from_bits(_t(a), pt)),
        _bytes_j(jc._ulp_from_bits(jnp.asarray(a), pj)))
    np.testing.assert_array_equal(_bytes_t(tc.quantize_rtn_k(xt, pt)),
                                  _bytes_j(jc.quantize_rtn_k(xj, pj)))
    np.testing.assert_array_equal(_bytes_t(tc.quantize_sr_k(xt, pt, ut)),
                                  _bytes_j(jc.quantize_sr_k(xj, pj, uj)))
    ts = np.float32(2.0 ** -3)
    np.testing.assert_array_equal(
        _bytes_t(tc.generic_block_scale_k(_t(a), 6.0, pt, torch.tensor(ts))),
        _bytes_j(jc.generic_block_scale_k(jnp.asarray(a), 6.0, pj,
                                          jnp.float32(ts))))
    np.testing.assert_array_equal(
        _bytes_t(tc.e8m0_block_scale_k(_t(a), 2)),
        _bytes_j(jc.e8m0_block_scale_k(jnp.asarray(a), 2)))


def test_nibble_and_e4m3_byte_decoders():
    nib = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(
        _bytes_t(tc._decode_e2m1_nibble_k(torch.from_numpy(nib))),
        _bytes_j(jc._decode_e2m1_nibble_k(jnp.asarray(nib))))
    b = np.arange(256, dtype=np.uint8)
    ok = (b & 0x7F) != 0x7F                       # skip the two NaN codes
    got = tc.decode_e4m3_byte_k(torch.from_numpy(b)).numpy()
    want = b.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))
    assert np.isnan(got[~ok]).all()
