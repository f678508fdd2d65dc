"""Plain versions of the port's kernels (K4, K6, K7) against the JAX
Pallas kernels in interpret mode, on CPU tensors.

On a CPU tensor each wrapper takes its plain PyTorch version and leaves its
launch counter at 0; the CUDA kernels themselves are held to these plain
versions on the card by ``chip_smoke.py``.  Tolerances follow
``tests/test_kernels.py`` (1e-5 for the packed GEMM: identical quantized
operands, only the summation order differs) and
``tests/test_flash_kernel.py`` (2e-5 for f32 attention).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import fqt as jfqt
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.kernels.flash_attn import flash_attention as j_flash
from repro.kernels.flash_attn import flash_attention_packed as j_flash_packed
from repro.models.layers import attention_core as j_attention_core
from repro_torch.core import fqt as tfqt
from repro_torch.core import quantize as tq
from repro_torch.kernels import counters
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_packed)
from repro_torch.kernels.fp4_matmul import packed_matmul

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _packed_t(pj) -> tq.PackedQuantizedTensor:
    return tq.PackedQuantizedTensor(
        packed=_t(pj.packed), scales=_t(pj.scales), tscale=_t(pj.tscale),
        axis=pj.axis, block=pj.block, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _zero_counts():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}, \
        "a CPU tensor must never launch a kernel"


# ---- K4 -------------------------------------------------------------------------

_SPECS = {
    "nvfp4-rtn": jq.NVFP4,
    "nvfp4-sr": jq.NVFP4.with_rounding(True),
    "mxfp4-e8m0": jq.MXFP4,
}


@pytest.mark.parametrize("spec_id,M", [
    ("nvfp4-rtn", 1), ("nvfp4-rtn", 4), ("nvfp4-rtn", 37),
    ("nvfp4-rtn", 128), ("nvfp4-sr", 4), ("nvfp4-sr", 37),
    ("mxfp4-e8m0", 4), ("mxfp4-e8m0", 37)])
def test_packed_block_matmul_plain_vs_pallas(spec_id, M):
    K, N = 128, 96
    rng = np.random.default_rng(M)
    a = (rng.standard_normal((M, K)) * 1.5).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    sj = _SPECS[spec_id]
    st = tq.BlockQuantSpec(sj.data_fmt, sj.scale_fmt, sj.block, sj.two_level,
                           sj.stochastic)
    rbits = (rng.integers(0, 2 ** 32, (M, K), dtype=np.uint64).astype(
        np.uint32) if sj.stochastic else None)
    wj = jq.pack_quantize(jnp.asarray(b), jq.NVFP4, axis=-2)
    want = jops.packed_block_matmul(
        jnp.asarray(a), wj, sj,
        a_rbits=None if rbits is None else jnp.asarray(rbits),
        interpret=True)
    got = packed_matmul(
        _t(a), _packed_t(wj), st,
        a_rbits=None if rbits is None else torch.from_numpy(
            rbits.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fp4_matmul_packed_vs_jnp_packed_forward():
    """The port's packed forward (K4 plain) against fqt._packed_forward's
    jnp path on a (B, S, K) activation: one tensor scale over all rows."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 5, 64)) * 2).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.2).astype(np.float32)
    wj = jq.pack_quantize(jnp.asarray(w), jq.NVFP4, axis=-2)
    want = jfqt.fp4_matmul(jnp.asarray(x), wj, cfg=jfqt.qaf_config())
    got = tfqt.fp4_matmul(_t(x), _packed_t(wj), cfg=tfqt.qaf_config())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fp4_matmul_fake_quant_and_bf16_paths():
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((6, 64))).astype(np.float32)
    w = (rng.standard_normal((64, 32)) * 0.2).astype(np.float32)
    for jc, tc in ((jfqt.qaf_config(), tfqt.qaf_config()),
                   (jfqt.bf16_config(), tfqt.bf16_config())):
        want = jfqt.fp4_matmul(jnp.asarray(x), jnp.asarray(w), cfg=jc)
        got = tfqt.fp4_matmul(_t(x), _t(w), cfg=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_packed_block_matmul_rejects_bad_shapes():
    w = tq.pack_quantize(torch.randn(64, 32), tq.NVFP4, axis=-2)
    with pytest.raises(ValueError, match="contraction"):
        packed_matmul(torch.randn(4, 48), w)
    with pytest.raises(ValueError, match="stochastic"):
        packed_matmul(torch.randn(4, 64), w, tq.NVFP4.with_rounding(True))


# ---- K6 -------------------------------------------------------------------------


def _packed_cache(fmt, B, Sk, KVH, D, seed):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, Sk, KVH, D)) * 2).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    kc, ks = jq.kv_quant_rows(jnp.asarray(k), fmt)
    vc, vs = jq.kv_quant_rows(jnp.asarray(v), fmt)
    return kc, ks, vc, vs


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8"])
@pytest.mark.parametrize("H,KVH", [(4, 4), (8, 1)])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_packed_plain_vs_pallas(fmt, H, KVH, window):
    B, Sq, Sk, D = 2, 2, 64, 32
    q_offset, kv_len = 40, 42
    kc, ks, vc, vs = _packed_cache(fmt, B, Sk, KVH, D, seed=H + KVH)
    q = np.random.default_rng(3).standard_normal((B, Sq, H, D)).astype(
        np.float32)
    want = j_flash_packed(jnp.asarray(q), kc, ks, vc, vs, fmt=fmt,
                          causal=True, window=window, kv_len=kv_len,
                          q_offset=q_offset, interpret=True)
    pos = torch.tensor([q_offset, kv_len], dtype=torch.int32)
    got = flash_attention_packed(_t(q), _t(kc), _t(ks), _t(vc), _t(vs), pos,
                                 fmt=fmt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_packed_decode_row():
    """Sq = 1 at the frontier (q_offset = kv_len - 1), the decode case."""
    B, Sk, H, KVH, D = 3, 96, 4, 2, 64
    kc, ks, vc, vs = _packed_cache("nvfp4", B, Sk, KVH, D, seed=9)
    q = np.random.default_rng(4).standard_normal((B, 1, H, D)).astype(
        np.float32)
    for kv_len in (1, 33, 70):
        want = j_flash_packed(jnp.asarray(q), kc, ks, vc, vs, fmt="nvfp4",
                              kv_len=kv_len, q_offset=kv_len - 1,
                              block_kv=32, interpret=True)
        pos = torch.tensor([kv_len - 1, kv_len], dtype=torch.int32)
        got = flash_attention_packed(_t(q), _t(kc), _t(ks), _t(vc), _t(vs),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_flash_attention_packed_rejects_bad_layout():
    kc = torch.zeros((1, 32, 2, 8), dtype=torch.uint8)
    ks = torch.zeros((1, 32, 2, 2), dtype=torch.uint8).view(
        torch.float8_e4m3fn)
    pos = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="layout"):
        flash_attention_packed(torch.zeros(1, 1, 2, 32), kc, ks, kc, ks, pos)
    with pytest.raises(ValueError, match="format"):
        flash_attention_packed(torch.zeros(1, 1, 2, 16), kc, ks, kc, ks, pos,
                               fmt="int4")


# ---- K7 -------------------------------------------------------------------------


def _qkv(B, Sq, Sk, H, KVH, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype) for s in
                 ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))


@pytest.mark.parametrize("shape", [(1, 64, 2, 2, 16), (2, 64, 8, 2, 32)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_flash_attention_plain_vs_pallas_f32(shape, causal, window):
    B, S, H, KVH, D = shape
    q, k, v = _qkv(B, S, S, H, KVH, D, np.float32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, block_q=32, block_kv=32,
                   interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_plain_vs_pallas_bf16():
    """bf16: both round p to bf16 against the running max of the same
    32-key tiles, so only f32 summation order differs; the outputs are
    bf16, whose spacing is 2^-8 relative -- tolerance 1e-2 covers one ulp
    (the JAX flash test uses 3e-2 against an f32-p oracle)."""
    q, k, v = _qkv(2, 64, 64, 4, 2, 32, ml_dtypes.bfloat16, seed=1)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   block_q=32, block_kv=32, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_flash_attention_ragged_lengths():
    """Any Sq and Sk: the ragged edge is masked (the Pallas kernel needs
    divisible blocks, so the oracle is the dense attention_core)."""
    q, k, v = _qkv(1, 50, 50, 4, 2, 32, np.float32, seed=2)
    pos = jnp.arange(50, dtype=jnp.int32)
    want = j_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            qpos=pos, kpos=pos, causal=True, chunk=4096)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_rejects_bad_gqa():
    q, k, v = _qkv(1, 8, 8, 3, 2, 16, np.float32)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(_t(q), _t(k), _t(v))

