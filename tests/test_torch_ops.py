"""The port's ``kernels/ops.py`` and ``kernels/ref.py`` (K2
``block_quantize`` and K3 ``block_matmul`` in their plain versions, on CPU
tensors) against the JAX package as ``tests/test_kernels.py`` runs it:
``repro.kernels.ops`` in Pallas interpret mode and ``repro.kernels.ref``.

Inputs and SR bits are drawn with numpy from a seed and handed to both
packages.  Tolerances: quantizer outputs bit for bit (codes compared as
bit patterns, so -0.0 and 0.0 differ); products at rtol = atol = 1e-5
(identical quantized operands, only the summation order differs);
attention at 2e-5 (f32 softmax, the parity contract).  On a CPU tensor
every wrapper takes its plain version and leaves its launch counter at 0;
the CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.nvfp4_quant import block_quantize_pallas
from repro_torch.core import quantize as tq
from repro_torch.kernels import counters, ops, ref
from repro_torch.kernels.fp4_matmul import (block_matmul_plain,
                                            fused_quant_matmul_plain)
from repro_torch.kernels.nvfp4_quant import (block_quantize,
                                             block_quantize_plain)

torch.set_num_threads(1)

I = dict(interpret=True)

SPECS = [                       # tests/test_kernels.py:27-33
    jq.NVFP4,
    jq.MXFP4,
    jq.NVFP4.with_rounding(stochastic=True),
    jq.MXFP4.with_rounding(stochastic=True),
    jq.BlockQuantSpec(scale_fmt="e3m4", block=8, two_level=False),
]
SPEC_IDS = [f"{s.scale_fmt}-b{s.block}-{'sr' if s.stochastic else 'rtn'}"
            for s in SPECS]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _spec_t(sj) -> tq.BlockQuantSpec:
    return tq.BlockQuantSpec(sj.data_fmt, sj.scale_fmt, sj.block,
                             sj.two_level, sj.stochastic)


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    """The bit patterns of a float array (numpy, jax or torch)."""
    if isinstance(a, torch.Tensor):
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return a.contiguous().view(view[a.dtype]).numpy()
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int16)


def _assert_same_bits(got, want):
    assert got.dtype == {np.dtype(np.float32): torch.float32,
                         np.dtype(ml_dtypes.bfloat16): torch.bfloat16}[
        np.asarray(want).dtype]
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _rand(shape, seed, scale=1.0, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _rbits(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.fixture(autouse=True)
def _zero_counts():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}, \
        "a CPU tensor must never launch a kernel"


# ---- K2: ops.block_quantize ------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("shape", [(8, 32), (128, 128), (64, 256), (256, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_quantize_matches_jax(spec, shape, dtype):
    np_dt, _ = DTYPES[dtype]
    x = (_rand(shape, seed=shape[0] * 7 + shape[1]) * 3).astype(np_dt)
    rb = _rbits(shape, 5) if spec.stochastic else None
    want_c, want_s = jops.block_quantize(
        jnp.asarray(x), spec, rbits=None if rb is None else jnp.asarray(rb),
        **I)
    got_c, got_s = ops.block_quantize(_t(x), _spec_t(spec),
                                      rbits=None if rb is None else _t(rb))
    _assert_same_bits(got_c, want_c)
    _assert_same_bits(got_s, want_s)


@pytest.mark.parametrize("spec", [SPECS[0], SPECS[2], SPECS[4]],
                         ids=[SPEC_IDS[0], SPEC_IDS[2], SPEC_IDS[4]])
@pytest.mark.parametrize("tscale", [0.25, 3.0])
def test_block_quantize_given_tscale_matches_jax(spec, tscale):
    """A caller's tensor scale replaces the computed one (also where the
    spec is not two-level)."""
    x = _rand((32, 64), 17, 2.0)
    rb = _rbits(x.shape, 6) if spec.stochastic else None
    want_c, want_s = block_quantize_pallas(
        jnp.asarray(x), spec, rbits=None if rb is None else jnp.asarray(rb),
        tscale=jnp.float32(tscale), **I)
    got_c, got_s = block_quantize(
        _t(x), _spec_t(spec), rbits=None if rb is None else _t(rb),
        tscale=torch.tensor(tscale, dtype=torch.float32))
    _assert_same_bits(got_c, want_c)
    _assert_same_bits(got_s, want_s)


def test_block_quantize_matches_core_block_quantize():
    """K2's semantics == repro_torch.core.quantize.block_quantize (RtN), as
    tests/test_kernels.py holds the Pallas kernel to repro.core."""
    x = _t(_rand((64, 128), 3, 2.5))
    codes, scales = ops.block_quantize(x, tq.NVFP4)
    qt = tq.block_quantize(x, tq.NVFP4, axis=-1)
    _assert_same_bits(codes, qt.codes.numpy())
    _assert_same_bits(scales, qt.scales.to(torch.float32).numpy())


# ---- K3: ops.block_matmul --------------------------------------------------------


def _quantized_pair(M, N, K, dtype=np.float32):
    """JAX-quantized operands (A blocked along K, B along K) and tsA * tsB."""
    a = jnp.asarray(_rand((M, K), 11).astype(dtype))
    b = jnp.asarray(_rand((K, N), 12).astype(dtype))
    ac, asc = jref.block_quant_ref(a, jq.NVFP4, axis=1)
    bc, bsc = jref.block_quant_ref(b, jq.NVFP4, axis=0)
    ts = jref.tensor_scale_ref(a, jq.NVFP4) * jref.tensor_scale_ref(
        b, jq.NVFP4)
    return ac, asc, bc, bsc, ts


@pytest.mark.parametrize("shape_mnk", [(32, 32, 32), (128, 128, 256),
                                       (64, 48, 512), (16, 128, 64)])
def test_block_matmul_matches_jax(shape_mnk):
    M, N, K = shape_mnk
    args = _quantized_pair(M, N, K)
    want = jops.block_matmul(*args, block=16, **I)
    got = ops.block_matmul(*(_t(x) for x in args), block=16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_block_matmul_takes_bf16_codes():
    """K2's bf16 codes (exact) give the f32 codes' product."""
    ac, asc, bc, bsc, ts = _quantized_pair(32, 48, 64)
    want = jops.block_matmul(ac, asc, bc, bsc, ts, block=16, **I)
    got = ops.block_matmul(_t(ac).to(torch.bfloat16), _t(asc),
                           _t(bc).to(torch.bfloat16), _t(bsc), _t(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---- the other two public wrappers -----------------------------------------------


@pytest.mark.parametrize("sr", [False, True])
def test_fused_quant_matmul_matches_jax(sr):
    M, N, K = 64, 96, 128
    a, b = _rand((M, K), 21, 1.5), _rand((K, N), 22, 0.7)
    ra, rb = (_rbits((M, K), 1), _rbits((K, N), 2)) if sr else (None, None)
    spec = jq.NVFP4.with_rounding(sr)
    want = jops.fused_quant_matmul(
        jnp.asarray(a), jnp.asarray(b), spec, spec,
        a_rbits=None if ra is None else jnp.asarray(ra),
        b_rbits=None if rb is None else jnp.asarray(rb), **I)
    got = ops.fused_quant_matmul(
        _t(a), _t(b), _spec_t(spec), _spec_t(spec),
        a_rbits=None if ra is None else _t(ra),
        b_rbits=None if rb is None else _t(rb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_packed_block_matmul_matches_jax():
    a, w = _rand((5, 64), 31, 1.5), _rand((64, 48), 32, 0.3)
    wj = jq.pack_quantize(jnp.asarray(w), jq.NVFP4, axis=-2)
    wt = tq.PackedQuantizedTensor(
        packed=_t(wj.packed), scales=_t(wj.scales), tscale=_t(wj.tscale),
        axis=wj.axis, block=wj.block, dtype=torch.float32)
    want = jops.packed_block_matmul(jnp.asarray(a), wj, jq.NVFP4, **I)
    got = ops.packed_block_matmul(_t(a), wt, tq.NVFP4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---- ref.py against repro.kernels.ref --------------------------------------------


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_tensor_scale_ref_matches_jax(spec):
    for x in (_rand((16, 64), 41, 300.0), np.zeros((4, 32), np.float32)):
        _assert_same_bits(ref.tensor_scale_ref(_t(x), _spec_t(spec)),
                          jref.tensor_scale_ref(jnp.asarray(x), spec))


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("axis", [0, 1])
def test_block_quant_ref_matches_jax(spec, axis):
    x = _rand((64, 96), 43 + axis, 2.0)
    rb = _rbits(x.shape, 7) if spec.stochastic else None
    want_c, want_s = jref.block_quant_ref(
        jnp.asarray(x), spec, rbits=None if rb is None else jnp.asarray(rb),
        axis=axis)
    got_c, got_s = ref.block_quant_ref(
        _t(x), _spec_t(spec), rbits=None if rb is None else _t(rb),
        axis=axis)
    _assert_same_bits(got_c, want_c)
    _assert_same_bits(got_s, want_s)


def test_block_quant_ref_3d_bf16_given_tscale_matches_jax():
    x = _rand((3, 32, 48), 45, 4.0, ml_dtypes.bfloat16)
    want = jref.block_quant_ref(jnp.asarray(x), jq.NVFP4, axis=1,
                                tscale=jnp.float32(0.5))
    got = ref.block_quant_ref(_t(x), tq.NVFP4, axis=1,
                              tscale=torch.tensor(0.5))
    for g, w in zip(got, want):
        _assert_same_bits(g, w)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_block_matmul_ref_matches_jax(out_dtype):
    args = _quantized_pair(48, 32, 128)
    want = jref.block_matmul_ref(*args, 16, getattr(jnp, out_dtype))
    got = ref.block_matmul_ref(*(_t(x) for x in args), 16,
                               getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sr", [False, True])
def test_fused_quant_matmul_ref_matches_jax(sr):
    M, N, K = 32, 40, 64
    a, b = _rand((M, K), 51, 1.5), _rand((K, N), 52, 0.7)
    ra, rb = (_rbits((M, K), 3), _rbits((K, N), 4)) if sr else (None, None)
    spec = jq.NVFP4.with_rounding(sr)
    want = jref.fused_quant_matmul_ref(
        jnp.asarray(a), jnp.asarray(b), spec, spec,
        a_rbits=None if ra is None else jnp.asarray(ra),
        b_rbits=None if rb is None else jnp.asarray(rb))
    got = ref.fused_quant_matmul_ref(
        _t(a), _t(b), _spec_t(spec), _spec_t(spec),
        a_rbits=None if ra is None else _t(ra),
        b_rbits=None if rb is None else _t(rb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _kv_rows(shape, fmt, seed):
    """KV rows quantized by the JAX package: (codes, scales) of K and V."""
    k = _rand(shape, seed, 2.0)
    v = _rand(shape, seed + 1)
    return jq.kv_quant_rows(jnp.asarray(k), fmt) + jq.kv_quant_rows(
        jnp.asarray(v), fmt)


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8"])
@pytest.mark.parametrize("case", [
    dict(), dict(kv_len=13, q_offset=12), dict(window=8, q_offset=20),
    dict(causal=False, kv_len=20)], ids=["full", "kv_len", "window",
                                          "noncausal"])
def test_packed_attention_ref_matches_jax(fmt, case):
    B, Sq, H, KVH, D, Sk = 2, 4, 4, 2, 32, 24
    q = _rand((B, Sq, H, D), 61)
    cache = _kv_rows((B, Sk, KVH, D), fmt, 62)
    want = jref.packed_attention_ref(jnp.asarray(q), *cache, fmt=fmt, **case)
    got = ref.packed_attention_ref(_t(q), *(_t(c) for c in cache), fmt=fmt,
                                   **case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8", "bf16"])
@pytest.mark.parametrize("window", [None, 10])
def test_paged_attention_ref_matches_jax(fmt, window):
    B, Sq, H, KVH, D, psz, n_pages = 3, 2, 4, 2, 32, 8, 4
    P = 1 + B * n_pages
    q = _rand((B, Sq, H, D), 71)
    if fmt == "bf16":
        k = _rand((P, psz, KVH, D), 72).astype(ml_dtypes.bfloat16)
        v = _rand((P, psz, KVH, D), 73).astype(ml_dtypes.bfloat16)
        ones = np.ones((P, psz, KVH, 1), ml_dtypes.bfloat16)
        pools = (k, ones, v, ones)
    else:
        pools = _kv_rows((P, psz, KVH, D), fmt, 72)
    rng = np.random.default_rng(74)
    table = (rng.permutation(P - 1) + 1).reshape(B, n_pages).astype(np.int32)
    lengths = np.array([5, 17, 32], np.int32)
    q_off = lengths - Sq
    want = jref.paged_attention_ref(jnp.asarray(q),
                                    *(jnp.asarray(p) for p in pools), table,
                                    lengths, q_off, fmt=fmt, window=window)
    got = ref.paged_attention_ref(_t(q), *(_t(p) for p in pools), _t(table),
                                  _t(lengths), _t(q_off), fmt=fmt,
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---- the unfused chain K2 -> K2 -> K3 against K1 ----------------------------------


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unfused_chain_matches_fused_quant_matmul(sr, dtype):
    """block_quantize(A), block_quantize(B^T) -> block_matmul equals
    fused_quant_matmul on the same raw operands and SR bits: both quantize
    identically and differ only in the order of accumulation."""
    np_dt, t_dt = DTYPES[dtype]
    M, N, K = 48, 80, 128
    a, b = _t(_rand((M, K), 81, 1.5, np_dt)), _t(_rand((K, N), 82, 0.1,
                                                         np_dt))
    spec = tq.NVFP4.with_rounding(sr)
    ra = _t(_rbits((M, K), 8)) if sr else None
    rb = _t(_rbits((K, N), 9)) if sr else None
    ac, asc = block_quantize_plain(a, spec, rbits=ra)
    bc_t, bsc_t = block_quantize_plain(
        b.T.contiguous(), spec, rbits=None if rb is None else rb.T)
    assert ac.dtype == bc_t.dtype == t_dt
    ts = ref.tensor_scale_ref(a, spec) * ref.tensor_scale_ref(b, spec)
    got = block_matmul_plain(ac, asc, bc_t.T, bsc_t.T, ts)
    want = fused_quant_matmul_plain(a, b, spec, spec, a_rbits=ra, b_rbits=rb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# ---- errors --------------------------------------------------------------------


_X = np.ones((8, 32), np.float32)
_SR = jq.NVFP4.with_rounding(True)
ERRORS = {
    "quantize-3d": (lambda p, S, x: p.block_quantize(x(np.ones((2, 4, 32),
                                                               np.float32)),
                                                     S(jq.NVFP4)),
                    "2D"),
    "quantize-k-block": (lambda p, S, x: p.block_quantize(
        x(np.ones((8, 24), np.float32)), S(jq.NVFP4)), "divisible"),
    "quantize-sr-no-bits": (lambda p, S, x: p.block_quantize(x(_X), S(_SR)),
                            "rbits"),
    "quantize-sr-bad-bits": (lambda p, S, x: p.block_quantize(
        x(_X), S(_SR), rbits=x(np.zeros((8, 16), np.uint32))), "rbits"),
    "fused-block-mismatch": (lambda p, S, x: p.fused_quant_matmul(
        x(_X), x(_X.T), S(jq.NVFP4), S(jq.MXFP4)), "block"),
    "fused-sr-no-bits": (lambda p, S, x: p.fused_quant_matmul(
        x(_X), x(_X.T), S(_SR), S(jq.NVFP4)), "a_rbits"),
    "fused-k-block": (lambda p, S, x: p.fused_quant_matmul(
        x(np.ones((8, 24), np.float32)), x(np.ones((24, 8), np.float32)),
        S(jq.NVFP4), S(jq.NVFP4)), "divisible"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(case):
    """Every ValueError the JAX wrappers raise, raised by the port's."""
    fn, match = ERRORS[case]
    with pytest.raises(ValueError, match=match):
        fn(jops, lambda s: s, lambda a: jnp.asarray(a))
    with pytest.raises(ValueError, match=match):
        fn(ops, _spec_t, _t)


def test_packed_block_matmul_rejects_a_weight_not_blocked_along_k():
    w = jq.pack_quantize(jnp.asarray(_rand((32, 64), 91)), jq.NVFP4,
                         axis=-1)
    with pytest.raises(ValueError, match="blocked along K"):
        jops.packed_block_matmul(jnp.asarray(_rand((4, 32), 92)), w,
                                 jq.NVFP4, **I)
    wt = tq.pack_quantize(torch.randn(32, 64), tq.NVFP4, axis=-1)
    with pytest.raises(ValueError, match="blocked along K"):
        ops.packed_block_matmul(torch.randn(4, 32), wt, tq.NVFP4)


@pytest.mark.parametrize("a_shape,b_shape,block", [
    ((8, 32), (48, 16), 16), ((8, 24), (24, 16), 16)],
    ids=["contraction", "k-block"])
def test_block_matmul_rejects_bad_shapes(a_shape, b_shape, block):
    """Where the JAX function asserts (or tiles what it cannot), the port
    raises ValueError."""
    M, K = a_shape
    N = b_shape[1]
    args = (torch.ones(a_shape), torch.ones(M, max(K // block, 1)),
            torch.ones(b_shape), torch.ones(max(b_shape[0] // block, 1), N),
            torch.tensor(1.0))
    with pytest.raises(ValueError, match="contraction|divisible"):
        ops.block_matmul(*args, block=block)


def test_wrappers_refuse_other_devices():
    """No plain-version fallback off the CPU: a tensor on another device
    launches the kernel (CUDA) or raises -- here, a meta tensor."""
    x = torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.block_quantize(x, tq.NVFP4)
    s = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.block_matmul(x, s, x.T, s.T, torch.empty((), device="meta"))


def test_cpu_tensors_leave_the_counters_at_zero():
    x = _t(_rand((16, 64), 93))
    rb = _t(_rbits((16, 64), 10))
    codes, scales = ops.block_quantize(x, tq.NVFP4.with_rounding(True),
                                       rbits=rb)
    ops.block_matmul(codes, scales, codes.T, scales.T, torch.tensor(1.0))
    ops.fused_quant_matmul(x, x.T, tq.NVFP4, tq.NVFP4)
    ops.packed_block_matmul(x, tq.pack_quantize(x.T.contiguous(), tq.NVFP4,
                                                axis=-2), tq.NVFP4)
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}
