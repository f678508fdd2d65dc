"""K1's counter mode and the route to the tensor-core GEMM core, on the CPU.

  * Counter mode (``a_counter`` / ``b_counter`` = (seed32, row_stride,
    col_stride)) against the rbits route with the JAX package's
    ``counter_bits`` drawn for the same elements: bit for bit, for the
    natural index map (cols, 1) and the update GEMM's transposed map
    (1, rows), on tile-multiple and ragged shapes; and against the Pallas
    kernel in interpret mode at rtol = atol = 1e-5 (only the f32 summation
    order may differ).
  * ``core/fqt.py`` hands K1 counters, never bits tensors, with the strides
    each GEMM's operands need.
  * The route: every preset spec pair is bf16-exact (code x block scale
    survives a round trip through bf16) and goes to the tensor-core core;
    E3M4 data under E4M3 scales is not, and takes the f32 route.

The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``; here every wrapper gets CPU tensors and the launch
counters stay 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro_torch.core import formats as tf
from repro_torch.core import fqt as tfqt
from repro_torch.core import quantize as tq
from repro_torch.kernels import counters
from repro_torch.kernels import fp4_matmul as fm
from repro_torch.kernels.nvfp4_quant import quant_blocks

torch.set_num_threads(1)

SEED_A, SEED_B = 0x1234ABCD, 0xFEDCBA98
SPECS = {"nvfp4": (jq.NVFP4, tq.NVFP4), "mxfp4": (jq.MXFP4, tq.MXFP4)}


def _bits(j) -> torch.Tensor:
    return torch.from_numpy(np.asarray(j).view(np.int32).copy())


@pytest.fixture(autouse=True)
def _zero_counts():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}, \
        "a CPU tensor must never launch a kernel"


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    return a, b


def _reference_bits(M, K, N, transposed_a):
    """The JAX package's counter_bits for A and B: A's drawn for its (K, M)
    transpose when ``transposed_a`` (as the update GEMM's x^T), and the
    counters that name the same elements."""
    if transposed_a:
        ra = np.asarray(jf.counter_bits(jnp.uint32(SEED_A), (K, M))).T
        ca = (SEED_A, 1, M)
    else:
        ra = np.asarray(jf.counter_bits(jnp.uint32(SEED_A), (M, K)))
        ca = (SEED_A, K, 1)
    rb = np.asarray(jf.counter_bits(jnp.uint32(SEED_B), (K, N)))
    return ra, rb, ca, (SEED_B, N, 1)


@pytest.mark.parametrize("transposed_a", [False, True],
                         ids=["natural", "transposed"])
@pytest.mark.parametrize("mkn", [(64, 128, 64), (40, 96, 24)],
                         ids=["tiles", "ragged"])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_counter_mode_equals_rbits_route(fmt, mkn, transposed_a):
    M, K, N = mkn
    a, b = _operands(M, K, N, seed=[M, K, N, len(fmt)])
    ra, rb, ca, cb = _reference_bits(M, K, N, transposed_a)
    sr = SPECS[fmt][1].with_rounding(True)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    want = fm.fused_quant_matmul(at, bt, sr, sr, a_rbits=_bits(ra),
                                 b_rbits=_bits(rb))
    got = fm.fused_quant_matmul(at, bt, sr, sr, a_counter=ca, b_counter=cb)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the bits themselves, as the kernel hashes them
    assert torch.equal(fm.counter_rbits((M, K), ca), _bits(ra))
    assert torch.equal(fm.counter_rbits((K, N), cb), _bits(rb))


@pytest.mark.parametrize("transposed_a", [False, True],
                         ids=["natural", "transposed"])
def test_counter_mode_vs_jax_pallas(transposed_a):
    """Counter mode against the Pallas kernel given the reference's bits,
    in interpret mode; a ragged shape (not a multiple of the tiles)."""
    M, K, N = 40, 96, 24
    a, b = _operands(M, K, N, seed=7)
    ra, rb, ca, cb = _reference_bits(M, K, N, transposed_a)
    js, ts = SPECS["nvfp4"]
    want = jops.fused_quant_matmul(
        jnp.asarray(a), jnp.asarray(b), js.with_rounding(True),
        js.with_rounding(True), a_rbits=jnp.asarray(np.ascontiguousarray(ra)),
        b_rbits=jnp.asarray(rb), interpret=True)
    got = fm.fused_quant_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                ts.with_rounding(True), ts.with_rounding(True),
                                a_counter=ca, b_counter=cb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_counter_bits_at_matches_reference():
    """``counter_bits_at`` at scattered indices equals the JAX stream at
    those flat indices; ``counter_bits`` is its arange."""
    seed = 0x9E3779B1
    full = np.asarray(jf.counter_bits(jnp.uint32(seed), (1 << 16,)))
    idx = np.random.default_rng(0).integers(0, 1 << 16, 300)
    got = tf.counter_bits_at(seed, torch.from_numpy(idx))
    assert torch.equal(got, _bits(full[idx]))
    # counter mode's index map wraps mod 2^32, as the kernel's uint32 does
    wrapped = fm.counter_rbits((1, 300), (seed, 0, 1 << 32))
    assert torch.equal(wrapped.flatten(), _bits(np.repeat(full[:1], 300)))
    assert torch.equal(tf.counter_bits(seed, (1 << 16,)), _bits(full))


def test_counter_mode_rejects():
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    sr = tq.NVFP4.with_rounding(True)
    with pytest.raises(ValueError, match="a_counter"):
        fm.fused_quant_matmul(a, b, sr, tq.NVFP4, a_counter=(1, 64, 1),
                              a_rbits=torch.zeros(32, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="b_counter"):
        fm.fused_quant_matmul(a, b, tq.NVFP4, sr, b_counter=(1, 16))
    with pytest.raises(ValueError, match="b_rbits"):
        fm.fused_quant_matmul(a, b, tq.NVFP4, sr)
    # an RtN operand ignores its counter, as it ignores rbits
    assert torch.equal(
        fm.fused_quant_matmul(a, b, tq.NVFP4, tq.NVFP4, a_counter=(1, 64, 1)),
        fm.fused_quant_matmul(a, b, tq.NVFP4, tq.NVFP4))


def test_fqt_hands_k1_counters(monkeypatch):
    """Forward, dX and dW of the paper's config reach K1 with counters for
    the SR operands (the site seeds, strides (cols, 1); x^T of the update
    GEMM (1, K)) and no bits tensors."""
    calls = []
    real = fm.fused_quant_matmul

    def spy(a, b, spec_a, spec_b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), spec_a.stochastic,
                      spec_b.stochastic, kw))
        return real(a, b, spec_a, spec_b, **kw)

    monkeypatch.setattr(fm, "fused_quant_matmul", spy)
    M, K, N, seed = 48, 64, 32, 11
    x = torch.randn(M, K, requires_grad=True)
    w = torch.randn(K, N, requires_grad=True)
    y = tfqt.fp4_matmul(x, w, cfg=tfqt.nvfp4_paper_config(), seed=seed)
    torch.autograd.grad(y, (x, w), torch.randn(M, N))
    s = tfqt._site_seed32
    want = [((M, K), (K, N), False, False, None, None),          # forward
            ((M, N), (N, K), True, False, (s(seed, 2), N, 1), None),  # dX
            ((K, M), (M, N), True, True, (s(seed, 4), 1, K),
             (s(seed, 5), N, 1))]                                 # dW
    assert len(calls) == 3
    for (sa, sb, sra, srb, kw), (wa, wb, wsra, wsrb, ca, cb) in zip(calls,
                                                                     want):
        assert (sa, sb, sra, srb) == (wa, wb, wsra, wsrb)
        assert kw.get("a_rbits") is None and kw.get("b_rbits") is None
        assert kw["a_counter"] == ca and kw["b_counter"] == cb


_PRESETS = ["nvfp4_paper_config", "mxfp4_config", "wang2025_config",
            "tseng2025_config"]


@pytest.mark.parametrize("config", _PRESETS)
def test_presets_take_the_core_route(config):
    """Every spec pair a preset hands K1 (both operands of one GEMM
    quantized) is bf16-exact and takes the tensor-core core."""
    cfg = getattr(tfqt, config)()
    pairs = [(cfg.fwd_a, cfg.fwd_w), (cfg.bwd_g, cfg.bwd_w),
             (cfg.upd_a, cfg.upd_g)]
    specs = [s for p in pairs for s in p if s is not None]
    assert specs
    for s in specs:
        assert fm.bf16_exact(s)
    for sa, sb in pairs:
        if sa is not None and sb is not None:
            assert fm.k1_route(sa, sb) == "core"


def test_non_exact_pair_takes_the_f32_route():
    e3m4 = tq.BlockQuantSpec(data_fmt="e3m4", scale_fmt="e4m3")
    assert not fm.bf16_exact(e3m4)
    assert fm.k1_route(e3m4, tq.NVFP4) == "f32"
    assert fm.k1_route(tq.NVFP4, e3m4) == "f32"
    assert fm.k1_route(tq.NVFP4, tq.MXFP4) == "core"


@pytest.mark.parametrize("spec", [
    tq.NVFP4, tq.MXFP4, tq.BlockQuantSpec(scale_fmt="e3m4", block=8,
                                          two_level=False),
    tq.BlockQuantSpec(data_fmt="e3m4", scale_fmt="e8m0", block=32,
                      two_level=False)], ids=["nvfp4", "mxfp4", "e3m4-scale",
                                              "e3m4-data-e8m0"])
def test_bf16_exact_specs_survive_bf16(spec):
    """What the core's operands rest on: for a bf16-exact spec every code
    x block scale the quantizer writes (over 12 decades of magnitude, SR
    and RtN) round-trips through bf16 unchanged."""
    assert fm.bf16_exact(spec)
    rng = np.random.default_rng(len(spec.scale_fmt) + spec.block)
    x = rng.standard_normal((64, 256)) * 10.0 ** rng.integers(-6, 6, (64, 1))
    xf = torch.from_numpy(x.astype(np.float32))
    for sr in (False, True):
        rb = _bits(jf.counter_bits(jnp.uint32(5), xf.shape)) if sr else None
        s = spec.with_rounding(sr)
        ts = torch.tensor(0.25 if spec.two_level else 1.0)
        codes, scales = quant_blocks(xf, s, ts, rb)
        deq = codes * scales.unsqueeze(-1)
        assert torch.equal(deq.to(torch.bfloat16).to(torch.float32), deq)


def test_e3m4_data_with_e4m3_scales_is_not_bf16_exact():
    """The f32 route is needed: E3M4 data under E4M3 scales (4 + 3
    mantissa bits) writes products that bf16 rounds."""
    spec = tq.BlockQuantSpec(data_fmt="e3m4", scale_fmt="e4m3")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 256)).astype(np.float32))
    codes, scales = quant_blocks(x, spec, torch.tensor(1.0))
    deq = codes * scales.unsqueeze(-1)
    assert not torch.equal(deq.to(torch.bfloat16).to(torch.float32), deq)
