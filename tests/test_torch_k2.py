"""K2's counter mode, its routes, and the sigma_q probe's way through K2, on
the CPU.

  * K2's plain version in counter mode (``counter`` = (seed32, row_stride,
    col_stride)) equals the plain version given ``counter_rbits``' bits,
    and the Pallas kernel in interpret mode given the JAX package's
    ``counter_bits`` for the same elements, bit for bit: strides (K, 1)
    (the tensor's own stream) and (1, M) (its transpose's).
  * ``core.quantize.block_quantize(x, spec, seed=s)`` equals K2's plain
    version on the (-1, K) reshape with counter (s, K, 1) and the core's
    tensor scale, bit for bit: the identity the CUDA route relies on.  The
    route's own code (``_block_quantize_k2``) runs here on the plain
    version and gives the torch code's result; ``_takes_k2`` sends the
    probe's calls to K2 on a CUDA tensor and nothing else.
  * ``k2_route``: "vec" exactly where a block is a power-of-two number (at
    most 32) of 16-byte lanes and the pointers are aligned.
  * The wrapper's argument rules, and no launch from a CPU tensor.

The CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py`` (phases ``kernels`` and ``train``).
"""
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import quantize as jq
from repro.kernels.nvfp4_quant import block_quantize_pallas
from repro_torch.core import quantize as tq
from repro_torch.kernels import counters
from repro_torch.kernels import nvfp4_quant as nq
from repro_torch.train import step as step_mod

torch.set_num_threads(1)

SEED = 0x5EED1234
SR_SPECS = {"nvfp4-sr": (jq.NVFP4.with_rounding(True),
                         tq.NVFP4.with_rounding(True)),
            "mxfp4-sr": (jq.MXFP4.with_rounding(True),
                         tq.MXFP4.with_rounding(True))}
CORE_SPECS = {"nvfp4": tq.NVFP4, "mxfp4": tq.MXFP4,
              "nvfp4-sr": tq.NVFP4.with_rounding(True),
              "mxfp4-sr": tq.MXFP4.with_rounding(True)}
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _zero_counts():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}, \
        "a CPU tensor must never launch a kernel"


def _x(shape, dtype, seed=3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 3
    x.flat[::7] *= 40                      # some blocks with an outlier
    x.flat[5] = 0.0
    return x.astype(DTYPES[dtype][0])


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits_of(t: torch.Tensor) -> torch.Tensor:
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.contiguous().view(ints[t.dtype])


def _assert_bits(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, tuple(got.shape), want.dtype, tuple(want.shape))
    assert torch.equal(_bits_of(got), _bits_of(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("strides", ["rows", "transposed"])
@pytest.mark.parametrize("spec", list(SR_SPECS))
def test_counter_mode_plain_matches_bits_and_pallas(spec, strides, dtype):
    sj, st = SR_SPECS[spec]
    M, K = 24, 64
    x = _x((M, K), dtype)
    if strides == "rows":           # the tensor's own counter_bits stream
        counter = (SEED, K, 1)
        jbits = np.asarray(jf.counter_bits(jnp.uint32(SEED), (M, K)))
    else:                           # the stream drawn for its (K, M) transpose
        counter = (SEED, 1, M)
        jbits = np.asarray(jf.counter_bits(jnp.uint32(SEED), (K, M))).T
    xt = _t(x)
    got = nq.block_quantize(xt, st, counter=counter)
    rbits = nq.counter_rbits((M, K), counter)
    assert torch.equal(rbits, torch.from_numpy(
        np.ascontiguousarray(jbits).view(np.int32).copy()))
    given = nq.block_quantize_plain(xt, st, rbits=rbits)
    jc, js = block_quantize_pallas(jnp.asarray(x), sj,
                                   rbits=jnp.asarray(jbits), interpret=True)
    for g, w, j in zip(got, given, (jc, js)):
        _assert_bits(g, w)
        _assert_bits(g, _t(np.asarray(j)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(24, 64), (3, 8, 64)], ids=["2d", "3d"])
@pytest.mark.parametrize("spec", list(CORE_SPECS))
def test_core_block_quantize_equals_k2_counter_mode(spec, shape, dtype):
    """The identity the CUDA route of ``core.quantize.block_quantize``
    relies on; the route's own code gives the same on the plain version."""
    st = CORE_SPECS[spec]
    xt = _t(_x(shape, dtype))
    K = shape[-1]
    want = tq.block_quantize(xt, st, axis=-1, seed=SEED)
    counter = (SEED, K, 1) if st.stochastic else None
    codes, scales = nq.block_quantize_plain(
        xt.reshape(-1, K), st, tscale=want.tscale, counter=counter)
    _assert_bits(codes.reshape(shape), want.codes)
    _assert_bits(scales.reshape(want.scales.shape).to(xt.dtype), want.scales)
    via = tq._block_quantize_k2(xt, st, SEED)
    for g, w in zip(via[:3], want[:3]):
        _assert_bits(g, w)
    assert (via.axis, via.block) == (want.axis, want.block)


@pytest.mark.parametrize("case, takes", [
    (dict(), True),
    (dict(device="cpu"), False),
    (dict(axis=0), False),
    (dict(u=True), False),
    (dict(seed=None), False),
    (dict(seed=None, spec=tq.NVFP4), True),
    (dict(dtype=torch.bfloat16, ndim=3, axis=2), True),
    (dict(dtype=torch.float16), False),
], ids=["probe", "cpu", "other-axis", "uniforms", "sr-no-seed", "rtn",
        "bf16-3d", "f16"])
def test_takes_k2(case, takes):
    """Which calls of ``core.quantize.block_quantize`` go through K2 (a
    stand-in with the attributes the route reads: no card here)."""
    c = dict(device="cuda", ndim=2, dtype=torch.float32, axis=1, u=False,
             seed=SEED, spec=tq.NVFP4.with_rounding(True)) | case
    x = types.SimpleNamespace(device=torch.device(c["device"]),
                              ndim=c["ndim"], dtype=c["dtype"])
    u = torch.zeros(1) if c["u"] else None
    assert tq._takes_k2(x, c["spec"], c["axis"], u, c["seed"]) is takes


def test_probe_leaves_take_k2(monkeypatch):
    """Every quantization of the sigma_q probe meets K2's route rule on a
    CUDA tensor: blocks along the last axis, SR from a seed, f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.optim.adamw import tree_map
    cfg = get_config("llama2-60m").smoke()
    grads = tree_map(lambda p: torch.ones_like(p) * 0.01,
                     registry.init_params(cfg, seed=0, device="cpu"))
    calls = []

    def spy(x, spec, *, axis=-1, u=None, seed=None):
        cuda = types.SimpleNamespace(device=torch.device("cuda"),
                                     ndim=x.ndim, dtype=x.dtype)
        calls.append(tq._takes_k2(cuda, spec, axis % x.ndim, u, seed))
        return tq.block_quantize(x, spec, axis=axis, u=u, seed=seed)
    monkeypatch.setattr(step_mod, "block_quantize", spy)
    step_mod._estimate_sigma_q(grads, 3)
    n_leaves = sum(
        1 for group, stacked in step_mod._reference_leaves(grads)
        if group[0].ndim + stacked >= 2 and group[0].shape[-1] % 16 == 0)
    assert len(calls) == n_leaves > 0 and all(calls)


def _route_want(block, dtype, aligned):
    nbytes = block * (4 if dtype == torch.float32 else 2)
    lanes = nbytes // 16
    return ("vec" if aligned and nbytes % 16 == 0
            and lanes in (1, 2, 4, 8, 16, 32) else "scalar")


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("block", [2, 4, 8, 12, 16, 24, 32, 64, 128, 256])
def test_k2_route(block, dtype, aligned):
    assert nq.k2_route(block, dtype, aligned) == _route_want(block, dtype,
                                                             aligned)


def test_k2_route_named_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    assert [nq.k2_route(b, f32, True) for b in (8, 16, 32)] == ["vec"] * 3
    assert [nq.k2_route(b, bf16, True) for b in (8, 16, 32)] == ["vec"] * 3
    assert nq.k2_route(4, bf16, True) == "scalar"      # 8 bytes: half a lane
    assert nq.k2_route(12, f32, True) == "scalar"      # 3 lanes
    assert nq.k2_route(256, f32, True) == "scalar"     # 64 lanes
    assert nq.k2_route(16, f32, False) == "scalar"


@pytest.mark.parametrize("fn", [nq.block_quantize, nq.block_quantize_plain],
                         ids=["wrapper", "plain"])
def test_counter_argument_rules(fn):
    x = torch.ones((4, 32))
    sr = tq.NVFP4.with_rounding(True)
    bits = nq.counter_rbits((4, 32), (SEED, 32, 1))
    with pytest.raises(ValueError, match="in place of rbits"):
        fn(x, sr, rbits=bits, counter=(SEED, 32, 1))
    with pytest.raises(ValueError, match="RtN"):
        fn(x, tq.NVFP4, counter=(SEED, 32, 1))
    with pytest.raises(ValueError, match="seed32"):
        fn(x, sr, counter=(SEED, 32))
    with pytest.raises(ValueError, match="rbits"):
        fn(x, sr)


@pytest.mark.parametrize("spec", ["nvfp4", "nvfp4-sr"])
def test_cpu_core_block_quantize_launches_nothing(spec):
    """On a CPU tensor the core takes its torch code (the autouse fixture
    holds every launch counter at 0)."""
    x = _t(_x((3, 8, 64), "float32"))
    q = tq.block_quantize(x, CORE_SPECS[spec], seed=SEED)
    assert q.codes.shape == x.shape
