"""K4's routes, K5's and K6's split plans, and the plain versions of K5 and
K6 on shapes that span several of the card's tiles, on the CPU.

  * ``k4_route`` at every M the serving paths give K4 (1: a prefill
    program's lm_head, 4 and 8: decode, 32: verify, 64: chunk and suffix
    prefill, 192 and 256: cold prefill) and for an A spec whose code x
    scale is not exact in bf16 (the f32 route at every M).
  * ``k4_gemv_plan``: the GEMV's K ranges cover K exactly in multiples of
    32 rows and of A's block, at most 1024 rows each.
  * ``k5_plan``: from static shapes only (it takes no lengths); its splits
    cover the slot buffer in whole tiles, and a block holds at most
    ``k5_qmax(D)`` query vectors.
  * K5's plain version within 2e-5 of JAX's ``flash_attention_paged``
    (interpret mode) where the card's plan cuts every slot into several
    splits: a rolling sliding window whose slots have wrapped, and verify
    (Sq 4) with GQA over shuffled page tables.
  * ``k6_plan``: static shapes only; its one split covers Sk in whole
    tiles (no combine launch), and a block holds at most ``k5_qmax(D)``
    query vectors.  K6's plain version within 2e-5 of JAX's
    ``flash_attention_packed`` on a cache of 8 of the kernel's tiles, with
    and without a window.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``; here every wrapper gets CPU tensors and the launch
counters stay 0.
"""
import inspect

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels.flash_attn import \
    flash_attention_packed as jax_flash_attention_packed
from repro.kernels.flash_attn import \
    flash_attention_paged as jax_flash_attention_paged
from repro_torch.core.quantize import NVFP4, BlockQuantSpec
from repro_torch.kernels import counters
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import fp4_matmul as fm

torch.set_num_threads(1)

ATOL = 2e-5
FMTS = ("nvfp4", "fp8", "bf16")


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


# ---- K4: routes and the GEMV's K split ------------------------------------------


@pytest.mark.parametrize("M,route", [(1, "gemv"), (4, "gemv"), (8, "gemv"),
                                     (32, "gemv"), (64, "core"),
                                     (192, "core"), (256, "core")])
def test_k4_route_serving_rows(M, route):
    assert fm.k4_route(M, NVFP4) == route
    assert fm.k4_route(M, NVFP4.with_rounding(True)) == route
    assert (M <= fm.K4_GEMV_MAX_M) == (route == "gemv")


@pytest.mark.parametrize("M", [1, 8, 32, 64, 256])
def test_k4_route_f32_for_a_spec_not_exact_in_bf16(M):
    e3m4 = BlockQuantSpec(data_fmt="e3m4", scale_fmt="e4m3", block=16,
                          two_level=True)
    assert not fm.bf16_exact(e3m4)
    assert fm.k4_route(M, e3m4) == "f32"


@pytest.mark.parametrize("N,K,block_a", [(4096, 4096, 16), (11008, 4096, 16),
                                         (4096, 11008, 16), (32000, 4096, 16),
                                         (4096, 4096, 32), (384, 128, 16),
                                         (96, 256, 8)])
def test_k4_gemv_plan_covers_k(N, K, block_a):
    splits, ks = fm.k4_gemv_plan(N, K, block_a)
    assert ks % fm.K4_GEMV_ROWS == 0 and ks % block_a == 0
    assert ks <= max(fm.K4_GEMV_MAX_ROWS, fm.K4_GEMV_ROWS)
    assert (splits - 1) * ks < K <= splits * ks
    assert fm.k4_gemv_plan(N, K, block_a) == (splits, ks)


# ---- K5: the split plan ----------------------------------------------------------


def test_k5_plan_takes_static_shapes_only():
    assert list(inspect.signature(fa.k5_plan).parameters) == [
        "B", "Sq", "H", "KVH", "D", "page_size", "n_pages"]


# (B, Sq, H, KVH, D, page, pages): llama2-7b decode, verify and chunk prefill
# over the 8-slot, 512-token pool, a GQA decode, the rolling-window pool, and
# the smoke engine's shapes
@pytest.mark.parametrize("shape", [(8, 1, 32, 32, 128, 16, 32),
                                   (8, 4, 32, 32, 128, 16, 32),
                                   (1, 64, 32, 32, 128, 16, 32),
                                   (8, 1, 32, 4, 64, 16, 32),
                                   (8, 1, 32, 32, 128, 16, 8),
                                   (4, 16, 4, 4, 32, 16, 8)])
def test_k5_plan_covers_the_slot_buffer(shape):
    B, Sq, H, KVH, D, psz, npg = shape
    qv, keys, splits = fa.k5_plan(*shape)
    buf = psz * npg
    assert keys % fa.K5_TILE == 0
    assert (splits - 1) * keys < buf <= splits * keys
    assert 1 <= qv <= min(fa.k5_qmax(D), Sq * (H // KVH))


# ---- K5: the plain version against JAX where the card splits every slot -------


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _pools(fmt, P, psz, KVH, D, rng):
    """K and V page pools (P, page, KVH, .) of random rows, quantized by the
    JAX package: the same bits for both sides."""
    out = []
    for _ in range(2):
        x = jnp.asarray((rng.standard_normal((P, psz, KVH, D)) * 2
                         ).astype(np.float32))
        if fmt == "bf16":
            out += [x.astype(jnp.bfloat16),
                    jnp.ones((P, psz, KVH, 1), jnp.bfloat16)]
        else:
            out += list(jq.kv_quant_rows(x, fmt))
    return out


# (name, B, Sq, H, KVH, D, page, pages, lengths, window); each slot's query
# rows are its last Sq positions
SPLIT_CASES = (
    # decode over a rolling window: both slots have wrapped past the buffer
    ("window", 2, 1, 4, 2, 32, 16, 24, (400, 530), 250),
    # verify, 4 query rows, GQA (2 query heads per kv head)
    ("verify", 3, 4, 4, 2, 64, 16, 16, (200, 140, 256), None),
)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_k5_plain_matches_jax_kernel_across_splits(case, fmt):
    name, B, Sq, H, KVH, D, psz, npg, lens, window = case
    qv, keys, splits = fa.k5_plan(B, Sq, H, KVH, D, psz, npg)
    buf = psz * npg
    assert splits > 1 and min(min(lens), buf) > keys   # every slot is cut up
    rng = np.random.default_rng(7)
    P = 1 + B * npg
    pools = _pools(fmt, P, psz, KVH, D, rng)
    table = rng.permutation(np.arange(1, P)).reshape(B, npg).astype(np.int32)
    kv_len = np.minimum(np.asarray(lens), buf).astype(np.int32)
    q_off = np.maximum(np.asarray(lens) - Sq, 0).astype(np.int32)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    want = jax_flash_attention_paged(
        jnp.asarray(q), *pools, jnp.asarray(table), jnp.asarray(kv_len),
        jnp.asarray(q_off), fmt=fmt, causal=True, window=window,
        interpret=True)
    got = fa.flash_attention_paged(
        torch.from_numpy(q), *(_t(p) for p in pools),
        torch.from_numpy(table), torch.from_numpy(kv_len),
        torch.from_numpy(q_off), fmt=fmt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


# ---- K6: the plan ----------------------------------------------------------------


def test_k6_plan_takes_static_shapes_only():
    assert list(inspect.signature(fa.k6_plan).parameters) == [
        "Sq", "H", "KVH", "D", "Sk"]


# (Sq, H, KVH, D, Sk, qv): K6_CASES of chip_smoke.py (llama2-7b's lockstep
# decode, tinyllama's G = 8), the smoke engine, a prefix of the same batch,
# a cache that is not a whole number of tiles, and long caches
@pytest.mark.parametrize("shape", [(1, 32, 32, 128, 256, 1),
                                   (1, 32, 4, 64, 256, 8),
                                   (1, 4, 4, 32, 64, 1),
                                   (2, 32, 32, 128, 256, 2),
                                   (1, 32, 32, 128, 200, 1),
                                   (1, 4, 2, 32, 1024, 2),
                                   (1, 32, 8, 128, 4096, 4)])
def test_k6_plan_covers_the_cache(shape):
    *dims, want = shape
    Sq, H, KVH, D, Sk = dims
    qv, keys = fa.k6_plan(*dims)
    assert qv == want
    assert keys % fa.K5_TILE == 0
    assert keys - fa.K5_TILE < Sk <= keys
    assert 1 <= qv <= min(fa.k5_qmax(D), Sq * (H // KVH))


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8"])
@pytest.mark.parametrize("Sq,window", [(1, None), (1, 500), (3, None),
                                       (3, 300)])
def test_k6_plain_matches_jax_kernel_across_splits(fmt, Sq, window):
    B, H, KVH, D, Sk, kv_len = 1, 4, 2, 32, 1024, 900
    qv, keys = fa.k6_plan(Sq, H, KVH, D, Sk)
    assert keys // fa.K5_TILE == 8                # 8 of the kernel's tiles
    rng = np.random.default_rng(11)
    k, v = (jnp.asarray((rng.standard_normal((B, Sk, KVH, D)) * sc
                         ).astype(np.float32)) for sc in (2, 1))
    kc, ks = jq.kv_quant_rows(k, fmt)
    vc, vs = jq.kv_quant_rows(v, fmt)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    q_offset = kv_len - Sq
    want = jax_flash_attention_packed(
        jnp.asarray(q), kc, ks, vc, vs, fmt=fmt, causal=True, window=window,
        kv_len=kv_len, q_offset=q_offset, block_q=Sq, block_kv=128,
        interpret=True)
    pos = torch.tensor([q_offset, kv_len], dtype=torch.int32)
    got = fa.flash_attention_packed(
        torch.from_numpy(q), *(_t(x) for x in (kc, ks, vc, vs)), pos,
        fmt=fmt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
