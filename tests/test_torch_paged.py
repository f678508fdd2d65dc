"""The port's paged KV cache and K5 against the JAX package, on the CPU.

  * ``PagedKVCache`` write sequences (prompt, prompt_at, token with a mask,
    a rolling token write past the buffer, tokens with a mask, truncate)
    leave the same pool bytes, page table and lengths as JAX's, bit for
    bit, for the nvfp4, fp8 and bf16 pools; the reads (``gather_slots``,
    ``gather_slot``, ``dequant``, ``nbytes``) and ``swa_kpos`` agree too.
  * K5's plain version (``flash_attention_paged`` on CPU tensors) is held
    within 2e-5 to JAX's ``flash_attention_paged(..., interpret=True)`` and
    to the jnp ``_attn_decode_paged`` the reference engine computes, over
    decode, verify, suffix-prefill, GQA, sliding-window (rolling) and
    empty-slot cases.
  * The wrapper rejects bad layouts.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import \
    flash_attention_paged as jax_flash_attention_paged
from repro.models import layers as jl
from repro_torch.kernels import counters
from repro_torch.kernels.flash_attn import flash_attention_paged
from repro_torch.models import layers as tl

torch.set_num_threads(1)

FMTS = ("nvfp4", "fp8", "bf16")
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _bits(a) -> np.ndarray:
    """Bit pattern of a JAX or torch array (float8/bf16 as integers)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _assert_same_cache(tc, jc):
    for name in ("k_codes", "k_scales", "v_codes", "v_scales", "page_table",
                 "lengths"):
        np.testing.assert_array_equal(_bits(getattr(tc, name)),
                                      _bits(getattr(jc, name)), err_msg=name)


def _pair(fmt, B=3, buf=32, KVH=2, D=32, psz=8, seed=0):
    """The same empty paged cache in both packages, with one permuted page
    table (slot rows non-contiguous, out of order)."""
    npg = buf // psz
    jc = jl.PagedKVCache.init(B, buf, KVH, D, fmt=fmt, page_size=psz)
    tc = tl.PagedKVCache.init(B, buf, KVH, D, fmt=fmt, page_size=psz,
                              device="cpu")
    perm = np.random.default_rng(seed).permutation(
        np.arange(1, 1 + B * npg)).reshape(B, npg).astype(np.int32)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(perm))
    tc.page_table.copy_(torch.from_numpy(perm))
    return tc, jc


def _rows(rng, *shape):
    a = (rng.standard_normal(shape) * 2).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("fmt", FMTS)
def test_paged_writes_bit_identical(fmt):
    rng = np.random.default_rng(1)
    B, KVH, D = 3, 2, 32
    tc, jc = _pair(fmt)
    _assert_same_cache(tc, jc)
    # prefill-into-slot, with right-pad rows past plen
    k, kj = _rows(rng, 1, 12, KVH, D)
    v, vj = _rows(rng, 1, 12, KVH, D)
    assert tc.write_prompt(0, k, v, 10) is tc
    jc = jc.write_prompt(0, kj, vj, 10)
    _assert_same_cache(tc, jc)
    # suffix prefill at an offset, its pad running past the slot buffer
    k, kj = _rows(rng, 1, 16, KVH, D)
    v, vj = _rows(rng, 1, 16, KVH, D)
    tc.write_prompt_at(1, k, v, 24, 28)
    jc = jc.write_prompt_at(1, kj, vj, 24, 28)
    _assert_same_cache(tc, jc)
    tc.write_prompt(2, k[:, :5], v[:, :5], 5)
    jc = jc.write_prompt(2, kj[:, :5], vj[:, :5], 5)
    # batched decode writes: masked, unmasked, and rolling past the buffer
    for step, mask in enumerate(([True, False, True], None, None, None,
                                 [False, True, True])):
        k, kj = _rows(rng, B, 1, KVH, D)
        v, vj = _rows(rng, B, 1, KVH, D)
        tm = None if mask is None else torch.tensor(mask)
        jm = None if mask is None else jnp.asarray(mask)
        tc.write_token(k, v, mask=tm)
        jc = jc.write_token(kj, vj, mask=jm)
        _assert_same_cache(tc, jc)
    # verify-block writes (past the buffer to the trash page), masked
    k, kj = _rows(rng, B, 4, KVH, D)
    v, vj = _rows(rng, B, 4, KVH, D)
    tc.write_tokens(k, v, mask=torch.tensor([True, True, False]))
    jc = jc.write_tokens(kj, vj, mask=jnp.asarray([True, True, False]))
    _assert_same_cache(tc, jc)
    tc.write_tokens(k[:, :2], v[:, :2])
    jc = jc.write_tokens(kj[:, :2], vj[:, :2])
    _assert_same_cache(tc, jc)
    # rollback: batched, and one slot (never extends a slot)
    new = np.asarray(jc.lengths) - np.asarray([3, 0, 9], np.int32)
    tc.truncate_to(None, torch.from_numpy(new))
    jc = jc.truncate_to(None, jnp.asarray(new))
    tc.truncate_to(2, 4)
    jc = jc.truncate_to(2, 4)
    tc.truncate_to(0, 10 ** 6)
    jc = jc.truncate_to(0, 10 ** 6)
    _assert_same_cache(tc, jc)
    # reads
    for got, want in zip(tc.gather_slots(), jc.gather_slots()):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for got, want in zip(tc.gather_slot(1), jc.gather_slot(1)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for got, want in zip(tc.dequant(torch.float32), jc.dequant(jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tc.nbytes() == jc.nbytes()
    assert (tc.n_slots, tc.buf) == (jc.n_slots, jc.buf)


def test_swa_kpos_matches():
    lengths = np.asarray([0, 5, 32, 45, 77], np.int32)
    got = tl.swa_kpos(torch.from_numpy(lengths), 32)
    want = jl.swa_kpos(jnp.asarray(lengths), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_shares_page_table_and_lengths():
    """Layers of a paged carry share one page table; each has its own
    lengths row, and both are checked against the slot layout."""
    table = torch.zeros((2, 4), dtype=torch.int32)
    lengths = torch.zeros((3, 2), dtype=torch.int32)
    caches = [tl.PagedKVCache.init(2, 32, 2, 32, page_size=8, device="cpu",
                                   page_table=table, lengths=lengths[i])
              for i in range(3)]
    caches[0].lengths.add_(5)
    assert all(c.page_table is table for c in caches)
    assert lengths.tolist() == [[5, 5], [0, 0], [0, 0]]
    with pytest.raises(ValueError, match="slot layout"):
        tl.PagedKVCache.init(2, 32, 2, 32, page_size=16, device="cpu",
                             page_table=table)


# ---- K5: the plain version against JAX's kernel and jnp read -----------------


def _filled(fmt, B, KVH, D, psz, npg, pre, extra, seed):
    """A paged cache pair with permuted pages, per-slot prompt lengths
    ``pre`` and ``extra`` rolling decode writes."""
    rng = np.random.default_rng(seed)
    tc, jc = _pair(fmt, B=B, buf=psz * npg, KVH=KVH, D=D, psz=psz,
                   seed=seed)
    for i, T in enumerate(pre):
        if T == 0:
            continue
        k, kj = _rows(rng, 1, T, KVH, D)
        v, vj = _rows(rng, 1, T, KVH, D)
        tc.write_prompt(i, k, v, T)
        jc = jc.write_prompt(i, kj, vj, T)
    for _ in range(extra):
        k, kj = _rows(rng, B, 1, KVH, D)
        v, vj = _rows(rng, B, 1, KVH, D)
        tc.write_token(k, v)
        jc = jc.write_token(kj, vj)
    _assert_same_cache(tc, jc)
    return tc, jc


# (name, B, H, KVH, D, page, pages, prompt lengths, rolling writes, Sq,
#  q_offset rule, window).  GQA (4 query heads per kv head) throughout; the
#  decode and empty-slot cases share their shapes, so JAX compiles its
#  interpret-mode kernel once for both.
K5_CASES = (
    ("decode", 3, 8, 2, 64, 8, 4, (12, 32, 27), 0, 1, "last", None),
    ("empty slots", 3, 8, 2, 64, 8, 4, (0, 19, 0), 0, 1, "last", None),
    ("verify", 3, 8, 2, 64, 8, 4, (9, 28, 17), 0, 4, "block", None),
    ("suffix", 1, 8, 2, 64, 8, 4, (30,), 0, 16, 14, None),
    ("window", 3, 8, 2, 64, 8, 4, (12, 32, 27), 9, 1, "last", 24),
)


def _k5_inputs(case, fmt):
    name, B, H, KVH, D, psz, npg, pre, extra, Sq, qo, window = case
    tc, jc = _filled(fmt, B, KVH, D, psz, npg, pre, extra, seed=3)
    lengths = np.asarray(jc.lengths)
    kv_len = np.minimum(lengths, psz * npg).astype(np.int32)
    if qo == "last":
        q_off = np.maximum(lengths - 1, 0)
    elif qo == "block":
        q_off = np.maximum(lengths - Sq, 0)
    else:
        q_off = np.full((B,), qo)
    q_off = q_off.astype(np.int32)
    q = np.random.default_rng(4).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    return tc, jc, q, kv_len, q_off, window


def _port_k5(tc, q, kv_len, q_off, window, fmt):
    return flash_attention_paged(
        torch.from_numpy(q), tc.k_codes, tc.k_scales, tc.v_codes,
        tc.v_scales, tc.page_table, torch.from_numpy(kv_len),
        torch.from_numpy(q_off), fmt=fmt, causal=True, window=window).numpy()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", K5_CASES, ids=[c[0] for c in K5_CASES])
def test_k5_plain_matches_jax_kernel(case, fmt):
    tc, jc, q, kv_len, q_off, window = _k5_inputs(case, fmt)
    got = _port_k5(tc, q, kv_len, q_off, window, fmt)
    want = jax_flash_attention_paged(
        jnp.asarray(q), jc.k_codes, jc.k_scales, jc.v_codes, jc.v_scales,
        jc.page_table, jnp.asarray(kv_len), jnp.asarray(q_off), fmt=fmt,
        causal=True, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=ATOL, atol=ATOL)
    if case[0] == "empty slots":
        assert np.all(got[kv_len == 0] == 0) and np.isfinite(got).all()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", [c for c in K5_CASES if c[0] != "empty slots"],
                         ids=lambda c: c[0])
def test_k5_plain_matches_jnp_paged_read(case, fmt):
    """The read the reference engine runs (``_attn_decode_paged`` over
    ``gather_slots``), with the same per-slot positions.  (An empty slot
    is where the two reference paths themselves differ: the kernel skips
    every page and returns 0, the jnp scan averages V; the engine never
    reads an empty slot's output.)"""
    tc, jc, q, kv_len, q_off, window = _k5_inputs(case, fmt)
    B, Sq = q.shape[:2]
    assert kv_len.min() > 0
    got = _port_k5(tc, q, kv_len, q_off, window, fmt)
    qpos = jnp.asarray(q_off)[:, None] + jnp.arange(Sq, dtype=jnp.int32)
    if window is None:
        kpos = jnp.broadcast_to(jnp.arange(jc.buf, dtype=jnp.int32)[None],
                                (B, jc.buf))
    else:
        kpos = jl.swa_kpos(jnp.asarray(q_off) + Sq, jc.buf)
    want = jl._attn_decode_paged(jnp.asarray(q), jc, qpos=qpos, kpos=kpos,
                                 causal=True, window=window,
                                 kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(got, np.asarray(want), rtol=ATOL, atol=ATOL)


def test_k5_bf16_query_keeps_dtype():
    tc, _, q, kv_len, q_off, _ = _k5_inputs(K5_CASES[0], "nvfp4")
    qb = torch.from_numpy(q).to(torch.bfloat16)
    out = flash_attention_paged(qb, tc.k_codes, tc.k_scales, tc.v_codes,
                                tc.v_scales, tc.page_table,
                                torch.from_numpy(kv_len),
                                torch.from_numpy(q_off))
    want = flash_attention_paged(qb.float(), tc.k_codes, tc.k_scales,
                                 tc.v_codes, tc.v_scales, tc.page_table,
                                 torch.from_numpy(kv_len),
                                 torch.from_numpy(q_off))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)


def test_k5_rejects_bad_layouts():
    tc, _, q, kv_len, q_off, _ = _k5_inputs(K5_CASES[0], "nvfp4")
    q = torch.from_numpy(q)
    kl, qo = torch.from_numpy(kv_len), torch.from_numpy(q_off)
    pools = (tc.k_codes, tc.k_scales, tc.v_codes, tc.v_scales)
    with pytest.raises(ValueError, match="format"):
        flash_attention_paged(q, *pools, tc.page_table, kl, qo, fmt="int4")
    with pytest.raises(ValueError, match="layout"):
        flash_attention_paged(q, tc.k_codes[..., :8], tc.k_scales,
                              tc.v_codes[..., :8], tc.v_scales,
                              tc.page_table, kl, qo)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_paged(q[:, :, :3], *pools, tc.page_table, kl, qo)
    with pytest.raises(ValueError, match="scales"):
        flash_attention_paged(q, tc.k_codes, tc.k_scales[..., :1],
                              tc.v_codes, tc.v_scales, tc.page_table, kl, qo)
    with pytest.raises(ValueError, match="page_table"):
        flash_attention_paged(q, *pools, tc.page_table[:2], kl, qo)
    with pytest.raises(ValueError, match="lengths"):
        flash_attention_paged(q, *pools, tc.page_table, kl[:2], qo)
    with pytest.raises(ValueError, match="q must be"):
        flash_attention_paged(q[0], *pools, tc.page_table, kl, qo)
