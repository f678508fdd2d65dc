"""The port's encdec family (whisper-base) against the JAX package, on the
CPU.

``whisper-base.smoke()`` (2 encoder + 2 decoder layers, d 128, 4 heads of
32, d_ff 256, enc_seq 32) from the same JAX-initialised parameters,
carried across with ``convert.params_from_jax_numpy``, every attention and
MLP bias set to seeded nonzero values (the reference initialises them to
zero, which would test nothing of the bias path).  Frames, tokens and the
unit tests' operands are numpy-seeded.  The JAX reference runs in
subprocesses with excess precision off (``tests/_jax_ref.py``); ``python
<this file> OUT PART PARTS`` writes a part of it.

Tolerances, each with its reason:
  * the tanh GELU (``refnum.Gelu``) bit for bit, forward and backward, on
    the smoke config's pre-activations; torch's ``gelu(approximate=
    "tanh")`` parts from XLA's in the last f32 bit of ~23% of bf16-valued
    N(0, 1) arguments (asserted nonzero here: the reason ``refnum`` carries
    XLA's tanh), and in the bf16 rounding of 0.003% of them and of 1.1% of
    N(0, 2) ones (1M values each), each a flipped FP4 code in ``w_out``'s
    input;
  * the biased GELU MLP and the biased self- and cross-attention under
    qaf_config, ``encode`` (training attention), forward logits under
    qaf_config and the loss with every GEMM weight's gradient under
    nvfp4_paper_config: bit for bit (E2M1 x E4M3 products sum exactly in
    any order; the f32 softmax's differences stay below the bf16
    roundings here);
  * forward logits under bf16_config within ``BF16_LOGIT_SCALE`` of their
    scale (bf16 x bf16 GEMMs sum in another order, tests/_recurrent.py);
  * the other gradient leaves (biases, norms, the embedding and the
    position tables) are sums over B*S (or B*T) tokens that XLA and torch
    reduce in another order and precision: relative L2 ``OTHER_LEAF_REL_L2``
    (the 1-D-leaf rule of tests/test_torch_train.py; 0.6-0.9% seen, the
    embedding and ``pos_dec`` bit for bit).  The key biases' gradients
    are 0 in exact arithmetic (q . b_k is one constant over a query's
    keys, which the softmax drops), so both sides hold rounding noise
    (|g| ~ 3e-5): their difference is held to ``OTHER_LEAF_REL_L2`` times
    the norm of the same block's query-bias gradient;
  * ``encode(serving=True)``, the serving route (K7's plain version: an
    online softmax over 128-key tiles that divides after the pv product,
    where the reference's dense softmax divides before it) within
    ``K7_ENC_ULPS`` bf16 ulps of each value's own magnitude;
  * the packed-NVFP4 Engine and ContinuousEngine streams: token for token,
    or first apart at a step whose reference margin is below 0.02 (a
    near-tie: the encoder's serving route moves f32 ulps), and the greedy
    margins within ``MARGIN_ATOL`` where the streams are equal.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _recurrent as R
from _jax_ref import Reference, assert_stream, jax_engine_stream, run_jobs
from repro.configs import get_config as jax_get_config
from repro.core import fqt as jfqt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
from repro_torch.core import fqt
from repro_torch.core.quantize import NVFP4
from repro_torch.kernels import counters
from repro_torch.models import refnum, registry, whisper
from repro_torch.models.layers import QCtx, attn_apply, mlp_apply
from repro_torch.serve import (ContinuousEngine, Engine, Request,
                               ServeConfig, packing)

torch.set_num_threads(1)

ARCH = "whisper-base"
REF_PARTS = 3
SEQ = 16                   # loss / grads / logits: B 2 x 16 decoder tokens
SEED = 0x5EED
BF16_LOGIT_SCALE = 2.0 ** -6
OTHER_LEAF_REL_L2 = 3e-2
K7_ENC_ULPS = 2
MARGIN_ATOL = 1e-5
NO_EOS = -1
PROMPT_LENS = (8, 6)
MAX_NEW, MAX_LEN = 8, 64
BIAS_KEYS = ("bq", "bk", "bv", "b_in", "b_out")
GEMM_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_out"})
# continuous: 3 requests over 2 slots (the third reuses a slot; it has no
# frames, its prefill a signature of its own), a pool of 5 pages: the
# second request is preempted and re-encodes its frames at re-admission
CONT_SCFG = dict(max_slots=2, max_len=MAX_LEN, page_size=16,
                 kv_cache_format="nvfp4", decode_chunk=4, eos_id=NO_EOS,
                 total_pages=5)
CONT_REQS = ((0, 20, 24, 0), (1, 12, 30, 0), (2, 6, 10, 1))  # rid, plen,
COMPILES = ("prefill_compiles", "prefill_suffix_compiles", "chunk_compiles",
            "decode_compiles", "verify_compiles")


def _bf16(a) -> np.ndarray:
    import ml_dtypes
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reference's smoke init with seeded nonzero biases."""
    from repro.models import registry as jreg
    cfg = jax_get_config(ARCH).smoke()
    params = jreg.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(17)

    def bias(path, leaf):
        name = jax.tree_util.keystr(path[-1:]).strip("[]'")
        if name in BIAS_KEYS:
            return jnp.asarray(_bf16(rng.standard_normal(leaf.shape) * 0.1))
        return leaf

    return jax.tree_util.tree_map_with_path(bias, params)


def _frames(n, seed=5):
    cfg = get_config(ARCH).smoke()
    rng = np.random.default_rng(seed)
    return _bf16(rng.standard_normal((n, cfg.enc_seq, cfg.d_model)))


def _tokens(seq=SEQ):
    return np.random.default_rng(3).integers(
        0, get_config(ARCH).smoke().vocab_size, (2, seq + 1)).astype(np.int32)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, get_config(ARCH).smoke().vocab_size, n)
            for n in PROMPT_LENS]


def _cont_requests(req_cls):
    rng = np.random.default_rng(8)
    vocab = get_config(ARCH).smoke().vocab_size
    return [req_cls(rid=r, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new=mn, arrival=a) for r, n, mn, a in CONT_REQS]


def _cont_frames():
    """Frames of requests 0 and 1 (request 2 comes without)."""
    f = _frames(2, seed=9)
    return {0: f[:1], 1: f[1:]}


def _unit_inputs():
    """Operands of the unit tests: x (2, 12, d), xkv (2, 32, d), a biased
    attention block and a biased GELU MLP at the smoke widths."""
    cfg = get_config(ARCH).smoke()
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    rng = np.random.default_rng(21)

    def w(i, o):
        return _bf16(rng.standard_normal((i, o)) * i ** -0.5)

    def b(n):
        return _bf16(rng.standard_normal(n) * 0.1)

    attn = {"wq": w(d, cfg.n_heads * hd), "wk": w(d, cfg.n_kv_heads * hd),
            "wv": w(d, cfg.n_kv_heads * hd), "wo": w(cfg.n_heads * hd, d),
            "bq": b(cfg.n_heads * hd), "bk": b(cfg.n_kv_heads * hd),
            "bv": b(cfg.n_kv_heads * hd)}
    mlp = {"w_in": w(d, f), "b_in": b(f), "w_out": w(f, d), "b_out": b(d)}
    x = _bf16(rng.standard_normal((2, 12, d)))
    xkv = _bf16(rng.standard_normal((2, cfg.enc_seq, d)))
    return cfg, attn, mlp, x, xkv


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                use_rope=False)


def _u16(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


# ---- the reference's jobs ------------------------------------------------------


def _ref_units(ref):
    from repro.models import layers as jl
    cfg, attn, mlp, x, xkv = _unit_inputs()
    q = jfqt.qaf_config()
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    h = jax.jit(lambda p, a: jl.QCtx(q, jnp.uint32(7)).dense(
        a, p["w_in"], p["b_in"]))(j(mlp), j(x))
    ref["gelu/pre"] = _u16(h)
    ref["gelu/out"] = np.asarray(jax.jit(jax.nn.gelu)(h.astype(jnp.float32))
                                 ).view(np.uint32)
    g = jnp.asarray(_bf16(np.random.default_rng(4).standard_normal(h.shape)))
    ref["gelu/grad"] = _u16(jax.jit(lambda a, g: jax.vjp(
        lambda v: jax.nn.gelu(v.astype(jnp.float32)).astype(jnp.bfloat16),
        a)[1](g)[0])(h, g))
    ref["mlp"] = _u16(jax.jit(lambda p, a: jl.mlp_apply(
        p, a, jl.QCtx(q, jnp.uint32(7)), "gelu"))(j(mlp), j(x)))
    kw = _attn_kw(cfg)
    ref["attn/self"] = _u16(jax.jit(lambda p, a: jl.attn_apply(
        p, a, jl.QCtx(q, jnp.uint32(8)), causal=False, **kw)[0])(
        j(attn), j(x)))
    ref["attn/cross"] = _u16(jax.jit(lambda p, a, kv: jl.attn_apply(
        p, a, jl.QCtx(q, jnp.uint32(9)), xkv=kv, **kw)[0])(
        j(attn), j(x), j(xkv)))


def _ref_encode_forward(ref):
    from repro.models import registry as jreg
    from repro.models import whisper as jw
    cfg, params = jax_get_config(ARCH).smoke(), _jax_params()
    frames = jnp.asarray(_frames(2))
    ref["encode"] = _u16(jax.jit(lambda p, f: jw.encode(
        p, cfg, jfqt.qaf_config(), f, seed=3))(params, frames))
    toks = jnp.asarray(_tokens()[:, :-1])
    for qn in ("bf16_config", "qaf_config"):
        logits, _ = jax.jit(lambda p, t, f: jreg.forward(
            p, cfg, getattr(jfqt, qn)(), {"tokens": t, "frames": f},
            seed=5))(params, toks, frames)
        ref[f"logits/{qn}"] = _u16(logits)


def _ref_grads(ref):
    from repro.models import registry as jreg
    cfg, params = jax_get_config(ARCH).smoke(), _jax_params()
    batch = {"tokens": jnp.asarray(_tokens()),
             "frames": jnp.asarray(_frames(2))}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jreg.loss_fn(p, cfg, jfqt.nvfp4_paper_config(), batch,
                               seed=jnp.uint32(SEED), remat=False),
        has_aux=True))(params)
    ref["loss"] = np.float32(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        ref["grads" + jax.tree_util.keystr(path)] = np.asarray(leaf,
                                                               np.float32)


def _ref_stream(ref):
    cfg = jax_get_config(ARCH).smoke()
    ref["stream"], ref["margins"] = jax_engine_stream(
        cfg, _jax_params(), "nvfp4", "nvfp4", _prompts(), MAX_NEW, MAX_LEN,
        extras={"frames": jnp.asarray(_frames(len(PROMPT_LENS)))})


def _ref_continuous(ref):
    from repro import serve as jserve
    cfg = jax_get_config(ARCH).smoke()
    eng = jserve.ContinuousEngine(cfg, _jax_params(),
                                  jserve.ServeConfig(**CONT_SCFG))
    res = eng.run(_cont_requests(jserve.Request),
                  extras={r: {"frames": jnp.asarray(f)}
                          for r, f in _cont_frames().items()})
    for rid, toks in res.items():
        ref[f"cont/{rid}/stream"] = np.asarray(toks, np.int32)
        ref[f"cont/{rid}/margins"] = np.asarray(eng.margins[rid],
                                                np.float32)
    ref["cont/compiles"] = np.asarray([getattr(eng, c) for c in COMPILES])
    ref["cont/preemptions"] = np.int64(eng.scheduler.stats["preemptions"])


def write_jax_reference(out_path, part=0, parts=1):
    run_jobs([_ref_grads, _ref_continuous, _ref_stream, _ref_encode_forward,
              _ref_units], out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_whisper"),
                    REF_PARTS)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).smoke()
    return cfg, params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, _jax_params()), cfg, device="cpu")


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


def _from_bits(u16: np.ndarray) -> np.ndarray:
    return torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16
                                                     ).float().numpy()


# ---- tests that need no reference (they run while it is written) ----------------


def test_configs_match_reference():
    """whisper-base and its smoke config field for field the reference's."""
    R.check_configs(ARCH)


def test_params_from_jax_numpy_splits_enc_and_dec(model):
    """The reference's stacked ``enc`` (enc_layers) and ``dec`` (n_layers)
    become per-layer lists of its leaves, layer i the stack's row i."""
    cfg, params = model
    jp = jax.tree_util.tree_map(np.asarray, _jax_params())
    assert len(params["enc"]) == cfg.enc_layers == 2
    assert len(params["dec"]) == cfg.n_layers == 2
    assert "xattn" in params["dec"][0] and "xattn" not in params["enc"][0]
    for key in ("enc", "dec"):
        for i, lp in enumerate(params[key]):
            for name, _, _ in ckpt.reference_leaves(lp):
                keys = [k.strip("'") for k in name.strip("[]").split("][")]
                want = jp[key]
                got = lp
                for k in keys:
                    want, got = want[k], got[k]
                np.testing.assert_array_equal(_bits(got), _u16(want[i]))
    assert float(torch.abs(params["dec"][1]["xattn"]["bk"]).sum()) > 0


def test_checkpoints_cross_both_ways(model, tmp_path):
    """A JAX-written TrainState and packed tree restore in the port and
    the port's in the reference, 0 leaves apart; the port's leaf names
    are ``jax.tree_util.keystr``'s (``['dec']``, ``['enc']``, ...)."""
    cfg, params = model
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(_jax_params())]
    assert [n for n, _, _ in ckpt.reference_leaves(params)] == want
    assert want[0].startswith("['dec']")
    R.check_checkpoints(ARCH, cfg, tmp_path)


def test_init_packed_params_is_the_packed_init():
    """The streaming packer (``finish`` per encoder and decoder layer)
    builds ``pack_model_params(init_params(...))`` bit for bit."""
    cfg = get_config(ARCH).smoke()
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    got = packing.init_packed_params(cfg, gens[0], NVFP4, device="cpu")
    want = packing.pack_model_params(
        cfg, registry.init_params(cfg, generator=gens[1], device="cpu"),
        NVFP4)
    a, b = ckpt.reference_leaves(got), ckpt.reference_leaves(want)
    assert [n for n, _, _ in a] == [n for n, _, _ in b]
    assert any(".packed" in n for n, _, _ in a)
    for (n, pa, _), (_, pb, _) in zip(a, b):
        assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   if x.element_size() == 1 else torch.equal(x, y)
                   for x, y in zip(pa, pb)), n


def test_reset_decode_state_zeroes_the_encdec_carry(model):
    """``reset_decode_state`` on (enc_out, caches): the encoder output is
    zeroed and the caches emptied at the same addresses (it is no hybrid
    carry, whose reset would read a dict of Mamba states)."""
    cfg, params = model
    carry = registry.make_decode_state(cfg, 2, MAX_LEN,
                                       kv_cache_format="nvfp4", device="cpu")
    ptrs = [carry[0].data_ptr()] + [c.k_codes.data_ptr() for c in carry[1]]
    with torch.no_grad():
        registry.prefill(params, cfg, fqt.qaf_config(),
                         torch.ones((2, 5), dtype=torch.long), carry,
                         extras={"frames": _t(_frames(2))})
    assert bool(carry[0].abs().sum() > 0)
    assert all(int(c.length) == 5 for c in carry[1])
    registry.reset_decode_state(carry)
    assert [carry[0].data_ptr()] + [c.k_codes.data_ptr()
                                    for c in carry[1]] == ptrs
    assert not bool(carry[0].any())
    assert all(int(c.length) == 0 and not bool(c.k_codes.any())
               for c in carry[1])
    paged = registry.make_decode_state(cfg, 2, MAX_LEN, page_size=16,
                                       kv_cache_format="nvfp4", device="cpu")
    paged[0].fill_(1.0)
    paged[1][0].lengths.fill_(3)
    registry.reset_decode_state(paged)
    assert not bool(paged[0].any()) and not bool(paged[1][0].lengths.any())


def test_refusals_are_the_reference_ones(model):
    """The continuous-batching entries the reference keeps closed for
    encdec raise its NotImplementedError, word for word: prefix pages,
    chunked prefill, verify-k, a masked decode step; ContinuousEngine with
    the prefix cache, chunked prefill or speculative decoding."""
    from repro import serve as jserve
    from repro.models import registry as jreg
    cfg, params = model
    jcfg = jax_get_config(ARCH).smoke()
    q, jq = fqt.qaf_config(), jfqt.qaf_config()
    carry = registry.make_decode_state(cfg, 1, MAX_LEN, page_size=16,
                                       kv_cache_format="nvfp4", device="cpu")
    tok = torch.ones((1, 4), dtype=torch.long)
    mask = torch.ones((1,), dtype=torch.bool)
    calls = (
        ("prefill_suffix", (tok, carry, 0, 4, 2), {}),
        ("prefill_chunk", (tok, carry, 0, 0), {}),
        ("verify_k", (tok, carry), {}),
        ("decode_step", (tok[:, :1], carry), {"write_mask": mask}))
    for name, args, kw in calls:
        with pytest.raises(NotImplementedError) as want:
            getattr(jreg, name)(None, jcfg, jq, *args, **kw)
        with pytest.raises(NotImplementedError) as got:
            getattr(registry, name)(params, cfg, q, *args, **kw)
        assert str(got.value) == str(want.value), name
    for fields in (dict(prefix_cache=True), dict(prefill_chunk=16),
                   dict(spec_k=4)):
        with pytest.raises(NotImplementedError) as want:
            jserve.ContinuousEngine(jcfg, None, jserve.ServeConfig(**fields),
                                    pack_weights=False)
        with pytest.raises(NotImplementedError) as got:
            ContinuousEngine(cfg, params, ServeConfig(**fields),
                             device="cpu")
        assert str(got.value) == str(want.value), fields


def test_launchers_smoke():
    """``--arch whisper-base --smoke`` serves in lockstep with random
    frames, through ContinuousEngine with ``--queue`` (random frames a
    request) and trains, on the CPU."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len",
              "6", "--max-new", "3", "--max-len", "64"]
    out = serve_cli.main(common + ["--batch", "2"])
    assert len(out) == 2 and all(len(o) == 3 for o in out)
    res = serve_cli.main(common + ["--queue", "3"])
    assert sorted(res) == [0, 1, 2]
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "8"])


# ---- against the reference ---------------------------------------------------------


def test_gelu_bits(jax_ref):
    """``refnum.Gelu`` is XLA's tanh GELU bit for bit on the smoke
    config's pre-activations (f32 out, and the backward's bf16 gradient);
    torch's own tanh GELU parts from it in the last f32 bit of some."""
    h = torch.from_numpy(jax_ref["gelu/pre"].view(np.int16)).view(
        torch.bfloat16).float().requires_grad_(True)
    y = refnum.Gelu.apply(h)
    np.testing.assert_array_equal(y.detach().numpy().view(np.uint32),
                                  jax_ref["gelu/out"])
    g = torch.from_numpy(_bf16(np.random.default_rng(4).standard_normal(
        h.shape)).view(np.int16)).view(torch.bfloat16)
    hb = h.detach().to(torch.bfloat16).requires_grad_(True)
    refnum.Gelu.apply(hb.float()).to(torch.bfloat16).backward(g)
    np.testing.assert_array_equal(_bits(hb.grad), jax_ref["gelu/grad"])
    theirs = torch.nn.functional.gelu(h.detach(), approximate="tanh")
    assert int((theirs != y.detach()).sum()) > 0


def test_gelu_mlp_and_biased_attention(jax_ref):
    """The biased GELU MLP, the biased non-causal self-attention (the
    encoder's) and cross-attention to a 32-row ``xkv`` under qaf_config,
    bit for bit (training attention, ``attention_core``)."""
    cfg, attn, mlp, x, xkv = _unit_inputs()
    tt = lambda d: {k: _t(v) for k, v in d.items()}  # noqa: E731
    q, kw = fqt.qaf_config(), _attn_kw(cfg)
    with torch.no_grad():
        got = mlp_apply(tt(mlp), _t(x), QCtx(q, 7), "gelu")
        np.testing.assert_array_equal(_bits(got), jax_ref["mlp"])
        got, _ = attn_apply(tt(attn), _t(x), QCtx(q, 8), causal=False, **kw)
        np.testing.assert_array_equal(_bits(got), jax_ref["attn/self"])
        got, cache = attn_apply(tt(attn), _t(x), QCtx(q, 9), xkv=_t(xkv),
                                **kw)
        assert cache is None
        np.testing.assert_array_equal(_bits(got), jax_ref["attn/cross"])


def test_encode(model, jax_ref):
    """``encode`` bit for bit on the training route; on the serving route
    (K7's plain version) within ``K7_ENC_ULPS`` bf16 ulps of each value."""
    cfg, params = model
    want = jax_ref["encode"]
    with torch.no_grad():
        train = whisper.encode(params, cfg, fqt.qaf_config(),
                               _t(_frames(2)), seed=3)
        serve = whisper.encode(params, cfg, fqt.qaf_config(),
                               _t(_frames(2)), seed=3, serving=True)
    np.testing.assert_array_equal(_bits(train), want)
    w = _from_bits(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(serve.float().numpy() - w) <= K7_ENC_ULPS * ulp)


@pytest.mark.parametrize("qn", ("qaf_config", "bf16_config"))
def test_forward_logits(model, jax_ref, qn):
    cfg, params = model
    toks = torch.from_numpy(_tokens()[:, :-1]).long()
    with torch.no_grad():
        logits, aux = registry.forward(params, cfg, getattr(fqt, qn)(),
                                       {"tokens": toks,
                                        "frames": _t(_frames(2))}, seed=5)
    assert float(aux) == 0.0
    want = jax_ref[f"logits/{qn}"]
    if qn == "qaf_config":
        np.testing.assert_array_equal(_bits(logits), want)
        return
    w = _from_bits(want)
    np.testing.assert_allclose(logits.float().numpy(), w, rtol=0,
                               atol=BF16_LOGIT_SCALE * float(np.abs(w).max()))


def test_loss_and_grads(model, jax_ref):
    """The loss (rtol 1e-6) and every reference leaf's gradient under
    nvfp4_paper_config with remat: the GEMM weights bit for bit, the key
    biases against their block's query-bias scale, the rest at
    ``OTHER_LEAF_REL_L2``."""
    from repro_torch.train import step as step_mod
    cfg, params = model
    batch = {"tokens": torch.from_numpy(_tokens()).long(),
             "frames": _t(_frames(2))}
    loss, _, grads = step_mod.loss_and_grads(
        params, cfg, fqt.nvfp4_paper_config(), batch, seed=SEED, remat=True)
    np.testing.assert_allclose(float(loss), jax_ref["loss"],
                               rtol=R.LOSS_RTOL)
    names = [k[len("grads"):] for k in jax_ref if k.startswith("grads[")]
    assert len(names) == len(ckpt.reference_leaves(params))
    for name in names:
        want = jax_ref["grads" + name]
        got = R.port_leaf(grads, name).float().numpy()
        assert got.shape == want.shape, name
        leaf = name.strip("[]").split("][")[-1].strip("'")
        if leaf in GEMM_LEAVES:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        scale = jax_ref["grads" + name.replace("['bk']", "['bq']")]
        rel = float(np.linalg.norm(got - want)
                    / max(np.linalg.norm(scale), 1e-30))
        assert rel <= OTHER_LEAF_REL_L2, f"{name}: relative L2 {rel:.3g}"


def test_engine_stream_with_frames(model, jax_ref):
    """The packed-NVFP4 lockstep Engine with frames (nvfp4 KV) against the
    JAX Engine: streams and greedy margins."""
    cfg, params = model
    eng = Engine(cfg, params, ServeConfig(batch_size=len(PROMPT_LENS),
                                          max_len=MAX_LEN,
                                          kv_cache_format="nvfp4",
                                          decode_chunk=4, eos_id=NO_EOS),
                 device="cpu")
    frames = _frames(len(PROMPT_LENS))
    got = np.stack(eng.generate(_prompts(), max_new=MAX_NEW,
                                extras={"frames": frames}))
    want, margins = jax_ref["stream"], jax_ref["margins"]
    assert got.shape == want.shape == (len(PROMPT_LENS), MAX_NEW)
    for i, (g, w, m) in enumerate(zip(got, want, margins)):
        if assert_stream(g, w, m, f"row {i}"):
            np.testing.assert_allclose(eng.margins[i], m, rtol=0,
                                       atol=MARGIN_ATOL)
    # a second generate on the same engine (its carry reset in place, the
    # frames copied into the same operand) repeats the first
    again = np.stack(eng.generate(_prompts(), max_new=MAX_NEW,
                                  extras={"frames": torch.from_numpy(
                                      frames.view(np.int16)).view(
                                      torch.bfloat16)}))
    np.testing.assert_array_equal(again, got)


def test_continuous_engine_with_frames(model, jax_ref):
    """ContinuousEngine serving three requests over two slots, two with
    their own frames and one without, through a preemption (re-encoding
    at re-admission): streams and margins against the JAX
    ContinuousEngine, and the five compile counts equal (prefill 2: with
    frames and without)."""
    cfg, params = model
    eng = ContinuousEngine(cfg, params, ServeConfig(**CONT_SCFG),
                           device="cpu")
    res = eng.run(_cont_requests(Request), extras={
        r: {"frames": f} for r, f in _cont_frames().items()})
    assert sorted(res) == [r for r, *_ in CONT_REQS]
    for rid, toks in res.items():
        key = f"cont/{rid}"
        if assert_stream(toks, jax_ref[f"{key}/stream"],
                         jax_ref[f"{key}/margins"], key):
            np.testing.assert_allclose(eng.margins[rid],
                                       jax_ref[f"{key}/margins"], rtol=0,
                                       atol=MARGIN_ATOL, err_msg=key)
    assert eng.scheduler.stats["preemptions"] == \
        int(jax_ref["cont/preemptions"]) > 0
    assert [getattr(eng, c) for c in COMPILES] == \
        jax_ref["cont/compiles"].tolist()
    assert eng.prefill_compiles == 2


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
