"""The port's dense archs beyond Llama-2 and the lockstep sliding-window
cache, against the JAX package, on the CPU.

Smoke configs of CodeQwen1.5-7B (QKV bias, MHA, rope theta 1e6), Qwen2.5-32B
(QKV bias, GQA), Llama3-405B (GQA, rope theta 5e5) and TinyLlama with qk-norm,
from the same JAX-initialised parameters (``convert.params_from_jax_numpy``):
forward logits and GEMM-weight gradients bit for bit, lockstep and
continuous streams equal.  Mixtral's smoke config (window 64) serves a
prompt longer than its rolling buffer through the lockstep ``Engine`` on the
bf16, nvfp4 and fp8 caches.  K6's plain version with the rolling rule is held
to the reference's ``_attn_decode_packed`` over ``swa_kpos``, and the
streaming packer ``init_packed_params`` to packing the whole init.  The JAX
reference runs in subprocesses with excess precision off
(``tests/_jax_ref.py``); ``python <this file> OUT PART PARTS`` writes a
part of it.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_ref import (Reference, assert_card_loss_within_one_ulp,
                      assert_stream, jax_engine_stream, port_leaf, run_jobs)
from repro.configs import get_config as jax_get_config
from repro.core import fqt as jfqt
from repro.core import quantize as jq
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
from repro_torch.core import fqt
from repro_torch.core.quantize import PackedQuantizedTensor
from repro_torch.kernels import counters
from repro_torch.kernels.flash_attn import flash_attention_packed
from repro_torch.models import registry
from repro_torch.serve import (ContinuousEngine, Engine, Request,
                               ServeConfig, packing)
from repro_torch.train import step as step_mod

torch.set_num_threads(1)

QK = "tinyllama-1.1b qk-norm"
DENSE = ("codeqwen1.5-7b", "qwen2.5-32b", "llama3-405b", QK)
MIXTRAL = "mixtral-8x7b"
SEQ = 32                        # loss/grads: the dense attention branch
SEED = 0xA5C5
NO_EOS = -1
PROMPT_LENS = (8, 6)
# lockstep: (arch, KV format) with packed NVFP4 weights (qaf_config)
LOCKSTEP = (("codeqwen1.5-7b", "nvfp4"), ("codeqwen1.5-7b", "fp8"),
            ("qwen2.5-32b", "nvfp4"), ("qwen2.5-32b", "fp8"),
            ("llama3-405b", "nvfp4"), (QK, "nvfp4"))
# the rolling lockstep cache: window 64, prompts of 80 and 70 tokens, 40 new,
# max_len 128 -> a 64-row buffer that rolls in the prefill and every step
ROLL_PROMPTS, ROLL_NEW, ROLL_MAX_LEN = (80, 70), 40, 128
# (cache format, weights): the packed NVFP4 weights throughout, whose GEMMs
# sum exactly in any order, so only the cache format changes; with bf16
# weights the one-ulp GEMM differences of XLA and torch reorder near-tied
# router probabilities over the 160-token prefill
ROLL = (("bf16", "nvfp4"), ("nvfp4", "nvfp4"), ("fp8", "nvfp4"))
# continuous: arch, ServeConfig fields, runs
CONT = {
    "codeqwen staggered preempt": ("codeqwen1.5-7b", dict(
        max_slots=3, total_pages=6, kv_cache_format="nvfp4"), 1),
    "qwen2.5 prefix chunked fp8": ("qwen2.5-32b", dict(
        max_slots=2, prefix_cache=True, prefill_chunk=8,
        kv_cache_format="fp8"), 2),
    "llama3 spec": ("llama3-405b", dict(max_slots=2, spec_k=4,
                                        draft_layers=1), 1),
}
# the reference's jobs run in this many subprocesses at once
REF_PARTS = 3
GEMM_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head")


def _cfg(get, arch):
    if arch == QK:
        return dataclasses.replace(get("tinyllama-1.1b").smoke(),
                                   use_qk_norm=True)
    return get(arch).smoke()


def _tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, SEQ + 1)).astype(np.int32)


def _prompts(vocab, lens=PROMPT_LENS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in lens]


def _requests(case, vocab, run=0):
    rng = np.random.default_rng(100 * run + len(case))
    if "prefix" in case:
        shared = np.random.default_rng(9).integers(0, vocab, 32)
        return [(10 * run + i,
                 np.concatenate([shared, rng.integers(0, vocab, 5 + 3 * i)]),
                 6, i) for i in range(3)]
    if "spec" in case:
        return [(i, rng.integers(0, vocab, 6 + 2 * i), 8, i // 2)
                for i in range(3)]
    return [(i, rng.integers(0, vocab, 12 + 2 * i), 10, i // 2)
            for i in range(5)]


def _cont_scfg(fields, cls=ServeConfig):
    return cls(max_len=64, page_size=16, decode_chunk=4, eos_id=NO_EOS,
               **fields)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jreg.init_params(_cfg(jax_get_config, arch), jax.random.PRNGKey(0))


def _ref_dense(arch, ref):
    """Forward logits, loss and gradients of one dense arch."""
    cfg, p = _cfg(jax_get_config, arch), _jax_params(arch)
    toks = _tokens(cfg)
    logits, _ = jax.jit(lambda q, t: jreg.forward(
        q, cfg, jfqt.nvfp4_paper_config(), {"tokens": t}, seed=5))(
        p, jnp.asarray(toks[:, :-1]))
    ref[f"{arch}/logits"] = np.asarray(logits, np.float32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda q: jreg.loss_fn(q, cfg, jfqt.nvfp4_paper_config(),
                               {"tokens": jnp.asarray(toks)},
                               seed=jnp.uint32(SEED), remat=True),
        has_aux=True))(p)
    ref[f"{arch}/loss"] = np.float32(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        ref[f"{arch}/grads" + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)


def _ref_lockstep(arch, fmt, ref):
    cfg = _cfg(jax_get_config, arch)
    ref[f"lockstep/{arch}/{fmt}/stream"], \
        ref[f"lockstep/{arch}/{fmt}/margins"] = jax_engine_stream(
            cfg, _jax_params(arch), fmt, "nvfp4", _prompts(cfg.vocab_size),
            8, 64)


def _ref_roll(fmt, weights, ref):
    cfg = jax_get_config(MIXTRAL).smoke()
    ref[f"roll/{fmt}/stream"], ref[f"roll/{fmt}/margins"] = jax_engine_stream(
        cfg, _jax_params(MIXTRAL), fmt, weights,
        _prompts(cfg.vocab_size, ROLL_PROMPTS), ROLL_NEW, ROLL_MAX_LEN)


def _ref_continuous(case, ref):
    from repro import serve as jserve
    arch, fields, runs = CONT[case]
    cfg = _cfg(jax_get_config, arch)
    eng = jserve.ContinuousEngine(cfg, _jax_params(arch),
                                  _cont_scfg(fields, jserve.ServeConfig))
    for run in range(runs):
        res = eng.run([jserve.Request(rid=r, prompt=np.asarray(
            pr, np.int32), max_new=mn, arrival=a) for r, pr, mn, a in
            _requests(case, cfg.vocab_size, run)])
        for rid, toks in res.items():
            key = f"{case}/{run}/{rid}"
            ref[f"{key}/stream"] = np.asarray(toks, np.int32)
            ref[f"{key}/margins"] = np.asarray(eng.margins[rid], np.float32)


def write_jax_reference(out_path, part=0, parts=1):
    jobs = ([functools.partial(_ref_dense, a) for a in DENSE]
            + [functools.partial(_ref_continuous, c) for c in CONT]
            + [functools.partial(_ref_roll, *r) for r in ROLL]
            + [functools.partial(_ref_lockstep, *c) for c in LOCKSTEP])
    run_jobs(jobs, out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The JAX reference, started with the module's first test; the tests
    that need none come first and run meanwhile."""
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_archs"), REF_PARTS)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in DENSE + (MIXTRAL,):
        jp = jreg.init_params(_cfg(jax_get_config, arch),
                              jax.random.PRNGKey(0))
        cfg = _cfg(get_config, arch)
        out[arch] = (cfg, params_from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu"))
    return out


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


@pytest.mark.parametrize("arch", DENSE + (MIXTRAL, "qwen3-moe-235b-a22b"))
def test_configs_are_the_references(arch):
    cfg, jcfg = get_config(arch.split(" ")[0]), jax_get_config(
        arch.split(" ")[0])
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in cfg.__dataclass_fields__}


@pytest.mark.parametrize("arch", DENSE)
def test_card_loss_gradient_within_one_ulp(models, arch):
    """The card's loss gradient (``refnum.torch_nll``) on this model's
    logits stays within one bf16 ulp of the reference order's."""
    cfg, params = models[arch]
    toks = torch.from_numpy(_tokens(cfg)).long()
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, fqt.nvfp4_paper_config(),
                                     {"tokens": toks[:, :-1]}, seed=5)
    assert_card_loss_within_one_ulp(logits, toks[:, 1:], arch)


def _t(a) -> torch.Tensor:
    """A JAX array as a torch tensor on the CPU (float8 through its
    bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return tensor_from_numpy(a, "cpu")


def _jax_rolling_oracle(q, kc, ks, vc, vs, fmt, q_offset, kv_len, window):
    from repro.models.layers import PackedKVCache as JCache
    from repro.models.layers import _attn_decode_packed, swa_kpos
    buf = kc.shape[1]
    cache = JCache(kc, ks, vc, vs, jnp.int32(q_offset + 1), fmt, 16)
    kpos = swa_kpos(jnp.asarray([q_offset + 1], jnp.int32), buf)[0]
    return _attn_decode_packed(
        jnp.asarray(q), cache, qpos=jnp.asarray([q_offset], jnp.int32),
        kpos=kpos, causal=True, window=window, kv_len=kv_len)


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8"])
@pytest.mark.parametrize("H,KVH", [(4, 4), (8, 2)])
@pytest.mark.parametrize("length", [40, 64, 65, 150])
def test_k6_plain_rolling_vs_reference(fmt, H, KVH, length):
    """K6's plain version with ``rolling`` against the reference's
    ``_attn_decode_packed`` over ``swa_kpos`` (the lockstep decode read of
    a sliding-window cache): a 64-row buffer holding fewer, exactly 64 and
    more tokens than it has rows (rows overwritten), GQA, both formats."""
    B, buf, D, window = 2, 64, 32, 64
    rng = np.random.default_rng(length + H)
    k = (rng.standard_normal((B, buf, KVH, D)) * 2).astype(np.float32)
    v = rng.standard_normal((B, buf, KVH, D)).astype(np.float32)
    kc, ks = jq.kv_quant_rows(jnp.asarray(k), fmt)
    vc, vs = jq.kv_quant_rows(jnp.asarray(v), fmt)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    q_offset, kv_len = length - 1, min(length, buf)
    want = _jax_rolling_oracle(q, kc, ks, vc, vs, fmt, q_offset, kv_len,
                               window)
    t = [_t(a) for a in (kc, ks, vc, vs)]
    pos = torch.tensor([q_offset, kv_len], dtype=torch.int32)
    got = flash_attention_packed(torch.from_numpy(q), *t, pos, fmt=fmt,
                                 window=window, rolling=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="window"):
        flash_attention_packed(torch.from_numpy(q), *t, pos, fmt=fmt,
                               rolling=True)


def _same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, PackedQuantizedTensor):
        assert isinstance(b, PackedQuantizedTensor), where
        for f in ("packed", "scales", "tscale"):
            _same_tree(getattr(a, f), getattr(b, f), f"{where}.{f}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b), where


@pytest.mark.parametrize("arch", ["qwen2.5-32b", MIXTRAL, "zamba2-1.2b",
                                  "xlstm-125m"])
def test_init_packed_params_is_the_packed_init(arch):
    """The streaming packer builds exactly pack_model_params(init_params):
    the same draws from the generator, leaf for leaf and bit for bit (the
    recurrent families' inits pack each layer, zamba2's shared block and
    the lm_head as they are drawn)."""
    cfg = get_config(arch).smoke()
    spec = fqt.qaf_config().fwd_w
    gen = torch.Generator().manual_seed(3)
    want = packing.pack_model_params(
        cfg, registry.init_params(cfg, generator=gen, device="cpu"), spec)
    gen = torch.Generator().manual_seed(3)
    got = packing.init_packed_params(cfg, gen, spec, device="cpu")
    _same_tree(got, want)
    first = {"hybrid": lambda t: t["mamba"][0]["in_proj"],
             "ssm": lambda t: t["layers"][0]["mlstm"]["w_q"]}.get(
        cfg.family, lambda t: t["layers"][0]["attn"]["wq"])
    assert isinstance(first(got), PackedQuantizedTensor)
    assert isinstance(got["lm_head"], PackedQuantizedTensor)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits(models, jax_ref, arch):
    cfg, params = models[arch]
    toks = torch.from_numpy(_tokens(cfg)[:, :-1]).long()
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, fqt.nvfp4_paper_config(),
                                     {"tokens": toks}, seed=5)
    np.testing.assert_array_equal(logits.float().numpy(),
                                  jax_ref[f"{arch}/logits"])


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads(models, jax_ref, arch):
    """The dense attention branch: loss and every GEMM-weight gradient
    bit-identical; the bias and norm leaves at the 1-D-leaf rule of
    tests/test_torch_train.py (3e-2: sums over tokens that XLA and torch
    reduce in another order)."""
    cfg, params = models[arch]
    loss, _, grads = step_mod.loss_and_grads(
        params, cfg, fqt.nvfp4_paper_config(),
        {"tokens": torch.from_numpy(_tokens(cfg)).long()}, seed=SEED,
        remat=True)
    np.testing.assert_allclose(float(loss), jax_ref[f"{arch}/loss"],
                               rtol=1e-6)
    prefix = f"{arch}/grads"
    names = [k[len(prefix):] for k in jax_ref if k.startswith(prefix)]
    for name in names:
        want = jax_ref[prefix + name]
        got = port_leaf(grads, name).float().numpy()
        leaf = name.strip("[]").split("][")[-1].strip("'")
        if leaf in GEMM_LEAVES:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= 3e-2, f"{name}: relative L2 {rel:.3g}"


def _engine_run(models, arch, fmt, weights, lens, max_new, max_len):
    cfg, params = models[arch]
    prompts = _prompts(cfg.vocab_size, lens)
    qcfg = fqt.qaf_config() if weights == "nvfp4" else fqt.bf16_config()
    eng = Engine(cfg, params, ServeConfig(batch_size=len(prompts),
                                          max_len=max_len,
                                          kv_cache_format=fmt,
                                          decode_chunk=4),
                 qcfg=qcfg, device="cpu")
    return eng, np.stack(eng.generate(prompts, max_new=max_new))


def _check_streams(eng, got, want, margins, exact_margins):
    same = all(assert_stream(g, w, m, f"row {i}") for i, (g, w, m) in
               enumerate(zip(got, want, margins)))
    if same and exact_margins:
        np.testing.assert_array_equal(np.asarray(eng.margins), margins)


@pytest.mark.parametrize("arch,fmt", LOCKSTEP,
                         ids=[f"{a}-{f}" for a, f in LOCKSTEP])
def test_lockstep_streams(models, jax_ref, arch, fmt):
    eng, got = _engine_run(models, arch, fmt, "nvfp4", PROMPT_LENS, 8, 64)
    _check_streams(eng, got, jax_ref[f"lockstep/{arch}/{fmt}/stream"],
                   jax_ref[f"lockstep/{arch}/{fmt}/margins"], True)


@pytest.mark.parametrize("fmt,weights", ROLL, ids=[r[0] for r in ROLL])
def test_lockstep_rolling_cache(models, jax_ref, fmt, weights):
    """Mixtral's 64-token window over a 64-row lockstep buffer: the 80-token
    prefill keeps its last 64 rows and every decode step overwrites the
    oldest row, read through K6's rolling rule (nvfp4, fp8) or the dense
    read (bf16)."""
    eng, got = _engine_run(models, MIXTRAL, fmt, weights, ROLL_PROMPTS,
                           ROLL_NEW, ROLL_MAX_LEN)
    assert eng._carry[0].buf == 64
    assert int(eng._carry[0].length) == max(ROLL_PROMPTS) + eng.steps
    _check_streams(eng, got, jax_ref[f"roll/{fmt}/stream"],
                   jax_ref[f"roll/{fmt}/margins"], fmt != "bf16")


@pytest.mark.parametrize("case", list(CONT))
def test_continuous_streams(models, jax_ref, case):
    arch, fields, runs = CONT[case]
    cfg, params = models[arch]
    eng = ContinuousEngine(cfg, params, _cont_scfg(fields), device="cpu")
    for run in range(runs):
        res = eng.run([Request(rid=r, prompt=np.asarray(p, np.int32),
                               max_new=mn, arrival=a)
                       for r, p, mn, a in _requests(case, cfg.vocab_size,
                                                    run)])
        for rid, toks in res.items():
            key = f"{case}/{run}/{rid}"
            if assert_stream(toks, jax_ref[f"{key}/stream"],
                              jax_ref[f"{key}/margins"], key):
                np.testing.assert_array_equal(
                    np.asarray(eng.margins[rid], np.float32),
                    jax_ref[f"{key}/margins"], err_msg=key)


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
