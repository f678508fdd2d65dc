"""The port's moe family against the JAX package, on the CPU.

``mixtral-8x7b.smoke()`` (4 experts, top-2, window 64, one dispatch group)
and ``qwen3-moe-235b-a22b.smoke()`` (4 experts, top-2, qk-norm, 16 dispatch
groups wherever they divide the tokens) from the same JAX-initialised
parameters, carried across with ``convert.params_from_jax_numpy``; a
variant with 8 experts and top-4 makes the combine's order of addition
matter.  The JAX reference runs in subprocesses with excess precision off
(``tests/_jax_ref.py``); ``python <this file> OUT PART PARTS`` writes a
part of it.

Held bit for bit: routing (slots, sorted tokens, gates, keep mask; the
router's softmax takes the reference's exp, ``refnum.exp``), dispatched rows,
the combine, ``moe_apply``'s output, the forward logits, and the streams and
greedy margins of both engines.  Tolerances, each with its reason:
  * the aux loss: means over tokens and groups that XLA and torch reduce
    in another order -> rtol 1e-6;
  * gradients: the router's softmax, the gates' renormalisation, the gate
    products and the loss compute their gradients in XLA's order
    (``models/refnum.py``).  Every GEMM-weight gradient, the router's and
    the embedding's come out bit-identical, but for one rule of the
    reference: an expert's update GEMM stays bf16 where its capacity rows
    are not a multiple of the block (Mixtral's 40 rows here), and bf16
    products sum in another order in XLA and torch -> those expert leaves
    at relative L2 1e-4 (2.6e-5 seen); the 1-D leaves (norms) at the
    1-D-leaf rule of tests/test_torch_train.py, 3e-2.
  * the card's loss (``refnum.torch_nll``, torch's log_softmax backward):
    its logit gradient within one bf16 ulp of ``MeanNLL``'s.
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
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
from repro_torch.core import fqt
from repro_torch.kernels import counters
from repro_torch.models import moe, registry
from repro_torch.models.layers import QCtx
from repro_torch.serve import (ContinuousEngine, Engine, Request,
                               ServeConfig)
from repro_torch.train import step as step_mod

torch.set_num_threads(1)

MIXTRAL, QWEN3 = "mixtral-8x7b", "qwen3-moe-235b-a22b"
ARCHS = (MIXTRAL, QWEN3)
# unit cases of the routing: (name, arch, overrides of the smoke config)
UNIT = (("mixtral", MIXTRAL, {}), ("qwen3", QWEN3, {}),
        ("top4", QWEN3, dict(n_experts=8, top_k=4)))
TOKENS = 64
# a router row whose probabilities tie four ways ([.1 .3 .3 .2 .3 0 .3 .1]
# up to the softmax): jax.lax.top_k takes experts (1, 2); torch.topk on the
# CPU returns (1, 6)
TIE_ROW = (1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 3.0, 1.0)
SEQ = 32                   # loss/grads: B 2 x 32 tokens, 16 groups for qwen3
SEED = 0x5EED
NO_EOS = -1
LOCKSTEP = (("nvfp4", "nvfp4"), ("fp8", "nvfp4"), ("bf16", "bf16"))
PROMPT_LENS = (8, 6)
# continuous cases: arch, ServeConfig fields, runs
CONT = {
    "mixtral staggered preempt": (MIXTRAL, dict(max_slots=3, total_pages=6,
                                                kv_cache_format="nvfp4"), 1),
    "qwen3 prefix chunked spec": (QWEN3, dict(
        max_slots=2, prefix_cache=True, prefill_chunk=8, spec_k=4,
        draft_layers=1, kv_cache_format="fp8"), 2),
}
# the reference's jobs run in this many subprocesses at once
REF_PARTS = 3
GEMM_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head", "router", "embed")
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _cfg(mod, arch, over=None):
    return dataclasses.replace(mod(arch).smoke(), **(over or {}))


def _unit_inputs(cfg):
    """(x (T, d) bf16, router logits (T, E) bf16-valued f32); with 8
    experts the first rows are the tied row."""
    import ml_dtypes
    rng = np.random.default_rng(7)
    x = rng.standard_normal((TOKENS, cfg.d_model)).astype(ml_dtypes.bfloat16)
    lg = rng.standard_normal((TOKENS, cfg.n_experts)).astype(
        ml_dtypes.bfloat16).astype(np.float32)
    if cfg.n_experts == len(TIE_ROW):
        lg[:4] = np.asarray(TIE_ROW, np.float32)
    return x, lg


def _capacity(cfg):
    c = int(TOKENS * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cfg.top_k, (c + 3) // 4 * 4)


def _ye(cfg):
    import ml_dtypes
    return np.random.default_rng(8).standard_normal(
        (cfg.n_experts, _capacity(cfg), cfg.d_model)).astype(
        ml_dtypes.bfloat16)


def _tokens(cfg, seq=SEQ):
    return np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, seq + 1)).astype(np.int32)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _requests(case, vocab, run=0):
    rng = np.random.default_rng(100 * run + len(case))
    if case.startswith("qwen3"):
        shared = np.random.default_rng(9).integers(0, vocab, 32)
        return [(10 * run + i,
                 np.concatenate([shared, rng.integers(0, vocab, 5 + 3 * i)]),
                 6, i) for i in range(3)]
    return [(i, rng.integers(0, vocab, 12 + 2 * i), 10, i // 2)
            for i in range(5)]


def _cont_scfg(fields, cls=ServeConfig):
    return cls(max_len=64, page_size=16, decode_chunk=4, eos_id=NO_EOS,
               **fields)


def _qcfg(weights, mod):
    return mod.qaf_config() if weights == "nvfp4" else mod.bf16_config()


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jreg.init_params(jax_get_config(arch).smoke(),
                            jax.random.PRNGKey(0))


def _ref_units(ref):
    """Routing and combine on the unit inputs, and the tied row's top-2."""
    from repro.models import moe as jmoe
    for name, arch, over in UNIT:
        cfg = _cfg(jax_get_config, arch, over)
        x, lg = _unit_inputs(cfg)
        C = _capacity(cfg)
        xe, meta, aux = jax.jit(lambda a, b: jmoe._dispatch(a, b, cfg, C))(
            jnp.asarray(x), jnp.asarray(lg))
        ref[f"{name}/xe"] = _bits(xe)
        for k, v in zip(("slot", "st", "sg", "keep"), meta):
            ref[f"{name}/{k}"] = np.asarray(v)
        ref[f"{name}/aux"] = np.float32(aux)
        ref[f"{name}/combine"] = _bits(jax.jit(
            lambda a, m: jmoe._combine(a, m, TOKENS))(jnp.asarray(_ye(cfg)),
                                                      meta))
    ref["tie"] = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray([TIE_ROW], jnp.float32)), 2)[1])


def _ref_forward(arch, ref):
    """Layer 0's moe block and the forward logits."""
    from repro.models import moe as jmoe
    from repro.models.layers import QCtx as JQCtx
    cfg, params = jax_get_config(arch).smoke(), _jax_params(arch)
    layer = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])
    x, _ = _unit_inputs(cfg)
    for T in (TOKENS, TOKENS + 2):               # 16 groups, then one
        y, aux = jax.jit(lambda p, a: jmoe.moe_apply(
            p, a, JQCtx(jfqt.nvfp4_paper_config(), jnp.uint32(9)),
            cfg))(layer, jnp.asarray(np.resize(x, (T, cfg.d_model))))
        ref[f"{arch}/apply/{T}/y"] = _bits(y)
        ref[f"{arch}/apply/{T}/aux"] = np.float32(aux)
    toks = _tokens(cfg)
    for qn in ("nvfp4_paper_config", "qaf_config"):
        logits, _ = jax.jit(lambda p, t: jreg.forward(
            p, cfg, getattr(jfqt, qn)(), {"tokens": t}, seed=5))(
            params, jnp.asarray(toks[:, :-1]))
        ref[f"{arch}/logits/{qn}"] = np.asarray(logits, np.float32)


def _ref_grads(arch, ref):
    cfg, params = jax_get_config(arch).smoke(), _jax_params(arch)
    qcfg = jfqt.nvfp4_paper_config()
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jreg.loss_fn(p, cfg, qcfg, {"tokens": jnp.asarray(
            _tokens(cfg))}, seed=jnp.uint32(SEED), remat=True),
        has_aux=True))(params)
    ref[f"{arch}/loss"] = np.float32(loss)
    ref[f"{arch}/nll"] = np.float32(aux["nll"])
    ref[f"{arch}/aux"] = np.float32(aux["aux"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        ref[f"{arch}/grads" + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)


def _ref_lockstep(fmt, weights, ref):
    cfg = jax_get_config(QWEN3).smoke()
    ref[f"lockstep/{fmt}/stream"], ref[f"lockstep/{fmt}/margins"] = \
        jax_engine_stream(cfg, _jax_params(QWEN3), fmt, weights,
                          _prompts(cfg.vocab_size), 8, 64)


def _ref_continuous(case, ref):
    from repro import serve as jserve
    arch, fields, runs = CONT[case]
    cfg = jax_get_config(arch).smoke()
    eng = jserve.ContinuousEngine(cfg, _jax_params(arch),
                                  _cont_scfg(fields, jserve.ServeConfig))
    for run in range(runs):
        res = eng.run([jserve.Request(rid=r, prompt=np.asarray(
            p, np.int32), max_new=mn, arrival=a) for r, p, mn, a in
            _requests(case, cfg.vocab_size, run)])
        for rid, toks_ in res.items():
            key = f"{case}/{run}/{rid}"
            ref[f"{key}/stream"] = np.asarray(toks_, np.int32)
            ref[f"{key}/margins"] = np.asarray(eng.margins[rid], np.float32)


def write_jax_reference(out_path, part=0, parts=1):
    jobs = ([functools.partial(_ref_grads, a) for a in ARCHS]
            + [functools.partial(_ref_continuous, c) for c in CONT]
            + [functools.partial(_ref_lockstep, *c) for c in LOCKSTEP]
            + [functools.partial(_ref_forward, a) for a in ARCHS]
            + [_ref_units])
    run_jobs(jobs, out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The JAX reference, started with the module's first test; the tests
    that need none come first and run meanwhile."""
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_moe"), REF_PARTS)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch).smoke()
        jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch).smoke()
        out[arch] = (cfg, params_from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu"))
    return out


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _tbits(t: torch.Tensor) -> np.ndarray:
    return t.detach().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("arch", ARCHS)
def test_card_loss_gradient_within_one_ulp(models, arch):
    """The card's loss gradient (``refnum.torch_nll``) on this model's
    logits stays within one bf16 ulp of the reference order's."""
    cfg, params = models[arch]
    toks = torch.from_numpy(_tokens(cfg)).long()
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, fqt.nvfp4_paper_config(),
                                     {"tokens": toks[:, :-1]}, seed=5)
    assert_card_loss_within_one_ulp(logits, toks[:, 1:], arch)


def test_moe_refusals_that_stay(models):
    """The reference's own refusals under a window stay (Mixtral); the moe
    family itself is served."""
    cfg, params = models[MIXTRAL]
    for fields in (dict(prefix_cache=True), dict(prefill_chunk=8),
                   dict(spec_k=4)):
        with pytest.raises(NotImplementedError):
            ContinuousEngine(cfg, params, ServeConfig(max_len=64, **fields),
                             device="cpu")


@pytest.mark.parametrize("name,arch,over", UNIT, ids=[u[0] for u in UNIT])
def test_dispatch_and_combine(jax_ref, name, arch, over):
    cfg = _cfg(get_config, arch, over)
    x, lg = _unit_inputs(cfg)
    C = _capacity(cfg)
    xe, meta, aux, _ = moe._dispatch_ids(_t(x), torch.from_numpy(lg),
                                         cfg, C)
    np.testing.assert_array_equal(_tbits(xe), jax_ref[f"{name}/xe"])
    for k, v in zip(("slot", "st", "keep"), (meta[0], meta[1], meta[3])):
        np.testing.assert_array_equal(v.numpy(), jax_ref[f"{name}/{k}"],
                                      err_msg=k)
    np.testing.assert_array_equal(meta[2].numpy(), jax_ref[f"{name}/sg"])
    np.testing.assert_allclose(float(aux), jax_ref[f"{name}/aux"], rtol=1e-6)
    y = moe._combine(_t(_ye(cfg)), meta, TOKENS)
    np.testing.assert_array_equal(_tbits(y), jax_ref[f"{name}/combine"])


def test_tied_router_row_takes_the_lower_experts(jax_ref):
    """Four tied probabilities: the port picks JAX's experts (1, 2)."""
    cfg = _cfg(get_config, QWEN3, dict(n_experts=8, top_k=2))
    x = torch.ones((1, cfg.d_model), dtype=torch.bfloat16)
    _, (slot, st, _, keep), _, _ = moe._dispatch_ids(
        x, torch.tensor([TIE_ROW]), cfg, _capacity(cfg))
    C = _capacity(cfg)
    assert sorted((slot[keep] // C).tolist()) == \
        sorted(jax_ref["tie"][0].tolist()) == [1, 2]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", (TOKENS, TOKENS + 2), ids=("groups",
                                                         "no groups"))
def test_moe_apply(models, jax_ref, arch, T):
    """Layer 0's moe block under nvfp4_paper_config on 64 tokens (16
    dispatch groups for qwen3) and on 66 (one group)."""
    cfg, params = models[arch]
    x, _ = _unit_inputs(cfg)
    with torch.no_grad():
        y, aux = moe.moe_apply(params["layers"][0]["moe"],
                               _t(np.resize(x, (T, cfg.d_model))),
                               QCtx(fqt.nvfp4_paper_config(), 9), cfg)
    np.testing.assert_array_equal(_tbits(y), jax_ref[f"{arch}/apply/{T}/y"])
    np.testing.assert_allclose(float(aux), jax_ref[f"{arch}/apply/{T}/aux"],
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("qn", ("nvfp4_paper_config", "qaf_config"))
def test_forward_logits(models, jax_ref, arch, qn):
    cfg, params = models[arch]
    toks = torch.from_numpy(_tokens(cfg)[:, :-1]).long()
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, getattr(fqt, qn)(),
                                     {"tokens": toks}, seed=5)
    np.testing.assert_array_equal(logits.float().numpy(),
                                  jax_ref[f"{arch}/logits/{qn}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads(models, jax_ref, arch):
    cfg, params = models[arch]
    batch = {"tokens": torch.from_numpy(_tokens(cfg)).long()}
    loss, aux, grads = step_mod.loss_and_grads(
        params, cfg, fqt.nvfp4_paper_config(), batch, seed=SEED, remat=True)
    np.testing.assert_allclose(float(loss), jax_ref[f"{arch}/loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(aux["nll"]), jax_ref[f"{arch}/nll"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(aux["aux"]), jax_ref[f"{arch}/aux"],
                               rtol=1e-6)
    # loss = nll + router_aux_weight * aux
    assert float(loss) > float(aux["nll"])
    prefix = f"{arch}/grads"
    names = [k[len(prefix):] for k in jax_ref if k.startswith(prefix)]
    assert any("router" in n for n in names)
    for name in names:
        want = jax_ref[prefix + name]
        got = port_leaf(grads, name).float().numpy()
        assert got.shape == want.shape, name
        leaf = name.strip("[]").split("][")[-1].strip("'")
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        if leaf in EXPERT_LEAVES and _bf16_update(cfg, SEQ * 2):
            assert rel <= 1e-4, f"{name}: relative L2 {rel:.3g}"
        elif leaf in GEMM_LEAVES:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert rel <= 3e-2, f"{name}: relative L2 {rel:.3g}"


def _bf16_update(cfg, tokens) -> bool:
    """The experts' update GEMMs run in bf16 (the reference's rule for a
    contraction that is not a multiple of the block): their capacity rows
    are not a multiple of 16."""
    G = cfg.moe_groups if (cfg.moe_groups and tokens % cfg.moe_groups == 0) \
        else 1
    return (G * moe._capacity(tokens // G, cfg)) % 16 != 0


@pytest.mark.parametrize("fmt,weights", LOCKSTEP, ids=[c[0]
                                                       for c in LOCKSTEP])
def test_lockstep_streams(models, jax_ref, fmt, weights):
    cfg, params = models[QWEN3]
    prompts = _prompts(cfg.vocab_size)
    eng = Engine(cfg, params, ServeConfig(batch_size=len(prompts),
                                          max_len=64, kv_cache_format=fmt,
                                          decode_chunk=4),
                 qcfg=_qcfg(weights, fqt), device="cpu")
    got = np.stack(eng.generate(prompts, max_new=8))
    want = jax_ref[f"lockstep/{fmt}/stream"]
    margins = jax_ref[f"lockstep/{fmt}/margins"]
    same = all(assert_stream(g, w, m, f"row {i}") for i, (g, w, m) in
               enumerate(zip(got, want, margins)))
    if same and weights == "nvfp4":
        np.testing.assert_array_equal(np.asarray(eng.margins), margins)


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
    st = eng.scheduler.stats
    if case.startswith("mixtral"):
        assert st["preemptions"] > 0
    else:
        assert st["prefix_tokens_skipped"] > 0
        assert len(eng.scheduler.prefill_log) > 0
        assert eng.metrics.summary()["spec_accepted_per_tick_slot"]["n"] > 0


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
