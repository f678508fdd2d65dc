"""The port's vlm family (internvl2-26b: the dense LM behind a prefix of
precomputed patch embeddings) against the JAX package, on the CPU.

``internvl2-26b.smoke()`` (2 layers, d 128, GQA 4/1, d_ff 256, 16 vision
tokens) from the same JAX-initialised parameters
(``convert.params_from_jax_numpy``); the prefix embeddings and tokens are
numpy-seeded.  The JAX reference runs in subprocesses with excess precision
off (``tests/_jax_ref.py``); ``python <this file> OUT PART PARTS`` writes a
part of it.

Tolerances (tests/_recurrent.py and tests/test_torch_whisper.py give the
reasons): forward logits under qaf_config, the loss and every GEMM
weight's gradient under nvfp4_paper_config bit for bit, with and without
the prefix; the other leaves (norms, the embedding) at relative L2
``OTHER_LEAF_REL_L2``; the packed-NVFP4 lockstep stream after a prefix
token for token and its greedy margins within ``MARGIN_ATOL``.
"""
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
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import fqt
from repro_torch.core.quantize import NVFP4
from repro_torch.kernels import counters
from repro_torch.models import registry, transformer
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig, packing

torch.set_num_threads(1)

ARCH = "internvl2-26b"
REF_PARTS = 3
SEQ = 16
SEED = 0x5EED
OTHER_LEAF_REL_L2 = 3e-2
MARGIN_ATOL = 1e-5
NO_EOS = -1
PROMPT_LENS = (8, 6)
MAX_NEW, MAX_LEN = 8, 64
GEMM_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down", "lm_head"})
PREFIX = ("prefix", "no prefix")


def _prefix(n, seed=5):
    import ml_dtypes
    cfg = get_config(ARCH).smoke()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.vision_tokens, cfg.d_model)).astype(
        np.float32).astype(ml_dtypes.bfloat16)


def _batch(case, np_side=False):
    toks = R.tokens(get_config(ARCH).smoke().vocab_size, SEQ)
    b = {"tokens": toks if np_side else torch.from_numpy(toks).long()}
    if case == "prefix":
        b["prefix_embeds"] = (_prefix(2) if np_side
                              else tensor_from_numpy(_prefix(2), "cpu"))
    return b


def _u16(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


# ---- the reference's jobs ------------------------------------------------------


def _ref_model(case, ref):
    from repro.models import registry as jreg
    cfg, params = jax_get_config(ARCH).smoke(), R.jax_params(ARCH)
    batch = {k: jnp.asarray(v) for k, v in _batch(case, True).items()}
    fwd = dict(batch, tokens=batch["tokens"][:, :-1])
    logits, _ = jax.jit(lambda p, b: jreg.forward(
        p, cfg, jfqt.qaf_config(), b, seed=5))(params, fwd)
    ref[f"{case}/logits"] = _u16(logits)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jreg.loss_fn(p, cfg, jfqt.nvfp4_paper_config(), batch,
                               seed=jnp.uint32(SEED), remat=False),
        has_aux=True))(params)
    ref[f"{case}/loss"] = np.float32(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        ref[f"{case}/grads" + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)


def _ref_stream(ref):
    cfg = jax_get_config(ARCH).smoke()
    ref["stream"], ref["margins"] = jax_engine_stream(
        cfg, R.jax_params(ARCH), "nvfp4", "nvfp4", R.prompts(cfg.vocab_size),
        MAX_NEW, MAX_LEN,
        extras={"prefix_embeds": jnp.asarray(_prefix(len(PROMPT_LENS)))})


def write_jax_reference(out_path, part=0, parts=1):
    run_jobs([_ref_stream] + [functools.partial(_ref_model, c)
                              for c in PREFIX], out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_vlm"), REF_PARTS)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(scope="module")
def model():
    return R.port_model(ARCH)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


# ---- tests that need no reference (they run while it is written) ----------------


def test_configs_match_reference():
    R.check_configs(ARCH)


def test_check_family(model):
    """vlm is a transformer family without experts; a vlm config with
    experts, a moe config without, and the families of other modules are
    not."""
    import dataclasses
    cfg, _ = model
    transformer.check_family(cfg)
    moe = get_config("mixtral-8x7b").smoke()
    for bad in (dataclasses.replace(cfg, n_experts=4, top_k=2),
                dataclasses.replace(moe, n_experts=0),
                get_config("whisper-base").smoke(),
                get_config("zamba2-1.2b").smoke()):
        with pytest.raises(ValueError, match="no transformer family"):
            transformer.check_family(bad)


def test_refusals_are_the_reference_ones(model):
    """prefill_slot, prefill_suffix, prefill_chunk, verify_k and
    ContinuousEngine raise the reference's NotImplementedError word for
    word: vlm stays on the lockstep Engine."""
    from repro import serve as jserve
    from repro.models import registry as jreg
    cfg, params = model
    jcfg = jax_get_config(ARCH).smoke()
    q, jq = fqt.qaf_config(), jfqt.qaf_config()
    carry = registry.make_decode_state(cfg, 1, MAX_LEN, page_size=16,
                                       kv_cache_format="nvfp4", device="cpu")
    tok = torch.ones((1, 4), dtype=torch.long)
    for name, args in (("prefill_slot", (tok, carry, 0, 4)),
                       ("prefill_suffix", (tok, carry, 0, 4, 2)),
                       ("prefill_chunk", (tok, carry, 0, 0)),
                       ("verify_k", (tok, carry))):
        with pytest.raises(NotImplementedError) as want:
            getattr(jreg, name)(None, jcfg, jq, *args)
        with pytest.raises(NotImplementedError) as got:
            getattr(registry, name)(params, cfg, q, *args)
        assert str(got.value) == str(want.value), name
    with pytest.raises(NotImplementedError) as want:
        jserve.ContinuousEngine(jcfg, None, jserve.ServeConfig())
    with pytest.raises(NotImplementedError) as got:
        ContinuousEngine(cfg, params, ServeConfig(), device="cpu")
    assert str(got.value) == str(want.value)


def test_checkpoints_and_probe_order(model, tmp_path):
    """The σ_q probe's and the checkpoints' leaf order is the reference's
    ``tree_leaves``; checkpoints cross both ways, 0 leaves apart."""
    cfg, params = model
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(R.jax_params(ARCH))]
    assert [n for n, _, _ in ckpt.reference_leaves(params)] == want
    R.check_checkpoints(ARCH, cfg, tmp_path)


def test_init_packed_params_is_the_packed_init():
    cfg = get_config(ARCH).smoke()
    gens = [torch.Generator().manual_seed(12) for _ in range(2)]
    got = packing.init_packed_params(cfg, gens[0], NVFP4, device="cpu")
    want = packing.pack_model_params(
        cfg, registry.init_params(cfg, generator=gens[1], device="cpu"),
        NVFP4)
    a, b = ckpt.reference_leaves(got), ckpt.reference_leaves(want)
    assert [n for n, _, _ in a] == [n for n, _, _ in b]
    for (n, pa, _), (_, pb, _) in zip(a, b):
        assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   if x.element_size() == 1 else torch.equal(x, y)
                   for x, y in zip(pa, pb)), n


def test_prefix_is_attended(model):
    """The prefix changes the logits of every token row, and a prefix of
    P rows is the prompt's first P positions: ``prefill`` after the
    prefix gives the last row of ``forward``'s logits with it (bf16, no
    quantization, so only the attention's route differs)."""
    cfg, params = model
    b = _batch("prefix")
    toks = b["tokens"][:, :-1]
    with torch.no_grad():
        with_p, _ = registry.forward(params, cfg, fqt.bf16_config(),
                                     {"tokens": toks, "prefix_embeds":
                                      b["prefix_embeds"]})
        without, _ = registry.forward(params, cfg, fqt.bf16_config(),
                                      {"tokens": toks})
        carry = registry.make_decode_state(cfg, 2, MAX_LEN, device="cpu")
        last, _ = registry.prefill(params, cfg, fqt.bf16_config(), toks,
                                   carry, extras={"prefix_embeds":
                                                  b["prefix_embeds"]})
    assert with_p.shape == without.shape == (2, SEQ, cfg.padded_vocab)
    assert bool((with_p != without).any(dim=-1).all())
    assert int(carry[0].length) == cfg.vision_tokens + SEQ
    np.testing.assert_allclose(last.float().numpy(),
                               with_p[:, -1].float().numpy(), rtol=0,
                               atol=2.0 ** -6 * float(with_p.abs().max()))


def test_launchers_smoke():
    """``--arch internvl2-26b --smoke`` serves with random patch
    embeddings and trains on tokens only, on the CPU."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "6", "--max-new",
                          "3", "--max-len", "64"])
    assert len(out) == 2 and all(len(o) == 3 for o in out)
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "8"])


# ---- against the reference ---------------------------------------------------------


@pytest.mark.parametrize("case", PREFIX)
def test_forward_logits(model, jax_ref, case):
    cfg, params = model
    b = _batch(case)
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, fqt.qaf_config(),
                                     dict(b, tokens=b["tokens"][:, :-1]),
                                     seed=5)
    assert logits.shape == (2, SEQ, cfg.padded_vocab)
    np.testing.assert_array_equal(_bits(logits), jax_ref[f"{case}/logits"])


@pytest.mark.parametrize("case", PREFIX)
def test_loss_and_grads(model, jax_ref, case):
    from repro_torch.train import step as step_mod
    cfg, params = model
    loss, _, grads = step_mod.loss_and_grads(
        params, cfg, fqt.nvfp4_paper_config(), _batch(case), seed=SEED,
        remat=True)
    np.testing.assert_allclose(float(loss), jax_ref[f"{case}/loss"],
                               rtol=R.LOSS_RTOL)
    prefix = f"{case}/grads"
    names = [k[len(prefix):] for k in jax_ref if k.startswith(prefix)]
    assert len(names) == len(ckpt.reference_leaves(params))
    for name in names:
        want = jax_ref[prefix + name]
        got = R.port_leaf(grads, name).float().numpy()
        assert got.shape == want.shape, name
        if name.strip("[]").split("][")[-1].strip("'") in GEMM_LEAVES:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            rel = float(np.linalg.norm(got - want)
                        / max(np.linalg.norm(want), 1e-30))
            assert rel <= OTHER_LEAF_REL_L2, f"{name}: relative L2 {rel:.3g}"


def test_engine_stream_with_prefix(model, jax_ref):
    """The packed-NVFP4 lockstep Engine after a 16-row prefix (nvfp4 KV)
    against the JAX Engine: streams token for token, margins within
    ``MARGIN_ATOL``; a second generate repeats the first."""
    cfg, params = model
    eng = Engine(cfg, params, ServeConfig(batch_size=len(PROMPT_LENS),
                                          max_len=MAX_LEN,
                                          kv_cache_format="nvfp4",
                                          decode_chunk=4, eos_id=NO_EOS),
                 device="cpu")
    extras = {"prefix_embeds": _prefix(len(PROMPT_LENS))}
    got = np.stack(eng.generate(R.prompts(cfg.vocab_size), max_new=MAX_NEW,
                                extras=extras))
    want, margins = jax_ref["stream"], jax_ref["margins"]
    assert got.shape == want.shape == (len(PROMPT_LENS), MAX_NEW)
    for i, (g, w, m) in enumerate(zip(got, want, margins)):
        assert assert_stream(g, w, m, f"row {i}", tol=0.0), i
    np.testing.assert_allclose(np.asarray(eng.margins), margins, rtol=0,
                               atol=MARGIN_ATOL)
    again = np.stack(eng.generate(R.prompts(cfg.vocab_size),
                                  max_new=MAX_NEW, extras=extras))
    np.testing.assert_array_equal(again, got)


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
