"""Cases shared by tests/test_torch_mamba2.py (zamba2, family "hybrid") and
tests/test_torch_xlstm.py (xLSTM, family "ssm"): the port against the JAX
package on a smoke config, from the same JAX-initialised parameters
(``convert.params_from_jax_numpy``).

The ``ref_*`` jobs write the JAX reference and run in the subprocesses of
``tests/_jax_ref.Reference`` (excess precision off); the ``check_*``
functions hold the port to it.  Tolerances, each with its reason:
  * forward logits: under nvfp4_paper_config bit for bit (every GEMM sums
    E2M1 x E4M3 products, exact in f32 in any order, and the recurrences'
    f32 differences stay below the bf16 roundings here); under bf16_config
    within ``BF16_LOGIT_SCALE`` of the logits' scale: bf16 x bf16 products
    do not sum exactly and XLA and torch add them in another order (the
    dense family's rule in tests/test_torch_serve.py is 2^-6, 0.7% seen
    there), and a recurrence carries each token's moved values into every
    later token (1.0% seen for zamba2, 1.6% for xLSTM);
  * greedy streams of the packed NVFP4 Engine: token for token, and the
    greedy margins within ``MARGIN_ATOL``;
  * loss and gradients under nvfp4_paper_config: the loss and every GEMM
    weight's gradient bit for bit (held at rtol 1e-6 and equality); the
    other leaves (norm weights, the conv weights, the SSM and gate
    parameters, the embedding) are sums over B*S tokens that XLA and torch
    reduce in another order and precision -> relative L2 3e-2, the 1-D-leaf
    rule of tests/test_torch_train.py;
  * the Trainer: events and LRs equal; the losses of the first two steps
    at the loss tolerance (AdamW's first update is lr * sign(g), so the
    other leaves' gradient differences do not reach the parameters), later
    ones at ``TRAIN_LOSS_RTOL``: from the second update on those
    differences move the clipping scale and the moments, a few bf16
    weights round the other way, and the FP4 forward turns them into
    flipped codes (0.6% seen at zamba2's fourth step, 1.5% at xLSTM's).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _jax_ref import assert_stream, jax_engine_stream

SEQ = 32                     # loss/grads: B 2 x 32 tokens (one SSM chunk)
BATCH = 2
SEED = 0x5EED                # the loss_fn's SR seed
PROBE_STEP = 7
PROMPT_LENS = (8, 6)
MAX_NEW = 8
MAX_LEN = 64
MARGIN_ATOL = 1e-5
LOSS_RTOL = 1e-6
OTHER_LEAF_REL_L2 = 3e-2
TRAIN_LOSS_RTOL = 3e-2
BF16_LOGIT_SCALE = 2.0 ** -5
# the GEMM weights, whose gradients are bit-identical
GEMM_LEAVES = frozenset({
    "in_proj", "out_proj", "wq", "wk", "wv", "wo", "w_gate", "w_up",
    "w_down", "w_q", "w_k", "w_v", "w_gates", "w_ff_gate", "w_ff_up",
    "w_ff_down", "lm_head"})
# the Trainer: a fixed QAF switch at step 2 of 4, batch 2 x 16
TRAIN_STEPS, QAF_AT, TRAIN_SEQ = 4, 2, 16


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    from repro.configs import get_config as jax_get_config
    from repro.models import registry as jreg
    return jreg.init_params(jax_get_config(arch).smoke(),
                            jax.random.PRNGKey(0))


def port_model(arch):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax_numpy
    cfg = get_config(arch).smoke()
    return cfg, params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params(arch)), cfg,
        device="cpu")


def tokens(vocab, seq=SEQ):
    return np.random.default_rng(3).integers(0, vocab, (BATCH, seq + 1)
                                             ).astype(np.int32)


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _jcfg(arch):
    from repro.configs import get_config as jax_get_config
    return jax_get_config(arch).smoke()


# the Trainer scenario: no remat (the values do not depend on it) and no
# sigma_q probe (its SR draws are a declared divergence, held separately):
# each halves the reference's compile
def _jax_tcfg():
    from repro.optim import schedule as jsched
    from repro.train import TrainConfig as JTC
    return JTC(sched=jsched.ScheduleConfig(warmup_steps=2, total_steps=10),
               remat=False, probe_sigma=False)


def _port_tcfg():
    from repro_torch.optim import schedule
    from repro_torch.train import TrainConfig
    return TrainConfig(sched=schedule.ScheduleConfig(warmup_steps=2,
                                                     total_steps=10),
                       remat=False, probe_sigma=False)


def check_configs(arch):
    """The port's copy of the arch's config, and its ``smoke()``, field for
    field the reference's (zamba2's smoke: 4 layers, attn_every 2, state
    16, 4 SSM heads; xLSTM's: 4 blocks, the fourth sLSTM)."""
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for full in (False, True):
        want = jax_get_config(arch)
        got = get_config(arch)
        if not full:
            want, got = want.smoke(), got.smoke()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---- the reference's jobs ------------------------------------------------------


def ref_forward(arch, ref):
    from repro.core import fqt as jfqt
    from repro.models import registry as jreg
    cfg, params = _jcfg(arch), jax_params(arch)
    toks = tokens(cfg.vocab_size)
    for qn in ("bf16_config", "nvfp4_paper_config"):
        logits, _ = jax.jit(lambda p, t: jreg.forward(
            p, cfg, getattr(jfqt, qn)(), {"tokens": t}, seed=5))(
            params, jnp.asarray(toks[:, :-1]))
        ref[f"{arch}/logits/{qn}"] = np.asarray(logits).view(np.uint16)


def ref_grads(arch, ref):
    """Loss and per-leaf grads under nvfp4_paper_config, and the sigma_q
    probe on those grads.  The reference runs without remat (the loss and
    the GEMM weights' gradients do not depend on it, and its compile takes
    half the time); the port is held to them with remat."""
    from repro.core import fqt as jfqt
    from repro.models import registry as jreg
    from repro.train import step as jstep
    cfg, params = _jcfg(arch), jax_params(arch)
    toks = jnp.asarray(tokens(cfg.vocab_size))
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jreg.loss_fn(p, cfg, jfqt.nvfp4_paper_config(),
                               {"tokens": toks}, seed=jnp.uint32(SEED),
                               remat=False), has_aux=True))(params)
    ref[f"{arch}/loss"] = np.float32(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        ref[f"{arch}/grads" + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)
    ref[f"{arch}/sigma_q"] = np.float32(jax.jit(jstep._estimate_sigma_q)(
        grads, jnp.int32(PROBE_STEP)))


def ref_stream(arch, ref):
    cfg = _jcfg(arch)
    ref[f"{arch}/stream"], ref[f"{arch}/margins"] = jax_engine_stream(
        cfg, jax_params(arch), "nvfp4", "nvfp4", prompts(cfg.vocab_size),
        MAX_NEW, MAX_LEN)


def ref_trainer(arch, ref):
    from repro.core import fqt as jfqt
    from repro.core import qaf as jqaf
    from repro.data.pipeline import DataConfig as JDC
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    from repro.train import step as jstep
    cfg = _jcfg(arch)
    # the reference's AdamW init aliases every f32 parameter (A_log, D,
    # dt_bias, b_if, b_gates) as its own master weight (astype to the same
    # dtype), and its jitted step donates both: "donate the same buffer
    # twice".  The reference Trainer runs here on a copy of each leaf.
    init_state = jstep.init_state
    jstep.init_state = lambda *a, **k: jax.tree_util.tree_map(
        lambda x: jnp.array(x, copy=True), init_state(*a, **k))
    tr = JTrainer(cfg, jfqt.nvfp4_paper_config(), _jax_tcfg(),
                  JTrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                 qaf=jqaf.QAFConfig(
                                     auto_switch=False,
                                     fixed_switch_step=QAF_AT)),
                  JDC(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=BATCH))
    try:
        tr.run(jax.random.PRNGKey(0))
    finally:
        jstep.init_state = init_state
    ref[f"{arch}/trainer"] = np.asarray(json.dumps(
        {"events": tr.events, "lr": [h["lr"] for h in tr.history],
         "loss": [h["loss"] for h in tr.history]}, default=float))


def ref_jobs(arch):
    """The model-level jobs, the longest first."""
    return [functools.partial(f, arch)
            for f in (ref_trainer, ref_grads, ref_stream, ref_forward)]


# ---- the port against it -----------------------------------------------------------


def check_forward(arch, params, cfg, ref, qn):
    from repro_torch.core import fqt
    from repro_torch.models import registry
    toks = torch.from_numpy(tokens(cfg.vocab_size)[:, :-1]).long()
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, getattr(fqt, qn)(),
                                     {"tokens": toks}, seed=5)
    bits = ref[f"{arch}/logits/{qn}"]
    if qn == "nvfp4_paper_config":
        got = logits.contiguous().view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, bits)
        return
    want = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16
                                                      ).float().numpy()
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=BF16_LOGIT_SCALE
                               * float(np.abs(want).max()))


def port_leaf(tree, name):
    """The port's tensor behind a reference leaf path: ``['mamba'][...]``
    and ``['layers'][...]`` of a stacked tree stacked over layers, a
    numbered path (``['layers'][3]['slstm'][...]``) followed as it is."""
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    node = tree
    for i, k in enumerate(keys):
        if isinstance(node, list) and not k.isdigit():
            return torch.stack([port_leaf(lp, "[" + "][".join(
                repr(x) for x in keys[i:]) + "]") for lp in node])
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


def check_grads(arch, params, cfg, ref):
    """The loss; each reference leaf's gradient, the GEMM weights' bit for
    bit.  Returns the relative L2 of each leaf."""
    from repro_torch.core import fqt
    from repro_torch.train import step as step_mod
    batch = {"tokens": torch.from_numpy(tokens(cfg.vocab_size)).long()}
    loss, _, grads = step_mod.loss_and_grads(
        params, cfg, fqt.nvfp4_paper_config(), batch, seed=SEED, remat=True)
    np.testing.assert_allclose(float(loss), ref[f"{arch}/loss"],
                               rtol=LOSS_RTOL)
    prefix = f"{arch}/grads"
    names = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    rels = {}
    for name in names:
        want = ref[prefix + name]
        got = port_leaf(grads, name).float().numpy()
        assert got.shape == want.shape, name
        rel = float(np.linalg.norm(got - want)
                    / max(np.linalg.norm(want), 1e-30))
        rels[name] = rel
        if name.strip("[]").split("][")[-1].strip("'") in GEMM_LEAVES:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert rel <= OTHER_LEAF_REL_L2, f"{name}: relative L2 {rel:.3g}"
    return rels


def check_probe(arch, params, ref):
    """The sigma_q probe walks the reference's leaves in the reference's
    order (names of ``jax.tree_util``), and on the reference's own gradients
    gives its sigma_q within 2% (the SR draws are a declared divergence)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.train import step as step_mod
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(jax_params(arch))]
    assert [n for n, _, _ in ckpt.reference_leaves(params)] == want
    prefix = f"{arch}/grads"
    grads = _fill(params, iter(ref[prefix + n] for n in want))
    got = float(step_mod._estimate_sigma_q(grads, PROBE_STEP))
    w = float(ref[f"{arch}/sigma_q"])
    assert abs(got - w) <= 0.02 * w, (got, w)


def _fill(like, it):
    """``like``'s structure with leaves taken in the reference's order from
    ``it`` (stacked leaves split over the layers), as f32 tensors."""
    from repro_torch.checkpoint import ckpt
    leaves = ckpt.reference_leaves(like)
    arrays = [next(it) for _ in leaves]
    out = []
    for (_, parts, stacked), a in zip(leaves, arrays):
        out.append([torch.from_numpy(a[i].copy()) for i in range(len(parts))]
                   if stacked else torch.from_numpy(a.copy()))
    return ckpt._rebuild(like, iter(out).__next__)


def check_stream(arch, params, cfg, ref):
    from repro_torch.serve import Engine, ServeConfig
    ps = prompts(cfg.vocab_size)
    eng = Engine(cfg, params, ServeConfig(batch_size=len(ps),
                                          max_len=MAX_LEN,
                                          kv_cache_format="nvfp4",
                                          decode_chunk=4), device="cpu")
    got = np.stack(eng.generate(ps, max_new=MAX_NEW))
    want, margins = ref[f"{arch}/stream"], ref[f"{arch}/margins"]
    assert got.shape == want.shape == (len(ps), MAX_NEW)
    for i, (g, w, m) in enumerate(zip(got, want, margins)):
        assert assert_stream(g, w, m, f"{arch} row {i}", tol=0.0), i
    np.testing.assert_allclose(np.asarray(eng.margins), margins, rtol=0,
                               atol=MARGIN_ATOL)
    return eng


def check_trainer(arch, cfg, ref):
    """The port's Trainer from the reference's initial TrainState, the
    same data and a fixed QAF switch: events and LRs equal, the first two
    losses at ``LOSS_RTOL``, the later ones at ``TRAIN_LOSS_RTOL``."""
    from repro.train import step as jstep
    from repro_torch.convert import train_state_from_jax_numpy
    from repro_torch.core import fqt, qaf
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    want = json.loads(str(ref[f"{arch}/trainer"]))
    init = train_state_from_jax_numpy(jax.tree_util.tree_map(
        np.asarray, jstep.init_state(_jcfg(arch), _jax_tcfg(),
                                     jax.random.PRNGKey(0))), cfg,
        device="cpu")
    tr = Trainer(cfg, fqt.nvfp4_paper_config(), _port_tcfg(),
                 TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                               qaf=qaf.QAFConfig(auto_switch=False,
                                                 fixed_switch_step=QAF_AT)),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            global_batch=BATCH), device="cpu")
    tr.run(init)
    strip = [{k: v for k, v in e.items() if k != "gnr"} for e in tr.events]
    assert strip == [{k: v for k, v in e.items() if k != "gnr"}
                     for e in want["events"]]
    assert any(e["kind"] == "qaf_switch" for e in tr.events)
    np.testing.assert_allclose([h["lr"] for h in tr.history], want["lr"],
                               rtol=1e-6)
    losses = [h["loss"] for h in tr.history]
    np.testing.assert_allclose(losses[:2], want["loss"][:2], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, want["loss"], rtol=TRAIN_LOSS_RTOL)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(
        {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def check_checkpoints(arch, cfg, tmp_path):
    """A JAX-written TrainState and packed tree restore in the port, and the
    port's in the reference, with 0 differing leaves."""
    from repro.checkpoint import ckpt as jckpt
    from repro.core import quantize as jquant
    from repro.serve.packing import pack_model_params as jpack
    from repro.train import step as jstep
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import train_state_from_jax_numpy
    from repro_torch.core import quantize as tquant
    from repro_torch.serve.packing import pack_model_params
    jcfg = _jcfg(arch)
    jstate = jstep.init_state(jcfg, _jax_tcfg(), jax.random.PRNGKey(0))
    jstate = jstate._replace(step=jnp.int32(5))
    jpacked = jax.jit(lambda p: jpack(jcfg, p, jquant.NVFP4))(jstate.params)
    pstate = train_state_from_jax_numpy(jax.tree_util.tree_map(
        np.asarray, jstate), cfg, device="cpu")
    ppacked = pack_model_params(cfg, pstate.params, tquant.NVFP4)
    for name, jtree, ptree in (("state", jstate, pstate),
                               ("packed", jpacked, ppacked)):
        jckpt.save(str(tmp_path / "jax" / name), 5, jtree)
        ckpt.save(str(tmp_path / "port" / name), 5, ptree)
        # the reference's checkpoint in the port
        got = ckpt.restore(str(tmp_path / "jax" / name), 5, ptree)
        want = ckpt.reference_leaves(ptree)
        have = ckpt.reference_leaves(got)
        assert [n for n, _, _ in have] == [n for n, _, _ in want]
        bad = [n for (n, pa, _), (_, pb, _) in zip(have, want)
               if not all(_same(x, y) for x, y in zip(pa, pb))]
        assert bad == [], f"{name}: leaves differ: {bad}"
        # the port's checkpoint in the reference
        back = jckpt.restore(str(tmp_path / "port" / name), 5, jtree)
        la, lb = (jax.tree_util.tree_leaves(t) for t in (back, jtree))
        assert len(la) == len(lb) == len(want)
        bad = [i for i, (x, y) in enumerate(zip(la, lb))
               if np.asarray(x).dtype != np.asarray(y).dtype
               or not np.array_equal(_bits(x), _bits(y))]
        assert bad == [], f"{name}: reference leaves differ: {bad}"


def _same(x, y) -> bool:
    if not isinstance(x, torch.Tensor):
        return x == y
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.view(torch.uint8) if x.element_size() == 1 else x, y.view(
            torch.uint8) if y.element_size() == 1 else y)
