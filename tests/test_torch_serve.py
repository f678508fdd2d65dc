"""The port's serving slice against the JAX package, on the CPU.

Both packages serve ``llama2-7b.smoke()`` (MHA) and ``tinyllama-1.1b.smoke()``
(GQA) from the same JAX-initialised parameters, carried across with
``repro_torch.convert.params_from_jax_numpy``.

The JAX reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``.  By default XLA's CPU
compiler, under ``jit``, drops f32 -> bf16 -> f32 round trips (rmsnorm's
cast to ``x.dtype``, the bf16 GEMM outputs), so the jitted reference skips
bf16 roundings that its own source states and that op-by-op JAX and the port
both make.  The next GEMM's FP4 re-quantization turns each skipped rounding
into flipped codes, and greedy streams part within a few steps.  With the
flag the jitted reference computes what its source says, and the port
agrees with it token for token.  Running this file as a script writes that
reference (``python tests/test_torch_serve.py OUT.npz``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import fqt as jfqt
from repro.models import registry as jreg
from repro.serve import packing as jpack
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
from repro_torch.core import fqt
from repro_torch.core import quantize as tq
from repro_torch.kernels import counters
from repro_torch.models import registry
from repro_torch.serve import Engine, ServeConfig, packing

torch.set_num_threads(1)

ARCHS = ("llama2-7b", "tinyllama-1.1b")
# (arch, KV cache format, weights): the packed NVFP4 path (qaf_config) with
# the nvfp4 cache on MHA and GQA and the fp8 cache on GQA, and the
# unquantized path (bf16_config, bf16 cache) as ``--bf16`` serves it
CASES = (("llama2-7b", "nvfp4", "nvfp4"), ("tinyllama-1.1b", "nvfp4", "nvfp4"),
         ("tinyllama-1.1b", "fp8", "nvfp4"), ("llama2-7b", "bf16", "bf16"))
PROMPT_LENS = (8, 6)             # unequal: the shorter one is left-padded
MAX_NEW = 8
MAX_LEN = 64
MARGIN_TOL = 0.02                # as tests/test_scheduler.py's gate


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _padded(prompts):
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


def _jax_params(arch):
    cfg = jax_get_config(arch).smoke()
    return cfg, jreg.init_params(cfg, jax.random.PRNGKey(0))


def _checksum(params) -> float:
    return float(sum(np.asarray(leaf, np.float64).sum() for leaf in
                     jax.tree_util.tree_leaves(params)))


def _qcfg(weights, fqt_mod):
    return fqt_mod.qaf_config() if weights == "nvfp4" else fqt_mod.bf16_config()


def write_jax_reference(out_path):
    """JAX Engine streams, and the logits behind them teacher-forced through
    the Engine's own compiled prefill and the registry's decode step."""
    from repro.distributed import sharding as shd
    from repro.serve import Engine as JEngine
    from repro.serve import ServeConfig as JServeConfig
    ref = {}
    decode = jax.jit(jreg.decode_step, static_argnums=(1, 2))
    for arch in ARCHS:
        cfg, params = _jax_params(arch)
        ref[f"{arch}/checksum"] = _checksum(params)
        # packed once here; the Engine takes the packed tree as it is
        packed = jpack.pack_model_params(cfg, params,
                                         jfqt.qaf_config().fwd_w)
        ref[f"{arch}/weight_store_bytes"] = jpack.weight_store_bytes(packed)
        prompts = _prompts(cfg.vocab_size)
        for a, fmt, weights in CASES:
            if a != arch:
                continue
            qcfg = _qcfg(weights, jfqt)
            eng = JEngine(cfg, packed if weights == "nvfp4" else params,
                          JServeConfig(batch_size=len(prompts),
                                       max_len=MAX_LEN, kv_cache_format=fmt,
                                       decode_chunk=4),
                          qcfg=qcfg, pack_weights=False)
            stream = np.stack(eng.generate(prompts, max_new=MAX_NEW))
            carry = shd.place_serve_cache(jreg.make_decode_state(
                cfg, len(prompts), MAX_LEN, kv_cache_format=fmt), eng.mesh)
            logits, carry = eng._prefill(
                eng._replicate(jnp.asarray(_padded(prompts))), carry, {})
            steps = [np.asarray(logits, np.float32)]
            for t in range(stream.shape[1] - 1):
                lg, carry = decode(eng.params, cfg, qcfg,
                                   jnp.asarray(stream[:, t:t + 1]), carry)
                steps.append(np.asarray(lg[:, -1], np.float32))
            logits = np.stack(steps, axis=1)            # (B, T, V)
            top2 = np.sort(logits, axis=-1)[..., -2:]
            ref[f"{arch}/{fmt}/stream"] = stream.astype(np.int32)
            ref[f"{arch}/{fmt}/logits"] = logits
            ref[f"{arch}/{fmt}/margins"] = top2[..., 1] - top2[..., 0]
    np.savez(out_path, **ref)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, __file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params on the CPU)."""
    out = {}
    for arch in ARCHS:
        jcfg, jparams = _jax_params(arch)
        cfg = get_config(arch).smoke()
        tparams = params_from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        out[arch] = (jcfg, jparams, cfg, tparams)
    return out


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def test_configs_are_the_references(models):
    for jcfg, _, cfg, _ in models.values():
        assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
            {f: getattr(jcfg, f) for f in cfg.__dataclass_fields__}
    full = get_config("llama2-7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.hd, full.d_ff,
            full.vocab_size, full.act) == (32, 4096, 32, 128, 11008, 32000,
                                           "smooth_swiglu")


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_store_bytes_equal(models, jax_ref, arch):
    jcfg, jparams, cfg, tparams = models[arch]
    assert jax_ref[f"{arch}/checksum"] == _checksum(jparams), \
        "the reference subprocess initialised other parameters"
    packed = packing.pack_model_params(cfg, tparams, fqt.qaf_config().fwd_w)
    assert packing.weight_store_bytes(packed) == \
        int(jax_ref[f"{arch}/weight_store_bytes"])


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_fp4_matmul_per_layer(models, arch):
    """Every packed GEMM weight of every layer, and the lm_head: the port's
    forward (K4's plain version) against ``fqt.fp4_matmul``'s jnp packed
    path, at the K4 tolerance of tests/test_kernels.py (1e-5)."""
    jcfg, jparams, cfg, tparams = models[arch]
    jqc, tqc = jfqt.qaf_config(), fqt.qaf_config()
    jp = jpack.pack_model_params(jcfg, jparams, jqc.fwd_w)
    tp = packing.pack_model_params(cfg, tparams, tqc.fwd_w)
    rng = np.random.default_rng(1)
    pairs = [(jp["lm_head"], tp["lm_head"])]
    for i in range(cfg.n_layers):
        jl = _layer(jp["layers"], i)
        for blk in ("attn", "mlp"):
            for name, leaf in tp["layers"][i][blk].items():
                if isinstance(leaf, tq.PackedQuantizedTensor):
                    pairs.append((jl[blk][name], leaf))
    assert len(pairs) == 7 * cfg.n_layers + 1
    ref = jax.jit(lambda x, w: jfqt.fp4_matmul(x, w, cfg=jqc))
    for jw, tw in pairs:
        K = tw.shape[0]
        x = (rng.standard_normal((2, 3, K)) * 2).astype(np.float32)
        want = ref(jnp.asarray(x), jw)
        got = fqt.fp4_matmul(torch.from_numpy(x), tw, cfg=tqc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _port_logits(models, arch, fmt, weights, stream):
    """Teacher-forced port logits over the reference stream: (B, T, V)."""
    _, _, cfg, tparams = models[arch]
    qcfg = _qcfg(weights, fqt)
    packed = packing.pack_model_params(cfg, tparams, qcfg.fwd_w)
    prompts = _prompts(cfg.vocab_size)
    carry = registry.make_decode_state(cfg, len(prompts), MAX_LEN,
                                       kv_cache_format=fmt, device="cpu")
    with torch.no_grad():
        lg, carry = registry.prefill(
            packed, cfg, qcfg, torch.from_numpy(_padded(prompts)).long(),
            carry)
        steps = [lg.float()]
        for t in range(stream.shape[1] - 1):
            lg, carry = registry.decode_step(
                packed, cfg, qcfg, torch.from_numpy(stream[:, t:t + 1]).long(),
                carry)
            steps.append(lg[:, -1].float())
    return torch.stack(steps, dim=1).numpy()


def _logit_atol(weights, want) -> float:
    """Packed NVFP4 weights: the K4 products (E2M1 x E4M3 on both sides)
    sum exactly in f32 in any order, and the port's prefill attention (K7)
    gets f32 operands so p stays f32 as in the reference's ``_attn_dense``:
    the logits come out bit-identical, held at 1e-3 of their scale.  bf16
    weights: bf16 x bf16 products do not sum exactly, XLA and torch add them
    in another order, and the one-ulp differences of each GEMM's bf16 output
    carry through the layers (0.7% of the scale seen): held at 2^-6 of it,
    two bf16 ulps at the top binade."""
    return (1e-3 if weights == "nvfp4" else 2.0 ** -6) * float(
        np.abs(want).max())


@pytest.mark.parametrize("arch,fmt,weights", CASES)
def test_prefill_and_decode_logits(models, jax_ref, arch, fmt, weights):
    """Prefill and every decode step, teacher-forced on the reference
    stream, at the tolerance of ``_logit_atol``."""
    stream = jax_ref[f"{arch}/{fmt}/stream"]
    want = jax_ref[f"{arch}/{fmt}/logits"]
    got = _port_logits(models, arch, fmt, weights, stream)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_logit_atol(weights, want))


@pytest.mark.parametrize("arch,fmt,weights", CASES)
def test_engine_streams_match_jax_engine(models, jax_ref, arch, fmt,
                                         weights):
    """Greedy streams equal JAX ``Engine``'s; a step may differ only where
    the JAX greedy margin is below 0.02 (a near-tie), and the streams are
    compared up to their first difference (after it, histories differ)."""
    _, _, cfg, tparams = models[arch]
    want = jax_ref[f"{arch}/{fmt}/stream"]
    margins = jax_ref[f"{arch}/{fmt}/margins"]
    prompts = _prompts(cfg.vocab_size)
    eng = Engine(cfg, tparams, ServeConfig(batch_size=len(prompts),
                                           max_len=MAX_LEN,
                                           kv_cache_format=fmt,
                                           decode_chunk=4),
                 qcfg=_qcfg(weights, fqt), device="cpu")
    got = np.stack(eng.generate(prompts, max_new=MAX_NEW))
    assert got.shape == want.shape
    for row in range(len(prompts)):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            assert margins[row, diff[0]] < MARGIN_TOL, \
                f"row {row} differs at decisive step {diff[0]}"
    assert eng.steps == want.shape[1]
    np.testing.assert_allclose(
        np.asarray(eng.margins), margins[:, :eng.steps], rtol=0,
        atol=2 * _logit_atol(weights, jax_ref[f"{arch}/{fmt}/logits"]))


def test_entry_points_need_a_card_unless_cpu_is_asked(models, monkeypatch):
    _, _, cfg, tparams = models["llama2-7b"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, tparams, ServeConfig(batch_size=2, max_len=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax_numpy({"layers": {}}, cfg)
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "llama2-60m", "--smoke"])


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    out = launch.main(["--arch", "llama2-60m", "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "4", "--max-len",
                       "32", "--device", "cpu"])
    assert len(out) == 2 and all(len(o) <= 4 for o in out)
    assert "tok/s" in capsys.readouterr().out


def test_tensor_from_numpy_keeps_bf16_bits():
    import ml_dtypes
    a = np.random.default_rng(2).standard_normal(64).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


if __name__ == "__main__":
    write_jax_reference(sys.argv[1])
