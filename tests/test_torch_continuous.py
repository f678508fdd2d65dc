"""The port's ContinuousEngine against the JAX ContinuousEngine, on the CPU.

Both packages serve smoke configs (``llama2-7b`` MHA, ``tinyllama-1.1b``
GQA) from the same JAX-initialised parameters, carried across with
``convert.params_from_jax_numpy``.  The JAX engine runs in a subprocess
with ``XLA_FLAGS=--xla_allow_excess_precision=false`` (see
tests/test_torch_serve.py for why); running this file as a script writes
its streams (``python tests/test_torch_continuous.py OUT.npz``).

Greedy streams must be equal, or first differ at a step whose reference
greedy margin is below 0.02 (a near-tie that f32 summation order may
flip).  Cases: staggered arrivals with slot reuse (nvfp4 and the GQA fp8
pool), prefix-cache warm admissions across two ``run`` calls, chunked
prefill over the bf16 pool, speculative verify-k, and preemption under a
small page pool; and ``launch.serve --queue --device cpu``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax_numpy
from repro_torch.kernels import counters
from repro_torch.serve import ContinuousEngine, Request, ServeConfig

torch.set_num_threads(1)

MARGIN_TOL = 0.02
NO_EOS = -1                        # an eos id no sampled token matches
SHARED = 32                        # shared-prefix tokens (two 16-token pages)


def _requests(case, vocab, run=0):
    """(rid, prompt, max_new, arrival) of each request of a case's run."""
    rng = np.random.default_rng(100 * run + len(case))
    if case.startswith("prefix"):
        shared = np.random.default_rng(9).integers(0, vocab, SHARED)
        return [(10 * run + i,
                 np.concatenate([shared, rng.integers(0, vocab, 5 + 3 * i)]),
                 6, i) for i in range(3)]
    if case.startswith("chunked"):
        return [(i, rng.integers(0, vocab, (21, 9, 30)[i]), 6, i // 2)
                for i in range(3)]
    if case == "spec":
        return [(i, rng.integers(0, vocab, 6 + 2 * i), 8, i // 2)
                for i in range(3)]
    # staggered arrivals, 5 requests over 3 slots (slot reuse), that need
    # 2 pages each from a pool of 5 usable pages (preemption)
    return [(i, rng.integers(0, vocab, 12 + 2 * i), 10, i // 2)
            for i in range(5)]


# case -> (arch, ServeConfig fields, number of run() calls); the JAX engine
# compiles its programs anew for each case, so the cases are few and each
# covers several paths
CASES = {
    "staggered preempt": ("llama2-7b", dict(max_slots=3, total_pages=6,
                                            kv_cache_format="nvfp4"), 1),
    "prefix gqa fp8": ("tinyllama-1.1b", dict(max_slots=2, prefix_cache=True,
                                              kv_cache_format="fp8"), 2),
    "chunked bf16": ("llama2-7b", dict(max_slots=2, prefill_chunk=8,
                                       kv_cache_format="bf16"), 1),
    "spec": ("llama2-7b", dict(max_slots=2, spec_k=4, draft_layers=1), 1),
}


def _scfg(fields, config_cls=ServeConfig):
    return config_cls(max_len=64, page_size=16, decode_chunk=4,
                      eos_id=NO_EOS, **fields)


def _jax_params(arch):
    cfg = jax_get_config(arch).smoke()
    return cfg, jreg.init_params(cfg, jax.random.PRNGKey(0))


def write_jax_reference(out_path):
    """Streams, greedy margins and scheduler stats of the JAX engine."""
    from repro import serve as jserve
    ref = {}
    params = {}
    for case, (arch, fields, runs) in CASES.items():
        if arch not in params:
            params[arch] = _jax_params(arch)
        cfg, p = params[arch]
        eng = jserve.ContinuousEngine(cfg, p,
                                      _scfg(fields, jserve.ServeConfig))
        for run in range(runs):
            reqs = [jserve.Request(rid=r, prompt=np.asarray(pr, np.int32),
                                   max_new=mn, arrival=a)
                    for r, pr, mn, a in _requests(case, cfg.vocab_size, run)]
            res = eng.run(reqs)
            for rid, toks in res.items():
                ref[f"{case}/{run}/{rid}/stream"] = np.asarray(toks, np.int32)
                ref[f"{case}/{run}/{rid}/margins"] = np.asarray(
                    eng.margins[rid], np.float32)
            st = eng.scheduler.stats
            ref[f"{case}/{run}/stats"] = np.asarray(
                [st[k] for k in sorted(st)], np.int64)
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
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("llama2-7b", "tinyllama-1.1b"):
        _, jparams = _jax_params(arch)
        cfg = get_config(arch).smoke()
        out[arch] = (cfg, params_from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    return out


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _assert_stream(got, want, margins, where):
    """Equal, or first different where the reference margin is < 0.02
    (after a difference the histories part, so nothing more is held)."""
    n = min(len(got), len(want))
    diff = np.nonzero(got[:n] != want[:n])[0]
    if diff.size:
        assert margins[diff[0]] < MARGIN_TOL, \
            f"{where}: differs at decisive step {diff[0]}"
        return False
    assert len(got) == len(want), where
    return True


@pytest.mark.parametrize("case", list(CASES))
def test_streams_match_jax_engine(models, jax_ref, case):
    arch, fields, runs = CASES[case]
    cfg, tparams = models[arch]
    eng = ContinuousEngine(cfg, tparams, _scfg(fields), device="cpu")
    for run in range(runs):
        reqs = [Request(rid=r, prompt=np.asarray(pr, np.int32), max_new=mn,
                        arrival=a)
                for r, pr, mn, a in _requests(case, cfg.vocab_size, run)]
        res = eng.run(reqs)
        want_rids = sorted(int(k.split("/")[2]) for k in jax_ref
                           if k.startswith(f"{case}/{run}/")
                           and k.endswith("/stream"))
        assert sorted(res) == want_rids
        all_equal = True
        for rid in want_rids:
            key = f"{case}/{run}/{rid}"
            all_equal &= _assert_stream(res[rid], jax_ref[f"{key}/stream"],
                                        jax_ref[f"{key}/margins"],
                                        f"{key}")
            assert len(eng.margins[rid]) == len(res[rid])
            assert np.isfinite(eng.margins[rid]).all()
        if all_equal:        # same tokens: the same schedule, tick by tick
            st = eng.scheduler.stats
            np.testing.assert_array_equal(
                [st[k] for k in sorted(st)], jax_ref[f"{case}/{run}/stats"])
        if case.startswith("prefix") and run == 1:
            assert eng.scheduler.stats["prefix_tokens_skipped"] > 0
        if case.startswith("staggered"):
            assert eng.scheduler.stats["preemptions"] > 0
            assert eng.scheduler.stats["admitted"] > 3
        if case.startswith("chunked"):
            assert len(eng.scheduler.prefill_log) > len(reqs)
        if case == "spec":
            acc = eng.metrics.summary()["spec_accepted_per_tick_slot"]
            assert acc["n"] > 0


def test_spec_stream_equals_plain_decode(models):
    """Speculative verify-k emits the non-speculative engine's tokens."""
    cfg, tparams = models["llama2-7b"]
    reqs = [Request(rid=r, prompt=np.asarray(p, np.int32), max_new=mn,
                    arrival=a)
            for r, p, mn, a in _requests("spec", cfg.vocab_size)]
    plain = ContinuousEngine(cfg, tparams, _scfg(dict(max_slots=2)),
                             device="cpu").run(reqs)
    spec = ContinuousEngine(cfg, tparams, _scfg(
        dict(max_slots=2, spec_k=3, draft_layers=2)), device="cpu").run(reqs)
    assert {r: v.tolist() for r, v in plain.items()} == \
        {r: v.tolist() for r, v in spec.items()}


def test_continuous_config_errors(models):
    cfg, tparams = models["llama2-7b"]
    # a serving mesh is accepted; its ranks must exist (one process each)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ContinuousEngine(cfg, tparams, ServeConfig(mesh="tp=2"),
                         device="cpu")
    with pytest.raises(ValueError, match="draft_layers"):
        ContinuousEngine(cfg, tparams, ServeConfig(draft_layers=1),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="greedy"):
        ContinuousEngine(cfg, tparams, ServeConfig(spec_k=4,
                                                   temperature=1.0),
                         device="cpu")
    import dataclasses
    with pytest.raises(NotImplementedError, match="'vlm' stays on the "
                       "lockstep Engine"):
        ContinuousEngine(dataclasses.replace(cfg, family="vlm"), tparams,
                         ServeConfig(), device="cpu")


RECURRENT = ("zamba2-1.2b", "xlstm-125m")


@pytest.fixture(scope="module")
def recurrent():
    """The recurrent families' smoke configs with the port's own init."""
    from repro_torch.models import registry
    return {arch: (get_config(arch).smoke(), registry.init_params(
        get_config(arch).smoke(), seed=0, device="cpu"))
        for arch in RECURRENT}


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_families_stay_lockstep(recurrent, arch):
    """The reference's serving contract for the hybrid and ssm families:
    ContinuousEngine refuses them ("lockstep"), as do the continuous-
    batching entries of the registry and a masked decode step; the hybrid
    family's shared-attention caches still build paged (the reference's
    tests/test_scheduler.py check)."""
    from repro_torch.core import fqt
    from repro_torch.models import registry
    from repro_torch.models.layers import PagedKVCache
    cfg, params = recurrent[arch]
    with pytest.raises(NotImplementedError, match="lockstep"):
        ContinuousEngine(cfg, params, _scfg({}), device="cpu")
    carry = registry.make_decode_state(cfg, 2, 64, kv_cache_format="nvfp4",
                                       page_size=16, device="cpu")
    if cfg.family == "hybrid":
        assert len(carry[1]) == 2
        assert all(isinstance(c, PagedKVCache) for c in carry[1])
    tok = torch.ones((1, 4), dtype=torch.long)
    q = fqt.qaf_config()
    for call in (
            lambda: registry.prefill_slot(params, cfg, q, tok, carry, 0, 4),
            lambda: registry.prefill_suffix(params, cfg, q, tok, carry, 0, 4,
                                            2),
            lambda: registry.prefill_chunk(params, cfg, q, tok, carry, 0, 0),
            lambda: registry.verify_k(params, cfg, q, tok, carry),
            lambda: registry.decode_step(
                params, cfg, q, tok[:, :1], carry,
                write_mask=torch.ones((1,), dtype=torch.bool))):
        with pytest.raises(NotImplementedError, match=cfg.family):
            call()


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_state_resets_in_place(recurrent, arch):
    """``reset_decode_state`` puts the recurrent states (and zamba2's KV
    caches) back to their initial values at the same addresses: a prefill
    moves every state tensor, the reset restores ``make_decode_state``'s
    values bit for bit, and no tensor is reallocated."""
    from repro_torch.core import fqt
    from repro_torch.models import registry
    cfg, params = recurrent[arch]
    carry = registry.make_decode_state(cfg, 2, 16, kv_cache_format="nvfp4",
                                       device="cpu")
    fresh = registry.make_decode_state(cfg, 2, 16, kv_cache_format="nvfp4",
                                       device="cpu")
    states = carry[0] if cfg.family == "hybrid" else carry
    tensors = (list(states.values()) if cfg.family == "hybrid"
               else [t for st in states for t in st])
    want = (list(fresh[0].values()) if cfg.family == "hybrid"
            else [t for st in fresh for t in st])
    ptrs = [t.data_ptr() for t in tensors]
    with torch.no_grad():
        registry.prefill(params, cfg, fqt.qaf_config(),
                         torch.ones((2, 3), dtype=torch.long), carry)
    assert all(not torch.equal(t, w) for t, w in zip(tensors, want))
    registry.reset_decode_state(carry)
    assert [t.data_ptr() for t in tensors] == ptrs
    assert all(torch.equal(t, w) for t, w in zip(tensors, want))
    if cfg.family == "hybrid":
        assert all(int(c.length) == 0 for c in carry[1])


def test_temperature_stream_is_per_request(models):
    """A request's sampled tokens do not depend on its slot or on the other
    requests in the batch (streams keyed by (seed, rid, step))."""
    cfg, tparams = models["llama2-7b"]
    prompts = [np.arange(5, 13, dtype=np.int32) * (i + 1) for i in range(3)]
    scfg = _scfg(dict(max_slots=3, temperature=0.8, seed=3))
    both = ContinuousEngine(cfg, tparams, scfg, device="cpu").run(
        [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)])
    alone = ContinuousEngine(cfg, tparams, scfg, device="cpu").run(
        [Request(rid=2, prompt=prompts[2], max_new=6)])
    assert both[2].tolist() == alone[2].tolist()


@pytest.mark.parametrize("fields", [dict(prefix_cache=True,
                                         prefill_chunk=8),
                                    dict(spec_k=3, draft_layers=1)],
                         ids=["prefix chunked", "spec"])
def test_one_device_read_per_tick(models, monkeypatch, fields):
    """The serving loop reads the device back at most once per tick
    (``_fetch``) and nowhere else: a tensor read anywhere else in a run
    (``cpu``, ``numpy``, ``item``, ``tolist``, ``bool``/``int``/``float``
    of a tensor) raises here."""
    from repro_torch.serve import engine as engine_mod
    cfg, tparams = models["llama2-7b"]
    eng = ContinuousEngine(cfg, tparams, _scfg(dict(max_slots=2, **fields)),
                           device="cpu")
    reqs = [Request(rid=r, prompt=np.asarray(p, np.int32), max_new=mn,
                    arrival=a)
            for r, p, mn, a in _requests("prefix", cfg.vocab_size)]
    fetches = []
    real_fetch = engine_mod._fetch

    def fetch(*ts):
        fetches.append(len(ts))
        with monkeypatch.context() as m:
            for name, fn in real.items():
                m.setattr(torch.Tensor, name, fn)
            return real_fetch(*ts)

    def forbidden(name):
        def f(self, *a, **k):
            raise AssertionError(f"device read through Tensor.{name}")
        return f

    real = {"cpu": torch.Tensor.cpu, "numpy": torch.Tensor.numpy}
    monkeypatch.setattr(engine_mod, "_fetch", fetch)
    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    res = eng.run(reqs)
    monkeypatch.undo()
    assert sorted(res) == [r.rid for r in reqs]
    assert 0 < len(fetches) <= eng.metrics.summary()["ticks"]


def test_launch_serve_queue_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve as launch
    res = launch.main(["--arch", "llama2-60m", "--smoke", "--queue", "4",
                       "--max-slots", "2", "--prompt-len", "6",
                       "--max-new", "5", "--max-len", "64",
                       "--prefix-cache", "--shared-prefix", "16",
                       "--spec-decode", "--spec-k", "3", "--trace",
                       str(tmp_path / "trace.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(res) == [0, 1, 2, 3] and all(len(v) == 5
                                               for v in res.values())
    for line in ("tok/s", "paging:", "TTFT", "prefix cache: hit rate",
                 "speculative (k=3", "trace:"):
        assert line in out, line


if __name__ == "__main__":
    write_jax_reference(sys.argv[1])
