"""The port's serving programs (``repro_torch.serve.graphs``), on the CPU.

On the card each serving program replays as one CUDA graph per static
signature; here the same ``Program`` runs its body eagerly and counts the
signatures, which are the reference's compile counts.  Held here:

  * the five ``*_compiles`` of ``ContinuousEngine`` and the tracer's
    ``jit_compile`` instants and ``jit_compiles`` counter equal the JAX
    engine's, event for event, in the scenarios of tests/test_obs.py
    (speculative + chunked + prefix cache, and a second run on the same
    engine), tests/test_spec.py and tests/test_traffic.py (chunked, and a
    chunk that covers every prompt).  The JAX engine runs in a subprocess
    with ``XLA_FLAGS=--xla_allow_excess_precision=false``, as in
    tests/test_torch_continuous.py (``python tests/test_torch_graphs.py
    OUT.npz`` writes its record);
  * two runs on one engine equal two runs on fresh engines, token and
    margin for margin, for both engines: the carry is allocated once and
    reset in place to ``make_decode_state``'s state;
  * a program rejects a Python int for a dynamic operand (slot, plen, pfx,
    off) with ``TypeError``, while the model and cache functions take ints
    or int32 tensors with the same results;
  * the launch-count accounting of a capture and its replays, and the
    dispatch (eager first call, capture on the second, replays after), as
    pure functions with a stand-in for the CUDA graph.
"""
import dataclasses
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
from repro_torch.models import registry
from repro_torch.models.layers import PagedKVCache
from repro_torch.obs.trace import Tracer
from repro_torch.serve import (ContinuousEngine, Engine, Request,
                               ServeConfig, graphs)

torch.set_num_threads(1)

NO_EOS = -1
PROGRAMS = ("prefill", "prefill_suffix", "prefill_chunk", "decode",
            "verify")
COMPILES = ("prefill_compiles", "prefill_suffix_compiles", "chunk_compiles",
            "decode_compiles", "verify_compiles")


def _lens_requests(vocab, lens, max_new, request_cls):
    """The reference tests' traces: seed 7, one request per prompt length,
    all arriving at tick 0."""
    rng = np.random.default_rng(7)
    return [request_cls(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new=max_new) for i, n in enumerate(lens)]


# scenario -> (ServeConfig fields, prompt lengths, max_new, runs on the
# engine); llama2-60m smoke, batch 2, max_len 96, page 16, nvfp4 pages
SCENARIOS = {
    # tests/test_obs.py:257-287: spec + chunked + prefix cache, traced
    "obs": (dict(spec_k=3, draft_layers=1, prefill_chunk=5,
                 prefix_cache=True), (33, 12, 37), 10, 2),
    # tests/test_spec.py:170-182
    "spec": (dict(spec_k=3, draft_layers=1), (33, 12, 37), 12, 1),
    # tests/test_traffic.py:108-127 (decode_chunk 4)
    "chunked": (dict(prefill_chunk=5, decode_chunk=4), (37, 12, 33), 8, 1),
    # tests/test_traffic.py:138-149
    "whole chunk": (dict(prefill_chunk=48, decode_chunk=4), (37, 12, 33), 8,
                    1),
}


def _scfg(fields, config_cls=ServeConfig):
    return config_cls(**{**dict(batch_size=2, max_len=96, eos_id=NO_EOS,
                                kv_cache_format="nvfp4", page_size=16),
                         **fields})


def _jit_events(trc):
    """The tracer's compile record: (phase, tick, program or total,
    cache size) of every jit_compile instant and jit_compiles counter."""
    out = []
    for e in trc.trace_events():
        if e["name"] == "jit_compile":
            out.append((0, e["ts"], PROGRAMS.index(e["args"]["program"]),
                        e["args"]["cache_size"]))
        elif e["name"] == "jit_compiles" and e["ph"] == "C":
            out.append((1, e["ts"], e["args"]["jit_compiles"], 0))
    return np.asarray(out, np.int64).reshape(-1, 4)


def _run_scenario(eng_cls, req_cls, tracer_cls, cfg, params, name, **kw):
    """{key: array} of one scenario: per run, the compile counts, the
    jit_compiles total and the compile events."""
    fields, lens, max_new, runs = SCENARIOS[name]
    eng = eng_cls(cfg, params, _scfg(fields, kw.pop("config_cls",
                                                     ServeConfig)), **kw)
    out = {}
    for run in range(runs):
        trc = tracer_cls(clock="tick")
        eng.tracer = trc
        eng.run(_lens_requests(cfg.vocab_size, lens, max_new, req_cls))
        out[f"{name}/{run}/compiles"] = np.asarray(
            [getattr(eng, c) for c in COMPILES], np.int64)
        out[f"{name}/{run}/jit_compiles"] = np.asarray(
            trc.counters.get("jit_compiles"), np.int64)
        out[f"{name}/{run}/events"] = _jit_events(trc)
    return out


def _jax_params():
    cfg = jax_get_config("llama2-60m").smoke()
    return cfg, jreg.init_params(cfg, jax.random.PRNGKey(0))


def write_jax_reference(out_path):
    from repro import serve as jserve
    from repro.obs.trace import Tracer as JTracer
    cfg, params = _jax_params()
    ref = {}
    for name in SCENARIOS:
        ref.update(_run_scenario(jserve.ContinuousEngine, jserve.Request,
                                 JTracer, cfg, params, name,
                                 config_cls=jserve.ServeConfig))
    np.savez(out_path, **ref)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_graphs") / "ref.npz"
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
def model():
    _, jparams = _jax_params()
    cfg = get_config("llama2-60m").smoke()
    return cfg, params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_compiles_and_trace_events_match_jax_engine(model, jax_ref, name):
    cfg, params = model
    got = _run_scenario(ContinuousEngine, Request, Tracer, cfg, params, name,
                        device="cpu")
    assert sorted(got) == sorted(k for k in jax_ref
                                 if k.startswith(f"{name}/"))
    for key, want in got.items():
        np.testing.assert_array_equal(got[key], jax_ref[key], err_msg=key)
    runs = SCENARIOS[name][3]
    # the reference tests' own numbers, on the port's side
    first = dict(zip(COMPILES, got[f"{name}/0/compiles"]))
    if name == "obs":
        assert first == dict(prefill_compiles=0, prefill_suffix_compiles=1,
                             chunk_compiles=1, decode_compiles=0,
                             verify_compiles=1)
        assert got[f"{name}/0/jit_compiles"] == 3
        # a second run on the engine (warm prefix cache) compiles nothing
        assert runs == 2 and len(got[f"{name}/1/events"]) == 0
    elif name == "spec":
        assert (first["verify_compiles"], first["decode_compiles"],
                first["prefill_compiles"]) == (1, 0, 1)
    elif name == "chunked":
        assert (first["prefill_compiles"], first["prefill_suffix_compiles"],
                first["chunk_compiles"], first["decode_compiles"]) == \
            (0, 1, 1, 1)
    else:
        assert (first["chunk_compiles"],
                first["prefill_suffix_compiles"]) == (0, 1)


def test_tracerless_engine_counts_compiles_too(model):
    """The compile counts need no tracer (the reference's cache sizes are
    always there), and a second trace with another prefill width is a new
    signature of the cold prefill program, as jit retraces it."""
    cfg, params = model
    eng = ContinuousEngine(cfg, params, _scfg({}), device="cpu")
    eng.run(_lens_requests(cfg.vocab_size, (12, 20), 4, Request))
    assert (eng.prefill_compiles, eng.decode_compiles) == (1, 1)
    eng.run(_lens_requests(cfg.vocab_size, (25, 9), 4, Request))  # pad 32
    assert (eng.prefill_compiles, eng.decode_compiles) == (1, 1)
    eng.run(_lens_requests(cfg.vocab_size, (40,), 4, Request))    # pad 48
    assert (eng.prefill_compiles, eng.decode_compiles) == (2, 1)


# ---- the persistent carry: two runs on one engine == two fresh engines -------


def _continuous_runs(cfg, params, fields, traces, fresh):
    out = []
    eng = None
    for lens in traces:
        if fresh or eng is None:
            eng = ContinuousEngine(cfg, params, _scfg(fields), device="cpu")
        res = eng.run(_lens_requests(cfg.vocab_size, lens, 6, Request))
        out.append({r: (v.tolist(), eng.margins[r].tolist())
                    for r, v in res.items()})
    return out


@pytest.mark.parametrize("fields", [dict(max_slots=2),
                                    dict(prefill_chunk=8, decode_chunk=4),
                                    dict(spec_k=3, draft_layers=1)],
                         ids=["plain", "chunked", "spec"])
def test_continuous_two_runs_equal_fresh_engines(model, fields):
    cfg, params = model
    traces = [(21, 7, 30), (9, 26)]
    assert _continuous_runs(cfg, params, fields, traces, fresh=False) == \
        _continuous_runs(cfg, params, fields, traces, fresh=True)


@pytest.mark.parametrize("fmt", ["nvfp4", "bf16"])
def test_lockstep_two_runs_equal_fresh_engines(model, fmt):
    cfg, params = model
    scfg = ServeConfig(batch_size=2, max_len=48, eos_id=NO_EOS,
                       kv_cache_format=fmt, decode_chunk=3)
    rng = np.random.default_rng(3)
    batches = [[rng.integers(0, cfg.vocab_size, n) for n in (9, 6)],
               [rng.integers(0, cfg.vocab_size, n) for n in (9, 4)]]

    def runs(fresh):
        out, eng = [], None
        for prompts in batches:
            if fresh or eng is None:
                eng = Engine(cfg, params, scfg, device="cpu")
            toks = eng.generate(prompts, max_new=7)
            out.append(([t.tolist() for t in toks],
                        [m.tolist() for m in eng.margins]))
        return out, eng

    kept, eng = runs(False)
    assert kept == runs(True)[0]
    # the same prompt width twice: one signature per program
    assert [p.cache_size for p in eng.programs.values()] == [1, 1]


def _bits(t):
    """A float tensor's bytes (so -0.0, NaN payloads and float8 compare
    exactly); integer tensors as they are."""
    return t.view(torch.uint8) if t.dtype.is_floating_point else t


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8", "bf16"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "lockstep"])
def test_reset_decode_state_equals_a_fresh_state(model, fmt, paged):
    cfg, _ = model
    kw = dict(kv_cache_format=fmt, device="cpu")
    if paged:
        kw["page_size"] = 16
    carry = registry.make_decode_state(cfg, 2, 32, **kw)
    g = torch.Generator().manual_seed(0)
    for c in carry:                       # scribble over every tensor
        for f in dataclasses.fields(c):
            t = getattr(c, f.name)
            if isinstance(t, torch.Tensor):
                bits = _bits(t)
                bits.copy_(torch.randint(0, 7, bits.shape, generator=g))
    registry.reset_decode_state(carry)
    fresh = registry.make_decode_state(cfg, 2, 32, **kw)
    for c, f in zip(carry, fresh):
        for fld in dataclasses.fields(c):
            a, b = getattr(c, fld.name), getattr(f, fld.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(_bits(a), _bits(b)), fld.name


# ---- dynamic operands --------------------------------------------------------


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _engine(model, **fields):
    cfg, params = model
    eng = ContinuousEngine(cfg, params, _scfg(fields), device="cpu")
    eng.run(_lens_requests(cfg.vocab_size, (5,), 2, Request))   # a carry
    return eng


@pytest.mark.parametrize("call", ["prefill", "prefill_suffix",
                                  "prefill_chunk"])
def test_programs_reject_host_ints(model, call):
    eng = _engine(model)
    toks = torch.zeros((1, 16), dtype=torch.int64)
    one = _i32(1)
    bad = {"prefill": [(toks, 5, one, 0), (toks, one, 1, 0)],
           "prefill_suffix": [(toks, one, 0, one, 0), (toks, 5, one, one, 0),
                              (toks, one, one, 1, 0)],
           "prefill_chunk": [(toks, 1, one), (toks, one, 0)]}[call]
    seen = eng.programs[call].cache_size
    for args in bad:
        with pytest.raises(TypeError, match="int32 scalar for slot"):
            getattr(eng, f"_{call}")(*args)
    assert eng.programs[call].cache_size == seen


def _carry_bits(carry):
    return [_bits(getattr(c, f.name)).clone()
            for c in carry for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fmt", ["nvfp4", "fp8", "bf16"])
def test_model_functions_take_ints_or_tensors(model, fmt):
    """prefill_slot, prefill_chunk and prefill_suffix (and the cache writes
    under them) give the same logits and cache bits from host ints as from
    int32 device scalars."""
    cfg, _ = model
    eng = _engine(model, kv_cache_format=fmt)
    p, q = eng.params, eng.qcfg
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)))
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8)))
    row = torch.tensor([3, 4, 5, 6, 0, 0], dtype=torch.int32)

    def drive(conv):
        carry = registry.make_decode_state(
            cfg, 2, 96, kv_cache_format=fmt, page_size=16, device="cpu")
        carry[0].page_table[1] = row
        lg1, _ = registry.prefill_slot(p, cfg, q, toks, carry, conv(1),
                                       conv(13))
        lg2, _ = registry.prefill_slot(p, cfg, q, toks, carry, conv(0),
                                       conv(16))
        registry.prefill_chunk(p, cfg, q, chunk, carry, conv(1), conv(13))
        lg3, _ = registry.prefill_suffix(p, cfg, q, toks, carry, conv(1),
                                         conv(30), conv(21))
        return [lg1, lg2, lg3] + _carry_bits(carry)

    _assert_same(drive(int), drive(_i32))


def test_cache_writes_take_ints_or_tensors():
    g = torch.Generator().manual_seed(1)
    k = torch.randn((1, 8, 2, 32), generator=g)
    v = torch.randn((1, 8, 2, 32), generator=g)

    def drive(conv):
        c = PagedKVCache.init(3, 32, 2, 32, fmt="nvfp4", page_size=8)
        c.page_table[2] = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
        c.write_prompt(conv(2), k, v, conv(6))
        c.write_prompt_at(conv(2), k, v, conv(12), conv(19))
        return _carry_bits([c])

    _assert_same(drive(int), drive(_i32))


# ---- the program wrapper: signatures, dispatch, launch accounting --------------


def test_signature_is_shapes_never_values():
    a = graphs.signature("p", (_i32(3), None, torch.zeros((2, 4))))
    assert a == graphs.signature("p", (_i32(9), None, torch.ones((2, 4))))
    assert a != graphs.signature("p", (_i32(3), torch.zeros(2),
                                       torch.zeros((2, 4))))
    assert a != graphs.signature("p", (_i32(3), None, torch.zeros((2, 5))))
    assert a != graphs.signature("p", (torch.tensor(3), None,
                                       torch.zeros((2, 4))))
    with pytest.raises(TypeError, match="operand 1 is a int"):
        graphs.signature("p", (_i32(3), 4))


def test_counted_restores_counts_and_returns_the_delta():
    counters.reset()
    counters.bump("flash_attention")

    def capture():
        for name in ("packed_block_matmul", "packed_block_matmul",
                     "flash_attention_paged"):
            counters.bump(name)
        return "out"

    out, delta = graphs.counted(capture)
    assert out == "out"
    assert delta == {"packed_block_matmul": 2, "flash_attention_paged": 1}
    assert counters.snapshot() == dict(
        {k: 0 for k in counters.COUNTS}, flash_attention=1)
    for _ in range(3):                    # three replays
        counters.add(delta)
    assert counters.snapshot() == dict(
        {k: 0 for k in counters.COUNTS}, flash_attention=1,
        packed_block_matmul=6, flash_attention_paged=3)

    def failing():
        counters.bump("packed_block_matmul")
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.counted(failing)
    assert counters.snapshot()["packed_block_matmul"] == 6
    counters.reset()


class _FakeGraph:
    """Stands in for a CUDA graph: a replay reruns the recorded body on the
    static buffers and writes the static outputs, and like a graph's
    kernels it bumps no launch count in Python."""

    def __init__(self, body, inputs, outputs):
        self.body, self.inputs, self.outputs = body, inputs, outputs

    def replay(self):
        out, _ = graphs.counted(lambda: self.body(*self.inputs))
        self.outputs.copy_(out)


def test_program_dispatch_eager_then_capture_then_replay(monkeypatch):
    calls = []

    def body(x, slot):
        calls.append("body")
        counters.bump("packed_block_matmul")
        return x * 2 + slot

    prog = graphs.Program("decode", body, graphs=True)

    def capture(self, args):
        calls.append("capture")
        inputs = [a.clone() for a in args]
        outputs, delta = graphs.counted(lambda: body(*inputs))
        return graphs._Graph(_FakeGraph(body, inputs, outputs), inputs,
                             outputs, delta)

    monkeypatch.setattr(graphs.Program, "_capture", capture)
    counters.reset()
    x = torch.arange(4)
    assert prog(x, _i32(1)).tolist() == [1, 3, 5, 7]        # eager warm-up
    assert calls == ["body"] and prog.cache_size == 1
    assert prog(x + 1, _i32(2)).tolist() == [4, 6, 8, 10]   # capture+replay
    assert calls == ["body", "capture", "body", "body"]
    out = prog(x, _i32(0))                                  # replay
    assert out.tolist() == [0, 2, 4, 6] and len(calls) == 5
    assert prog(x, _i32(5)) is out          # outputs are the static buffers
    assert prog.cache_size == 1
    # one count per call that ran the body: the warm-up and three replays
    assert counters.snapshot()["packed_block_matmul"] == 4
    prog(torch.arange(3), _i32(0))              # a new shape: a new compile
    assert prog.cache_size == 2
    counters.reset()


@pytest.mark.parametrize("engine", [Engine, ContinuousEngine])
def test_an_engine_is_freed_without_a_gc_pass(model, engine):
    """The programs hold the engine's methods weakly: dropping the last
    reference frees the engine (and on the card its weights and graph
    pools) at once, not at the next cyclic collection."""
    import gc
    import weakref
    cfg, params = model
    gc.disable()
    try:
        eng = engine(cfg, params, _scfg({}), device="cpu")
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_eager_program_never_captures():
    prog = graphs.Program("prefill", lambda x: x + 1, graphs=False)
    for _ in range(3):
        assert prog(torch.zeros(2)).tolist() == [1.0, 1.0]
    assert prog.cache_size == 1 and prog.captures == 0


if __name__ == "__main__":
    write_jax_reference(sys.argv[1])
