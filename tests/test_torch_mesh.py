"""The port's serving mesh against the reference's, on the CPU.

  * Spec derivation (``distributed/specs.py``, the port's copy): the cases
    of tests/test_mesh_serving.py:43-128, equal to the reference's.
  * The rule table (``distributed/sharding.py``): ``params_specs``,
    ``spec_for_packed`` and ``serve_cache_shardings`` equal the
    reference's leaf for leaf, on stand-in meshes that need no devices (as
    tests/test_distributed.py's ``_FakeMesh``), for the llama2-60m smoke
    tree and llama2-7b's full shapes (shape structs: ``jax.eval_shape`` on
    the reference's side, ``meta`` tensors on the port's) at tp 2, 4 and 8
    and at dp=2,tp=4.  The reference stacks the layers: its spec of a
    layer leaf is the port's with a leading None.
  * Placement: each rank's ``place_serve_params`` shard, of the packed
    tree and of the bf16 tree carried over by ``params_from_jax_numpy``,
    is the numpy slice of the reference's leaf that the reference's spec
    names for that device, bit for bit.
  * Serving on gloo CPU ranks (tests/_dist.py), the reference's TP setup
    (test_mesh_serving.py:202-226: llama2-60m smoke, nvfp4 KV, 16-token
    pages, 2 prompts x 8 new tokens): ``ContinuousEngine`` (its mesh from
    ``ServeConfig.mesh``) and the lockstep ``Engine`` (given the mesh) at
    tp=2, tp=4, dp=2,tp=2 and fsdp=2 give every rank the same streams,
    equal token for token to the port's 1-rank engines and to the
    reference's 1-device engines, with one signature per program
    (``prefill_compiles == decode_compiles == 1``); the caches hold the
    rank's KV heads; the launcher's ``--mesh``.
  * The families beyond dense pass the gate: hybrid, ssm and encdec build
    an engine at tp=2 and a decode carry of this rank's heads (their
    streams are tests/test_torch_mesh_encdec_recurrent.py's, the moe and
    vlm families' tests/test_torch_mesh_families.py's).
  * The refusals: ``cuda_graphs`` on a multi-rank
    mesh on the card (from static facts, before any collective), too few
    ranks, heads that do not split, a leaf whose planned split does not
    divide.

The reference's engines run in a subprocess (``_jax_ref.Reference``) while
the ranks run.
"""
import logging
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _dist import run_ranks, serve_engines
from _jax_ref import Reference, jax_engine_stream, run_jobs
from repro.configs import get_config as jax_get_config
from repro.core.quantize import NVFP4 as JNVFP4
from repro.core.quantize import PackedQuantizedTensor as JPacked
from repro.distributed import sharding as jshd
from repro.distributed import specs as jspecs
from repro.models import registry as jreg
from repro.serve import packing as jpack
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core.quantize import NVFP4, PackedQuantizedTensor
from repro_torch.distributed import sharding, specs
from repro_torch.distributed.mesh import Mesh, MeshShape, make_serve_mesh
from repro_torch.kernels import counters
from repro_torch.models import registry
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig, packing

torch.set_num_threads(1)

ARCH = "llama2-60m"
MAX_NEW = 8
FIELDS = dict(batch_size=2, max_len=64, kv_cache_format="nvfp4",
              page_size=16, eos_id=-1)
SPEC_MESHES = ("tp=2", "tp=4", "tp=8", "dp=2,tp=4")
RANKS = {"tp=2": 2, "tp=4": 4, "dp=2,tp=2": 4, "fsdp=2": 2}
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 8) for _ in range(2)]


def _ref_continuous(ref):
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import ServeConfig as JServeConfig
    cfg = jax_get_config(ARCH).smoke()
    params = jreg.init_params(cfg, jax.random.PRNGKey(0))
    eng = JCont(cfg, params, JServeConfig(**FIELDS))
    for i, s in enumerate(eng.generate(_prompts(cfg.vocab_size),
                                       max_new=MAX_NEW)):
        ref[f"cont/{i}"] = np.asarray(s, np.int32)


def _ref_lockstep(ref):
    cfg = jax_get_config(ARCH).smoke()
    params = jreg.init_params(cfg, jax.random.PRNGKey(0))
    ref["lock"], _ = jax_engine_stream(cfg, params, "nvfp4", "nvfp4",
                                       _prompts(cfg.vocab_size), MAX_NEW,
                                       FIELDS["max_len"])


def write_jax_reference(out_path, part, parts):
    run_jobs([_ref_continuous, _ref_lockstep], out_path, part, parts)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Started with the module's first test; the tests that need no
    reference, and the ranks of those that do, run meanwhile."""
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_mesh"), 2)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _shape_of(spec: str) -> MeshShape:
    sizes = specs.parse_mesh_spec(spec)
    axes = tuple(a for a in ("data", "model") if a in sizes)
    return MeshShape(tuple(sizes[a] for a in axes), axes)


def _jax_mesh(m: MeshShape):
    """The reference's stand-in mesh: axis names and a device grid's shape
    (tests/test_distributed.py's ``_FakeMesh``)."""
    return types.SimpleNamespace(axis_names=m.axis_names,
                                 devices=types.SimpleNamespace(
                                     shape=m.shape, size=m.size))


# ---- spec derivation ----------------------------------------------------------


SPEC_CASES = [
    ("parse", None), ("parse", ""), ("parse", "tp=2"), ("parse", "dp=2,tp=4"),
    ("parse", "fsdp=2"),
    ("strip", (None, None)), ("strip", ("model", None)),
    ("divisible", (("model", None), (8, 8), {"model": 1})),
    ("divisible", (("model", None), (15, 8), {"model": 2})),
    ("divisible", (("data", "model"), (64, 30), {"data": 2, "model": 4})),
    ("divisible", ((("data", "model"), None), (16, 8),
                   {"data": 2, "model": 4})),
    ("packed", ((None, "model"), (64, 32), -2, 16, {"model": 1})),
    ("packed", ((None, "model"), (64, 32), -2, 16, {"model": 2})),
    ("packed", ((None, "model"), (64, 32), -2, 16, {"model": 4})),
    ("packed", ((None, "model"), (64, 30), -2, 16, {"model": 2})),
    ("packed", (("data", "model"), (4096, 11008), -2, 16,
                {"data": 2, "model": 4})),
    ("packed", (("model", "data"), (11008, 4096), -2, 16,
                {"data": 2, "model": 8})),
    ("packed", ((None, "data", "model"), (4, 64, 32), -2, 16,
                {"data": 2, "model": 2})),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_derivation_equals_reference(case):
    kind, arg = SPEC_CASES[case]
    for mod in (specs, jspecs):
        if kind == "parse":
            got = mod.parse_mesh_spec(arg)
        elif kind == "strip":
            got = mod.strip_trailing_none(arg)
        elif kind == "divisible":
            drops = []
            got = (mod.divisible_axes(*arg, path="mlp/w_up", drops=drops),
                   drops)
        else:
            drops = []
            got = (mod.packed_leaf_specs(*arg, path="layers/attn/wq",
                                         drops=drops), drops)
            out = got[0]
            assert mod.congruent(out["packed"], out["scales"])
        if mod is specs:
            want = got
    assert want == got


def test_spec_errors_and_wire_accounting():
    for bad in ("tp=0", "tp=-1", "ep=2", "tp", "tp=2;dp=2"):
        with pytest.raises(ValueError):
            specs.parse_mesh_spec(bad)
    assert specs.packed_wire_bits_per_param() == 4.5
    assert specs.packed_gather_ratio() == jspecs.packed_gather_ratio()
    assert not specs.congruent(("model",), (None, "model"))


def test_divisible_diagnoses_dropped_axes(caplog):
    """Named leaves log (or raise, strict=True) a diagnostic naming the
    leaf; anonymous calls stay silent."""
    m = _shape_of("tp=2")
    with caplog.at_level(logging.WARNING, "repro_torch.distributed.sharding"):
        assert sharding._divisible(("model",), (15,), m,
                                   path="mlp/w_up") == ()
    assert any("mlp/w_up" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="mlp/w_up"):
        sharding._divisible(("model",), (15,), m, path="mlp/w_up",
                            strict=True)
    n0 = len(caplog.records)
    with caplog.at_level(logging.WARNING, "repro_torch.distributed.sharding"):
        assert sharding._divisible(("model",), (15,), m) == ()
    assert len(caplog.records) == n0


# ---- the rule table, leaf for leaf --------------------------------------------


_TORCH_DT = {"uint8": torch.uint8, "float8_e4m3fn": torch.float8_e4m3fn,
             "bfloat16": torch.bfloat16}


def _meta(sds, stacked):
    shape = tuple(sds.shape[1:] if stacked else sds.shape)
    return torch.empty(shape, dtype=_TORCH_DT.get(str(sds.dtype),
                                                  torch.float32),
                       device="meta")


def _port_tree(jtree, n_layers):
    """The port's layout (a list of layer dicts) of a reference tree of
    shape structs, as meta tensors."""
    def conv(v, stacked):
        if isinstance(v, dict):
            return {k: conv(x, stacked) for k, x in v.items()}
        if isinstance(v, JPacked):
            return PackedQuantizedTensor(
                _meta(v.packed, stacked), _meta(v.scales, stacked),
                _meta(v.tscale, stacked), v.axis, v.block)
        return _meta(v, stacked)
    return {k: ([conv(v, True) for _ in range(n_layers)] if k == "layers"
                else conv(v, False)) for k, v in jtree.items()}


def _jax_specs(jtree, mesh):
    """{path: spec tuple (or dict of them)} of the reference."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, JPacked))
    for path, leaf in flat:
        p = jshd._path_str(path)
        if isinstance(leaf, JPacked):
            out[p] = {k: tuple(v) for k, v in
                      jshd.spec_for_packed(p, leaf, mesh).items()}
        else:
            out[p] = tuple(jshd._divisible(
                jshd.param_spec(p, leaf.ndim, mesh), leaf.shape, mesh,
                path=p))
    return out


def _flat_specs(tree, path=""):
    """(path, spec) pairs of a spec tree; a packed leaf's dict is one."""
    if isinstance(tree, dict) and set(tree) != {"packed", "scales",
                                                "tscale"}:
        for k, v in tree.items():
            yield from _flat_specs(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_specs(v, f"{path}/{i}")
    else:
        yield path, tree


def _port_specs(tree, mesh):
    return dict(_flat_specs(sharding.params_specs(tree, mesh)))


def _drop_layer(spec):
    if isinstance(spec, dict):
        return {k: _drop_layer(v) for k, v in spec.items()}
    return tuple(spec[1:])


@pytest.fixture(scope="module")
def trees():
    """{name: (cfg, reference bf16 struct, reference packed struct)}."""
    out = {}
    for arch, smoke in ((ARCH, True), ("llama2-7b", False)):
        cfg = jax_get_config(arch)
        cfg = cfg.smoke() if smoke else cfg
        st = jax.eval_shape(lambda: jreg.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
        pk = jax.eval_shape(lambda p: jpack.pack_model_params(cfg, p,
                                                              JNVFP4), st)
        out[arch] = (cfg, st, pk)
    return out


@pytest.mark.parametrize("arch", [ARCH, "llama2-7b"])
@pytest.mark.parametrize("spec", SPEC_MESHES)
def test_param_specs_equal_reference(trees, arch, spec):
    cfg, st, pk = trees[arch]
    m = _shape_of(spec)
    for jtree in (st, pk):
        want = _jax_specs(jtree, _jax_mesh(m))
        got = _port_specs(_port_tree(jtree, cfg.n_layers), m)
        assert len(got) == (len(want) - sum(p.startswith("layers/")
                                            for p in want)
                            + cfg.n_layers * sum(p.startswith("layers/")
                                                 for p in want))
        for p, w in want.items():
            if p.startswith("layers/"):
                for i in range(cfg.n_layers):
                    q = p.replace("layers/", f"layers/{i}/", 1)
                    assert got[q] == _drop_layer(w), (q, got[q], w)
            else:
                assert got[p] == w, (p, got[p], w)


@pytest.mark.parametrize("spec", SPEC_MESHES)
def test_serve_cache_shardings_equal_reference(spec, monkeypatch):
    """Paged pools: KV heads over "model" (the reference's spec with its
    stacked layer axis); page table, lengths and the lockstep caches
    replicated.  ``make_decode_state(mesh=)`` allocates those local heads,
    for the lockstep caches too (the declared layout divergence)."""
    m = _shape_of(spec)
    # the reference's specs without its devices: a NamedSharding stand-in
    monkeypatch.setattr(jshd, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))
    jcfg, cfg = jax_get_config("llama2-7b"), get_config("llama2-7b")
    for page in (16, None):
        st = jax.eval_shape(lambda: jreg.make_decode_state(
            jcfg, 2, 64, kv_cache_format="nvfp4", page_size=page))
        want = jshd.serve_cache_shardings(st, _jax_mesh(m))
        full = registry.make_decode_state(cfg, 2, 64, kv_cache_format="nvfp4",
                                          page_size=page, device="meta")
        got = sharding.serve_cache_shardings(full, m)
        fields = ("k_codes", "k_scales", "v_codes", "v_scales")
        for layer in got:
            if page:
                for f in fields:
                    assert getattr(layer, f) == _drop_layer(
                        tuple(getattr(want, f).spec)), f
                assert layer.page_table == tuple(want.page_table.spec) == ()
                assert layer.lengths == tuple(want.lengths.spec) == ()
            else:
                assert layer == ()
                assert all(tuple(s.spec) == () for s in
                           jax.tree_util.tree_leaves(want))
        rank = Mesh(m.shape, m.axis_names, device=torch.device("meta"))
        local = registry.make_decode_state(cfg, 2, 64,
                                           kv_cache_format="nvfp4",
                                           page_size=page, device="meta",
                                           mesh=rank)
        assert local[0].k_codes.shape[-2] == cfg.n_kv_heads // m.shape[-1]
        if page:
            placed = sharding.place_serve_cache(full, rank)
            assert placed[0].v_scales.shape == local[0].v_scales.shape


# ---- placement: this rank's shards ------------------------------------------


def _numpy_slice(a, spec, m: MeshShape, rank):
    """The block of ``a`` on device ``rank`` of the reference's row-major
    device grid under ``spec`` (tuples of axes: the first major)."""
    coords = dict(zip(m.axis_names, np.unravel_index(rank, m.shape)))
    sizes = dict(zip(m.axis_names, m.shape))
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([sizes[x] for x in axes]))
        idx = int(np.ravel_multi_index([coords[x] for x in axes],
                                       [sizes[x] for x in axes]))
        size = a.shape[d] // n
        a = np.take(a, range(idx * size, (idx + 1) * size), axis=d)
    return a


def _bits(a):
    a = a if isinstance(a, torch.Tensor) else np.asarray(a)
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.uint8) if a.element_size() == 1 else
             a.view(torch.int16) if a.element_size() == 2 else a).numpy()
    return a.view(np.uint8 if a.itemsize == 1 else
                  np.uint16 if a.itemsize == 2 else np.uint32)


@pytest.fixture(scope="module")
def models():
    """(cfg, reference params (numpy), reference packed (numpy), the port's
    params from ``params_from_jax_numpy``)."""
    jcfg = jax_get_config(ARCH).smoke()
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    jpk = jax.jit(lambda p: jpack.pack_model_params(jcfg, p, JNVFP4))(jp)
    cfg = get_config(ARCH).smoke()
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return (cfg, jcfg, np_params, jax.tree_util.tree_map(np.asarray, jpk),
            params_from_jax_numpy(np_params, cfg, device="cpu"))


@pytest.mark.parametrize("spec", ["tp=2", "tp=4", "dp=2,tp=2"])
def test_place_serve_params_is_the_reference_slice(models, spec):
    cfg, jcfg, jnp_params, jnp_packed, params = models
    m = _shape_of(spec)
    packed = packing.pack_model_params(cfg, params, NVFP4)
    for tree, jtree in ((params, jnp_params), (packed, jnp_packed)):
        want = _jax_specs(jtree, _jax_mesh(m))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jtree, is_leaf=lambda x: isinstance(x, JPacked))
        for r in range(m.size):
            local = sharding.place_serve_params(
                tree, Mesh(m.shape, m.axis_names,
                           device=torch.device("cpu"), rank=r))
            for path, leaf in flat:
                p = jshd._path_str(path)
                layers = range(cfg.n_layers) if p.startswith("layers/") \
                    else [None]
                for i in layers:
                    keys = p.split("/")
                    got = local[keys[0]] if i is None else \
                        local["layers"][i]
                    for k in keys[1:]:
                        got = got[k]
                    sp = want[p] if i is None else _drop_layer(want[p])
                    if isinstance(leaf, JPacked):
                        for f in ("packed", "scales", "tscale"):
                            a = getattr(leaf, f)
                            a = a if i is None else a[i]
                            np.testing.assert_array_equal(
                                _bits(getattr(got, f)),
                                _bits(_numpy_slice(a, sp[f], m, r)),
                                err_msg=f"{p}/{f} rank {r}")
                    else:
                        a = leaf if i is None else leaf[i]
                        np.testing.assert_array_equal(
                            _bits(got), _bits(_numpy_slice(a, sp, m, r)),
                            err_msg=f"{p} rank {r}")


# ---- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m",
                                  "whisper-base"])
def test_unported_families_refuse_a_mesh(arch):
    """Once refused, the hybrid, ssm and encdec families now pass the gate
    at tp=2: an ``Engine`` builds on rank 0's shards (packing and slicing
    need no collective) and the decode carry holds this rank's heads --
    2 of the smoke config's 4 KV heads, zamba2's SSM heads, xLSTM's mLSTM
    heads -- with the conv, sLSTM and encoder states whole."""
    cfg = get_config(arch).smoke()
    mesh = Mesh((2,), ("model",), device=torch.device("cpu"), rank=0)
    registry.check_mesh(cfg, mesh)
    eng = Engine(cfg, registry.init_params(cfg, device="cpu"),
                 ServeConfig(**FIELDS), device="cpu", mesh=mesh)
    assert eng.params["embed"].shape == (cfg.padded_vocab // 2,
                                         cfg.d_model)
    carry = registry.make_decode_state(cfg, 2, 64, kv_cache_format="nvfp4",
                                       device="cpu", mesh=mesh)
    if arch == "whisper-base":
        assert carry[0].shape == (2, cfg.enc_seq, cfg.d_model)
        assert {c.k_codes.shape[-2] for c in carry[1]} == {2}
    elif arch == "zamba2-1.2b":
        assert carry[0]["ssm"].shape[2] == cfg.n_ssm_heads // 2
        assert {c.k_codes.shape[-2] for c in carry[1]} == {2}
    else:
        assert {st[0].shape[1] for st in carry if len(st) == 2} == {2}
        assert {st[0].shape for st in carry if len(st) == 4} == {
            (2, cfg.d_model)}
    registry.check_mesh(cfg, Mesh((1,), ("model",),
                                  device=torch.device("cpu")))


def test_mesh_shapes_and_describe():
    from repro_torch.distributed import mesh as dmesh
    prod = dmesh.make_production_mesh()
    assert (prod.shape, prod.axis_names) == ((16, 16), ("data", "model"))
    pods = dmesh.make_production_mesh(multi_pod=True)
    assert (pods.shape, pods.size) == ((2, 16, 16), 512)
    assert dmesh.make_host_mesh() == MeshShape((1, 1), ("data", "model"))
    assert dmesh.describe(prod) == "mesh{'data': 16, 'model': 16}"
    one = make_serve_mesh(None, device="cpu")
    assert (one.shape, one.axis_names, one.size) == ((1,), ("model",), 1)
    rank = Mesh((2, 4), ("data", "model"), device=torch.device("cpu"),
                rank=6)
    assert rank.coords == {"data": 1, "model": 2}
    assert (rank.axis_size("data"), rank.axis_index("model")) == (2, 2)
    assert (rank.axis_size("pod"), rank.axis_index("pod")) == (1, 0)


def test_mesh_refusals(models, monkeypatch):
    cfg, _, _, _, params = models
    from repro_torch.core import fqt
    # an unpacked weight on a mesh is trained through the sharded FQT
    # matmul (tests/test_torch_train_mesh.py); a shard that would split a
    # block between two ranks is refused before any collective
    with pytest.raises(ValueError, match="straddle"):
        fqt.dense(torch.ones(2, 128),
                  params["layers"][0]["attn"]["wq"][:, :24],
                  cfg=fqt.nvfp4_paper_config(), kind="io", mesh=Mesh(
                      (2,), ("model",), device=torch.device("cpu")))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_serve_mesh("tp=2", device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        Engine(cfg, params, ServeConfig(mesh="dp=2,tp=2", **FIELDS),
               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        make_serve_mesh(None)
    monkeypatch.undo()
    # cuda_graphs on a multi-rank mesh on the card: refused from the
    # static facts, before any collective or CUDA call
    from repro_torch.serve import engine as eng_mod
    monkeypatch.setattr(eng_mod, "resolve_device", torch.device)
    card = Mesh((2,), ("model",), device=torch.device("cuda"), rank=0)
    for cls in (Engine, ContinuousEngine):
        with pytest.raises(ValueError, match="cuda_graphs=False"):
            cls(cfg, params, ServeConfig(**FIELDS), mesh=card)
    monkeypatch.undo()
    tiny = get_config("tinyllama-1.1b").smoke()        # 1 KV head
    with pytest.raises(ValueError, match="do not split over tp=2"):
        registry.check_mesh(tiny, Mesh((2,), ("model",),
                                       device=torch.device("cpu")))
    rank = Mesh((2,), ("model",), device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mlp/w_up"):
        sharding.place_serve_params({"mlp": {"w_up": torch.zeros(128, 33)}},
                                    rank)
    from repro_torch.core.quantize import pack_quantize
    with pytest.raises(ValueError, match="attn/wq"):
        sharding.place_serve_params(
            {"attn": {"wq": pack_quantize(torch.ones(64, 30), NVFP4)}}, rank)
    assert sharding.place_serve_params(params, Mesh(
        (1,), ("model",), device=torch.device("cpu"))) is params


# ---- serving on gloo ranks ----------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(models):
    """The port's 1-rank engines (the default mesh, and "tp=1" spelt out)."""
    cfg, _, _, _, params = models
    prompts = _prompts(cfg.vocab_size)
    out = {}
    for mesh in (None, "tp=1"):
        scfg = ServeConfig(mesh=mesh, **FIELDS)
        cont = ContinuousEngine(cfg, params, scfg, device="cpu")
        lock = Engine(cfg, params, scfg, device="cpu")
        out[mesh] = (cont.generate(prompts, max_new=MAX_NEW),
                     lock.generate(prompts, max_new=MAX_NEW))
        assert cont.prefill_compiles == cont.decode_compiles == 1
    return out


@pytest.mark.parametrize("spec", list(RANKS))
def test_mesh_engines_stream_parity(models, one_rank, tmp_path, request,
                                    spec):
    cfg, _, jnp_params, _, _ = models
    prompts = _prompts(cfg.vocab_size)
    out = run_ranks(serve_engines, RANKS[spec], tmp_path, spec, jnp_params,
                    prompts, MAX_NEW, FIELDS)
    jax_ref = request.getfixturevalue("jax_ref")    # after the ranks ran
    cont1, lock1 = one_rank[None]
    tp = specs.parse_mesh_spec(spec)["model"]
    for o in out:
        for i in range(len(prompts)):
            np.testing.assert_array_equal(o["cont"][i], out[0]["cont"][i])
            np.testing.assert_array_equal(o["cont"][i], cont1[i])
            np.testing.assert_array_equal(o["cont"][i], jax_ref[f"cont/{i}"])
            np.testing.assert_array_equal(o["lock"][i], lock1[i])
            np.testing.assert_array_equal(o["lock"][i], jax_ref["lock"][i])
        assert o["compiles"] == (1, 1)
        assert o["lock_compiles"] == (1, 1)
        assert o["heads"] == (cfg.n_kv_heads // tp,) * 2
        assert o["collectives"]["calls"] > 0
        assert o["launches"] == {k: 0 for k in counters.COUNTS}
        assert o["wire"] < o["store"] <= packing.weight_store_bytes(
            packing.pack_model_params(cfg, models[4], NVFP4))


def test_launcher_mesh(models, one_rank, tmp_path):
    """``launch.serve --mesh tp=2`` spawns its ranks and rank 0 prints the
    serving-mesh line and the 1-rank streams."""
    env = dict(os.environ, PYTHONPATH=SRC)
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--max-new", "8", "--max-len", "64"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *args, "--mesh", "tp=2", "--report",
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "serving mesh: {'model': 2} over 2 of 2 ranks (gloo)" in r.stdout
    assert r.stdout.count("seq 0:") == 1
    from repro_torch.launch import serve
    want = serve.main(args)
    import json
    ranks = [json.loads((tmp_path / f"rank{i}.json").read_text())
             for i in range(2)]
    for rec in ranks:
        assert rec["streams"] == {str(i): np.asarray(o).tolist()
                                  for i, o in enumerate(want)}
        assert rec["mesh"] == {"model": 2} and rec["backend"] == "gloo"
    assert (tmp_path / "prefill_logits.npy").exists()


def test_one_rank_mesh_is_the_default_path(one_rank, jax_ref):
    for a, b in zip(one_rank[None][0] + one_rank[None][1],
                    one_rank["tp=1"][0] + one_rank["tp=1"][1]):
        np.testing.assert_array_equal(a, b)
    for i, s in enumerate(one_rank[None][0]):
        np.testing.assert_array_equal(s, jax_ref[f"cont/{i}"])
    np.testing.assert_array_equal(np.stack(one_rank[None][1]),
                                  jax_ref["lock"])


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
