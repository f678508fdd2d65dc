"""Gloo ranks on the CPU for the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_tp.py, tests/test_torch_train_mesh.py,
tests/test_torch_mesh_families.py).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes with
``repro_torch.distributed.mesh.spawn`` (a ``file://`` rendezvous of its own
under ``tmp_path``, so tests running at once never share a port), runs
``fn(rank, *args)`` on each and returns their results in rank order,
pickled back through ``tmp_path``.  The rank bodies live here, in a module
that imports nothing of jax: each rank imports only the port, on one
thread.
"""
import itertools
import pickle
from pathlib import Path

_SEQ = itertools.count()


def run_ranks(fn, world: int, tmp_path, *args) -> list:
    from repro_torch.distributed.mesh import spawn
    out = Path(tmp_path) / f"ranks{next(_SEQ)}"
    out.mkdir(parents=True)
    spawn(_rank, world, backend="gloo", device="cpu",
          init_method=f"file://{out}/rendezvous", args=(fn, str(out), args))
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _rank(rank, fn, out, args):
    (Path(out) / f"rank{rank}.pkl").write_bytes(pickle.dumps(fn(rank,
                                                                *args)))


def smoke_cfg():
    from repro_torch.configs import get_config
    return get_config("llama2-60m").smoke()


def serve_engines(rank, spec, params_np, prompts, max_new, fields):
    """Both engines on ``spec``'s mesh from the JAX-initialised params
    (numpy): ``ContinuousEngine`` building its mesh from
    ``ServeConfig.mesh``, the lockstep ``Engine`` given the mesh."""
    import numpy as np
    from repro_torch.convert import params_from_jax_numpy
    from repro_torch.distributed.mesh import make_serve_mesh
    from repro_torch.kernels import counters
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
    from repro_torch.serve import packing
    cfg = smoke_cfg()
    params = params_from_jax_numpy(params_np, cfg, device="cpu")
    scfg = ServeConfig(mesh=spec, **fields)
    cont = ContinuousEngine(cfg, params, scfg, device="cpu")
    streams = cont.generate(prompts, max_new=max_new)
    mesh = make_serve_mesh(spec, device="cpu")
    lock = Engine(cfg, params, scfg, device="cpu", mesh=mesh)
    lstreams = lock.generate(prompts, max_new=max_new)
    return {"cont": [np.asarray(s) for s in streams],
            "lock": [np.asarray(s) for s in lstreams],
            "compiles": (cont.prefill_compiles, cont.decode_compiles),
            "lock_compiles": tuple(p.cache_size
                                   for p in lock.programs.values()),
            "margins": lock.margins,
            "launches": counters.snapshot(),
            "collectives": dict(cont.mesh.stats),
            "store": packing.weight_store_bytes(cont.params),
            "wire": packing.weight_wire_bytes(cont.params),
            "heads": (cont._caches()[0].k_codes.shape[-2],
                      lock._carry[0].k_codes.shape[-2])}


def tp_matmul(rank, spec, x_np, w_np, fwd_a_sr):
    """``tp_fp4_matmul`` on this rank's shards of x (M, K) and of the
    packed ``w`` (K, N): column (w split on N), row (x and w split on K);
    under a "data" axis also the FSDP forms -- column with K gathered
    ("w_up"'s rule) and row with N gathered along the nibble-packed axis
    ("w_down"'s).  Returns this rank's outputs."""
    import dataclasses
    import torch
    from repro_torch.core import fqt
    from repro_torch.core.quantize import NVFP4, pack_quantize
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compression import allgather_packed
    from repro_torch.distributed.mesh import make_serve_mesh
    from repro_torch.kernels.fp4_matmul import tp_fp4_matmul
    mesh = make_serve_mesh(spec, device="cpu")
    cfg = fqt.qaf_config()
    if fwd_a_sr:
        cfg = dataclasses.replace(cfg, fwd_a=NVFP4.with_rounding(True))
    x = torch.from_numpy(x_np)
    pw = pack_quantize(torch.from_numpy(w_np), NVFP4, axis=-2)
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    K = x.shape[-1]
    out = {}

    def shard(path):
        sh = sharding.spec_for_packed(path, pw, mesh, strict=True)
        return dataclasses.replace(
            pw, **{f: sharding.local_shard(getattr(pw, f), sh[f], mesh)
                   for f in ("packed", "scales", "tscale")})

    data = "data" if mesh.axis_size("data") > 1 else None
    col = shard("w_up")                      # (K / data, N / tp)
    out["col"] = tp_fp4_matmul(x, col, cfg=cfg, mesh=mesh, seed=7,
                               parallel="column", gather_axis=data)
    row = shard("w_down")                    # (K / tp, N / data)
    xr = x[:, r * (K // tp):(r + 1) * (K // tp)]
    out["row"] = tp_fp4_matmul(xr, row, cfg=cfg, mesh=mesh, seed=7,
                               parallel="row", gather_axis=data,
                               gather_dim=-1)
    if data:
        out["gather0"] = allgather_packed(col, mesh, "data", dim=0)
        out["gather1"] = allgather_packed(row, mesh, "data", dim=-1)
        out["wire"] = (col.wire_nbytes(), out["gather0"].wire_nbytes())
    out["stats"] = dict(mesh.stats)
    return {k: (v if not hasattr(v, "packed") else
                (v.packed.numpy(), v.scales.view(torch.uint8).numpy(),
                 v.tscale.numpy()))
            if not isinstance(v, torch.Tensor) else v.numpy()
            for k, v in out.items()}


# ---- the training mesh (tests/test_torch_train_mesh.py) ---------------------


def _coords(mesh):
    return {a: mesh.axis_index(a) for a in ("pod", "data", "model")}


def _record_k1(calls):
    """Wrap K1's wrapper so every call records its quantized operands:
    (code x block scale of A, of B, tsA, tsB) as K1's plain version forms
    them (``fp4_matmul._quantized_operand``), from the call's own counters
    and given maxima.  Returns the function that undoes the wrap."""
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels.nvfp4_quant import counter_rbits
    orig = fm.fused_quant_matmul

    def rec(a, b, spec_a, spec_b, **kw):
        def deq(x, spec, ctr, amax, rows):
            bits = (counter_rbits(x.shape, ctr, x.device)
                    if spec.stochastic else None)
            d, ts = fm._quantized_operand(x, spec, bits, along_rows=rows,
                                          amax=amax)
            return d.numpy(), float(ts)
        da, ta = deq(a, spec_a, kw.get("a_counter"), kw.get("a_amax"), False)
        db, tb = deq(b, spec_b, kw.get("b_counter"), kw.get("b_amax"), True)
        calls.append((da, db, ta, tb))
        return orig(a, b, spec_a, spec_b, **kw)

    fm.fused_quant_matmul = rec
    return lambda: setattr(fm, "fused_quant_matmul", orig)


def sharded_matmul(rank, shape, names, kinds, x_np, w_np, g_np, seed):
    """``fqt.fp4_matmul`` on this rank's shards under the training mesh
    ``shape`` x ``names``, for each weight rule in ``kinds``: x's rows over
    the DP axes (and its K columns over "model" for a row-parallel rule),
    w placed by the rule table; forward, then dX and dW from the cotangent
    g's local block.  Returns per kind the local y, dx, dw, the rank's
    coordinates and every K1 call's quantized operands."""
    import torch
    from repro_torch.core import fqt
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh(shape, names, device="cpu")
    out = {"coords": _coords(mesh)}
    x_full, w_full, g_full = (torch.from_numpy(a).to(torch.bfloat16)
                              for a in (x_np, w_np, g_np))
    dp = sharding.dp_axes(mesh)
    n, idx = mesh.axes_size(dp), mesh.axes_index(dp)
    b = x_full.shape[0] // n
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    for kind in kinds:
        path = {"io": "wq", "oi": "wo", "d_vocab": "lm_head"}[kind]
        w = sharding.place_train_params({path: w_full}, mesh)[path]
        x = x_full[idx * b:(idx + 1) * b]
        g = g_full[idx * b:(idx + 1) * b]
        if kind == "oi":
            kl = x.shape[-1] // tp
            x = x[..., r * kl:(r + 1) * kl]
        else:
            nl = g.shape[-1] // tp
            g = g[..., r * nl:(r + 1) * nl]
        x = x.contiguous().requires_grad_(True)
        w = w.contiguous().requires_grad_(True)
        calls = []
        mesh.reset_stats()
        undo = _record_k1(calls)
        try:
            y = fqt.fp4_matmul(x, w, cfg=fqt.nvfp4_paper_config(),
                               seed=seed, mesh=mesh, kind=kind)
            dx, dw = torch.autograd.grad(y, (x, w), g.contiguous())
        finally:
            undo()
        out[kind] = {"y": y.detach().float().numpy(),
                     "dx": dx.float().numpy(), "dw": dw.float().numpy(),
                     "calls": calls, "stats": dict(mesh.stats["ops"])}
    return out


def mesh_session(rank, shape, names, kinds, mm, state_np, batches):
    """One rank session of tests/test_torch_train_mesh.py on the training
    mesh ``shape`` x ``names``: ``sharded_matmul`` at the operands ``mm``
    (x, w, g, seed), then ``train_steps`` (probe on, uncompressed)."""
    return {"matmul": sharded_matmul(rank, shape, names, kinds, *mm),
            "steps": train_steps(rank, shape, names, state_np, batches, True,
                                 False)}


def _flat_tree(tree, prefix=""):
    """{slash path: f32 numpy} of a port tree's tensors (copies: AdamW
    updates its f32 state in place)."""
    import torch
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat_tree(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().to(torch.float32, copy=True).numpy()
    return out


def train_steps(rank, shape, names, state_np, batches, probe, compression,
                qcfg_name="nvfp4_paper_config"):
    """From a JAX ``TrainState`` (numpy leaves) carried over with
    ``convert.train_state_from_jax_numpy`` and placed on the training mesh
    ``shape`` x ``names``: the first step's gathered gradients (after the
    DP sum and the pod mean, as the step takes them), then one step per
    global batch in ``batches`` through ``make_train_step(mesh=)``.
    Returns the metrics of every step, the gathered gradients and the
    gathered parameters after each step, the launches and collectives."""
    import torch
    from repro_torch.convert import train_state_from_jax_numpy
    from repro_torch.core import fqt
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.optim import schedule
    from repro_torch.train import step as st
    cfg = smoke_cfg()
    mesh = make_mesh(shape, names, device="cpu")
    qcfg = getattr(fqt, qcfg_name)()
    tcfg = st.TrainConfig(
        sched=schedule.ScheduleConfig(warmup_steps=2, total_steps=10),
        remat=True, probe_sigma=probe,
        compression=(comp.CompressionConfig(spec=comp.GRAD_FP8)
                     if compression else None))
    state = sharding.place_train_state(
        train_state_from_jax_numpy(state_np, cfg, device="cpu"), mesh)
    batch0 = st.local_batch({"tokens": torch.from_numpy(batches[0])}, mesh)
    per_pod = compression and mesh.axis_size("pod") > 1
    with sharding.per_pod_gradients(per_pod):
        _, _, grads = st.loss_and_grads(state.params, cfg, qcfg, batch0,
                                        seed=st.step_seed(0), remat=True,
                                        mesh=mesh)
    grads = st._sync_dp_grads(grads, mesh, per_pod)
    if per_pod:
        grads = comp.pod_mean_grads(grads, st.step_seed(0), mesh,
                                    tcfg.compression)
    out = {"coords": _coords(mesh), "grads": _flat_tree(
        sharding.gather_tree(grads, mesh)), "metrics": [], "params": []}
    fn = st.make_train_step(cfg, qcfg, tcfg, mesh)
    mesh.reset_stats()
    for tokens in batches:
        state, m = fn(state, st.local_batch(
            {"tokens": torch.from_numpy(tokens)}, mesh))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(_flat_tree(sharding.gather_tree(state.params,
                                                             mesh)))
    out["stats"] = dict(mesh.stats)
    out["local_params"] = _flat_tree(state.params)
    return out


def trainer_run(rank, shape, names, ckpt_dir, total_steps, ckpt_every):
    """``Trainer(mesh=)`` on llama2-60m smoke (nvfp4_paper_config, the
    sigma_q probe, a step-clock tracer on every rank: rank 0 writes it),
    resuming from ``ckpt_dir``'s latest checkpoint.  Returns the events,
    the history, the trace's entries and this rank's coordinates."""
    from repro_torch.core import fqt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim import schedule
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import step as st
    cfg = smoke_cfg()
    mesh = make_mesh(shape, names, device="cpu")
    tracer = Tracer(clock="step")
    tr = Trainer(cfg, fqt.nvfp4_paper_config(), st.TrainConfig(
        sched=schedule.ScheduleConfig(warmup_steps=2, total_steps=10)),
        TrainerConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                      ckpt_dir=ckpt_dir, log_every=1),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
        mesh=mesh, tracer=tracer, device="cpu")
    tr.run()
    return {"coords": _coords(mesh), "events": tr.events,
            "history": [{k: v for k, v in h.items() if k != "dt"}
                        for h in tr.history],
            "trace": tracer.n_events}


# ---- compression and the pipeline (tests/test_torch_compression.py,
# ---- tests/test_torch_pipeline.py) -------------------------------------------


def reduce_scatter_case(rank, shape, names, seed):
    """``Mesh.reduce_scatter`` over "data" of an (8, 12, 4) f32 tensor
    drawn from ``seed + rank``, along dims 0 and 1: each output and the
    call's ``stats`` entry."""
    import torch
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh(shape, names, device="cpu")
    t = torch.randn((8, 12, 4),
                    generator=torch.Generator().manual_seed(seed + rank))
    out = {"coords": _coords(mesh)}
    for dim in (0, 1):
        mesh.reset_stats()
        out[dim] = mesh.reduce_scatter(t, "data", dim=dim)
        out[f"stats{dim}"] = mesh.stats["ops"]["reduce_scatter"]
    return out


def pod_mean(rank, shape, names, per_pod, seed, configs):
    """``pod_mean_grads`` on this rank's shards of its pod's gradient tree
    (``per_pod[pod]``: full numpy leaves, placed by the rule table), under
    each of ``configs`` (None, "off", "fp8", "fp4").  Returns the gathered
    results, this rank's coordinates and the collectives."""
    import torch
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh(shape, names, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in
            per_pod[mesh.axis_index("pod")].items()}
    grads = sharding.place_train_params(full, mesh)
    cfgs = {None: None, "off": comp.CompressionConfig(enabled=False),
            "fp8": comp.CompressionConfig(spec=comp.GRAD_FP8),
            "fp4": comp.CompressionConfig(spec=comp.GRAD_FP4)}
    out = {"coords": _coords(mesh)}
    for name in configs:
        got = comp.pod_mean_grads(grads, seed, mesh, cfgs[name])
        out[str(name)] = {k: v.float().numpy() for k, v in
                          sharding.gather_tree(got, mesh).items()}
    out["stats"] = dict(mesh.stats["ops"])
    return out


def pipeline_case(rank, S, M, case):
    """``pipeline_apply`` over ("pipe", "data") = (S, 1): ``case`` "tanh"
    (the reference's test layer, f32) or "llama" (llama2-60m smoke's dense
    block under nvfp4_paper_config, bf16), forward and backward of
    sum(out^2); and the same layers applied in order on this one rank to
    each microbatch (the GPipe unit of work).  Returns this rank's
    outputs, its stage's parameter gradients, x's gradient and the
    collectives."""
    import torch
    from repro_torch.distributed import pipeline as pp
    torch.set_num_threads(1)
    mesh = pp.make_pipeline_mesh(S, device="cpu")
    g = torch.Generator().manual_seed(0)
    if case == "tanh":
        L, B, D = 8, 8, 16
        params = {"w": torch.randn(L, D, D, generator=g) * 0.3}
        x = torch.randn(B, D, generator=g)

        def fn(p, h):
            return torch.tanh(h @ p["w"])
    else:
        from repro_torch.core import fqt
        from repro_torch.models import registry, transformer
        cfg = smoke_cfg()
        layers = registry.init_params(cfg, device="cpu")["layers"]
        params = {k: v for k, v in _stack(layers).items()}
        L, B = cfg.n_layers, 2 * M
        x = (torch.randn(B, 32, cfg.d_model, generator=g)
             ).to(torch.bfloat16)

        def fn(p, h):
            return transformer._layer_apply(
                cfg, p, h, 0x1234, cache=None,
                qcfg=fqt.nvfp4_paper_config())[0]
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    out = pp.pipeline_apply(fn, params, xg, mesh,
                            pp.PipelineConfig(n_stages=S, n_microbatches=M))
    torch.sum(out.float() ** 2).backward()
    mesh.wait_sends()
    s, per = mesh.axis_index("pipe"), L // S
    res = {"out": out.detach().float().numpy(),
           "grads": [t.grad[s * per:(s + 1) * per].float().numpy()
                     for t in leaves],
           "dx": (xg.grad if xg.grad is not None
                  else torch.zeros_like(xg)).float().numpy(), "stage": s,
           "stats": dict(mesh.stats["ops"])}
    # the sequential reference on this rank: each microbatch through the
    # L layers in order
    for t in leaves:
        t.grad = None
    xs = x.clone().requires_grad_(True)
    outs = []
    for mb in xs.chunk(M):
        h = mb
        for i in range(L):
            h = fn(_index_tree(params, i), h)
        outs.append(h)
    seq = torch.cat(outs)
    torch.sum(seq.float() ** 2).backward()
    res["seq_out"] = seq.detach().float().numpy()
    res["seq_grads"] = [t.grad[s * per:(s + 1) * per].float().numpy()
                        for t in leaves]
    res["seq_dx"] = xs.grad.float().numpy()
    return res


def _stack(layers):
    import torch
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack(layers)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---- the moe and vlm families on a mesh (tests/test_torch_mesh_families.py) --


def family_cfg(arch: str, n_kv_heads: int = 2):
    """The smoke config of ``arch`` with ``n_kv_heads`` KV heads (the
    smoke configs' one head does not split over "model")."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).smoke(),
                               n_kv_heads=n_kv_heads)


def _routing(log):
    """The forward's routing records (``moe.recording``) as numpy: one per
    moe layer (a remat's recompute records them again: dropped)."""
    return [{"route": r["route"], "G": r["G"], "C": r["C"],
             "first": r["first"],
             "groups": [tuple(t.numpy() for t in g) for g in r["groups"]]}
            for r in log]


def family_train(mesh, arch, state_np, batches, compression=False,
                 ckpt_dir=None, masters=False, **overrides):
    """``make_train_step(mesh=)`` on ``arch``'s smoke config from a JAX
    ``TrainState`` (numpy leaves), one step per global batch of
    ``batches`` (dicts of numpy arrays: tokens, and a vlm's
    prefix_embeds), as ``train_steps``: metrics and gathered parameters
    after each step, the collectives, and of the first step its routing
    (``moe.recording``), this rank's aux share and the gradients its
    backward gave, after the DP sum (and the pod mean), gathered.
    ``ckpt_dir``: the final state is saved there (``ckpt.save(mesh=)``)
    and restored into this rank's shards, which must equal it bit for
    bit ("ckpt_equal").  ``masters``: AdamW's f32 master weights after
    each step too, gathered.  ``overrides``: fields of the config to
    replace (the dispatch groups of a 1-rank comparison)."""
    import dataclasses
    import torch
    from repro_torch.convert import (tensor_from_numpy,
                                     train_state_from_jax_numpy)
    from repro_torch.core import fqt
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.optim import schedule
    from repro_torch.train import step as st
    cfg = dataclasses.replace(family_cfg(arch), **overrides)
    qcfg = fqt.nvfp4_paper_config()
    tcfg = st.TrainConfig(
        sched=schedule.ScheduleConfig(warmup_steps=2, total_steps=10),
        remat=True, compression=(comp.CompressionConfig(spec=comp.GRAD_FP8)
                                 if compression else None))
    state = sharding.place_train_state(
        train_state_from_jax_numpy(state_np, cfg, device="cpu"), mesh)

    def batch(b):
        return st.local_batch({k: tensor_from_numpy(v, "cpu")
                               for k, v in b.items()}, mesh)

    per_pod = compression and mesh.axis_size("pod") > 1
    fn = st.make_train_step(cfg, qcfg, tcfg, mesh)
    # the first step's own gradients and aux, as its backward left them
    seen = []
    take = st.loss_and_grads
    st.loss_and_grads = lambda *a, **k: seen.append(take(*a, **k)) or \
        seen[-1]
    mesh.reset_stats()
    out = {"coords": _coords(mesh), "metrics": [], "params": [],
           "masters": []}
    try:
        for i, b in enumerate(batches):
            with moe.recording() as log:
                state, m = fn(state, batch(b))
            if i == 0:
                out["routing"] = _routing(log[:cfg.n_layers])
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["params"].append(_flat_tree(sharding.gather_tree(
                state.params, mesh)))
            if masters:
                out["masters"].append(_flat_tree(sharding.gather_tree(
                    state.opt.master, mesh)))
    finally:
        st.loss_and_grads = take
    stats = {k: v["calls"] for k, v in mesh.stats["ops"].items()}
    _, aux, grads = seen[0]
    grads = st._sync_dp_grads(grads, mesh, per_pod)
    if per_pod:
        grads = comp.pod_mean_grads(grads, st.step_seed(0), mesh,
                                    tcfg.compression)
    out.update(aux_share=float(aux["aux"]), stats=stats,
               grads=_flat_tree(sharding.gather_tree(grads, mesh)))
    if ckpt_dir is not None:
        from repro_torch.checkpoint import ckpt
        ckpt.save(ckpt_dir, state.step, state, mesh=mesh)
        back = ckpt.restore(ckpt_dir, state.step, state, mesh=mesh)
        pairs = []
        sharding.map_paths(state, lambda p, x: pairs.append(x) or x)
        sharding.map_paths(back, lambda p, x: pairs.append(x) or x)
        n = len(pairs) // 2
        out["ckpt_equal"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(pairs[:n], pairs[n:]))
    return out


def family_serve(arch, spec, params_np, prompts, max_new, fields,
                 extras=None):
    """Both engines (the lockstep ``Engine`` only for vlm, as on one card)
    on the serving mesh ``spec`` from the JAX-initialised params (numpy):
    streams, and the collectives of the lockstep run by operation."""
    import numpy as np
    from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
    from repro_torch.distributed.mesh import make_serve_mesh
    from repro_torch.kernels import counters
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
    cfg = family_cfg(arch)
    params = params_from_jax_numpy(params_np, cfg, device="cpu")
    scfg = ServeConfig(mesh=spec, **fields)
    out = {}
    if cfg.family == "moe":
        cont = ContinuousEngine(cfg, params, scfg, device="cpu")
        out["cont"] = [np.asarray(s) for s in
                       cont.generate(prompts, max_new=max_new)]
    mesh = make_serve_mesh(spec, device="cpu")
    lock = Engine(cfg, params, scfg, device="cpu", mesh=mesh)
    extras = {k: tensor_from_numpy(v, "cpu")
              for k, v in (extras or {}).items()}
    out["lock"] = [np.asarray(s) for s in
                   lock.generate(prompts, max_new=max_new, extras=extras)]
    out["ops"] = {k: v["calls"] for k, v in mesh.stats["ops"].items()}
    out["decode_calls"] = lock.programs["decode"].calls
    out["prefill_calls"] = lock.programs["prefill"].calls
    out["launches"] = counters.snapshot()
    return out


def family_session(rank, shape, names, train, serve, pods, ckpt=None):
    """One rank session of tests/test_torch_mesh_families.py on the mesh
    ``shape`` x ``names``: ``train`` {arch: (state_np, batches)} through
    ``family_train`` (``ckpt`` {arch: directory}: checkpointed there);
    ``serve`` (spec, {arch: (params_np, prompts, max_new, fields,
    extras)}) through ``family_serve``; ``pods`` {arch: (state_np,
    batches)} compressed (``family_train(compression=True)``)."""
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh(shape, names, device="cpu")
    ckpt = ckpt or {}
    out = {"train": {a: family_train(mesh, a, *v, ckpt_dir=ckpt.get(a))
                     for a, v in train.items()},
           "pods": {a: family_train(mesh, a, *v, compression=True)
                    for a, v in pods.items()}}
    if serve:
        spec, cases = serve
        out["serve"] = {a: family_serve(a, spec, *v)
                        for a, v in cases.items()}
    return out


# ---- the encdec, hybrid and ssm families on a mesh --------------------------
# (tests/test_torch_mesh_encdec_recurrent.py)


def smoke_family_cfg(arch: str):
    """The plain smoke config of ``arch`` (whisper-base, zamba2-1.2b and
    xlstm-125m smoke configs have 4 query and 4 KV heads, and zamba2's and
    xLSTM's 4 SSM / mLSTM heads: all split over "model" at tp=2)."""
    from repro_torch.configs import get_config
    return get_config(arch).smoke()


def smoke_family_serve(arch, spec, params_np, prompts, max_new, fields,
                       frames=None):
    """The lockstep ``Engine`` on the serving mesh ``spec`` from the
    JAX-initialised params (numpy), with whisper's ``frames`` (numpy,
    one row a prompt), and for whisper the ``ContinuousEngine`` too, each
    request with its row of the frames: streams, the collectives of the
    lockstep run by operation, its program calls and the launches."""
    import numpy as np
    from repro_torch.convert import params_from_jax_numpy, tensor_from_numpy
    from repro_torch.distributed.mesh import make_serve_mesh
    from repro_torch.kernels import counters
    from repro_torch.serve import ContinuousEngine, Engine, Request
    from repro_torch.serve import ServeConfig
    cfg = smoke_family_cfg(arch)
    params = params_from_jax_numpy(params_np, cfg, device="cpu")
    scfg = ServeConfig(mesh=spec, **fields)
    mesh = make_serve_mesh(spec, device="cpu")
    out = {}
    extras = {}
    if frames is not None:
        extras = {"frames": tensor_from_numpy(frames, "cpu")}
        cont = ContinuousEngine(cfg, params, scfg, device="cpu")
        res = cont.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                                max_new=max_new)
                        for i, p in enumerate(prompts)],
                       extras={i: {"frames": extras["frames"][i:i + 1]}
                               for i in range(len(prompts))})
        out["cont"] = [np.asarray(res[i]) for i in range(len(prompts))]
        out["cont_heads"] = cont._caches()[0].k_codes.shape[-2]
    lock = Engine(cfg, params, scfg, device="cpu", mesh=mesh)
    out["lock"] = [np.asarray(s) for s in
                   lock.generate(prompts, max_new=max_new, extras=extras)]
    out["ops"] = {k: v["calls"] for k, v in mesh.stats["ops"].items()}
    out["decode_calls"] = lock.programs["decode"].calls
    out["launches"] = counters.snapshot()
    out["carry"] = _shapes(lock._carry)
    out["engine_whole"] = _whole_shapes(lock.params)
    return out


def _whole_shapes(params):
    """{path: shape} of a tree's ``packing.ENGINE_WHOLE`` leaves."""
    from repro_torch.distributed.sharding import map_paths
    from repro_torch.serve.packing import ENGINE_WHOLE
    out = {}
    map_paths(params, lambda path, x: out.update({path: tuple(x.shape)})
              if path.rsplit("/", 1)[-1] in ENGINE_WHOLE else None)
    return out


def _shapes(carry):
    """A decode carry's tensor shapes, nested as the carry (a KV cache as
    {field: shape})."""
    import dataclasses
    import torch
    if isinstance(carry, (list, tuple)):
        return [_shapes(c) for c in carry]
    if isinstance(carry, dict):
        return {k: _shapes(v) for k, v in carry.items()}
    if dataclasses.is_dataclass(carry):
        return {f.name: tuple(getattr(carry, f.name).shape)
                for f in dataclasses.fields(carry)
                if isinstance(getattr(carry, f.name), torch.Tensor)}
    return tuple(carry.shape)


def smoke_family_session(rank, shape, names, train, serve, ckpt=None):
    """One rank session of tests/test_torch_mesh_encdec_recurrent.py on
    the mesh ``shape`` x ``names``: ``train`` {arch: (state_np, batches)}
    through ``family_train`` on the plain smoke configs (``ckpt`` {arch:
    directory}: checkpointed there); ``serve`` (spec, {arch: (params_np,
    prompts, max_new, fields, frames)}) through ``smoke_family_serve``."""
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh(shape, names, device="cpu")
    ckpt = ckpt or {}
    out = {"train": {a: family_train(mesh, a, *v, ckpt_dir=ckpt.get(a),
                                     masters=True,
                                     n_kv_heads=smoke_family_cfg(
                                         a).n_kv_heads)
                     for a, v in train.items()}}
    if serve:
        spec, cases = serve
        out["serve"] = {a: smoke_family_serve(a, spec, *v)
                        for a, v in cases.items()}
    return out
