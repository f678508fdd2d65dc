"""Gloo ranks on the CPU for the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_tp.py).

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
