"""The port's tensor-parallel packed GEMM against the reference's, on CPU
gloo ranks (tests/_dist.py).

  * ``tp_fp4_matmul`` on this rank's shards against the reference's
    ``tp_fp4_matmul`` on 4 forced host devices (the snippet of
    tests/test_mesh_serving.py:239-275, x (4, 64) @ packed (64, 32)): the
    column-parallel shards assembled are bitwise the reference's column
    result and the port's 1-device packed forward; row-parallel is within
    rtol = atol = 1e-5 of the reference's (the all-reduce reorders the f32
    partial sums); the dp=2,tp=2 column form, which gathers the packed
    wire format over "data" first, is bitwise; the row form with N split
    over "data" (gathered along the nibble-packed axis, which the
    reference's ``allgather_packed`` refuses) within 1e-5; with an SR
    ``fwd_a`` the row ranks take their columns of the full activation's
    bits, and the results hold to the same rules.
  * ``allgather_packed`` along dim 0 and along the packed last axis
    reassembles the packed tensor byte for byte; ``wire_nbytes`` is the
    reference's K * N/2 + K/16 * N.
  * K4's ``a_amax`` and ``plan_n`` in its plain version: a given |A| max
    is the tensor scale's source (global max -> the 1-device quantization
    of the shard's columns), absent it nothing changes; ``k4_gemv_plan``
    with ``plan_n`` is the full width's plan.

The reference runs in a subprocess (``_jax_ref.Reference``; this file as a
script, with ``--xla_force_host_platform_device_count=4``) while the ranks
run.
"""
import os
import sys

if __name__ == "__main__":       # the reference's forced host devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=4")

import numpy as np
import pytest
import torch

from _dist import run_ranks, tp_matmul
from _jax_ref import Reference
from repro_torch.core import fqt
from repro_torch.core.quantize import NVFP4, pack_quantize
from repro_torch.distributed import compression
from repro_torch.kernels import counters
from repro_torch.kernels import fp4_matmul as fm

torch.set_num_threads(1)

K, N, M = 64, 32, 4
ROW_TOL = 1e-5


def _operands():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    return x, w


def write_jax_reference(out_path, part, parts):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.core import fqt as jfqt
    from repro.core.quantize import NVFP4 as JNVFP4
    from repro.core.quantize import pack_quantize as jpack
    from repro.distributed.sharding import make_serve_mesh
    from repro.kernels.fp4_matmul import tp_fp4_matmul
    assert len(jax.devices()) == 4
    x, w = _operands()
    pw = jpack(jnp.asarray(w), axis=-2)
    ref = {"wire": np.asarray(pw.wire_nbytes())}
    for sr in (False, True):
        cfg = jfqt.qaf_config()
        if sr:
            cfg = dataclasses.replace(cfg, fwd_a=JNVFP4.with_rounding(True))
        seed = jnp.asarray(7, jnp.uint32)
        qx = jfqt._maybe_q(jnp.asarray(x), jfqt._if_divisible(cfg.fwd_a, K),
                           axis=-1, seed=seed, site=0)
        ref[f"{sr}/one"] = np.asarray(jnp.matmul(
            qx, pw.dequant(), preferred_element_type=jnp.float32))
        tp2 = make_serve_mesh("tp=2")
        for par in ("column", "row"):
            ref[f"{sr}/{par}"] = np.asarray(tp_fp4_matmul(
                jnp.asarray(x), pw, cfg=cfg, mesh=tp2, seed=seed,
                parallel=par))
        ref[f"{sr}/both"] = np.asarray(tp_fp4_matmul(
            jnp.asarray(x), pw, cfg=cfg, mesh=make_serve_mesh("dp=2,tp=2"),
            seed=seed, parallel="column", gather_axis="data"))
    np.savez(out_path, **ref)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = Reference(__file__, tmp_path_factory.mktemp("jax_tp"), 1)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def jax_ref(reference):
    return reference.result()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(spec, sr): per-rank outputs} of the two meshes' rank runs."""
    x, w = _operands()
    tmp = tmp_path_factory.mktemp("tp_ranks")
    return {(spec, sr): run_ranks(tp_matmul, n, tmp, spec, x, w, sr)
            for spec, n in (("tp=2", 2), ("dp=2,tp=2", 4))
            for sr in (False, True)}


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


def _one_device(sr):
    """The port's 1-device packed forward of the same operands."""
    x, w = _operands()
    cfg = fqt.qaf_config()
    if sr:
        cfg = fqt.QuantConfig(fwd_w=NVFP4, fwd_a=NVFP4.with_rounding(True))
    pw = pack_quantize(torch.from_numpy(w), NVFP4, axis=-2)
    return fqt.fp4_matmul(torch.from_numpy(x), pw, cfg=cfg, seed=7).numpy()


@pytest.mark.parametrize("sr", [False, True], ids=["rtn", "sr"])
def test_column_parallel_bitwise(ranks, jax_ref, sr):
    out = ranks[("tp=2", sr)]
    col = np.concatenate([o["col"] for o in out], axis=1)
    np.testing.assert_array_equal(col, jax_ref[f"{sr}/column"])
    np.testing.assert_array_equal(col, _one_device(sr))
    np.testing.assert_array_equal(jax_ref[f"{sr}/column"],
                                  jax_ref[f"{sr}/one"])


@pytest.mark.parametrize("sr", [False, True], ids=["rtn", "sr"])
def test_row_parallel_within_tolerance(ranks, jax_ref, sr):
    out = ranks[("tp=2", sr)]
    np.testing.assert_array_equal(out[0]["row"], out[1]["row"])
    np.testing.assert_allclose(out[0]["row"], jax_ref[f"{sr}/row"],
                               rtol=ROW_TOL, atol=ROW_TOL)
    np.testing.assert_allclose(out[0]["row"], _one_device(sr),
                               rtol=ROW_TOL, atol=ROW_TOL)


@pytest.mark.parametrize("sr", [False, True], ids=["rtn", "sr"])
def test_fsdp_gather_forms(ranks, jax_ref, sr):
    """dp=2,tp=2: column with K gathered over "data" bitwise; row with N
    gathered along the packed axis within the row rule; every rank of a
    model group alike."""
    out = ranks[("dp=2,tp=2", sr)]
    # rank = data * 2 + model: ranks 0 and 1 hold data shard 0
    col = np.concatenate([out[0]["col"], out[1]["col"]], axis=1)
    np.testing.assert_array_equal(col, jax_ref[f"{sr}/both"])
    np.testing.assert_array_equal(out[2]["col"], out[0]["col"])
    for o in out:
        np.testing.assert_array_equal(o["row"], out[0]["row"])
    np.testing.assert_allclose(out[0]["row"], jax_ref[f"{sr}/one"],
                               rtol=ROW_TOL, atol=ROW_TOL)


def test_allgather_packed_both_axes(ranks, jax_ref):
    """The gathered shards are the packed weight's bytes: dim 0 (codes and
    block-scale rows) and the nibble-packed last axis; the wire bytes are
    the reference's."""
    _, w = _operands()
    pw = pack_quantize(torch.from_numpy(w), NVFP4, axis=-2)
    full = (pw.packed.numpy(), pw.scales.view(torch.uint8).numpy())
    out = ranks[("dp=2,tp=2", False)]
    for r, o in enumerate(out):
        m = r % 2
        g0 = o["gather0"]           # (K, N / tp): this model rank's columns
        np.testing.assert_array_equal(g0[0], full[0][:, m * N // 4:
                                                     (m + 1) * N // 4])
        np.testing.assert_array_equal(g0[1], full[1][:, m * N // 2:
                                                     (m + 1) * N // 2])
        g1 = o["gather1"]           # (K / tp, N): this model rank's rows
        np.testing.assert_array_equal(g1[0], full[0][m * K // 2:
                                                     (m + 1) * K // 2])
        np.testing.assert_array_equal(g1[1], full[1][m * K // 32:
                                                     (m + 1) * K // 32])
        assert o["wire"] == (pw.wire_nbytes() // 4, pw.wire_nbytes() // 2)
    assert pw.wire_nbytes() == K * (N // 2) + (K // 16) * N
    assert pw.wire_nbytes() == int(jax_ref["wire"])
    assert compression.packed_wire_bits_per_param() == 4.5
    assert compression.packed_gather_ratio() == pytest.approx(16 / 4.5)


def test_allgather_packed_refuses_a_plain_tensor():
    with pytest.raises(TypeError, match="PackedQuantizedTensor"):
        compression.allgather_packed(torch.zeros(4, 4), None, "data")


def test_k4_given_amax_is_the_tensor_scale_source():
    """The plain K4 on column shards of A with the GLOBAL |A| max quantizes
    each shard as the 1-device K4 quantizes those columns: the shards'
    products sum to the 1-device product (f32 reassociation only); without
    ``a_amax`` the small shard takes its own max, which gives another
    result, and a given max equal to A's own changes nothing."""
    x, w = _operands()
    x[:, :K // 2] *= 1e-5      # E4M3 block scales of these columns lie
    a = torch.from_numpy(x)     # near their range's foot under A's scale
    pw = pack_quantize(torch.from_numpy(w), NVFP4, axis=-2)
    full = fm.packed_block_matmul_plain(a, pw.packed, pw.scales, pw.tscale)
    amax = torch.amax(torch.abs(a)).reshape(1)
    np.testing.assert_array_equal(
        fm.packed_block_matmul_plain(a, pw.packed, pw.scales, pw.tscale,
                                     a_amax=amax).numpy(), full.numpy())
    parts, own = [], []
    for s in (slice(0, K // 2), slice(K // 2, K)):
        args = (a[:, s].contiguous(), pw.packed[s],
                pw.scales[s.start // 16:s.stop // 16], pw.tscale)
        parts.append(fm.packed_block_matmul(*args, a_amax=amax))
        own.append(fm.packed_block_matmul(*args))
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), full.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not torch.equal(own[0] + own[1], parts[0] + parts[1])


def test_k4_plan_n_and_argument_checks():
    for N_loc, K_, tp in ((2048, 4096, 2), (5504, 4096, 2), (16000, 4096, 2),
                          (4096, 5504, 2), (2752, 4096, 4)):
        assert fm.k4_gemv_plan(N_loc, K_, 16, plan_n=N_loc * tp) == \
            fm.k4_gemv_plan(N_loc * tp, K_, 16)
        assert fm.k4_gemv_plan(N_loc, K_, 16, plan_n=None) == \
            fm.k4_gemv_plan(N_loc, K_, 16)
    x, w = _operands()
    pw = pack_quantize(torch.from_numpy(w), NVFP4, axis=-2)
    a = torch.from_numpy(x)
    with pytest.raises(ValueError, match="a_amax"):
        fm.packed_block_matmul(a, pw.packed, pw.scales, pw.tscale,
                               a_amax=torch.ones(2))
    with pytest.raises(ValueError, match="plan_n"):
        fm.packed_block_matmul(a, pw.packed, pw.scales, pw.tscale,
                               plan_n=N - 2)


if __name__ == "__main__":
    write_jax_reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
