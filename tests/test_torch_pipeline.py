"""``distributed/pipeline.py`` on gloo CPU ranks (tests/_dist.py): the GPipe
schedule over ("pipe", "data") = (2, 1) and (4, 1).

  * The reference's case (tests/test_distributed.py: 8 layers of
    tanh(h @ w), batch 8 x 16, 4 microbatches): the output on every stage
    equals the sequential stack within rtol = atol = 2e-4 (the reference's
    rule), forward and backward: each stage's layers' gradients and x's
    gradient on the first stage; the stack is also JAX's (``jnp``, the
    same numpy inputs) within the same rule.
  * llama2-60m smoke's dense block (``transformer._layer_apply`` under
    ``nvfp4_paper_config``, bf16) as ``layer_fn``, 2 stages x 1 layer, 2
    microbatches of 2 x 32 tokens: the GPipe unit of work is a microbatch,
    so the reference is each microbatch through the layers in order on one
    rank.  The forward is equal bit for bit (the same ops on the same
    operands), the gradients within relative L2 1e-2: autograd adds the
    microbatches' bf16 contributions in another order.
  * Transfers: one send and one receive per microbatch and stage boundary
    in each direction; the broadcast of the last stage's output is one
    all-reduce.
"""
import numpy as np
import pytest
import torch

from _dist import pipeline_case, run_ranks
from repro_torch.distributed import pipeline as pp
from repro_torch.kernels import counters

torch.set_num_threads(1)

RTOL = ATOL = 2e-4
LLAMA_GRAD_REL_L2 = 1e-2


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counters.reset()
    yield
    assert counters.snapshot() == {k: 0 for k in counters.COUNTS}


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_equals_sequential_stack(tmp_path, stages):
    outs = run_ranks(pipeline_case, stages, tmp_path, stages, 4, "tanh")
    for o in outs:
        np.testing.assert_allclose(o["out"], o["seq_out"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(o["out"], outs[0]["out"], rtol=0, atol=0)
        for got, want in zip(o["grads"], o["seq_grads"]):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        ops = o["stats"]
        s = o["stage"]
        assert ops.get("send", {}).get("calls", 0) == \
            4 * ((s < stages - 1) + (s > 0))
        assert ops.get("recv", {}).get("calls", 0) == \
            4 * ((s < stages - 1) + (s > 0))
        assert ops["all_reduce_sum"]["calls"] == 1
    np.testing.assert_allclose(outs[0]["dx"], outs[0]["seq_dx"], rtol=RTOL,
                               atol=ATOL)
    for o in outs[1:]:
        assert not o["dx"].any()      # x enters at the first stage only
    # the reference's stack in JAX on the same inputs
    import jax.numpy as jnp
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(8, 16, 16, generator=g) * 0.3).numpy()
    x = torch.randn(8, 16, generator=g).numpy()
    h = jnp.asarray(x)
    for i in range(8):
        h = jnp.tanh(h @ jnp.asarray(w[i]))
    np.testing.assert_allclose(outs[0]["out"], np.asarray(h), rtol=RTOL,
                               atol=ATOL)


def test_pipeline_llama_block(tmp_path):
    outs = run_ranks(pipeline_case, 2, tmp_path, 2, 2, "llama")
    for o in outs:
        assert np.array_equal(o["out"], o["seq_out"])
        for got, want in zip(o["grads"], o["seq_grads"]):
            err = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert err <= LLAMA_GRAD_REL_L2, err
    err = np.linalg.norm(outs[0]["dx"] - outs[0]["seq_dx"]) \
        / np.linalg.norm(outs[0]["seq_dx"])
    assert err <= LLAMA_GRAD_REL_L2, err


def test_pipeline_refusals():
    from repro_torch.distributed.mesh import Mesh
    mesh = Mesh((2, 1), ("pipe", "data"), device=torch.device("cpu"))
    p = {"w": torch.zeros(4, 8, 8)}
    with pytest.raises(ValueError, match="microbatches"):
        pp.pipeline_apply(lambda q, h: h, p, torch.zeros(6, 8), mesh,
                          pp.PipelineConfig(2, 4))
    with pytest.raises(ValueError, match="stages"):
        pp.pipeline_apply(lambda q, h: h, p, torch.zeros(8, 8), mesh,
                          pp.PipelineConfig(4, 4))
    with pytest.raises(ValueError, match="layers"):
        pp.pipeline_apply(lambda q, h: h, {"w": torch.zeros(3, 8, 8)},
                          torch.zeros(8, 8), mesh, pp.PipelineConfig(2, 4))
    with pytest.raises(ValueError, match="divisible into 3 stages"):
        pp.make_pipeline_mesh(3, world=4, device="cpu")
