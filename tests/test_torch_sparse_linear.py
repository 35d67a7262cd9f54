"""smt_linear (torch.autograd.Function) against the JAX custom VJP through
jax.vjp, the dispatch hook, the device-based impl policy, and the plan's
gather/scatter against the JAX plan's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops.sparse_linear import smt_linear as jax_smt_linear
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import (
    _resolve_impl, make_sparse_linear_dispatch, smt_linear)
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, LinearPlan, SMTPlan

BLOCKS = ((0, 1), (2, 0), (1, 1))
# fp32: the JAX suite's fp32 block-grad tolerance; bf16: its bf16 one, which
# also holds fp16
TOL = {"fp32": (1e-5, 1e-4), "bf16": (2e-2, 2e-1), "fp16": (2e-2, 2e-1)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_smt_linear_matches_jax_vjp(dtype):
    out_dim, in_dim = 3 * BLOCK, 2 * BLOCK
    w_np = tp.seeded_normal((out_dim, in_dim), 0, 0.05)
    x_np = tp.seeded_normal((2, 24, in_dim), 1)
    g_np = tp.seeded_normal((2, 24, out_dim), 2)
    jlp = JaxLinearPlan("q_proj", 0, out_dim, in_dim, blocks=BLOCKS)
    lp = LinearPlan("q_proj", 0, out_dim, in_dim, blocks=BLOCKS)

    jw = tp.to_jax(w_np, dtype)
    jblocks = JaxSMTPlan("matrix", {"0.q_proj": jlp}).gather({"0": {"q_proj": jw}})["0.q_proj"]
    y_j, vjp = jax.vjp(lambda x, b: jax_smt_linear(x, b, jw, jlp, "oracle"),
                       tp.to_jax(x_np, dtype), jblocks)
    gx_j, gb_j = vjp(tp.to_jax(g_np, dtype))

    w = tp.to_torch(w_np, dtype).requires_grad_(True)  # frozen: must get no grad
    blocks = SMTPlan("matrix", {"0.q_proj": lp}).gather({"0": {"q_proj": w}})["0.q_proj"]
    blocks.requires_grad_(True)
    x = tp.to_torch(x_np, dtype).requires_grad_(True)
    y = smt_linear(x, blocks, w, lp, "oracle")
    y.backward(tp.to_torch(g_np, dtype))

    rtol, atol = TOL[dtype]
    assert y.dtype == tp.TORCH_DTYPES[dtype] and blocks.grad.dtype == torch.float32
    tp.assert_close(y, y_j, rtol, atol)
    tp.assert_close(x.grad, gx_j, rtol, atol)
    tp.assert_close(blocks.grad, gb_j, rtol, atol)
    assert w.grad is None


def test_no_grad_x_when_input_is_frozen():
    """Below the lowest trainable layer nothing needs grad_x; the Function
    skips that matmul and still gives the blocks their gradient."""
    lp = LinearPlan("up_proj", 0, 2 * BLOCK, BLOCK, blocks=((1, 0),))
    w = tp.to_torch(tp.seeded_normal((2 * BLOCK, BLOCK), 0))
    x = tp.to_torch(tp.seeded_normal((5, BLOCK), 1))
    blocks = w.view(2, BLOCK, 1, BLOCK)[1:, :, 0, :].clone().requires_grad_(True)
    smt_linear(x, blocks, w, lp).sum().backward()
    want = torch.ones(5, BLOCK).t() @ x  # sum-loss: g = 1
    torch.testing.assert_close(blocks.grad[0], want, rtol=1e-5, atol=1e-5)


def test_dispatch_routes_planned_linears_only():
    lp = LinearPlan("q_proj", 1, BLOCK, BLOCK, blocks=((0, 0),))
    plan = SMTPlan("matrix", {"1.q_proj": lp})
    w = tp.to_torch(tp.seeded_normal((BLOCK, BLOCK), 0))
    x = tp.to_torch(tp.seeded_normal((3, BLOCK), 1))
    trainable = plan.gather({"1": {"q_proj": w}})
    trainable["1.q_proj"].requires_grad_(True)
    linear = make_sparse_linear_dispatch(plan, trainable, "auto")
    y_planned = linear(x, w, "q_proj", 1)
    y_frozen = linear(x, w, "q_proj", 0)
    torch.testing.assert_close(y_planned, x @ w.t())
    assert y_planned.requires_grad and not y_frozen.requires_grad
    # the plan builds its device index tensors once
    assert plan.block_index("1.q_proj", "cpu", torch.int32) is \
        plan.block_index("1.q_proj", "cpu", torch.int32)


def test_resolve_impl_by_tensor_device():
    assert _resolve_impl("auto", "cpu") == "oracle"
    assert _resolve_impl("auto", torch.device("cuda", 0)) == "kernel"
    assert _resolve_impl("oracle", "cpu") == "oracle"
    assert _resolve_impl("kernel", "cuda") == "kernel"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _resolve_impl("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown sparse_impl"):
        _resolve_impl("pallas", "cpu")


def test_gather_scatter_round_trip_matches_jax():
    """Rectangular weight (3x5 blocks), asymmetric coordinates: the numpy
    advanced-indexing semantics of w4[rb, :, cb, :] -> (n, 256, 256)."""
    blocks = ((2, 4), (0, 1), (1, 3), (2, 0))
    out_dim, in_dim = 3 * BLOCK, 5 * BLOCK
    w_np = tp.seeded_normal((out_dim, in_dim), 0)
    jplan = JaxSMTPlan("matrix", {"0.down_proj": JaxLinearPlan(
        "down_proj", 0, out_dim, in_dim, blocks=blocks)})
    plan = SMTPlan("matrix", {"0.down_proj": LinearPlan(
        "down_proj", 0, out_dim, in_dim, blocks=blocks)})

    jt = jplan.gather({"0": {"down_proj": jnp.asarray(w_np)}})["0.down_proj"]
    w = torch.from_numpy(w_np.copy())
    t = plan.gather({"0": {"down_proj": w}})["0.down_proj"]
    np.testing.assert_array_equal(tp.np32(t), tp.np32(jt))
    np.testing.assert_array_equal(tp.np32(t[0]), w_np[2 * BLOCK:3 * BLOCK, 4 * BLOCK:5 * BLOCK])

    new = tp.seeded_normal(tuple(t.shape), 5)
    jw_new = jplan.scatter({"0": {"down_proj": jnp.asarray(w_np)}},
                           {"0.down_proj": jnp.asarray(new)})["0"]["down_proj"]
    layers = {"0": {"down_proj": w}}
    assert plan.scatter(layers, {"0.down_proj": torch.from_numpy(new)}) is layers
    assert layers["0"]["down_proj"] is w  # in place
    np.testing.assert_array_equal(tp.np32(w), tp.np32(jw_new))
    back = plan.gather(layers)["0.down_proj"]
    np.testing.assert_array_equal(tp.np32(back), new)
