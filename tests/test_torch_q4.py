"""The port's int4 primitives (ops/quant.py, int4 half) and the plain
version of K6 (ops/cuda/q4_matmul.py) against the JAX package on the same
numpy inputs: packing, unpacking and dequantization equal bit for bit (to
the values JAX computes under jit, where it quantizes); K6's plain version
against the Pallas kernels `q4_matmul_t_pallas` and
`q4_matmul_t_stacked_pallas` in interpret mode (observed: fp32 outputs
within 1e-6 relative, bf16 outputs within one bf16 ulp; held to the JAX
suite's 2e-2, tests/test_q4.py:95-143, and 1e-5 for fp32); the routes
(K6 at <= 64 rows, bf16 dequantize + matmul above, the fp32 reference for
shapes K6 does not take) against JAX's; frozen_q4_linear and its
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops import quant as jq
from sparse_matrix_tuning_tpu.ops import sparse_linear as jsl
from sparse_matrix_tuning_tpu.ops.pallas.q4_matmul import (
    build_scale_strips, pad_packed, q4_matmul_t_pallas, q4_matmul_t_stacked_pallas)
from sparse_matrix_tuning_tpu_torch.ops import quant as pq
from sparse_matrix_tuning_tpu_torch.ops import sparse_linear as psl
from sparse_matrix_tuning_tpu_torch.ops.cuda import q4_matmul as k6

KERNEL_TOL = 2e-2  # tests/test_q4.py:95-143, bf16 outputs
FP32_TOL = 1e-5    # fp32 outputs: the same exact products, fp32 sums in another order


def _close_fp32(got, want):
    """fp32 sums of the same products in another order: FP32_TOL of the
    largest output (~50 here: standard-normal x and weights over 512)."""
    tp.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL * float(np.abs(tp.np32(want)).max()))


def _w(o, i, seed):
    return tp.seeded_normal((o, i), seed=seed)


def _both_q4(o, i, seed):
    """The same weight quantized by both packages: (port (w4, s4), JAX (w4, s4))."""
    w = _w(o, i, seed)
    return pq.quantize_weight_int4(torch.from_numpy(w)), jax.jit(jq.quantize_weight_int4)(
        jnp.asarray(w))


# ---------------------------------------------------------------------------
# quantization: equal packed values and scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("o,i", [(8, 512), (16, 256), (8, 128), (64, 768)],
                         ids=["8x512", "16x256", "group-fallback-8x128", "64x768"])
def test_int4_quantization_equals_jax(o, i):
    (w4, s4), (jw4, js4) = _both_q4(o, i, seed=o + i)
    assert w4.dtype == torch.int8 and w4.shape == (o, i // 2) and s4.dtype == torch.float32
    np.testing.assert_array_equal(w4.numpy(), np.asarray(jw4))
    np.testing.assert_array_equal(s4.numpy(), np.asarray(js4))
    np.testing.assert_array_equal(pq.unpack_int4(w4).numpy(), np.asarray(jq.unpack_int4(jw4)))
    for dtype in ("fp32", "bf16"):
        got = pq.dequantize_weight_int4(w4, s4, tp.TORCH_DTYPES[dtype])
        want = jq.dequantize_weight_int4(jw4, js4, tp.JAX_DTYPES[dtype])
        np.testing.assert_array_equal(tp.np32(got), tp.np32(want))
    if i == 128:  # the group fallback: 64-column groups
        assert s4.shape == (o, 2)


def test_int4_bad_in_dim_raises_in_both():
    w = _w(8, 120, seed=1)
    with pytest.raises(ValueError, match="multiple"):
        pq.quantize_weight_int4(torch.from_numpy(w), group=64)
    with pytest.raises(ValueError, match="multiple"):
        jq.quantize_weight_int4(jnp.asarray(w), group=64)


# ---------------------------------------------------------------------------
# K6: the plain version against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("t,o,i", [(8, 64, 512), (5, 128, 256), (32, 72, 768), (64, 256, 1024)])
def test_k6_plain_matches_pallas_kernel(t, o, i, dtype):
    """x in `dtype`: both round it to bf16 first; the output comes back in x's
    dtype (the Pallas kernel writes fp32, then casts)."""
    (w4, s4), (jw4, js4) = _both_q4(o, i, seed=5 + i)
    x = tp.seeded_normal((t, i), seed=6 + t)
    got = k6.q4mm_t_plain(tp.to_torch(x, dtype).to(torch.bfloat16), w4, s4,
                          out_dtype=tp.TORCH_DTYPES[dtype])
    want = q4_matmul_t_pallas(tp.to_jax(x, dtype), jw4, js4, interpret=True)
    assert got.shape == (t, o) and got.dtype == tp.TORCH_DTYPES[dtype]
    tol = FP32_TOL if dtype == "fp32" else KERNEL_TOL
    tp.assert_close(got, want, rtol=tol, atol=tol)


def test_k6s_stacked_layer_views_match_pallas_stacked_kernel():
    """K6s: the port runs K6 (here its plain version) on the layer view
    w4[l], s4[l]; JAX its stacked kernel on the padded stack with transposed
    scale strips. Every layer."""
    n_layers, o, i = 3, 128, 512
    both = [_both_q4(o, i, seed=20 + l) for l in range(n_layers)]
    w4s = torch.stack([p[0] for p, _ in both])
    s4s = torch.stack([p[1] for p, _ in both])
    jw4p = pad_packed(jnp.stack([j[0] for _, j in both]))
    strips = [build_scale_strips(j[1], i // 2) for _, j in both]
    slt, sht = jnp.stack([s[0] for s in strips]), jnp.stack([s[1] for s in strips])
    x = tp.seeded_normal((8, i), seed=30)
    for l in range(n_layers):
        assert w4s[l].is_contiguous() and w4s[l].data_ptr() == w4s.data_ptr() + l * o * i // 2
        got = pq.q4_matmul_t_stacked(tp.to_torch(x, "bf16"), w4s, s4s, l)
        want = q4_matmul_t_stacked_pallas(tp.to_jax(x, "bf16"), jw4p, slt, sht, jnp.int32(l),
                                          interpret=True)
        tp.assert_close(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_array_equal(
            pq.dequantize_stacked_layer_int4(w4s, s4s, l, torch.float32).numpy(),
            np.asarray(jq.dequantize_weight_int4(both[l][1][0], both[l][1][1], jnp.float32)))


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prefill_rows_route_matches_jax(dtype):
    """Above Q4_DECODE_MAX_ROWS both dequantize the layer to bf16 and run a
    bf16 product on x cast to bf16 (JAX's stacked form with s4s): the same
    values up to the bf16 rounding of the products' sums."""
    o, i = 128, 512
    (w4, s4), (jw4, js4) = _both_q4(o, i, seed=40)
    x = tp.seeded_normal((2, (pq.Q4_DECODE_MAX_ROWS + 8) // 2, i), seed=41)
    got = pq.q4_matmul_t(tp.to_torch(x, dtype), w4, s4)
    slt, sht = build_scale_strips(js4, i // 2)
    want = jq.q4_matmul_t_stacked(tp.to_jax(x, dtype), pad_packed(jw4[None]), slt[None],
                                  sht[None], jnp.int32(0), s4s=js4[None])
    assert got.shape == (2, (pq.Q4_DECODE_MAX_ROWS + 8) // 2, o)
    assert got.dtype == tp.TORCH_DTYPES[dtype]
    # bf16 sums: a bf16 ulp of the largest output (the JAX suite's 0.02 x max)
    tol = 2.0 ** -8 * float(np.abs(tp.np32(want)).max())
    tp.assert_close(got, want, rtol=0, atol=tol)


def test_route_by_rows_and_shape(monkeypatch):
    """A conforming weight takes K6 (here its plain version) at <= 64 rows
    and not above; one K6 does not take (O % 128 != 0) takes the fp32
    reference, equal to JAX's q4_matmul_t_ref."""
    calls = []
    plain = k6.q4mm_t_plain
    monkeypatch.setattr(k6, "q4mm_t_plain", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    (w4, s4), _ = _both_q4(128, 256, seed=50)
    assert pq.q4_conforms(w4, s4)
    pq.q4_matmul_t(torch.zeros((4, 16, 256)), w4, s4)
    assert len(calls) == 1
    pq.q4_matmul_t(torch.zeros((5, 16, 256)), w4, s4)
    assert len(calls) == 1
    (w4, s4), (jw4, js4) = _both_q4(64, 512, seed=51)
    assert not pq.q4_conforms(w4, s4)
    x = tp.seeded_normal((4, 512), seed=52)
    got = pq.q4_matmul_t(torch.from_numpy(x), w4, s4)
    assert len(calls) == 1
    want = jq.q4_matmul_t_ref(jnp.asarray(x), jw4, js4)
    _close_fp32(got, want)
    with pytest.raises(ValueError, match="conform"):
        pq.q4_matmul_t_stacked(torch.from_numpy(x), w4[None], s4[None], 0)


def test_frozen_q4_linear_and_grad_match_jax():
    """Forward (the reference route on this shape) and the straight-through
    input gradient against the dequantized weight."""
    (w4, s4), (jw4, js4) = _both_q4(64, 512, seed=11)
    x = tp.seeded_normal((4, 512), seed=12)
    g = tp.seeded_normal((4, 64), seed=13)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = psl.frozen_q4_linear(xt, w4, s4)
    y.backward(torch.from_numpy(g))
    jy, vjp = jax.vjp(lambda xx: jsl.frozen_q4_linear(xx, jw4, js4), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    _close_fp32(y, jy)
    _close_fp32(xt.grad, jgx)
    w4s, s4s = torch.stack([w4, w4]), torch.stack([s4, s4])  # the stacked form: layer views
    _close_fp32(psl.frozen_q4_linear(torch.from_numpy(x), w4s[1], s4s[1]), jy)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_k6_splits_and_refusals():
    """The group split over CTAs at the TinyLlama and Llama-3-8B shapes on a
    132-SM card (128-column output tiles; tiles x splits at most the SMs,
    at least one group a split), and a device without a kernel refused."""
    n_sm = 132
    for (o, k), want in {(5632, 1024): 3, (2048, 1024): 8, (256, 1024): 8, (2048, 2816): 8,
                         (14336, 2048): 1, (128, 128): 1, (384, 1024): 8}.items():
        got = k6.splits_for(o, k, n_sm)
        tiles = -(-o // k6.TILE_O)
        assert got == want and 1 <= got <= k // 128, (o, k, got)
        assert tiles * got <= max(n_sm, tiles), (o, k, got)
    meta = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k6.q4mm_t(meta, torch.empty((128, 128), dtype=torch.int8, device="meta"),
                  torch.empty((128, 2), device="meta"))
    assert k6.LAUNCHES == 0
