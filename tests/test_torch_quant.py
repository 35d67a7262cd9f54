"""The port's int8 primitives (ops/quant.py) and the plain versions of the
K4 and K5 kernels (ops/cuda/q8_matmul.py, ops/cuda/correction.py) against
the JAX package on the same numpy inputs: quantization must give the same
int8 values and scales, the int8 products are integer-exact, and the block
correction agrees with the Pallas kernel (interpret mode) and the XLA
formulations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops import quant as jq
from sparse_matrix_tuning_tpu.ops import sparse_linear as jsl
from sparse_matrix_tuning_tpu.ops.pallas.correction import block_correction as jax_block_correction
from sparse_matrix_tuning_tpu.ops.pallas.q8_matmul import q8_matmul_fused, q8_matmul_t_fused
from sparse_matrix_tuning_tpu_torch.ops import quant as pq
from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5
from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4


def _int8(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int8
        return x.numpy()
    assert x.dtype == jnp.int8
    return np.asarray(x)


# ---------------------------------------------------------------------------
# quantization: equal int8 values and scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("shape", [(16, 64), (3, 5, 96), (7, 256)])
def test_row_quant_equals_jax(shape, dtype):
    x = tp.seeded_normal(shape, seed=1, scale=0.3)
    x[..., 0, :] = 0.0  # an all-zero row takes the 1e-8 clamp
    # jitted, as the JAX package runs it (inside its trainer and eval steps)
    xq_j, sx_j = jax.jit(jq.row_quant)(tp.to_jax(x, dtype))
    xq_p, sx_p = pq.row_quant(tp.to_torch(x, dtype))
    assert sx_p.shape == sx_j.shape == (*shape[:-1], 1) and sx_p.dtype == torch.float32
    np.testing.assert_array_equal(_int8(xq_p), _int8(xq_j))
    np.testing.assert_array_equal(sx_p.numpy(), np.asarray(sx_j))
    assert np.abs(_int8(xq_p)).max() == 127


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_row_quant_scales_equal_jitted_jax_at_every_magnitude(dtype):
    """Rows scaled 0.01 .. 10: the scales and int8 values equal jax.jit's
    bit for bit. Eager JAX divides by 127 and parts from jit in the last
    bit of some scales (29 of these 512 rows in fp32)."""
    x = tp.rows_scaled_normal((512, 256), seed=0)
    xq_j, sx_j = jax.jit(jq.row_quant)(tp.to_jax(x, dtype))
    xq_p, sx_p = pq.row_quant(tp.to_torch(x, dtype))
    np.testing.assert_array_equal(sx_p.numpy(), np.asarray(sx_j))
    np.testing.assert_array_equal(_int8(xq_p), _int8(xq_j))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_and_dequantize_weight_equal_jax(dtype):
    w = tp.seeded_normal((96, 80), seed=2, scale=0.02)
    w[5] = 0.0
    wq_j, sw_j = jq.quantize_weight(tp.to_jax(w, dtype))
    wq_p, sw_p = pq.quantize_weight(tp.to_torch(w, dtype))
    np.testing.assert_array_equal(_int8(wq_p), _int8(wq_j))
    np.testing.assert_array_equal(sw_p.numpy(), np.asarray(sw_j))
    for out in ("fp32", "bf16"):
        np.testing.assert_array_equal(
            tp.np32(pq.dequantize_weight(wq_p, sw_p, tp.TORCH_DTYPES[out])),
            tp.np32(jq.dequantize_weight(wq_j, sw_j, tp.JAX_DTYPES[out])))
    # symmetric per-channel int8: |err| <= scale / 2 per element
    err = np.abs(tp.np32(tp.to_torch(w, dtype)) - tp.np32(pq.dequantize_weight(wq_p, sw_p, torch.float32)))
    assert (err <= sw_p.numpy()[:, None] * 0.5 + 1e-8).all()


# ---------------------------------------------------------------------------
# the int8 matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(8,), (2, 5)])
def test_q8_matmuls_match_jax_fp32(lead):
    """fp32: the same int32 product and the same fp32 scale expression
    (rtol 1e-6 leaves room for XLA fusing the two multiplies)."""
    w = tp.seeded_normal((48, 64), seed=3, scale=0.02)
    x = tp.seeded_normal((*lead, 64), seed=4, scale=0.1)
    g = tp.seeded_normal((*lead, 48), seed=5, scale=0.1)
    wq_j, sw_j = jq.quantize_weight(tp.to_jax(w))
    wq_p, sw_p = pq.quantize_weight(tp.to_torch(w))
    y = pq.q8_matmul_t(tp.to_torch(x), wq_p, sw_p)
    gx = pq.q8_matmul(tp.to_torch(g), wq_p, sw_p)
    assert y.shape == (*lead, 48) and gx.shape == (*lead, 64) and y.dtype == torch.float32
    tp.assert_close(y, jq.q8_matmul_t(tp.to_jax(x), wq_j, sw_j), rtol=1e-6, atol=0)
    tp.assert_close(gx, jq.q8_matmul(tp.to_jax(g), wq_j, sw_j), rtol=1e-6, atol=0)
    # and they approximate the unquantized products
    exact = x.astype(np.float64) @ w.astype(np.float64).T
    assert np.abs(tp.np32(y) - exact).max() < 0.02 * np.abs(exact).max() + 1e-4


@pytest.fixture(scope="module")
def tile_data():
    """tests/test_q8_matmul_kernel.py's one-tile shape: T 512, O 512, K 1024."""
    x = tp.seeded_normal((512, 1024), seed=6)
    w = tp.seeded_normal((512, 1024), seed=7, scale=0.02)
    return x, w


@pytest.mark.parametrize("dtype", ["bf16", "fp32", "fp16"])
def test_k4_plain_equals_pallas_kernel_interpret(tile_data, dtype):
    """K4's plain version against the JAX Pallas kernels in interpret mode:
    the int32 accumulation is exact and the epilogue is the same fp32
    expression, so every bit agrees (as tests/test_q8_matmul_kernel.py
    holds the Pallas kernel to the XLA form). The JAX side is jitted, as
    the JAX package's sparse step runs it: the activation row scales are
    then amax * fp32(1/127)."""
    x, w = tile_data
    wq_j, sw_j = jq.quantize_weight(tp.to_jax(w, dtype))
    wq_p, sw_p = pq.quantize_weight(tp.to_torch(w, dtype))
    y_j = jax.jit(q8_matmul_t_fused)(tp.to_jax(x, dtype), wq_j, sw_j)
    y_p = pq.q8_matmul_t(tp.to_torch(x, dtype), wq_p, sw_p)
    assert y_p.dtype == tp.TORCH_DTYPES[dtype]
    np.testing.assert_array_equal(tp.np32(y_p), tp.np32(y_j))
    g = x[:, :512]
    g_j = jax.jit(q8_matmul_fused)(tp.to_jax(g, dtype), wq_j, sw_j)
    g_p = pq.q8_matmul(tp.to_torch(g, dtype), wq_p, sw_p)
    np.testing.assert_array_equal(tp.np32(g_p), tp.np32(g_j))


@pytest.mark.parametrize("t,k,o", [(37, 2064, 50), (5, 16, 3), (130, 1024, 257)])
def test_k4_plain_product_is_integer_exact(t, k, o):
    """The sliced fp32 product equals an int64 product, at ragged T and O,
    at the largest magnitudes (all +-127) and over more than one slice."""
    rng = np.random.default_rng(8)
    aq = rng.integers(-127, 128, (t, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (o, k)).astype(np.int8)
    aq[0], wq[0] = 127, -127
    got = k4._exact_int_product(torch.from_numpy(aq), torch.from_numpy(wq), contract_rows=False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), aq.astype(np.int64) @ wq.astype(np.int64).T)
    gq = rng.integers(-127, 128, (t, o)).astype(np.int8)
    got = k4._exact_int_product(torch.from_numpy(gq), torch.from_numpy(wq), contract_rows=True)
    np.testing.assert_array_equal(got.numpy(), gq.astype(np.int64) @ wq.astype(np.int64))
    sx = torch.from_numpy(rng.random((t, 1), dtype=np.float32))
    sw = torch.from_numpy(rng.random((o,), dtype=np.float32))
    y = k4.q8mm_t(torch.from_numpy(aq), sx, torch.from_numpy(wq), sw, torch.float32)
    want = (aq.astype(np.int64) @ wq.astype(np.int64).T).astype(np.float32) * sx.numpy() * sw.numpy()
    np.testing.assert_array_equal(y.numpy(), want)


def test_k4_and_k5_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((4, 32), dtype=torch.int8, device="meta")
    s = torch.empty((4, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k4.q8mm_t(q, s, q, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        k4.q8mm_g(q, s, torch.empty((32, 16), dtype=torch.int8, device="meta"))
    out = torch.empty((4, 256), device="meta")
    sched = k5.correction_schedule([0], [0], "meta")
    with pytest.raises(ValueError, match="no kernel"):
        k5.block_correction(out, out, torch.empty((1, 256, 256), device="meta"), sched)
    assert not any(k4.LAUNCHES.values()) and not any(k5.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the block correction
# ---------------------------------------------------------------------------

# repeated out blocks, a repeated in block, a repeated (o, i) pair, unsorted
IDX_OUT = (2, 0, 2, 1, 0, 2)
IDX_IN = (1, 0, 0, 1, 0, 1)


def _correction_inputs(t, dtype, seed=9):
    out = tp.seeded_normal((t, 3 * 256), seed=seed)
    src = tp.seeded_normal((t, 2 * 256), seed=seed + 1)
    delta = tp.seeded_normal((len(IDX_OUT), 256, 256), seed=seed + 2, scale=0.02)
    return out, src, delta


def test_correction_schedule_groups_by_out_block():
    s = k5.correction_schedule(IDX_OUT, IDX_IN, "cpu")
    assert s.n_runs == 3 and s.run_o.tolist() == [2, 0, 1]   # the longest run first
    assert s.run_start.tolist() == [0, 3, 5, 6]
    assert s.run_j.tolist() == [0, 2, 5, 1, 4, 3]      # stable within a run
    assert s.idx_in_dev.tolist() == list(IDX_IN) and s.run_o.dtype == torch.int32
    empty = k5.correction_schedule([], [], "cpu")
    assert empty.n_runs == 0 and empty.run_start.tolist() == [0]
    with pytest.raises(ValueError, match="differ in length"):
        k5.correction_schedule([0, 1], [0], "cpu")


@pytest.mark.parametrize("transpose", [False, True], ids=["D", "Dt"])
@pytest.mark.parametrize("t", [512, 70])
def test_k5_plain_matches_pallas_kernel_and_chain_fp32(t, transpose):
    """fp32: K5's plain version through the wrapper against the Pallas
    kernel in interpret mode (sorted by its static wrapper) and the
    sequential XLA chain, with repeated out blocks (tests/test_scan_ops.py's
    rtol 1e-5, atol 1e-5)."""
    out, src, delta = _correction_inputs(t, "fp32")
    mats = np.ascontiguousarray(delta.transpose(0, 2, 1)) if transpose else delta
    want_kernel = jax_block_correction(tp.to_jax(out), tp.to_jax(src), tp.to_jax(mats),
                                       IDX_OUT, IDX_IN)
    want_chain = jsl._dyn_correction(tp.to_jax(out), tp.to_jax(src), tp.to_jax(mats),
                                     jnp.asarray(IDX_OUT, jnp.int32),
                                     jnp.asarray(IDX_IN, jnp.int32))
    buf = tp.to_torch(out)
    got = k5.block_correction(buf, tp.to_torch(src), tp.to_torch(delta),
                              k5.correction_schedule(IDX_OUT, IDX_IN, "cpu"), transpose)
    assert got is buf                                   # in place
    tp.assert_close(got, want_kernel, rtol=1e-5, atol=1e-5)
    tp.assert_close(got, want_chain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("by", ["r", "c"])
def test_k5_plain_matches_grouped_correction_bf16(by):
    """bf16: one rounding per out block, as the JAX default
    (_grouped_correction: fp32 accumulation over a group, one cast). Both
    sum the same bf16 products in fp32, in another order, so they are equal
    or one bf16 ulp apart."""
    out, src, delta = _correction_inputs(64, "bf16")
    blocks = tuple(zip(IDX_OUT, IDX_IN)) if by == "r" else tuple(zip(IDX_IN, IDX_OUT))
    want = jsl._grouped_correction(tp.to_jax(out, "bf16"), tp.to_jax(src, "bf16"),
                                   tp.to_jax(delta, "bf16"), blocks, by,
                                   transpose_delta=(by == "r"))
    got = k5.block_correction(tp.to_torch(out, "bf16"), tp.to_torch(src, "bf16"),
                              tp.to_torch(delta, "bf16"),
                              k5.correction_schedule(IDX_OUT, IDX_IN, "cpu"), by == "r")
    assert got.dtype == torch.bfloat16
    tp.assert_close(got, want, rtol=2.0 ** -7, atol=1e-4)


def test_k5_no_coordinates_leaves_out_untouched():
    out, src, delta = _correction_inputs(8, "fp32")
    buf = tp.to_torch(out)
    got = k5.block_correction(buf, tp.to_torch(src), tp.to_torch(delta)[:0],
                              k5.correction_schedule([], [], "cpu"))
    assert got is buf and np.array_equal(got.numpy(), out)
