"""K4's prologue, the row quantization (ops/cuda/row_quant.py), on the CPU:
its plain version, which the CUDA kernel equals bit for bit on the card
(chip_smoke.py), against `jax.jit` of the JAX package's row_quant, in both
forms: row_quant(x) and the g form's fold row_quant(g.astype(f32) * sw),
bf16 and fp32, row magnitudes 1e-2 to 10, rows of zeros and rows whose
values over the scale sit exactly on .5 ties (round half to even in both),
and rows holding a NaN or an inf. Also the cached reciprocal (no device copy per call) and the wrapper's
refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops import quant as jq
from sparse_matrix_tuning_tpu_torch.ops import quant as pq
from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq


def _rows(t, k, dtype, seed, fold):
    """(x (T, K) in dtype as numpy fp32, sw (K,) fp32 or None): magnitudes
    1e-2 to 10 by row, row 0 zeros, every fourth row from row 3 on .5 ties
    (max 127 * 2^e, the rest (j + 0.5) * 2^e; with the fold, sw powers of
    two so x * sw stays exact)."""
    rng = np.random.default_rng(seed)
    sw = np.exp2(rng.integers(-10, -4, k)).astype(np.float32) if fold else None
    x = (rng.standard_normal((t, k)) * 10.0 ** rng.uniform(-2, 1, (t, 1))).astype(np.float32)
    for r in range(3, t, 4):
        e = float(rng.integers(-12, -2))
        row = (rng.integers(-127, 127, k) + 0.5) * 2.0 ** e
        row[0] = 127 * 2.0 ** e
        x[r] = row / (sw if fold else 1.0)
    x[0] = 0
    x = tp.np32(tp.to_torch(x, dtype).float())  # representable in dtype
    return x, sw


def _ties(x, sw, sx):
    v = x.astype(np.float32) * (sw if sw is not None else np.float32(1))
    return int((np.abs(np.modf(v / sx)[0]) == 0.5).sum())


@pytest.mark.parametrize("dtype", ["bf16", "fp32", "fp16"])
@pytest.mark.parametrize("t,k", [(64, 256), (37, 100)])
def test_fold_quantization_equals_jitted_jax(t, k, dtype):
    """The g form: row_quant(g * sw) equals jax.jit of the JAX twin's
    row_quant(g.astype(f32) * sw) bit for bit, values and scales."""
    x, sw = _rows(t, k, dtype, seed=t + k, fold=True)
    xq_j, sx_j = jax.jit(lambda g, s: jq.row_quant(g.astype(jnp.float32) * s))(
        tp.to_jax(x, dtype), jnp.asarray(sw))
    xt = tp.to_torch(x, dtype)
    for xq_p, sx_p in (rq.row_quant(xt, torch.from_numpy(sw)),
                       pq.row_quant(xt, torch.from_numpy(sw))):
        np.testing.assert_array_equal(xq_p.numpy(), np.asarray(xq_j))
        np.testing.assert_array_equal(sx_p.numpy(), np.asarray(sx_j))
    assert _ties(x, sw, np.asarray(sx_j)) > 0


@pytest.mark.parametrize("dtype", ["bf16", "fp32", "fp16"])
def test_ties_round_half_to_even_as_jitted_jax(dtype):
    """row_quant over rows built on .5 ties: the same values as jax.jit."""
    x, _ = _rows(48, 128, dtype, seed=3, fold=False)
    xq_j, sx_j = jax.jit(jq.row_quant)(tp.to_jax(x, dtype))
    xq_p, sx_p = rq.row_quant(tp.to_torch(x, dtype))
    np.testing.assert_array_equal(xq_p.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx_p.numpy(), np.asarray(sx_j))
    assert _ties(x, None, np.asarray(sx_j)) > 100
    assert (xq_p[0] == 0).all() and float(sx_p[0]) == np.float32(1e-8) * np.float32(1 / 127)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "fp32", "fp16"])
def test_nan_and_inf_rows_as_jitted_jax(dtype, fold):
    """A NaN in a row makes its scale NaN and an inf makes it inf, and the
    row's int8 values 0, as jax.jit of the JAX twin gives them (the card's
    kernel is held to the plain version on such rows, chip_smoke.py)."""
    x, sw = _rows(12, 96, dtype, seed=5, fold=fold)
    x[1, 40], x[2, 7], x[5, 95] = np.nan, np.inf, -np.inf
    if fold:
        fn = jax.jit(lambda g, s: jq.row_quant(g.astype(jnp.float32) * s))
        xq_j, sx_j = fn(tp.to_jax(x, dtype), jnp.asarray(sw))
        xq_p, sx_p = rq.row_quant(tp.to_torch(x, dtype), torch.from_numpy(sw))
    else:
        xq_j, sx_j = jax.jit(jq.row_quant)(tp.to_jax(x, dtype))
        xq_p, sx_p = rq.row_quant(tp.to_torch(x, dtype))
    np.testing.assert_array_equal(xq_p.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx_p.numpy(), np.asarray(sx_j))  # NaN matches NaN
    assert np.isnan(sx_p[1, 0].item()) and np.isinf(sx_p[[2, 5], 0].numpy()).all()
    assert np.isfinite(np.delete(sx_p.numpy(), [1, 2, 5], axis=0)).all()
    assert (xq_p[[1, 2, 5]] == 0).all()


def test_division_scale_is_not_the_jitted_one():
    """amax / 127 (what an eager division gives) differs from the jitted
    scale on some rows: the check the card's planted fault relies on."""
    x, _ = _rows(512, 64, "fp32", seed=4, fold=False)
    _, sx = rq.row_quant(torch.from_numpy(x))
    div = torch.clamp(torch.from_numpy(x).abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    assert int((div != sx).sum()) > 0


def test_reciprocal_is_made_once_per_device():
    a = rq.reciprocal(127.0, "cpu")
    assert rq.reciprocal(127.0, torch.device("cpu")) is a
    assert a.dtype == torch.float32 and float(a) == np.float32(1 / 127)
    assert rq.reciprocal(7.0, "cpu") is not a
    x = torch.randn(5, 3)
    assert torch.equal(pq._over(x, 7.0, reciprocal=True), x * torch.tensor(np.float32(1 / 7)))


def test_row_quant_refusals():
    with pytest.raises(ValueError, match="no kernel"):
        rq.row_quant(torch.empty((4, 32), dtype=torch.bfloat16, device="meta"))
    bad = [
        (torch.zeros((4, 32), dtype=torch.int8), None, TypeError),
        (torch.zeros((4, 32), dtype=torch.float64), None, TypeError),
        (torch.zeros((2, 4, 32)), None, ValueError),
        (torch.zeros((32, 4)).t(), None, ValueError),
        (torch.zeros((4, 32)), torch.ones(31), ValueError),
        (torch.zeros((4, 32)), torch.ones(32, dtype=torch.float64), ValueError),
        (torch.zeros((4, 32)), torch.ones(64)[::2], ValueError),
    ]
    for x, sw, err in bad:
        with pytest.raises(err):
            rq._validate(x, sw)
    rq._validate(torch.zeros((4, 32), dtype=torch.bfloat16), torch.ones(32))
    rq._validate(torch.zeros((4, 32), dtype=torch.float16), torch.ones(32))
    assert not any(rq.LAUNCHES.values())
