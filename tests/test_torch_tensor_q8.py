"""The int8 base and head under the tensor axis (`--frozen_quant int8` on
`--mesh_shape D,F,T`, T > 1) without a spawn: T ranks run as threads, the
tensor group's all-reduce replaced by one over the threads
(tests/test_torch_tensor.py's harness), inputs from numpy seeds.

  * the split row quantization (each rank's row amax, their MAX over the
    group as int32 bit patterns, the quantization with it) equals the
    fused one on the whole row bit for bit, NaN and inf rows included; a
    rank-local amax does not;
  * q8_matmul_t / q8_matmul in their tensor forms (a row-parallel forward,
    a column-parallel backward) over two- and three-part rows, the ranks'
    partial sums added in rank order, against the JAX package's
    ops/quant.py on the whole row (fp32 1e-6 of the largest entry, bf16
    2^-7 of it: the partials are rounded to the output dtype before the
    sum, where JAX sums int32);
  * smt_linear_q8 on each rank's window of blocks (K5's and K1's plain
    versions, zero-padded panels where a block straddles the slice, and a
    rank whose window holds no block) and frozen_q8_linear against one
    process (fp32, 1e-5);
  * the int8 head over each rank's vocabulary rows, in both loss forms, at
    V/T not a multiple of the chunk: loss and grad_hidden against
    jax.grad of the JAX package's chunked_causal_lm_loss_q8 (and of its
    frozen_q8_linear head with causal_lm_loss for the full form).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_tensor import _on_threads

from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import (
    row_amax_plain, row_quant_amax_plain, row_quant_plain)
from sparse_matrix_tuning_tpu_torch.ops.quant import (
    q8_matmul, q8_matmul_t, quantize_weight, row_quant)


def _nan_equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _rows(dtype, k=96, seed=0):
    """Rows of assorted scales; row 2 has a NaN in its last third, row 3 an
    inf in its first third, row 4 a -inf in its middle, row 5 is zero, row
    6 holds .5 ties of the quotient, row 7 its largest entry in the last
    third only."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, k)).astype(np.float32) * np.array(
        [1, 3e-3, 2, 5, 1, 1, 1, 1], np.float32)[:, None]
    x[2, k - 3] = np.nan
    x[3, 1] = np.inf
    x[4, k // 2] = -np.inf
    x[5] = 0
    x[6] = (np.arange(k) % 5 - 2) * 0.5 * 127 / 2 / 127
    x[6, 0] = 1.0
    x[7, : 2 * k // 3] *= 0.01
    return tp.to_torch(x, dtype)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("fold", [False, True], ids=["x", "x*sw"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_split_row_quant_equals_fused(parts, fold, dtype, monkeypatch):
    """row_quant(part, tensor=mesh) on each rank's columns: the int8 values
    concatenate to row_quant of the whole row, and every rank's scale is
    the whole row's, bit for bit (NaN where a NaN lies in any part, inf
    where an inf does); the plain twins compose to the fused plain version;
    a rank-local amax gives other values on the rows whose amax lies in
    another part."""
    x = _rows(dtype)
    sw = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 2, 96).astype(np.float32)) \
        if fold else None
    want_q, want_s = row_quant_plain(x, sw)
    _nan_equal(row_quant_amax_plain(x, row_amax_plain(x, sw), sw)[0], want_q)
    _nan_equal(row_quant_amax_plain(x, row_amax_plain(x, sw), sw)[1], want_s)
    cols = list(torch.arange(96).chunk(parts))

    def rank(mesh):
        c = cols[mesh.tensor_index]
        part = x[:, c].contiguous()
        swp = None if sw is None else sw[c].contiguous()
        return row_quant(part, swp, tensor=mesh), row_quant(part, swp)

    got = _on_threads(parts, monkeypatch, rank)
    _nan_equal(torch.cat([q for (q, _), _ in got], 1), want_q)
    for (_, s), _ in got:
        _nan_equal(s, want_s)
    assert torch.isnan(want_s[2]).all() and torch.isinf(want_s[3]).all()
    local = torch.cat([q for _, (q, _) in got], 1)
    assert not torch.equal(local[7], want_q[7])


def test_row_quant_takes_amax_or_tensor_not_both(monkeypatch):
    """A whole-row scale comes one way: a given amax, or the MAX over the
    tensor group; both at once are refused, not one silently dropped."""
    x = _rows("fp32")

    def rank(mesh):
        with pytest.raises(ValueError, match="not both"):
            row_quant(x, tensor=mesh, amax=row_amax_plain(x))
        with pytest.raises(ValueError, match="not both"):
            q8_matmul(x, *quantize_weight(torch.ones((96, 8))), tensor=mesh,
                      amax=row_amax_plain(x))

    _on_threads(2, monkeypatch, rank)


def _q8_inputs(dtype, o=192, i=256, seed=0):
    x = tp.seeded_normal((3, 10, i), seed)
    g = tp.seeded_normal((3, 10, o), seed + 1)
    wq, sw = quantize_weight(torch.from_numpy(tp.seeded_normal((o, i), seed + 2, 0.05)))
    return tp.to_torch(x, dtype), tp.to_torch(g, dtype), wq, sw


def _bound(want, dtype):
    scale = 1e-6 if dtype == "fp32" else 2.0 ** -7
    return dict(rtol=0, atol=scale * float(want.abs().max()))


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tensor_q8_matmuls_match_jax(parts, dtype, monkeypatch):
    """The row-parallel forward (each rank x's columns and wq's, sw whole)
    and the column-parallel backward (each rank g's columns and wq / sw's
    rows): the ranks' partial sums, added in rank order as the all-reduce
    adds them, equal the JAX package's q8_matmul_t / q8_matmul on the whole
    row within the bounds of the module notes; in fp32, with rank-local
    amaxes, the gap is over ten times larger."""
    from sparse_matrix_tuning_tpu.ops.quant import q8_matmul as jax_q8_g
    from sparse_matrix_tuning_tpu.ops.quant import q8_matmul_t as jax_q8_t
    x, g, wq, sw = _q8_inputs(dtype)
    jdt = tp.JAX_DTYPES[dtype]
    want_t = torch.from_numpy(tp.np32(jax_q8_t(jnp.asarray(tp.np32(x), jdt), jnp.asarray(wq),
                                               jnp.asarray(sw))))
    want_g = torch.from_numpy(tp.np32(jax_q8_g(jnp.asarray(tp.np32(g), jdt), jnp.asarray(wq),
                                               jnp.asarray(sw))))
    i_cols, o_rows = torch.arange(256).chunk(parts), torch.arange(192).chunk(parts)

    def rank(mesh, tensor=True):
        c, r = i_cols[mesh.tensor_index], o_rows[mesh.tensor_index]
        m = mesh if tensor else None
        return (q8_matmul_t(x[..., c], wq[:, c].contiguous(), sw, tensor=m),
                q8_matmul(g[..., r], wq[r].contiguous(), sw[r].contiguous(), tensor=m))

    for tensor in (True, False) if dtype == "fp32" else (True,):
        got = _on_threads(parts, monkeypatch, lambda mesh: rank(mesh, tensor))
        sum_t, sum_g = got[0]
        for yt, yg in got[1:]:
            sum_t, sum_g = sum_t + yt, sum_g + yg
        if tensor:
            torch.testing.assert_close(sum_t.float(), want_t, **_bound(want_t, dtype))
            torch.testing.assert_close(sum_g.float(), want_g, **_bound(want_g, dtype))
        else:
            for got_sum, want in ((sum_t, want_t), (sum_g, want_g)):
                gap = float((got_sum.float() - want).abs().max())
                assert gap > 10 * _bound(want, dtype)["atol"], gap


def _q8_layer(module, t, blocks):
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    lp = LinearPlan(module, 0, 768, 768, blocks=blocks)
    plan = SMTPlan("matrix", {"0.q": lp})
    w = torch.from_numpy(tp.seeded_normal((768, 768), 5, 0.05))
    wq, sw = quantize_weight(w)
    n = len(blocks)
    rb, cb = plan.block_index("0.q", "cpu")
    wq4 = wq.reshape(3, 256, 3, 256)
    base = (wq4[rb, :, cb, :].float() * sw.reshape(3, 256)[rb][:, :, None]).contiguous()
    trained = base + torch.from_numpy(tp.seeded_normal((n, 256, 256), 7, 0.02))
    return lp, plan, wq, sw, base, trained


@pytest.mark.parametrize("module,t,blocks", [
    ("q_proj", 2, ((2, 1), (0, 0), (1, 2), (2, 2), (1, 0))),
    ("q_proj", 3, ((2, 1), (0, 0), (1, 2), (2, 2), (1, 0))),
    ("down_proj", 2, ((2, 1), (0, 0), (1, 2), (2, 2), (1, 0))),
    ("down_proj", 4, ((2, 1), (0, 0), (1, 2), (2, 2), (1, 0))),
    ("q_proj", 2, ((0, 0), (0, 2))),
    ("down_proj", 3, ((0, 0), (2, 0))),
], ids=["col-t2", "col-t3", "row-t2", "row-t4", "col-empty-rank", "row-empty-rank"])
def test_windowed_q8_linear_matches_one_process(module, t, blocks, monkeypatch):
    """smt_linear_q8 on each tensor rank's slice of a 768-wide int8 weight
    (its output rows or input columns: 384, 256 or 192 wide, so blocks
    straddle the slices; in the "empty" cases a rank's window holds no
    block): the outputs concatenate (or sum) to one process's, the grad_x
    parts sum (or concatenate) to its grad_x, and the ranks' block grads
    sum to its block grads (fp32, 1e-5); outputs and grad_x are
    contiguous (K3 takes only contiguous q/k/v, and v is not copied by
    RoPE)."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import smt_linear_q8
    lp, plan, wq, sw, base, trained = _q8_layer(module, t, blocks)
    x = torch.from_numpy(tp.seeded_normal((3, 10, 768), 6))
    g = torch.from_numpy(tp.seeded_normal((3, 10, 768), 8))
    bw = trained.clone().requires_grad_(True)
    xw = x.clone().requires_grad_(True)
    y = smt_linear_q8(xw, bw, wq, sw, base, lp)
    (y * g).sum().backward()
    col = module == "q_proj"

    def rank(mesh):
        i = mesh.tensor_index
        window, first = plan.tensor_window("0.q", "cpu", i, t)
        rows = torch.arange(768).chunk(t)[i]
        wqi = wq[rows] if col else wq[:, rows]
        swi = sw[rows] if col else sw
        xi = (x if col else x[..., rows]).clone().requires_grad_(True)
        bi = trained.clone().requires_grad_(True)
        yi = smt_linear_q8(xi, bi, wqi.contiguous(), swi.contiguous(), base, lp,
                           schedules=plan.tensor_q8_schedules("0.q", "cpu", i, t),
                           tensor=(mesh, window, first))
        (yi * (g[..., rows] if col else g)).sum().backward()
        assert yi.is_contiguous() and xi.grad.is_contiguous()
        return yi.detach(), xi.grad, bi.grad, window

    got = _on_threads(t, monkeypatch, rank)
    outs, grad_x, grads, windows = zip(*got)
    if len(blocks) == 2:
        assert any(w is None for w in windows)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(outs, -1) if col else sum(outs), y.detach(), **tol)
    torch.testing.assert_close(sum(grad_x) if col else torch.cat(grad_x, -1), xw.grad, **tol)
    torch.testing.assert_close(sum(grads), bw.grad, **tol)
    for gr, w in zip(grads, windows):
        touched = set() if w is None else set(w[0].tolist())
        assert all(not gr[j].any() for j in range(len(blocks)) if j not in touched)


@pytest.mark.parametrize("split", ["out", "in"])
def test_frozen_q8_linear_tensor_forms_match_one_process(split, monkeypatch):
    """frozen_q8_linear on each rank's output rows ("out", its g * sw row
    quantized over the whole row in the backward) or input columns ("in",
    its x row over the whole row in the forward): outputs and grad_x parts
    combine to one process's (fp32, 1e-5)."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import frozen_q8_linear
    x, g, wq, sw = _q8_inputs("fp32")
    xw = x.clone().requires_grad_(True)
    y = frozen_q8_linear(xw, wq, sw)
    (y * g).sum().backward()
    out = split == "out"

    def rank(mesh):
        part = (torch.arange(192) if out else torch.arange(256)).chunk(2)[mesh.tensor_index]
        xi = (x if out else x[..., part]).clone().requires_grad_(True)
        yi = frozen_q8_linear(xi, (wq[part] if out else wq[:, part]).contiguous(),
                              (sw[part] if out else sw).contiguous(), mesh, split)
        (yi * (g[..., part] if out else g)).sum().backward()
        return yi.detach(), xi.grad

    outs, grad_x = zip(*_on_threads(2, monkeypatch, rank))
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(outs, -1) if out else sum(outs), y.detach(), **tol)
    torch.testing.assert_close(sum(grad_x) if out else torch.cat(grad_x, -1), xw.grad, **tol)


def _head_inputs(v, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 17, 64)).astype(np.float32)
    wq, sw = quantize_weight(torch.from_numpy(rng.standard_normal((v, 64)).astype(np.float32)
                                              * 0.2))
    labels = rng.integers(0, v, (2, 17))
    labels[1, 9:] = -100
    return h, wq, sw, labels


# the int8 head's grad_hidden against JAX's: the ranks' fp32 parts summed
# (JAX sums each chunk's int32 product, then scales it) and the chunks in
# another order; measured worst 2.4e-7 of the largest entry. A rank-local
# chunk grid (each rank's chunks from its first row) quantizes other groups
# of g * sw and misses by 1.1e-2 of it.
HEAD_GRAD_ATOL = 1e-6


@pytest.mark.parametrize("form", ["chunked", "full"])
@pytest.mark.parametrize("t,v,chunk", [(2, 384, 128), (3, 384, 96)], ids=["t2", "t3"])
def test_q8_head_over_vocab_rows_matches_jax(form, t, v, chunk, monkeypatch):
    """The int8 head on each rank's V/T vocabulary rows, V/T not a multiple
    of the chunk (a global chunk straddles every rank boundary): the loss
    (rtol 1e-6) and grad_hidden (each rank's part summed over the group by
    to_tensor_region; HEAD_GRAD_ATOL of its largest entry) against jax.grad
    of the JAX package's chunked_causal_lm_loss_q8 ("chunked") or of its
    frozen_q8_linear head with causal_lm_loss ("full"), on every rank."""
    from sparse_matrix_tuning_tpu.models.llama import causal_lm_loss as jax_ce
    from sparse_matrix_tuning_tpu.ops.loss import chunked_causal_lm_loss_q8 as jax_q8_loss
    from sparse_matrix_tuning_tpu.ops.sparse_linear import frozen_q8_linear as jax_frozen_q8
    from sparse_matrix_tuning_tpu_torch.ops.loss import (
        chunked_causal_lm_loss_q8, vocab_parallel_causal_lm_loss)
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import frozen_q8_linear
    from sparse_matrix_tuning_tpu_torch.parallel.tensor import to_tensor_region
    h, wq, sw, labels = _head_inputs(v)
    jwq, jsw, jlab = jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(labels)
    if form == "chunked":
        def jax_loss(a):
            return jax_q8_loss(a, jwq, jsw, jlab, chunk)
    else:
        def jax_loss(a):
            return jax_ce(jax_frozen_q8(a, jwq, jsw), jlab)
    want_loss, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(h))
    want_g = torch.from_numpy(tp.np32(want_g))

    def rank(mesh):
        rows = torch.arange(v).chunk(t)[mesh.tensor_index]
        wqi, swi = wq[rows].contiguous(), sw[rows].contiguous()
        hi = torch.from_numpy(h).requires_grad_(True)
        lab = torch.from_numpy(labels)
        if form == "chunked":
            loss = chunked_causal_lm_loss_q8(hi, wqi, swi, lab, chunk, tensor=mesh)
        else:
            logits = frozen_q8_linear(to_tensor_region(hi, mesh), wqi, swi, mesh, "out")
            loss = vocab_parallel_causal_lm_loss(logits, lab, mesh)
        loss.backward()
        return loss.detach(), hi.grad

    for loss, gh in _on_threads(t, monkeypatch, rank):
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
        torch.testing.assert_close(gh, want_g, rtol=0,
                                   atol=HEAD_GRAD_ATOL * float(want_g.abs().max()))
