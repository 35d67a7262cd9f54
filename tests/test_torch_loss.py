"""The port's chunked-vocabulary cross-entropy (ops/loss.py) and its loss
policy (train/steps.py _use_chunked_loss) against the JAX package, at fp32
as tests/test_loss.py holds the JAX one: loss and gradients, ragged last
chunk, ignored labels, the int8 head."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.ops import loss as jloss
from sparse_matrix_tuning_tpu.ops import quant as jq
from sparse_matrix_tuning_tpu.train import steps as jsteps
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, causal_lm_loss
from sparse_matrix_tuning_tpu_torch.ops import loss as ploss
from sparse_matrix_tuning_tpu_torch.ops import quant as pq
from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import frozen_q8_linear
from sparse_matrix_tuning_tpu_torch.train import steps as psteps

B, S, D = 3, 17, 64


def _inputs(v, seed=0):
    rng = np.random.default_rng(seed)
    hidden = tp.seeded_normal((B, S, D), seed=seed + 1)
    head = tp.seeded_normal((v, D), seed=seed + 2, scale=0.2)
    labels = rng.integers(0, v, (B, S)).astype(np.int32)
    labels[:, :4] = -100
    labels[1, 9:] = -100   # a right-padded row
    labels[0, 5] = v - 1   # a target in the (ragged) last chunk
    return hidden, head, labels


# vocab 200 over chunks of 64: three whole chunks and a ragged one of 8
@pytest.mark.parametrize("v,chunk", [(200, 64), (256, 64), (100, 4096)])
def test_chunked_loss_and_grads_match_jax(v, chunk):
    hidden, head, labels = _inputs(v)
    loss_j, (gh_j, gw_j) = jax.value_and_grad(
        lambda h, w: jloss.chunked_causal_lm_loss(h, w, jnp.asarray(labels), chunk),
        argnums=(0, 1))(tp.to_jax(hidden), tp.to_jax(head))
    h = tp.to_torch(hidden).requires_grad_()
    w = tp.to_torch(head).requires_grad_()
    loss = ploss.chunked_causal_lm_loss(h, w, torch.from_numpy(labels), chunk)
    loss.backward()
    # fp32, the same online log-sum-exp; tests/test_loss.py holds the JAX
    # chunked loss to the dense one at rtol 1e-5 (loss) and 1e-4 (grads)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    tp.assert_close(h.grad, gh_j, rtol=1e-4, atol=1e-6)
    tp.assert_close(w.grad, gw_j, rtol=1e-4, atol=1e-6)
    assert float(h.grad[:, -1].abs().max()) == 0.0  # the last position predicts nothing

    # and it is the dense shifted cross-entropy of the port
    h2 = tp.to_torch(hidden).requires_grad_()
    w2 = tp.to_torch(head).requires_grad_()
    dense = causal_lm_loss(torch.matmul(h2, w2.t()), torch.from_numpy(labels))
    dense.backward()
    assert float(loss) == pytest.approx(float(dense), rel=1e-5)
    tp.assert_close(h.grad, h2.grad, rtol=1e-4, atol=1e-6)
    tp.assert_close(w.grad, w2.grad, rtol=1e-4, atol=1e-6)


def test_chunked_loss_fp16_scaled_matches_jax():
    """--dtype fp16's warm-up at a large vocabulary: the chunked loss over
    fp16 hidden states and head, times a loss scale, and its fp16 grads
    against the JAX twin under jit. Both take fp32 logits from the fp16
    products; JAX's scan adds each chunk's fp16 grad_h into an fp16 carry,
    the port sums the chunks in fp32 and rounds once, so grad_h parts by at
    most one fp16 half-ulp per chunk (4 chunks: 2^-9 of the largest
    |grad|); grad_head is one product per chunk in both (one rounding)."""
    hidden, head, labels = _inputs(200, seed=3)
    scale = 2.0 ** 12
    loss_j, (gh_j, gw_j) = jax.jit(jax.value_and_grad(
        lambda h, w: jloss.chunked_causal_lm_loss(h, w, jnp.asarray(labels), 64) * scale,
        argnums=(0, 1)))(tp.to_jax(hidden, "fp16"), tp.to_jax(head, "fp16"))
    h = tp.to_torch(hidden, "fp16").requires_grad_()
    w = tp.to_torch(head, "fp16").requires_grad_()
    loss = ploss.chunked_causal_lm_loss(h, w, torch.from_numpy(labels), 64) * scale
    loss.backward()
    assert h.grad.dtype == w.grad.dtype == torch.float16
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    tp.assert_close(h.grad, gh_j, rtol=0, atol=2.0 ** -9 * float(np.abs(tp.np32(gh_j)).max()))
    tp.assert_close(w.grad, gw_j, rtol=2.0 ** -10, atol=2.0 ** -10 * float(
        np.abs(tp.np32(gw_j)).max()))


def test_chunked_loss_all_labels_ignored_is_zero():
    hidden, head, labels = _inputs(128)
    loss = ploss.chunked_causal_lm_loss(tp.to_torch(hidden), tp.to_torch(head),
                                        torch.full((B, S), -100), 64)
    assert float(loss) == 0.0


@pytest.mark.parametrize("v,chunk", [(200, 64), (256, 128)])
def test_chunked_q8_loss_and_grad_match_jax(v, chunk):
    """The int8 head: hidden row-quantized once, every chunk's logits one
    exact int8 product; grad_hidden is the straight-through int8
    grad_input, row-quantized per chunk on both sides. The int8 rounding of
    a chunk's cotangent can flip where the two frameworks' fp32 softmax
    differ in the last bit, so the gradient is held to 1e-3 of its largest
    element, the loss to 1e-5."""
    hidden, head, labels = _inputs(v, seed=3)
    wq_j, sw_j = jq.quantize_weight(tp.to_jax(head))
    loss_j, gh_j = jax.value_and_grad(
        lambda h: jloss.chunked_causal_lm_loss_q8(h, wq_j, sw_j, jnp.asarray(labels), chunk)
    )(tp.to_jax(hidden))
    wq, sw = pq.quantize_weight(tp.to_torch(head))
    h = tp.to_torch(hidden).requires_grad_()
    loss = ploss.chunked_causal_lm_loss_q8(h, wq, sw, torch.from_numpy(labels), chunk)
    loss.backward()
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    scale = float(np.abs(np.asarray(gh_j)).max())
    tp.assert_close(h.grad, gh_j, rtol=0, atol=1e-3 * scale)
    assert float(h.grad.abs().max()) > 0

    # the dense q8 head gives the same logits bit for bit: the two q8
    # losses agree to fp32 reduction order
    h2 = tp.to_torch(hidden).requires_grad_()
    dense = causal_lm_loss(frozen_q8_linear(h2.float(), wq, sw), torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(dense), rel=1e-6)


@pytest.mark.parametrize("loss_impl", ["auto", "full", "chunked"])
@pytest.mark.parametrize("vocab", [256, 16384, 32000, 128256])
def test_loss_policy_matches_jax(loss_impl, vocab):
    """_use_chunked_loss per phase: chunked in the warm-up from a
    vocabulary of 16384, in the sparse phase only when the fp32 logits
    outgrow 2 GiB."""
    jcfg, pcfg = JaxSMTConfig(loss_impl=loss_impl), SMTConfig(loss_impl=loss_impl)
    assert pcfg.loss_impl == loss_impl  # "auto" is resolved per phase, not in the config
    jm, pm = JaxLlamaConfig(vocab_size=vocab), LlamaConfig(vocab_size=vocab)
    for sparse in (False, True):
        for tokens in (None, 4 * 511, 16 * 2047):
            assert psteps._use_chunked_loss(pcfg, pm, sparse=sparse, batch_tokens=tokens) == \
                jsteps._use_chunked_loss(jcfg, jm, sparse=sparse, batch_tokens=tokens)
    assert psteps._SPARSE_DENSE_LOSS_BUDGET == jsteps._SPARSE_DENSE_LOSS_BUDGET
