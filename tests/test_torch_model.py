"""The port's Llama training forward and loss against the JAX model on
LlamaConfig.tiny, with the JAX weights carried across by params_from_jax,
right-padded masks, fp32 — at tests/test_model.py's tolerance (2e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu_torch.models import llama

JAX_CFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
TOL = 2e-4


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, tp.port_params(jp)


def _inputs(seed=0, b=2, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0  # right padding
    labels = ids.copy()
    labels[:, :3] = -100
    labels[1, 9:] = -100
    return ids, mask, labels


def test_config_matches_jax():
    assert CFG.to_hf() == JAX_CFG.to_hf()
    assert llama.LlamaConfig() == llama.LlamaConfig.from_hf(jllama.LlamaConfig().to_hf())
    assert llama.LlamaConfig().to_hf() == jllama.LlamaConfig().to_hf()  # TinyLlama-1.1B


def test_logits_and_loss_match_jax(weights):
    jp, pp = weights
    ids, mask, labels = _inputs()
    want = jllama.forward(jp, jnp.asarray(ids), JAX_CFG, attention_mask=jnp.asarray(mask))
    got = llama.forward(pp, torch.from_numpy(ids).long(), CFG,
                        attention_mask=torch.from_numpy(mask))
    assert got.shape == (2, 12, CFG.vocab_size) and got.dtype == torch.float32
    tp.assert_close(got[0], want[0], TOL, TOL)
    tp.assert_close(got[1, :9], want[1, :9], TOL, TOL)  # non-pad positions
    loss_j = jllama.causal_lm_loss(want, jnp.asarray(labels))
    loss_p = llama.causal_lm_loss(got, torch.from_numpy(labels))
    assert float(loss_p) == pytest.approx(float(loss_j), rel=1e-4)
    all_ignored = torch.full((2, 12), -100)
    assert float(llama.causal_lm_loss(got, all_ignored)) == 0.0


def test_qwen2_bias_and_tied_head_match_jax():
    cfg_j = jllama.LlamaConfig(**{**JAX_CFG.__dict__, "tie_word_embeddings": True})
    cfg_p = llama.LlamaConfig(**{**CFG.__dict__, "tie_word_embeddings": True})
    jp = jllama.init_params(jax.random.PRNGKey(1), cfg_j)
    for m, n in (("q_proj", 256), ("k_proj", 128), ("v_proj", 128)):
        jp["layers"]["0"][f"{m}_bias"] = jnp.asarray(tp.seeded_normal((n,), len(m), 0.1))
    pp = tp.port_params(jp)
    assert "lm_head" not in pp
    ids, mask, _ = _inputs(seed=3)
    want = jllama.forward(jp, jnp.asarray(ids), cfg_j, attention_mask=jnp.asarray(mask))
    got = llama.forward(pp, torch.from_numpy(ids).long(), cfg_p,
                        attention_mask=torch.from_numpy(mask))
    tp.assert_close(got[0], want[0], TOL, TOL)


def test_remat_and_stop_grad(weights):
    """Checkpointed layers give the same logits and gradients as plain ones;
    stop_grad_below_layer cuts autograd below that layer."""
    _, pp = weights
    ids, mask, labels = _inputs(seed=2)

    def grads(remat, stop=None):
        params = llama.tree_map(lambda t: t.detach().clone().requires_grad_(True), pp)
        loss = llama.causal_lm_loss(
            llama.forward(params, torch.from_numpy(ids).long(), CFG,
                          attention_mask=torch.from_numpy(mask), remat=remat,
                          stop_grad_below_layer=stop), torch.from_numpy(labels))
        loss.backward()
        return loss, params

    l0, p0 = grads(False)
    l1, p1 = grads(True)
    assert torch.equal(l0, l1)
    torch.testing.assert_close(p1["layers"]["0"]["q_proj"].grad,
                               p0["layers"]["0"]["q_proj"].grad, rtol=1e-6, atol=1e-8)
    _, p2 = grads(True, stop=1)
    assert p2["layers"]["0"]["q_proj"].grad is None
    assert p2["embed_tokens"].grad is None
    assert p2["layers"]["1"]["q_proj"].grad is not None


def test_param_shapes_match_jax(weights):
    jp, pp = weights
    assert llama.target_module_dims(pp) == jllama.target_module_dims(jp)
    assert llama.all_2d_param_shapes(pp) == [tuple(s) for s in jllama.all_2d_param_shapes(jp)]
    mine = llama.init_params(CFG, seed=0)
    shapes_j = {k: tuple(v.shape) for k, v in tp.port_params(jp).items() if k != "layers"}
    assert {k: tuple(v.shape) for k, v in mine.items() if k != "layers"} == shapes_j
    assert {k: tuple(v.shape) for k, v in mine["layers"]["1"].items()} == \
        {k: tuple(v.shape) for k, v in pp["layers"]["1"].items()}
    assert torch.equal(llama.init_params(CFG, seed=0)["lm_head"], mine["lm_head"])
