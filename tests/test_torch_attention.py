"""The port's fullk attention (K3) on the CPU, where its wrappers run the
plain versions, against the JAX fullk_attention (Pallas in interpret mode,
as tests/test_attention_kernel.py runs it): forward, the three gradients,
GQA geometries and right padding; the explicit backward formula against
autograd; the wrappers' refusals; and the trainer's right-padding guard.
Tolerances are the JAX suite's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops.pallas.attention import fullk_attention as jax_fullk
from sparse_matrix_tuning_tpu.parallel.mesh import set_compute_mesh
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
from sparse_matrix_tuning_tpu_torch.ops.attention import fullk_attention
from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

@pytest.fixture(scope="module", autouse=True)
def single_device_jax():
    """JAX's compute mesh reset before this module runs: a JAX SMTTrainer
    built on a mesh earlier in this process leaves it set (trainer.py:68)."""
    set_compute_mesh(None)


# fp16 is held to the bf16 bounds (it keeps 3 more mantissa bits)
FWD_TOL = {"fp32": (2e-6, 1e-5), "bf16": (2e-2, 1e-1), "fp16": (2e-2, 1e-1)}
GRAD_TOL = {"fp32": (1e-5, 1e-4), "bf16": (4e-2, 4e-1), "fp16": (4e-2, 4e-1)}


def _inputs(seed, b, s, hq, hkv, hd, dtype):
    """q, k, v and an output weight w from one numpy seed, for both
    frameworks: ((jax q, k, v), (torch q, k, v), w fp32)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd))]
    w = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    return ([tp.to_jax(a, dtype) for a in arrays],
            [tp.to_torch(a, dtype) for a in arrays], w)


def _sm(hd):
    return 1.0 / float(np.sqrt(hd))


def _port_grads(q, k, v, w, sm):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fullk_attention(*leaves, sm)
    (o.float() * torch.from_numpy(w)).sum().backward()
    return o, [t.grad for t in leaves]


def _jax_grads(q, k, v, w, sm):
    def loss(q, k, v):
        return jnp.sum(jax_fullk(q, k, v, sm).astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("s", [128, 192])  # aligned and ragged
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_fwd_matches_jax(s, dtype):
    b, hq, hkv, hd = 2, 4, 2, 64
    (jq, jk, jv), (q, k, v), _ = _inputs(0, b, s, hq, hkv, hd, dtype)
    got = fullk_attention(q, k, v, _sm(hd))
    assert got.shape == (b, s, hq, hd) and got.dtype == tp.TORCH_DTYPES[dtype]
    tp.assert_close(got, jax_fullk(jq, jk, jv, _sm(hd)), *FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_grads_match_jax(dtype):
    b, s, hq, hkv, hd = 2, 192, 4, 2, 64
    (jq, jk, jv), (q, k, v), w = _inputs(1, b, s, hq, hkv, hd, dtype)
    _, got = _port_grads(q, k, v, w, _sm(hd))
    want = _jax_grads(jq, jk, jv, w, _sm(hd))
    for g, wnt, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        tp.assert_close(g, wnt, *GRAD_TOL[dtype])


@pytest.mark.parametrize("hq,hkv,hd", [(4, 2, 64), (4, 1, 64), (2, 2, 128)],
                         ids=["gqa", "mqa", "mha-hd128"])
def test_gqa_geometries_match_jax(hq, hkv, hd):
    (jq, jk, jv), (q, k, v), w = _inputs(2, 1, 128, hq, hkv, hd, "fp32")
    o, got = _port_grads(q, k, v, w, _sm(hd))
    tp.assert_close(o, jax_fullk(jq, jk, jv, _sm(hd)), *FWD_TOL["fp32"])
    for g, wnt in zip(got, _jax_grads(jq, jk, jv, w, _sm(hd))):
        tp.assert_close(g, wnt, *GRAD_TOL["fp32"])


def test_right_padding_rows_match_unpadded():
    """Pad keys sit causally after every real query: the first s_real rows
    of a padded batch equal the unpadded result (the property that lets
    training skip the mask)."""
    b, s_real, pad, hq, hkv, hd = 1, 100, 28, 2, 1, 64
    _, (q, k, v), _ = _inputs(3, b, s_real, hq, hkv, hd, "fp32")
    padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v)]
    full = fullk_attention(*padded, _sm(hd))[:, :s_real]
    tp.assert_close(full, fullk_attention(q, k, v, _sm(hd)), 1e-6, 1e-6)


def test_bwd_plain_matches_autograd_of_fwd_plain():
    """The explicit backward formula (delta = rowsum(dO*O), dS = P(dP -
    delta)) equals autograd through the plain forward, and lse is the
    log-sum-exp of the causal scores (float64 numpy)."""
    b, s, hq, hkv, hd = 2, 70, 4, 2, 64
    _, (q, k, v), w = _inputs(4, b, s, hq, hkv, hd, "fp32")
    sm = _sm(hd)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = k3.attn_fwd_plain(*leaves, sm)
    (o * torch.from_numpy(w)).sum().backward()
    got = k3.attn_bwd_plain(q, k, v, o.detach(), lse.detach(), torch.from_numpy(w), sm)
    for g, x in zip(got, leaves):
        tp.assert_close(g, x.grad, *GRAD_TOL["fp32"])

    q64, k64 = q.double().numpy(), k.double().numpy()
    k64 = np.repeat(k64, hq // hkv, axis=2)  # head h reads kv-head h // g
    scores = np.einsum("bqhd,bkhd->bhqk", q64, k64) * sm
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    m = scores.max(-1, keepdims=True)
    want = (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrappers_on_cpu_run_plain_and_launch_nothing(monkeypatch):
    def no_build():
        raise AssertionError("nothing may be built for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(k3.LAUNCHES)
    _, (q, k, v), w = _inputs(5, 1, 64, 4, 2, 64, "bf16")
    o, grads = _port_grads(q, k, v, w, 0.125)
    o_plain, lse = k3.attn_fwd_plain(q, k, v, 0.125)
    assert torch.equal(o.detach(), o_plain)
    do = torch.from_numpy(w).to(torch.bfloat16)
    for g, want in zip(grads, k3.attn_bwd_plain(q, k, v, o_plain, lse, do, 0.125)):
        assert torch.equal(g, want)
    assert k3.LAUNCHES == before == {n: 0 for n in k3.LAUNCHES}


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("args,err,match", [
    ((_t(1, 8, 4, 96), _t(1, 8, 2, 96), _t(1, 8, 2, 96)), ValueError, "head_dim 96"),
    ((_t(1, 8, 3, 64), _t(1, 8, 2, 64), _t(1, 8, 2, 64)), ValueError, "multiple of"),
    ((_t(1, 8, 4, 64), _t(1, 8, 2, 64, dtype=torch.bfloat16), _t(1, 8, 2, 64)),
     TypeError, "bf16 or all fp32"),
    # fp16 is taken (its own bodies), but only all fp16
    ((_t(1, 8, 4, 64, dtype=torch.float16), _t(1, 8, 2, 64, dtype=torch.float16),
      _t(1, 8, 2, 64, dtype=torch.bfloat16)), TypeError, "all fp16"),
    ((_t(1, 8, 4, 64), _t(1, 9, 2, 64), _t(1, 9, 2, 64)), ValueError, "want q"),
    ((_t(1, 8, 4, 64, device="meta"), _t(1, 8, 2, 64, device="meta"),
      _t(1, 8, 2, 64, device="meta")), ValueError, "no kernel"),
], ids=["hd96", "hq-not-multiple", "mixed-dtypes", "fp16", "lengths-differ", "meta-device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(args, err, match):
    with pytest.raises(err, match=match):
        k3.attn_fwd(*args, 0.125)


def _guard_trainer(attn_impl):
    cfg_m = LlamaConfig.tiny(vocab_size=256)
    cfg = SMTConfig(data_path=["x"], model_name_or_path="m", dtype="fp32",
                    matrix_sparsity=True, full_ft_steps=2, attn_impl=attn_impl,
                    downsample_attention_blocks_ratio=0.05,
                    downsample_mlp_blocks_ratio=0.05, gradient_checkpointing=False)
    return SMTTrainer(cfg, cfg_m, init_params(cfg_m, seed=0), total_steps=4)


def test_left_padded_batch_rejected_for_fused_attention():
    """The fused kernel ignores the mask: a left-padded batch fails loudly
    at the trainer boundary; the einsum path, which honours the mask,
    accepts it."""
    batch = tp.lm_batches(1)[0]
    batch["attention_mask"][:, 0] = 0  # left padding
    with pytest.raises(ValueError, match="right-padded"):
        _guard_trainer("fullk").train_step(batch)
    assert np.isfinite(float(_guard_trainer("einsum").train_step(batch)["loss"]))
