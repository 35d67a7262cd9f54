"""Attention dropout (--dropout) against the JAX package, tiny Llama, fp32,
CPU. Torch's Philox bits are not JAX's threefry bits, so the two packages
draw different masks by design: the port's _attention is held to JAX's
given JAX's own keep mask. The port's masks are derived from (seed, step,
layer): the scan and unrolled forwards, a remat recompute and a resumed run
draw the same ones; eval draws none; the fused kernels stand aside under
dropout, as in JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.train.scan_phase import make_scan_dispatch
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

RATE = 0.1
CFG = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256), attention_dropout=RATE)
# fp32, one attention in two frameworks (tests/test_torch_model.py's bound)
ATTN_TOL = 1e-5
# the scan state's dense base computes base + delta where the per-layer
# phase scatters (one fp add apart, scan_phase.py:14-18)
SCAN_LOSS_RTOL = 1e-4


def _qkv(b=2, s=16, hq=4, hkv=2, hd=64):
    q = tp.seeded_normal((b, s, hq, hd), 1)
    k = tp.seeded_normal((b, s, hkv, hd), 2)
    v = tp.seeded_normal((b, s, hkv, hd), 3)
    keep = np.tril(np.ones((s, s), bool))[None] & np.array([[1] * s, [1] * (s - 5) + [0] * 5],
                                                           bool)[:, None, :]
    bias = np.where(keep, 0.0, np.finfo(np.float32).min).astype(np.float32)[:, None]
    return q, k, v, bias


def test_attention_with_jax_mask_equals_jax():
    """The port's _attention given JAX's keep mask against JAX's _attention
    with the key that drew it: inverted scaling, zeros elsewhere."""
    q, k, v, bias = _qkv()
    rng = jax.random.PRNGKey(7)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    keep = np.asarray(jax.random.bernoulli(rng, 1.0 - RATE, (b, hkv, hq // hkv, s, s)))
    want = jllama._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                             dropout_rate=RATE, dropout_rng=rng)
    got = llama._attention(*(torch.from_numpy(a) for a in (q, k, v, bias)), RATE,
                           keep=torch.from_numpy(keep.copy()))
    tp.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert 0.05 < 1.0 - keep.mean() < 0.15
    plain = llama._attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert not np.allclose(tp.np32(got), tp.np32(plain), atol=1e-3)


def test_attn_dropout_draws_the_rate_and_scales():
    probs = torch.full((4, 2, 2, 64, 64), 0.5)
    out = llama._attn_dropout(probs, RATE, llama._dropout_rng(123, "cpu"))
    kept = out != 0
    assert abs(1.0 - kept.float().mean().item() - RATE) < 0.01
    assert torch.equal(out[kept], torch.full_like(out[kept], 0.5 / (1.0 - RATE)))
    again = llama._attn_dropout(probs, RATE, llama._dropout_rng(123, "cpu"))
    assert torch.equal(out, again)
    assert llama._attn_dropout(probs, 0.0, llama._dropout_rng(123, "cpu")) is probs
    assert llama._attn_dropout(probs, RATE) is probs


def _batch():
    b = tp.lm_batches(1, pad_from=24)[0]
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _stacked(params):
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    out["layers_stacked"] = {m: torch.stack([layers[str(l)][m] for l in range(len(layers))])
                             for m in layers["0"]}
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["eager", "remat"])
def test_scan_and_unrolled_forwards_agree_bitwise(remat):
    """forward and forward_scan under dropout at equal keys: the same logits
    and the same gradients bit for bit (each layer seeds its mask from the
    absolute layer index); another step's key draws other masks."""
    params = llama.init_params(CFG, seed=0)
    leaves = [p.requires_grad_(True) for p in llama.flatten_tree(params).values()]
    batch = _batch()
    key = (5, 3)
    kw = dict(attention_mask=batch["attention_mask"], remat=remat, dropout_key=key)
    a = llama.forward(params, batch["input_ids"], CFG, **kw)
    ga = torch.autograd.grad(a.square().mean(), leaves)
    stacked = _stacked(params)
    b = llama.forward_scan(stacked, batch["input_ids"], CFG, layer_xs={"t": {}},
                           linear_scan=make_scan_dispatch(), **kw)
    gb = torch.autograd.grad(b.square().mean(), leaves)
    assert torch.equal(a, b)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)
    other = llama.forward(params, batch["input_ids"], CFG, **{**kw, "dropout_key": (5, 4)})
    assert not torch.equal(a, other)


def test_remat_recompute_draws_the_same_masks():
    """The remat backward recomputes each layer with the mask its forward
    drew: the gradients equal those of the forward without remat."""
    params = llama.init_params(CFG, seed=0)
    leaves = [p.requires_grad_(True) for p in llama.flatten_tree(params).values()]
    batch = _batch()
    grads = []
    for remat in (False, True):
        out = llama.forward(params, batch["input_ids"], CFG, remat=remat, dropout_key=(1, 2),
                            attention_mask=batch["attention_mask"])
        grads.append(torch.autograd.grad(out.square().mean(), leaves))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_eval_draws_no_mask_and_training_without_a_key_raises():
    params = llama.init_params(CFG, seed=0)
    batch = _batch()
    no_drop = dataclasses.replace(CFG, attention_dropout=0.0)
    with torch.no_grad():
        ev = llama.forward(params, batch["input_ids"], CFG, attention_mask=batch["attention_mask"])
        ref = llama.forward(params, batch["input_ids"], no_drop,
                            attention_mask=batch["attention_mask"])
        keyed = llama.forward(params, batch["input_ids"], CFG, dropout_key=(0, 0),
                              attention_mask=batch["attention_mask"])
    assert torch.equal(ev, ref) and not torch.equal(keyed, ref)
    params["embed_tokens"].requires_grad_(True)
    with pytest.raises(ValueError, match="no dropout_key"):
        llama.forward(params, batch["input_ids"], CFG, attention_mask=batch["attention_mask"])


@pytest.mark.parametrize("impl", ["auto", "fullk", "flash", "einsum"])
def test_fused_attention_stands_aside_under_dropout(impl, monkeypatch):
    """Every attn_impl resolves to the einsum in a training forward under
    dropout (JAX's fused_ok): K3 is not run, on the card either; eval keeps
    the fused kernel."""
    assert llama.resolve_attn_impl(impl, 64, "cuda", dropout=True) == "einsum"
    assert llama.resolve_attn_impl(impl, 64, "cpu", dropout=True) == "einsum"
    assert llama.resolve_attn_impl(impl, 64, "cuda") == ("einsum" if impl == "einsum" else "fullk")

    def forbidden(*a, **k):
        raise AssertionError("the fused attention ran under dropout")

    monkeypatch.setattr(llama, "fullk_attention", forbidden)
    params = llama.init_params(CFG, seed=0)
    batch = _batch()
    out = llama.forward(params, batch["input_ids"], CFG, attn_impl=impl, dropout_key=(0, 1),
                        attention_mask=batch["attention_mask"])
    assert torch.isfinite(out).all()


def _trainer(model_cfg=CFG, **kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                matrix_sparsity=True, full_ft_steps=2, downsample_attention_blocks_ratio=0.05,
                downsample_mlp_blocks_ratio=0.05, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=3,
                dropout=RATE)
    base.update(kw)
    return SMTTrainer(SMTConfig(**base), model_cfg, llama.init_params(model_cfg, seed=0),
                      total_steps=6)


def test_steps_key_masks_by_phase_seed_and_step(monkeypatch):
    """The warm-up keys its masks by (seed, step), the sparse phase by
    (seed + 1, step), as the JAX steps key theirs; eval draws none."""
    seen = []
    real = llama.dropout_layer_seed

    def spy(key, layer):
        seen.append((tuple(key), layer))
        return real(key, layer)

    monkeypatch.setattr(llama, "dropout_layer_seed", spy)
    t = _trainer()
    for batch in tp.lm_batches(4, pad_from=24):
        t.train_step(batch)
    t.evaluate(tp.lm_batches(1, seed=9))
    keys = sorted({k for k, _ in seen})
    assert keys == [(3, 0), (3, 1), (4, 2), (4, 3)]
    assert {l for _, l in seen} == {0, 1}


def test_scan_and_per_layer_trainers_under_dropout():
    """JAX's tests/test_scan_phase.py dropout pair: the scan sparse phase
    draws the per-layer phase's masks; warm-ups equal bit for bit, sparse
    losses one fp add apart; a run without dropout parts from step 1."""
    runs = {}
    for scan in ("on", "off"):
        t = _trainer(scan_layers=scan)
        runs[scan] = (t, [float(t.train_step(b)["loss"]) for b in tp.lm_batches(6, pad_from=24)])
    (ts, ls), (tu, lu) = runs["on"], runs["off"]
    assert ts._scan and not tu._scan
    assert ls[:2] == lu[:2]
    np.testing.assert_allclose(ls, lu, rtol=SCAN_LOSS_RTOL, atol=0)
    nodrop = _trainer(dataclasses.replace(CFG, attention_dropout=0.0), dropout=0.0)
    first = float(nodrop.train_step(tp.lm_batches(1, pad_from=24)[0])["loss"])
    assert abs(first - lu[0]) > 1e-6
