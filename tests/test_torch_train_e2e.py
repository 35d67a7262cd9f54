"""The port's two-phase trainer against the JAX SMTTrainer on the same
weights and batches (the tests/test_train_e2e.py configuration: tiny
Llama, fp32, 2 warm-up + 6 sparse steps): step-for-step losses, the plan
fingerprint, frozen weights, and the merged export."""
import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

JAX_CFG = JaxLlamaConfig.tiny(vocab_size=256)
CFG = LlamaConfig.tiny(vocab_size=256)
N_WARMUP, N_SPARSE = 2, 6
# fp32 on the CPU, the same algorithm in two frameworks: measured worst
# loss difference 5.6e-7 relative over the 8 steps; the bound is 1e-4.
LOSS_RTOL = 1e-4


def _cfg_kwargs(**kw):
    base = dict(
        data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
        matrix_sparsity=True, full_ft_steps=N_WARMUP,
        downsample_attention_blocks_ratio=0.05,
        downsample_mlp_blocks_ratio=0.05,
        ft_learning_rate=1e-3, smt_lr=1e-2, lr_scheduler_type="constant",
        eval_step=0, save_steps=0, gradient_checkpointing=False,
        max_seq_len=32, seq_buckets=[32], seed=0,
    )
    base.update(kw)
    return base


def _run_pair(**kw):
    n = N_WARMUP + N_SPARSE
    jax_params = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
    batches = tp.lm_batches(n, pad_from=24)
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg_kwargs(**kw)), JAX_CFG, jax_params,
                       total_steps=n)
    pt = SMTTrainer(SMTConfig(**_cfg_kwargs(**kw)), CFG, tp.port_params(jax_params),
                    total_steps=n)
    out = {"jax": jt, "port": pt, "jax_losses": [], "port_losses": []}
    for i, batch in enumerate(batches):
        if i == N_WARMUP:
            pt.maybe_convert()
            out["port_at_conversion"] = {
                li: {m: w.clone() for m, w in layer.items()}
                for li, layer in pt.state["params"]["layers"].items()}
            out["embed_at_conversion"] = pt.state["params"]["embed_tokens"].clone()
        out["jax_losses"].append(float(jt.train_step(batch)["loss"]))
        out["port_losses"].append(float(pt.train_step(batch)["loss"]))
    return out


@pytest.fixture(scope="module")
def pair():
    return _run_pair()


def test_losses_match_step_for_step(pair):
    assert pair["port"].phase == "sparse" and pair["jax"].phase == "sparse"
    np.testing.assert_allclose(pair["port_losses"], pair["jax_losses"],
                               rtol=LOSS_RTOL, atol=0)
    assert pair["port_losses"][-1] < pair["port_losses"][0]


def test_plan_fingerprint_matches(pair):
    assert pair["port"].plan.to_json() == pair["jax"].plan.to_json()
    assert pair["port"].plan.fingerprint() == pair["jax"].plan.fingerprint()
    assert pair["port"].plan.trainable_params > 0


def test_frozen_weights_untouched_in_sparse_phase(pair):
    plan = pair["port"].plan
    after = pair["port"].state["params"]
    changed = 0
    for li, layer in pair["port_at_conversion"].items():
        for mod, w_before in layer.items():
            w_after = after["layers"][li][mod]
            lp = plan.linears.get(f"{li}.{mod}")
            if lp is None:
                assert torch.equal(w_after, w_before), (li, mod)
                continue
            mask = torch.zeros(w_before.shape, dtype=torch.bool)
            for rb, cb in lp.blocks:
                mask[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = True
            assert torch.equal(w_after[~mask], w_before[~mask]), (li, mod)
            assert not torch.equal(w_after[mask], w_before[mask]), (li, mod)
            changed += 1
    assert torch.equal(after["embed_tokens"], pair["embed_at_conversion"])
    assert changed == len(plan.linears)


def test_merged_export_matches_jax(pair, tmp_path):
    port, jt = pair["port"], pair["jax"]
    merged = port.merged_params()
    # the JAX trainer's merged dense params, within the fp32 drift of 8
    # steps in two frameworks. Compared by relative Frobenius norm: Adam's
    # first steps move every element by ~lr whatever |g|, so an element
    # whose gradient is ~0 may move either way (measured worst tensor
    # 1.7e-5; bound 1e-4).
    jax_merged = tp.numpy_tree(jt.merged_params())
    pairs = [(w, jax_merged["layers"][li][m]) for li, layer in merged["layers"].items()
             for m, w in layer.items()]
    pairs += [(merged[k], jax_merged[k]) for k in ("embed_tokens", "norm", "lm_head")]
    for w, want in pairs:
        got, want = tp.np32(w), np.asarray(want, np.float32)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)

    port.cfg.output_dir = str(tmp_path)
    try:
        port._save("final")
    finally:
        port.cfg.output_dir = None
    assert (tmp_path / "final" / "smt_plan.json").read_text() == port.plan.to_json()
    back = load_hf_params(str(tmp_path / "final"), CFG, dtype=torch.float32)
    for li, layer in merged["layers"].items():
        for m, w in layer.items():
            assert torch.equal(back["layers"][li][m], w), (li, m)
    assert torch.equal(back["embed_tokens"], merged["embed_tokens"])


def test_eval_loss_matches_jax(pair):
    batches = tp.lm_batches(2, seed=9)
    ppl_p, loss_p = pair["port"].evaluate(batches)
    ppl_j, loss_j = pair["jax"].evaluate(batches)
    assert loss_p == pytest.approx(loss_j, rel=LOSS_RTOL)
    assert np.isfinite(ppl_p)


@pytest.mark.parametrize("kw", [
    dict(saliency_accumulation="per_step_stats", qk_scheduler=True, w_decay=0.1),
    dict(gradient_accumulation_steps=2, calculate_strategy="L2",
         lr_scheduler_type="cosine", gradient_checkpointing=True),
    dict(attn_impl="fullk"),
], ids=["per_step_stats-qk-wd", "accum2-L2-cosine-remat", "fullk"])
def test_variants_match_jax(kw):
    """Param groups (q/k LR boost, weight decay), per-step saliency,
    microbatch accumulation, another reducer, a decaying schedule, remat;
    the fused fullk attention on both sides (Pallas in interpret mode, the
    port's K3 plain versions) over right-padded batches."""
    p = _run_pair(**kw)
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=LOSS_RTOL, atol=0)
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
