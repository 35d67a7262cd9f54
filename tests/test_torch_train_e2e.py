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


# ---------------------------------------------------------------------------
# the int8 frozen base
# ---------------------------------------------------------------------------

# int8 sparse phase, fp32 on the CPU: the integer products are exact in both
# frameworks, but rounding to int8 is not continuous: an activation or a
# master weight that differs in its last fp32 bits between them (the warm-up
# masters do, by ~1e-5) can take the neighbouring int8 step, and Adam then
# carries the two runs apart. From identical states the first sparse loss is
# equal bit for bit (test_int8_sparse_phase_from_a_carried_jax_state); from
# scratch the worst loss difference measured over the 6 sparse steps is
# 3.2e-4 relative at smt_lr 1e-3 (1.5e-3 at the other tests' 1e-2, hence the
# smaller rate here). The bound is 1e-3; the JAX suite holds its own int8 run
# on a mesh to the one on a single device at 2e-3 (tests/test_quant.py:313).
INT8_LOSS_RTOL = 1e-3
INT8_KW = dict(frozen_quant="int8", smt_lr=1e-3)


@pytest.fixture(scope="module")
def int8_pair():
    return _run_pair(**INT8_KW)


def test_int8_sparse_phase_from_a_carried_jax_state():
    """The JAX trainer's converted int8 state carried across (weights,
    trainable blocks, int8 base and head, host store): the port's first
    sparse step computes the same loss to fp32 rounding, the later ones stay
    within the int8 bound."""
    from sparse_matrix_tuning_tpu_torch.models.from_jax import (
        plan_from_jax, qstate_from_jax, tensor_from_numpy)
    from sparse_matrix_tuning_tpu_torch.train.steps import init_sparse_state
    n = N_WARMUP + 4
    jax_params = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
    batches = tp.lm_batches(n, pad_from=24)
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg_kwargs(**INT8_KW)), JAX_CFG, jax_params, total_steps=n)
    pt = SMTTrainer(SMTConfig(**_cfg_kwargs(**INT8_KW)), CFG, tp.port_params(jax_params),
                    total_steps=n)
    for b in batches[:N_WARMUP]:
        jt.train_step(b)
    jt.maybe_convert()
    js = tp.numpy_tree({k: jt.state[k] for k in ("params", "trainable", "q", "q_head")})
    pt.plan = plan_from_jax(jt.plan)
    pt.state = init_sparse_state(
        tp.port_params(jt.state["params"]),
        {ks: tensor_from_numpy(v) for ks, v in js["trainable"].items()}, step=N_WARMUP)
    pt.state.update(qstate_from_jax(js))
    pt._host_frozen = {ks: tensor_from_numpy(v) for ks, v in jt._host_frozen.items()}
    pt.install_sparse_phase()
    jax_losses = [float(jt.train_step(b)["loss"]) for b in batches[N_WARMUP:]]
    port_losses = [float(pt.train_step(b)["loss"]) for b in batches[N_WARMUP:]]
    assert port_losses[0] == pytest.approx(jax_losses[0], rel=1e-6)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=INT8_LOSS_RTOL, atol=0)


def test_int8_losses_and_plan_match_jax(int8_pair):
    p = int8_pair
    assert p["port"].phase == "sparse" and "q" in p["port"].state and "q_head" in p["port"].state
    assert "q" in p["jax"].state and "q_head" in p["jax"].state
    assert p["port"]._host_frozen is not None and p["jax"]._host_frozen is not None
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=INT8_LOSS_RTOL, atol=0)
    np.testing.assert_allclose(p["port_losses"][:N_WARMUP], p["jax_losses"][:N_WARMUP],
                               rtol=LOSS_RTOL, atol=0)
    assert p["port_losses"][-1] < p["port_losses"][0]
    # the same int8 base as the JAX conversion built, up to the masters' drift
    for ks, entry in p["port"].state["q"].items():
        theirs = p["jax"].state["q"][ks]
        assert set(entry) == set(theirs)
        assert np.mean(entry["wq"].numpy() != np.asarray(theirs["wq"])) < 1e-4, ks
        np.testing.assert_allclose(entry["sw"].numpy(), np.asarray(theirs["sw"]), rtol=1e-4)


def test_int8_tracks_the_bf16_base(pair, int8_pair):
    """Warm-up identical, sparse losses inside the JAX suite's 5% band
    (tests/test_quant.py:202-203)."""
    dense = _run_pair(smt_lr=INT8_KW["smt_lr"])
    np.testing.assert_allclose(int8_pair["port_losses"][:N_WARMUP], pair["port_losses"][:N_WARMUP],
                               rtol=1e-6)
    np.testing.assert_allclose(int8_pair["port_losses"][N_WARMUP:], dense["port_losses"][N_WARMUP:],
                               rtol=0.05)
    assert int8_pair["port_losses"][N_WARMUP:] != dense["port_losses"][N_WARMUP:]


def test_int8_eval_loss_matches_training_forward_and_jax(int8_pair):
    """The sparse-phase eval runs the SAME forward as training, int8 head
    included: the eval loss on a batch equals the next train step's loss on
    it, taken before the update (tests/test_head_quant.py:71-80); and it
    equals the JAX trainer's eval loss."""
    port, jt = int8_pair["port"], int8_pair["jax"]
    batches = tp.lm_batches(2, seed=9)
    _, loss_p = port.evaluate(batches)
    _, loss_j = jt.evaluate(batches)
    assert loss_p == pytest.approx(loss_j, rel=INT8_LOSS_RTOL)
    batch = tp.lm_batches(1, seed=4)[0]
    ev = port.evaluate([batch])[1]
    np.testing.assert_allclose(ev, float(port.train_step(batch)["loss"]), rtol=1e-6)


def test_int8_merged_export_matches_jax(int8_pair):
    """The export is exact, whatever the int8 compute path did: frozen
    weights are the conversion-time weights bit for bit (the same values as
    the JAX trainer's, both cast from warm-up masters 1e-4 apart), and the
    trained blocks are in."""
    port, jt = int8_pair["port"], int8_pair["jax"]
    merged = port.merged_params()
    jax_merged = tp.numpy_tree(jt.merged_params())
    for li, layer in merged["layers"].items():
        for m, w in layer.items():
            got = tp.np32(w).copy()
            want = np.array(jax_merged["layers"][li][m], np.float32)
            assert got.shape == want.shape
            lp = port.plan.linears.get(f"{li}.{m}")
            for rb, cb in (lp.blocks if lp is not None else ()):
                # a trained block follows its own run's int8 rounding (Adam moves an
                # element by ~lr whichever way a near-zero gradient points): held
                # to the trainables below, not to the JAX run
                got[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = 0
                want[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = 0
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), (li, m)
    at_conversion = int8_pair["port_at_conversion"]
    for ks, lp in port.plan.linears.items():
        w = merged["layers"][str(lp.layer)][lp.module]
        mask = torch.zeros(w.shape, dtype=torch.bool)
        for rb, cb in lp.blocks:
            mask[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = True
        before = port._host_frozen[ks]
        assert torch.equal(w[~mask], before[~mask]) and not torch.equal(w[mask], before[mask])
        w4 = w.view(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
        rbs, cbs = port.plan.block_index(ks, "cpu")
        assert torch.equal(w4[rbs, :, cbs, :], port.state["trainable"][ks].detach())
    # the conversion-time snapshot of an offloaded run holds placeholders
    assert all(w.shape == (1,) for layer in at_conversion.values()
               for m, w in layer.items() if m.endswith("_proj"))


@pytest.mark.parametrize("kw,rtol", [
    (dict(INT8_KW, loss_impl="chunked", vocab_chunk=96), INT8_LOSS_RTOL),
    (dict(INT8_KW, frozen_host_offload=False, gradient_checkpointing=True,
          gradient_accumulation_steps=2), INT8_LOSS_RTOL),
    (dict(frozen_quant="none", head_quant="int8", smt_lr=1e-3), INT8_LOSS_RTOL),
    (dict(loss_impl="chunked", vocab_chunk=96), LOSS_RTOL),
], ids=["int8-chunked-q8-loss", "int8-resident-remat-accum2", "q8-head-over-dense-base",
        "chunked-loss"])
def test_int8_and_loss_variants_match_jax(kw, rtol):
    """The chunked q8 loss (vocabulary 256 over ragged chunks of 96), the
    resident int8 base under remat and accumulation, an int8 head over a
    dense base (measured worst 3.2e-4, 1.7e-4 and 7.7e-6 relative), and the
    exact chunked loss in both phases (2e-7, held to the dense bound)."""
    p = _run_pair(**kw)
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=rtol, atol=0)
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
    assert ("q" in p["port"].state) == (kw.get("frozen_quant") == "int8")
    assert ("q_head" in p["port"].state) == ("int8" in (kw.get("frozen_quant"), kw.get("head_quant")))
    assert ("q_head" in p["jax"].state) == ("q_head" in p["port"].state)


if __name__ == "__main__":
    # The int8 run's drift from the JAX trainer: the largest relative loss
    # difference over the two phases, at INT8_KW's rate and at 1e-2 (CPU,
    # fp32): JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_e2e.py
    for lr in (INT8_KW["smt_lr"], 1e-2):
        p = _run_pair(**{**INT8_KW, "smt_lr": lr})
        rel = np.abs(np.subtract(p["port_losses"], p["jax_losses"])) / np.abs(p["jax_losses"])
        print(f"int8, smt_lr {lr}: largest relative loss difference {rel.max():.3e} "
              f"(bound INT8_LOSS_RTOL {INT8_LOSS_RTOL})")
