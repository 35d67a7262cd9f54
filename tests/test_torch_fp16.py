"""fp16 training with DeepSpeed-style dynamic loss scaling (--dtype fp16)
in the port against the JAX package, on the CPU (tests/test_fp16.py's
semantics): tiny Llama, tests/torch_parity batches, both trainers on the
same weights. The scale-update rule; a forced overflow (loss scale 3e38)
in the warm-up, the per-layer sparse step (dense base, and int8 base with
its host store), the channel sparse step and the scan sparse step leaves
every other leaf bit for bit as it was, advances `step`, halves the scale
and resets the good count, as JAX's step from the same state does; the
two-phase run against the JAX trainer (same plan, same overflow flags and
scales step for step, losses within 1e-3 for two steps and 3e-2 after,
tests/test_fp16.py:82-83's bounds), including the scan layout and channel
+ int8 at 12 layers; overflowed steps skipped by `fit` as JAX skips them;
resume bit for bit with the scaler restored; a restore across dtypes and
the quantize-on-load entry refused; the CLI to its export."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.data.sft import SFTDataset as JaxSFTDataset
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu.train.steps import update_loss_scale as jax_update_loss_scale
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.data.sft import SFTDataset
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
from sparse_matrix_tuning_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from sparse_matrix_tuning_tpu_torch.train.steps import update_loss_scale
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

N_WARMUP, N_SPARSE = 2, 4
# tests/test_fp16.py:82-83: an fp16 forward in two implementations, the
# first two steps and the rest (measured: 2.5e-4 at worst, int8 base)
RTOL_FIRST, RTOL_REST = 1e-3, 3e-2
FORCED = 3.0e38  # the scaled loss overflows fp32 (tests/test_fp16.py:38)


def _cfg_kwargs(mode="matrix", **kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp16",
                full_ft_steps=N_WARMUP, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=0)
    if mode == "channel":
        base.update(channel_sparsity=True, num_attention_channel=8, num_mlp_channel=8)
    else:
        base.update(matrix_sparsity=True, downsample_attention_blocks_ratio=0.05,
                    downsample_mlp_blocks_ratio=0.05)
    base.update(kw)
    return base


def _models(layers=2):
    return (dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=256), num_hidden_layers=layers),
            dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256), num_hidden_layers=layers))


def _pair(mode="matrix", layers=2, total=N_WARMUP + N_SPARSE, **kw):
    """The JAX and the port trainer on the same weights."""
    jcfg, pcfg = _models(layers)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    pt = SMTTrainer(SMTConfig(**_cfg_kwargs(mode, **kw)), pcfg, tp.port_params(jparams),
                    total_steps=total)
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg_kwargs(mode, **kw)), jcfg, jparams, total_steps=total)
    return jt, pt


def _leaves(trainer):
    return llama.flatten_tree({k: v for k, v in trainer.state.items() if k != "sched"})


# ---------------------------------------------------------------------------
# the scale-update rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,good,finite,want", [
    (65536.0, 5, False, (32768.0, 0)),     # overflow: halve and reset
    (1.0, 0, False, (1.0, 0)),             # the floor
    (1024.0, 10, True, (1024.0, 11)),      # a good step counts up
    (1024.0, 1999, True, (2048.0, 0)),     # a full window doubles and resets
], ids=["overflow", "floor", "good", "window"])
def test_update_loss_scale_matches_jax(scale, good, finite, want):
    s_p, g_p = update_loss_scale(torch.tensor(scale), torch.tensor(good, dtype=torch.int32),
                                 torch.tensor(finite), window=2000)
    s_j, g_j = jax_update_loss_scale(jnp.float32(scale), jnp.int32(good), jnp.bool_(finite),
                                     window=2000)
    assert (float(s_p), int(g_p)) == (float(s_j), int(g_j)) == want
    assert s_p.dtype == torch.float32 and g_p.dtype == torch.int32


# ---------------------------------------------------------------------------
# a forced overflow changes nothing but step and the scaler
# ---------------------------------------------------------------------------

FORCED_CASES = {
    "warmup": (dict(), 1),
    "sparse_dense": (dict(), N_WARMUP + 1),
    "sparse_int8_offload": (dict(frozen_quant="int8"), N_WARMUP + 1),
    "channel_sparse": (dict(mode="channel"), N_WARMUP + 1),
    "scan_sparse": (dict(scan_layers="on"), N_WARMUP + 1),
}


@pytest.mark.parametrize("case", list(FORCED_CASES))
def test_forced_overflow_changes_only_step_and_scaler(case):
    kw, before = FORCED_CASES[case]
    jt, pt = _pair(**kw)
    batches = tp.lm_batches(before + 1, pad_from=24)
    for b in batches[:before]:
        jt.train_step(b)
        pt.train_step(b)
    assert pt.phase == ("warmup" if case == "warmup" else "sparse")
    if case == "sparse_int8_offload":
        assert pt._host_frozen and "q" in pt.state
    if case == "scan_sparse":
        assert pt._scan and jt._scan
    leaves = {k: v.detach().clone() for k, v in _leaves(pt).items()}
    host = {k: v.clone() for k, v in (pt._host_frozen or {}).items()}
    step = pt.step
    pt.state["loss_scale"].fill_(FORCED)
    jt.state["loss_scale"] = jnp.asarray(FORCED, jnp.float32)
    pm = pt.train_step(batches[before])
    jm = jt.train_step(batches[before])
    assert pm["overflow"] is True and bool(jm["overflow"])
    assert float(pm["loss_scale"]) == float(jm["loss_scale"]) == float(np.float32(FORCED))
    half = float(np.float32(FORCED) * np.float32(0.5))
    assert float(pt.state["loss_scale"]) == float(jt.state["loss_scale"]) == half
    assert int(pt.state["good_steps"]) == int(jt.state["good_steps"]) == 0
    assert pt.step == step + 1 == int(jt.state["step"])
    assert int(pt.state["count"]) == int(jt.state["count"])
    changed = [k for k, v in _leaves(pt).items()
               if k not in ("step", "loss_scale", "good_steps") and not torch.equal(v, leaves[k])]
    assert not changed, changed
    assert set(_leaves(pt)) == set(leaves)
    for k, v in host.items():
        assert torch.equal(pt._host_frozen[k], v), k


# ---------------------------------------------------------------------------
# the two-phase run against the JAX trainer
# ---------------------------------------------------------------------------

TWO_PHASE = {
    "matrix_dense": (dict(), 2),
    "matrix_int8": (dict(frozen_quant="int8"), 2),
    "channel": (dict(mode="channel"), 2),
    "matrix_scan_on": (dict(scan_layers="on"), 2),
    # JAX's "auto" takes its scan warm-up and the int8 scan state here; the
    # port's eager warm-up converts into the same state
    "channel_int8_12_layers_auto": (dict(mode="channel", frozen_quant="int8"), 12),
}


def _assert_losses(got, want):
    np.testing.assert_allclose(got[:2], want[:2], rtol=RTOL_FIRST, atol=0)
    np.testing.assert_allclose(got[2:], want[2:], rtol=RTOL_REST, atol=0)


@pytest.mark.parametrize("case", list(TWO_PHASE))
def test_two_phase_matches_jax(case):
    kw, layers = TWO_PHASE[case]
    jt, pt = _pair(layers=layers, **kw)
    seq = {"jax": [], "port": []}
    for b in tp.lm_batches(N_WARMUP + N_SPARSE, pad_from=24):
        jm, pm = jt.train_step(b), pt.train_step(b)
        # the channel warm-up is forward-only: no scaler metrics, as in JAX
        seq["jax"].append((float(jm["loss"]), float(jm.get("loss_scale", -1.0)),
                           bool(jm.get("overflow", False))))
        seq["port"].append((float(pm["loss"]), float(pm.get("loss_scale", -1.0)),
                            bool(pm.get("overflow", False))))
    assert pt.phase == jt.phase == "sparse" and pt._scan == jt._scan
    if case == "channel_int8_12_layers_auto":
        assert pt._scan and "q" in pt.state and "q_head" in pt.state
    assert pt.plan.fingerprint() == jt.plan.fingerprint()
    assert [s[1:] for s in seq["port"]] == [s[1:] for s in seq["jax"]]
    assert "loss_scale" in pt.state and "loss_scale" in jt.state
    _assert_losses([s[0] for s in seq["port"]], [s[0] for s in seq["jax"]])
    eval_batches = tp.lm_batches(2, pad_from=20, seed=5)
    np.testing.assert_allclose(pt.evaluate(eval_batches)[1], jt.evaluate(eval_batches)[1],
                               rtol=RTOL_REST)


def _datasets(cls, n=8, seq=16):
    rng = np.random.default_rng(0)
    ids = [rng.integers(3, 256, seq).astype(np.int32) for _ in range(n)]
    return cls(ids, [i.copy() for i in ids])


@pytest.mark.parametrize("scale_exp", [40, 127])
def test_natural_scale_descent_skips_like_jax(scale_exp):
    """From a raised scale both packages skip the same steps. At 2^40 the
    grads overflow (the loss stays finite, so fit keeps it); at 2^127 the
    scaled loss itself overflows fp32 for the first two steps of each phase
    (the sparse phase starts a fresh scaler), which fit skips without eval,
    save or history: equal history lengths cover that branch."""
    fit = dict(num_ft_epochs=2, per_device_ft_batch_size=2, init_loss_scale=2.0 ** scale_exp)
    jcfg, pcfg = _models()
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    pt = SMTTrainer(SMTConfig(**_cfg_kwargs(**fit)), pcfg, tp.port_params(jparams), total_steps=8)
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg_kwargs(**fit)), jcfg, jparams, total_steps=8)
    hist_p = pt.fit(_datasets(SFTDataset), _datasets(SFTDataset).subset([0]), pad_token_id=0)
    hist_j = jt.fit(_datasets(JaxSFTDataset), _datasets(JaxSFTDataset).subset([0]),
                    pad_token_id=0)
    assert pt.step == int(jt.state["step"]) == 8
    assert len(hist_p["train_loss"]) == len(hist_j["train_loss"])
    assert len(hist_p["train_loss"]) == (8 if scale_exp == 40 else 4)
    assert float(pt.state["loss_scale"]) == float(jt.state["loss_scale"])
    _assert_losses(hist_p["train_loss"], hist_j["train_loss"])
    np.testing.assert_allclose(hist_p["eval_loss"][-1], hist_j["eval_loss"][-1], rtol=RTOL_REST)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _fresh(dtype="fp16", **kw):
    return SMTTrainer(SMTConfig(**_cfg_kwargs(dtype=dtype, **kw)), llama.LlamaConfig.tiny(
        vocab_size=256), llama.init_params(llama.LlamaConfig.tiny(vocab_size=256), seed=0),
        total_steps=8)


@pytest.mark.parametrize("stop_at", [2, 4], ids=["warmup", "sparse"])
def test_resume_fp16_bit_for_bit(tmp_path, stop_at):
    """Saved mid warm-up (3 warm-up steps) and mid sparse phase: the
    restored trainer continues bit for bit, its scaler restored (the first
    warm-up step overflows at 2^16, so the saved scale is not the initial
    one)."""
    batches = tp.lm_batches(7, pad_from=24)
    ref = _fresh(full_ft_steps=3)
    losses = [float(ref.train_step(b)["loss"]) for b in batches]
    first = _fresh(full_ft_steps=3)
    for b in batches[:stop_at]:
        first.train_step(b)
    saved_scale = float(first.state["loss_scale"])
    assert saved_scale != 2.0 ** 16 or stop_at == 4
    save_checkpoint(str(tmp_path / "ck"), first)
    second = _fresh(full_ft_steps=3)
    restore_checkpoint(str(tmp_path / "ck"), second)
    assert float(second.state["loss_scale"]) == saved_scale
    assert int(second.state["good_steps"]) == int(first.state["good_steps"])
    after = [float(second.train_step(b)["loss"]) for b in batches[stop_at:]]
    assert after == losses[stop_at:]
    la, lb = _leaves(second), _leaves(ref)
    assert set(la) == set(lb)
    for k, v in la.items():
        assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k


@pytest.mark.parametrize("saved,now", [("fp16", "bf16"), ("bf16", "fp16")])
def test_restore_across_dtypes_is_refused_by_name(tmp_path, saved, now):
    t = _fresh(dtype=saved)
    t.train_step(tp.lm_batches(1)[0])
    save_checkpoint(str(tmp_path / "ck"), t)
    other = _fresh(dtype=now)
    before = {k: v.clone() for k, v in _leaves(other).items()}
    with pytest.raises(ValueError, match=f"--dtype {saved} but the trainer runs --dtype {now}"):
        restore_checkpoint(str(tmp_path / "ck"), other)
    assert all(torch.equal(v, before[k]) for k, v in _leaves(other).items())


def test_sparse_scan_from_hf_refuses_fp16():
    """The fp16 scaler's state comes from the warm-up, which this entry
    skips: both packages refuse it before reading a checkpoint."""
    jcfg, pcfg = _models()
    plan = SMTPlan("matrix", {"0.q_proj": LinearPlan("q_proj", 0, 256, 256, blocks=((0, 0),))})
    jplan = JaxSMTPlan("matrix", {"0.q_proj": JaxLinearPlan("q_proj", 0, 256, 256,
                                                            blocks=((0, 0),))})
    kw = _cfg_kwargs(frozen_quant="int8")
    with pytest.raises(ValueError, match="fp16"):
        SMTTrainer.sparse_scan_from_hf(SMTConfig(**kw), "no-such-dir", plan, 8,
                                       model_cfg=pcfg, device="cpu")
    with pytest.raises(ValueError, match="fp16"):
        JaxSMTTrainer.sparse_scan_from_hf(JaxSMTConfig(**kw), "no-such-dir", jplan, 8,
                                          model_cfg=jcfg)


def test_fine_tune_cli_fp16_runs_to_its_export(tmp_path):
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from test_torch_checkpoint import _tiny_ckpt
    d, data = _tiny_ckpt(tmp_path)
    out = tmp_path / "out"
    hist = main(["--model_name_or_path", d, "--data_path", data, "--device", "cpu",
                 "--dtype", "fp16", "--matrix_sparsity", "--full_ft_steps", "2",
                 "--downsample_attention_blocks_ratio", "0.2",
                 "--downsample_mlp_blocks_ratio", "0.2", "--per_device_ft_batch_size", "4",
                 "--max_seq_len", "64", "--eval_step", "0", "--num_ft_epochs", "1",
                 "--ft_learning_rate", "1e-3", "--smt_lr", "1e-3", "--output_dir", str(out)])
    assert hist["train_loss"] and np.isfinite(hist["train_loss"]).all()
    assert np.isfinite(hist["eval_loss"][-1])
    assert (out / "final" / "model.safetensors").exists()
    assert (out / "final" / "smt_plan.json").exists()
    back = load_hf_params(str(out / "final"), llama.LlamaConfig.tiny(vocab_size=512),
                          dtype=torch.float16)
    assert all(torch.isfinite(v).all() for v in llama.flatten_tree(back).values())
