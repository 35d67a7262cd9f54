"""Checkpoint and resume (train/checkpoint.py, --resume_from), on the
pattern of tests/test_checkpoint.py and tests/test_fit_resume.py: tiny
Llama, fp32, CPU. A run interrupted and restored into a fresh trainer
continues bit for bit as the uninterrupted run, mid warm-up (selection
preserved), mid sparse phase over the per-layer state and over the int8
scan state with its host store, and under dropout; a layout that differs
from the saved one raises naming its keys; the resumed fit agrees with the
JAX package's uninterrupted fit."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.data.sft import SFTDataset as JaxSFTDataset
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.data.sft import SFTDataset
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.train.checkpoint import (
    STATE_FILE, restore_checkpoint, save_checkpoint)
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

CFG = llama.LlamaConfig.tiny(vocab_size=256)
DROP_CFG = dataclasses.replace(CFG, attention_dropout=0.1)
# the port's fit against the JAX trainer's (tests/test_torch_train_e2e.py)
LOSS_RTOL = 1e-4


def _cfg(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                matrix_sparsity=True, full_ft_steps=2, downsample_attention_blocks_ratio=0.05,
                downsample_mlp_blocks_ratio=0.05, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=0)
    if kw.get("channel_sparsity"):
        base.update(matrix_sparsity=False, num_attention_channel=8, num_mlp_channel=8)
    base.update(kw)
    return base


def _fresh(model_cfg=CFG, total=8, **kw):
    return SMTTrainer(SMTConfig(**_cfg(**kw)), model_cfg, llama.init_params(model_cfg, seed=0),
                      total_steps=total)


def _leaves(trainer):
    return llama.flatten_tree({k: v for k, v in trainer.state.items() if k != "sched"})


def _assert_same(a, b):
    """Two trainers' states, plans and host stores, bit for bit."""
    assert a.phase == b.phase and a._scan == b._scan
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k, v in la.items():
        assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k
    if a.plan is not None:
        assert a.plan.to_json() == b.plan.to_json()
    assert (a._host_frozen is None) == (b._host_frozen is None)
    for k, v in (a._host_frozen or {}).items():
        assert torch.equal(v, b._host_frozen[k]), k


def _interrupted(tmp_path, n_steps, stop_at, model_cfg=CFG, **kw):
    """Train to `stop_at`, save, restore into a fresh trainer and train on:
    (restored trainer, losses after the restore)."""
    batches = tp.lm_batches(n_steps, pad_from=24)
    first = _fresh(model_cfg, **kw)
    for b in batches[:stop_at]:
        first.train_step(b)
    save_checkpoint(str(tmp_path / "ck"), first)
    second = _fresh(model_cfg, **kw)
    restore_checkpoint(str(tmp_path / "ck"), second)
    assert second.step == stop_at and second.phase == first.phase
    return second, [float(second.train_step(b)["loss"]) for b in batches[stop_at:]]


def _straight(n_steps, model_cfg=CFG, **kw):
    t = _fresh(model_cfg, **kw)
    return t, [float(t.train_step(b)["loss"]) for b in tp.lm_batches(n_steps, pad_from=24)]


def test_resume_mid_warmup_preserves_selection(tmp_path):
    """Saved at step 2 of a 3-step warm-up (accumulators half filled): the
    same plan and every leaf as the uninterrupted run."""
    ref, losses = _straight(6, full_ft_steps=3)
    t, after = _interrupted(tmp_path, 6, 2, full_ft_steps=3)
    assert after == losses[2:]
    assert t.plan.fingerprint() == ref.plan.fingerprint()
    _assert_same(t, ref)


def test_resume_mid_sparse_phase_per_layer(tmp_path):
    ref, losses = _straight(7)
    t, after = _interrupted(tmp_path, 7, 4)
    assert not t._scan and after == losses[4:]
    _assert_same(t, ref)


@pytest.mark.parametrize("mode", ["matrix", "channel"])
def test_resume_mid_sparse_phase_scan_int8_offload(tmp_path, mode):
    """The int8 scan state (scan_layers on) with its host store and int8
    head: restored into a warm-up trainer, which converts to the saved
    layout, rebuilds the schedules and continues bit for bit."""
    kw = dict(scan_layers="on", frozen_quant="int8",
              **({"channel_sparsity": True} if mode == "channel" else {}))
    ref, losses = _straight(7, **kw)
    t, after = _interrupted(tmp_path, 7, 4, **kw)
    assert t._scan and "q" in t.state and "q_head" in t.state and "sched" in t.state
    assert set(t._host_frozen) == set(ref._host_frozen) and "lm_head" in t._host_frozen
    assert after == losses[4:]
    _assert_same(t, ref)
    assert (tmp_path / "ck" / "frozen_host.pt").exists()
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["resolved"] == {"scan": True, "host_offload": True, "frozen_quant": "int8",
                                "head_quant": "int8"}


@pytest.mark.parametrize("stop_at", [1, 3], ids=["warmup", "sparse"])
def test_resume_under_dropout(tmp_path, stop_at):
    """Dropout masks are derived from (seed, step, layer): a resumed run
    draws the masks the uninterrupted run drew, with no RNG state saved."""
    ref, losses = _straight(6, DROP_CFG, dropout=0.1)
    t, after = _interrupted(tmp_path, 6, stop_at, DROP_CFG, dropout=0.1)
    assert after == losses[stop_at:]
    _assert_same(t, ref)
    nodrop, plain = _straight(2)
    assert plain[0] != losses[0]


@pytest.mark.parametrize("change,keys", [
    (dict(scan_layers="off"), ["scan"]),
    (dict(frozen_quant="none"), ["frozen_quant", "head_quant", "host_offload"]),
    (dict(frozen_host_offload=False), ["host_offload"]),
    (dict(head_quant="none"), ["head_quant"]),
], ids=["scan", "frozen_quant", "host_offload", "head_quant"])
def test_layout_guard_names_the_keys(tmp_path, change, keys):
    kw = dict(scan_layers="on", frozen_quant="int8")
    t = _fresh(**kw)
    for b in tp.lm_batches(3, pad_from=24):
        t.train_step(b)
    save_checkpoint(str(tmp_path / "ck"), t)
    other = _fresh(**{**kw, **change})
    with pytest.raises(ValueError, match="different resolved sparse-phase layout") as err:
        restore_checkpoint(str(tmp_path / "ck"), other)
    for k in keys:
        assert repr(k) in str(err.value), (k, str(err.value))
    assert other.phase == "warmup"


def test_mismatched_leaves_raise_one_clear_error(tmp_path):
    """A checkpoint of another model: one ValueError naming the leaves,
    before the trainer's state is touched."""
    t = _fresh()
    t.train_step(tp.lm_batches(1)[0])
    save_checkpoint(str(tmp_path / "ck"), t)
    wide = dataclasses.replace(CFG, intermediate_size=768)
    other = _fresh(wide)
    before = _leaves(other)["master/layers/0/gate_proj"].clone()
    with pytest.raises(ValueError, match="does not match the trainer's") as err:
        restore_checkpoint(str(tmp_path / "ck"), other)
    assert "gate_proj" in str(err.value)
    assert torch.equal(_leaves(other)["master/layers/0/gate_proj"], before)
    flat = torch.load(tmp_path / "ck" / STATE_FILE, weights_only=True)
    assert flat["step"].dtype == torch.int32 and int(flat["step"]) == 1


def _datasets(cls, n=8, seq=16):
    rng = np.random.default_rng(0)
    ids = [rng.integers(3, 256, seq).astype(np.int32) for _ in range(n)]
    return cls(ids, [i.copy() for i in ids])


FIT = dict(num_ft_epochs=2, per_device_ft_batch_size=2, save_steps=0, eval_step=0)


def test_fit_resume_matches_uninterrupted_and_jax(tmp_path):
    """One epoch, its end-of-epoch checkpoint, then --resume_from into a
    2-epoch run: fit skips the batches already consumed. Bit for bit the
    port's uninterrupted fit, and within the e2e bound of the JAX
    package's uninterrupted fit."""
    ds = _datasets(SFTDataset)
    whole = _fresh(output_dir=str(tmp_path / "a"), **FIT)
    hist_a = whole.fit(ds, ds.subset([0]), pad_token_id=0)
    part = _fresh(output_dir=str(tmp_path / "b"), **{**FIT, "num_ft_epochs": 1})
    hist_b1 = part.fit(ds, ds.subset([0]), pad_token_id=0)
    assert part.step == 4 and (tmp_path / "b" / "ckpt" / "state.pt").exists()
    resumed = _fresh(output_dir=str(tmp_path / "b2"), **FIT)
    restore_checkpoint(str(tmp_path / "b" / "ckpt"), resumed)
    hist_b2 = resumed.fit(ds, ds.subset([0]), pad_token_id=0)
    assert resumed.step == 8
    assert hist_b1["train_loss"] + hist_b2["train_loss"] == hist_a["train_loss"]
    _assert_same(resumed, whole)

    jds = _datasets(JaxSFTDataset)
    jcfg = jllama.LlamaConfig.tiny(vocab_size=256)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = tp.port_params(jparams)  # before the JAX trainer donates them
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg(**FIT)), jcfg, jparams, total_steps=8)
    hist_j = jt.fit(jds, jds.subset([0]), pad_token_id=0)
    pt = SMTTrainer(SMTConfig(**_cfg(output_dir=str(tmp_path / "c"), **{**FIT, "num_ft_epochs": 1})),
                    CFG, pparams, total_steps=8)
    hist_c1 = pt.fit(ds, ds.subset([0]), pad_token_id=0)
    pt2 = SMTTrainer(SMTConfig(**_cfg(**FIT)), CFG, pparams, total_steps=8)
    restore_checkpoint(str(tmp_path / "c" / "ckpt"), pt2)
    hist_c2 = pt2.fit(ds, ds.subset([0]), pad_token_id=0)
    assert pt2.plan.fingerprint() == jt.plan.fingerprint()
    np.testing.assert_allclose(hist_c1["train_loss"] + hist_c2["train_loss"],
                               hist_j["train_loss"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(hist_c2["eval_loss"][-1], hist_j["eval_loss"][-1], rtol=LOSS_RTOL)
    # by relative Frobenius norm, as tests/test_torch_train_e2e.py holds the
    # export: Adam moves an element whose gradient is ~0 by ~lr either way
    for ks, t in pt2.state["trainable"].items():
        got, want = tp.np32(t), np.asarray(jt.state["trainable"][ks], np.float32)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), ks


def test_fine_tune_cli_resume_from(tmp_path):
    """--resume_from through the CLI: a 1-epoch run's checkpoint continued
    into 2 epochs gives the uninterrupted 2-epoch run's losses (a constant
    schedule: the runs' horizons differ)."""
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    d, data = _tiny_ckpt(tmp_path)
    common = ["--model_name_or_path", d, "--data_path", data, "--device", "cpu",
              "--matrix_sparsity", "--full_ft_steps", "2",
              "--downsample_attention_blocks_ratio", "0.2",
              "--downsample_mlp_blocks_ratio", "0.2", "--per_device_ft_batch_size", "4",
              "--max_seq_len", "64", "--eval_step", "0", "--dtype", "fp32",
              "--ft_learning_rate", "1e-3", "--smt_lr", "1e-3", "--dropout", "0.1",
              "--lr_scheduler_type", "constant"]
    whole = main(common + ["--num_ft_epochs", "2", "--output_dir", str(tmp_path / "a")])
    first = main(common + ["--num_ft_epochs", "1", "--output_dir", str(tmp_path / "b")])
    rest = main(common + ["--num_ft_epochs", "2", "--output_dir", str(tmp_path / "c"),
                          "--resume_from", str(tmp_path / "b" / "ckpt")])
    assert first["train_loss"] + rest["train_loss"] == whole["train_loss"]
    assert rest["eval_loss"][-1] == whole["eval_loss"][-1]


def _tiny_ckpt(tmp_path):
    """A tiny HF checkpoint written by the port (random weights from a
    seed), a fast tokenizer and an alpaca JSON."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format

    d = tmp_path / "tiny_ckpt"
    corpus = ["Below is an instruction that describes a task.",
              "### Instruction: ### Response: the quick brown fox"] * 50
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<pad>", "<unk>", "<s>", "</s>"]))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                                   bos_token="<s>", eos_token="</s>")
    cfg = llama.LlamaConfig.tiny(vocab_size=512)
    save_hf_format(llama.init_params(cfg, seed=0), cfg, str(d), fast)
    data = d / "train.json"
    data.write_text(json.dumps([{"instruction": f"Repeat fox {i}",
                                 "output": "the quick brown fox"} for i in range(24)]))
    return str(d), str(data)
