"""Data-parallel checkpoints and CLIs on the CPU (tests/test_torch_parallel.py
holds the steps): two gloo ranks spawned by torch.multiprocessing
(tests/torch_dp_ranks.py, which imports no JAX).

  * a checkpoint written at D=2 (rank 0 writes, between barriers) resumes
    bit for bit on both ranks, inside the sparse phase and inside channel
    mode's warm-up (whose |x| sums every rank holds for the global rows);
    a restore at D=1 is refused by name (fit's batch skip counts global
    batches);
  * `cli.fine_tune --mesh_shape 2,1,1 --device cpu` under torchrun's
    environment trains to its export as the one-process CLI does at the
    same global batch;
  * `cli.run_commonsense` under torchrun's environment splits the prompts
    by rank stride and gathers the completions: the same summary and
    predictions as one process, written by rank 0 alone.
"""
import json

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp
from test_torch_parallel import MODEL, N_WARMUP, _cfg, batches

from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params

D = 2


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    """A tiny HF Llama, a fast BPE tokenizer, an alpaca JSON and a
    commonsense test set (tests/test_torch_config.py's construction)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("tiny_ckpt")
    corpus = ["Below is an instruction that describes a task.",
              "Write a response that appropriately completes the request.",
              "### Instruction: ### Response: the quick brown fox true false"] * 50
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<pad>", "<unk>", "<s>", "</s>"]))
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>").save_pretrained(d)
    hf_cfg = HFConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512, tie_word_embeddings=False,
                      attention_bias=False)
    torch.manual_seed(0)
    LlamaForCausalLM(hf_cfg).save_pretrained(d, safe_serialization=True)
    (d / "train.json").write_text(json.dumps(
        [{"instruction": f"Repeat fox {i} {'fox ' * (i % 5)}", "output": "the quick brown fox"}
         for i in range(16)]))
    cs = d / "cs" / "boolq"
    cs.mkdir(parents=True)
    cs.joinpath("test.json").write_text(json.dumps(
        [{"instruction": f"Is the fox quick? {i} {'word ' * (2 * i)}", "answer": "true"}
         for i in range(5)]))
    return str(d)


# ---------------------------------------------------------------------------
# checkpoint at D=2
# ---------------------------------------------------------------------------

def _resume_at_d2(tmp_path, cfg, stop):
    """Both ranks' straight and resumed runs (torch_dp_ranks.checkpoint_ranks),
    held to each other: losses, leaf checksums after every step, plans and
    last leaves equal, and the two ranks' runs equal."""
    params = tp.port_params(jax_init_params(jax.random.PRNGKey(0),
                                            JaxLlamaConfig.tiny(vocab_size=256)))
    torch.save(params, tmp_path / "params.pt")
    torch.save(batches(N_WARMUP + 3), tmp_path / "batches.pt")
    spec = {"cfg": cfg, "model": MODEL, "total_steps": N_WARMUP + 3,
            "params": str(tmp_path / "params.pt"), "batches": str(tmp_path / "batches.pt")}
    ranks.spawn(ranks.checkpoint_ranks, D, tmp_path, spec, stop, str(tmp_path))
    got = [torch.load(tmp_path / f"ckpt.{r}.pt", weights_only=False) for r in range(D)]
    for r, g in enumerate(got):
        assert g["phase"] == "sparse"
        assert g["resumed"] == g["straight"], r
        for i, (a, b) in enumerate(zip(g["resumed_sums"], g["straight_sums"])):
            differ = sorted(k for k in a if a[k] != b.get(k))
            assert set(a) == set(b) and not differ, f"rank {r} step {i + 1}: {differ}"
        assert g["fingerprints"][0] == g["fingerprints"][1]
        assert set(g["resumed_leaves"]) == set(g["straight_leaves"])
        for k, v in g["straight_leaves"].items():
            assert torch.equal(g["resumed_leaves"][k], v), k
    assert got[0]["straight"] == got[1]["straight"]
    assert got[0]["straight_sums"] == got[1]["straight_sums"]
    return got, params


def test_checkpoint_resumes_bit_for_bit_at_d2_and_refuses_d1(tmp_path):
    stop = N_WARMUP + 1  # inside the sparse phase
    cfg = _cfg(output_dir=str(tmp_path / "out"))
    got, params = _resume_at_d2(tmp_path, cfg, stop)
    assert got[0]["saved_phase"] == "sparse"
    meta = json.loads((tmp_path / "out" / "ckpt" / "meta.json").read_text())
    assert meta["mesh"] == [2, 1, 1] and meta["phase"] == "sparse"

    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.train.checkpoint import restore_checkpoint
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    one = SMTTrainer(SMTConfig(**cfg), LlamaConfig(**MODEL), params, total_steps=5)
    with pytest.raises(ValueError, match="--mesh_shape 2,1,1"):
        restore_checkpoint(str(tmp_path / "out" / "ckpt"), one)


def test_channel_checkpoint_mid_warmup_resumes_at_d2(tmp_path):
    """Channel mode stopped inside its warm-up: the checkpoint rank 0
    writes holds the |x| sums of the global rows seen so far, which every
    rank restores; the resumed ranks' sums, plan and sparse steps are the
    straight run's."""
    got, _ = _resume_at_d2(tmp_path, _cfg("channel", output_dir=str(tmp_path / "out")), 1)
    assert got[0]["saved_phase"] == "warmup"
    assert any(k.startswith("act_acc/") for k in got[0]["straight_sums"][0])


# ---------------------------------------------------------------------------
# the CLIs under torchrun's environment
# ---------------------------------------------------------------------------

def _fine_tune_args(d, out, per_device):
    return ["--model_name_or_path", d, "--data_path", f"{d}/train.json",
            "--output_dir", str(out), "--device", "cpu", "--matrix_sparsity",
            "--full_ft_steps", "1", "--downsample_attention_blocks_ratio", "0.2",
            "--downsample_mlp_blocks_ratio", "0.2", "--per_device_ft_batch_size", str(per_device),
            "--per_device_eval_batch_size", str(per_device), "--num_ft_epochs", "1",
            "--max_seq_len", "64", "--eval_step", "2", "--dtype", "fp32",
            "--ft_learning_rate", "1e-3", "--smt_lr", "1e-3", "--seed", "0"]


def test_fine_tune_cli_at_d2_matches_one_process(tiny_hf, tmp_path):
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    argv = _fine_tune_args(tiny_hf, tmp_path / "d2", 2) + ["--mesh_shape", "2,1,1"]
    ranks.spawn(ranks.cli_ranks, D, tmp_path, "sparse_matrix_tuning_tpu_torch.cli.fine_tune",
                argv, str(tmp_path))
    got = [torch.load(tmp_path / f"cli.{r}.pt", weights_only=False)["result"] for r in range(D)]
    want = main(_fine_tune_args(tiny_hf, tmp_path / "d1", 2 * D))
    assert got[0] == got[1]
    assert len(got[0]["train_loss"]) == len(want["train_loss"]) == 3
    np.testing.assert_allclose(got[0]["train_loss"], want["train_loss"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[0]["eval_loss"], want["eval_loss"], rtol=1e-5, atol=0)
    d2, d1 = tmp_path / "d2", tmp_path / "d1"
    assert (d2 / "final" / "smt_plan.json").read_text() == (d1 / "final" / "smt_plan.json") \
        .read_text()
    lines = (d2 / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3  # rank 0 alone writes
    assert json.loads(lines[0])["phase"] == "warmup" and json.loads(lines[-1])["phase"] == "sparse"


def test_fine_tune_cli_mesh_without_a_card_raises(tiny_hf, tmp_path, monkeypatch):
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _fine_tune_args(tiny_hf, tmp_path, 2) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--mesh_shape", "2,1,1"])
    assert not torch.distributed.is_initialized()


def test_eval_cli_at_d2_matches_one_process(tiny_hf, tmp_path):
    from sparse_matrix_tuning_tpu_torch.cli.run_commonsense import main
    args = ["--model_name_or_path", tiny_hf, "--data_path", f"{tiny_hf}/cs", "--datasets",
            "boolq", "--per_device_eval_batch_size", "2", "--max_new_tokens", "6",
            "--num_beams", "4", "--dtype", "fp32", "--device", "cpu"]
    ranks.spawn(ranks.cli_ranks, D, tmp_path, "sparse_matrix_tuning_tpu_torch.cli.run_commonsense",
                args + ["--output_dir", str(tmp_path / "d2")], str(tmp_path))
    want = main(args + ["--output_dir", str(tmp_path / "d1")])
    got = [torch.load(tmp_path / f"cli.{r}.pt", weights_only=False)["result"] for r in range(D)]
    assert got[0] == got[1] == want
    for name in ("summary.json", "boolq/model_predictions.jsonl"):
        assert (tmp_path / "d2" / name).read_text() == (tmp_path / "d1" / name).read_text()
    preds = (tmp_path / "d2" / "boolq" / "model_predictions.jsonl").read_text().splitlines()
    assert len(preds) == 5 and any(json.loads(p)["raw_output"] for p in preds)
