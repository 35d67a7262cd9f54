"""The port's generation eval on the CPU against the JAX package, on the same
carried-over fp32 weights: greedy with and without repetition penalty,
beam-4, beam with early EOS, EOS-then-pad, int8-cache greedy and beam, each
through the einsum attention and through K7's plain version (tokens must be
identical); the logits processors; seeded sampling; the harness's answer
extraction and accuracy; and the run_commonsense CLI end to end (same
summary.json and predictions as the JAX CLI)."""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.eval import harness as jharness
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.eval import generate as pgen
from sparse_matrix_tuning_tpu_torch.eval import harness
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

# the JAX eval package re-exports a function named generate over its module
jgen = importlib.import_module("sparse_matrix_tuning_tpu.eval.generate")
JCFG = JaxLlamaConfig.tiny()
PCFG = LlamaConfig.tiny()
EOS, PAD = 2, 0


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, tp.port_params(jp)


def _prompts(seed, lens=(5, 8, 11), width=12):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), width), np.int32)
    mask = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(3, JCFG.vocab_size, n)
        mask[i, width - n:] = 1
    return ids, mask


def _eos_boosted(jp, scale):
    """Both packages' params with the EOS logit raised (lm_head row 2 +=
    scale * norm, the JAX suite's early-EOS construction)."""
    boost = np.zeros((JCFG.vocab_size, JCFG.hidden_size), np.float32)
    boost[EOS] = np.asarray(jp["norm"]) * scale
    jb = dict(jp)
    jb["lm_head"] = jp["lm_head"] + jnp.asarray(boost)
    return jb, tp.port_params(jb)


def _generate_both(jp, pp, ids, mask, attn, **kw):
    kw = {"max_new_tokens": 10, "eos_token_id": EOS, "pad_token_id": PAD,
          "cache_dtype": "float32", **kw}
    want = jgen.generate(jp, JCFG, ids, mask, jgen.GenerationConfig(**kw))
    got = pgen.generate(pp, PCFG, ids, mask, pgen.GenerationConfig(**kw), device="cpu")
    return got, want


CASES = {
    "greedy": dict(num_beams=1),
    "greedy-rep1.1": dict(num_beams=1, repetition_penalty=1.1),
    "beam4-rep1.1": dict(num_beams=4, repetition_penalty=1.1),
    "greedy-int8": dict(num_beams=1, cache_dtype="int8"),
    "beam4-int8": dict(num_beams=4, repetition_penalty=1.1, cache_dtype="int8"),
}


@pytest.mark.parametrize("attn", ["off", "on"], ids=["einsum", "k7-plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_tokens_match_jax(weights, monkeypatch, case, attn):
    monkeypatch.setenv("SMT_CACHED_ATTN", attn)
    ids, mask = _prompts(seed=len(case))
    got, want = _generate_both(*weights, ids, mask, attn, **CASES[case])
    assert got.shape == want.shape == (3, 10) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attn", ["off", "on"], ids=["einsum", "k7-plain"])
def test_beam_with_early_eos_matches_jax(weights, monkeypatch, attn):
    """EOS competitive, so beams finish at different steps: the finished-
    hypothesis bookkeeping and the rank < K EOS gate."""
    monkeypatch.setenv("SMT_CACHED_ATTN", attn)
    jb, pb = _eos_boosted(weights[0], 0.35)
    ids, mask = _prompts(seed=4, lens=(5, 9, 7, 12))
    got, want = _generate_both(jb, pb, ids, mask, attn, num_beams=4, repetition_penalty=1.1)
    assert (want == EOS).any()
    np.testing.assert_array_equal(got, want)


def test_eos_then_pad_matches_jax(weights, monkeypatch):
    monkeypatch.setenv("SMT_CACHED_ATTN", "on")
    jb, pb = _eos_boosted(weights[0], 0.3)
    ids, mask = _prompts(seed=2, lens=(4, 7), width=8)
    got, want = _generate_both(jb, pb, ids, mask, "on", num_beams=1, max_new_tokens=20)
    np.testing.assert_array_equal(got, want)
    finished = 0
    for row in got:
        eos_pos = np.where(row == EOS)[0]
        if eos_pos.size:
            finished += 1
            assert (row[eos_pos[0] + 1:] == PAD).all()
    assert finished


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9), (40, 0.5)])
def test_logits_processors_match_jax(top_k, top_p):
    logits = tp.seeded_normal((4, 512), seed=top_k + int(10 * top_p), scale=3.0)
    seen = np.random.default_rng(1).random((4, 512)) < 0.2
    want = jgen._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), 1.1)
    got = pgen._apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen), 1.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jgen._filter_logits(want, top_k, top_p)
    got = pgen._filter_logits(got, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > pgen.NEG_INF).sum(-1).min() >= 1


def test_scatter_seen_matches_jax():
    ids, _ = _prompts(seed=1)
    want = jgen._scatter_seen(jnp.zeros((3, 512), bool), jnp.asarray(ids))
    got = pgen._scatter_seen(torch.zeros((3, 512), dtype=torch.bool), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, PAD].all()  # pads count as seen, as in JAX


def test_sampling_is_seeded_by_call_idx(weights):
    _, pp = weights
    ids, mask = _prompts(seed=7)
    gen = pgen.GenerationConfig(max_new_tokens=8, do_sample=True, top_k=50, top_p=0.95,
                                temperature=0.8, seed=3, eos_token_id=EOS, cache_dtype="float32")
    a = pgen.generate(pp, PCFG, ids, mask, gen, call_idx=0, device="cpu")
    b = pgen.generate(pp, PCFG, ids, mask, gen, call_idx=0, device="cpu")
    c = pgen.generate(pp, PCFG, ids, mask, gen, call_idx=1, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert ((a >= 0) & (a < PCFG.vocab_size)).all()


def test_generate_refuses_bad_requests(weights):
    _, pp = weights
    ids, mask = _prompts(seed=0)
    with pytest.raises(ValueError, match="num_beams=1"):
        pgen.generate(pp, PCFG, ids, mask, pgen.GenerationConfig(do_sample=True, num_beams=4),
                      device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        pgen.generate(pp, PCFG, ids, mask,
                      pgen.GenerationConfig(do_sample=True, temperature=0.0), device="cpu")
    with pytest.raises(ValueError, match="params are on cpu"):
        pgen.generate(pp, PCFG, ids, mask, pgen.GenerationConfig())  # default: the card
    with pytest.raises(NotImplementedError, match="slice 3"):
        pgen.decode_params_from_scan({}, PCFG)


def test_trainer_decode_params_feed_generate():
    """A fine-tune's result goes straight into generate: decode_params() is
    the merged dense params, in warm-up and after conversion."""
    cfg = SMTConfig(data_path=["x"], model_name_or_path="m", dtype="fp32", matrix_sparsity=True,
                    full_ft_steps=1, downsample_attention_blocks_ratio=0.05,
                    downsample_mlp_blocks_ratio=0.05, gradient_checkpointing=False)
    trainer = SMTTrainer(cfg, PCFG, init_params(PCFG, seed=0), total_steps=3)
    for batch in tp.lm_batches(2, vocab=PCFG.vocab_size):
        trainer.train_step(batch)
        tp.assert_trees_equal(trainer.decode_params(),
                              tp.numpy_tree(trainer.merged_params()))
    assert trainer.phase == "sparse"
    ids, mask = _prompts(seed=8)
    out = pgen.generate(trainer.decode_params(), PCFG, ids, mask,
                        pgen.GenerationConfig(max_new_tokens=4, num_beams=4,
                                              cache_dtype="float32"), device="cpu")
    assert out.shape == (3, 4) and ((out >= 0) & (out < PCFG.vocab_size)).all()


# ---------------------------------------------------------------------------
# harness and CLI
# ---------------------------------------------------------------------------

SENTENCES = ["The answer is True.", "false then true", "no idea", "I pick Solution2",
             "answer3, or answer1", "ending4 is right", "option1", "clearly answer5.",
             "So the result is 42 dollars", "= 1,234.5.", "-3 apples", "the answer is (c)",
             "b or d", ""]


def test_extract_answer_matches_jax():
    for ds in harness.COMMONSENSE_DATASETS + harness.MATH_DATASETS:
        for s in SENTENCES:
            assert harness.extract_answer(ds, s) == jharness.extract_answer(ds, s), (ds, s)
    with pytest.raises(ValueError, match="unknown dataset"):
        harness.extract_answer("mmlu", "a")


@pytest.mark.parametrize("dataset", ["boolq", "gsm8k", "AQuA"])
def test_run_dataset_eval_matches_jax(tmp_path, dataset):
    answers = {"boolq": ["true", "true", "false"], "gsm8k": ["42", "1234.5", "7"],
               "AQuA": ["c", "a", "b"]}[dataset]
    examples = [{"instruction": f"question {i}", "answer": a} for i, a in enumerate(answers)]
    outputs = {"boolq": ["True!", "it is true", "no"],
               "gsm8k": ["so 42", "= 1,234.5.", "8"],
               "AQuA": ["(c)", "a", "none"]}[dataset]
    prompts_seen = []

    def fn(prompts):
        prompts_seen.append(list(prompts))
        return outputs

    got = harness.run_dataset_eval(dataset, examples, fn, output_dir=str(tmp_path / "port"))
    want = jharness.run_dataset_eval(dataset, examples, fn, output_dir=str(tmp_path / "jax"))
    assert prompts_seen[0] == prompts_seen[1]
    assert got == want and got["accuracy"] == pytest.approx(2 / 3)
    name = f"{dataset}/model_predictions.jsonl"
    assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


@pytest.fixture(scope="module")
def tiny_hf_dir(tmp_path_factory):
    """A local HF checkpoint: tiny Llama weights and a trained BPE fast
    tokenizer (tests/test_cli.py's construction)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("tiny_ckpt")
    corpus = ["Below is an instruction that describes a task.",
              "Write a response that appropriately completes the request.",
              "### Instruction: ### Response: true false solution1 solution2",
              "the quick brown fox jumps over the lazy dog 1 2 3 4 5"] * 50
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<pad>", "<unk>", "<s>", "</s>"]))
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>").save_pretrained(d)
    hf_cfg = HFConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512, tie_word_embeddings=False,
                      attention_bias=False)
    torch.manual_seed(0)
    LlamaForCausalLM(hf_cfg).save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.mark.parametrize("beams", [4, 1])
def test_cli_matches_jax(tiny_hf_dir, tmp_path, beams):
    from sparse_matrix_tuning_tpu.cli.run_commonsense import main as jax_main
    from sparse_matrix_tuning_tpu_torch.cli.run_commonsense import main

    data = tmp_path / "cs"
    for ds, answer in (("boolq", "true"), ("gsm8k", "4")):
        (data / ds).mkdir(parents=True)
        examples = [{"instruction": f"Is the fox quick? {i} {'word ' * (3 * i)}",
                     "answer": answer} for i in range(4)]
        (data / ds / "test.json").write_text(json.dumps(examples))
    args = ["--model_name_or_path", tiny_hf_dir, "--data_path", str(data),
            "--datasets", "boolq", "gsm8k", "--per_device_eval_batch_size", "3",
            "--max_new_tokens", "6", "--num_beams", str(beams), "--dtype", "fp32"]
    want = jax_main(args + ["--output_dir", str(tmp_path / "jax")])
    got = main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want
    for name in ("summary.json", "boolq/model_predictions.jsonl",
                 "gsm8k/model_predictions.jsonl"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    preds = (tmp_path / "port" / "boolq" / "model_predictions.jsonl").read_text().splitlines()
    assert len(preds) == 4 and any(json.loads(p)["raw_output"] for p in preds)


def test_cli_refuses_what_is_not_ported(tmp_path):
    from sparse_matrix_tuning_tpu_torch.cli.run_commonsense import build_parser, main
    base = ["--model_name_or_path", str(tmp_path), "--data_path", str(tmp_path)]
    for quant in ("int8", "int4"):
        with pytest.raises(NotImplementedError, match="slice 2"):
            main(base + ["--frozen_quant", quant, "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(base + ["--top_k", "5", "--device", "cpu"])  # sampling knob without --do_sample
    assert build_parser().parse_args(base + ["--kv_cache", "int8"]).kv_cache == "int8"
    assert build_parser().parse_args(base).device == "cuda"
