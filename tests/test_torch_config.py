"""The port's config and CLI: the JAX package's flag surface, the "auto"
policies resolved to what the port implements, the fused attention and
int8 options, channel mode, a loud NotImplementedError for every option
not yet ported,
and the fine-tune CLI end to end on a tiny HF checkpoint (whose safetensors
the port reads by hand) on CPU, over the dense and the int8 frozen base."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.config import parse_args as jax_parse_args
from sparse_matrix_tuning_tpu_torch.config import SMTConfig, parse_args

RECIPE = ["--model_name_or_path", "m", "--data_path", "d.json",
          "--per_device_ft_batch_size", "16", "--max_seq_len", "2048",
          "--ft_learning_rate", "9.865e-6", "--num_ft_epochs", "3",
          "--lr_warmup_steps", "100", "--seed", "1234", "--smt_lr", "9.865e-6",
          "--eval_step", "30", "--matrix_sparsity",
          "--selection_strategy", "no_restriction", "--calculate_strategy", "abs_mean",
          "--downsample_mlp_blocks_ratio", "0.0084",
          "--downsample_attention_blocks_ratio", "0.0084", "--full_ft_steps", "100"]
POLICIES = ("sparse_impl", "attn_impl", "frozen_quant", "head_quant", "scan_layers",
            "loss_impl")


def test_recipe_flags_parse_like_jax():
    """recipes/smt_commonsense.sh's flags give the same config in both
    packages, apart from the device policies the port resolves itself."""
    mine = dataclasses.asdict(parse_args(RECIPE))
    theirs = dataclasses.asdict(jax_parse_args(RECIPE))
    assert mine.keys() == theirs.keys()
    for k in mine:
        if k not in POLICIES:
            assert mine[k] == theirs[k], k
    assert parse_args(RECIPE).param_dtype == torch.bfloat16


def test_auto_policies_resolve_to_ported_paths():
    """scan_layers stays "auto": the trainer resolves it per mode and depth
    (train/scan_phase.resolve_scan_layers, tests/test_torch_scan_convert.py)."""
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.train.scan_phase import resolve_scan_layers
    cfg = SMTConfig()
    assert (cfg.sparse_impl, cfg.attn_impl, cfg.frozen_quant, cfg.head_quant,
            cfg.scan_layers, cfg.loss_impl) == ("auto", "auto", "none", "none",
                                                 "auto", "auto")
    assert not resolve_scan_layers(cfg, LlamaConfig(), "matrix")
    assert resolve_scan_layers(SMTConfig(channel_sparsity=True, frozen_quant="int8"),
                               LlamaConfig(), "channel")
    assert SMTConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
    assert {f.name for f in dataclasses.fields(SMTConfig)} == \
        {f.name for f in dataclasses.fields(JaxSMTConfig)}


@pytest.mark.parametrize("impl", ["fullk", "flash"])
def test_fused_attention_options_construct(impl):
    """--attn_impl fullk|flash build, keep their value (resolved per call
    by the model) and resolve to the K3 kernel path."""
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, resolve_attn_impl
    cfg = parse_args(RECIPE + ["--attn_impl", impl])
    assert cfg.attn_impl == impl
    assert resolve_attn_impl(cfg.attn_impl, LlamaConfig().head_dim, "cuda") == "fullk"
    assert resolve_attn_impl(cfg.attn_impl, LlamaConfig().head_dim, "cpu") == "fullk"


@pytest.mark.parametrize("flags,want", [
    (["--frozen_quant", "int8"], ("int8", "int8", True, "auto")),
    (["--frozen_quant", "int8", "--no_frozen_host_offload", "--head_quant", "none"],
     ("int8", "none", False, "auto")),
    (["--head_quant", "int8"], ("none", "int8", True, "auto")),
    (["--loss_impl", "chunked", "--vocab_chunk", "1024"], ("none", "none", True, "chunked")),
], ids=["int8", "int8-resident-dense-head", "q8-head", "chunked"])
def test_int8_and_loss_options_construct(flags, want):
    """--frozen_quant int8 (K4, K5), --head_quant int8 and --loss_impl
    chunked build; head_quant "auto" follows the frozen base."""
    cfg = parse_args(RECIPE + flags)
    assert (cfg.frozen_quant, cfg.head_quant, cfg.frozen_host_offload, cfg.loss_impl) == want
    assert SMTConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()


# ported since the list was written, each with its tests: channel mode
# (tests/test_torch_channel.py), scan_layers=on, --resume_from, --dropout and
# --dtype fp16 (tests/test_torch_scan_convert.py, test_torch_checkpoint.py,
# test_torch_dropout.py, test_torch_fp16.py): these build and parse as in JAX
PORTED = {"channel_sparsity": ["--channel_sparsity"], "scan_layers": ["--scan_layers", "on"],
          "resume_from": ["--resume_from", "ckpt"], "dropout": ["--dropout", "0.1"],
          "dtype": ["--dtype", "fp16"]}


@pytest.mark.parametrize("kw", [
    dict(scan_layers="on"),
    dict(channel_sparsity=True), dict(dtype="fp16"), dict(resume_from="ckpt"),
    dict(dropout=0.1), dict(mesh_shape=[1, 2, 1]),
    dict(profile_dir="prof"), dict(do_gradient_distribution_analysis=True),
], ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values()))))
def test_unported_options_raise(kw):
    name, value = next(iter(kw.items()))
    if name in PORTED:
        flags = RECIPE + PORTED[name]
        if name == "channel_sparsity":
            flags = [f for f in flags if f != "--matrix_sparsity"]
        mine, theirs = dataclasses.asdict(parse_args(flags)), dataclasses.asdict(
            jax_parse_args(flags))
        assert mine[name] == theirs[name] == value
        assert {k: v for k, v in mine.items() if k not in POLICIES} == \
            {k: v for k, v in theirs.items() if k not in POLICIES}
        assert getattr(SMTConfig(**kw), name) == value
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        SMTConfig(**kw)


def test_sparse_from_plan_parses_and_dispatches(tiny_hf, tmp_path, monkeypatch):
    """--sparse_from_plan builds (as in JAX) and sends the CLI to
    SMTTrainer.sparse_scan_from_hf with the plan read from the file; the
    dense params are never loaded."""
    from sparse_matrix_tuning_tpu_torch.cli import fine_tune
    from sparse_matrix_tuning_tpu_torch.models import hf_io
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    flags = ["--frozen_quant", "int8", "--sparse_from_plan", "p.json"]
    assert parse_args(RECIPE + flags).sparse_from_plan == "p.json" == \
        jax_parse_args(RECIPE + flags).sparse_from_plan

    plan = SMTPlan("matrix", {"1.q_proj": LinearPlan("q_proj", 1, 256, 256, ((0, 0),))})
    (tmp_path / "plan.json").write_text(plan.to_json())
    seen = {}

    def entry(cfg, model_dir, got_plan, total_steps, model_cfg=None, device=None):
        seen.update(plan=got_plan.to_json(), model_dir=model_dir, device=str(device))
        raise StopIteration

    def no_dense_load(*a, **k):
        raise AssertionError("the dense params were loaded")

    monkeypatch.setattr(SMTTrainer, "sparse_scan_from_hf", staticmethod(entry))
    monkeypatch.setattr(hf_io, "load_hf_params", no_dense_load)
    _, d, data = tiny_hf
    with pytest.raises(StopIteration):
        fine_tune.main(["--model_name_or_path", d, "--data_path", data, "--device", "cpu",
                        "--matrix_sparsity", "--frozen_quant", "int8", "--dtype", "fp32",
                        "--sparse_from_plan", str(tmp_path / "plan.json")])
    assert seen == {"plan": plan.to_json(), "model_dir": d, "device": "cpu"}


def test_bad_values_raise_value_error():
    with pytest.raises(ValueError, match="sparse_impl"):
        SMTConfig(sparse_impl="pallas")
    with pytest.raises(ValueError, match="calculate_strategy"):
        SMTConfig(calculate_strategy="L3")


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    """Tiny HF Llama + fast tokenizer + alpaca JSON, as tests/test_cli.py."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("tiny_ckpt")
    corpus = ["Below is an instruction that describes a task.",
              "Write a response that appropriately completes the request.",
              "### Instruction: ### Response: the quick brown fox"] * 50
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
    model = LlamaForCausalLM(hf_cfg).eval()
    model.save_pretrained(d, safe_serialization=True)
    data = d / "train.json"
    data.write_text(json.dumps([{"instruction": f"Repeat fox {i}",
                                 "output": "the quick brown fox"} for i in range(16)]))
    return model, str(d), str(data)


def test_forward_matches_hf_transformers(tiny_hf):
    """The port's forward on the HF checkpoint, read by the hand-written
    safetensors reader, against transformers (tests/test_model.py's 2e-4)."""
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_config, load_hf_params
    from sparse_matrix_tuning_tpu_torch.models.llama import forward
    model, d, _ = tiny_hf
    cfg = load_hf_config(d)
    params = load_hf_params(d, cfg, dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 12)))
    mask = torch.ones((2, 12), dtype=torch.int64)
    mask[1, 9:] = 0
    with torch.no_grad():
        ref = model(input_ids=ids, attention_mask=mask).logits
        got = forward(params, ids, cfg, attention_mask=mask)
    tp.assert_close(got[0], ref[0], rtol=2e-4, atol=2e-4)
    tp.assert_close(got[1, :9], ref[1, :9], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("extra", [[], ["--frozen_quant", "int8"]], ids=["dense", "int8"])
def test_fine_tune_cli_end_to_end(tiny_hf, tmp_path, extra):
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    _, d, data = tiny_hf
    out = tmp_path / "out"
    history = main(extra + [
        "--model_name_or_path", d, "--data_path", data, "--output_dir", str(out),
        "--device", "cpu",
        "--matrix_sparsity", "--full_ft_steps", "1",
        "--downsample_attention_blocks_ratio", "0.2",
        "--downsample_mlp_blocks_ratio", "0.2",
        "--per_device_ft_batch_size", "2", "--per_device_eval_batch_size", "2",
        "--num_ft_epochs", "1", "--max_seq_len", "64", "--eval_step", "2",
        "--dtype", "fp32", "--ft_learning_rate", "1e-3", "--smt_lr", "1e-3",
    ])
    assert len(history["train_loss"]) >= 3
    assert np.isfinite(history["train_loss"]).all() and np.isfinite(history["eval_loss"]).all()
    for name in ("model.safetensors", "smt_plan.json", "tokenizer_config.json", "config.json"):
        assert (out / "final" / name).exists(), name
    phases = [json.loads(line)["phase"] for line in
              (out / "metrics.jsonl").read_text().splitlines()]
    assert phases[0] == "warmup" and phases[-1] == "sparse"
    # the export is a whole dense checkpoint, from the int8 run too
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_config, load_hf_params
    back = load_hf_params(str(out / "final"), load_hf_config(str(out / "final")),
                          dtype=torch.float32)
    assert back["layers"]["0"]["q_proj"].shape == (256, 256) and back["lm_head"].shape == (512, 256)


def test_fine_tune_cli_cuda_without_a_card_raises(tiny_hf, tmp_path, monkeypatch):
    """The trainer runs on the card unless --device cpu is given: without
    CUDA, the default raises before any step and never falls back."""
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from sparse_matrix_tuning_tpu_torch.config import build_arg_parser
    _, d, data = tiny_hf
    out = tmp_path / "out"
    args = ["--model_name_or_path", d, "--data_path", data, "--output_dir", str(out),
            "--matrix_sparsity", "--full_ft_steps", "1", "--dtype", "fp32"]
    assert build_arg_parser().parse_args(args).device == "cuda"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args + extra)
    assert not out.exists()
