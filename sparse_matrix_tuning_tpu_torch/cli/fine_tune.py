"""Training entry point (PyTorch port) — the `deepspeed fine_tune.py
--flags` equivalent (reference deepspeed/fine_tune.py:867-1081):

  python -m sparse_matrix_tuning_tpu_torch.cli.fine_tune \
      --model_name_or_path /path/to/TinyLlama-1.1B \
      --data_path /path/to/commonsense_170k.json \
      --matrix_sparsity --full_ft_steps 100 \
      --downsample_attention_blocks_ratio 0.0084 \
      --downsample_mlp_blocks_ratio 0.0084 \
      --output_dir /path/to/out

Channel mode: the warm-up steps only harvest |activation| saliency at the
inputs of q/k/v/gate/up/down, then whole input columns of those linears
train:

  python -m sparse_matrix_tuning_tpu_torch.cli.fine_tune \
      --model_name_or_path /path/to/TinyLlama-1.1B \
      --data_path /path/to/commonsense_170k.json \
      --channel_sparsity --full_ft_steps 100 \
      --num_attention_channel 30 --num_mlp_channel 30 \
      --output_dir /path/to/out

Sparse-only continuation from a plan made elsewhere (smt_plan.json of an
earlier run, matrix or channel): the checkpoint is quantized to int8
while it loads and only the planned blocks (or columns) train over it:

  python -m sparse_matrix_tuning_tpu_torch.cli.fine_tune \
      --model_name_or_path /path/to/TinyLlama-1.1B \
      --data_path /path/to/commonsense_170k.json \
      --matrix_sparsity --frozen_quant int8 \
      --sparse_from_plan /path/to/smt_plan.json --output_dir /path/to/out

(with a channel plan, --channel_sparsity in place of --matrix_sparsity).

A run with an --output_dir keeps its whole train state in
{output_dir}/ckpt at every --save_steps step and epoch end; --resume_from
{output_dir}/ckpt continues it, with the same flags, from where it
stopped (train/checkpoint.py). --dropout p sets the attention dropout of
the training forwards (the einsum attention then runs in training; eval
keeps the fused kernel).

--dtype fp16 trains in fp16 with dynamic loss scaling (from 2^16, doubled
after 2000 good steps): a step whose loss or gradients overflow is skipped
and the scale halved, with an "[fp16] overflow at step ..." line where the
loss itself overflowed. It is refused with --sparse_from_plan, as in the
JAX package (the scaler's state comes from the warm-up).

model_name_or_path must be a local HF checkpoint dir. Runs on the card
(--device cuda, the default, raises when there is none); --device cpu runs
the plain versions of the kernels on the CPU.
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    from sparse_matrix_tuning_tpu_torch.config import build_arg_parser, config_from_args
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
    from sparse_matrix_tuning_tpu_torch.data.sft import make_supervised_data, num_batches
    from sparse_matrix_tuning_tpu_torch.models.hf_io import (
        load_hf_config, load_hf_params, load_hf_tokenizer,
    )
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    from sparse_matrix_tuning_tpu_torch.utils.logging import print_rank_0, set_random_seed

    set_random_seed(cfg.seed)
    print_rank_0(f"[config]\n{cfg.to_json()}")

    if not os.path.isdir(cfg.model_name_or_path):
        raise FileNotFoundError(
            f"{cfg.model_name_or_path}: model_name_or_path must be a local "
            "HF checkpoint directory")

    device = torch.device(args.device)
    print_rank_0(f"[device] {device}")
    tokenizer = load_hf_tokenizer(cfg.model_name_or_path, cfg.max_seq_len,
                                  cfg.add_eot_token)
    model_cfg = load_hf_config(cfg.model_name_or_path)
    if cfg.dropout > 0:
        # reference configure_dropout (deepspeed_helpers.py:577-583): the
        # Llama family exposes attention_dropout
        import dataclasses
        model_cfg = dataclasses.replace(model_cfg, attention_dropout=cfg.dropout)
    params = None
    if not cfg.sparse_from_plan:
        params = load_hf_params(cfg.model_name_or_path, model_cfg,
                                dtype=cfg.param_dtype, device=device)

    train_ds, eval_ds = make_supervised_data(
        cfg.data_path[0], tokenizer, cfg.max_seq_len, cfg.eval_set_ratio, cfg.seed)
    print_rank_0(f"Training data size {len(train_ds)}, "
                 f"validation data set {len(eval_ds)}")

    global_bs = cfg.per_device_ft_batch_size * cfg.gradient_accumulation_steps
    steps_per_epoch = num_batches(len(train_ds), global_bs)
    total_steps = cfg.num_ft_epochs * steps_per_epoch

    if cfg.sparse_from_plan:
        # sparse-only continuation: warm-up and selection ran elsewhere and
        # produced this plan; the base checkpoint is quantized while it loads
        # into the int8 scan state
        from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
        with open(cfg.sparse_from_plan) as f:
            plan = SMTPlan.from_json(f.read())
        trainer = SMTTrainer.sparse_scan_from_hf(cfg, cfg.model_name_or_path, plan,
                                                 total_steps, model_cfg=model_cfg,
                                                 device=device)
    else:
        trainer = SMTTrainer(cfg, model_cfg, params, total_steps, device=device)
        del params
    if cfg.resume_from:
        from sparse_matrix_tuning_tpu_torch.train.checkpoint import restore_checkpoint
        restore_checkpoint(cfg.resume_from, trainer)
        print_rank_0(f"[resume] from {cfg.resume_from} at step {trainer.step} "
                     f"phase {trainer.phase}")
    history = trainer.fit(train_ds, eval_ds, tokenizer.pad_token_id,
                          tokenizer=tokenizer)
    print_rank_0(f"training_loss_list: {history['train_loss'][-20:]}")
    print_rank_0(f"eval_loss_list: {history['eval_loss']}")
    print_rank_0(f"ppl_list: {history['ppl']}")
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
