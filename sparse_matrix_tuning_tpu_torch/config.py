"""Typed configuration for SMT fine-tuning (PyTorch port).

Same dataclass and CLI flag surface as `sparse_matrix_tuning_tpu.config`,
so recipes and CLIs run unchanged. The "auto" policies resolve to the
paths this port implements:

  sparse_impl   auto -> "kernel" for CUDA tensors, "oracle" for CPU tensors
                (resolved per tensor in ops/sparse_linear.py)
  attn_impl     auto -> "fullk" (the K3 attention kernels) for CUDA tensors
                with head_dim 64 or 128, "einsum" otherwise; "flash" runs
                fullk (resolved per call in models/llama.py)
  frozen_quant  auto -> "none";  head_quant auto -> "none"
  scan_layers   auto -> "off"  (eager loop over layers)
  loss_impl     auto -> "full" (materialised fp32 logits)

Options whose implementation has not been ported raise NotImplementedError
when the config is built; none of them silently runs another path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch


@dataclass
class SMTConfig:
    # --- data ---------------------------------------------------------------
    data_path: List[str] = field(default_factory=list)
    eval_set_ratio: float = 0.2
    max_seq_len: int = 2048
    # pad each batch up to the next bucket boundary; `[max_seq_len]` = pad fully
    seq_buckets: Optional[List[int]] = None

    # --- model --------------------------------------------------------------
    model_name_or_path: str = ""
    dropout: float = 0.0
    dtype: str = "bf16"            # {fp16, bf16, fp32}
    compute_fp32_loss: bool = True
    gradient_checkpointing: bool = True
    # sparse-phase override; None = same as gradient_checkpointing
    sparse_gradient_checkpointing: Optional[bool] = None

    # --- optimisation ---------------------------------------------------------
    per_device_ft_batch_size: int = 16
    per_device_eval_batch_size: int = 16
    ft_learning_rate: float = 9.65e-6
    smt_lr: float = 5e-5
    w_decay: float = 0.0
    num_ft_epochs: int = 3
    gradient_accumulation_steps: int = 1
    lr_scheduler_type: str = "linear"   # {linear, cosine, constant}
    lr_warmup_steps: int = 0
    smt_lr_warmup_steps: int = 0
    grad_clip: float = 1.0
    matrix_adam_betas: Sequence[float] = (0.9, 0.95)
    channel_adam_betas: Sequence[float] = (0.95, 0.999)
    warmup_adam_betas: Sequence[float] = (0.9, 0.95)
    adam_eps: float = 1e-8
    init_loss_scale: float = 2.0 ** 16
    loss_scale_window: int = 2000

    # --- SMT ------------------------------------------------------------------
    matrix_sparsity: bool = False
    channel_sparsity: bool = False
    full_ft_steps: int = 0
    downsample_attention_blocks_ratio: float = 0.0084
    downsample_mlp_blocks_ratio: float = -1.0
    num_mlp_channel: int = 30
    num_attention_channel: int = 30
    selection_strategy: str = "no_restriction"   # {no_restriction, norm_dist}
    calculate_strategy: str = "mean_abs"         # {mean_abs, abs_mean, L1, L2}
    no_limit_mixture: bool = False
    qk_scheduler: bool = False
    qk_lr_times: int = 2
    do_gradient_distribution_analysis: bool = False
    # "grad_sum" | "per_step_stats" | "auto" (see train/steps.py)
    saliency_accumulation: str = "auto"
    # "oracle" (plain PyTorch block grad + Adam) | "kernel" (CUDA kernels) | "auto"
    sparse_impl: str = "auto"
    attn_impl: str = "auto"
    frozen_quant: str = "auto"
    frozen_host_offload: bool = True
    head_quant: str = "auto"
    scan_layers: str = "auto"
    sparse_from_plan: Optional[str] = None
    loss_impl: str = "auto"
    vocab_chunk: int = 4096

    # --- schedule / cadence -----------------------------------------------------
    eval_step: int = 30
    save_steps: int = 500
    log_steps: int = 100
    throughput_steps: int = 200
    early_terminate: bool = False

    # --- parallelism ------------------------------------------------------------
    mesh_shape: Optional[List[int]] = None
    mesh_axes: Sequence[str] = ("data", "fsdp", "tensor")

    # --- misc --------------------------------------------------------------------
    output_dir: Optional[str] = None
    seed: int = 1234
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 3
    add_eot_token: bool = False
    resume_from: Optional[str] = None

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if isinstance(self.data_path, str):
            self.data_path = [self.data_path]
        if self.seq_buckets is None:
            self.seq_buckets = _default_buckets(self.max_seq_len)
        if self.matrix_sparsity and self.channel_sparsity:
            raise ValueError("matrix_sparsity and channel_sparsity are mutually exclusive")
        _check_choice("selection_strategy", self.selection_strategy,
                      ("no_restriction", "norm_dist"))
        _check_choice("calculate_strategy", self.calculate_strategy,
                      ("mean_abs", "abs_mean", "L1", "L2"))
        _check_choice("saliency_accumulation", self.saliency_accumulation,
                      ("grad_sum", "per_step_stats", "auto"))
        _check_choice("sparse_impl", self.sparse_impl, ("oracle", "kernel", "auto"))
        _check_choice("dtype", self.dtype, ("fp16", "bf16", "fp32"))
        _check_choice("attn_impl", self.attn_impl, ("einsum", "flash", "fullk", "auto"))
        _check_choice("frozen_quant", self.frozen_quant, ("none", "int8", "auto"))
        _check_choice("head_quant", self.head_quant, ("none", "int8", "auto"))
        _check_choice("scan_layers", self.scan_layers, ("off", "on", "auto"))
        _check_choice("loss_impl", self.loss_impl, ("full", "chunked", "auto"))
        self._refuse_unported()
        # resolve the "auto" policies to what this port implements
        # (attn_impl stays "auto": models/llama.py resolves it per call)
        if self.frozen_quant == "auto":
            self.frozen_quant = "none"
        if self.head_quant == "auto":
            self.head_quant = "none"
        if self.scan_layers == "auto":
            self.scan_layers = "off"
        if self.loss_impl == "auto":
            self.loss_impl = "full"

    def _refuse_unported(self):
        unported = []
        if self.frozen_quant == "int8":
            unported.append("frozen_quant=int8 (int8 frozen base)")
        if self.head_quant == "int8":
            unported.append("head_quant=int8 (int8 lm-head)")
        if self.scan_layers == "on":
            unported.append("scan_layers=on (the port loops over layers eagerly)")
        if self.loss_impl == "chunked":
            unported.append("loss_impl=chunked (ops/loss.py)")
        if self.channel_sparsity:
            unported.append("--channel_sparsity (channel mode)")
        if self.dtype == "fp16":
            unported.append("--dtype fp16 (dynamic loss scaling)")
        if self.resume_from:
            unported.append("--resume_from (checkpoint resume)")
        if self.sparse_from_plan:
            unported.append("--sparse_from_plan (quantize-on-load continuation)")
        if self.dropout > 0:
            unported.append("--dropout > 0 (attention dropout)")
        if self.mesh_shape:
            unported.append("--mesh_shape (multi-device training)")
        if self.profile_dir:
            unported.append("--profile_dir (device tracing)")
        if self.do_gradient_distribution_analysis:
            unported.append("--do_gradient_distribution_analysis")
        if unported:
            raise NotImplementedError(
                "not yet ported to sparse_matrix_tuning_tpu_torch: "
                + "; ".join(unported))

    @property
    def sparse_remat(self) -> bool:
        if self.sparse_gradient_checkpointing is None:
            return self.gradient_checkpointing
        return self.sparse_gradient_checkpointing

    @property
    def param_dtype(self) -> torch.dtype:
        return {"bf16": torch.bfloat16, "fp16": torch.float16,
                "fp32": torch.float32}[self.dtype]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "SMTConfig":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def _check_choice(name: str, value, choices):
    if value not in choices:
        raise ValueError(f"unknown {name} {value!r}")


def _default_buckets(max_seq_len: int) -> List[int]:
    """Power-of-two padding buckets up to max_seq_len (always included)."""
    buckets, b = [], 128
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return buckets


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX package's CLI flags (config.py build_arg_parser), with
    sparse_impl choices {oracle, kernel, auto}."""
    p = argparse.ArgumentParser(description="SMT fine-tuning (PyTorch)")
    d = SMTConfig()
    p.add_argument("--data_path", action="append", type=str, required=True)
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--per_device_ft_batch_size", type=int, default=d.per_device_ft_batch_size)
    p.add_argument("--per_device_eval_batch_size", type=int, default=d.per_device_eval_batch_size)
    p.add_argument("--max_seq_len", type=int, default=d.max_seq_len)
    p.add_argument("--eval_set_ratio", type=float, default=d.eval_set_ratio)
    p.add_argument("--eval_step", type=int, default=d.eval_step)
    p.add_argument("--ft_learning_rate", type=float, default=d.ft_learning_rate)
    p.add_argument("--w_decay", type=float, default=d.w_decay)
    p.add_argument("--num_ft_epochs", type=int, default=d.num_ft_epochs)
    p.add_argument("--gradient_accumulation_steps", type=int, default=d.gradient_accumulation_steps)
    p.add_argument("--lr_scheduler_type", type=str, default=d.lr_scheduler_type,
                   choices=["linear", "cosine", "constant"])
    p.add_argument("--lr_warmup_steps", type=int, default=d.lr_warmup_steps)
    p.add_argument("--smt_lr_warmup_steps", type=int, default=d.smt_lr_warmup_steps)
    p.add_argument("--full_ft_steps", type=int, default=d.full_ft_steps)
    p.add_argument("--dtype", type=str, default=d.dtype, choices=["fp16", "bf16", "fp32"])
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--add_eot_token", action="store_true")
    p.add_argument("--compute_fp32_loss", action="store_true")
    p.add_argument("--matrix_sparsity", action="store_true")
    p.add_argument("--channel_sparsity", action="store_true")
    p.add_argument("--qk_scheduler", action="store_true")
    p.add_argument("--qk_lr_times", type=int, default=d.qk_lr_times)
    p.add_argument("--early_terminate", action="store_true")
    p.add_argument("--downsample_attention_blocks_ratio", type=float,
                   default=d.downsample_attention_blocks_ratio)
    p.add_argument("--downsample_mlp_blocks_ratio", type=float,
                   default=d.downsample_mlp_blocks_ratio)
    p.add_argument("--num_mlp_channel", type=int, default=d.num_mlp_channel)
    p.add_argument("--num_attention_channel", type=int, default=d.num_attention_channel)
    p.add_argument("--selection_strategy", type=str, default=d.selection_strategy)
    p.add_argument("--calculate_strategy", type=str, default=d.calculate_strategy)
    p.add_argument("--no_limit_mixture", action="store_true")
    p.add_argument("--do_gradient_distribution_analysis", action="store_true")
    p.add_argument("--saliency_accumulation", type=str, default=None,
                   choices=["grad_sum", "per_step_stats", "auto"])
    p.add_argument("--smt_lr", type=float, default=d.smt_lr)
    p.add_argument("--sparse_impl", type=str, default=d.sparse_impl,
                   choices=["oracle", "kernel", "auto"])
    p.add_argument("--attn_impl", type=str, default=d.attn_impl,
                   choices=["einsum", "flash", "fullk", "auto"])
    p.add_argument("--frozen_quant", type=str, default=d.frozen_quant,
                   choices=["none", "int8", "auto"])
    p.add_argument("--no_frozen_host_offload", dest="frozen_host_offload",
                   action="store_false")
    p.add_argument("--head_quant", type=str, default=d.head_quant,
                   choices=["none", "int8", "auto"])
    p.add_argument("--scan_layers", type=str, default=d.scan_layers,
                   choices=["off", "on", "auto"])
    p.add_argument("--loss_impl", type=str, default=d.loss_impl,
                   choices=["full", "chunked", "auto"])
    p.add_argument("--vocab_chunk", type=int, default=d.vocab_chunk)
    p.add_argument("--sparse_from_plan", type=str, default=None)
    p.add_argument("--mesh_shape", type=int, nargs="*", default=None)
    p.add_argument("--seq_buckets", type=int, nargs="*", default=None)
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--profile_start", type=int, default=10)
    p.add_argument("--profile_steps", type=int, default=3)
    p.add_argument("--no_gradient_checkpointing", dest="gradient_checkpointing",
                   action="store_false")
    # launcher-compatibility flags, parsed and ignored
    p.add_argument("--local_rank", type=int, default=-1, help="ignored")
    p.add_argument("--zero_stage", type=int, default=0, help="ignored")
    p.add_argument("--offload", action="store_true", help="ignored")
    p.add_argument("--sparse_gradient_checkpointing", type=lambda s: s == "true",
                   choices=[True, False], default=None, metavar="{true,false}",
                   help="override remat for the sparse phase only")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> SMTConfig:
    ns = build_arg_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(SMTConfig)}
    kwargs = {k: v for k, v in vars(ns).items() if k in known and v is not None}
    # store_true defaults (False) must not override dataclass defaults of True
    if "compute_fp32_loss" in kwargs and not ns.compute_fp32_loss:
        kwargs.pop("compute_fp32_loss")
    return SMTConfig(**kwargs)

