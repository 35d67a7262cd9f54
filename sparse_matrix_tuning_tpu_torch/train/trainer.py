"""Two-phase SMT trainer — the orchestration layer (PyTorch twin of
`sparse_matrix_tuning_tpu.train.trainer`, matrix mode on one device).

Warm-up -> the one-shot conversion event -> sparse fine-tuning, with the
eval/save cadences and throughput prints of reference
deepspeed/fine_tune.py:72-864.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import (
    LlamaConfig, all_2d_param_shapes, flatten_tree, resolve_attn_impl, tree_map)
from sparse_matrix_tuning_tpu_torch.smt.optimizer import make_lr_schedule
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
from sparse_matrix_tuning_tpu_torch.train import convert as convert_mod
from sparse_matrix_tuning_tpu_torch.train.steps import (
    build_eval_step, build_sparse_step, build_warmup_step, init_warmup_state,
)
from sparse_matrix_tuning_tpu_torch.utils.logging import print_rank_0
from sparse_matrix_tuning_tpu_torch.utils.throughput import ThroughputReporter


class SMTTrainer:
    """Drives warm-up -> selection/conversion -> sparse fine-tuning.

    params: initial model params (any float dtype; copied to an fp32 master
    on `device`, default the params' device). total_steps: optimizer-step
    horizon for the LR schedule (num_ft_epochs * steps_per_epoch)."""

    def __init__(self, cfg: SMTConfig, model_cfg: LlamaConfig, params,
                 total_steps: int, device=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.total_steps = int(total_steps)
        self.device = torch.device(device if device is not None
                                   else params["embed_tokens"].device)
        self.plan: Optional[SMTPlan] = None
        self.phase = "warmup"
        self._padding_checked = False
        self._all_2d_shapes = all_2d_param_shapes(params)

        self.state = init_warmup_state(params, cfg, device=self.device)
        warmup_sched = make_lr_schedule(cfg.lr_scheduler_type, cfg.ft_learning_rate,
                                        cfg.lr_warmup_steps, self.total_steps)
        self._warmup_step = build_warmup_step(cfg, model_cfg, warmup_sched)
        self._sparse_step = None  # built at conversion
        self._eval_step = build_eval_step(cfg, model_cfg)

        self.history: Dict[str, list] = {"train_loss": [], "eval_loss": [], "ppl": []}
        self.best_eval_loss = float("inf")
        self.reporter: Optional[ThroughputReporter] = None

    # -- conversion ---------------------------------------------------------------

    @property
    def step(self) -> int:
        return int(self.state["step"])

    @property
    def is_smt(self) -> bool:
        return self.cfg.matrix_sparsity

    def maybe_convert(self):
        if self.phase != "warmup" or not self.is_smt:
            return
        if self.step < self.cfg.full_ft_steps:
            return
        t0 = time.time()
        self.plan, sparse_state = convert_mod.convert(
            self.cfg, self.state, self._all_2d_shapes)
        self.state = sparse_state  # drops the warm-up master, moments, accumulators
        self.install_sparse_phase()

        total = sum(p.numel() for p in flatten_tree(self.state["params"]).values())
        sel = self.plan.trainable_params
        print_rank_0(
            f"[smt] converted at step {self.step} in {time.time() - t0:.1f}s: "
            f"{len(self.plan.linears)} linears, {sel:,} trainable "
            f"({100.0 * sel / total:.3f}% of {total:,})")

    def install_sparse_phase(self):
        """Switch to phase 2: the sparse step with its LR schedule over the
        remaining horizon at smt_lr (reference fine_tune.py:366-372, with
        the group-lr-overrides-constructor-lr quirk, smt.py:506-519)."""
        self.phase = "sparse"
        conversion_step = self.step - int(self.state["count"])
        sparse_sched = make_lr_schedule(
            self.cfg.lr_scheduler_type, self.cfg.smt_lr,
            self.cfg.smt_lr_warmup_steps,
            max(self.total_steps - conversion_step, 1))
        self._sparse_step = build_sparse_step(self.cfg, self.model_cfg, self.plan,
                                              sparse_sched)

    # -- steps ------------------------------------------------------------------------

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, torch.int64)
                for k, v in batch.items()}

    def _check_right_padding(self, batch: Dict[str, np.ndarray]):
        """One-time (per trainer) invariant check: the fused attention
        kernel (fullk, which also serves flash) ignores the attention mask
        and is exact only for causal + RIGHT-padded batches
        (models/llama.py _decoder_layer). The data pipeline right-pads by
        construction; a left-padded or packed batch must fail loudly here
        rather than train on silently wrong attention."""
        if self._padding_checked:
            return
        self._padding_checked = True
        mask = batch.get("attention_mask")
        if mask is None:
            return
        if resolve_attn_impl(self.cfg.attn_impl, self.model_cfg.head_dim,
                             self.device) == "einsum":
            return
        m = np.asarray(mask)
        if not (m[:, :-1] >= m[:, 1:]).all():
            raise ValueError(
                "batch attention_mask is not right-padded (monotone non-"
                "increasing rows); the fused attention kernel requires "
                "right padding — use attn_impl='einsum' for left-padded "
                "or packed batches")

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One global-batch step, dispatching on phase (reference loop body
        fine_tune.py:248-844). Returns 0-dim metric tensors."""
        self._check_right_padding(batch)
        self.maybe_convert()
        batch = self._to_device(batch)
        if self.phase == "sparse":
            self.state, metrics = self._sparse_step(self.state, batch)
        else:
            self.state, metrics = self._warmup_step(self.state, batch)
        return metrics

    def evaluate(self, eval_batches: Iterable[Dict[str, np.ndarray]]):
        """Mean eval loss + perplexity (reference helper.py:210-245)."""
        losses = [self._eval_step(self.state, self._to_device(b)) for b in eval_batches]
        if not losses:
            return float("inf"), float("inf")
        loss = float(torch.mean(torch.stack(losses)))
        return float(np.exp(min(loss, 80.0))), loss

    # -- full training loop ------------------------------------------------------------

    def fit(self, train_ds, eval_ds, pad_token_id: int,
            tokenizer=None, on_metrics=None) -> Dict[str, list]:
        from sparse_matrix_tuning_tpu_torch.data.sft import batch_iterator, num_batches

        cfg = self.cfg
        global_bs = cfg.per_device_ft_batch_size * cfg.gradient_accumulation_steps
        eval_bs = cfg.per_device_eval_batch_size
        steps_per_epoch = num_batches(len(train_ds), global_bs)

        self.reporter = ThroughputReporter(
            batch_size=global_bs, seq_length=cfg.max_seq_len,
            num_layers=self.model_cfg.num_hidden_layers,
            hidden_size=self.model_cfg.hidden_size,
            vocab_size=self.model_cfg.vocab_size,
            num_devices=1, every=cfg.throughput_steps)

        def eval_batches():
            return batch_iterator(eval_ds, eval_bs, pad_token_id,
                                  cfg.seq_buckets, cfg.seed, 0,
                                  shuffle=False, drop_last=False)

        stop = False
        for epoch in range(cfg.num_ft_epochs):
            print_rank_0(f"Beginning of Epoch {epoch + 1}/{cfg.num_ft_epochs}, "
                         f"Total Micro Batches {steps_per_epoch}")
            mean_loss, n_steps = 0.0, 0
            for batch in batch_iterator(train_ds, global_bs, pad_token_id,
                                        cfg.seq_buckets, cfg.seed, epoch):
                metrics = self.train_step(batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    # explicit NaN guard (the reference has no sanitizers)
                    raise FloatingPointError(
                        f"non-finite training loss at step {self.step} "
                        f"(phase {self.phase}); last grad_norm="
                        f"{float(metrics.get('grad_norm', float('nan')))}")
                mean_loss += loss
                n_steps += 1
                self.history["train_loss"].append(loss)
                step = self.step
                self._log_metrics(step, metrics)

                rep = self.reporter.maybe_report(step)
                if rep:
                    print_rank_0({"throughput": rep})
                if step % cfg.log_steps == 0:
                    print_rank_0(f"step {step} loss {loss:.4f} lr "
                                 f"{float(metrics.get('lr', 0)):.3e} phase {self.phase}")
                if on_metrics:
                    on_metrics(step, metrics)

                if cfg.eval_step > 0 and step % cfg.eval_step == 0:
                    ppl, eval_loss = self.evaluate(eval_batches())
                    self.history["eval_loss"].append(eval_loss)
                    self.history["ppl"].append(ppl)
                    print_rank_0(f"Validation perplexity: {ppl}, "
                                 f"Validation loss: {eval_loss}")
                    if eval_loss < self.best_eval_loss:
                        self.best_eval_loss = eval_loss
                        self._save("best", tokenizer)

                if cfg.save_steps > 0 and step % cfg.save_steps == 0:
                    self._save(f"step_{step}", tokenizer)

                if cfg.early_terminate and step > 0 and step % 3000 == 0:
                    stop = True
                    break
            if n_steps:
                print_rank_0(f"epoch {epoch + 1}/{cfg.num_ft_epochs} with "
                             f"training loss: {mean_loss / n_steps}")
            self._save(f"epoch_{epoch + 1}", tokenizer)
            if stop:
                break

        ppl, eval_loss = self.evaluate(eval_batches())
        self.history["eval_loss"].append(eval_loss)
        self.history["ppl"].append(ppl)
        self._save("final", tokenizer)
        return self.history

    # -- export -----------------------------------------------------------------------

    @torch.no_grad()
    def merged_params(self):
        """Dense params with the current trainables merged (reference
        convert_matrix_sparsity_to_linear_layer, smt.py:416-457): in the
        sparse phase the dense weights are already current; in warm-up the
        master, cast to the param dtype, is the truth."""
        if self.phase == "sparse":
            return self.state["params"]
        dt = self.cfg.param_dtype
        return tree_map(lambda p: p.detach().to(dt, copy=True), self.state["master"])

    def decode_params(self):
        """Params for eval/generate.generate: the exact merged dense params
        (the JAX trainer decodes scan+int8 states from the int8 base
        instead; the port has neither yet)."""
        from sparse_matrix_tuning_tpu_torch.eval.generate import prepare_decode_params
        return prepare_decode_params(self.merged_params(), self.model_cfg)

    def _log_metrics(self, step: int, metrics: Dict):
        """One JSON line per step into {output_dir}/metrics.jsonl."""
        if not self.cfg.output_dir:
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        rec = {"step": step, "phase": self.phase,
               **{k: float(v) for k, v in metrics.items()}}
        with open(os.path.join(self.cfg.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _save(self, tag: str, tokenizer=None):
        if not self.cfg.output_dir:
            return
        from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
        out = os.path.join(self.cfg.output_dir, tag)
        save_hf_format(self.merged_params(), self.model_cfg, out, tokenizer)
        if self.plan is not None:
            with open(os.path.join(out, "smt_plan.json"), "w") as f:
                f.write(self.plan.to_json())
        print_rank_0(f"[save] {out}")
