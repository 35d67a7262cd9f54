"""Two-phase SMT trainer — the orchestration layer (PyTorch twin of
`sparse_matrix_tuning_tpu.train.trainer`, matrix and channel mode on one
device).

Warm-up -> the one-shot conversion event -> sparse fine-tuning, with the
eval/save cadences and throughput prints of reference
deepspeed/fine_tune.py:72-864. In channel mode the warm-up steps only
harvest activation saliency (steps.build_channel_warmup_step) and do not
train.
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
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, SMTPlan
from sparse_matrix_tuning_tpu_torch.train import convert as convert_mod
from sparse_matrix_tuning_tpu_torch.train.steps import (
    build_channel_warmup_step, build_eval_step, build_sparse_step, build_warmup_step,
    init_warmup_state,
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
        self._init_common(cfg, model_cfg, total_steps,
                          device if device is not None else params["embed_tokens"].device)
        self.phase = "warmup"
        self._all_2d_shapes = all_2d_param_shapes(params)

        self.state = init_warmup_state(params, cfg, device=self.device)
        warmup_sched = make_lr_schedule(cfg.lr_scheduler_type, cfg.ft_learning_rate,
                                        cfg.lr_warmup_steps, self.total_steps)
        self._warmup_step = build_warmup_step(cfg, model_cfg, warmup_sched)
        # channel mode: the steps before full_ft_steps harvest activations
        # and do not train (JAX trainer.py:96-103)
        self._channel_step = (build_channel_warmup_step(cfg, model_cfg)
                              if cfg.channel_sparsity else None)
        self._sparse_step = None  # built at conversion
        self._eval_step = build_eval_step(cfg, model_cfg)

    def _init_common(self, cfg: SMTConfig, model_cfg: LlamaConfig, total_steps: int, device):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.total_steps = int(total_steps)
        self.device = torch.device(device)
        self.plan: Optional[SMTPlan] = None
        self._host_frozen: Optional[Dict[str, torch.Tensor]] = None
        self._scan = False  # the stacked scan state (scan_phase.resolve_scan_layers)
        self._padding_checked = False
        self.history: Dict[str, list] = {"train_loss": [], "eval_loss": [], "ppl": []}
        self.best_eval_loss = float("inf")
        self.reporter: Optional[ThroughputReporter] = None

    @classmethod
    def sparse_scan_from_hf(cls, cfg: SMTConfig, model_dir: str, plan: SMTPlan,
                            total_steps: int, model_cfg: Optional[LlamaConfig] = None,
                            device="cuda") -> "SMTTrainer":
        """A sparse-phase-only trainer over the int8 scan state, quantized
        while the local HF checkpoint loads (train/scan_phase.
        build_scan_state_from_hf): warm-up and selection ran elsewhere and
        produced `plan`, and the full-precision weights never co-reside on
        `device` (the JAX trainer's entry of the same name). There is no
        warm-up state."""
        from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_config
        from sparse_matrix_tuning_tpu_torch.train.scan_phase import build_scan_state_from_hf

        model_cfg = model_cfg or load_hf_config(model_dir)
        if plan.mode not in ("matrix", "channel") or cfg.dtype == "fp16":
            raise ValueError("sparse_scan_from_hf requires matrix or channel mode and dtype != "
                             "fp16 (the fp16 loss-scale state is created by the warm-up phase, "
                             "which this entry skips)")
        self = cls.__new__(cls)
        self._init_common(cfg, model_cfg, total_steps, device)
        self.plan, self._scan, self.phase = plan, True, "sparse"
        self.state, self._host_frozen = build_scan_state_from_hf(cfg, model_dir, plan,
                                                                 model_cfg, device=self.device)
        self.install_sparse_phase()
        return self

    # -- conversion ---------------------------------------------------------------

    @property
    def step(self) -> int:
        return int(self.state["step"])

    @property
    def is_smt(self) -> bool:
        return self.cfg.matrix_sparsity or self.cfg.channel_sparsity

    def maybe_convert(self):
        if self.phase != "warmup" or not self.is_smt:
            return
        if self.step < self.cfg.full_ft_steps:
            return
        from sparse_matrix_tuning_tpu_torch.train.scan_phase import resolve_scan_layers
        t0 = time.time()
        self._scan = resolve_scan_layers(self.cfg, self.model_cfg,
                                         "matrix" if self.cfg.matrix_sparsity else "channel")
        # the new state drops the warm-up master, moments and accumulators
        self.plan, self.state, self._host_frozen = convert_mod.convert(
            self.cfg, self.state, self._all_2d_shapes, model_cfg=self.model_cfg,
            scan=self._scan)
        self.install_sparse_phase()

        total = sum(p.numel() for p in flatten_tree(self.state["params"]).values())
        total += sum(w.numel() for w in (self._host_frozen or {}).values())
        sel = self.plan.trainable_params
        print_rank_0(
            f"[smt] converted at step {self.step} in {time.time() - t0:.1f}s"
            f"{' into the scan state' if self._scan else ''}: "
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
        if self._scan:
            from sparse_matrix_tuning_tpu_torch.train import scan_phase
            scan_phase.attach_schedules(self.state)
            self._sparse_step = scan_phase.build_scan_sparse_step(
                self.cfg, self.model_cfg, self.plan, sparse_sched)
            self._eval_step = scan_phase.build_scan_eval_step(self.cfg, self.model_cfg,
                                                              self.plan)
            return
        self._sparse_step = build_sparse_step(self.cfg, self.model_cfg, self.plan,
                                              sparse_sched)
        if self._host_frozen is not None:
            # dense weights left the device: the eval loss must run the same
            # q8-corrected dispatch as the training forward
            self._eval_step = build_eval_step(self.cfg, self.model_cfg, plan=self.plan)

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
        elif self.cfg.channel_sparsity:
            # channel warm-up (maybe_convert left the phase at "warmup", so
            # step < full_ft_steps): collect activations, do NOT train
            self.state, metrics = self._channel_step(self.state, batch)
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

        # resume: skip the epochs and batches already consumed (the batch
        # order is deterministic in (seed, epoch), so the replay is exact)
        per_epoch = max(steps_per_epoch, 1)
        start_epoch = min(self.step // per_epoch, cfg.num_ft_epochs)
        skip_in_epoch = self.step % per_epoch if start_epoch < cfg.num_ft_epochs else 0

        stop = False
        for epoch in range(start_epoch, cfg.num_ft_epochs):
            print_rank_0(f"Beginning of Epoch {epoch + 1}/{cfg.num_ft_epochs}, "
                         f"Total Micro Batches {steps_per_epoch}")
            mean_loss, n_steps = 0.0, 0
            to_skip, skip_in_epoch = skip_in_epoch, 0
            for bi, batch in enumerate(batch_iterator(train_ds, global_bs, pad_token_id,
                                                      cfg.seq_buckets, cfg.seed, epoch)):
                if bi < to_skip:
                    continue
                metrics = self.train_step(batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    if metrics.get("overflow"):
                        # fp16 dynamic loss scaling: an overflowed step was
                        # skipped and rescaled, not fatal (DeepSpeed
                        # semantics); no eval, save or history for it
                        print_rank_0(
                            f"[fp16] overflow at step {self.step}, loss scale "
                            f"-> {float(metrics['loss_scale']) / 2:.0f}")
                        continue
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
                    self._save_resumable()

                if cfg.early_terminate and step > 0 and step % 3000 == 0:
                    stop = True
                    break
            if n_steps:
                print_rank_0(f"epoch {epoch + 1}/{cfg.num_ft_epochs} with "
                             f"training loss: {mean_loss / n_steps}")
            self._save(f"epoch_{epoch + 1}", tokenizer)
            self._save_resumable()
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
        sparse phase the dense weights are already current (blocks or
        columns, scattered in every step); in warm-up the
        master, cast to the param dtype, is the truth. With the int8 host
        offload the frozen weights come back from the host store with the
        trained blocks scattered in (those tensors stay on the CPU): the
        export is exact, whatever the int8 compute path did."""
        if self.phase == "sparse":
            if self._scan:
                from sparse_matrix_tuning_tpu_torch.train.scan_phase import (
                    merged_params_from_scan)
                return merged_params_from_scan(self.state, self.plan, self.model_cfg,
                                               self._host_frozen)
            if self._host_frozen is not None:
                return self._merged_from_host()
            return self.state["params"]
        dt = self.cfg.param_dtype
        return tree_map(lambda p: p.detach().to(dt, copy=True), self.state["master"])

    def _merged_from_host(self):
        params = dict(self.state["params"])
        layers = {k: dict(v) for k, v in params["layers"].items()}
        for ks, w in self._host_frozen.items():
            if ks == "lm_head":  # offloaded untied head (head_quant)
                params["lm_head"] = w
                continue
            li, mod = ks.split(".", 1)
            layers[li][mod] = w
        for ks, lp in self.plan.linears.items():  # every planned linear was offloaded
            w = layers[str(lp.layer)][lp.module].clone()
            w4 = w.view(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
            rb, cb = self.plan.block_index(ks, "cpu")
            w4[rb, :, cb, :] = self.state["trainable"][ks].detach().to("cpu", w.dtype)
            layers[str(lp.layer)][lp.module] = w
        params["layers"] = layers
        return params

    def decode_params(self):
        """Params for eval/generate.generate. The scan trainer over the int8
        base decodes from its state, with no dense layer weight on the device
        (eval/generate.decode_params_from_scan); the others from the exact
        merged dense params, on the trainer's device (weights offloaded to
        the host come back)."""
        from sparse_matrix_tuning_tpu_torch.eval.generate import (
            decode_params_from_scan, prepare_decode_params)
        if self.phase == "sparse" and self._scan and "q" in self.state:
            return decode_params_from_scan(self.state, self.model_cfg, self._host_frozen)
        merged = tree_map(lambda p: p.to(self.device), self.merged_params())
        return prepare_decode_params(merged, self.model_cfg)

    def _log_metrics(self, step: int, metrics: Dict):
        """One JSON line per step into {output_dir}/metrics.jsonl."""
        if not self.cfg.output_dir:
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        rec = {"step": step, "phase": self.phase,
               **{k: float(v) for k, v in metrics.items()}}
        with open(os.path.join(self.cfg.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _save_resumable(self):
        """The full train state at {output_dir}/ckpt, what --resume_from
        reads (train/checkpoint.py; the HF-format saves are weights only)."""
        if not self.cfg.output_dir:
            return
        from sparse_matrix_tuning_tpu_torch.train.checkpoint import save_checkpoint
        save_checkpoint(os.path.join(self.cfg.output_dir, "ckpt"), self)

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
