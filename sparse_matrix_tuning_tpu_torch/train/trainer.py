"""Two-phase SMT trainer — the orchestration layer (PyTorch twin of
`sparse_matrix_tuning_tpu.train.trainer`, matrix and channel mode, on one
device or data-parallel over a mesh of processes, parallel/mesh.py).

Warm-up -> the one-shot conversion event -> sparse fine-tuning, with the
eval/save cadences and throughput prints of reference
deepspeed/fine_tune.py:72-864. In channel mode the warm-up steps only
harvest activation saliency (steps.build_channel_warmup_step) and do not
train. `fit` takes its training batches from the C++ collator through a
prefetch thread (data/native.py), its eval batches from
data/sft.batch_iterator, and traces steps under --profile_dir.

On a mesh (`mesh`, `--mesh_shape D,F,T`) every rank takes the identical
global batch of B * D * F * A rows and steps on its own rows
(data/sft.shard_batch; the T ranks of a tensor group share theirs); the
steps reduce the grads. Over data alone (F 1, T 1) every rank holds a
full replica. Over fsdp (F > 1) or tensor (T > 1, matrix or channel mode
over the dense or the int8 base; parallel/tensor.py) every rank holds
its shards of the state (parallel/fsdp.py; `self.sharding` records their
dims over both axes): the trainer shards the params it is given (or takes
shards made by models/hf_io.load_hf_params_sharded with their dims), and
the HF export and eval generation gather leaf by leaf over both axes. The scan layouts (--scan_layers on, and
channel + int8 at depth) convert the sharded warm-up into a sharded scan
state, whose host store of frozen weights holds this rank's slices over
both axes (train/scan_phase.build_scan_sparse_state). Eval losses are reduced once
per evaluate; rank 0 alone writes metrics and HF saves, between barriers;
checkpoints are written as train/checkpoint.py says.
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
from sparse_matrix_tuning_tpu_torch.parallel.fsdp import Sharding
from sparse_matrix_tuning_tpu_torch.parallel.mesh import all_reduce_, assert_same
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
    on `device`, default the mesh's or else the params' device).
    total_steps: optimizer-step horizon for the LR schedule (num_ft_epochs *
    steps_per_epoch). mesh: parallel/mesh.Mesh (every rank builds its
    trainer from the same params and seed). param_sharding: `params` are
    already this rank's shards, split on the fsdp dims (`dims`) and the
    tensor dims (`tdims`) of this parallel/fsdp.Sharding by state path
    "master/..." (models/hf_io.load_hf_params_sharded); without it a mesh
    with F or T above 1 shards the full params here."""

    def __init__(self, cfg: SMTConfig, model_cfg: LlamaConfig, params,
                 total_steps: int, device=None, mesh=None, param_sharding=None):
        if device is None:
            device = mesh.device if mesh is not None else params["embed_tokens"].device
        self._init_common(cfg, model_cfg, total_steps, device, mesh)
        self.phase = "warmup"
        sh = self.sharding
        if mesh is not None:
            from sparse_matrix_tuning_tpu_torch.parallel.mesh import refuse_tensor_model
            refuse_tensor_model(model_cfg, mesh.tensor)
        if sh is not None:
            if param_sharding is None:
                params = sh.shard_tree(params, "master")
            else:
                sh.dims.update(param_sharding.dims)
                sh.tdims.update(param_sharding.tdims)
            self._all_2d_shapes = [sh.full_shape(f"master/{k}", p)
                                   for k, p in flatten_tree(params).items() if p.dim() == 2]
        else:
            self._all_2d_shapes = all_2d_param_shapes(params)

        self.state = init_warmup_state(params, cfg, device=self.device, sharding=sh)
        warmup_sched = make_lr_schedule(cfg.lr_scheduler_type, cfg.ft_learning_rate,
                                        cfg.lr_warmup_steps, self.total_steps)
        self._warmup_step = build_warmup_step(cfg, model_cfg, warmup_sched, mesh, sh)
        # channel mode: the steps before full_ft_steps harvest activations
        # and do not train (JAX trainer.py:96-103)
        self._channel_step = (build_channel_warmup_step(cfg, model_cfg, mesh, sh)
                              if cfg.channel_sparsity else None)
        self._sparse_step = None  # built at conversion
        self._eval_step = build_eval_step(cfg, model_cfg, sharding=sh)

    def _init_common(self, cfg: SMTConfig, model_cfg: LlamaConfig, total_steps: int, device,
                     mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:   # the config may name no mesh_shape (a mesh built in code)
            from sparse_matrix_tuning_tpu_torch.parallel.mesh import refuse_sharded_axes
            refuse_sharded_axes(mesh.shape, cfg)
        # the fsdp and tensor axes: the dims of this rank's shards by state path
        self.sharding = Sharding(mesh) if mesh is not None and (
            mesh.fsdp > 1 or mesh.tensor > 1) else None
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
        self._profiler = None   # the torch.profiler of --profile_dir, while it traces

    @classmethod
    def sparse_scan_from_hf(cls, cfg: SMTConfig, model_dir: str, plan: SMTPlan,
                            total_steps: int, model_cfg: Optional[LlamaConfig] = None,
                            device="cuda", mesh=None) -> "SMTTrainer":
        """A sparse-phase-only trainer over the int8 scan state, quantized
        while the local HF checkpoint loads (train/scan_phase.
        build_scan_state_from_hf): warm-up and selection ran elsewhere and
        produced `plan`, and the full-precision weights never co-reside on
        `device` (the JAX trainer's entry of the same name). There is no
        warm-up state."""
        from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_config
        from sparse_matrix_tuning_tpu_torch.train.scan_phase import build_scan_state_from_hf

        model_cfg = model_cfg or load_hf_config(model_dir)
        if mesh is not None and (mesh.fsdp > 1 or mesh.tensor > 1):
            raise NotImplementedError(
                f"sparse_scan_from_hf (--sparse_from_plan) on mesh {tuple(mesh.shape)}: the JAX "
                "package's entry runs on one device (it sets no mesh), so it has no sharded form; "
                f"use --mesh_shape {mesh.batch_shards},1,1")
        if plan.mode not in ("matrix", "channel") or cfg.dtype == "fp16":
            raise ValueError("sparse_scan_from_hf requires matrix or channel mode and dtype != "
                             "fp16 (the fp16 loss-scale state is created by the warm-up phase, "
                             "which this entry skips)")
        self = cls.__new__(cls)
        self._init_common(cfg, model_cfg, total_steps, device, mesh)
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
        assert_same("the step counter at conversion", self.step, self.mesh)
        self._scan = resolve_scan_layers(self.cfg, self.model_cfg,
                                         "matrix" if self.cfg.matrix_sparsity else "channel")
        # the new state drops the warm-up master, moments and accumulators
        self.plan, self.state, self._host_frozen = convert_mod.convert(
            self.cfg, self.state, self._all_2d_shapes, model_cfg=self.model_cfg,
            scan=self._scan, mesh=self.mesh, sharding=self.sharding)
        self.install_sparse_phase()

        sh = self.sharding
        total = sum(p.numel() if sh is None else torch.Size(sh.full_shape(f"params/{k}", p))
                    .numel() for k, p in flatten_tree(self.state["params"]).items())
        total += sum(w.numel() if sh is None else torch.Size(sh.full_shape(f"host/{k}", w))
                     .numel() for k, w in (self._host_frozen or {}).items())
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
        if self.sharding is not None:  # the warm-up leaves went
            self.sharding.keep([f"{k}/{p}" for k, v in self.state.items() if isinstance(v, dict)
                                for p in flatten_tree(v)]
                               + [f"host/{k}" for k in self._host_frozen or {}])
        conversion_step = self.step - int(self.state["count"])
        sparse_sched = make_lr_schedule(
            self.cfg.lr_scheduler_type, self.cfg.smt_lr,
            self.cfg.smt_lr_warmup_steps,
            max(self.total_steps - conversion_step, 1))
        if self._scan:
            from sparse_matrix_tuning_tpu_torch.train import scan_phase
            scan_phase.attach_schedules(self.state, self.sharding)
            self._sparse_step = scan_phase.build_scan_sparse_step(
                self.cfg, self.model_cfg, self.plan, sparse_sched, self.mesh, self.sharding)
            self._eval_step = scan_phase.build_scan_eval_step(self.cfg, self.model_cfg,
                                                              self.plan, self.sharding)
            return
        self._sparse_step = build_sparse_step(self.cfg, self.model_cfg, self.plan,
                                              sparse_sched, self.mesh, self.sharding)
        if self.sharding is not None:
            self._eval_step = build_eval_step(self.cfg, self.model_cfg, sharding=self.sharding)
        if self._host_frozen is not None:
            # dense weights left the device: the eval loss must run the same
            # q8-corrected dispatch as the training forward
            self._eval_step = build_eval_step(self.cfg, self.model_cfg, plan=self.plan)

    # -- steps ------------------------------------------------------------------------

    def _to_device(self, batch: Dict[str, np.ndarray], accum: int = 1
                   ) -> Dict[str, torch.Tensor]:
        """The step's batch on the device: the global batch, or on a mesh
        this rank's rows of its `accum` microbatches with their global
        valid-token counts (data/sft.shard_batch)."""
        if self.mesh is not None:
            from sparse_matrix_tuning_tpu_torch.data.sft import shard_batch
            batch = shard_batch(batch, self.mesh, accum)
        return {k: torch.as_tensor(np.asarray(v)).to(
                    self.device, torch.float32 if k == "loss_denom" else torch.int64)
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
        batch = self._to_device(batch, self.cfg.gradient_accumulation_steps)
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
        """Mean eval loss + perplexity (reference helper.py:210-245): each
        global batch's loss is token-weighted over the whole batch (on a
        mesh the ranks' parts, summed in one all-reduce over the batch
        group: a tensor group's ranks hold the same part), and the batches
        weigh equally, as JAX's evaluate."""
        losses = [self._eval_step(self.state, self._to_device(b)) for b in eval_batches]
        if not losses:
            return float("inf"), float("inf")
        losses = torch.stack(losses)
        if self.mesh is not None:
            all_reduce_([losses], self.mesh, "batch")
        loss = float(torch.mean(losses))
        return float(np.exp(min(loss, 80.0))), loss

    # -- full training loop ------------------------------------------------------------

    def fit(self, train_ds, eval_ds, pad_token_id: int,
            tokenizer=None, on_metrics=None) -> Dict[str, list]:
        from sparse_matrix_tuning_tpu_torch.data import native
        from sparse_matrix_tuning_tpu_torch.data.sft import batch_iterator, num_batches

        cfg = self.cfg
        n_dev = 1 if self.mesh is None else self.mesh.batch_shards
        # effective batch = per-device x devices x accumulation (JAX
        # trainer.py:379-385, reference fine_tune.py:96-102); the devices
        # are the batch's row slices, D * F
        global_bs = cfg.per_device_ft_batch_size * n_dev * cfg.gradient_accumulation_steps
        eval_bs = cfg.per_device_eval_batch_size * n_dev
        steps_per_epoch = num_batches(len(train_ds), global_bs)

        self.reporter = ThroughputReporter(
            batch_size=global_bs, seq_length=cfg.max_seq_len,
            num_layers=self.model_cfg.num_hidden_layers,
            hidden_size=self.model_cfg.hidden_size,
            vocab_size=self.model_cfg.vocab_size,
            num_devices=n_dev, every=cfg.throughput_steps)

        def eval_batches():
            return batch_iterator(eval_ds, eval_bs, pad_token_id,
                                  cfg.seq_buckets, cfg.seed, 0,
                                  shuffle=False, drop_last=False)

        # training batches: the C++ collator in a background prefetch thread
        # (JAX trainer.py:400-411, without its numpy fallback: a failed
        # build raises through the loader); every rank collates the global
        # batch
        arena = native.TokenArena.from_dataset(train_ds)

        def train_batches(epoch):
            return native.PrefetchLoader(lambda: native.native_batch_iterator(
                arena, global_bs, pad_token_id, cfg.seq_buckets, cfg.seed, epoch))

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
            for bi, batch in enumerate(train_batches(epoch)):
                if bi < to_skip:
                    continue
                self._maybe_profile()
                reduced_at = self.mesh.stats["bytes"] if self.mesh is not None else 0
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
                    reduced = "" if self.mesh is None else \
                        f" all-reduced {(self.mesh.stats['bytes'] - reduced_at) / 1e6:.1f} MB"
                    print_rank_0(f"step {step} loss {loss:.4f} lr "
                                 f"{float(metrics.get('lr', 0)):.3e} phase {self.phase}{reduced}")
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
        self._stop_profile()   # a run that ended inside the window

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
        export is exact, whatever the int8 compute path did. Under fsdp
        or tensor the shards are gathered leaf by leaf into host tensors
        (the scan state's layer by layer, over both axes): collective,
        every rank calls it."""
        if self.sharding is not None and not (self.phase == "sparse" and self._scan):
            warm = self.phase != "sparse"
            return self.sharding.full_tree(self.state["master" if warm else "params"],
                                           "master" if warm else "params",
                                           dtype=self.cfg.param_dtype if warm else None)
        if self.phase == "sparse":
            if self._scan:
                from sparse_matrix_tuning_tpu_torch.train.scan_phase import (
                    merged_params_from_scan)
                return merged_params_from_scan(self.state, self.plan, self.model_cfg,
                                               self._host_frozen, self.sharding)
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
        the host come back). Under fsdp or tensor every rank gathers the
        whole state over both axes (collective)."""
        from sparse_matrix_tuning_tpu_torch.eval.generate import (
            decode_params_from_scan, prepare_decode_params)
        if self.phase == "sparse" and self._scan and "q" in self.state:
            state, host, sh = self.state, self._host_frozen, self.sharding
            if sh is not None:
                state = {k: sh.full_tree(v, k, device=self.device)
                         if isinstance(v, dict) and k != "sched" else v for k, v in state.items()}
                host = host and {k: sh.full(f"host/{k}", w.to(self.device))
                                 for k, w in host.items() if k == "lm_head"}
            return decode_params_from_scan(state, self.model_cfg, host)
        merged = tree_map(lambda p: p.to(self.device), self.merged_params())
        return prepare_decode_params(merged, self.model_cfg)

    def _maybe_profile(self):
        """--profile_dir: a torch.profiler trace (CPU and, on a CUDA
        device, the kernels) of steps profile_start .. profile_start +
        profile_steps - 1, on rank 0 (JAX trainer.py:560-575)."""
        cfg = self.cfg
        if not cfg.profile_dir or (self.mesh is not None and not self.mesh.is_main):
            return
        if self._profiler is None and self.step == cfg.profile_start:
            from torch.profiler import ProfilerActivity
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            print_rank_0(f"[profile] tracing steps {cfg.profile_start}.."
                         f"{cfg.profile_start + cfg.profile_steps} -> {cfg.profile_dir}")
        elif self._profiler is not None and \
                self.step >= cfg.profile_start + cfg.profile_steps:
            self._stop_profile()

    def _stop_profile(self):
        """Stop the trace once the traced steps' kernels are done, and write
        it into profile_dir as a Chrome trace."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_steps_{self.cfg.profile_start}_{self.step}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print_rank_0(f"[profile] wrote {path}")

    def _log_metrics(self, step: int, metrics: Dict):
        """One JSON line per step into {output_dir}/metrics.jsonl (rank 0:
        the metrics are the global batch's on every rank)."""
        if not self.cfg.output_dir or (self.mesh is not None and not self.mesh.is_main):
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        rec = {"step": step, "phase": self.phase,
               **{k: float(v) for k, v in metrics.items()}}
        with open(os.path.join(self.cfg.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _on_rank_0(self, write, every=False):
        """write() in rank 0 only (every=True: on every rank), between
        barriers on a mesh: every rank has reached the save, and none goes
        on before the files are complete."""
        if self.mesh is None:
            return write()
        self.mesh.barrier()
        if self.mesh.is_main or every:
            write()
        self.mesh.barrier()

    def _save_resumable(self):
        """The full train state at {output_dir}/ckpt, what --resume_from
        reads (train/checkpoint.py; the HF-format saves are weights only).
        Under fsdp every rank takes part (its shards)."""
        if not self.cfg.output_dir:
            return
        from sparse_matrix_tuning_tpu_torch.train.checkpoint import save_checkpoint
        self._on_rank_0(lambda: save_checkpoint(os.path.join(self.cfg.output_dir, "ckpt"), self),
                        every=self.sharding is not None)

    def _save(self, tag: str, tokenizer=None):
        if not self.cfg.output_dir:
            return
        from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
        out = os.path.join(self.cfg.output_dir, tag)
        # under fsdp every rank gathers (collective), rank 0 writes
        merged = self.merged_params() if self.sharding is not None else None

        def write():
            save_hf_format(merged if merged is not None else self.merged_params(),
                           self.model_cfg, out, tokenizer)
            if self.plan is not None:
                with open(os.path.join(out, "smt_plan.json"), "w") as f:
                    f.write(self.plan.to_json())
        self._on_rank_0(write)
        print_rank_0(f"[save] {out}")
