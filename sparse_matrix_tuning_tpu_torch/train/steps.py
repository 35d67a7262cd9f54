"""Training/eval step functions for both SMT phases (PyTorch twin of
`sparse_matrix_tuning_tpu.train.steps`).

Phase 1 (warm-up, reference fine_tune.py:710-773): full fine-tuning with
fp32 master weights; every step also accumulates saliency of the six
target linears from the UNCLIPPED gradients into on-device accumulators.

In channel mode the warm-up does not train (reference fine_tune.py:708):
each step is a forward that sums the target linears' |input| activations
into the accumulators (build_channel_warmup_step).

Phase 2 (sparse): gradients exist only for the gathered blocks (or
columns) via the sparse autograd Functions; Adam state is proportional to
the selected fraction; the updated blocks (or columns) are scattered once
per step into the dense weights.

--dtype fp16 trains with DeepSpeed-style dynamic loss scaling (the
reference inherits it, deepspeed_helpers.py:76-87): the state carries
"loss_scale" and "good_steps", the loss is scaled before its backward and
the grads unscaled after it, and a step whose loss or grad norm is not
finite changes nothing but the step counter and the scaler
(unscale_and_check, update_loss_scale); that test is the one value an fp16
step reads on the host.

A state is a plain dict of tensors. The steps update it IN PLACE (params,
optimizer state, counters) where the JAX twin donated its buffers, and
return it with a dict of 0-dim metric tensors; nothing waits on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import (
    ATTN_TARGETS, TARGET_MODULES, LlamaConfig, causal_lm_loss, default_linear,
    flatten_tree, forward, lm_head_weight, tree_map,
)
from sparse_matrix_tuning_tpu_torch.ops.cuda.masked_adam import masked_adam
from sparse_matrix_tuning_tpu_torch.ops.loss import (
    chunked_causal_lm_loss, chunked_causal_lm_loss_q8)
from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import (
    _resolve_impl, frozen_q8_linear, make_sparse_linear_dispatch)
from sparse_matrix_tuning_tpu_torch.smt.optimizer import (
    AdamConfig, adam_step, clip_by_global_norm, full_ft_wd_mask, global_norm,
    make_qk_lr_scale,
)
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan


def _cast_tree(tree, dtype):
    return tree_map(lambda p: p.to(dtype), tree)


def accumulated_value_and_grad(loss_of, accum_steps: int):
    """Microbatch gradient accumulation (the reference delegates this to the
    DeepSpeed engine). Returns vag(params, batch) -> (mean loss, grads):
    `params` is a flat {key: leaf tensor requiring grad}; the global batch's
    leading dim is split into `accum_steps` microbatches, each backward adds
    into .grad, and loss and grads are scaled by 1/accum_steps at the end —
    the JAX twin's sum-then-scale order. Each microbatch loss is a mean over
    its own valid tokens and microbatches weigh equally (DeepSpeed
    semantics)."""

    def vag(params: Dict[str, torch.Tensor], batch):
        for p in params.values():
            p.grad = None
        if accum_steps <= 1:
            micro = [batch]
        else:
            micro = [{k: v.reshape(accum_steps, -1, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum_steps)]
        total = None
        for mb in micro:
            loss = loss_of(params, mb)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            total = total * inv
            grads = {k: g.mul_(inv) for k, g in grads.items()}
        return total, grads

    return vag


# fp32 logits budget for the "auto" loss policy in the sparse phase: what
# the dense CE keeps for its backward.
_SPARSE_DENSE_LOSS_BUDGET = 2 * 1024**3


def _use_chunked_loss(cfg: SMTConfig, model_cfg: LlamaConfig, sparse: bool = False,
                      batch_tokens: Optional[int] = None) -> bool:
    """Loss-path policy (the JAX twin's). The chunked form (ops/loss.py)
    never materialises the (T, V) fp32 logits but recomputes each chunk's
    logits in its backward. Memory-tight phases (the full-FT warm-up at a
    large vocabulary) take it; the SPARSE phase's live set is small, so
    when the logits fit the budget the dense form's fewer operations win."""
    if cfg.loss_impl == "chunked":
        return True
    if cfg.loss_impl == "full":
        return False
    if sparse and batch_tokens is not None:
        return batch_tokens * model_cfg.vocab_size * 4 > _SPARSE_DENSE_LOSS_BUDGET
    return model_cfg.vocab_size >= 16384  # "auto"


def dropout_key(cfg: SMTConfig, state: Dict, sparse: bool):
    """The (base seed, step) the step's dropout masks derive from
    (models/llama.dropout_layer_seed), or None without --dropout: base seed
    cfg.seed in the warm-up and cfg.seed + 1 in the sparse phase, as the
    JAX steps key theirs (steps.py:284, :433; scan_phase.py:784). Reads the
    step on the host, once a step, only under dropout."""
    if cfg.dropout <= 0:
        return None
    return (cfg.seed + (1 if sparse else 0), int(state["step"]))


def compute_loss(params, batch, cfg: SMTConfig, model_cfg: LlamaConfig,
                 linear=None, remat=True, stop_grad_below_layer=None,
                 sparse=False, q_head=None, dropout_key=None):
    """Shared loss path of all steps: full logits + CE, or the chunked-vocab
    CE (ops/loss.py), by the _use_chunked_loss policy (sparse-phase steps
    pass sparse=True).

    q_head: optional {"wq" int8 (V, D), "sw" fp32 (V,)} frozen int8 lm-head
    (train/convert.py build_q_head): the head matmul is then K4 in BOTH
    loss forms (the head is frozen in the sparse phase: int8 forward,
    straight-through int8 grad_hidden, no weight gradient), dense via
    frozen_q8_linear over the full logits, chunked via
    chunked_causal_lm_loss_q8. dropout_key: the training step's
    (seed, step) under attention dropout (dropout_key()), None in eval."""
    kw = dict(attention_mask=batch.get("attention_mask"),
              linear=linear or default_linear, remat=remat,
              stop_grad_below_layer=stop_grad_below_layer, attn_impl=cfg.attn_impl,
              dropout_key=dropout_key)
    return head_loss(lambda hidden: forward(params, batch["input_ids"], model_cfg,
                                            return_hidden=hidden, **kw),
                     params, batch, cfg, model_cfg, sparse, q_head)


def head_loss(run, params, batch, cfg: SMTConfig, model_cfg: LlamaConfig, sparse: bool,
              q_head=None):
    """The loss of compute_loss over a decoder `run(return_hidden)` (forward
    or, for the scan state, forward_scan): the loss path and the head as
    compute_loss describes them."""
    b, sq = batch["input_ids"].shape
    if _use_chunked_loss(cfg, model_cfg, sparse=sparse, batch_tokens=b * (sq - 1)):
        hidden = run(True)
        if q_head is not None:
            return chunked_causal_lm_loss_q8(hidden, q_head["wq"], q_head["sw"],
                                             batch["labels"], cfg.vocab_chunk)
        return chunked_causal_lm_loss(hidden, lm_head_weight(params, model_cfg),
                                      batch["labels"], cfg.vocab_chunk)
    if q_head is not None:
        # fp32 input -> fp32 logits straight from the int32 product
        logits = frozen_q8_linear(run(True).float(), q_head["wq"], q_head["sw"])
        return causal_lm_loss(logits, batch["labels"])
    return causal_lm_loss(run(False), batch["labels"])


# ---------------------------------------------------------------------------
# Warm-up (full fine-tuning) step
# ---------------------------------------------------------------------------

# "auto" saliency accumulation switches to per_step_stats once the grad_sum
# accumulators would exceed this many bytes of fp32 device memory.
SALIENCY_AUTO_GRAD_SUM_LIMIT = 2 * 1024 ** 3


def _grad_sum_accumulator_bytes(master, cfg: SMTConfig) -> int:
    total = 0
    for layer in master["layers"].values():
        for mod in TARGET_MODULES:
            shape = tuple(layer[mod].shape)
            if cfg.matrix_sparsity and _wants_saliency(cfg, mod) \
                    and not (shape[0] % 256 or shape[1] % 256):
                total += shape[0] * shape[1] * 4
            if cfg.channel_sparsity and _wants_channel(cfg, mod):
                total += cfg.max_seq_len * shape[1] * 4
    return total


def resolve_saliency_accumulation(cfg: SMTConfig, master) -> str:
    """Resolve saliency_accumulation="auto": reference-exact grad_sum while
    the accumulators stay small, per_step_stats at scale (exact for the
    matrix mean_abs reducer — signed-mean accumulation,
    select.block_stats_step — and for channel mean_abs / abs_mean / L1).
    Mutates cfg so later consumers agree."""
    if cfg.saliency_accumulation == "auto":
        over = _grad_sum_accumulator_bytes(master, cfg) > SALIENCY_AUTO_GRAD_SUM_LIMIT
        cfg.saliency_accumulation = "per_step_stats" if over else "grad_sum"
        if over:
            from sparse_matrix_tuning_tpu_torch.utils.logging import print_rank_0
            print_rank_0(
                "[smt] saliency_accumulation=auto -> per_step_stats "
                "(grad_sum accumulators would exceed "
                f"{SALIENCY_AUTO_GRAD_SUM_LIMIT >> 30} GiB; exact vs grad_sum "
                "for mean_abs, approximate for the abs-inside reducers)")
    return cfg.saliency_accumulation


# --- fp16 dynamic loss scaling (DeepSpeed DynamicLossScaler semantics) ----

def update_loss_scale(scale: torch.Tensor, good_steps: torch.Tensor, finite,
                      window: int, min_scale: float = 1.0):
    """The scale-update rule: halve (down to min_scale) and reset the good
    count on overflow, double after `window` consecutive good steps
    (reference fp16 block defaults, deepspeed_helpers.py:76-87). Tensors in,
    tensors out, on the scale's device: no host sync."""
    finite = torch.as_tensor(finite, device=scale.device)
    good = torch.where(finite, good_steps + 1, torch.zeros_like(good_steps))
    grew = good >= window
    new_scale = torch.where(finite, torch.where(grew, scale * 2.0, scale),
                            torch.clamp(scale * 0.5, min=min_scale))
    return new_scale, torch.where(grew, torch.zeros_like(good), good)


def loss_scaler(cfg: SMTConfig, device) -> Dict[str, torch.Tensor]:
    """A fresh scaler's state leaves, {} unless cfg.dtype is fp16."""
    if cfg.dtype != "fp16":
        return {}
    return {"loss_scale": torch.full((), float(cfg.init_loss_scale), dtype=torch.float32,
                                     device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def unscale_and_check(loss: torch.Tensor, grads: Dict[str, torch.Tensor], state: Dict,
                      cfg: SMTConfig):
    """After a backward of the scaled loss: the loss and the fp32 grads
    (in place) times 1 / loss_scale, their global norm, and the scaler
    stepped in place on the device. Returns (loss, grads, norm, metrics,
    finite): finite = isfinite(loss) & isfinite(norm) read on the host,
    the one sync that loss scaling adds to a step, taken before the caller
    updates anything in place; metrics = {"loss_scale": the scale the step
    ran at, "overflow": not finite}. An overflowed step must then leave
    every other leaf as it was (the JAX twin's select-on-overflow)."""
    inv = torch.reciprocal(state["loss_scale"])
    loss = loss * inv
    for g in grads.values():
        g.mul_(inv)
    norm = global_norm(grads)
    finite_t = torch.isfinite(loss) & torch.isfinite(norm)
    ran_at = state["loss_scale"].clone()
    scale, good = update_loss_scale(state["loss_scale"], state["good_steps"], finite_t,
                                    cfg.loss_scale_window)
    state["loss_scale"].copy_(scale)
    state["good_steps"].copy_(good)
    finite = bool(finite_t)
    return loss, grads, norm, {"loss_scale": ran_at, "overflow": not finite}, finite


def init_warmup_state(master, cfg: SMTConfig, device=None) -> Dict:
    """fp32 master copies (leaf tensors requiring grad), zero Adam moments,
    step counters and the saliency accumulators, on `device` (default: the
    params' device). Channel mode keeps the master and moments too, as the
    JAX twin does, though its warm-up never trains; its accumulators
    ("act_acc") are (max_seq_len, in_dim) positional |activation| sums, or
    (in_dim,) running per-channel stats under per_step_stats."""
    resolve_saliency_accumulation(cfg, master)
    if device is None:
        device = master["embed_tokens"].device

    def to_master(p):
        return p.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_(True)

    state = {
        "master": tree_map(to_master, master),
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    state["m"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device),
                          state["master"])
    state["v"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device),
                          state["master"])
    state.update(loss_scaler(cfg, device))  # fp16: carried through the channel warm-up too
    if cfg.matrix_sparsity:
        acc = {}
        for li, layer in master["layers"].items():
            for mod in TARGET_MODULES:
                shape = tuple(layer[mod].shape)
                if not _wants_saliency(cfg, mod):
                    continue
                if shape[0] % 256 or shape[1] % 256:
                    continue  # excluded from selection (reference would crash)
                if cfg.saliency_accumulation == "per_step_stats":
                    shape = (shape[0] // 256, shape[1] // 256)
                acc[f"{li}.{mod}"] = torch.zeros(shape, dtype=torch.float32, device=device)
        state["acc"] = acc
    if cfg.channel_sparsity:
        act = {}
        for li, layer in master["layers"].items():
            for mod in TARGET_MODULES:
                if _wants_channel(cfg, mod):
                    in_dim = layer[mod].shape[1]
                    shape = ((in_dim,) if cfg.saliency_accumulation == "per_step_stats"
                             else (cfg.max_seq_len, in_dim))
                    act[f"{li}.{mod}"] = torch.zeros(shape, dtype=torch.float32, device=device)
        state["act_acc"] = act
    return state


def _wants_saliency(cfg: SMTConfig, module: str) -> bool:
    if module in ATTN_TARGETS:
        return cfg.downsample_attention_blocks_ratio > 0 or cfg.no_limit_mixture
    return cfg.downsample_mlp_blocks_ratio > 0 or cfg.no_limit_mixture


def _wants_channel(cfg: SMTConfig, module: str) -> bool:
    if module in ATTN_TARGETS:
        return cfg.num_attention_channel > 0 or cfg.no_limit_mixture
    return cfg.num_mlp_channel > 0 or cfg.no_limit_mixture


def _target_grad(grads: Dict[str, torch.Tensor], ks: str) -> torch.Tensor:
    layer, module = ks.split(".", 1)
    return grads[f"layers/{layer}/{module}"].float()


def build_warmup_step(cfg: SMTConfig, model_cfg: LlamaConfig,
                      lr_sched: Callable) -> Callable:
    adam_cfg = AdamConfig(betas=tuple(cfg.warmup_adam_betas), eps=cfg.adam_eps,
                          weight_decay=cfg.w_decay, grad_clip=cfg.grad_clip)
    param_dtype = cfg.param_dtype
    # --qk_scheduler boosts q/k_proj LR during warm-up too (fine_tune.py:160-163)
    lr_scale = make_qk_lr_scale(cfg.qk_lr_times) if cfg.qk_scheduler else None
    use_ls = cfg.dtype == "fp16"  # dynamic loss scaling

    def step(state: Dict, batch: Dict) -> tuple:
        master = state["master"]
        key = dropout_key(cfg, state, sparse=False)

        def loss_of(flat_master, mb):
            params = _cast_tree(master, param_dtype)
            raw = compute_loss(params, mb, cfg, model_cfg,
                               remat=cfg.gradient_checkpointing, dropout_key=key)
            return raw * state["loss_scale"] if use_ls else raw

        flat = flatten_tree(master)
        vag = accumulated_value_and_grad(loss_of, cfg.gradient_accumulation_steps)
        loss, grads = vag(flat, batch)

        with torch.no_grad():
            norm, ls_metrics = None, {}
            if use_ls:
                loss, grads, norm, ls_metrics, finite = unscale_and_check(loss, grads, state, cfg)
                if not finite:  # skipped: master, moments, count and acc stay as they were
                    return _skipped(state, flat, loss, norm, lr_sched(state["step"]),
                                    ls_metrics)
            if "acc" in state:
                # saliency accumulates the UNCLIPPED averaged grad, as the
                # reference harvests before optimizer clipping (fine_tune.py:716)
                if cfg.saliency_accumulation == "per_step_stats":
                    from sparse_matrix_tuning_tpu_torch.smt.select import block_stats_step
                    from sparse_matrix_tuning_tpu_torch.train.convert import harvest_strategy
                    for ks, acc in state["acc"].items():
                        strat = harvest_strategy(cfg, ks.split(".", 1)[1])
                        acc.add_(block_stats_step(_target_grad(grads, ks), strat))
                else:
                    for ks, acc in state["acc"].items():
                        acc.add_(_target_grad(grads, ks))

            grads, gnorm = clip_by_global_norm(grads, adam_cfg.grad_clip, norm=norm)
            lr = lr_sched(state["step"])
            opt_state = {"m": flatten_tree(state["m"]), "v": flatten_tree(state["v"]),
                         "count": state["count"]}
            adam_step(grads, opt_state, flat, lr, adam_cfg, lr_scale=lr_scale,
                      wd_mask=full_ft_wd_mask)
            del grads
            for p in flat.values():
                p.grad = None  # the fp32 grads are model-sized: free them now
            state["step"].add_(1)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **ls_metrics}

    return step


def _skipped(state: Dict, leaves: Dict[str, torch.Tensor], loss, norm, lr, ls_metrics):
    """An overflowed fp16 step: the grads of `leaves` are dropped and only
    the step counter advances (unscale_and_check has stepped the scaler),
    as the JAX twin's select keeps the old leaves and adds 1 to step."""
    for p in leaves.values():
        p.grad = None
    state["step"].add_(1)
    return state, {"loss": loss, "grad_norm": norm, "lr": lr, **ls_metrics}


def build_channel_warmup_step(cfg: SMTConfig, model_cfg: LlamaConfig) -> Callable:
    """The channel warm-up step: a forward only, which does not train
    (reference fine_tune.py:708 `continue`), with the full-logits loss, and
    the activation taps (models/llama._tapped) added into state["act_acc"]:
    padded to max_seq_len rows, or reduced per step by select.channel_stats
    under per_step_stats. Pad positions are excluded by the attention mask,
    as in the JAX twin (the reference's hooks also sum them)."""
    from sparse_matrix_tuning_tpu_torch.smt.select import channel_stats
    from sparse_matrix_tuning_tpu_torch.train.convert import harvest_strategy
    param_dtype = cfg.param_dtype

    @torch.no_grad()
    def step(state: Dict, batch: Dict) -> tuple:
        params = _cast_tree(state["master"], param_dtype)
        taps: Dict[str, torch.Tensor] = {}
        logits = forward(params, batch["input_ids"], model_cfg,
                         attention_mask=batch.get("attention_mask"),
                         activation_taps=taps, attn_impl=cfg.attn_impl)
        loss = causal_lm_loss(logits, batch["labels"])
        for ks, acc in state["act_acc"].items():
            tap = taps[ks]  # (S_batch, in_dim) batch-summed |activation|
            if cfg.saliency_accumulation == "per_step_stats":
                acc.add_(channel_stats(tap, harvest_strategy(cfg, ks.split(".", 1)[1])))
            else:
                acc[:tap.shape[0]].add_(tap)
        state["step"].add_(1)
        return state, {"loss": loss}

    return step


# ---------------------------------------------------------------------------
# Sparse (post-conversion) step
# ---------------------------------------------------------------------------

def init_sparse_state(params, trainable, step: int, cfg: Optional[SMTConfig] = None) -> Dict:
    """Zero Adam moments over the trainables and the step carried over; under
    fp16 a fresh scaler (the reference rebuilds the whole DeepSpeed engine at
    conversion, fine_tune.py:379-384)."""
    device = next(iter(trainable.values())).device
    for t in trainable.values():
        t.requires_grad_(True)
    return {
        "params": params,
        "trainable": trainable,
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
              for k, p in trainable.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
              for k, p in trainable.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "step": torch.full((), int(step), dtype=torch.int32, device=device),
        **(loss_scaler(cfg, device) if cfg is not None else {}),
    }


def build_sparse_step(cfg: SMTConfig, model_cfg: LlamaConfig, plan: SMTPlan,
                      lr_sched: Callable) -> Callable:
    adam_cfg = AdamConfig(betas=tuple(adam_betas(cfg, plan.mode)), eps=cfg.adam_eps,
                          weight_decay=cfg.w_decay, grad_clip=cfg.grad_clip)
    lr_scale = make_qk_lr_scale(cfg.qk_lr_times) if cfg.qk_scheduler else None
    # autograd parity: no backward below the lowest trainable layer
    lowest_layer = min(lp.layer for lp in plan.linears.values())
    adam = block_adam(adam_cfg, lr_scale)
    use_ls = cfg.dtype == "fp16"

    def step(state: Dict, batch: Dict) -> tuple:
        params = state["params"]
        trainable = state["trainable"]
        device = next(iter(trainable.values())).device
        impl = _resolve_impl(cfg.sparse_impl, device)
        key = dropout_key(cfg, state, sparse=True)

        def loss_of(tr, mb):
            linear = make_sparse_linear_dispatch(plan, tr, impl, qweights=state.get("q"))
            raw = compute_loss(params, mb, cfg, model_cfg, linear=linear,
                               remat=cfg.sparse_remat,
                               stop_grad_below_layer=lowest_layer, sparse=True,
                               q_head=state.get("q_head"), dropout_key=key)
            return raw * state["loss_scale"] if use_ls else raw

        vag = accumulated_value_and_grad(loss_of, cfg.gradient_accumulation_steps)
        loss, grads = vag(trainable, batch)
        with torch.no_grad():
            norm, ls_metrics = None, {}
            if use_ls:
                loss, grads, norm, ls_metrics, finite = unscale_and_check(loss, grads, state, cfg)
                if not finite:  # skipped: trainables, moments, count, dense weights unchanged
                    return _skipped(state, trainable, loss, norm, lr_sched(state["count"]),
                                    ls_metrics)
            grads, gnorm = clip_by_global_norm(grads, adam_cfg.grad_clip, norm=norm)
            lr = lr_sched(state["count"])
            adam(impl, grads, state, trainable, lr)
            del grads
            for p in trainable.values():
                p.grad = None
            # scatter-at-update: the dense weights absorb the new block (or
            # column) values once per step, in place (weights offloaded to
            # the host are skipped: the int8 path reads the trainable blocks
            # directly)
            plan.scatter(params["layers"], trainable)
            state["step"].add_(1)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **ls_metrics}

    return step


def adam_betas(cfg: SMTConfig, mode: str):
    """The sparse phase's Adam betas: the reference hardcodes (0.9, 0.95) on
    the matrix path (fine_tune.py:361-363) and (0.95, 0.999) on the channel
    path (:538-540)."""
    return cfg.matrix_adam_betas if mode == "matrix" else cfg.channel_adam_betas


def block_adam(adam_cfg: AdamConfig, lr_scale) -> Callable:
    """The sparse phases' Adam update, in place: adam(impl, grads, state,
    trainable, lr) over state's "m", "v" and "count". K2 on impl "kernel"
    (any contiguous fp32 leaf whose numel is a multiple of 4: blocks,
    columns, or a module's stack of either; masked_adam raises on any
    other), with the scalars on the device (made once per device); else
    smt/optimizer.adam_step."""
    consts: Dict[str, torch.Tensor] = {}  # device -> [b1, b2, eps, wd]

    def adam(impl: str, grads, state, trainable, lr):
        opt_state = {"m": state["m"], "v": state["v"], "count": state["count"]}
        if impl != "kernel":
            return adam_step(grads, opt_state, trainable, lr, adam_cfg, lr_scale=lr_scale)
        device = state["count"].device
        key = str(device)
        if key not in consts:
            b1, b2 = adam_cfg.betas
            consts[key] = torch.tensor([b1, b2, adam_cfg.eps, adam_cfg.weight_decay],
                                       dtype=torch.float32, device=device)
        return _fused_block_adam_update(grads, opt_state, trainable, lr, adam_cfg,
                                        lr_scale, consts[key])
    return adam


def _fused_block_adam_update(grads, opt_state, trainable, lr, adam_cfg,
                             lr_scale, consts):
    """K2 over every trainable linear, or every stacked module of the scan
    state (one launch each, as the JAX twin's per-tensor Pallas loop). The
    scalars stay on the device: bias corrections come from the device step
    count in fp32, and a linear's LR scale (make_qk_lr_scale) is folded
    into its lr."""
    b1, b2 = adam_cfg.betas
    opt_state["count"].add_(1)
    c = opt_state["count"].float()
    bc = torch.stack([1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)])
    scalars_by_scale: Dict[float, torch.Tensor] = {}
    for ks, p in trainable.items():
        s = lr_scale(ks) if lr_scale is not None else 1.0
        if s not in scalars_by_scale:
            scalars_by_scale[s] = torch.cat([(lr * s).reshape(1).float(), consts, bc])
        masked_adam(p, grads[ks], opt_state["m"][ks], opt_state["v"][ks],
                    scalars_by_scale[s])
    return trainable, opt_state


# ---------------------------------------------------------------------------
# Eval loss
# ---------------------------------------------------------------------------

def build_eval_step(cfg: SMTConfig, model_cfg: LlamaConfig, plan=None) -> Callable:
    """Forward-only loss (reference helpers/helper.py:210-245). In the
    sparse phase the dense weights already contain the current block values
    (scatter-at-update), so eval is a plain dense forward.

    plan: needed only when the dense weights were offloaded to the host
    (train/convert.py offload_frozen_to_host): eval then runs the same
    q8-corrected sparse dispatch as the training forward."""
    param_dtype = cfg.param_dtype

    @torch.no_grad()
    def step(state, batch) -> torch.Tensor:
        linear = None
        if "master" in state:
            params = _cast_tree(state["master"], param_dtype)
        else:
            params = state["params"]
            if plan is not None and "q" in state:
                linear = make_sparse_linear_dispatch(plan, state["trainable"],
                                                     cfg.sparse_impl, qweights=state["q"])
        # sparse-phase eval mirrors the training forward, int8 head included,
        # so the eval loss tracks the trained objective
        return compute_loss(params, batch, cfg, model_cfg, linear=linear, remat=False,
                            sparse="master" not in state, q_head=state.get("q_head"))

    return step
