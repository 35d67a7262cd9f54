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

Data parallelism (a `mesh`, parallel/mesh.py): each rank steps on its rows
of the global batch with the global microbatch's valid-token count as the
loss denominator (batch["loss_denom"], data/sft.shard_batch), and
accumulated_value_and_grad SUMs the loss and the grads over the ranks
after the last microbatch's backward: the warm-up's every dense grad, the
sparse phase's selected blocks or columns, the scan state's stacks. Every
rank then holds the global batch's loss and grads, so the overflow test,
the clip norm, the saliency accumulators and the update agree bit for bit.

The fsdp axis (a mesh with F > 1 and the state's parallel/fsdp.Sharding):
the master, moments, accumulators, trainables and frozen base are this
rank's shards, the forward gathers each layer where it runs
(fsdp.LayerGather) and the backward reduce-scatters its grads over the
fsdp group, so a sharded leaf's grad is summed over the data group after
the last microbatch and a whole leaf's (the norms) over the world; the
clip norm sums the shards' squares over the fsdp group and counts a whole
leaf's once; Adam, K2 among it, runs on the shards.

The tensor axis (a mesh with T > 1; parallel/tensor.py): the forward runs
each layer on its tensor slices and the loss over this rank's vocabulary
rows (head_loss); the ranks of a tensor group see the same rows, so the
loss and the grads of leaves whole over fsdp are summed over the batch
group (the D*F ranks of one tensor index), not the world; the sparse
phase's block grads are each rank's parts of the blocks (ops/
sparse_linear.smt_linear(tensor=); over the scan state smt_linear_dyn's,
summed at the valid entries only), summed over the tensor group as well;
the clip norm sums the squares of a tensor-split leaf over the tensor
group and counts a leaf whole over tensor once, so it (and fp16's
overflow test) is equal on every rank. A q/k/v bias is whole on every
rank and each rank's grad holds its rows only: the warm-up sums it over
the tensor group with the block-grad parts (a whole leaf then, as JAX's
P() bias). Dropout masks are drawn whole and cut to the rank's rows and
kv heads (models/llama._attn_dropout). In channel mode the warm-up keeps
each rank's columns of the activation sums (build_channel_warmup_step),
and the columns' grads are each rank's parts (ops/sparse_linear.
smt_channel_linear(tensor=)), summed over the tensor group whole.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Mapping, Optional

import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import (
    ATTN_TARGETS, TARGET_MODULES, LlamaConfig, causal_lm_loss, default_linear,
    flatten_tree, forward, lm_head_weight, tree_map,
)
from sparse_matrix_tuning_tpu_torch.ops.cuda.masked_adam import masked_adam
from sparse_matrix_tuning_tpu_torch.ops.loss import (
    chunked_causal_lm_loss, chunked_causal_lm_loss_q8, vocab_parallel_causal_lm_loss)
from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import (
    _resolve_impl, frozen_q8_linear, make_sparse_linear_dispatch)
from sparse_matrix_tuning_tpu_torch.parallel.fsdp import LayerGather, block_stats_sharded
from sparse_matrix_tuning_tpu_torch.parallel.mesh import all_gather_, all_reduce_
from sparse_matrix_tuning_tpu_torch.parallel.tensor import to_tensor_region
from sparse_matrix_tuning_tpu_torch.smt.optimizer import (
    AdamConfig, adam_step, clip_by_global_norm, full_ft_wd_mask, global_norm,
    make_qk_lr_scale,
)
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan


def _cast_tree(tree, dtype):
    return tree_map(lambda p: p.to(dtype), tree)


def accumulated_value_and_grad(loss_of, accum_steps: int, mesh=None, sharded=(),
                               tensor_parts: Optional[Mapping] = None):
    """Microbatch gradient accumulation (the reference delegates this to the
    DeepSpeed engine). Returns vag(params, batch) -> (mean loss, grads):
    `params` is a flat {key: leaf tensor requiring grad}; the global batch's
    leading dim is split into `accum_steps` microbatches, each backward adds
    into .grad, and loss and grads are scaled by 1/accum_steps at the end —
    the JAX twin's sum-then-scale order. Each microbatch loss is a mean over
    its own valid tokens and microbatches weigh equally (DeepSpeed
    semantics). With a mesh the batch is this rank's rows and each loss
    its token-loss sum over the global microbatch's count: the loss and
    the grads are SUM-reduced over the ranks (parallel/mesh.all_reduce_,
    in buckets) after the last microbatch's backward. Under fsdp the
    grads of the `sharded` keys are reduce-scattered shards already
    (fsdp.gather's backward): they are summed over the data group, the
    loss and the other grads over the batch group (the world without a
    tensor axis). The grads of the `tensor_parts` keys are each tensor rank's
    parts (the tensor axis's block grads): summed over the tensor group
    as well. Its value for a key, where not None, names by their positions
    in the grad's first two dims flattened (int64, on its device) the only
    entries that hold parts (the scan state's valid entries): the others
    are 0 on every rank, so only those rows are summed, with the same
    result (_sum_parts); None sums the grad whole."""

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
        if mesh is not None:
            split = [g for k, g in grads.items() if k in sharded]
            parts = tensor_parts or {}
            whole = [g for k, g in grads.items() if k not in sharded and k not in parts]
            all_reduce_(split, mesh, "data")
            _sum_parts({k: g for k, g in grads.items() if k in sharded and k in parts}, parts,
                       mesh, "tensor")
            all_reduce_([total] + whole, mesh, "batch")
            _sum_parts({k: g for k, g in grads.items() if k not in sharded and k in parts},
                       parts, mesh, "world")
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            total = total * inv
            grads = {k: g.mul_(inv) for k, g in grads.items()}
        return total, grads

    return vag


def _sum_parts(grads: Dict[str, torch.Tensor], rows, mesh, over: str) -> None:
    """all_reduce_ over `over` of the tensor ranks' block-grad parts, in
    place, counted in mesh.stats["grad_parts_*"]: of a key with rows only
    those entries (picked, summed in the same buckets, written back)."""
    picked = {k: g if rows.get(k) is None else g.view(-1, *g.shape[2:]).index_select(0, rows[k])
              for k, g in grads.items()}
    all_reduce_(list(picked.values()), mesh, over, stat="grad_parts")
    for k, p in picked.items():
        if rows.get(k) is not None:
            grads[k].view(-1, *grads[k].shape[2:]).index_copy_(0, rows[k], p)


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


def dropout_key(cfg: SMTConfig, state: Dict, sparse: bool, mesh=None):
    """The (base seed, step) the step's dropout masks derive from
    (models/llama.dropout_layer_seed), or None without --dropout: base seed
    cfg.seed in the warm-up and cfg.seed + 1 in the sparse phase, as the
    JAX steps key theirs (steps.py:284, :433; scan_phase.py:784). With a
    mesh, (seed, step, rank, D * F row slices): the rank's rows of the
    global microbatch's mask (models/llama._run). Reads the step on the host,
    once a step, only under dropout."""
    if cfg.dropout <= 0:
        return None
    key = (cfg.seed + (1 if sparse else 0), int(state["step"]))
    return key if mesh is None else key + (mesh.batch_index, mesh.batch_shards)


def compute_loss(params, batch, cfg: SMTConfig, model_cfg: LlamaConfig,
                 linear=None, remat=True, stop_grad_below_layer=None,
                 sparse=False, q_head=None, dropout_key=None, fsdp=None):
    """Shared loss path of all steps: full logits + CE, or the chunked-vocab
    CE (ops/loss.py), by the _use_chunked_loss policy (sparse-phase steps
    pass sparse=True).

    q_head: optional {"wq" int8 (V, D), "sw" fp32 (V,)} frozen int8 lm-head
    (train/convert.py build_q_head): the head matmul is then K4 in BOTH
    loss forms (the head is frozen in the sparse phase: int8 forward,
    straight-through int8 grad_hidden, no weight gradient), dense via
    frozen_q8_linear over the full logits, chunked via
    chunked_causal_lm_loss_q8. dropout_key: the training step's
    (seed, step) under attention dropout (dropout_key()), None in eval.
    fsdp: the fsdp.LayerGather of a params tree of shards (forward's)."""
    kw = dict(attention_mask=batch.get("attention_mask"),
              linear=linear or default_linear, remat=remat,
              stop_grad_below_layer=stop_grad_below_layer, attn_impl=cfg.attn_impl,
              dropout_key=dropout_key, fsdp=fsdp)
    return head_loss(lambda hidden: forward(params, batch["input_ids"], model_cfg,
                                            return_hidden=hidden, **kw),
                     params, batch, cfg, model_cfg, sparse, q_head, fsdp)


def head_loss(run, params, batch, cfg: SMTConfig, model_cfg: LlamaConfig, sparse: bool,
              q_head=None, fsdp=None):
    """The loss of compute_loss over a decoder `run(return_hidden)` (forward
    or, for the scan state, forward_scan): the loss path and the head as
    compute_loss describes them; under fsdp the head (or the int8 head's
    wq) is gathered here (over fsdp only); under the tensor axis
    (fsdp.tensor) the head, exact or int8, is this rank's vocabulary rows
    and both loss forms are vocabulary-parallel (ops/loss.py)."""
    b, sq = batch["input_ids"].shape
    denom = batch.get("loss_denom")  # data parallelism: the global count
    tensor = getattr(fsdp, "tensor", None)
    if fsdp is not None:
        q_head = fsdp.q_head(q_head)
    if _use_chunked_loss(cfg, model_cfg, sparse=sparse, batch_tokens=b * (sq - 1)):
        hidden = run(True)
        if q_head is not None:
            return chunked_causal_lm_loss_q8(hidden, q_head["wq"], q_head["sw"],
                                             batch["labels"], cfg.vocab_chunk, denom, tensor)
        head = lm_head_weight(params, model_cfg) if fsdp is None else \
            fsdp.head(params, model_cfg.tie_word_embeddings)
        if tensor is not None:
            hidden = to_tensor_region(hidden, tensor)
        return chunked_causal_lm_loss(hidden, head, batch["labels"], cfg.vocab_chunk, denom,
                                      tensor)
    if q_head is not None:
        # fp32 input -> fp32 logits straight from the int32 product
        h = run(True).float()
        if tensor is None:
            return causal_lm_loss(frozen_q8_linear(h, q_head["wq"], q_head["sw"]),
                                  batch["labels"], denom)
        # the rank's vocabulary rows: the grad's g * sw rows lie across the ranks
        logits = frozen_q8_linear(to_tensor_region(h, tensor), q_head["wq"], q_head["sw"],
                                  tensor, "out")
        return vocab_parallel_causal_lm_loss(logits, batch["labels"], tensor, denom)
    if tensor is not None:
        return vocab_parallel_causal_lm_loss(run(False), batch["labels"], tensor, denom)
    return causal_lm_loss(run(False), batch["labels"], denom)


# ---------------------------------------------------------------------------
# Warm-up (full fine-tuning) step
# ---------------------------------------------------------------------------

# "auto" saliency accumulation switches to per_step_stats once the grad_sum
# accumulators would exceed this many bytes of fp32 device memory.
SALIENCY_AUTO_GRAD_SUM_LIMIT = 2 * 1024 ** 3


def _grad_sum_accumulator_bytes(master, cfg: SMTConfig, shape_of=None) -> int:
    total = 0
    for li, layer in master["layers"].items():
        for mod in TARGET_MODULES:
            shape = tuple(layer[mod].shape) if shape_of is None else \
                shape_of(f"layers/{li}/{mod}", layer[mod])
            if cfg.matrix_sparsity and _wants_saliency(cfg, mod) \
                    and not (shape[0] % 256 or shape[1] % 256):
                total += shape[0] * shape[1] * 4
            if cfg.channel_sparsity and _wants_channel(cfg, mod):
                total += cfg.max_seq_len * shape[1] * 4
    return total


def resolve_saliency_accumulation(cfg: SMTConfig, master, shape_of=None) -> str:
    """Resolve saliency_accumulation="auto": reference-exact grad_sum while
    the accumulators stay small, per_step_stats at scale (exact for the
    matrix mean_abs reducer — signed-mean accumulation,
    select.block_stats_step — and for channel mean_abs / abs_mean / L1).
    The bytes are the full accumulators', on a mesh too, as JAX counts
    them (shape_of(path, leaf): a sharded master leaf's full shape).
    Mutates cfg so later consumers agree."""
    if cfg.saliency_accumulation == "auto":
        over = _grad_sum_accumulator_bytes(master, cfg, shape_of) > SALIENCY_AUTO_GRAD_SUM_LIMIT
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


def sharded_global_norm(grads: Dict[str, torch.Tensor], mesh=None, sharded=(),
                        tensor_split=()) -> torch.Tensor:
    """global_norm of grads of which the `sharded` keys are this rank's
    fsdp shards and the `tensor_split` keys its tensor slices: their
    squares summed over the fsdp group, the tensor group, or both, a leaf
    whole over an axis counted once over it. Equal on every rank;
    global_norm without fsdp or tensor."""
    if mesh is None or (mesh.fsdp == 1 and mesh.tensor == 1) or not (sharded or tensor_split):
        return global_norm(grads)
    sums = {kind: [] for kind in ("both", "fsdp", "tensor", "whole")}
    for k, g in grads.items():
        kind = ("both" if k in tensor_split else "fsdp") if k in sharded else \
            ("tensor" if k in tensor_split else "whole")
        sums[kind].append(torch.sum(torch.square(g.float())))
    zero = next(iter(grads.values())).new_zeros((), dtype=torch.float32)
    s = {kind: torch.sum(torch.stack(v)) if v else zero for kind, v in sums.items()}
    over_f = torch.stack([s["both"], s["fsdp"]])
    all_reduce_([over_f], mesh, "fsdp")
    over_t = torch.stack([over_f[0], s["tensor"]])
    all_reduce_([over_t], mesh, "tensor")
    return torch.sqrt(over_t[0] + over_t[1] + over_f[1] + s["whole"])


@torch.no_grad()
def unscale_and_check(loss: torch.Tensor, grads: Dict[str, torch.Tensor], state: Dict,
                      cfg: SMTConfig, norm_of=global_norm):
    """After a backward of the scaled loss: the loss and the fp32 grads
    (in place) times 1 / loss_scale, their global norm, and the scaler
    stepped in place on the device. Returns (loss, grads, norm, metrics,
    finite): finite = isfinite(loss) & isfinite(norm) read on the host,
    the one sync that loss scaling adds to a step, taken before the caller
    updates anything in place; metrics = {"loss_scale": the scale the step
    ran at, "overflow": not finite}. An overflowed step must then leave
    every other leaf as it was (the JAX twin's select-on-overflow).
    norm_of: the global norm of the grads (under fsdp over the shards of
    every rank, so one rank's inf makes every rank skip)."""
    inv = torch.reciprocal(state["loss_scale"])
    loss = loss * inv
    for g in grads.values():
        g.mul_(inv)
    norm = norm_of(grads)
    finite_t = torch.isfinite(loss) & torch.isfinite(norm)
    ran_at = state["loss_scale"].clone()
    scale, good = update_loss_scale(state["loss_scale"], state["good_steps"], finite_t,
                                    cfg.loss_scale_window)
    state["loss_scale"].copy_(scale)
    state["good_steps"].copy_(good)
    finite = bool(finite_t)
    return loss, grads, norm, {"loss_scale": ran_at, "overflow": not finite}, finite


def init_warmup_state(master, cfg: SMTConfig, device=None, sharding=None) -> Dict:
    """fp32 master copies (leaf tensors requiring grad), zero Adam moments,
    step counters and the saliency accumulators, on `device` (default: the
    params' device). Channel mode keeps the master and moments too, as the
    JAX twin does, though its warm-up never trains; its accumulators
    ("act_acc") are (max_seq_len, in_dim) positional |activation| sums, or
    (in_dim,) running per-channel stats under per_step_stats.

    sharding (the fsdp axis): `master` holds this rank's shards at state
    path "master/..." (fsdp.Sharding.shard_tree); the moments take their
    dims and the accumulators are made at their shards' sizes (under the
    tensor axis act_acc's (S, C) sums hold the rank's C/T columns, its
    (C,) per-step stats stay whole)."""
    def full_shape(sub, t):
        return tuple(t.shape) if sharding is None else sharding.full_shape(f"master/{sub}", t)

    resolve_saliency_accumulation(cfg, master, full_shape)
    if device is None:
        device = master["embed_tokens"].device

    def zeros(path, shape):
        if sharding is None:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return sharding.zeros(path, shape, torch.float32, device)

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
    if sharding is not None:
        sharding.alias("master", "m")
        sharding.alias("master", "v")
    state.update(loss_scaler(cfg, device))  # fp16: carried through the channel warm-up too
    if cfg.matrix_sparsity:
        acc = {}
        for li, layer in master["layers"].items():
            for mod in TARGET_MODULES:
                shape = full_shape(f"layers/{li}/{mod}", layer[mod])
                if not _wants_saliency(cfg, mod):
                    continue
                if shape[0] % 256 or shape[1] % 256:
                    continue  # excluded from selection (reference would crash)
                if cfg.saliency_accumulation == "per_step_stats":
                    shape = (shape[0] // 256, shape[1] // 256)
                acc[f"{li}.{mod}"] = zeros(f"acc/{li}.{mod}", shape)
        state["acc"] = acc
    if cfg.channel_sparsity:
        act = {}
        for li, layer in master["layers"].items():
            for mod in TARGET_MODULES:
                if _wants_channel(cfg, mod):
                    in_dim = full_shape(f"layers/{li}/{mod}", layer[mod])[1]
                    shape = ((in_dim,) if cfg.saliency_accumulation == "per_step_stats"
                             else (cfg.max_seq_len, in_dim))
                    act[f"{li}.{mod}"] = zeros(f"act_acc/{li}.{mod}", shape)
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
                      lr_sched: Callable, mesh=None, sharding=None) -> Callable:
    """The warm-up step. sharding (the fsdp axis): the state is this
    rank's shards (module notes)."""
    adam_cfg = AdamConfig(betas=tuple(cfg.warmup_adam_betas), eps=cfg.adam_eps,
                          weight_decay=cfg.w_decay, grad_clip=cfg.grad_clip)
    param_dtype = cfg.param_dtype
    # --qk_scheduler boosts q/k_proj LR during warm-up too (fine_tune.py:160-163)
    lr_scale = make_qk_lr_scale(cfg.qk_lr_times) if cfg.qk_scheduler else None
    use_ls = cfg.dtype == "fp16"  # dynamic loss scaling
    tensor = mesh is not None and mesh.tensor > 1

    def step(state: Dict, batch: Dict) -> tuple:
        master = state["master"]
        key = dropout_key(cfg, state, sparse=False, mesh=mesh)
        gather = None if sharding is None else LayerGather(sharding, "master", cast=param_dtype)

        def loss_of(flat_master, mb):
            params = _cast_tree(master, param_dtype) if gather is None else master
            raw = compute_loss(params, mb, cfg, model_cfg,
                               remat=cfg.gradient_checkpointing, dropout_key=key, fsdp=gather)
            return raw * state["loss_scale"] if use_ls else raw

        flat = flatten_tree(master)
        sharded = () if sharding is None else sharding.sharded_keys("master", flat)
        tsplit = () if sharding is None else sharding.tensor_keys("master", flat)
        # a q/k/v bias is whole on every rank, its grad each rank's rows
        # (models/llama._lin): summed over the tensor group too
        biases = dict.fromkeys(k for k in flat if k.endswith("_bias")) if tensor else None
        vag = accumulated_value_and_grad(loss_of, cfg.gradient_accumulation_steps, mesh, sharded,
                                         biases)
        loss, grads = vag(flat, batch)

        with torch.no_grad():
            norm_of = partial(sharded_global_norm, mesh=mesh, sharded=sharded,
                              tensor_split=tsplit)
            ls_metrics = {}
            if use_ls:
                loss, grads, norm, ls_metrics, finite = unscale_and_check(loss, grads, state, cfg,
                                                                          norm_of)
                if not finite:  # skipped: master, moments, count and acc stay as they were
                    return _skipped(state, flat, loss, norm, lr_sched(state["step"]),
                                    ls_metrics)
            else:
                norm = norm_of(grads)
            if "acc" in state:
                _harvest(cfg, state["acc"], grads, mesh, sharding)

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


def _harvest(cfg: SMTConfig, accs: Dict[str, torch.Tensor], grads, mesh=None, sharding=None):
    """Saliency accumulates the UNCLIPPED averaged grad, as the reference
    harvests before optimizer clipping (fine_tune.py:716): the grad itself
    (grad_sum) or select.block_stats_step's per-step statistic. Under fsdp
    the statistic's partial sums over the grad's shards are combined over
    the fsdp and tensor groups first (fsdp.block_stats_sharded), and each
    rank keeps its accumulator's shard."""
    from sparse_matrix_tuning_tpu_torch.train.convert import harvest_strategy
    if cfg.saliency_accumulation != "per_step_stats":
        for ks, acc in accs.items():
            acc.add_(_target_grad(grads, ks))
        return
    if sharding is None:
        from sparse_matrix_tuning_tpu_torch.smt.select import block_stats_step
        for ks, acc in accs.items():
            acc.add_(block_stats_step(_target_grad(grads, ks), harvest_strategy(cfg, ks.split(
                ".", 1)[1])))
        return
    items = {}
    for ks in accs:
        li, mod = ks.split(".", 1)
        items[ks] = sharding.stat_item(f"master/layers/{li}/{mod}", grads[f"layers/{li}/{mod}"])
    stats = block_stats_sharded(items, lambda ks: harvest_strategy(cfg, ks.split(".", 1)[1]),
                                mesh, signed=True)
    for ks, acc in accs.items():
        acc.add_(sharding.local(f"acc/{ks}", stats[ks]))


def _skipped(state: Dict, leaves: Dict[str, torch.Tensor], loss, norm, lr, ls_metrics):
    """An overflowed fp16 step: the grads of `leaves` are dropped and only
    the step counter advances (unscale_and_check has stepped the scaler),
    as the JAX twin's select keeps the old leaves and adds 1 to step."""
    for p in leaves.values():
        p.grad = None
    state["step"].add_(1)
    return state, {"loss": loss, "grad_norm": norm, "lr": lr, **ls_metrics}


def build_channel_warmup_step(cfg: SMTConfig, model_cfg: LlamaConfig, mesh=None,
                              sharding=None) -> Callable:
    """The channel warm-up step: a forward only, which does not train
    (reference fine_tune.py:708 `continue`), with the full-logits loss, and
    the activation taps (models/llama._tapped) added into state["act_acc"]:
    padded to max_seq_len rows, or reduced per step by select.channel_stats
    under per_step_stats. Pad positions are excluded by the attention mask,
    as in the JAX twin (the reference's hooks also sum them).

    With a mesh each rank sums |x| over its own rows, and the loss and
    the taps are SUM-reduced over the batch group every step, before they
    are accumulated: every rank's act_acc then holds the global batch's
    sums (as JAX's taps over the global batch do), so a checkpoint that
    rank 0 writes mid warm-up restores on every rank (and per_step_stats'
    L2 statistic, not linear in the taps, reads the global ones). Under
    fsdp the forward gathers each layer of the master's shards; the taps
    stay whole.

    Under the tensor axis the loss is vocabulary-parallel (the logits are
    the rank's vocabulary rows) and each rank keeps its C/T columns of
    every tap, as JAX splits act_acc: a row-parallel linear's input is the
    rank's columns already, a column-parallel one's is whole and is cut,
    once per shared input (q/k/v, gate/up), so the reduce stays one a
    tap. Under per_step_stats the statistics of the rank's columns are
    gathered over the tensor group (one all-gather a step) into the whole
    (C,) leaf, which every rank holds."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import COL_PARALLEL
    from sparse_matrix_tuning_tpu_torch.smt.select import channel_stats
    from sparse_matrix_tuning_tpu_torch.train.convert import harvest_strategy
    param_dtype = cfg.param_dtype
    tensor = mesh if mesh is not None and mesh.tensor > 1 else None
    per_step = cfg.saliency_accumulation == "per_step_stats"

    @torch.no_grad()
    def step(state: Dict, batch: Dict) -> tuple:
        gather = None if sharding is None else LayerGather(sharding, "master", cast=param_dtype)
        params = _cast_tree(state["master"], param_dtype) if gather is None else state["master"]
        taps: Dict[str, torch.Tensor] = {}
        logits = forward(params, batch["input_ids"], model_cfg,
                         attention_mask=batch.get("attention_mask"),
                         activation_taps=taps, attn_impl=cfg.attn_impl, fsdp=gather)
        if tensor is None:
            loss = causal_lm_loss(logits, batch["labels"], batch.get("loss_denom"))
        else:
            loss = vocab_parallel_causal_lm_loss(logits, batch["labels"], tensor,
                                                 batch.get("loss_denom"))
            cut: Dict[int, tuple] = {}   # id of a shared tap -> (the tap, its cut)
            for ks in state["act_acc"]:
                tap = taps[ks]
                if ks.split(".", 1)[1] in COL_PARALLEL:
                    if id(tap) not in cut:
                        cut[id(tap)] = (tap, tap.chunk(tensor.tensor, -1)[
                            tensor.tensor_index].contiguous())
                    taps[ks] = cut[id(tap)][1]
        if mesh is not None:
            all_reduce_([loss] + [taps[ks] for ks in state["act_acc"]], mesh, "batch",
                        stat="taps")
        if per_step:
            stats = {ks: channel_stats(taps[ks], harvest_strategy(cfg, ks.split(".", 1)[1]))
                     for ks in state["act_acc"]}
            if tensor is not None:
                stats = gather_tensor_columns(stats, tensor)
        for ks, acc in state["act_acc"].items():
            tap = taps[ks]  # (S_batch, in_dim) batch-summed |activation|
            if per_step:
                acc.add_(stats[ks])
            else:
                acc[:tap.shape[0]].add_(tap)
        state["step"].add_(1)
        return state, {"loss": loss}

    return step


def gather_tensor_columns(parts: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """{key: (C,)} of {key: (C/T,)}, each rank's columns of a per-column
    statistic, in one all-gather over the tensor group (every rank calls it
    with the same keys in the same order)."""
    keys = list(parts)
    flat = torch.cat([parts[k].reshape(-1) for k in keys])
    full = all_gather_(flat, mesh, "tensor").view(mesh.tensor, -1)
    out, off = {}, 0
    for k in keys:
        n = parts[k].numel()
        out[k] = full[:, off:off + n].reshape(-1)
        off += n
    return out


# ---------------------------------------------------------------------------
# Sparse (post-conversion) step
# ---------------------------------------------------------------------------

def init_sparse_state(params, trainable, step: int, cfg: Optional[SMTConfig] = None,
                      sharding=None) -> Dict:
    """Zero Adam moments over the trainables and the step carried over; under
    fp16 a fresh scaler (the reference rebuilds the whole DeepSpeed engine at
    conversion, fine_tune.py:379-384). sharding: the moments take the
    trainables' shard dims."""
    if sharding is not None:
        sharding.alias("trainable", "m")
        sharding.alias("trainable", "v")
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
                      lr_sched: Callable, mesh=None, sharding=None) -> Callable:
    """The sparse step. sharding (the fsdp axis): the dense weights, the
    trainables, their moments and the int8 base are this rank's shards;
    the forward gathers each layer's (K1 computes full block grads, which
    gather's backward reduce-scatters), K2 runs on the shards, and the
    updated trainables are gathered for plan.scatter (module notes)."""
    adam_cfg = AdamConfig(betas=tuple(adam_betas(cfg, plan.mode)), eps=cfg.adam_eps,
                          weight_decay=cfg.w_decay, grad_clip=cfg.grad_clip)
    lr_scale = make_qk_lr_scale(cfg.qk_lr_times) if cfg.qk_scheduler else None
    # autograd parity: no backward below the lowest trainable layer
    lowest_layer = min(lp.layer for lp in plan.linears.values())
    adam = block_adam(adam_cfg, lr_scale)
    use_ls = cfg.dtype == "fp16"
    tensor = mesh if mesh is not None and mesh.tensor > 1 else None

    def step(state: Dict, batch: Dict) -> tuple:
        params = state["params"]
        trainable = state["trainable"]
        device = next(iter(trainable.values())).device
        impl = _resolve_impl(cfg.sparse_impl, device)
        key = dropout_key(cfg, state, sparse=True, mesh=mesh)

        def loss_of(tr, mb):
            gather, linear = None, None
            if sharding is None:
                linear = make_sparse_linear_dispatch(plan, tr, impl, qweights=state.get("q"))
            else:
                q = state.get("q")
                gather = LayerGather(
                    sharding, "params", extras={"trainable": tr, "q": q or {}},
                    make_linear=lambda t, qw: make_sparse_linear_dispatch(
                        plan, t, impl, qweights=qw if q is not None else None,
                        tensor=tensor))
            raw = compute_loss(params, mb, cfg, model_cfg, linear=linear,
                               remat=cfg.sparse_remat,
                               stop_grad_below_layer=lowest_layer, sparse=True,
                               q_head=state.get("q_head"), dropout_key=key, fsdp=gather)
            return raw * state["loss_scale"] if use_ls else raw

        sharded = () if sharding is None else sharding.sharded_keys("trainable", trainable)
        # the tensor axis: each rank's K1 gives its parts of the blocks
        parts = dict.fromkeys(trainable) if tensor is not None else None
        vag = accumulated_value_and_grad(loss_of, cfg.gradient_accumulation_steps, mesh, sharded,
                                         parts)
        loss, grads = vag(trainable, batch)
        with torch.no_grad():
            norm_of = partial(sharded_global_norm, mesh=mesh, sharded=sharded)
            ls_metrics = {}
            if use_ls:
                loss, grads, norm, ls_metrics, finite = unscale_and_check(loss, grads, state, cfg,
                                                                          norm_of)
                if not finite:  # skipped: trainables, moments, count, dense weights unchanged
                    return _skipped(state, trainable, loss, norm, lr_sched(state["count"]),
                                    ls_metrics)
            else:
                norm = norm_of(grads)
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
            plan.scatter(params["layers"], trainable, sharding)
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

def build_eval_step(cfg: SMTConfig, model_cfg: LlamaConfig, plan=None,
                    sharding=None) -> Callable:
    """Forward-only loss (reference helpers/helper.py:210-245). In the
    sparse phase the dense weights already contain the current block values
    (scatter-at-update), so eval is a plain dense forward.

    plan: needed only when the dense weights were offloaded to the host
    (train/convert.py offload_frozen_to_host): eval then runs the same
    q8-corrected sparse dispatch as the training forward. Under data
    parallelism the loss is this rank's part (the token-loss sum over the
    global count, batch["loss_denom"]), which the trainer reduces. Under
    fsdp the forward gathers each layer of the shards (the master's in the
    warm-up, the dense weights' after it)."""
    param_dtype = cfg.param_dtype

    @torch.no_grad()
    def step(state, batch) -> torch.Tensor:
        linear = None
        if sharding is not None:
            warm = "master" in state
            return compute_loss(state["master" if warm else "params"], batch, cfg, model_cfg,
                                remat=False, sparse=not warm, q_head=state.get("q_head"),
                                fsdp=LayerGather(sharding, "master" if warm else "params",
                                                 cast=param_dtype if warm else None))
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
