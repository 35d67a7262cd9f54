"""The SMT conversion event: saliency stats -> selection -> SMTPlan ->
sparse train state (matrix and channel mode; PyTorch twin of
`sparse_matrix_tuning_tpu.train.convert`).

Stats are reduced on the device from the accumulators and copied to the
host as tiny numpy arrays ((R/256, C/256) per linear in matrix mode, (C,)
in channel mode); selection (smt/select.py) is numpy with the reference's
total-order tie-break, so the plan — and its fingerprint — equals the JAX
package's on equal stats.

Quirk preserved: the reference omits calculate_strategy when selecting
ATTENTION blocks or channels, so attention always uses "mean_abs" while
MLP uses the configured strategy (fine_tune.py:306-313 vs :319-327,
:472-477 vs :493-498).

With frozen_quant=int8 the conversion also quantizes every layer linear
once from the fp32 master (build_qweights; the head too, build_q_head),
and offload_frozen_to_host moves the then compute-dead dense weights to
host memory, leaving 1-element placeholders on the device. With scan=True
the conversion builds the stacked scan state instead
(train/scan_phase.build_scan_sparse_state).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import (
    ATTN_TARGETS, MLP_TARGETS, lm_head_weight, tree_map)
from sparse_matrix_tuning_tpu_torch.ops.quant import quantize_weight
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan, parse_key
from sparse_matrix_tuning_tpu_torch.smt.select import (
    block_stats, block_stats_final, channel_stats, count_total_blocks, num_selected_blocks,
    select_channels, select_submatrices,
)

ATTENTION_CALCULATE_STRATEGY = "mean_abs"  # reference default-arg quirk


def harvest_strategy(cfg: SMTConfig, module: str) -> str:
    """Per-module saliency reducer: attention modules use the reference's
    default-arg mean_abs (fine_tune.py:306-313) unless no_limit_mixture
    merges the budgets. Shared by the warm-up harvest and the
    per_step_stats finalisation so they never disagree."""
    return (cfg.calculate_strategy
            if (module not in ATTN_TARGETS or cfg.no_limit_mixture)
            else ATTENTION_CALCULATE_STRATEGY)


# every per-layer matmul that is frozen (or mostly frozen) after conversion
LAYER_LINEARS = ATTN_TARGETS + ("o_proj",) + MLP_TARGETS


def resolve_frozen_quant(cfg: SMTConfig, mode: str, scan: bool = False) -> str:
    """The frozen base of the sparse phase: "int8" only on request. Channel
    mode takes it only over the scan state (scan=True), where
    smt_channel_linear_dyn corrects the selected columns exactly; the
    per-layer channel forward computes through the scatter-updated dense
    weight. "auto" is "none": whether int8 pays on the card is decided by a
    measurement there (PERF.md), not assumed."""
    if mode not in ("matrix", "channel") or (mode == "channel" and not scan):
        return "none"
    return "none" if cfg.frozen_quant == "auto" else cfg.frozen_quant


def resolve_head_quant(cfg: SMTConfig, model_cfg, frozen_quant: str) -> str:
    """head_quant="auto": an int8 lm-head for the sparse-phase loss iff the
    frozen base is int8. Both loss paths consume it, so the resolve does not
    depend on the loss policy (model_cfg is kept for the JAX signature)."""
    del model_cfg
    if cfg.head_quant != "auto":
        return cfg.head_quant
    return "int8" if frozen_quant == "int8" else "none"


@torch.no_grad()
def build_q_head(params, model_cfg) -> Dict:
    """Quantize the (frozen) lm-head weight once: {"wq" int8 (V, D), "sw"
    fp32 (V,)}. Tied models quantize the embedding matrix (the embedding
    LOOKUP keeps reading the unquantized copy)."""
    wq, sw = quantize_weight(lm_head_weight(params, model_cfg).detach())
    return {"wq": wq, "sw": sw}


@torch.no_grad()
def build_qweights(layer_params, plan: SMTPlan) -> Dict:
    """Quantize every frozen layer linear once: {'{layer}.{module}':
    {"wq" int8 (O, I), "sw" fp32 (O,)[, "base" fp32 (n, 256, 256)]}}.

    "base" (planned linears only) holds the dequantized frozen values of
    the selected blocks, so the sparse linear can apply the exact
    correction delta = blocks - base (ops/sparse_linear.py)."""
    q: Dict = {}
    for li, layer in layer_params.items():
        for mod in LAYER_LINEARS:
            w = layer.get(mod)
            if w is None or w.dim() != 2:
                continue
            ks = f"{li}.{mod}"
            wq, sw = quantize_weight(w.detach())
            entry = {"wq": wq, "sw": sw}
            lp = plan.linears.get(ks)
            if lp is not None and plan.mode == "matrix":
                rb, cb = plan.block_index(ks, w.device)
                wq4 = wq.reshape(lp.out_dim // 256, 256, lp.in_dim // 256, 256)
                sw_rows = sw.reshape(lp.out_dim // 256, 256)[rb]  # (n, 256)
                entry["base"] = (wq4[rb, :, cb, :].float() * sw_rows[:, :, None]).contiguous()
            q[ks] = entry
    return q


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t)


def _split_stats(flat_stats: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """'{layer}.{module}' -> {(module, layer): stat}, split attn / mlp."""
    attn, mlp = {}, {}
    for ks, s in flat_stats.items():
        module, layer = parse_key(ks)
        (attn if module in ATTN_TARGETS else mlp)[(module, layer)] = s
    return attn, mlp


def compute_matrix_selection(cfg: SMTConfig, acc: Dict[str, torch.Tensor],
                             all_2d_shapes) -> Dict:
    """acc: grad-sum (or per-step-stat) accumulators keyed '{layer}.{module}'."""
    total_blocks = count_total_blocks(all_2d_shapes)
    n_attn = num_selected_blocks(cfg.downsample_attention_blocks_ratio, total_blocks)
    n_mlp = num_selected_blocks(cfg.downsample_mlp_blocks_ratio, total_blocks)

    def stats_of(strategy):
        if cfg.saliency_accumulation == "per_step_stats":
            return {ks: _to_numpy(block_stats_final(
                        g, harvest_strategy(cfg, parse_key(ks)[0])))
                    for ks, g in acc.items()}
        return {ks: _to_numpy(block_stats(g, strategy)) for ks, g in acc.items()}

    if cfg.no_limit_mixture:
        stats = stats_of(cfg.calculate_strategy)
        merged = {parse_key(ks): s for ks, s in stats.items()}
        return select_submatrices(merged, n_attn + n_mlp, cfg.selection_strategy)

    selected: Dict = {}
    if n_attn > 0:
        attn_stats, _ = _split_stats(stats_of(ATTENTION_CALCULATE_STRATEGY))
        selected.update(select_submatrices(attn_stats, n_attn, cfg.selection_strategy))
    if n_mlp > 0:
        _, mlp_stats = _split_stats(stats_of(cfg.calculate_strategy))
        selected.update(select_submatrices(mlp_stats, n_mlp, cfg.selection_strategy))
    return selected


def compute_channel_selection(cfg: SMTConfig, act_acc: Dict[str, torch.Tensor]) -> Dict:
    """act_acc: (S, C) positional |activation| sums, or (C,) per-step
    stats (already reduced with the per-module strategy), keyed
    '{layer}.{module}'."""
    def stats_of(strategy):
        if cfg.saliency_accumulation == "per_step_stats":
            return {ks: _to_numpy(a) for ks, a in act_acc.items()}
        return {ks: _to_numpy(channel_stats(a, strategy)) for ks, a in act_acc.items()}

    if cfg.no_limit_mixture:
        merged = {parse_key(ks): s for ks, s in stats_of(cfg.calculate_strategy).items()}
        return select_channels(merged, cfg.num_attention_channel + cfg.num_mlp_channel,
                               cfg.selection_strategy)

    selected: Dict = {}
    if cfg.num_attention_channel > 0:
        attn_stats, _ = _split_stats(stats_of(ATTENTION_CALCULATE_STRATEGY))
        selected.update(select_channels(attn_stats, cfg.num_attention_channel,
                                        cfg.selection_strategy))
    if cfg.num_mlp_channel > 0:
        _, mlp_stats = _split_stats(stats_of(cfg.calculate_strategy))
        selected.update(select_channels(mlp_stats, cfg.num_mlp_channel,
                                        cfg.selection_strategy))
    return selected


def build_plan(cfg: SMTConfig, warmup_state: Dict, all_2d_shapes) -> SMTPlan:
    master = warmup_state["master"]
    dims = {}
    for li, layer in master["layers"].items():
        for mod in ATTN_TARGETS + MLP_TARGETS:
            dims[(mod, int(li))] = tuple(layer[mod].shape)
    if cfg.matrix_sparsity:
        selected = compute_matrix_selection(cfg, warmup_state["acc"], all_2d_shapes)
        return SMTPlan.from_selection("matrix", selected, dims)
    selected = compute_channel_selection(cfg, warmup_state["act_acc"])
    return SMTPlan.from_selection("channel", selected, dims)


def convert(cfg: SMTConfig, warmup_state: Dict, all_2d_shapes, model_cfg=None,
            scan: bool = False) -> Tuple[SMTPlan, Dict, Optional[Dict]]:
    """Run selection and build the phase-2 state from it
    (sparse_state_from_plan). Returns (plan, state, host_frozen). The caller
    drops the warm-up state (master, moments, accumulators), as the
    reference deletes its optimizer and grad dicts (fine_tune.py:352-358)."""
    plan = build_plan(cfg, warmup_state, all_2d_shapes)
    if not plan.linears:
        raise ValueError(
            "SMT selection produced zero trainable blocks/channels — the downsample "
            "ratios are too small for this model's block count (the "
            "denominator counts ALL 2-D params, fine_tune.py:231-241).")
    return (plan,) + sparse_state_from_plan(cfg, warmup_state, plan, model_cfg, scan)


def sparse_state_from_plan(cfg: SMTConfig, warmup_state: Dict, plan: SMTPlan, model_cfg=None,
                           scan: bool = False) -> Tuple[Dict, Optional[Dict]]:
    """The phase-2 state of `plan` from the warm-up's fp32 master, and its
    host store: (state, host_frozen), host_frozen None unless the frozen
    weights moved to the host.

    scan=True: the stacked scan state (scan_phase.build_scan_sparse_state,
    which needs model_cfg). Otherwise the per-layer state: dense weights in
    the param dtype (new tensors) and fp32 trainable blocks (or columns)
    gathered from the fp32 master; with an int8 frozen base (matrix mode)
    also state["q"], with an int8 head (needs model_cfg) state["q_head"],
    and with the host offload (frozen_offload_active) the quantized dense
    weights in host_frozen (offload_frozen_to_host)."""
    from sparse_matrix_tuning_tpu_torch.train.steps import init_sparse_state

    if scan:
        from sparse_matrix_tuning_tpu_torch.train.scan_phase import build_scan_sparse_state
        return build_scan_sparse_state(cfg, warmup_state, plan, model_cfg)
    master = warmup_state["master"]
    with torch.no_grad():
        params = tree_map(lambda p: p.detach().to(cfg.param_dtype, copy=True), master)
        trainable = plan.gather(master["layers"], dtype=torch.float32)
    state = init_sparse_state(params, trainable, step=int(warmup_state["step"]), cfg=cfg)
    fq = resolve_frozen_quant(cfg, plan.mode)
    if fq == "int8":
        # quantize from the fp32 master (best rounding); wq/sw/base are
        # frozen constants that ride along in the state
        state["q"] = build_qweights(master["layers"], plan)
    # NOT nested under fq == "int8": an explicit --head_quant int8 works
    # over a bf16 frozen base too (the head path is independent)
    if model_cfg is not None and resolve_head_quant(cfg, model_cfg, fq) == "int8":
        state["q_head"] = build_q_head(master, model_cfg)
    if frozen_offload_active(cfg, plan.mode):
        return offload_frozen_to_host(state)
    return state, None


def frozen_offload_active(cfg: SMTConfig, mode: str, scan: bool = False) -> bool:
    """int8 frozen base: the dense layer weights are dead in sparse-phase
    compute (planned linears run through wq/sw/base with the exact block
    or column correction, frozen ones through wq/sw), so they move to HOST
    memory and the device holds only the int8 copy. scan: the layout whose
    base is resolved (channel mode takes int8 only over the scan state)."""
    return (bool(cfg.frozen_host_offload)
            and resolve_frozen_quant(cfg, mode, scan=scan) == "int8")


def _placeholder(w: torch.Tensor) -> torch.Tensor:
    # 1 element keeps the param tree's structure and the model's lp[name] access
    return torch.zeros((1,), dtype=w.dtype, device=w.device)


def offload_lm_head(params: Dict, host: Dict) -> Dict:
    """Move the compute-dead untied lm_head into `host` under the key
    "lm_head", returning a params dict with a 1-element placeholder. Only
    meaningful with an int8 head (q_head carries the compute); a no-op for
    tied models (embed_tokens stays for the embedding lookup) or when
    already offloaded. trainer._merged_from_host reads the host key."""
    head = params.get("lm_head")
    if head is None or head.dim() != 2:
        return params
    params = dict(params)
    host["lm_head"] = head.detach().to("cpu")
    params["lm_head"] = _placeholder(head)
    return params


def offload_frozen_to_host(state: Dict) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """Move every quantized dense layer weight (the keys of state["q"]) to
    host tensors, leaving a 1-element placeholder on the device so the
    param tree keeps its structure. Returns (new_state, host_store).

    The sparse step then skips the per-step block scatter (plan.scatter
    passes over placeholders) and the HF export rebuilds the dense weights
    on the host (trainer.merged_params): 2 bytes per parameter of device
    memory freed."""
    host: Dict[str, torch.Tensor] = {}
    new_layers = {k: dict(v) for k, v in state["params"]["layers"].items()}
    for ks in state["q"]:
        li, mod = ks.split(".", 1)
        w = new_layers[li][mod]
        host[ks] = w.detach().to("cpu")
        new_layers[li][mod] = _placeholder(w)
    new_params = dict(state["params"])
    new_params["layers"] = new_layers
    if "q_head" in state:
        # int8 head: the untied lm_head is compute-dead too, both loss
        # paths read q_head
        new_params = offload_lm_head(new_params, host)
    new_state = dict(state)
    new_state["params"] = new_params
    return new_state, host
