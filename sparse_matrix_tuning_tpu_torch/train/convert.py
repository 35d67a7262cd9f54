"""The SMT conversion event: saliency stats -> selection -> SMTPlan ->
sparse train state (matrix mode; PyTorch twin of
`sparse_matrix_tuning_tpu.train.convert`).

Stats are reduced on the device from the accumulators and copied to the
host as tiny (R/256, C/256) numpy matrices; selection (smt/select.py) is
numpy with the reference's total-order tie-break, so the plan — and its
fingerprint — equals the JAX package's on equal stats.

Quirk preserved: the reference omits calculate_strategy when selecting
ATTENTION blocks, so attention always uses "mean_abs" while MLP uses the
configured strategy (fine_tune.py:306-313 vs :319-327).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import ATTN_TARGETS, MLP_TARGETS, tree_map
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan, parse_key
from sparse_matrix_tuning_tpu_torch.smt.select import (
    block_stats, block_stats_final, count_total_blocks, num_selected_blocks,
    select_submatrices,
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


def build_plan(cfg: SMTConfig, warmup_state: Dict, all_2d_shapes) -> SMTPlan:
    if not cfg.matrix_sparsity:
        raise NotImplementedError("only matrix-mode selection is ported")
    master = warmup_state["master"]
    dims = {}
    for li, layer in master["layers"].items():
        for mod in ATTN_TARGETS + MLP_TARGETS:
            dims[(mod, int(li))] = tuple(layer[mod].shape)
    selected = compute_matrix_selection(cfg, warmup_state["acc"], all_2d_shapes)
    return SMTPlan.from_selection("matrix", selected, dims)


def convert(cfg: SMTConfig, warmup_state: Dict, all_2d_shapes) -> Tuple[SMTPlan, Dict]:
    """Run selection and build the phase-2 state: dense weights in the
    param dtype (new tensors) and fp32 trainable blocks gathered from the
    fp32 master. The caller drops the warm-up state (master, moments,
    accumulators), as the reference deletes its optimizer and grad dicts
    (fine_tune.py:352-358)."""
    from sparse_matrix_tuning_tpu_torch.train.steps import init_sparse_state

    plan = build_plan(cfg, warmup_state, all_2d_shapes)
    if not plan.linears:
        raise ValueError(
            "SMT selection produced zero trainable blocks — the downsample "
            "ratios are too small for this model's block count (the "
            "denominator counts ALL 2-D params, fine_tune.py:231-241).")
    master = warmup_state["master"]
    with torch.no_grad():
        params = tree_map(lambda p: p.detach().to(cfg.param_dtype, copy=True), master)
        trainable = plan.gather(master["layers"], dtype=torch.float32)
    state = init_sparse_state(params, trainable, step=int(warmup_state["step"]))
    return plan, state
