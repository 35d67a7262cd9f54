"""Saliency reduction + block/channel selection (the SMT algorithm core).

Pure functions: arrays in, python index structures out. Replicates the
semantics of reference deepspeed/smt/smt_helper.py:

  * four block reducers over the intra-block dims of a grad reshaped to
    (R/B, B, C/B, B) — smt_helper.py:233-251:
        mean_abs : grad.mean(dim=(1,3)).abs()     (mean THEN abs)
        abs_mean : grad.abs().mean(dim=(1,3))     (abs THEN mean)
        L1       : grad.abs().sum(dim=(1,3))
        L2       : sqrt(sum(abs(grad)**2, dim=(1,3)))
  * "no_restriction": one global top-n across all blocks of all tensors,
    implemented in the reference as a min-heap of (value, (key, i, j))
    tuples (smt_helper.py:102-146) — ties therefore break on the lexical
    order of (module_name, layer, row, col), which we reproduce exactly.
  * "norm_dist": top-n per tensor (smt_helper.py:81-100).
  * channel selection from accumulated |activation| stats
    (smt_helper.py:149-230).

Selection runs once, on host, on numpy copies of tiny (R/256, C/256)
stat matrices, with the total-order tie-break below (the plan
fingerprint depends on it, so no torch.topk here). The reducers also
accept torch tensors, so the per-step harvest stays on the device.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

BLOCK = 256

Key = Tuple[str, int]  # (module_name, layer_number) — reference keying


# ---------------------------------------------------------------------------
# Reducers
# ---------------------------------------------------------------------------

def block_stats(grad: np.ndarray, calculate_strategy: str = "mean_abs",
                block: int = BLOCK) -> np.ndarray:
    """Per-256x256-block saliency of a (R, C) grad -> (R/block, C/block).

    Works on numpy arrays or torch tensors (the torch ops mirror np, so
    the warm-up harvest reduces on the device). Reference:
    smt_helper.py:67-78 (reshape) + :233-251 (reducers).
    """
    xp = _namespace(grad)
    r, c = grad.shape
    if r % block or c % block:
        raise ValueError(f"grad shape {grad.shape} not divisible by block {block}")
    g = grad.reshape(r // block, block, c // block, block)
    if calculate_strategy == "mean_abs":
        return xp.abs(g.mean(axis=(1, 3)))
    if calculate_strategy == "abs_mean":
        return xp.abs(g).mean(axis=(1, 3))
    if calculate_strategy == "L1":
        return xp.abs(g).sum(axis=(1, 3))
    if calculate_strategy == "L2":
        return xp.sqrt((xp.abs(g) ** 2).sum(axis=(1, 3)))
    raise ValueError(f"unknown calculate_strategy {calculate_strategy!r}")


def block_stats_step(grad: np.ndarray, calculate_strategy: str = "mean_abs",
                     block: int = BLOCK) -> np.ndarray:
    """Per-step ACCUMULABLE form of block_stats (per_step_stats mode).

    mean_abs is abs-of-mean, and the block mean commutes with summation
    over warm-up steps: sum_t mean(g_t) == mean(sum_t g_t). Accumulating
    the SIGNED block mean here and applying abs once at selection time
    (block_stats_final) therefore reproduces the reference's
    stat-of-summed-grads (smt_helper.py:233-239 over fine_tune.py:716
    grad sums) EXACTLY, at the same (R/256, C/256) accumulator memory.
    The other reducers apply abs inside the per-step stat, which does not
    commute with the step sum — those accumulate the stat itself and stay
    documented approximations of grad_sum.
    """
    if calculate_strategy == "mean_abs":
        r, c = grad.shape
        if r % block or c % block:
            raise ValueError(
                f"grad shape {grad.shape} not divisible by block {block}")
        return grad.reshape(r // block, block, c // block, block).mean(axis=(1, 3))
    return block_stats(grad, calculate_strategy, block)


def block_stats_final(acc: np.ndarray,
                      calculate_strategy: str = "mean_abs") -> np.ndarray:
    """Finalize a block_stats_step accumulator into selection saliency."""
    if calculate_strategy == "mean_abs":
        return _namespace(acc).abs(acc)
    return acc


def channel_stats(act: np.ndarray, calculate_strategy: str = "mean_abs") -> np.ndarray:
    """Per-input-channel saliency of accumulated |activation| (S, C) -> (C,).

    The reference first sums |act| over the batch dim (smt_helper.py:169)
    — our accumulators already hold that sum — then reduces over the
    sequence dim (dim 0) per strategy (smt_helper.py:171-183).
    """
    xp = _namespace(act)
    if calculate_strategy == "mean_abs":
        return xp.abs(act).mean(axis=0)
    if calculate_strategy == "abs_mean":
        return xp.abs(act.mean(axis=0))
    if calculate_strategy == "L1":
        return xp.abs(act).sum(axis=0)
    if calculate_strategy == "L2":
        return xp.sqrt((xp.abs(act) ** 2).sum(axis=0))
    raise ValueError(f"unknown calculate_strategy {calculate_strategy!r}")


def _namespace(x):
    if isinstance(x, np.ndarray):
        return np
    import torch
    return torch


# ---------------------------------------------------------------------------
# Top-k strategies
# ---------------------------------------------------------------------------

def select_submatrices(
    stats: Mapping[Key, np.ndarray],
    n: int,
    selection_strategy: str = "no_restriction",
) -> Dict[Key, List[Tuple[int, int]]]:
    """Pick the top-n 256x256 blocks from per-tensor block-stat matrices.

    stats: {(module, layer): (n_row_blocks, n_col_blocks) saliency}.
    Returns {(module, layer): [(row_block, col_block), ...]} with blocks of
    each tensor listed in descending-saliency order (reference ordering:
    smt_helper.py:131-141).
    """
    stats = {k: np.asarray(v) for k, v in stats.items()}
    if selection_strategy == "norm_dist":
        out: Dict[Key, List[Tuple[int, int]]] = defaultdict(list)
        for key, s in stats.items():
            flat = s.reshape(-1)
            # descending by value; stable flat-index tie-break
            order = np.lexsort((np.arange(flat.size), -flat))[:n]
            ncols = s.shape[1]
            out[key] = [(int(i) // ncols, int(i) % ncols) for i in order]
        return dict(out)

    if selection_strategy != "no_restriction":
        raise ValueError(f"unknown selection_strategy {selection_strategy!r}")

    if not stats or n <= 0:
        return {}
    # Global top-n with the reference's heap total order: descending by
    # (value, key, row, col) lexicographically. Vectorized (a Python loop
    # over every block is minutes of host time at 70B scale): keys are
    # ranked by their Python tuple sort order, then one global lexsort over
    # (value, key_rank, row, col) reproduces the tuple comparison exactly
    # (float32 -> float64 is order-preserving).
    key_rank = {k: r for r, k in enumerate(sorted(stats))}
    vals = np.concatenate([np.asarray(s, np.float64).reshape(-1) for s in stats.values()])
    ranks = np.concatenate([np.full(s.size, key_rank[k], np.int64)
                            for k, s in stats.items()])
    rows = np.concatenate([np.repeat(np.arange(s.shape[0]), s.shape[1])
                           for s in stats.values()])
    cols = np.concatenate([np.tile(np.arange(s.shape[1]), s.shape[0])
                           for s in stats.values()])
    # ascending lexsort by (value, rank, row, col); every tuple is unique,
    # so the reversal is the exact descending order
    order = np.lexsort((cols, rows, ranks, vals))[::-1][:n]
    keys = sorted(stats)
    out = defaultdict(list)
    for idx in order:
        out[keys[ranks[idx]]].append((int(rows[idx]), int(cols[idx])))
    return dict(out)


def select_channels(
    stats: Mapping[Key, np.ndarray],
    n: int,
    selection_strategy: str = "no_restriction",
) -> Dict[Key, List[int]]:
    """Pick top-n input channels from per-tensor per-column saliency vectors.

    Reference smt_helper.py:186-230 (same two strategies, per-column)."""
    stats = {k: np.asarray(v) for k, v in stats.items()}
    if selection_strategy == "norm_dist":
        out: Dict[Key, List[int]] = {}
        for key, s in stats.items():
            order = np.lexsort((np.arange(s.size), -s))[:n]
            out[key] = [int(i) for i in order]
        return out

    if selection_strategy != "no_restriction":
        raise ValueError(f"unknown selection_strategy {selection_strategy!r}")

    if not stats or n <= 0:
        return {}
    # same vectorized global descending (value, key, idx) order as
    # select_submatrices
    key_rank = {k: r for r, k in enumerate(sorted(stats))}
    vals = np.concatenate([np.asarray(s, np.float64).reshape(-1) for s in stats.values()])
    ranks = np.concatenate([np.full(s.size, key_rank[k], np.int64)
                            for k, s in stats.items()])
    idxs = np.concatenate([np.arange(s.size) for s in stats.values()])
    order = np.lexsort((idxs, ranks, vals))[::-1][:n]
    keys = sorted(stats)
    out = defaultdict(list)
    for i in order:
        out[keys[ranks[i]]].append(int(idxs[i]))
    return dict(out)


# ---------------------------------------------------------------------------
# Block-count accounting
# ---------------------------------------------------------------------------

def count_total_blocks(param_shapes: Sequence[Tuple[int, ...]], block: int = BLOCK) -> float:
    """Total 256x256 block count over ALL 2-D params.

    Quirk preserved from reference fine_tune.py:231-241: the denominator for
    the downsample ratios counts every 2-D parameter — including embeddings
    and lm_head, not just the target modules — using float division.
    """
    total = 0.0
    for shape in param_shapes:
        if len(shape) == 2:
            total += shape[0] / block * shape[1] / block
    return total


def num_selected_blocks(ratio: float, total_blocks: float) -> int:
    """int(ratio * total); negative ratios disable (reference flag doc)."""
    if ratio <= 0:
        return 0
    return int(ratio * total_blocks)
