"""Adam + param-group LR logic + global-norm clipping (PyTorch twin of
`sparse_matrix_tuning_tpu.smt.optimizer`).

The update is the JAX package's, term for term:
    m = m*b1 + g*(1-b1);  v = v*b2 + g^2*(1-b2)
    p = p - lr * ((m/bc1) / (sqrt(v/bc2) + eps) + wd*p)
which rounds differently from torch.optim.AdamW, so that is not used.
State is updated IN PLACE (the JAX twin returns new trees into donated
buffers); the full-FT warm-up's fp32 state is 3x the model, so no second
copy is ever made.

Param groups (reference deepspeed/smt/smt.py:465-549, :554-638): norms and
biases do not decay; optional q/k LR boost (--qk_scheduler).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch


@dataclass(frozen=True)
class AdamConfig:
    betas: Sequence[float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0   # DS config gradient_clipping: 1.0 (deepspeed_helpers.py:88)


def adam_init(trainable: Mapping[str, torch.Tensor]) -> Dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in trainable.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(iter(zeros.values())).device)}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """Scale every fp32 grad by min(1, max_norm / max(norm, 1e-6)), in
    place; norm: global_norm(grads) when the caller has it already.
    Returns (grads, norm)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def adam_step(
    grads: Mapping[str, torch.Tensor],
    opt_state: Dict,
    params: Mapping[str, torch.Tensor],
    lr: torch.Tensor,
    cfg: AdamConfig,
    lr_scale: Optional[Callable[[str], float]] = None,
    wd_mask: Optional[Callable[[str], bool]] = None,
):
    """One Adam update over flat {key: fp32 param} dicts, in place (the
    port's params here are always the fp32 master copies or blocks).

    opt_state: {"m": {key: t}, "v": {key: t}, "count": int32 0-dim}.
    lr_scale / wd_mask map a flat key path ("a/b/c") to a per-tensor LR
    multiplier / decay eligibility — the param-group mechanism.
    Returns (params, opt_state), the same objects."""
    b1, b2 = cfg.betas
    opt_state["count"].add_(1)
    c = opt_state["count"].float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    for key, p in params.items():
        g = grads[key].float()
        m = opt_state["m"][key]
        v = opt_state["v"][key]
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(torch.square(g) * (1.0 - b2))
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        k_lr = lr * (lr_scale(key) if lr_scale is not None else 1.0)
        wd = cfg.weight_decay if (wd_mask is None or wd_mask(key)) else 0.0
        if wd:
            update = update + wd * p
        p.sub_(k_lr * update)
    return params, opt_state


# ---------------------------------------------------------------------------
# Param-group policies
# ---------------------------------------------------------------------------

# Reference no-decay list is bias/layernorm/norm/ln_f only — embeddings decay.
NO_DECAY_MARKERS = ("norm", "bias")


def full_ft_wd_mask(key: str) -> bool:
    """Decay only matrix weights (biases/norms excluded)."""
    return not any(m in key for m in NO_DECAY_MARKERS)


def make_qk_lr_scale(qk_lr_times: float) -> Callable[[str], float]:
    """q_proj/k_proj trainables get a boosted LR (reference
    get_optimizer_qk_augment_grouped_parameters, smt.py:554-638)."""
    def scale(key: str) -> float:
        return float(qk_lr_times) if ("q_proj" in key or "k_proj" in key) else 1.0
    return scale


# ---------------------------------------------------------------------------
# LR schedules (HF get_scheduler parity: linear / cosine / constant)
# ---------------------------------------------------------------------------

def make_lr_schedule(kind: str, base_lr: float, warmup_steps: int,
                     total_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int or 0-dim tensor) -> fp32 0-dim tensor on the step's device."""
    total_steps = max(int(total_steps), 1)
    warmup_steps = int(warmup_steps)
    if kind not in ("linear", "cosine", "constant"):
        raise ValueError(f"unknown lr scheduler {kind!r}")

    def sched(step):
        step = torch.as_tensor(step).float()
        warm = step / max(1.0, warmup_steps)
        if kind == "linear":
            decay = torch.clamp(
                (total_steps - step) / max(1.0, total_steps - warmup_steps), min=0.0)
        elif kind == "cosine":
            progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
            progress = torch.clamp(progress, 0.0, 1.0)
            decay = 0.5 * (1.0 + torch.cos(math.pi * progress))
        else:
            decay = torch.ones_like(step)
        return base_lr * torch.where(step < warmup_steps,
                                     torch.clamp(warm, max=1.0), decay)

    return sched
