"""Carry JAX-package weights and plans across to the port.

`params_from_jax` takes the JAX parameter tree as numpy arrays (bf16 as
ml_dtypes.bfloat16, e.g. `jax.tree.map(np.asarray, params)`) and returns
the port's param dict with the same layout, so both packages compute the
same thing on the same weights; `cache_from_jax` does the same for a
decode KV cache, `qstate_from_jax` for the int8 frozen base of a
converted state, and `scan_state_from_jax` for the int8 scan state
(train/scan_phase.py). `plan_from_jax` reads an `SMTPlan.to_json()`. None
of them imports jax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan


def tensor_from_numpy(a, device=None, dtype=None) -> torch.Tensor:
    """numpy array (bf16 as ml_dtypes.bfloat16) -> torch tensor (a copy)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree: Mapping[str, Any], device=None, dtype=None) -> Dict[str, Any]:
    """Nested {name: array} tree -> the same nesting of torch tensors."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_jax(v, device=device, dtype=dtype)
        else:
            out[k] = tensor_from_numpy(v, device=device, dtype=dtype)
    return out


def cache_from_jax(cache, device=None) -> Dict[str, Any]:
    """A JAX per-layer KV cache (models.llama.init_cache, as numpy arrays)
    -> the port's: the same {"<i>": {"k", "v"[, "ks", "vs"]}} layout,
    (B, Hkv, S, hd) K/V and (B, Hkv, 1, S) scales, dtypes kept (int8
    included), so both packages can decode from one cache."""
    return params_from_jax(cache, device=device)


def qstate_from_jax(state, device=None) -> Dict[str, Any]:
    """The int8 frozen base of a JAX sparse state (as numpy arrays) -> the
    port's: {"q": {"{layer}.{module}": {"wq" int8, "sw" fp32[, "base"
    fp32]}}, "q_head": {"wq", "sw"}}, whichever of the two keys the state
    has, dtypes kept (params_from_jax with a dtype would cast the int8)."""
    return {k: params_from_jax(state[k], device=device) for k in ("q", "q_head") if k in state}


def scan_state_from_jax(state, device=None) -> Dict[str, Any]:
    """A JAX int8 scan state (train/scan_phase.py, as numpy arrays) -> the
    port's: its "params", "q", "q_head", "trainable", "base", "idx", Adam
    moments "m" / "v" and counters "count" / "step", leaf for leaf, dtypes
    kept (int8, int32 and bool included), so both packages train and decode
    from one state (training also needs the port's "sched":
    train/scan_phase.attach_schedules). Either mode: matrix blocks (L, n,
    256, 256) with "rb" / "cb", or channel columns (L, O, n) with "ci"."""
    out = {k: params_from_jax(state[k], device=device)
           for k in ("params", "q", "q_head", "trainable", "base", "idx", "m", "v")
           if k in state}
    out.update({k: tensor_from_numpy(state[k], device=device)
                for k in ("count", "step") if k in state})
    return out


def plan_from_jax(plan) -> SMTPlan:
    """A JAX `SMTPlan` (or its `to_json()` text), matrix or channel mode ->
    the port's SMTPlan."""
    text = plan if isinstance(plan, str) else plan.to_json()
    return SMTPlan.from_json(text)
