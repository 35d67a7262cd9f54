"""Carry JAX-package weights and plans across to the port.

`params_from_jax` takes the JAX parameter tree as numpy arrays (bf16 as
ml_dtypes.bfloat16, e.g. `jax.tree.map(np.asarray, params)`) and returns
the port's param dict with the same layout, so both packages compute the
same thing on the same weights; `cache_from_jax` does the same for a
decode KV cache. `plan_from_jax` reads an `SMTPlan.to_json()`. None of
them imports jax.
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


def plan_from_jax(plan) -> SMTPlan:
    """A JAX `SMTPlan` (or its `to_json()` text) -> the port's SMTPlan."""
    text = plan if isinstance(plan, str) else plan.to_json()
    return SMTPlan.from_json(text)
