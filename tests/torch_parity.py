"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once with numpy from a seed and handed to both packages:
the JAX function (on the CPU; Pallas kernels in interpret mode, as the JAX
suite runs them) and its twin in `sparse_matrix_tuning_tpu_torch`. Values
cross between the frameworks only as numpy arrays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.models.from_jax import params_from_jax

# the tier-1 suite runs many pytest workers; one intra-op thread each
torch.set_num_threads(1)

JAX_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def seeded_normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def rows_scaled_normal(shape, seed: int) -> np.ndarray:
    """Normal values whose rows (over the last dim) are scaled by factors
    log-uniform in 0.01 .. 10: scales of every magnitude, so that the last
    bit of amax / 127 and of amax * fp32(1/127) part on some rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    f = np.exp(rng.uniform(np.log(0.01), np.log(10.0), (*shape[:-1], 1)))
    return (x * f.astype(np.float32)).astype(np.float32)


def to_jax(a: np.ndarray, dtype: str = "fp32"):
    return jnp.asarray(a, JAX_DTYPES[dtype])


def to_torch(a: np.ndarray, dtype: str = "fp32") -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DTYPES[dtype])


def np32(x) -> np.ndarray:
    """JAX array or torch tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jax_params, dtype=None):
    """JAX param tree -> the port's param dict (same values)."""
    return params_from_jax(numpy_tree(jax_params), dtype=dtype)


def assert_close(got, want, rtol: float, atol: float):
    np.testing.assert_allclose(np32(got), np32(want), rtol=rtol, atol=atol)


def assert_trees_equal(port_tree, jax_tree):
    """Bitwise equality of a port param dict and a JAX param tree."""
    assert set(port_tree) == set(jax_tree), (sorted(port_tree), sorted(jax_tree))
    for k, v in port_tree.items():
        if isinstance(v, dict):
            assert_trees_equal(v, jax_tree[k])
        else:
            np.testing.assert_array_equal(np32(v), np32(jax_tree[k]), err_msg=k)


def lm_batches(n, bsz=4, seq=32, vocab=256, seed=0, pad_from=None):
    """Token batches of tests/test_train_e2e.py's learnable pattern, with
    optional right padding from position `pad_from` in the last row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab, (bsz, seq)).astype(np.int32)
        ids[:, ::2] = 7
        labels = ids.copy()
        labels[:, : seq // 4] = -100
        mask = np.ones((bsz, seq), np.int32)
        if pad_from is not None:
            mask[-1, pad_from:] = 0
            labels[-1, pad_from:] = -100
            ids[-1, pad_from:] = 0
        out.append({"input_ids": ids, "labels": labels, "attention_mask": mask})
    return out
