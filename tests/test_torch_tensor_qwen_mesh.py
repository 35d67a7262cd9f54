"""A tiny tied model with q/k/v biases (tests/test_torch_tensor_qwen.py's)
at (1, 2, 2), its ranks as threads, against the JAX package's SMTTrainer
on the same mesh over conftest's virtual CPU devices (GSPMD: the biases
P(), the embedding P("fsdp", "tensor"), no lm_head leaf): matrix mode
over the dense base per layer, and channel mode over the int8 base and
head on the scan state.
"""
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from test_torch_fsdp_scan import JAX_RTOL_INT8, jax_mesh
from test_torch_parallel import JAX_RTOL, N, batches
from test_torch_tensor import _on_threads
from test_torch_tensor_qwen import _case_cfg, _id, _jax_params, _spec, qwen_files  # noqa: F401

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer

CASES = [((1, 2, 2), "matrix", "dense", "layer", False),
         ((1, 2, 2), "channel", "int8", "scan", False)]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_tied_biased_ranks_match_jax_mesh(case, qwen_files, monkeypatch):
    """Rank 0's losses every step and its eval loss within 1e-4 (over the
    int8 base and head 1e-3) of JAX's SMTTrainer on the same mesh, with
    the same plan fingerprint; every rank reports the same."""
    shape, mode, base, layout, dropout = case
    spec = _spec(case, qwen_files)
    got = _on_threads(shape, monkeypatch, lambda mesh: ranks.run_scenario(spec, mesh))
    jcfg, jparams = _jax_params()
    with jax_mesh(shape) as mesh:
        jt = JaxSMTTrainer(JaxSMTConfig(**_case_cfg(mode, base, layout, dropout)), jcfg,
                           jparams, total_steps=N, mesh=mesh)
        losses = [float(jt.train_step(b)["loss"]) for b in batches(N)]
        eval_loss = jt.evaluate(torch.load(qwen_files / "eval.pt", weights_only=False))[1]
        fingerprint = jt.plan.fingerprint()
    r0 = got[0]
    for r in got[1:]:
        assert r["metrics"] == r0["metrics"] and r["eval_loss"] == r0["eval_loss"]
    rtol = JAX_RTOL_INT8 if base == "int8" else JAX_RTOL
    assert r0["fingerprint"] == fingerprint and r0["scan"] == (layout == "scan")
    np.testing.assert_allclose([m["loss"] for m in r0["metrics"]], losses, rtol=rtol, atol=0)
    np.testing.assert_allclose(r0["eval_loss"], eval_loss, rtol=rtol)
