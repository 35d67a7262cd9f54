"""The port stands alone: importing every module of
sparse_matrix_tuning_tpu_torch pulls in neither jax nor the JAX package,
and an explicit request for the CUDA kernels on CPU tensors raises instead
of running the plain versions."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
from sparse_matrix_tuning_tpu_torch.ops import sparse_linear
from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7
from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sparse_matrix_tuning_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "sparse_matrix_tuning_tpu" or m.startswith("sparse_matrix_tuning_tpu."))
print(len(names), bad)
need = {pkg.__name__ + m for m in (".ops.quant", ".ops.loss", ".ops.cuda.q8_matmul",
                                   ".ops.cuda.correction", ".ops.cuda.q4_matmul",
                                   ".train.scan_phase", ".train.checkpoint")}
sys.exit(1 if bad or len(names) < 20 or not need <= set(names) else 0)
"""


def test_importing_every_module_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_explicit_kernel_on_cpu_raises_without_running_plain(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("the plain version must not run")

    monkeypatch.setattr(sparse_linear, "_block_grad_weight_plain", forbidden)
    monkeypatch.setattr(k1, "block_grad_plain", forbidden)
    lp = LinearPlan("q_proj", 0, 256, 256, blocks=((0, 0),))
    w = torch.zeros(256, 256)
    blocks = torch.zeros(1, 256, 256, requires_grad=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sparse_linear.smt_linear(torch.zeros(2, 256), blocks, w, lp, impl="kernel")
    plan = SMTPlan("matrix", {"0.q_proj": lp})
    linear = sparse_linear.make_sparse_linear_dispatch(plan, {"0.q_proj": blocks}, "kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        linear(torch.zeros(2, 256), w, "q_proj", 0)
    assert not any(k1.LAUNCHES.values())


def test_sparse_step_with_kernel_impl_on_cpu_raises(monkeypatch):
    """sparse_impl="kernel" on a CPU trainer fails at the first sparse step,
    before any optimizer update (neither K2's plain version nor adam_step)."""
    def forbidden(*a, **k):
        raise AssertionError("no fallback may run")

    monkeypatch.setattr(k2, "masked_adam_plain", forbidden)
    cfg_m = LlamaConfig.tiny(vocab_size=256)
    cfg = SMTConfig(data_path=["x"], model_name_or_path="m", dtype="fp32",
                    matrix_sparsity=True, full_ft_steps=1, sparse_impl="kernel",
                    downsample_attention_blocks_ratio=0.05,
                    downsample_mlp_blocks_ratio=0.05, gradient_checkpointing=False)
    trainer = SMTTrainer(cfg, cfg_m, init_params(cfg_m, seed=0), total_steps=3)
    batches = tp.lm_batches(2)
    assert np.isfinite(float(trainer.train_step(batches[0])["loss"]))  # warm-up
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trainer.train_step(batches[1])
    assert int(trainer.state["count"]) == 0


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((4, 256), device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.block_grad(meta, meta, idx, idx)
    blk = torch.empty((1, 256, 256), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k2.masked_adam(blk, blk, blk, blk, torch.empty(7, device="meta"))
    q = torch.empty((2, 1, 8, 64), device="meta")
    cache = torch.empty((2, 4, 16, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k7.cached_attention(q, {"k": cache, "v": cache},
                            torch.ones((2, 16), dtype=torch.int32, device="meta"), 3)
    assert k7.LAUNCHES == {"cached_attn": 0, "cached_attn_q8": 0, "cached_attn_combine": 0}


def test_int8_path_on_cpu_launches_no_row_quant_kernel():
    """The int8 base's row quantization (K4's prologue) runs its plain
    version on CPU tensors: forward, grad_input and the q8 loss launch
    nothing."""
    from sparse_matrix_tuning_tpu_torch.ops import quant
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
    from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq
    from sparse_matrix_tuning_tpu_torch.ops.loss import chunked_causal_lm_loss_q8

    wq, sw = quant.quantize_weight(torch.randn(48, 32))
    x = torch.randn(6, 32, dtype=torch.bfloat16)
    assert quant.q8_matmul_t(x, wq, sw).shape == (6, 48)
    assert quant.q8_matmul(torch.randn(6, 48), wq, sw).shape == (6, 32)
    hidden = torch.randn(2, 5, 32, requires_grad=True)
    labels = torch.randint(0, 48, (2, 5))
    chunked_causal_lm_loss_q8(hidden, wq, sw, labels, vocab_chunk=16).backward()
    assert not any(rq.LAUNCHES.values()) and not any(k4.LAUNCHES.values())
