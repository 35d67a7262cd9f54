"""Profile one warm-up and one sparse training step on a CUDA device.

    python -m sparse_matrix_tuning_tpu_torch.utils.profile_steps

TinyLlama-1.1B geometry (random weights from a seed, synthetic batches,
bs 4 x seq 512, bf16, remat, attention "auto": the K3 kernels on the
card), the trainer's own steps: each phase's step is timed three times
unprofiled (median), then once under torch.profiler, which gives the
device's busy time (summed kernel time), its idle share, and the ops and
kernels with the most device time.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType

BS, SEQ, TOP = 4, 512, 25
TIMED = 3  # unprofiled steps per phase, before the profiled one
FULL_FT_STEPS = 2 + TIMED + 1


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile_step(trainer, batches, label):
    """Time batches[:-1] unprofiled, then profile batches[-1]."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for b in batches[:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(trainer.train_step(b)["loss"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] {label}: wall {statistics.median(walls):.1f} ms median of "
          f"{[round(w, 1) for w in walls]} (not profiled)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.train_step(batches[-1])["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernel rows carry the device time; op rows repeat it as the time of
    # the kernels they launched, so each is summed on its own
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms in {sum(e.count for e in kernels)} kernels, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for kind, rows in (("op", ops), ("kernel", kernels)):
        for e in sorted(rows, key=_device_us, reverse=True)[:TOP]:
            print(f"[profile] {label} {kind:6s} {_device_us(e) / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:100]}", flush=True)


def main():
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import (
        LlamaConfig, init_params, resolve_attn_impl)
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    if not torch.cuda.is_available():
        raise RuntimeError("profile_steps needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model_cfg = LlamaConfig()  # TinyLlama-1.1B geometry
    cfg = SMTConfig(data_path=["synthetic"], model_name_or_path="random-init",
                    dtype="bf16", matrix_sparsity=True, full_ft_steps=FULL_FT_STEPS,
                    downsample_attention_blocks_ratio=0.0084,
                    downsample_mlp_blocks_ratio=0.0084, ft_learning_rate=9.865e-6,
                    smt_lr=9.865e-6, calculate_strategy="abs_mean",
                    per_device_ft_batch_size=BS, max_seq_len=SEQ, seq_buckets=[SEQ],
                    seed=1234)
    rng = np.random.default_rng(0)

    def batch():
        ids = rng.integers(3, model_cfg.vocab_size, (BS, SEQ)).astype(np.int32)
        labels = ids.copy()
        labels[:, : SEQ // 8] = -100
        return {"input_ids": ids, "labels": labels, "attention_mask": np.ones_like(ids)}

    device = torch.device("cuda")
    trainer = SMTTrainer(cfg, model_cfg,
                         init_params(model_cfg, seed=0, dtype=torch.bfloat16, device=device),
                         total_steps=100, device=device)
    attn = resolve_attn_impl(cfg.attn_impl, model_cfg.head_dim, device)
    print(f"[profile] {torch.cuda.get_device_name(0)}, TinyLlama-1.1B geometry, "
          f"bs {BS} x seq {SEQ}, bf16, remat, attention {attn}", flush=True)
    for _ in range(FULL_FT_STEPS - TIMED - 1):
        trainer.train_step(batch())
    _profile_step(trainer, [batch() for _ in range(TIMED + 1)], "warmup_step")
    for _ in range(2):  # conversion + the first sparse step, then another
        trainer.train_step(batch())
    if trainer.phase != "sparse":
        raise RuntimeError("the trainer did not convert")
    _profile_step(trainer, [batch() for _ in range(TIMED + 1)], "sparse_step")


if __name__ == "__main__":
    main()
