"""Profile one warm-up and one sparse training step, and one prefill and
one decode step of the generation eval, on a CUDA device.

    python -m sparse_matrix_tuning_tpu_torch.utils.profile_steps

TinyLlama-1.1B geometry, random weights from a seed, bf16. Training: the
trainer's own steps on synthetic batches, bs 4 x seq 512, remat, attention
"auto" (the K3 kernels on the card); each phase's step is timed three
times unprofiled (median), then once under torch.profiler, which gives the
device's busy time (summed kernel time), its idle share, and the ops and
kernels with the most device time. Decode: eval/generate.generate with the
eval CLI's settings (beam-4, repetition penalty 1.1, bf16 cache, attention
through K7) on 16 prompts left-padded to 256 tokens; a call with one new
token is the prefill (and one beam selection), and a call with 1 +
DECODE_STEPS new tokens adds DECODE_STEPS decode steps, so a decode step is
the difference over DECODE_STEPS.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType

BS, SEQ, TOP = 4, 512, 25
TIMED = 3  # unprofiled steps per phase, before the profiled one
EVAL_BATCH, PROMPT = 16, 256  # the eval CLI's batch, the 256-token prompt bucket
DECODE_STEPS = 8
FULL_FT_STEPS = 2 + TIMED + 1


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profiled(fn):
    """fn() once under torch.profiler: (wall ms, device busy ms, kernel
    launches, kernel rows, op rows). Kernel rows carry the device time; op
    rows repeat it as the time of the kernels they launched, so each is
    summed on its own."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = _wall_ms(fn)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    return wall_ms, busy_ms, sum(e.count for e in kernels), kernels, ops


def _print_top(label, rows_by_kind):
    for kind, rows in rows_by_kind:
        for e in sorted(rows, key=_device_us, reverse=True)[:TOP]:
            print(f"[profile] {label} {kind:6s} {_device_us(e) / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:100]}", flush=True)


def _profile_step(trainer, batches, label):
    """Time batches[:-1] unprofiled, then profile batches[-1]."""
    walls = [_wall_ms(lambda b=b: float(trainer.train_step(b)["loss"])) for b in batches[:-1]]
    print(f"[profile] {label}: wall {statistics.median(walls):.1f} ms median of "
          f"{[round(w, 1) for w in walls]} (not profiled)", flush=True)
    wall_ms, busy_ms, n, kernels, ops = _profiled(
        lambda: float(trainer.train_step(batches[-1])["loss"]))
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms in {n} kernels, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    _print_top(label, (("op", ops), ("kernel", kernels)))


def profile_decode(model_cfg, device):
    """The decode leg (module docstring)."""
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig, generate
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7

    params = init_params(model_cfg, seed=0, dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(1)
    ids = np.zeros((EVAL_BATCH, PROMPT), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(rng.integers(60, PROMPT + 1, EVAL_BATCH)):
        ids[i, PROMPT - n:] = rng.integers(3, model_cfg.vocab_size, n)
        mask[i, PROMPT - n:] = 1

    def run(new_tokens):
        gen = GenerationConfig(max_new_tokens=new_tokens, num_beams=4, repetition_penalty=1.1)
        return lambda: generate(params, model_cfg, ids, mask, gen, device=device)

    n = 1 + DECODE_STEPS
    run(n)()  # warm-up
    walls = {m: statistics.median(_wall_ms(run(m)) for _ in range(TIMED)) for m in (1, n)}
    launches0 = dict(k7.LAUNCHES)
    p1 = _profiled(run(1))
    pn = _profiled(run(n))
    k7_launches = k7.LAUNCHES["cached_attn"] - launches0["cached_attn"]
    print(f"[profile] decode: {torch.cuda.get_device_name(0)}, TinyLlama-1.1B geometry, "
          f"{EVAL_BATCH} prompts x 4 beams, prompt bucket {PROMPT}, bf16 cache, K7", flush=True)
    print(f"[profile] prefill (+ one beam selection): wall {walls[1]:.1f} ms not profiled "
          f"(median of {TIMED}), {p1[0]:.1f} ms profiled; device busy {p1[1]:.2f} ms in "
          f"{p1[2]} kernels, idle share {max(0.0, 1 - p1[1] / p1[0]):.3f}", flush=True)
    step = [(a - b) / DECODE_STEPS for a, b in zip(pn[:3], p1[:3])]
    wall = (walls[n] - walls[1]) / DECODE_STEPS
    print(f"[profile] decode step: wall {wall:.1f} ms not profiled, {step[0]:.1f} ms "
          f"profiled; device busy {step[1]:.2f} ms in {step[2]:.0f} kernels, idle share "
          f"of the unprofiled wall {max(0.0, 1 - step[1] / wall):.3f}; K7 launches over the "
          f"two profiled calls {k7_launches}", flush=True)
    _print_top(f"generate({n} new tokens)", (("kernel", pn[3]),))


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
    del trainer
    torch.cuda.empty_cache()
    profile_decode(model_cfg, device)


if __name__ == "__main__":
    main()
