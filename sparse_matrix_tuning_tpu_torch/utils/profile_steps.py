"""Profile one warm-up and one sparse training step, and one prefill and
one decode step of the generation eval, on a CUDA device.

    python -m sparse_matrix_tuning_tpu_torch.utils.profile_steps

TinyLlama-1.1B geometry, random weights from a seed, bf16. Training: the
trainer's own steps on synthetic batches, bs 4 x seq 512, remat, attention
"auto" (the K3 kernels on the card); each phase's step is timed three
times unprofiled (median), then once under torch.profiler, which gives the
device's busy time (summed kernel time), its idle share, and the ops and
kernels with the most device time; one more step runs under
torch.cuda.set_sync_debug_mode("warn"), which counts the host-device
synchronisations it makes. A second trainer over the int8 frozen
base (--frozen_quant int8: K4, K5, int8 head, host offload) gives the same
for its sparse step, with the share of device time in K4, K5 and K1, and
so does the continuation over the int8 scan state (--sparse_from_plan)
from that trainer's weights and plan. A third trainer in channel mode
(--channel_sparsity, 30 attention and 30 MLP channels) gives its warm-up
step (a forward that harvests activations), its sparse step and the
continuation over the int8 scan state from its weights and channel plan.
Decode: eval/generate.generate with the
eval CLI's settings (beam-4, repetition penalty 1.1, bf16 cache, attention
through K7) on 16 prompts left-padded to 256 tokens; a call with one new
token is the prefill (and one beam selection), and a call with 1 +
DECODE_STEPS new tokens adds DECODE_STEPS decode steps, so a decode step is
the difference over DECODE_STEPS (its synchronisations likewise). The
decode is profiled four times: over the dense bf16 weights with a bf16
and with an int8 KV cache, and over the int4 and the int8 frozen base
(the same weights written as an HF checkpoint under build/ and loaded by
the eval CLI's load_decode_params with --frozen_quant int4 / int8: K6 or
K4 on every linear), with the share of device time in K4, K6 and K7.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

BS, SEQ, TOP = 4, 512, 25
TIMED = 3  # unprofiled steps per phase, before the profiled one
EVAL_BATCH, PROMPT = 16, 256  # the eval CLI's batch, the 256-token prompt bucket
DECODE_STEPS = 8
FULL_FT_STEPS = 2 + TIMED + 2


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


def _syncs(fn) -> int:
    """fn() once under torch.cuda.set_sync_debug_mode("warn"): the number of
    operations that synchronised the host with the device (a blocking copy,
    .item(), a host read of a device value), each of which PyTorch reports
    as a warning. The one-time notice that the debug mode is a prototype
    is not counted."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


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
    """Time batches[:-2] unprofiled, profile batches[-2], then count the
    host-device synchronisations of a step on batches[-1]."""
    walls = [_wall_ms(lambda b=b: float(trainer.train_step(b)["loss"])) for b in batches[:-2]]
    print(f"[profile] {label}: wall {statistics.median(walls):.1f} ms median of "
          f"{[round(w, 1) for w in walls]} (not profiled)", flush=True)
    wall_ms, busy_ms, n, kernels, ops = _profiled(
        lambda: float(trainer.train_step(batches[-2])["loss"]))
    n_sync = _syncs(lambda: float(trainer.train_step(batches[-1])["loss"]))
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms in {n} kernels, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; {n_sync} host-device synchronisations "
          "in a step (the loss's .item() included)", flush=True)
    _print_top(label, (("op", ops), ("kernel", kernels)))
    return busy_ms, kernels


def profile_decode(model_cfg, device, frozen_quant: str = "none", cache_dtype: str = "bfloat16"):
    """The decode leg (module docstring), over the dense weights or
    (frozen_quant "int4" / "int8") over a quantized frozen base, with a
    bf16 or (cache_dtype "int8") an int8 KV cache."""
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig, generate
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7

    params = init_params(model_cfg, seed=0, dtype=torch.bfloat16, device=device)
    if frozen_quant != "none":
        from sparse_matrix_tuning_tpu_torch.cli.run_commonsense import load_decode_params
        from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
        build = os.path.join(os.path.dirname(__file__), "..", "..", "build")
        os.makedirs(build, exist_ok=True)
        ckpt = tempfile.mkdtemp(prefix="profile_ckpt_", dir=build)
        try:
            save_hf_format(params, model_cfg, ckpt)
            del params
            params, _ = load_decode_params(ckpt, frozen_quant, "bf16", device)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    rng = np.random.default_rng(1)
    ids = np.zeros((EVAL_BATCH, PROMPT), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(rng.integers(60, PROMPT + 1, EVAL_BATCH)):
        ids[i, PROMPT - n:] = rng.integers(3, model_cfg.vocab_size, n)
        mask[i, PROMPT - n:] = 1

    def run(new_tokens):
        gen = GenerationConfig(max_new_tokens=new_tokens, num_beams=4, repetition_penalty=1.1,
                               cache_dtype=cache_dtype)
        return lambda: generate(params, model_cfg, ids, mask, gen, device=device)

    n = 1 + DECODE_STEPS
    run(n)()  # warm-up
    walls = {m: statistics.median(_wall_ms(run(m)) for _ in range(TIMED)) for m in (1, n)}
    launches0 = dict(k7.LAUNCHES)
    p1 = _profiled(run(1))
    pn = _profiled(run(n))
    k7_launches = sum(k7.LAUNCHES.values()) - sum(launches0.values())
    sync_step = (_syncs(run(n)) - _syncs(run(1))) / DECODE_STEPS
    base = "bf16 weights" if frozen_quant == "none" else f"{frozen_quant} frozen base"
    cache = "bf16" if cache_dtype == "bfloat16" else cache_dtype
    base = f"{base}, {cache} cache"
    print(f"[profile] decode: {torch.cuda.get_device_name(0)}, TinyLlama-1.1B geometry, "
          f"{base}, {EVAL_BATCH} prompts x 4 beams, prompt bucket {PROMPT}, K7", flush=True)
    print(f"[profile] prefill (+ one beam selection): wall {walls[1]:.1f} ms not profiled "
          f"(median of {TIMED}), {p1[0]:.1f} ms profiled; device busy {p1[1]:.2f} ms in "
          f"{p1[2]} kernels, idle share {max(0.0, 1 - p1[1] / p1[0]):.3f}", flush=True)
    step = [(a - b) / DECODE_STEPS for a, b in zip(pn[:3], p1[:3])]
    wall = (walls[n] - walls[1]) / DECODE_STEPS
    print(f"[profile] decode step: wall {wall:.1f} ms not profiled, {step[0]:.1f} ms "
          f"profiled; device busy {step[1]:.2f} ms in {step[2]:.0f} kernels, idle share "
          f"of the unprofiled wall {max(0.0, 1 - step[1] / wall):.3f}; K7 launches over the "
          f"two profiled calls {k7_launches}; {sync_step:.1f} host-device synchronisations "
          "a decode step", flush=True)
    own = {name: (sum(_device_us(e) for e in pn[3] if part in e.key)
                  - sum(_device_us(e) for e in p1[3] if part in e.key)) / 1e3 / DECODE_STEPS
           for name, part in OWN_KERNELS.items() if name.startswith(("K4", "K6", "K7", "row"))}
    print(f"[profile] decode step ({base}): device time in the port's kernels, ms (share of "
          f"{step[1]:.2f} ms busy): " + ", ".join(
              f"{name} {ms:.3f} ({ms / max(step[1], 1e-9):.3f})" for name, ms in own.items()),
          flush=True)
    _print_top(f"generate({n} new tokens, {base})", (("kernel", pn[3]),))


# device kernels of the port's own, by a part of their name
OWN_KERNELS = {"K4 q8_matmul": "q8mm_kernel", "row_quant (K4's prologue)": "row_quant_kernel",
               "K5 block_correction": "correction_",
               "K1 block_grad": "block_grad_", "K2 masked_adam": "masked_adam",
               "K3 attention": "attn_", "K6 q4_matmul": "q4mm_",
               "K7 cached_attention": "cached_attn"}


def profile_training(model_cfg, device, frozen_quant: str, mode: str = "matrix"):
    """Warm-up and sparse step of one trainer (module docstring); the int8
    trainer takes a short warm-up and profiles its sparse step only. The
    int8 trainer and the channel one ("channel" mode) then profile the
    continuation over the int8 scan state from their weights and plan."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params, resolve_attn_impl
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    int8 = frozen_quant == "int8"
    full_ft_steps = 2 if int8 else FULL_FT_STEPS
    cfg = SMTConfig(data_path=["synthetic"], model_name_or_path="random-init",
                    dtype="bf16", matrix_sparsity=mode == "matrix",
                    channel_sparsity=mode == "channel", full_ft_steps=full_ft_steps,
                    downsample_attention_blocks_ratio=0.0084,
                    downsample_mlp_blocks_ratio=0.0084, ft_learning_rate=9.865e-6,
                    smt_lr=9.865e-6, calculate_strategy="abs_mean",
                    per_device_ft_batch_size=BS, max_seq_len=SEQ, seq_buckets=[SEQ],
                    seed=1234, frozen_quant=frozen_quant)
    rng = np.random.default_rng(0)

    def batch():
        ids = rng.integers(3, model_cfg.vocab_size, (BS, SEQ)).astype(np.int32)
        labels = ids.copy()
        labels[:, : SEQ // 8] = -100
        return {"input_ids": ids, "labels": labels, "attention_mask": np.ones_like(ids)}

    trainer = SMTTrainer(cfg, model_cfg,
                         init_params(model_cfg, seed=0, dtype=torch.bfloat16, device=device),
                         total_steps=100, device=device)
    attn = resolve_attn_impl(cfg.attn_impl, model_cfg.head_dim, device)
    print(f"[profile] {torch.cuda.get_device_name(0)}, TinyLlama-1.1B geometry, "
          f"bs {BS} x seq {SEQ}, bf16, remat, attention {attn}, frozen_quant {frozen_quant}, "
          f"{mode} mode", flush=True)
    tag = "int8 " if int8 else "channel " if mode == "channel" else ""
    if int8:
        for _ in range(full_ft_steps):
            trainer.train_step(batch())
    else:
        for _ in range(full_ft_steps - TIMED - 2):  # _profile_step takes the last TIMED + 2
            trainer.train_step(batch())
        _print_own(f"{tag}warmup_step", *_profile_step(
            trainer, [batch() for _ in range(TIMED + 2)], f"{tag}warmup_step"))
    for _ in range(2):  # conversion + the first sparse step, then another
        trainer.train_step(batch())
    if trainer.phase != "sparse":
        raise RuntimeError("the trainer did not convert")
    _print_own(f"{tag}sparse_step",
               *_profile_step(trainer, [batch() for _ in range(TIMED + 2)], f"{tag}sparse_step"))
    if int8 or mode == "channel":
        profile_scan_continuation(trainer, model_cfg, device, batch, f"{tag}scan_sparse_step")


def _print_own(label, busy_ms, kernels):
    own = {name: sum(_device_us(e) for e in kernels if part in e.key) / 1e3
           for name, part in OWN_KERNELS.items()}
    print(f"[profile] {label}: device time in the port's kernels, ms (share of "
          f"{busy_ms:.1f} ms busy): " + ", ".join(
              f"{name} {ms:.2f} ({ms / busy_ms:.3f})" for name, ms in own.items()), flush=True)


def profile_scan_continuation(trainer, model_cfg, device, batch, label):
    """The continuation over the int8 scan state (--frozen_quant int8
    --sparse_from_plan): the trainer's merged weights written as an HF
    checkpoint under build/ with its plan, quantized while loading by
    SMTTrainer.sparse_scan_from_hf, and its sparse step profiled as the
    trainer's was."""
    import dataclasses

    from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    build = os.path.join(os.path.dirname(__file__), "..", "..", "build")
    os.makedirs(build, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="profile_ckpt_", dir=build)
    cfg = dataclasses.replace(trainer.cfg, frozen_quant="int8", head_quant="auto",
                              sparse_from_plan=os.path.join(ckpt, "smt_plan.json"))
    try:
        save_hf_format(trainer.merged_params(), model_cfg, ckpt)
        scan = SMTTrainer.sparse_scan_from_hf(cfg, ckpt, trainer.plan, total_steps=100,
                                              model_cfg=model_cfg, device=device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    scan.train_step(batch())
    _print_own(label, *_profile_step(scan, [batch() for _ in range(TIMED + 2)], label))


def main():
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    if not torch.cuda.is_available():
        raise RuntimeError("profile_steps needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model_cfg = LlamaConfig()  # TinyLlama-1.1B geometry
    device = torch.device("cuda")
    for frozen_quant, mode in (("none", "matrix"), ("int8", "matrix"), ("none", "channel")):
        profile_training(model_cfg, device, frozen_quant, mode)
        torch.cuda.empty_cache()
    for frozen_quant, cache_dtype in (("none", "bfloat16"), ("none", "int8"),
                                      ("int4", "bfloat16"), ("int8", "bfloat16")):
        profile_decode(model_cfg, device, frozen_quant, cache_dtype)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
