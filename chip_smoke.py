#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sparse_matrix_tuning_tpu_torch) on
one CUDA GPU (written for an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build the CUDA kernels (csrc/*.cu) with nvcc for sm_90a, timed;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (the two widest TinyLlama linears), with its time beside the
     plain version's and a library path's;
  4. a small-input reference: a tiny fp32 two-phase run on the GPU (CUDA
     kernels) against the same run on the CPU (plain versions);
  5. the main path at TinyLlama-1.1B width and depth (random weights from
     a seed, synthetic right-padded batches): SMTTrainer.fit runs the
     full-FT warm-up, selection + conversion, sparse steps, eval loss and
     the final HF export. The kernels' launch counts are zeroed just before
     and read just after; frozen weights and the export are checked.
The line before the last is a JSON object of the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T
# config.json): the port's LlamaConfig defaults
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=22, num_attention_heads=32,
                 num_key_value_heads=4, rms_norm_eps=1e-5, rope_theta=10000.0,
                 tie_word_embeddings=False)
K1_SHAPES = [(2048, 5632, 2048), (700, 5632, 2048), (2048, 2048, 5632), (700, 2048, 5632)]
K1_N = 24
K1_RTOL, K1_ATOL = 2e-2, 2e-1       # the JAX suite's bf16 block-grad tolerance
K1_F32_RTOL, K1_F32_ATOL = 1e-5, 1e-4  # and its fp32 one
K2_RTOL, K2_ATOL = 1e-6, 1e-9       # both compute in fp32, operation for operation


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def check_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
        log(f"[nvidia-smi] {line}")
    else:
        log("[nvidia-smi] not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps=20, warmup=3):
    """Median of `reps` single-call CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _coords(rng, n, n_row, n_col):
    """n block coordinates with repeated rows, repeated columns and one
    repeated pair."""
    import numpy as np
    rb = rng.integers(0, n_row, n).astype(np.int32)
    cb = rng.integers(0, n_col, n).astype(np.int32)
    rb[1] = rb[0]
    cb[2] = cb[0]
    rb[3], cb[3] = rb[0], cb[0]
    return rb, cb


def check_block_grad():
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda.block_grad import block_grad, block_grad_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst, timing = 0.0, None
    for t, o, i in K1_SHAPES:
        g2 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev, torch.bfloat16)
        x2 = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev, torch.bfloat16)
        rb_np, cb_np = _coords(rng, K1_N, o // 256, i // 256)
        rb = torch.from_numpy(rb_np).to(dev)
        cb = torch.from_numpy(cb_np).to(dev)
        got = block_grad(g2, x2, rb, cb)
        torch.cuda.synchronize()
        want = block_grad_plain(g2, x2, rb, cb)  # fp32 products of the same bf16 values
        assert got.shape == (K1_N, 256, 256) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=K1_ATOL)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"[K1 block_grad] bf16 T={t} (O,I)=({o},{i}) n={K1_N}: max_abs_err {err:.3e}")
        if timing is None:  # the main shape: T=2048, (5632, 2048)
            def lib():
                g_rows = g2.reshape(t, -1, 256).index_select(1, rb.long()).transpose(0, 1)
                x_cols = x2.reshape(t, -1, 256).index_select(1, cb.long()).transpose(0, 1)
                return torch.bmm(g_rows.transpose(1, 2), x_cols)
            ms = time_ms(lambda: block_grad(g2, x2, rb, cb))
            plain_ms = time_ms(lambda: block_grad_plain(g2, x2, rb, cb))
            lib_ms = time_ms(lib)
            ms2 = time_ms(lambda: block_grad(g2, x2, rb, cb))
            flop = 2.0 * K1_N * t * 256 * 256
            timing = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, ms_repeat=ms2,
                          shape=f"T={t} (O,I)=({o},{i}) n={K1_N} bf16",
                          tflops=flop / (min(ms, ms2) * 1e-3) / 1e12)
    # the fp32 variant (taken by --dtype fp32 runs)
    t, o, i = K1_SHAPES[3]
    g2 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev)
    x2 = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev)
    rb_np, cb_np = _coords(rng, K1_N, o // 256, i // 256)
    rb, cb = torch.from_numpy(rb_np).to(dev), torch.from_numpy(cb_np).to(dev)
    got = block_grad(g2, x2, rb, cb)
    torch.cuda.synchronize()
    want = block_grad_plain(g2, x2, rb, cb)
    torch.testing.assert_close(got, want, rtol=K1_F32_RTOL, atol=K1_F32_ATOL)
    log(f"[K1 block_grad] fp32 T={t} (O,I)=({o},{i}) n={K1_N}: "
        f"max_abs_err {float((got - want).abs().max()):.3e}")
    log(f"[K1 block_grad] time at {timing['shape']}: kernel {timing['ms']:.4f} ms "
        f"(repeat {timing['ms_repeat']:.4f}), plain {timing['plain_ms']:.4f} ms, "
        f"library bmm on gathered bf16 panels {timing['lib_ms']:.4f} ms; "
        f"kernel {timing['tflops']:.1f} TFLOP/s")
    return worst, timing


def check_masked_adam():
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda.masked_adam import masked_adam, masked_adam_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = K1_N
    shape = (n, 256, 256)

    def rand(scale):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)).to(dev)

    p0 = rand(0.02)
    kernel_state = [p0.clone(), torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)]
    plain_state = [p0.clone(), torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)]
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.1, 1e-3
    worst = 0.0
    for step in range(1, 4):
        g = rand(0.1)
        c = torch.tensor(float(step), device=dev)
        scalars = torch.stack([torch.tensor(lr, device=dev), torch.tensor(b1, device=dev),
                               torch.tensor(b2, device=dev), torch.tensor(eps, device=dev),
                               torch.tensor(wd, device=dev), 1.0 - torch.pow(b1, c),
                               1.0 - torch.pow(b2, c)]).float()
        masked_adam(*kernel_state[:1], g, *kernel_state[1:], scalars)
        torch.cuda.synchronize()
        masked_adam_plain(plain_state[0], g, plain_state[1], plain_state[2], scalars)
        for got, want, what in zip(kernel_state, plain_state, "pmv"):
            torch.testing.assert_close(got, want, rtol=K2_RTOL, atol=K2_ATOL)
            worst = max(worst, float((got - want).abs().max()))
        log(f"[K2 masked_adam] step {step}: p/m/v max_abs_err {worst:.3e}")

    p, m, v = kernel_state
    g = rand(0.1)

    def lib():  # torch._foreach Adam ops over the same tensors
        torch._foreach_mul_([m], b1)
        torch._foreach_add_([m], [g], alpha=1 - b1)
        torch._foreach_mul_([v], b2)
        torch._foreach_addcmul_([v], [g], [g], value=1 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div([v], 1 - b2 ** 3))
        torch._foreach_add_(denom, eps)
        torch._foreach_mul_([p], 1 - lr * wd)
        torch._foreach_addcdiv_([p], [m], denom, value=-lr / (1 - b1 ** 3))

    ms = time_ms(lambda: masked_adam(p, g, m, v, scalars))
    plain_ms = time_ms(lambda: masked_adam_plain(p, g, m, v, scalars))
    lib_ms = time_ms(lib)
    ms2 = time_ms(lambda: masked_adam(p, g, m, v, scalars))
    nbytes = 7 * 4 * p.numel()
    timing = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, ms_repeat=ms2,
                  shape=f"n={n} (n,256,256) fp32",
                  gbps=nbytes / (min(ms, ms2) * 1e-3) / 1e9)
    log(f"[K2 masked_adam] time at {timing['shape']}: kernel {ms:.4f} ms "
        f"(repeat {ms2:.4f}), plain {plain_ms:.4f} ms, library torch._foreach "
        f"{lib_ms:.4f} ms; kernel {timing['gbps']:.0f} GB/s of 28 B/element")
    return worst, timing


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def synthetic_sft(n, seq, vocab, seed):
    """SFT examples (right-padded by the batch iterator): random token ids,
    length 3/4 seq .. seq, the first seq/16 .. seq/4 tokens a prompt masked
    with -100 (32..128 at seq 512)."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.data.sft import IGNORE_INDEX, SFTDataset
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for _ in range(n):
        length = int(rng.integers(seq * 3 // 4, seq + 1))
        prompt = int(rng.integers(seq // 16, seq // 4 + 1))
        x = rng.integers(3, vocab, length).astype(np.int32)
        y = x.copy()
        y[:prompt] = IGNORE_INDEX
        ids.append(x)
        labels.append(y)
    return SFTDataset(ids, labels)


def run_main_path(model_cfg, device, *, dtype="bf16", bs=4, seq=512,
                  full_ft_steps=3, sparse_steps=4, eval_batches=2,
                  ratios=(0.0084, 0.0084), out_dir=None, log_fn=log):
    """SMTTrainer.fit through warm-up -> conversion -> sparse -> eval ->
    final export, with per-phase step times and peak memory. Checks
    finiteness, a non-empty plan, frozen weights outside the selected
    blocks, and the export against merged_params(). Returns a summary."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree, init_params
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
    from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = SMTConfig(
        data_path=["synthetic"], model_name_or_path="random-init", dtype=dtype,
        gradient_checkpointing=True, matrix_sparsity=True,
        full_ft_steps=full_ft_steps,
        downsample_attention_blocks_ratio=ratios[0],
        downsample_mlp_blocks_ratio=ratios[1],
        # recipes/smt_commonsense.sh hyper-parameters
        ft_learning_rate=9.865e-6, smt_lr=9.865e-6, calculate_strategy="abs_mean",
        per_device_ft_batch_size=bs, per_device_eval_batch_size=bs,
        max_seq_len=seq, seq_buckets=[seq], num_ft_epochs=1, eval_step=0,
        save_steps=0, log_steps=1, throughput_steps=10 ** 9, seed=1234,
        output_dir=out_dir)
    n_steps = full_ft_steps + sparse_steps
    train_ds = synthetic_sft(n_steps * bs, seq, model_cfg.vocab_size, 1)
    eval_ds = synthetic_sft(eval_batches * bs, seq, model_cfg.vocab_size, 2)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_and_reset():
        if not cuda:
            return None
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return peak

    t0 = time.time()
    params = init_params(model_cfg, seed=0, dtype=cfg.param_dtype, device=device)
    n_params = sum(p.numel() for p in flatten_tree(params).values())
    trainer = SMTTrainer(cfg, model_cfg, params, total_steps=n_steps, device=device)
    del params
    sync()
    log_fn(f"[main] {n_params:,} params, init + trainer {time.time() - t0:.1f} s, "
           f"saliency_accumulation={cfg.saliency_accumulation}")

    summary = {"n_params": n_params, "step_ms": [], "phase": [], "loss": [], "peak": {}}
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    marks = {"exit": 0.0}
    snap = {}

    def on_metrics(step, metrics):
        t_enter = time.perf_counter()
        summary["step_ms"].append((t_enter - marks["exit"]) * 1e3)
        summary["phase"].append(trainer.phase)
        summary["loss"].append(float(metrics["loss"]))
        if step == full_ft_steps:
            summary["peak"]["warmup"] = peak_and_reset()
            summary["launches_warmup"] = {"block_grad": k1.LAUNCHES,
                                          "masked_adam": k2.LAUNCHES}
            # dense weights at conversion: the master cast to the param dtype
            snap["params"] = {li: {m: w.to("cpu") for m, w in layer.items()}
                              for li, layer in trainer.merged_params()["layers"].items()}
            sync()
            peak_and_reset()
        elif step == full_ft_steps + 1:
            summary["peak"]["conversion_and_first_sparse"] = peak_and_reset()
        elif step == n_steps:
            summary["peak"]["later_sparse_steps"] = peak_and_reset()
        marks["exit"] = time.perf_counter()

    peak_and_reset()
    sync()
    marks["exit"] = time.perf_counter()
    history = trainer.fit(train_ds, eval_ds, pad_token_id=0, on_metrics=on_metrics)
    sync()
    t_fit_end = time.perf_counter()
    summary["launches"] = {"block_grad": k1.LAUNCHES, "masked_adam": k2.LAUNCHES}
    summary["eval_and_export_s"] = t_fit_end - marks["exit"]
    summary["peak"]["eval_and_export"] = peak_and_reset()
    summary["eval_loss"] = history["eval_loss"][-1]

    plan = trainer.plan
    losses = summary["loss"] + [summary["eval_loss"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if plan is None or not plan.linears:
        raise AssertionError("the plan is empty")
    if summary["phase"][full_ft_steps - 1] != "warmup" or summary["phase"][-1] != "sparse":
        raise AssertionError(f"phases {summary['phase']}")
    summary["plan"] = {"linears": len(plan.linears), "blocks": sum(
        lp.n_blocks for lp in plan.linears.values()),
        "trainable_params": plan.trainable_params, "fingerprint": plan.fingerprint()}

    # frozen weights: bitwise unchanged outside the selected blocks
    after = trainer.state["params"]["layers"]
    checked, changed_in_blocks, block_elems = 0, 0, 0
    for li, layer in snap["params"].items():
        for mod, before in layer.items():
            w = after[li][mod].to("cpu")
            lp = plan.linears.get(f"{li}.{mod}")
            if lp is None:
                if not torch.equal(w, before):
                    raise AssertionError(f"frozen weight {li}.{mod} changed")
            else:
                mask = torch.zeros(before.shape, dtype=torch.bool)
                for rb, cb in lp.blocks:
                    mask[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = True
                if not torch.equal(w[~mask], before[~mask]):
                    raise AssertionError(f"{li}.{mod} changed outside its selected blocks")
                changed_in_blocks += int((w[mask] != before[mask]).sum())
                block_elems += int(mask.sum())
            checked += 1
    summary["frozen_checked"] = checked
    summary["selected_elems_changed"] = (changed_in_blocks, block_elems)

    # export: the final safetensors read back equal merged_params() bitwise
    export = None
    if out_dir:
        merged = trainer.merged_params()
        back = load_hf_params(os.path.join(out_dir, "final"), model_cfg,
                              dtype=cfg.param_dtype, device="cpu")
        exported = 0

        def compare(a, b, path):
            nonlocal exported
            if isinstance(a, dict):
                if set(a) != set(b):
                    raise AssertionError(f"export keys differ at {path}")
                for k in a:
                    compare(a[k], b[k], f"{path}.{k}")
                return
            if not torch.equal(a.to("cpu"), b):
                raise AssertionError(f"exported {path} differs from merged_params()")
            exported += 1

        compare(merged, back, "params")
        with open(os.path.join(out_dir, "final", "smt_plan.json")) as f:
            if f.read() != plan.to_json():
                raise AssertionError("exported smt_plan.json differs")
        export = exported
    summary["export_tensors_equal"] = export
    return summary


def check_small_reference():
    """Tiny fp32 two-phase run on the GPU against the same run on the CPU
    (plain versions): losses and plan must agree."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(vocab_size=512)
    kw = dict(dtype="fp32", bs=4, seq=64, full_ft_steps=2, sparse_steps=4,
              eval_batches=1, ratios=(0.05, 0.05), log_fn=lambda m: None)
    gpu = run_main_path(cfg, "cuda", **kw)
    cpu = run_main_path(cfg, "cpu", **kw)
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=1e-4)
    if gpu["plan"]["fingerprint"] != cpu["plan"]["fingerprint"]:
        raise AssertionError("tiny run: GPU and CPU plans differ")
    if gpu["launches"]["block_grad"] == 0 or gpu["launches"]["masked_adam"] == 0:
        raise AssertionError(f"tiny GPU run did not launch the kernels: {gpu['launches']}")
    worst = float(np.max(np.abs(np.array(gpu["loss"]) - np.array(cpu["loss"]))
                         / np.abs(np.array(cpu["loss"]))))
    log(f"[reference] tiny fp32 run, GPU kernels vs CPU plain: losses {gpu['loss']} "
        f"(worst rel diff {worst:.2e}), same plan {gpu['plan']['fingerprint'][:16]}")


def main():
    check_device()
    import torch
    sys.path.insert(0, REPO)
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

    t0 = time.time()
    lib_path = _build.build()
    log(f"[build] {os.path.relpath(lib_path, REPO)} in {time.time() - t0:.1f} s "
        f"(nvcc {_build.last_build_seconds if _build.last_build_seconds is not None else 'cached'})")
    ptxas = lib_path.parent / f"{lib_path.stem}.ptxas.txt"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {line.strip()}")
    _build.load()

    k1_err, k1_time = check_block_grad()
    k2_err, k2_time = check_masked_adam()
    check_small_reference()

    model_cfg = LlamaConfig(**TINYLLAMA)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        s = run_main_path(model_cfg, "cuda", out_dir=out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    launches = s["launches"]
    if launches["block_grad"] <= 0 or launches["masked_adam"] <= 0:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    gib = 1024 ** 3
    n_w = 3
    warm, sparse = s["step_ms"][:n_w], s["step_ms"][n_w:]
    log(f"[main] TinyLlama-1.1B bf16, bs 4 x seq 512, remat: losses {s['loss']}, "
        f"eval loss {s['eval_loss']:.4f}")
    log(f"[main] plan: {s['plan']}")
    log(f"[main] warm-up ms/step {[round(x, 1) for x in warm]} (median "
        f"{statistics.median(warm[1:]):.1f} over steps 2-3); sparse ms/step "
        f"{[round(x, 1) for x in sparse]} (step 4 includes conversion; median "
        f"{statistics.median(sparse[1:]):.1f} over steps 5-7)")
    log("[main] peak device memory (GiB): " + ", ".join(
        f"{k} {v / gib:.2f}" for k, v in s["peak"].items() if v is not None))
    log(f"[main] eval + export {s['eval_and_export_s']:.1f} s; export tensors "
        f"equal to merged_params(): {s['export_tensors_equal']}; frozen weights "
        f"checked {s['frozen_checked']}; selected elements changed "
        f"{s['selected_elems_changed'][0]}/{s['selected_elems_changed'][1]}")
    log(f"[main] kernel launches in the main path: {launches} "
        f"(warm-up: {s.get('launches_warmup', 'n/a')})")

    kernels = [
        {"name": "block_grad", "route": "cuda",
         "source": "sparse_matrix_tuning_tpu_torch/csrc/block_grad.cu",
         "replaces": "sparse_matrix_tuning_tpu/ops/pallas/block_grad.py:56",
         "launches": launches["block_grad"], "max_abs_err": k1_err,
         "ms": k1_time["ms"], "plain_ms": k1_time["plain_ms"]},
        {"name": "masked_adam", "route": "cuda",
         "source": "sparse_matrix_tuning_tpu_torch/csrc/masked_adam.cu",
         "replaces": "sparse_matrix_tuning_tpu/ops/pallas/masked_adam.py:35",
         "launches": launches["masked_adam"], "max_abs_err": k2_err,
         "ms": k2_time["ms"], "plain_ms": k2_time["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
