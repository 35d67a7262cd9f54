#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sparse_matrix_tuning_tpu_torch) on
one CUDA GPU (written for an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build the CUDA kernels (csrc/*.cu) with nvcc for sm_90a, timed;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, with its time beside the plain version's and a library
     path's: K1/K2 at the two widest TinyLlama linears; K3 (attention
     forward, delta, dK/dV, dQ) at five shapes (K3_SHAPES), timed at the
     first two beside torch SDPA, with each path's fwd+bwd peak memory;
  4. a small-input reference: a tiny fp32 two-phase run on the GPU (CUDA
     kernels, attention through K3) against the same run on the CPU
     (plain versions, einsum attention);
  5. three trainer runs (random weights from a seed, synthetic
     right-padded batches), each SMTTrainer.fit through the full-FT
     warm-up, selection + conversion, sparse steps and eval loss, with the
     kernels' launch counts zeroed just before and read just after, and
     frozen weights checked: A, the main path, TinyLlama-1.1B width and
     depth at bs 4 x seq 512, attention "auto" (K3), with the final HF
     export checked; B, the same at the recipe's seq 2048, bs 2; C, as A
     with the einsum attention (no K3 launch allowed).
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
# K3 shapes (b, s, hq, hkv, hd, dtype, what); the first two are timed
K3_SHAPES = [
    (4, 512, 32, 4, 64, "bf16", "TinyLlama, the main path"),
    (2, 2048, 32, 4, 64, "bf16", "TinyLlama at the recipe's length"),
    (1, 2048, 32, 8, 128, "bf16", "Llama-3-8B attention geometry"),
    (2, 1000, 32, 4, 64, "bf16", "ragged"),
    (2, 700, 8, 2, 64, "fp32", "fp32"),
]
K3_TIMED = 2
# (fwd rtol, atol), (grads rtol, atol). bf16: the JAX suite's
# (tests/test_attention_kernel.py:40, 67). fp32: looser than the CPU
# suite's 2e-6 because the order of the sums over up to 2048 keys and the
# online-softmax rescaling differ from the plain version's.
K3_TOL = {"bf16": ((2e-2, 1e-1), (4e-2, 4e-1)), "fp32": ((1e-5, 1e-5), (1e-4, 1e-4))}
K3_KERNELS = ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")


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


def _k3_case(b, s, hq, hkv, hd, dtype, rng):
    """One K3 shape: every kernel against its plain version on the same
    inputs. Returns ({tensor: max abs err}, {kernel: max abs err}, the
    inputs of _k3_times)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3

    dev, dt = torch.device("cuda"), {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    q, k, v, do = rand(b, s, hq, hd), rand(b, s, hkv, hd), rand(b, s, hkv, hd), rand(b, s, hq, hd)
    sm = 1.0 / float(np.sqrt(hd))
    (f_rtol, f_atol), (g_rtol, g_atol) = K3_TOL[dtype]
    o, lse = k3.attn_fwd(q, k, v, sm)
    torch.cuda.synchronize()
    o_ref, lse_ref = k3.attn_fwd_plain(q, k, v, sm)
    # the backward kernels take the plain forward's o and lse, as the plain
    # backward does
    delta = k3.attn_bwd_delta(o_ref, do)
    dk, dv = k3.attn_bwd_dkdv(q, k, v, do, lse_ref, delta, sm)
    dq = k3.attn_bwd_dq(q, k, v, do, lse_ref, delta, sm)
    torch.cuda.synchronize()
    delta_ref = k3.attn_bwd_delta_plain(o_ref, do)
    dk_ref, dv_ref = k3.attn_bwd_dkdv_plain(q, k, v, do, lse_ref, delta_ref, sm)
    dq_ref = k3.attn_bwd_dq_plain(q, k, v, do, lse_ref, delta_ref, sm)
    errs = {}
    for name, got, want, (rtol, atol) in (
            ("o", o, o_ref, (f_rtol, f_atol)), ("lse", lse, lse_ref, (f_rtol, f_atol)),
            ("delta", delta, delta_ref, (f_rtol, f_atol)),
            ("dq", dq, dq_ref, (g_rtol, g_atol)), ("dk", dk, dk_ref, (g_rtol, g_atol)),
            ("dv", dv, dv_ref, (g_rtol, g_atol))):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m, name=name: f"K3 {name}: {m}")
        errs[name] = float((got.float() - want.float()).abs().max())
    per_kernel = {"attn_fwd": max(errs["o"], errs["lse"]), "attn_bwd_delta": errs["delta"],
                  "attn_bwd_dkdv": max(errs["dk"], errs["dv"]), "attn_bwd_dq": errs["dq"]}
    return errs, per_kernel, (q, k, v, do, sm, o_ref, lse_ref, delta)


def _peak_gib(fn):
    """Peak device memory of fn(), GiB (inputs included)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1024 ** 3


def _k3_times(q, k, v, do, sm, o, lse, delta):
    """Each kernel against its plain version, the sum of the backward
    kernels, and torch SDPA (a library reference for the time only), with
    the peak memory of each path's forward + backward."""
    import torch
    import torch.nn.functional as F
    from sparse_matrix_tuning_tpu_torch.ops.attention import fullk_attention
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3

    t = {
        "attn_fwd": (time_ms(lambda: k3.attn_fwd(q, k, v, sm)),
                     time_ms(lambda: k3.attn_fwd_plain(q, k, v, sm))),
        "attn_bwd_delta": (time_ms(lambda: k3.attn_bwd_delta(o, do)),
                           time_ms(lambda: k3.attn_bwd_delta_plain(o, do))),
        "attn_bwd_dkdv": (time_ms(lambda: k3.attn_bwd_dkdv(q, k, v, do, lse, delta, sm)),
                          time_ms(lambda: k3.attn_bwd_dkdv_plain(q, k, v, do, lse, delta, sm))),
        "attn_bwd_dq": (time_ms(lambda: k3.attn_bwd_dq(q, k, v, do, lse, delta, sm)),
                        time_ms(lambda: k3.attn_bwd_dq_plain(q, k, v, do, lse, delta, sm))),
    }
    t["bwd_kernels_sum"] = tuple(sum(t[n][i] for n in K3_KERNELS[1:]) for i in (0, 1))
    t["attn_fwd_repeat"] = time_ms(lambda: k3.attn_fwd(q, k, v, sm))
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, H, S, hd)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    t["sdpa_fwd"] = time_ms(sdpa)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd_bwd(attn):
        def run():
            for x in leaves:
                x.grad = None
            attn(*leaves).backward(do)
        return run

    def sdpa_path(a, b_, c):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2)

    def plain_path(a, b_, c):  # autograd through the plain forward
        return k3.attn_fwd_plain(a, b_, c, sm)[0]

    paths = {"kernels": lambda a, b_, c: fullk_attention(a, b_, c, sm),
             "plain": plain_path, "sdpa": sdpa_path}
    t["fwd_bwd_ms"] = {n: time_ms(fwd_bwd(f), reps=10) for n, f in paths.items()}
    t["fwd_bwd_peak_gib"] = {n: _peak_gib(fwd_bwd(f)) for n, f in paths.items()}
    for x in leaves:
        x.grad = None
    return t


def check_attention():
    """K3 at K3_SHAPES: o, lse, delta, dq, dk, dv against the plain versions;
    times at the first K3_TIMED shapes. Returns ({kernel: worst err},
    {kernel: (ms, plain_ms)} at the main shape)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    worst = {n: 0.0 for n in K3_KERNELS}
    main_times = None
    for i, (b, s, hq, hkv, hd, dtype, what) in enumerate(K3_SHAPES):
        errs, per_kernel, args = _k3_case(b, s, hq, hkv, hd, dtype, rng)
        for n, e in per_kernel.items():
            worst[n] = max(worst[n], e)
        shape = f"b{b} s{s} hq{hq} hkv{hkv} hd{hd} {dtype}"
        log(f"[K3 attention] {shape} ({what}): max_abs_err " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()))
        if i < K3_TIMED:
            t = _k3_times(*args)
            log(f"[K3 attention] time at {shape}: " + "; ".join(
                f"{n} {t[n][0]:.4f} ms (plain {t[n][1]:.4f})"
                for n in (*K3_KERNELS, "bwd_kernels_sum")) +
                f"; fwd repeat {t['attn_fwd_repeat']:.4f}; torch SDPA fwd {t['sdpa_fwd']:.4f}")
            log(f"[K3 attention] fwd+bwd at {shape}: " + "; ".join(
                f"{n} {t['fwd_bwd_ms'][n]:.4f} ms, peak {t['fwd_bwd_peak_gib'][n]:.3f} GiB"
                for n in t["fwd_bwd_ms"]))
            if main_times is None:
                main_times = {n: t[n] for n in K3_KERNELS}
        del args
        torch.cuda.empty_cache()
    return worst, main_times


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def reset_launches():
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    for name in k3.LAUNCHES:
        k3.LAUNCHES[name] = 0


def launches():
    """Every kernel's launch count since the last reset_launches()."""
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
    return {"block_grad": k1.LAUNCHES, "masked_adam": k2.LAUNCHES, **k3.LAUNCHES}


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
                  ratios=(0.0084, 0.0084), attn_impl="auto", out_dir=None, log_fn=log):
    """SMTTrainer.fit through warm-up -> conversion -> sparse -> eval ->
    final export, with per-phase step times and peak memory. Checks
    finiteness, a non-empty plan, frozen weights outside the selected
    blocks, and the export against merged_params(). Returns a summary."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree, init_params
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
        attn_impl=attn_impl, output_dir=out_dir)
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
    reset_launches()
    marks = {"exit": 0.0}
    snap = {}

    def on_metrics(step, metrics):
        t_enter = time.perf_counter()
        summary["step_ms"].append((t_enter - marks["exit"]) * 1e3)
        summary["phase"].append(trainer.phase)
        summary["loss"].append(float(metrics["loss"]))
        if step == full_ft_steps:
            summary["peak"]["warmup"] = peak_and_reset()
            summary["launches_warmup"] = launches()
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
    summary["launches"] = launches()
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
    """Tiny fp32 two-phase run on the GPU (attn_impl "auto": K3) against the
    same run on the CPU (plain versions, einsum attention): losses and plan
    must agree, and every kernel must have launched on the GPU."""
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
    if not all(n > 0 for n in gpu["launches"].values()):
        raise AssertionError(f"tiny GPU run did not launch every kernel: {gpu['launches']}")
    worst = float(np.max(np.abs(np.array(gpu["loss"]) - np.array(cpu["loss"]))
                         / np.abs(np.array(cpu["loss"]))))
    log(f"[reference] tiny fp32 run, GPU kernels vs CPU plain: losses {gpu['loss']} "
        f"(worst rel diff {worst:.2e}), same plan {gpu['plan']['fingerprint'][:16]}, "
        f"GPU launches {gpu['launches']}")


def report_run(tag, what, s, n_warmup):
    """Per-phase ms/step, peak memory and launches of one trainer run."""
    gib = 1024 ** 3
    warm, sparse = s["step_ms"][:n_warmup], s["step_ms"][n_warmup:]
    log(f"[{tag}] {what}: losses {s['loss']}, eval loss {s['eval_loss']:.4f}")
    log(f"[{tag}] plan: {s['plan']}")
    log(f"[{tag}] warm-up ms/step {[round(x, 1) for x in warm]} (median "
        f"{statistics.median(warm[1:]):.1f} over steps 2-{n_warmup}); sparse ms/step "
        f"{[round(x, 1) for x in sparse]} (step {n_warmup + 1} includes conversion; median "
        f"{statistics.median(sparse[1:]):.1f} over steps {n_warmup + 2}-{len(s['step_ms'])})")
    log(f"[{tag}] peak device memory (GiB): " + ", ".join(
        f"{k} {v / gib:.2f}" for k, v in s["peak"].items() if v is not None))
    log(f"[{tag}] eval{' + export' if s['export_tensors_equal'] else ''} "
        f"{s['eval_and_export_s']:.1f} s; export tensors equal to merged_params(): "
        f"{s['export_tensors_equal']}; frozen weights checked {s['frozen_checked']}; "
        f"selected elements changed {s['selected_elems_changed'][0]}/"
        f"{s['selected_elems_changed'][1]}")
    log(f"[{tag}] kernel launches: {s['launches']} (warm-up: {s['launches_warmup']})")


def main():
    t_start = time.time()
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
    k3_err, k3_time = check_attention()
    check_small_reference()

    # A: the main path, attn_impl "auto" (K3), with the final export
    model_cfg = LlamaConfig(**TINYLLAMA)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        run_a = run_main_path(model_cfg, "cuda", out_dir=out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    report_run("A", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn auto (K3)", run_a, 3)
    torch.cuda.empty_cache()
    # B: the recipe's max_seq_len 2048, bs 2
    run_b = run_main_path(model_cfg, "cuda", bs=2, seq=2048)
    report_run("B", "TinyLlama-1.1B bf16, bs 2 x seq 2048, remat, attn auto (K3)", run_b, 3)
    torch.cuda.empty_cache()
    # C: the einsum path kept alive, otherwise as A
    run_c = run_main_path(model_cfg, "cuda", attn_impl="einsum")
    report_run("C", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn einsum", run_c, 3)

    for tag, run in (("A", run_a), ("B", run_b)):
        if not all(n > 0 for n in run["launches"].values()):
            raise AssertionError(f"run {tag} did not launch every kernel: {run['launches']}")
    c = run_c["launches"]
    if any(c[n] for n in K3_KERNELS) or c["block_grad"] <= 0 or c["masked_adam"] <= 0:
        raise AssertionError(f"run C (einsum) launches: {c}")

    def entry(name, source, replaces, err, ms, plain_ms):
        return {"name": name, "route": "cuda",
                "source": f"sparse_matrix_tuning_tpu_torch/csrc/{source}",
                "replaces": f"sparse_matrix_tuning_tpu/ops/pallas/{replaces}",
                "launches": run_a["launches"][name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms}

    kernels = [
        entry("block_grad", "block_grad.cu", "block_grad.py:56", k1_err,
              k1_time["ms"], k1_time["plain_ms"]),
        entry("masked_adam", "masked_adam.cu", "masked_adam.py:35", k2_err,
              k2_time["ms"], k2_time["plain_ms"]),
    ] + [entry(name, "attention.cu",
               "attention.py:154" if name == "attn_fwd" else "attention.py:188",
               k3_err[name], *k3_time[name]) for name in K3_KERNELS]
    log(f"[smoke] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
