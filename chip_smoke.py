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
     forward, delta, dK/dV over the planned q-head partitions with its
     reduce, dQ) at five shapes (K3_SHAPES), with a dropped partition the
     check must reject and two dK/dV launches equal bit for bit, timed at
     the first three beside torch SDPA's forward and backward, dK/dV at
     every partition count, with each path's fwd+bwd peak memory; K7
     (cached attention, bf16/fp32 and int8 caches) at eleven shapes
     (K7_SHAPES), each with planted faults the check must reject, split
     over the cache and combined where the rows fit one CTA (a dropped
     split rejected, repeat launches equal), timed at eight beside torch
     SDPA with a boolean mask and at several split counts; K4 (the int8 matmul
     with fused scales, t and g forms) at six shapes (K4_SHAPES: the
     TinyLlama linears and head, a ragged chunk, Llama-3-8B's gate), equal
     to its plain version bit for bit, with a planted fault, timed at four
     beside torch._int_mm plus the scale pass and beside cuBLAS bf16; K5
     (the block correction) at six cases (K5_SHAPES: both orientations,
     ragged T, bf16 and fp32, unsorted coordinates with repeats), with a
     planted fault, timed at two beside bmm + index_add_; each timed kernel
     beside its bound (bytes over the HBM rate or operations over the peak
     rate, from the H100 data sheet);
  4. small-input references: a tiny fp32 two-phase run on the GPU (CUDA
     kernels, attention through K3) against the same run on the CPU
     (plain versions, einsum attention), over the dense base and over the
     int8 base with the chunked q8 loss (K4, K5); tiny fp32 generation,
     greedy and beam-4 over fp32, bf16 and int8 caches, on the GPU (K7)
     against the CPU (its plain version), tokens identical;
  5. trainer runs (random weights from a seed, synthetic right-padded
     batches), each SMTTrainer.fit through the full-FT warm-up, selection
     + conversion, sparse steps and eval loss, with the kernels' launch
     counts zeroed just before and read just after, and the merged weights
     checked: A, the main path, TinyLlama-1.1B width and depth at bs 4 x
     seq 512, attention "auto" (K3), with the final HF export checked; E,
     as A with --frozen_quant int8 (K4 and K5 carry every layer linear and
     the head; the dense weights leave the device; the export must still
     be exact), held against A, and E2, its chunked q8 loss at 2 layers;
     B, as A at the recipe's seq 2048, bs 2; C, as A with the einsum
     attention at 6 layers (no K3 launch allowed);
  6. run D (between A and B), the generation eval of A's fine-tuned
     weights through the harness (make_generate_fn + run_dataset_eval) with
     the CLI's defaults (batch 16, beam-4, repetition penalty 1.1, 256 new
     tokens) on 16 synthetic prompts of 60..256 ids (S = 512): D1 bf16
     cache, D2 greedy,
     D3 int8 cache (each must launch K7), D4 as D1 with the einsum
     attention at 64 new tokens (no K7 launch allowed), D5 one 1900-token
     prompt, greedy, 64 new tokens, through eval/generate (K7 split over
     the cache: cached_attn_combine must launch), against the same with one
     split; per leg prefill ms,
     decode ms/step, tokens/s, peak memory and launches; D1's and D4's
     prefill logits against the same prefill with fp32 attention;
  7. run F (after D), the same eval over a quantized frozen base, each
     leg's params quantized while loading A's HF export by the eval CLI's
     load_decode_params: F1 the int4 base, empty plan (--frozen_quant int4;
     K6 on every linear), F2 the int8 base (K4), F3 the int4 base with A's
     plan (K5 corrects the trained blocks; prefill logits against a dense
     oracle); conversion time and peak, no dense layer weight left on the
     device.
Before the references, K6 (the int4 unpack-matmul) runs at eight shapes
(K6_SHAPES: the TinyLlama linears at the eval decode's 64 rows, 16 and a
ragged 7, Llama-3-8B's gate) and on the layer views of a stack (K6s),
against its plain version within a limit derived from the two fp32
summation orders, with two planted faults the check must reject, timed
beside cuBLAS bf16 on the dequantized weight; and a tiny fp32 generation
over the int8 and int4 bases (planned and empty plan, bf16 and int8
cache, greedy and beam-4) on the GPU against the CPU, tokens identical.
The line before the last is a JSON object of the kernels' numbers; the
last line is {"ok": true, "device": {...}}. `--only q8` stops after the
build, the K4 / K5 checks and the tiny int8 reference; `--only q4` after
the build, the K6 checks and the tiny quantized generation; `--only attn`
after the build and the K3 / K7 checks; none of them prints a result.
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
# K3 shapes (b, s, hq, hkv, hd, dtype, what); the first three are timed
K3_SHAPES = [
    (4, 512, 32, 4, 64, "bf16", "TinyLlama, the main path"),
    (2, 2048, 32, 4, 64, "bf16", "TinyLlama at the recipe's length"),
    (1, 2048, 32, 8, 128, "bf16", "Llama-3-8B attention geometry"),
    (2, 1000, 32, 4, 64, "bf16", "ragged"),
    (2, 700, 8, 2, 64, "fp32", "fp32"),
]
K3_TIMED = 3
# (fwd rtol, atol), (grads rtol, atol). bf16: the JAX suite's
# (tests/test_attention_kernel.py:40, 67). fp32: looser than the CPU
# suite's 2e-6 because the order of the sums over up to 2048 keys and the
# online-softmax rescaling differ from the plain version's.
K3_TOL = {"bf16": ((2e-2, 1e-1), (4e-2, 4e-1)), "fp32": ((1e-5, 1e-5), (1e-4, 1e-4))}
K3_KERNELS = ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dkdv_reduce", "attn_bwd_dq")
TRAIN_KERNELS = ("block_grad", "masked_adam") + K3_KERNELS
# K7 shapes (b, t, hq, hkv, hd, s, cache_index, q dtype, cache dtype, what, timed)
K7_SHAPES = [
    (64, 1, 32, 4, 64, 512, 300, "bf16", "bf16", "TinyLlama eval decode, 16 prompts x 4 beams",
     True),
    (64, 1, 32, 4, 64, 512, 300, "bf16", "int8", "TinyLlama eval decode, int8 cache", True),
    (16, 1, 32, 4, 64, 512, 300, "bf16", "bf16", "TinyLlama greedy decode, 16 prompts", True),
    (1, 1, 32, 4, 64, 2048, 1900, "bf16", "bf16", "TinyLlama decode of one 1.9k-token prompt (D5)",
     True),
    (16, 256, 32, 4, 64, 512, 0, "bf16", "bf16", "TinyLlama eval prefill", True),
    (16, 1, 32, 8, 128, 4096, 3840, "bf16", "bf16", "Llama-3-8B geometry decode", True),
    (16, 1, 32, 8, 128, 4096, 3840, "bf16", "int8", "Llama-3-8B geometry decode, int8 cache", True),
    (4, 512, 32, 8, 128, 4096, 1024, "bf16", "bf16", "Llama-3-8B geometry prefill chunk", False),
    (2, 9, 8, 2, 64, 700, 687, "fp32", "fp32", "fp32, ragged S", False),
    (2, 9, 8, 2, 64, 700, 687, "fp32", "int8", "int8 cache on fp32", False),
    (1, 1, 32, 8, 128, 16384, 16000, "bf16", "bf16",
     "many splits: Llama-3-8B geometry decode, one sequence, 16k cache", True),
]
# fp32 and int8-on-fp32: (rtol, atol) of the JAX suite
# (tests/test_cached_attention.py:85). bf16: max |kernel - plain| at most
# K7_BF16_REL x max |plain| over the shape. Both round the output to bf16
# from fp32 values that differ by the rounding of P (the kernel rounds the
# unnormalised P to bf16, the plain version the normalised one: 2^-9 of a
# slot's share), far below an ulp of the large outputs, so they differ by at
# most one bf16 ulp, <= 2^-7 = 0.78e-2 of the largest |o|. A fixed atol
# would not do: decode rows average hundreds to thousands of slots, and
# their typical |o| is sqrt(e / slots), 0.03 at the 8B geometry's 3840.
K7_TOL = {"fp32": (2e-3, 2e-3)}
K7_BF16_REL = 1e-2
K7_KERNELS = ("cached_attn", "cached_attn_q8", "cached_attn_combine")
# K4 shapes (T, K, O, out dtype, what, timed); each runs the t form
# (T, K) x (O, K)^T -> (T, O) and the g form (T, O) x (O, K) -> (T, K)
K4_SHAPES = [
    (2048, 2048, 5632, "bf16", "TinyLlama gate/up, the main path", True),
    (2048, 5632, 2048, "bf16", "TinyLlama down", True),
    (2048, 2048, 256, "bf16", "TinyLlama k/v", False),
    (2048, 2048, 32000, "fp32", "TinyLlama head, fp32 logits", True),
    (2044, 2048, 4096, "fp32", "a chunk of the chunked q8 loss, ragged T", False),
    (2048, 4096, 14336, "bf16", "Llama-3-8B gate", True),
]
K4_KERNELS = ("q8mm_t", "q8mm_g")
# K5 cases (T, O, I, dtype, transpose, what, timed): out (T, O) += src (T, I)
# panels @ D_j; transpose = the forward correction (D_j = delta_j^T)
K5_N = 24
K5_SHAPES = [
    (2048, 5632, 2048, "bf16", True, "TinyLlama gate/up forward, the main path", True),
    (2048, 2048, 5632, "bf16", False, "TinyLlama gate/up grad_input", True),
    (2044, 5632, 2048, "bf16", True, "ragged T, forward", False),
    (2044, 2048, 5632, "bf16", False, "ragged T, grad_input", False),
    (2044, 2048, 2048, "fp32", True, "fp32, ragged T, forward", False),
    (2048, 2048, 2048, "fp32", False, "fp32 grad_input", False),
]
# K5 against its plain version. Both sum the same products in fp32 in another
# order and round once, so in bf16 they are equal or one bf16 ulp apart:
# |diff| <= 2^-7 |want|, plus an absolute term for sums near zero. fp32: the
# JAX suite's correction tolerance (tests/test_scan_ops.py:147).
K5_TOL = {"bf16": (2.0 ** -7, 1e-4), "fp32": (1e-5, 1e-5)}
Q8_KERNELS = K4_KERNELS + ("block_correction",)
# K6 shapes (T, I, O, out dtype, what, timed): out (T, O) = x (T, I) bf16 . the
# int4 weight (O, I/2 packed, one fp32 scale per 128 columns)
K6_SHAPES = [
    (64, 2048, 5632, "bf16", "TinyLlama gate/up at the eval decode (16 prompts x 4 beams), the "
     "main path", True),
    (64, 2048, 2048, "bf16", "TinyLlama q/o at the eval decode", False),
    (64, 2048, 256, "bf16", "TinyLlama k/v at the eval decode", False),
    (64, 5632, 2048, "bf16", "TinyLlama down at the eval decode", False),
    (16, 2048, 5632, "bf16", "TinyLlama gate/up at greedy decode", False),
    (7, 5632, 2048, "bf16", "ragged T", False),
    (7, 2048, 256, "fp32", "ragged T, fp32 out (an fp32 model's k/v)", False),
    (64, 4096, 14336, "bf16", "Llama-3-8B gate at the eval decode", True),
]
K6_STACK = (3, 64, 2048, 2048)  # K6s: layers, T, I, O; K6 on the views of layers 1 and 2
# tiny quantized generation, GPU against CPU: logits of each forward call
# before the decodes part, relative to the call's largest |logit|. Flipped
# int8 steps and bf16 roundings of K6 inputs, carried through the cache,
# moved them by up to 2.9e-2 over 16 steps on the int8 base and 6.1e-3 on
# the int4 base (PERF.md, section 6); a wrong kernel moves them by tens of
# percent
QUANT_DECODE_REL = 2.0 ** -3
# H100 SXM data sheet: HBM bytes/s and dense peak operations/s by type
# (bf16 on the tensor cores; fp32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}


def log(msg):
    print(msg, flush=True)


def bound(nbytes, ops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

_L2_SCRUB = []  # a buffer larger than the H100's 50 MB L2, made at first use
TIMER_COUNTS = {"timings": 0, "retries": 0}  # time_ms calls, and re-timings behind a longer spin


def time_ms(fn, reps=20, warmup=3):
    """Device time of one call, the median over `reps` calls. The calls are
    enqueued behind a spin kernel that lasts past their enqueueing, so the
    host's own time per call (the wrapper's checks, Python) opens no gap on
    the device; each call sits between its own pair of CUDA events, after a
    write over a 128 MB buffer that evicts its inputs from L2, as the main
    path finds them (a layer's weights, cache and optimizer state were last
    touched a whole step earlier). If the spin had ended by the time the
    last call was enqueued, the device may have waited on the host: the
    timing is taken again behind a spin twice as long, and raises after
    three tries (an fn that synchronises always ends the spin)."""
    import torch
    if not _L2_SCRUB:
        _L2_SCRUB.append(torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda"))
    scrub = _L2_SCRUB[0]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # one warm call's enqueueing, on an idle queue
    scrub.zero_()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # the first spin lasts about twice the enqueueing at up to 2 GHz
    spin_ms = min(2 * reps * host_ms + 1, 1000.0)
    TIMER_COUNTS["timings"] += 1
    for attempt in range(3):
        TIMER_COUNTS["retries"] += attempt > 0
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        spun = torch.cuda.Event()
        torch.cuda._sleep(int(spin_ms * 2e6))
        spun.record()
        for start, end in zip(starts, ends):
            scrub.zero_()
            start.record()
            fn()
            end.record()
        drained = spun.query()  # the spin had ended before the last call was enqueued
        ends[-1].synchronize()
        if not drained:
            return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))
        spin_ms *= 2
    raise RuntimeError("time_ms: the device caught up with the host in three tries; fn "
                       "synchronises or enqueues more than the launch queue holds")


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
            # the row / column panels of the selected blocks, read once, and
            # the fp32 blocks written
            nbytes = (len(set(rb_np)) + len(set(cb_np))) * t * 256 * 2 + K1_N * 256 * 256 * 4
            timing = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, ms_repeat=ms2,
                          shape=f"T={t} (O,I)=({o},{i}) n={K1_N} bf16",
                          tflops=flop / (min(ms, ms2) * 1e-3) / 1e12,
                          bound=bound(nbytes, flop, "bf16"))
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
        f"kernel {timing['tflops']:.1f} TFLOP/s; bound {timing['bound'][0]:.4f} ms "
        f"({timing['bound'][1]})")
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
    nbytes = 7 * 4 * p.numel()  # p, g, m, v read; p, m, v written
    timing = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, ms_repeat=ms2,
                  shape=f"n={n} (n,256,256) fp32",
                  gbps=nbytes / (min(ms, ms2) * 1e-3) / 1e9,
                  bound=bound(nbytes, 12 * p.numel(), "fp32"))  # ~12 flops per element
    log(f"[K2 masked_adam] time at {timing['shape']}: kernel {ms:.4f} ms "
        f"(repeat {ms2:.4f}), plain {plain_ms:.4f} ms, library torch._foreach "
        f"{lib_ms:.4f} ms; kernel {timing['gbps']:.0f} GB/s of 28 B/element; bound "
        f"{timing['bound'][0]:.4f} ms ({timing['bound'][1]})")
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
    checks = [("o", o, o_ref, (f_rtol, f_atol)), ("lse", lse, lse_ref, (f_rtol, f_atol)),
              ("delta", delta, delta_ref, (f_rtol, f_atol)),
              ("dq", dq, dq_ref, (g_rtol, g_atol)), ("dk", dk, dk_ref, (g_rtol, g_atol)),
              ("dv", dv, dv_ref, (g_rtol, g_atol))]
    g = hq // hkv
    plan = k3.plan_partitions(b, s, hq, hkv) if dtype == "bf16" else 1
    info = {"P": plan}
    if dtype == "bf16" and g > 1:
        # the partials at a P > 1 (the plan's, else 2), the reduce alone
        # against its plain version, the whole against the plain dK/dV;
        # a dropped q-head partition must be rejected; two launches equal
        # bit for bit
        pf = plan if plan > 1 else min(p for p in range(2, g + 1) if g % p == 0)
        ws = k3.attn_bwd_dkdv_partials(q, k, v, do, lse_ref, delta, sm, pf)
        dk_p, dv_p = k3.attn_bwd_dkdv_reduce(ws, k.dtype)
        red_ref = k3.attn_bwd_dkdv_reduce_plain(ws, k.dtype)
        torch.cuda.synchronize()
        errs["reduce"] = max(float((x.float() - y.float()).abs().max())
                             for x, y in zip((dk_p, dv_p), red_ref))
        # both round the same fp32 sum (in another order) to bf16 once
        if errs["reduce"] > 2.0 ** -7 * max(float(y.float().abs().max()) for y in red_ref):
            raise AssertionError(f"K3 attn_bwd_dkdv_reduce: max abs err {errs['reduce']:.3e}")
        checks += [(f"dk P={pf}", dk_p, dk_ref, (g_rtol, g_atol)),
                   (f"dv P={pf}", dv_p, dv_ref, (g_rtol, g_atol))]
        dropped = ws.clone()
        dropped[:, 0] = 0
        for name, got, want in zip(("dk", "dv"), k3.attn_bwd_dkdv_reduce(dropped, k.dtype),
                                   (dk_ref, dv_ref)):
            if torch.allclose(got.float(), want.float(), rtol=g_rtol, atol=g_atol):
                raise AssertionError(f"K3 {name}: the check passes a planted fault, q-head "
                                     f"partition 0 of {pf} dropped")
        info["fault_P"] = pf
        again = k3.attn_bwd_dkdv(q, k, v, do, lse_ref, delta, sm)
        if not (torch.equal(again[0], dk) and torch.equal(again[1], dv)):
            raise AssertionError("K3 attn_bwd_dkdv: two launches differ")
        info["repeat_equal"] = True
        del ws, dropped, again
    for name, got, want, (rtol, atol) in checks:
        assert got.shape == want.shape and got.dtype == want.dtype, name
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m, name=name: f"K3 {name}: {m}")
        errs[name] = float((got.float() - want.float()).abs().max())
    per_kernel = {"attn_fwd": max(errs["o"], errs["lse"]), "attn_bwd_delta": errs["delta"],
                  "attn_bwd_dkdv": max(v_ for n, v_ in errs.items() if n[:2] in ("dk", "dv")),
                  "attn_bwd_dkdv_reduce": errs.get("reduce", 0.0), "attn_bwd_dq": errs["dq"]}
    return errs, per_kernel, info, (q, k, v, do, sm, o_ref, lse_ref, delta)


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
    t["bwd_kernels_sum"] = tuple(sum(t[n][i] for n in ("attn_bwd_delta", "attn_bwd_dkdv",
                                                       "attn_bwd_dq")) for i in (0, 1))
    t["attn_fwd_repeat"] = time_ms(lambda: k3.attn_fwd(q, k, v, sm))
    b, s, hq, _ = q.shape
    g = hq // k.shape[2]
    plan = k3.plan_partitions(b, s, hq, k.shape[2])
    # dK/dV with its reduce at every partition count; the reduce alone
    t["dkdv_by_P"] = {p: time_ms(lambda p=p: k3.attn_bwd_dkdv(q, k, v, do, lse, delta, sm,
                                                              partitions=p))
                      for p in range(1, g + 1) if g % p == 0}
    if plan > 1:
        ws = k3.attn_bwd_dkdv_partials(q, k, v, do, lse, delta, sm, plan)
        t["attn_bwd_dkdv_reduce"] = (time_ms(lambda: k3.attn_bwd_dkdv_reduce(ws, k.dtype)),
                                     time_ms(lambda: k3.attn_bwd_dkdv_reduce_plain(ws, k.dtype)))
        del ws
    else:
        t["attn_bwd_dkdv_reduce"] = (None, None)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, H, S, hd)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    t["sdpa_fwd"] = time_ms(sdpa)
    # SDPA's backward alone, on a retained graph
    sq, sk, sv = (x.detach().requires_grad_() for x in (qs, ks, vs))
    out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    t["sdpa_bwd"] = time_ms(lambda: torch.autograd.grad(out, (sq, sk, sv), dos,
                                                        retain_graph=True))
    del out, sq, sk, sv
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


def _k3_bounds(b, s, hq, hkv, hd, dtype, partitions=1):
    """{kernel: bound()} from the shapes: causal (query, key) pairs, each
    input read once and each output written once."""
    e = 2 if dtype == "bf16" else 4
    pairs = b * hq * s * (s + 1) / 2
    qb, kvb, vec = b * s * hq * hd * e, b * s * hkv * hd * e, b * hq * s * 4
    out = {
        "attn_fwd": bound(2 * qb + 2 * kvb + vec, 4 * hd * pairs, dtype),
        "attn_bwd_delta": bound(2 * qb + vec, 2 * b * s * hq * hd, dtype),
        "attn_bwd_dkdv": bound(2 * qb + 4 * kvb + 2 * vec, 8 * hd * pairs, dtype),
        "attn_bwd_dq": bound(3 * qb + 2 * kvb + 2 * vec, 6 * hd * pairs, dtype),
    }
    if partitions > 1:  # the reduce: P fp32 partials of dK and dV read, dK and dV written
        n = b * s * hkv * hd
        out["attn_bwd_dkdv_reduce"] = bound(2 * partitions * n * 4 + 2 * kvb,
                                            2 * (partitions - 1) * n, "fp32")
    return out


def check_attention():
    """K3 at K3_SHAPES: o, lse, delta, dq, dk, dv against the plain versions;
    times at the first K3_TIMED shapes. Returns ({kernel: worst err},
    {kernel: (ms, plain_ms, bound, library ms or None)} at the main shape)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    worst = {n: 0.0 for n in K3_KERNELS}
    main_times = None
    for i, (b, s, hq, hkv, hd, dtype, what) in enumerate(K3_SHAPES):
        errs, per_kernel, info, args = _k3_case(b, s, hq, hkv, hd, dtype, rng)
        for n, e in per_kernel.items():
            worst[n] = max(worst[n], e)
        shape = f"b{b} s{s} hq{hq} hkv{hkv} hd{hd} {dtype}"
        log(f"[K3 attention] {shape} ({what}): planned partitions P={info['P']}; max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + (f"; planted fault rejected: q-head partition 0 of {info['fault_P']} dropped; "
               f"two launches equal bit for bit" if "fault_P" in info else ""))
        if i < K3_TIMED:
            t = _k3_times(*args)
            red = t["attn_bwd_dkdv_reduce"]
            log(f"[K3 attention] time at {shape}: " + "; ".join(
                f"{n} {t[n][0]:.4f} ms (plain {t[n][1]:.4f})"
                for n in ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq",
                          "bwd_kernels_sum")) +
                (f"; attn_bwd_dkdv_reduce alone {red[0]:.4f} ms (plain {red[1]:.4f})"
                 if red[0] is not None else "") +
                f"; fwd repeat {t['attn_fwd_repeat']:.4f}; torch SDPA fwd {t['sdpa_fwd']:.4f}, "
                f"bwd {t['sdpa_bwd']:.4f}")
            log(f"[K3 attention] dK/dV with its reduce by partitions at {shape}: " + ", ".join(
                f"P={p} {ms:.4f} ms" for p, ms in t["dkdv_by_P"].items()))
            log(f"[K3 attention] fwd+bwd at {shape}: " + "; ".join(
                f"{n} {t['fwd_bwd_ms'][n]:.4f} ms, peak {t['fwd_bwd_peak_gib'][n]:.3f} GiB"
                for n in t["fwd_bwd_ms"]))
            bounds = _k3_bounds(b, s, hq, hkv, hd, dtype, info["P"])
            log(f"[K3 attention] bound at {shape}: " + "; ".join(
                f"{n} {ms:.4f} ms ({by})" for n, (ms, by) in bounds.items()))
            if main_times is None:
                main_times = {n: (*t[n], bounds[n], t["sdpa_fwd"] if n == "attn_fwd" else None)
                              for n in K3_KERNELS if t[n][0] is not None}
        del args
        torch.cuda.empty_cache()
    return worst, main_times


def _k7_inputs(b, t, hq, hkv, hd, s, ci, qdt, cdt, rng):
    """q, a cache with its slots written, and a slot mask with a ragged left
    pad (up to 64 slots; in a prefill, pad query rows that see no slot) and,
    in decode, a few masked slots in between (the greedy loop's finished
    rows)."""
    import numpy as np
    import torch
    dev, dt = torch.device("cuda"), {"bf16": torch.bfloat16, "fp32": torch.float32}
    q = torch.from_numpy(rng.standard_normal((b, t, hq, hd), dtype=np.float32)).to(dev, dt[qdt])
    kf = rng.standard_normal((b, hkv, s, hd), dtype=np.float32)
    vf = rng.standard_normal((b, hkv, s, hd), dtype=np.float32)
    if cdt == "int8":
        ks = np.abs(kf).max(-1) / 127.0 + 1e-10
        vs = np.abs(vf).max(-1) / 127.0 + 1e-10
        kv = {"k": np.round(kf / ks[..., None]).astype(np.int8),
              "v": np.round(vf / vs[..., None]).astype(np.int8),
              "ks": ks[:, :, None, :].astype(np.float32),
              "vs": vs[:, :, None, :].astype(np.float32)}
        kv = {n: torch.from_numpy(a).to(dev) for n, a in kv.items()}
    else:
        kv = {"k": torch.from_numpy(kf).to(dev, dt[cdt]),
              "v": torch.from_numpy(vf).to(dev, dt[cdt])}
    sm = np.zeros((b, s), np.int32)
    for i in range(b):
        start = int(rng.integers(0, min(64, ci + t)))
        sm[i, start:ci + t] = 1
        if t == 1:
            sm[i, start:ci][rng.random(ci - start) < 0.05] = 0
    return q, kv, torch.from_numpy(sm).to(dev)


def _k7_bound(q, kv, sm, ci):
    """bound() of one call from its inputs: the query rows' visible
    (slot, head) pairs for the operations; q read and o written once, and
    of the cache only the slots some token of the row sees (K, V and an
    int8 cache's scales), plus the slot mask up to the last new token."""
    from sparse_matrix_tuning_tpu_torch.ops.cuda.cached_attention import visible_slots
    b, t, hq, hd = q.shape
    hkv = kv["k"].shape[1]
    vis = visible_slots(sm, ci, t)                      # (B, T, S)
    pairs = float(vis.sum()) * hq
    slots = float(vis.any(1).sum()) * hkv             # (b, kv-head, slot) read
    nbytes = 2 * q.numel() * q.element_size() + 2 * slots * hd * kv["k"].element_size() \
        + (2 * slots * 4 if "ks" in kv else 0) + b * (ci + t) * 4
    return bound(nbytes, 4 * hd * pairs, "bf16" if q.element_size() == 2 else "fp32")


def _k7_close(got, want, qdt):
    """(within the tolerance, max abs err, the limit in words): K7_TOL's
    rtol/atol for an fp32 q, K7_BF16_REL x max |want| for a bf16 q."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if qdt == "bf16":
        limit = K7_BF16_REL * float(want.float().abs().max())
        return err <= limit, err, f"limit {K7_BF16_REL} x max |o| = {limit:.3e}"
    rtol, atol = K7_TOL[qdt]
    return bool((diff <= atol + rtol * want.float().abs()).all()), err, f"rtol {rtol}, atol {atol}"


def _k7_faults(args, want):
    """Planted faults, which the check must reject, as the plain version
    computes them: half the output; the last 64-slot key tile of the visible
    range skipped; in a decode step, the masked slots between a row's first
    visible slot and the new token attended."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda.cached_attention import cached_attention_plain
    q, k, v, ks, vs, sm, ci, scale = args
    end = ci + q.shape[1]
    skipped = sm.clone()
    skipped[:, (end - 1) // 64 * 64:end] = 0
    faults = {"half the output": 0.5 * want.float(),
              "last key tile skipped": cached_attention_plain(q, k, v, ks, vs, skipped, ci, scale)}
    if q.shape[1] == 1:
        slots = torch.arange(sm.shape[1], device=sm.device)
        opened = ((sm.cumsum(1) > 0) & (slots < end)).to(sm.dtype)
        faults["masked slots attended"] = cached_attention_plain(q, k, v, ks, vs, opened, ci,
                                                                 scale)
    return faults


def check_cached_attention():
    """K7 at K7_SHAPES against its plain version; times at the timed shapes
    beside the plain version, torch SDPA with a boolean mask (a library
    reference for the time only; a float cache of q's dtype) and the bound.
    Returns ({kernel: worst err}, {kernel: (ms, plain_ms, bound, library ms)}
    at the first shape of each body, the eval decode)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7

    rng = np.random.default_rng(7)
    worst = {n: 0.0 for n in K7_KERNELS}
    main = {}
    for b, t, hq, hkv, hd, s, ci, qdt, cdt, what, timed in K7_SHAPES:
        q, kv, sm = _k7_inputs(b, t, hq, hkv, hd, s, ci, qdt, cdt, rng)
        name = "cached_attn_q8" if cdt == "int8" else "cached_attn"
        args = (q, kv["k"], kv["v"], kv.get("ks"), kv.get("vs"), sm, ci, 1.0 / hd ** 0.5)
        got = k7.cached_attention_kernel(*args)
        torch.cuda.synchronize()
        want = k7.cached_attention_plain(*args)
        if not torch.isfinite(got).all():
            raise AssertionError(f"K7 {what}: non-finite output")
        ok, err, limit = _k7_close(got, want, qdt)
        if not ok:
            raise AssertionError(f"K7 {what}: max abs err {err:.3e} against the plain "
                                 f"version, over the limit ({limit})")
        rejected = {}
        faults = _k7_faults(args, want)
        rows, kend = t * (hq // hkv), k7.visible_end(t, ci, s)
        plan = k7.plan_splits(b, hkv, rows, hd, kend, q.dtype)
        max_splits = -(-kend // k7.cta_slots(hd, rows))
        split_note = f"planned splits {plan}"
        if qdt == "bf16" and rows <= k7.cta_rows(rows) and max_splits > 1:
            # the split kernel at a count > 1 (the plan's, else 2): the
            # combine alone against its plain version, the whole against
            # the plain attention; a dropped split must be rejected; two
            # launches equal bit for bit
            sf = plan if plan > 1 else 2
            ws = k7.cached_attention_partials(*args, splits=sf)
            got_s = k7.cached_attn_combine(*ws, q.dtype)
            comb_ref = k7.cached_attn_combine_plain(*ws, q.dtype)
            torch.cuda.synchronize()
            comb_err = float((got_s.float() - comb_ref.float()).abs().max())
            ok_c, _, _ = _k7_close(got_s, comb_ref, qdt)
            ok_s, err_s, _ = _k7_close(got_s, want, qdt)
            if not (ok_c and ok_s):
                raise AssertionError(f"K7 {what}: at {sf} splits, max abs err {err_s:.3e} "
                                     f"against the plain version, combine {comb_err:.3e} "
                                     f"against its plain version ({limit})")
            worst["cached_attn_combine"] = max(worst["cached_attn_combine"], comb_err)
            err = max(err, err_s)
            dropped = tuple(x.clone() for x in ws)
            dropped[0][0], dropped[1][0], dropped[2][0] = 0.0, float("-inf"), 0.0
            faults[f"split 0 of {sf} dropped"] = k7.cached_attn_combine(*dropped, q.dtype)
            again = k7.cached_attention_kernel(*args, splits=sf)
            if not torch.equal(again, got_s):
                raise AssertionError(f"K7 {what}: two launches at {sf} splits differ")
            split_note += (f"; at {sf} splits max_abs_err {err_s:.3e}, combine {comb_err:.3e}, "
                           "two launches equal bit for bit")
            del ws, dropped, again, got_s
        for fault, out in faults.items():
            if _k7_close(out, want, qdt)[0]:
                raise AssertionError(f"K7 {what}: the check passes a planted fault, {fault}")
            rejected[fault] = float((out.float() - want.float()).abs().max())
        worst[name] = max(worst[name], err)
        shape = f"b{b} t{t} hq{hq} hkv{hkv} hd{hd} s{s} ci{ci} {qdt} q, {cdt} cache"
        log(f"[K7 cached_attn] {shape} ({what}): max_abs_err {err:.3e}, max |o| "
            f"{float(want.float().abs().max()):.3e} ({limit}); {split_note}; planted faults "
            "rejected: " + ", ".join(f"{n} (max abs err {e:.3e})" for n, e in rejected.items()))
        if timed:
            if plan > 1 or (qdt == "bf16" and rows <= k7.cta_rows(rows) and max_splits > 1):
                by_split = {n: time_ms(lambda n=n: k7.cached_attention_kernel(*args, splits=n))
                            for n in sorted({1, 2, 4, 8, plan}) if n <= max_splits}
                log(f"[K7 cached_attn] time by splits at {shape}: " + ", ".join(
                    f"{n} {ms:.4f} ms" for n, ms in by_split.items()))
            if plan > 1 and "cached_attn_combine" not in main:
                ws = k7.cached_attention_partials(*args, splits=plan)
                comb = (time_ms(lambda: k7.cached_attn_combine(*ws, q.dtype)),
                        time_ms(lambda: k7.cached_attn_combine_plain(*ws, q.dtype)))
                nbytes = sum(x.numel() * 4 for x in ws) + q.numel() * q.element_size()
                comb_bnd = bound(nbytes, 3 * ws[0].numel(), "fp32")
                log(f"[K7 cached_attn_combine] time at {shape}, {plan} splits: kernel "
                    f"{comb[0]:.4f} ms, plain {comb[1]:.4f} ms; bound {comb_bnd[0]:.4f} ms "
                    f"({comb_bnd[1]})")
                main.setdefault("cached_attn_combine", (*comb, comb_bnd, None))
                del ws
            ms = time_ms(lambda: k7.cached_attention_kernel(*args))
            plain_ms = time_ms(lambda: k7.cached_attention_plain(*args), reps=5)
            lib_ms = None
            if cdt != "int8":
                mask = k7.visible_slots(sm, ci, t)[:, None]   # (B, 1, T, S)
                qs = q.transpose(1, 2)
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, kv["k"], kv["v"], attn_mask=mask, enable_gqa=True))
            ms2 = time_ms(lambda: k7.cached_attention_kernel(*args))
            bnd = _k7_bound(q, kv, sm, ci)
            log(f"[K7 cached_attn] time at {shape}: kernel {ms:.4f} ms (repeat {ms2:.4f}), "
                f"plain {plain_ms:.4f} ms, torch SDPA with a boolean mask "
                f"{'n/a (int8 cache)' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
                f"bound {bnd[0]:.4f} ms ({bnd[1]})")
            main.setdefault(name, (ms, plain_ms, bnd, lib_ms))
        del q, kv, sm, args, got, want
        torch.cuda.empty_cache()
    return worst, main


def _k4_case(form, w, wq, sw, t, dtype, gen):
    """One K4 form at one shape: the kernel against its plain version
    (bitwise), the planted fault, the other scale order, and the closures
    the timings call. Returns (max abs err, info, closures)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
    from sparse_matrix_tuning_tpu_torch.ops.quant import row_quant

    o, k = w.shape
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    t_form = form == "q8mm_t"
    act = torch.randn((t, k if t_form else o), generator=gen, device=w.device).to(dt)
    wb, ab = w.to(torch.bfloat16), act.to(torch.bfloat16)
    if t_form:
        aq, sa = row_quant(act)
        kernel = lambda: k4.q8mm_t(aq, sa, wq, sw, dt)
        plain = lambda a=aq: k4.q8mm_t_plain(a, sa, wq, sw, dt)
        lib = lambda: ((torch._int_mm(aq, wq.t()).float() * sa) * sw).to(dt)
        cublas = lambda: torch.matmul(ab, wb.t())
    else:
        aq, sa = row_quant(act.float() * sw)
        kernel = lambda: k4.q8mm_g(aq, sa, wq, dt)
        plain = lambda a=aq: k4.q8mm_g_plain(a, sa, wq, dt)
        lib = lambda: (torch._int_mm(aq, wq).float() * sa).to(dt)
        cublas = lambda: torch.matmul(ab, wb)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    n_out = o if t_form else k
    if got.shape != (t, n_out) or got.dtype != dt or not torch.isfinite(got).all():
        raise AssertionError(f"K4 {form}: output {tuple(got.shape)} {got.dtype}")
    err = float((got.float() - want.float()).abs().max())
    # the int32 product is exact and both apply (acc * sx) * sw in fp32 and
    # round once to the output type: every bit must agree
    if not torch.equal(got, want):
        n_diff = int((got != want).sum())
        raise AssertionError(f"K4 {form} T={t} K={k} O={o} {dtype}: {n_diff} elements differ "
                             f"from the plain version, max abs err {err:.3e}")
    cut = aq.clone()
    cut[:, -64:] = 0                           # the planted fault: the last K tile skipped
    fault = plain(cut)
    if torch.equal(fault, want):
        raise AssertionError(f"K4 {form}: the check passes a planted fault (last K tile skipped)")
    info = f"fault rejected (max abs err {float((fault.float() - want.float()).abs().max()):.3e})"
    if t_form:  # not a fault unless it changes a bit: count the bits it changes
        acc = k4._exact_int_product(aq, wq, contract_rows=False).float()
        swapped = ((acc * sw) * sa).to(dt)
        info += (f"; sw applied before sx changes {int((swapped != want).sum())} of "
                 f"{want.numel()} elements")
    return err, info, (kernel, plain, lib, cublas)


def check_q8_matmul():
    """K4 at K4_SHAPES, both forms, bitwise against the plain version, with
    the planted fault; times at the timed shapes beside the plain version,
    the library (torch._int_mm plus the scale pass), cuBLAS bf16 on the
    unquantized operands (what frozen_quant=none runs) and the bound.
    Returns ({kernel: worst err}, {kernel: (ms, plain_ms, bound, library ms)}
    at the first shape)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.quant import quantize_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = {n: 0.0 for n in K4_KERNELS}
    main = {}
    for t, k, o, dtype, what, timed in K4_SHAPES:
        e = 2 if dtype == "bf16" else 4
        w = torch.randn((o, k), generator=gen, device="cuda") / k ** 0.5
        wq, sw = quantize_weight(w)
        for form in K4_KERNELS:
            err, info, (kernel, plain, lib, cublas) = _k4_case(form, w, wq, sw, t, dtype, gen)
            worst[form] = max(worst[form], err)
            shape = f"T={t} K={k} O={o} {dtype} out"
            log(f"[K4 {form}] {shape} ({what}): equal to the plain version bit for bit; {info}")
            if timed:
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, reps=5)
                lib_ms = time_ms(lib)
                bf16_ms = time_ms(cublas)
                ms2 = time_ms(kernel)
                n_out = o if form == "q8mm_t" else k
                n_act = k if form == "q8mm_t" else o
                nbytes = t * n_act + o * k + 4 * t + (4 * o if form == "q8mm_t" else 0) \
                    + t * n_out * e
                bnd = bound(nbytes, 2.0 * t * o * k, "int8")
                tops = 2.0 * t * o * k / (min(ms, ms2) * 1e-3) / 1e12
                log(f"[K4 {form}] time at {shape}: kernel {ms:.4f} ms (repeat {ms2:.4f}, "
                    f"{tops:.0f} TOP/s), plain {plain_ms:.4f} ms, library torch._int_mm + "
                    f"scale pass {lib_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
                log(f"[K4 {form}] cuBLAS bf16 matmul of the unquantized operands at {shape}: "
                    f"{bf16_ms:.4f} ms")
                main.setdefault(form, (ms, plain_ms, bnd, lib_ms))
            del kernel, plain, lib, cublas
        del w, wq, sw
        torch.cuda.empty_cache()
    return worst, main


def _k5_close(got, want, dtype):
    rtol, atol = K5_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + rtol * want.float().abs()).all()), float(diff.max())


def check_block_correction():
    """K5 at K5_SHAPES: n = 24 unsorted coordinates with repeated out
    blocks, repeated in blocks and a repeated pair, through the wrapper,
    against the plain version on a copy; a planted fault (the last j of one
    run dropped) the check must reject; n = 0 leaves out untouched; times
    beside the plain version, the library (bmm on gathered panels, then
    index_add_) and the bound. Returns (worst err, (ms, plain_ms, bound,
    library ms) at the first shape)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    worst, main = 0.0, None
    for t, o, i, dtype, transpose, what, timed in K5_SHAPES:
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        out0 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev, dt)
        src = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev, dt)
        delta = torch.from_numpy(
            rng.standard_normal((K5_N, 256, 256), dtype=np.float32) * np.float32(0.02)).to(dev, dt)
        io, ii = _coords(rng, K5_N, o // 256, i // 256)
        sched = k5.correction_schedule(io, ii, dev)
        got = k5.block_correction(out0.clone(), src, delta, sched, transpose)
        torch.cuda.synchronize()
        want = k5.block_correction_plain(out0.clone(), src, delta, io, ii, transpose)
        ok, err = _k5_close(got, want, dtype)
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"K5 {what}: max abs err {err:.3e} against the plain version, "
                                 f"over rtol/atol {K5_TOL[dtype]}")
        untouched = torch.ones(o // 256, dtype=torch.bool)
        untouched[torch.from_numpy(io).long()] = False
        cols = untouched.repeat_interleave(256).to(dev)
        if not torch.equal(got[:, cols], out0[:, cols]):
            raise AssertionError(f"K5 {what}: an out block no coordinate names changed")
        # the planted fault: the run of the first coordinate's out block
        # loses its last j
        last = max(j for j in range(K5_N) if io[j] == io[0])
        keep = [j for j in range(K5_N) if j != last]
        fault = k5.block_correction_plain(out0.clone(), src, delta[keep], io[keep], ii[keep],
                                          transpose)
        f_ok, f_err = _k5_close(fault, want, dtype)
        if f_ok:
            raise AssertionError(f"K5 {what}: the check passes a planted fault (a run's last "
                                 "j dropped)")
        empty = k5.correction_schedule([], [], dev)
        same = k5.block_correction(out0.clone(), src, delta[:0], empty, transpose)
        if not torch.equal(same, out0):
            raise AssertionError(f"K5 {what}: n = 0 changed out")
        worst = max(worst, err)
        shape = f"T={t} out {o} src {i} n={K5_N} {dtype} {'D^T' if transpose else 'D'}"
        log(f"[K5 block_correction] {shape} ({what}): max_abs_err {err:.3e} (rtol/atol "
            f"{K5_TOL[dtype]}), {sched.n_runs} runs; planted fault rejected (max abs err "
            f"{f_err:.3e}); n = 0 leaves out untouched")
        if timed:
            buf = out0.clone()
            io_t = torch.from_numpy(io).long().to(dev)
            ii_t = torch.from_numpy(ii).long().to(dev)

            def lib():
                panels = src.reshape(t, -1, 256).index_select(1, ii_t).transpose(0, 1)
                corr = torch.bmm(panels, delta.transpose(1, 2) if transpose else delta)
                buf.view(t, -1, 256).index_add_(1, io_t, corr.transpose(0, 1))

            ms = time_ms(lambda: k5.block_correction(buf, src, delta, sched, transpose))
            plain_ms = time_ms(lambda: k5.block_correction_plain(buf, src, delta, io, ii,
                                                                 transpose), reps=5)
            lib_ms = time_ms(lib)
            ms2 = time_ms(lambda: k5.block_correction(buf, src, delta, sched, transpose))
            e = 2 if dtype == "bf16" else 4
            # touched out tiles read and written, source panels and delta read
            nbytes = (2 * len(set(io)) + len(set(ii))) * t * 256 * e + K5_N * 65536 * e
            flop = 2.0 * K5_N * t * 65536
            bnd = bound(nbytes, flop, dtype)
            log(f"[K5 block_correction] time at {shape}: kernel {ms:.4f} ms (repeat {ms2:.4f}, "
                f"{flop / (min(ms, ms2) * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"library bmm on gathered panels + index_add_ {lib_ms:.4f} ms; bound "
                f"{bnd[0]:.4f} ms ({bnd[1]})")
            if main is None:
                main = (ms, plain_ms, bnd, lib_ms)
        torch.cuda.empty_cache()
    return worst, main


def _k6_limit(x, w4, s4, splits, want):
    """Elementwise limit on |K6 - plain| at one shape. Both sum the same
    exact products (a bf16 value times a small integer) in fp32 in another
    order: the 128 of a group, the n_groups scaled partials and, in the
    kernel, the splits. Recursive summation of n terms errs by at most
    (n - 1) u sum |terms| to first order, so the two differ by at most
    2 n u S, S = sum_g |s_g| sum_c |x_c q_c|, n = 128 + n_groups + splits,
    with u = 2^-23 (not 2^-24: the tensor cores' adder may truncate). A bf16
    output adds one rounding of each: one bf16 ulp, 2^-7 |want|."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda.q4_matmul import unpack_planes
    t, (o, _), n_groups = x.shape[0], w4.shape, s4.shape[1]
    qa = torch.cat(unpack_planes(w4), dim=1).abs().float()
    mag = torch.einsum("tgc,ogc->tgo", x.float().abs().reshape(t, n_groups, -1),
                       qa.reshape(o, n_groups, -1))
    mag = (mag * s4.abs().t()[None]).sum(dim=1)
    limit = 2 * (128 + n_groups + splits) * 2.0 ** -23 * mag
    if want.dtype == torch.bfloat16:
        limit = limit + 2.0 ** -7 * want.float().abs()
    return limit


def check_q4_matmul():
    """K6 at K6_SHAPES against its plain version within _k6_limit, with two
    planted faults the check must reject (the low and high nibble planes
    swapped; the last group's scale dropped); K6s, K6 on the layer views of
    a stack, against the plain version of each layer; times at the timed
    shapes beside the plain version, cuBLAS bf16 on the dequantized weight
    (the library call), dequantize + matmul (the int4 path without the
    kernel) and the bound. Returns (worst max abs err, (ms, plain_ms, bound,
    library ms) at the first timed shape)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q4_matmul as k6
    from sparse_matrix_tuning_tpu_torch.ops.quant import (
        dequantize_weight_int4, quantize_weight_int4)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, main = 0.0, None

    def held(got, want, x, w4, s4):
        limit = _k6_limit(x, w4, s4, k6.splits_for(w4.shape[0], w4.shape[1], n_sm), want)
        diff = (got.float() - want.float()).abs()
        return bool((diff <= limit).all()), float(diff.max()), float((diff / limit).max())

    for t, i, o, dtype, what, timed in K6_SHAPES:
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        w4, s4 = quantize_weight_int4(torch.randn((o, i), generator=gen, device="cuda") / i ** 0.5)
        x = torch.randn((t, i), generator=gen, device="cuda").to(torch.bfloat16)
        got = k6.q4mm_t(x, w4, s4, dt)
        torch.cuda.synchronize()
        want = k6.q4mm_t_plain(x, w4, s4, dt)
        ok, err, ratio = held(got, want, x, w4, s4)
        if got.shape != (t, o) or got.dtype != dt or not torch.isfinite(got).all() or not ok:
            raise AssertionError(f"K6 T={t} I={i} O={o} {dtype}: max abs err {err:.3e}, "
                                 f"{ratio:.2f} x the limit, output {tuple(got.shape)} {got.dtype}")
        p = w4.view(torch.uint8)
        swapped = (((p & 0x0F) << 4) | (p >> 4)).view(torch.int8)
        no_last = s4.clone()
        no_last[:, -1] = 0
        for fault, args in (("planes swapped", (swapped, s4)), ("last group's scale dropped",
                                                                (w4, no_last))):
            f_ok, f_err, _ = held(k6.q4mm_t_plain(x, *args, dt), want, x, w4, s4)
            if f_ok:
                raise AssertionError(f"K6 T={t} I={i} O={o}: the check passes a planted fault "
                                     f"({fault})")
        worst = max(worst, err)
        shape = f"T={t} I={i} O={o} {dtype} out"
        log(f"[K6 q4_matmul] {shape} ({what}): max_abs_err {err:.3e} ({ratio:.3f} of the "
            f"summation-order limit), splits {k6.splits_for(o, i // 2, n_sm)}; planted faults "
            "rejected (planes swapped, last group's scale dropped)")
        if timed:
            wdq = dequantize_weight_int4(w4, s4, torch.bfloat16)
            kernel = lambda: k6.q4mm_t(x, w4, s4, dt)
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: k6.q4mm_t_plain(x, w4, s4, dt), reps=5)
            lib_ms = time_ms(lambda: torch.matmul(x, wdq.t()))
            deq_ms = time_ms(lambda: torch.matmul(x, dequantize_weight_int4(w4, s4,
                                                                            torch.bfloat16).t()))
            ms2 = time_ms(kernel)
            e = 2 if dtype == "bf16" else 4
            nbytes = 2 * t * i + w4.numel() + 4 * s4.numel() + e * t * o
            bnd = bound(nbytes, 2.0 * t * o * i, "bf16")
            log(f"[K6 q4_matmul] time at {shape}: kernel {ms:.4f} ms (repeat {ms2:.4f}, "
                f"{nbytes / (min(ms, ms2) * 1e-3) / 1e9:.0f} GB/s of {nbytes / 1e6:.2f} MB), "
                f"plain {plain_ms:.4f} ms, library cuBLAS bf16 on the dequantized weight "
                f"{lib_ms:.4f} ms, dequantize + matmul {deq_ms:.4f} ms; bound {bnd[0]:.4f} ms "
                f"({bnd[1]})")
            if main is None:
                main = (ms, plain_ms, bnd, lib_ms)
            del wdq, kernel
        del w4, s4, x, got, want, swapped, no_last
        torch.cuda.empty_cache()

    # K6s: the kernel on contiguous layer views of an (L, O, I/2) stack
    n_layers, t, i, o = K6_STACK
    per_layer = [quantize_weight_int4(torch.randn((o, i), generator=gen, device="cuda") / i ** 0.5)
                 for _ in range(n_layers)]
    w4s = torch.stack([w for w, _ in per_layer])
    s4s = torch.stack([s for _, s in per_layer])
    x = torch.randn((t, i), generator=gen, device="cuda").to(torch.bfloat16)
    for l in range(1, n_layers):
        got = k6.q4mm_t(x, w4s[l], s4s[l], torch.bfloat16)
        torch.cuda.synchronize()
        want = k6.q4mm_t_plain(x, *per_layer[l], torch.bfloat16)
        ok, err, ratio = held(got, want, x, *per_layer[l])
        other = k6.q4mm_t_plain(x, *per_layer[l - 1], torch.bfloat16)
        if not ok or held(other, want, x, *per_layer[l])[0]:
            raise AssertionError(f"K6s layer {l}: max abs err {err:.3e} against the layer's plain "
                                 "version (or the check cannot tell the layers apart)")
        worst = max(worst, err)
        log(f"[K6s q4_matmul on a layer view] stack {tuple(w4s.shape)}, layer {l}, T={t}: "
            f"max_abs_err {err:.3e} ({ratio:.3f} of the limit); layer {l - 1}'s weights rejected")
    return worst, main


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def reset_launches():
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7
    from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q4_matmul as k6
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    k5.LAUNCHES = 0
    k6.LAUNCHES = 0
    for counts in (k3.LAUNCHES, k7.LAUNCHES, k4.LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches():
    """Every kernel's launch count since the last reset_launches()."""
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7
    from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q4_matmul as k6
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
    return {"block_grad": k1.LAUNCHES, "masked_adam": k2.LAUNCHES, **k3.LAUNCHES,
            **k7.LAUNCHES, **k4.LAUNCHES, "block_correction": k5.LAUNCHES,
            "q4_matmul": k6.LAUNCHES}


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
                  ratios=(0.0084, 0.0084), attn_impl="auto", out_dir=None, log_fn=log,
                  keep_decode_params=False, frozen_quant="none", loss_impl="auto"):
    """SMTTrainer.fit through warm-up -> conversion -> sparse -> eval ->
    final export, with per-phase step times and peak memory. Checks
    finiteness, a non-empty plan, the merged weights (frozen ones bitwise
    the conversion-time weights, selected blocks the trainables), the
    export against merged_params(), and, with frozen_quant="int8" (host
    offload and the int8 head follow), that no dense layer weight or head
    is left on the device. Returns a summary, with trainer.decode_params()
    under "decode_params" if asked for."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree, init_params
    from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK
    from sparse_matrix_tuning_tpu_torch.train.steps import _use_chunked_loss
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
        attn_impl=attn_impl, output_dir=out_dir, frozen_quant=frozen_quant,
        loss_impl=loss_impl)
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
    summary["loss_path"] = {
        phase: "chunked" if _use_chunked_loss(cfg, model_cfg, sparse=sparse,
                                              batch_tokens=bs * (seq - 1)) else "full"
        for phase, sparse in (("warmup", False), ("sparse", True))}
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
            at_conversion = trainer.merged_params()
            snap["params"] = {li: {m: w.to("cpu") for m, w in layer.items()}
                              for li, layer in at_conversion["layers"].items()}
            snap["lm_head"] = at_conversion["lm_head"].to("cpu")
            del at_conversion
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

    # int8 frozen base with host offload: no dense (O, I) layer weight and
    # no head is left on the device, only their 1-element placeholders
    summary["offloaded"] = None
    if frozen_quant == "int8":
        dense = [f"{li}.{m}" for li, layer in trainer.state["params"]["layers"].items()
                 for m, w in layer.items() if w.dim() == 2]
        if dense or trainer.state["params"]["lm_head"].dim() == 2:
            raise AssertionError(f"dense weights left on the device after conversion: "
                                 f"{dense[:4]}, lm_head {trainer.state['params']['lm_head'].shape}")
        if "q" not in trainer.state or "q_head" not in trainer.state:
            raise AssertionError("the int8 run has no int8 base or no int8 head in its state")
        summary["offloaded"] = len(trainer._host_frozen)

    # merged weights: bitwise the conversion-time weights outside the
    # selected blocks, the trainables (in the param dtype) inside them
    merged = trainer.merged_params()
    after = merged["layers"]
    if not torch.equal(merged["lm_head"].to("cpu"), snap["lm_head"]):
        raise AssertionError("the merged lm_head differs from the conversion-time head")
    checked, changed_in_blocks, block_elems = 0, 0, 0
    for li, layer in snap["params"].items():
        for mod, before in layer.items():
            w = after[li][mod].to("cpu")
            ks = f"{li}.{mod}"
            lp = plan.linears.get(ks)
            if lp is None:
                if not torch.equal(w, before):
                    raise AssertionError(f"frozen weight {li}.{mod} changed")
            else:
                mask = torch.zeros(before.shape, dtype=torch.bool)
                for rb, cb in lp.blocks:
                    mask[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = True
                if not torch.equal(w[~mask], before[~mask]):
                    raise AssertionError(f"{li}.{mod} changed outside its selected blocks")
                w4 = w.view(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
                rbs, cbs = plan.block_index(ks, "cpu")
                blocks = trainer.state["trainable"][ks].detach().to("cpu", w.dtype)
                if not torch.equal(w4[rbs, :, cbs, :], blocks):
                    raise AssertionError(f"{li}.{mod}: selected blocks differ from the trainables")
                changed_in_blocks += int((w[mask] != before[mask]).sum())
                block_elems += int(mask.sum())
            checked += 1
    summary["frozen_checked"] = checked
    summary["selected_elems_changed"] = (changed_in_blocks, block_elems)

    # export: the final safetensors read back equal merged_params() bitwise
    export = None
    if out_dir:
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
    if keep_decode_params:
        summary["decode_params"] = trainer.decode_params()
    return summary


def check_small_reference(frozen_quant="none", loss_impl="auto"):
    """Tiny fp32 two-phase run on the GPU (attn_impl "auto": K3) against the
    same run on the CPU (plain versions, einsum attention): losses and plan
    must agree, and every kernel of the path must have launched on the GPU.
    With frozen_quant="int8" the sparse phase runs K4 and K5 (with
    loss_impl="chunked", K4 also on the loss's ragged T = bs * (seq - 1)). The bf16 base holds
    the losses to rtol 1e-4. The int8 base to 1e-3: its integer products are
    exact on both devices, but an activation that differs in its last fp32
    bit between them can round to the neighbouring int8 step."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(vocab_size=512)
    kw = dict(dtype="fp32", bs=4, seq=64, full_ft_steps=2, sparse_steps=4,
              eval_batches=1, ratios=(0.05, 0.05), log_fn=lambda m: None,
              frozen_quant=frozen_quant, loss_impl=loss_impl)
    gpu = run_main_path(cfg, "cuda", **kw)
    cpu = run_main_path(cfg, "cpu", **kw)
    int8 = frozen_quant == "int8"
    np.testing.assert_allclose(gpu["loss"] + [gpu["eval_loss"]], cpu["loss"] + [cpu["eval_loss"]],
                               rtol=1e-3 if int8 else 1e-4)
    if gpu["plan"]["fingerprint"] != cpu["plan"]["fingerprint"]:
        raise AssertionError("tiny run: GPU and CPU plans differ")
    # fp32 attention walks each group whole: no partitions, no reduce
    needed = tuple(n for n in TRAIN_KERNELS if n != "attn_bwd_dkdv_reduce") + (
        Q8_KERNELS if int8 else ())
    if not all(gpu["launches"][n] > 0 for n in needed):
        raise AssertionError(f"tiny GPU run did not launch every kernel: {gpu['launches']}")
    worst = float(np.max(np.abs(np.array(gpu["loss"]) - np.array(cpu["loss"]))
                         / np.abs(np.array(cpu["loss"]))))
    log(f"[reference] tiny fp32 run, frozen_quant {frozen_quant}, loss {gpu['loss_path']}, GPU "
        f"kernels vs CPU plain: losses {gpu['loss']} (worst rel diff {worst:.2e}), eval loss "
        f"{gpu['eval_loss']:.6f} vs {cpu['eval_loss']:.6f}, same plan "
        f"{gpu['plan']['fingerprint'][:16]}, GPU launches {gpu['launches']}")


def report_run(tag, what, s, n_warmup):
    """Per-phase ms/step, peak memory and launches of one trainer run."""
    gib = 1024 ** 3
    warm, sparse = s["step_ms"][:n_warmup], s["step_ms"][n_warmup:]
    log(f"[{tag}] {what}: losses {s['loss']}, eval loss {s['eval_loss']:.4f}; loss path "
        f"{s['loss_path']}")
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
        f"{s['selected_elems_changed'][1]}, selected blocks equal to the trainables"
        + (f"; {s['offloaded']} dense weights offloaded to the host, none left on the device"
           if s["offloaded"] is not None else ""))
    log(f"[{tag}] kernel launches: {s['launches']} (warm-up: {s['launches_warmup']})")


# ---------------------------------------------------------------------------
# generation eval
# ---------------------------------------------------------------------------

def check_small_generation():
    """Tiny fp32 model, left-padded ragged prompts: greedy and beam-4 with
    repetition penalty 1.1 over an fp32, a bf16 and an int8 cache, on the
    GPU (K7) and on the CPU (its plain version): the tokens must be
    identical, and the GPU runs must launch K7."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig, generate
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params, tree_map

    cfg = LlamaConfig.tiny(vocab_size=512)
    cpu_params = init_params(cfg, seed=0)
    gpu_params = tree_map(lambda p: p.to("cuda"), cpu_params)
    rng = np.random.default_rng(5)
    lens = (5, 17, 30, 9)
    ids = np.zeros((len(lens), 32), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, 32 - n:] = rng.integers(3, cfg.vocab_size, n)
        mask[i, 32 - n:] = 1
    os.environ["SMT_CACHED_ATTN"] = "on"  # K7 on the GPU, its plain version on the CPU
    try:
        for cache in ("float32", "bfloat16", "int8"):
            for beams in (1, 4):
                gen = GenerationConfig(max_new_tokens=16, num_beams=beams,
                                       repetition_penalty=1.1, cache_dtype=cache)
                reset_launches()
                got = generate(gpu_params, cfg, ids, mask, gen, device="cuda")
                n = launches()["cached_attn_q8" if cache == "int8" else "cached_attn"]
                want = generate(cpu_params, cfg, ids, mask, gen, device="cpu")
                if n <= 0 or not np.array_equal(got, want):
                    raise AssertionError(f"tiny generation, {cache} cache, beams {beams}: "
                                         f"K7 launches {n}, GPU {got.tolist()} vs CPU "
                                         f"{want.tolist()}")
                log(f"[reference] tiny fp32 generation, {cache} cache, beams {beams}: "
                    f"GPU (K7, {n} launches) and CPU (plain) tokens identical, "
                    f"first row {got[0].tolist()}")
    finally:
        os.environ.pop("SMT_CACHED_ATTN", None)


class DecodeRecorder:
    """Wraps forward_with_cache and the beam search's top-k in the
    generation modules: records each forward call's last-position logits
    and each top-k's indices, on the host."""

    def __enter__(self):
        from sparse_matrix_tuning_tpu_torch.eval import _beam_impl, generate
        self.logits, self.topk = [], []
        self._mods = (generate, _beam_impl)
        self._orig = (generate.forward_with_cache, _beam_impl._top_k)
        forward, top_k = self._orig

        def recorded_forward(*args, **kw):
            out = forward(*args, **kw)
            self.logits.append(out[0][:, -1].float().cpu())
            return out

        def recorded_top_k(x, k):
            values, indices = top_k(x, k)
            self.topk.append(indices.cpu())
            return values, indices

        for m in self._mods:
            m.forward_with_cache = recorded_forward
        _beam_impl._top_k = recorded_top_k
        return self

    def __exit__(self, *exc):
        from sparse_matrix_tuning_tpu_torch.eval import _beam_impl
        for m in self._mods:
            m.forward_with_cache = self._orig[0]
        _beam_impl._top_k = self._orig[1]


def first_divergence(got, want, gpu, cpu, beams):
    """The first decision step at which two decodes of the same prompts
    chose differently (None if none): the first differing token column
    (greedy), or the step of the first beam-search top-k that picked other
    candidates (two a step: the continuations, then the hypotheses)."""
    import numpy as np
    if beams == 1:
        cols = np.nonzero((got != want).any(axis=0))[0]
        return int(cols[0]) if len(cols) else None
    for c, (a, b) in enumerate(zip(gpu.topk, cpu.topk)):
        if not np.array_equal(a.numpy(), b.numpy()):
            return c // 2
    return None


def check_small_quant_generation():
    """Tiny fp32 model written as an HF checkpoint, read back by the eval
    CLI's load_decode_params over the int8 and the int4 frozen base, with
    a plan of three linears (K5 corrects their blocks) and with the empty
    plan: greedy and beam-4 with repetition penalty 1.1 over a bf16 and an
    int8 cache, on the GPU (K4 or K6, K5, K7) and on the CPU (their plain
    versions). The GPU runs must launch the path's kernels; the tokens must
    be identical, or differ only after a decision that last-bit
    differences decide: every forward call up to that decision (identical
    inputs, identical earlier decisions) must give logits within
    QUANT_DECODE_REL of the largest. Quantized linears are not continuous
    in their input (int8 steps; K6 rounds its input to bf16), so the
    card's and the CPU's sums, which differ in their last bits, can move a
    logit by a step, and a random tiny model's next-token scores sit close
    to a tie at many steps."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.cli.run_commonsense import load_decode_params
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig, generate
    from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan

    cfg = LlamaConfig.tiny(vocab_size=512)
    plan = SMTPlan("matrix", {
        "0.q_proj": LinearPlan("q_proj", 0, 256, 256, blocks=((0, 0),)),
        "1.gate_proj": LinearPlan("gate_proj", 1, 512, 256, blocks=((1, 0), (0, 0))),
        "0.down_proj": LinearPlan("down_proj", 0, 256, 512, blocks=((0, 1),))})
    rng = np.random.default_rng(7)
    lens = (5, 17, 30, 9)
    ids = np.zeros((len(lens), 32), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, 32 - n:] = rng.integers(3, cfg.vocab_size, n)
        mask[i, 32 - n:] = 1
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_tiny_ckpt_", dir=build_dir)
    os.environ["SMT_CACHED_ATTN"] = "on"  # K7 on the GPU, its plain version on the CPU
    n_identical = n_cases = 0
    try:
        save_hf_format(init_params(cfg, seed=0), cfg, ckpt)
        for fq in ("int8", "int4"):
            for leg_plan in (plan, None):
                gpu_params, _ = load_decode_params(ckpt, fq, "fp32", "cuda", leg_plan)
                cpu_params, _ = load_decode_params(ckpt, fq, "fp32", "cpu", leg_plan)
                for cache in ("bfloat16", "int8"):
                    for beams in (1, 4):
                        gen = GenerationConfig(max_new_tokens=16, num_beams=beams,
                                               repetition_penalty=1.1, cache_dtype=cache)
                        reset_launches()
                        with DecodeRecorder() as gpu:
                            got = generate(gpu_params, cfg, ids, mask, gen, device="cuda")
                        counts = launches()
                        with DecodeRecorder() as cpu:
                            want = generate(cpu_params, cfg, ids, mask, gen, device="cpu")
                        need = ["cached_attn_q8" if cache == "int8" else "cached_attn",
                                "q4_matmul" if fq == "int4" else "q8mm_t"]
                        need += ["block_correction"] if leg_plan else []
                        what = (f"{fq} base, {'3 planned linears' if leg_plan else 'empty plan'}"
                                f", {cache} cache, beams {beams}")
                        step = first_divergence(got, want, gpu, cpu, beams)
                        n_calls = len(gpu.logits) if step is None else step + 1
                        rel = max(float((a - b).abs().max() / b.abs().max())
                                  for a, b in zip(gpu.logits[:n_calls], cpu.logits[:n_calls]))
                        identical = np.array_equal(got, want)
                        if (not all(counts[n] > 0 for n in need) or rel > QUANT_DECODE_REL
                                or (step is None and not identical)):
                            raise AssertionError(
                                f"tiny quantized generation, {what}: launches {counts}; logits "
                                f"{rel:.3e} apart (relative) over the first {n_calls} forward "
                                f"calls; GPU {got.tolist()} vs CPU {want.tolist()}")
                        log(f"[reference] tiny fp32 generation, {what}: " + (
                            "GPU and CPU tokens identical" if identical else
                            f"GPU and CPU tokens part at decision {step} of "
                            f"{gen.max_new_tokens}, a near-tie") + f"; logits up to there "
                            f"{rel:.2e} apart (relative, limit {QUANT_DECODE_REL:.2e}); GPU "
                            f"launches " + ", ".join(f"{n} {counts[n]}" for n in need))
                        n_identical += identical
                        n_cases += 1
                del gpu_params, cpu_params
    finally:
        os.environ.pop("SMT_CACHED_ATTN", None)
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[reference] tiny quantized generation: tokens identical in {n_identical} of "
        f"{n_cases} cases, the rest parting at a near-tie")


class StandInTokenizer:
    """ids <-> text for run D (the card has no `transformers`): one id per
    whitespace word, w<id> words back to their ids, other words hashed into
    the vocabulary; <s> = 1 first, pad 0 and eos 2 are special. It keeps
    the token arrays it decoded, for the comparisons between legs."""
    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size
        self.decoded = []

    def _id(self, word):
        import zlib
        if word[:1] == "w" and word[1:].isdigit():
            return int(word[1:])
        return 3 + zlib.crc32(word.encode()) % (self.vocab_size - 3)

    def __call__(self, texts, truncation=True, max_length=None, return_attention_mask=True):
        ids = [[self.bos_token_id] + [self._id(w) for w in t.split()] for t in texts]
        if truncation and max_length:
            ids = [x[:max_length] for x in ids]
        return {"input_ids": ids, "attention_mask": [[1] * len(x) for x in ids]}

    def batch_decode(self, rows, skip_special_tokens=True):
        import numpy as np
        rows = np.asarray(rows)
        self.decoded.append(rows)
        return [" ".join(f"w{int(i)}" for i in row if not (skip_special_tokens and i < 3))
                for row in rows]


def synthetic_eval_examples(n, tok, seed):
    """n boolq-style examples whose prompts tokenize to 60..256 ids (the
    longest 256, so the harness pads to the 256 bucket)."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.data.prompts import EVAL_PROMPT
    rng = np.random.default_rng(seed)
    base = len(tok([EVAL_PROMPT.format_map({"instruction": ""})])["input_ids"][0])
    lengths = rng.integers(60, 257, n)
    lengths[0] = 256
    return [{"instruction": " ".join(f"x{int(v)}" for v in rng.integers(0, 10 ** 6, int(L) - base)),
             "answer": "true" if i % 2 else "false"} for i, L in enumerate(lengths)]


class StepClock:
    """Wraps forward_with_cache in the generation modules: a prefill call
    (more than one new token) is timed between two synchronisations and its
    last-position logits kept, with the inputs of the first; a decode call
    records the host time at its start, with no synchronisation, so the
    intervals are whole steps."""

    def __init__(self):
        self.prefill_ms, self.prefill_logits, self.starts = [], [], []
        self.prefill_inputs = None  # (input_ids, cache_index, slot_mask, positions, max_len)

    def __enter__(self):
        from sparse_matrix_tuning_tpu_torch.eval import _beam_impl, generate
        self._mods = (generate, _beam_impl)
        self._orig = generate.forward_with_cache
        orig = self._orig

        def timed(params, input_ids, *args, **kw):
            import torch
            if input_ids.shape[1] == 1:
                self.starts.append(time.perf_counter())
                return orig(params, input_ids, *args, **kw)
            if self.prefill_inputs is None:
                _, cache, cache_index, slot_mask, positions = args
                self.prefill_inputs = (input_ids.clone(), cache_index, slot_mask.clone(),
                                       positions.clone(), cache["0"]["k"].shape[2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(params, input_ids, *args, **kw)
            torch.cuda.synchronize()
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
            self.prefill_logits.append(out[0][:, -1].float().cpu())
            return out

        for m in self._mods:
            m.forward_with_cache = timed
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.forward_with_cache = self._orig


def eval_leg(tag, what, params, cfg, examples, *, num_beams=4, cache_dtype="bfloat16",
             attn="auto", max_new_tokens=256):
    """One pass of the eval harness (make_generate_fn + run_dataset_eval, the
    CLI's batch 16 and repetition penalty 1.1) with the launch counts zeroed
    just before and read just after. Returns a summary."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig
    from sparse_matrix_tuning_tpu_torch.eval.harness import make_generate_fn, run_dataset_eval

    tok = StandInTokenizer(cfg.vocab_size)
    gen = GenerationConfig(max_new_tokens=max_new_tokens, num_beams=num_beams,
                           repetition_penalty=1.1, eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, cache_dtype=cache_dtype)
    fn = make_generate_fn(params, cfg, tok, gen, batch_size=16)
    os.environ["SMT_CACHED_ATTN"] = attn
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with StepClock() as clock:
            t0 = time.perf_counter()
            res = run_dataset_eval("boolq", examples, fn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launches()
    finally:
        os.environ.pop("SMT_CACHED_ATTN", None)
    tokens = np.concatenate(tok.decoded)
    steps = np.diff(clock.starts) * 1e3
    s = {"tokens": tokens, "launches": counts, "wall_s": wall,
         # the real rows (the harness pads a batch with empty rows)
         "prefill_ms": clock.prefill_ms, "prefill_logits": clock.prefill_logits[0][:len(examples)],
         "prefill_inputs": clock.prefill_inputs,
         "decode_ms": float(np.median(steps)), "decode_ms_p90": float(np.percentile(steps, 90)),
         "tokens_per_s": len(examples) * max_new_tokens / wall,
         "peak_gib": torch.cuda.max_memory_allocated() / 1024 ** 3,
         "in_vocab": bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
         "accuracy": res["accuracy"]}
    log(f"[{tag}] {what}: prefill {s['prefill_ms'][0]:.1f} ms; decode median "
        f"{s['decode_ms']:.2f} ms/step (p90 {s['decode_ms_p90']:.2f}) over {len(steps)} "
        f"intervals; {wall:.2f} s for {len(examples)} prompts x {max_new_tokens} new tokens = "
        f"{s['tokens_per_s']:.1f} tokens/s; peak {s['peak_gib']:.2f} GiB; K7 launches "
        f"{{cached_attn: {counts['cached_attn']}, cached_attn_q8: {counts['cached_attn_q8']}, "
        f"cached_attn_combine: {counts['cached_attn_combine']}}}; "
        f"tokens {tokens.shape}, all in the vocab: {s['in_vocab']}; accuracy "
        f"{res['accuracy']:.3f} (random weights)")
    if not s["in_vocab"]:
        raise AssertionError(f"run {tag}: tokens outside the vocabulary")
    return s


def long_prompt_leg(params, cfg, prompt=1900, new_tokens=64):
    """Run D5: one prompt of `prompt` random ids, greedy with repetition
    penalty 1.1, `new_tokens` new tokens, through eval/generate.generate. One
    sequence of 4 kv-heads gives K7 4 CTAs, so the planner splits the cache
    (flash-decoding; cached_attn_combine must launch); the same leg with the
    planner held to one split, for its time and tokens, in turns (one
    split, planned, planned, one split). Returns the planned legs' summary,
    launches from the first."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig, generate
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7

    ids = np.random.default_rng(13).integers(3, cfg.vocab_size, (1, prompt)).astype(np.int64)
    mask = np.ones(ids.shape, np.int32)
    gen = GenerationConfig(max_new_tokens=new_tokens, repetition_penalty=1.1)
    planner, legs = k7.plan_splits, {"planned": [], "one split": []}
    for name in ("one split", "planned", "planned", "one split"):
        k7.plan_splits = planner if name == "planned" else (lambda *a, **kw: 1)
        try:
            torch.cuda.synchronize()
            reset_launches()
            with StepClock() as clock:
                t0 = time.perf_counter()
                tokens = generate(params, cfg, ids, mask, gen)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            legs[name].append({"tokens": np.asarray(tokens), "launches": launches(),
                               "wall_s": wall,
                               "decode_ms": float(np.median(np.diff(clock.starts) * 1e3))})
        finally:
            k7.plan_splits = planner
    got, one = ({**runs[0], "decode_ms": float(np.mean([r["decode_ms"] for r in runs])),
                 "wall_s": float(np.mean([r["wall_s"] for r in runs])),
                 "decode_ms_each": [r["decode_ms"] for r in runs]}
                for runs in (legs["planned"], legs["one split"]))
    splits = planner(1, cfg.num_key_value_heads, cfg.num_attention_heads // cfg.num_key_value_heads,
                     cfg.head_dim, prompt + new_tokens - 1)
    agree = float(np.mean(got["tokens"] == one["tokens"]))
    log(f"[D5] one {prompt}-token prompt, greedy, {new_tokens} new tokens, bf16 cache, K7 "
        f"split {splits} ways at the last step: decode median ms/step "
        f"{got['decode_ms_each']} (one split {one['decode_ms_each']}, in turns one, planned, "
        f"planned, one), mean wall {got['wall_s']:.2f} s ({one['wall_s']:.2f}); K7 launches {{cached_attn: {got['launches']['cached_attn']}, "
        f"cached_attn_combine: {got['launches']['cached_attn_combine']}}} (one split: "
        f"{one['launches']['cached_attn']}, {one['launches']['cached_attn_combine']}); tokens "
        f"equal to the one-split leg's: {agree:.4f}")
    if got["launches"]["cached_attn_combine"] <= 0 or one["launches"]["cached_attn_combine"]:
        raise AssertionError(f"run D5: the planned leg must combine splits and the one-split "
                             f"leg must not: {got['launches']}, {one['launches']}")
    if not ((got["tokens"] >= 0) & (got["tokens"] < cfg.vocab_size)).all():
        raise AssertionError("run D5: tokens outside the vocabulary")
    return got


def fp32_attention_prefill_logits(params, cfg, prefill_inputs, n_rows):
    """The last-position logits of a prefill with its cached attention all in
    fp32 (K7's plain version on fp32 copies of q and the bf16 cache: fp32
    scores, softmax and P.V), everything else as in the run: the reference
    that D1 (K7, fp32 scores, bf16 P) and D4 (the einsum, bf16 scores) are
    held against. Its own cache, so the run's is untouched."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models import llama
    from sparse_matrix_tuning_tpu_torch.ops.cuda.cached_attention import cached_attention_plain

    def fp32_attention(q, kv, slot_mask, cache_index):
        return cached_attention_plain(q.float(), kv["k"], kv["v"], None, None, slot_mask,
                                      cache_index, 1.0 / q.shape[3] ** 0.5).to(q.dtype)

    input_ids, cache_index, slot_mask, positions, max_len = prefill_inputs
    cache = llama.init_cache(cfg, input_ids.shape[0], max_len, dtype=torch.bfloat16,
                             device=input_ids.device)
    orig = llama.cached_attention
    llama.cached_attention = fp32_attention
    os.environ["SMT_CACHED_ATTN"] = "on"
    try:
        logits, _ = llama.forward_with_cache(params, input_ids, cfg, cache, cache_index,
                                             slot_mask, positions, last_only=True)
    finally:
        llama.cached_attention = orig
        os.environ.pop("SMT_CACHED_ATTN", None)
    return logits[:n_rows, -1].float().cpu()


def run_eval(params, cfg):
    """Run D: the eval harness at TinyLlama-1.1B width and depth on 16
    prompts (60..256 ids, left-padded to 256, so S = 512). D1 bf16 cache,
    beam-4 (the CLI's defaults), D2 greedy, D3 int8 cache, beam-4, D4 as D1
    with the einsum attention at 64 new tokens; D1's and D4's prefill logits
    against an fp32-attention prefill. Returns {leg: summary}."""
    import numpy as np
    import torch
    examples = synthetic_eval_examples(16, StandInTokenizer(cfg.vocab_size), seed=11)
    legs = {
        "D1": eval_leg("D1", "bf16 cache, beam-4, K7", params, cfg, examples),
        "D2": eval_leg("D2", "bf16 cache, greedy, K7", params, cfg, examples, num_beams=1),
        "D3": eval_leg("D3", "int8 cache, beam-4, K7", params, cfg, examples,
                       cache_dtype="int8"),
        "D4": eval_leg("D4", "bf16 cache, beam-4, einsum attention", params, cfg, examples,
                       attn="off", max_new_tokens=64),
    }
    legs["D5"] = long_prompt_leg(params, cfg)
    for tag in ("D1", "D2"):
        if legs[tag]["launches"]["cached_attn"] <= 0:
            raise AssertionError(f"run {tag} did not launch K7: {legs[tag]['launches']}")
    if legs["D3"]["launches"]["cached_attn_q8"] <= 0:
        raise AssertionError(f"run D3 did not launch K7's int8 body: {legs['D3']['launches']}")
    if any(legs["D4"]["launches"][n] for n in K7_KERNELS):
        raise AssertionError(f"run D4 (einsum) launched K7: {legs['D4']['launches']}")
    d1, d4 = legs["D1"], legs["D4"]
    agree = float(np.mean(d1["tokens"][:, :64] == d4["tokens"]))
    diff = float((d1["prefill_logits"] - d4["prefill_logits"]).abs().max())
    scale = float(d4["prefill_logits"].abs().max())
    log(f"[D] D1 (K7) vs D4 (einsum): token agreement over the first 64 tokens {agree:.4f}; "
        f"prefill last-position logits max abs diff {diff:.4e} (max |logit| {scale:.3f})")
    # the same prompts; D4's cache is shorter (64 new tokens), but a prefill
    # from slot 0 sees only the prompt's slots
    ids1, _, sm1, pos1, _ = d1["prefill_inputs"]
    ids4, _, sm4, pos4, _ = d4["prefill_inputs"]
    t = ids1.shape[1]
    if not (torch.equal(ids1, ids4) and torch.equal(pos1, pos4)
            and torch.equal(sm1[:, :t], sm4[:, :t])):
        raise AssertionError("runs D1 and D4 prefilled different inputs")
    ref = fp32_attention_prefill_logits(params, cfg, d1["prefill_inputs"],
                                        len(d1["prefill_logits"]))
    for tag, leg in (("D1", d1), ("D4", d4)):
        dist = (leg["prefill_logits"] - ref).abs()
        top = float((leg["prefill_logits"].argmax(-1) == ref.argmax(-1)).float().mean())
        log(f"[D] {tag} vs the fp32-attention prefill: last-position logits max abs diff "
            f"{float(dist.max()):.4e}, mean {float(dist.mean()):.4e}; argmax agreement "
            f"{top:.4f}")
    return legs


def int4_dense_oracle(params, cfg, blocks=True):
    """Per-layer dense bf16 params equal to int4 decode params' weights: each
    linear the fp32-dequantized int4 base with the trained blocks scattered
    in (unless not `blocks`), rounded to bf16 (the JAX suite's oracle,
    tests/test_q4.py:176-248)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.quant import dequantize_weight_int4
    from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK

    dense = {k: params[k] for k in ("embed_tokens", "norm", "lm_head")}
    dense["layers"] = {}
    for l, ex in enumerate(params["layers_q8"]["layers"]):
        layer = {n: w for n, w in ex["params"].items() if w.numel() > 1}  # norms, biases
        for mod, q in ex["q"].items():
            w = dequantize_weight_int4(q["w4"], q["s4"], torch.float32)
            if blocks and mod in ex["t"]:
                meta = ex["idx"][mod]
                keep = meta["valid"]
                w.view(w.shape[0] // BLOCK, BLOCK, w.shape[1] // BLOCK, BLOCK)[
                    meta["rb"][keep].long(), :, meta["cb"][keep].long(), :] = ex["t"][mod][keep]
            layer[mod] = w.to(torch.bfloat16)
        dense["layers"][str(l)] = layer
    return dense


def dense_prefill_logits(params, cfg, prefill_inputs, n_rows):
    """Last-position logits of a prefill of per-layer params on the recorded
    inputs of a run's prefill, with its own bf16 cache."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models import llama
    input_ids, cache_index, slot_mask, positions, max_len = prefill_inputs
    cache = llama.init_cache(cfg, input_ids.shape[0], max_len, dtype=torch.bfloat16,
                             device=input_ids.device)
    logits, _ = llama.forward_with_cache(params, input_ids, cfg, cache, cache_index, slot_mask,
                                         positions, last_only=True)
    return logits[:n_rows, -1].float().cpu()


def run_quantized_eval(export_dir, cfg, d1):
    """Run F: the eval over a quantized frozen base, each leg's params built
    by the eval CLI's load_decode_params from run A's HF export
    (quantize-on-load), then the harness as in run D (16 prompts, beam-4,
    repetition penalty 1.1, bf16 cache, K7): F1 the int4 base with the
    empty plan (the CLI's --frozen_quant int4), 256 new tokens; F2 the int8
    base, 64; F3 the int4 base with run A's smt_plan.json (K5 corrects the
    trained blocks), 64, its prefill logits held against int4_dense_oracle.
    Each: conversion time and peak, resident bytes, no dense layer weight on
    the device, and the launches of its path. Returns {leg: summary}."""
    import gc

    import torch
    from sparse_matrix_tuning_tpu_torch.cli.run_commonsense import load_decode_params
    from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
    from sparse_matrix_tuning_tpu_torch.train.convert import LAYER_LINEARS

    gib = 1024 ** 3
    examples = synthetic_eval_examples(16, StandInTokenizer(cfg.vocab_size), seed=11)
    with open(os.path.join(export_dir, "smt_plan.json")) as f:
        plan = SMTPlan.from_json(f.read())
    legs = {}
    for tag, fq, leg_plan, new_tokens, need, forbid in (
            ("F1", "int4", None, 256, ("q4_matmul", "cached_attn"),
             ("q8mm_t", "block_correction")),
            ("F2", "int8", None, 64, ("q8mm_t", "cached_attn"), ("q4_matmul", "block_correction")),
            ("F3", "int4", plan, 64, ("q4_matmul", "block_correction", "cached_attn"),
             ("q8mm_t",))):
        gc.collect()  # what earlier runs left in reference cycles (the trainers)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, _ = load_decode_params(export_dir, fq, "bf16", "cuda", leg_plan)
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t0
        conv_peak = (torch.cuda.max_memory_allocated() - before) / gib
        resident = (torch.cuda.memory_allocated() - before) / gib
        stacked = params["layers_stacked"]
        dense = [m for m in LAYER_LINEARS if tuple(stacked[m].shape) != (cfg.num_hidden_layers, 1)]
        if dense or "layers" in params:
            raise AssertionError(f"run {tag}: dense layer weights on the device: {dense}")
        which = f"run A plan ({len(plan.linears)} linears)" if leg_plan else "empty plan"
        what = f"{fq} frozen base, {which}, bf16 cache, beam-4, {new_tokens} new tokens"
        log(f"[{tag}] load_decode_params({fq}) from run A's export: {conv_s:.2f} s, peak "
            f"{conv_peak:.2f} GiB above the {before / gib:.2f} GiB already allocated, resident "
            f"{resident:.3f} GiB; the {len(LAYER_LINEARS)} layer linears x "
            f"{cfg.num_hidden_layers} layers are {fq} only (placeholders (L, 1) on the device)")
        leg = eval_leg(tag, what, params, cfg, examples, max_new_tokens=new_tokens)
        leg.update(conversion_s=conv_s, conversion_peak_gib=conv_peak, resident_gib=resident)
        log(f"[{tag}] eval peak {leg['peak_gib'] - before / gib:.2f} GiB above the "
            f"{before / gib:.2f} GiB allocated before the conversion")
        bad = [n for n in need if leg["launches"][n] <= 0] + [n for n in forbid
                                                               if leg["launches"][n]]
        if bad:
            raise AssertionError(f"run {tag} launches {leg['launches']}: wrong for {bad}")
        log(f"[{tag}] launches of the path: " + ", ".join(
            f"{n} {leg['launches'][n]}" for n in need + forbid))
        if tag == "F3":
            # F3's prefill (more than 64 rows: each linear the bf16-dequantized
            # base and a bf16 matmul, then K5) against the dense oracle's on
            # the same inputs. They are the same bf16 computation except at
            # the planned linears: F3 rounds their output to bf16 twice (after
            # the base product, then after K5 adds x . delta^T) and holds the
            # trained blocks as bf16(base) + bf16(t - base) against the
            # oracle's bf16(t). Each is one bf16 rounding (2^-9 relative) of
            # the kind every stage of both forwards carries, which run D
            # measured at 1.6% of the largest logit (D1 against an
            # fp32-attention prefill); held to 2^-4 of the largest logit, and
            # on average closer to the oracle than the int4 base without the
            # trained blocks (what F3 would be if the corrections did nothing)
            prefill = leg["prefill_inputs"]
            n_rows = len(leg["prefill_logits"])
            want = dense_prefill_logits(int4_dense_oracle(params, cfg), cfg, prefill, n_rows)
            bare = dense_prefill_logits(int4_dense_oracle(params, cfg, blocks=False), cfg,
                                        prefill, n_rows)
            diff = (leg["prefill_logits"] - want).abs()
            bare_diff = (bare - want).abs()
            top = float((leg["prefill_logits"].argmax(-1) == want.argmax(-1)).float().mean())
            limit = 2.0 ** -4 * float(want.abs().max())
            log(f"[F3] prefill last-position logits against the dense oracle (the int4 base "
                f"with the trained blocks scattered in, bf16 dense path): max abs diff "
                f"{float(diff.max()):.4e} (limit {limit:.4e}), mean {float(diff.mean()):.4e}, "
                f"argmax agreement {top:.4f}; the int4 base without the blocks: max "
                f"{float(bare_diff.max()):.4e}, mean {float(bare_diff.mean()):.4e}")
            if float(diff.max()) > limit or float(diff.mean()) >= float(bare_diff.mean()):
                raise AssertionError("run F3 leaves the dense oracle's bound")
        legs[tag] = leg
        del params
    agree = float((legs["F1"]["tokens"][:, :64] == d1["tokens"][:, :64]).mean())
    diff = float((legs["F1"]["prefill_logits"] - d1["prefill_logits"]).abs().max())
    log(f"[F] F1 (int4 base) against D1 (bf16 weights): token agreement over the first 64 "
        f"tokens {agree:.4f}; prefill last-position logits max abs diff {diff:.4e} (max |logit| "
        f"{float(d1['prefill_logits'].abs().max()):.3f}); decode ms/step "
        f"{legs['F1']['decode_ms']:.2f} vs {d1['decode_ms']:.2f}; peak "
        f"{legs['F1']['peak_gib']:.2f} vs {d1['peak_gib']:.2f} GiB")
    return legs


def compare_int8_run(run_a, run_e, n_warmup):
    """Run E against run A: the same warm-up (int8 is a sparse-phase
    policy), sparse and eval losses inside the JAX suite's 5% band
    (tests/test_quant.py:202-203)."""
    import numpy as np
    a, e = np.array(run_a["loss"]), np.array(run_e["loss"])
    # both runs take the same steps on the same batches; what differs between
    # two warm-ups on one card is the order of the atomic adds in the
    # embedding's backward
    np.testing.assert_allclose(e[:n_warmup], a[:n_warmup], rtol=2e-3,
                               err_msg="run E's warm-up losses differ from run A's")
    np.testing.assert_allclose(e[n_warmup:], a[n_warmup:], rtol=0.05,
                               err_msg="run E's sparse losses leave the 5% band around run A's")
    np.testing.assert_allclose(run_e["eval_loss"], run_a["eval_loss"], rtol=0.05)
    if run_e["plan"]["fingerprint"] != run_a["plan"]["fingerprint"]:
        log("[E] note: run E selected another plan than run A "
            f"({run_e['plan']['fingerprint'][:16]} vs {run_a['plan']['fingerprint'][:16]})")
    rel = np.abs(e - a) / np.abs(a)
    log(f"[E] against run A: warm-up losses worst rel diff {rel[:n_warmup].max():.2e}, sparse "
        f"losses worst rel diff {rel[n_warmup:].max():.2e} (limit 5e-2), eval loss "
        f"{run_e['eval_loss']:.4f} vs {run_a['eval_loss']:.4f}; sparse ms/step median "
        f"{statistics.median(run_e['step_ms'][n_warmup + 1:]):.1f} vs "
        f"{statistics.median(run_a['step_ms'][n_warmup + 1:]):.1f}; later-sparse-steps peak "
        f"{run_e['peak']['later_sparse_steps'] / 1024 ** 3:.2f} vs "
        f"{run_a['peak']['later_sparse_steps'] / 1024 ** 3:.2f} GiB")


def main(argv=None):
    """`--only q8` stops after the build, the K4 / K5 checks and the tiny
    int8 references; `--only q4` after the build, the K6 checks and the tiny
    quantized generation; `--only attn` after the build and the K3 / K7
    checks (short first calls for a new kernel); none prints a result
    line. With no arguments every phase runs."""
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "q8"], ["--only", "q4"], ["--only", "attn"]):
        raise SystemExit("usage: python3 chip_smoke.py [--only q8|q4|attn]")
    only = argv[1] if argv else None
    only_q8 = only == "q8"
    t_start = time.time()
    check_device()
    import dataclasses
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
    marks = [("build", time.time())]

    if only == "attn":
        check_attention()
        check_cached_attention()
        marks.append(("kernels", time.time()))
        log("[smoke] --only attn: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "q4":
        check_q4_matmul()
        marks.append(("kernels", time.time()))
        check_small_quant_generation()
        marks.append(("references", time.time()))
        log("[smoke] --only q4: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if not only_q8:
        k1_err, k1_time = check_block_grad()
        k2_err, k2_time = check_masked_adam()
        k3_err, k3_time = check_attention()
        k7_err, k7_time = check_cached_attention()
    k4_err, k4_time = check_q8_matmul()
    k5_err, k5_time = check_block_correction()
    if not only_q8:
        k6_err, k6_time = check_q4_matmul()
    marks.append(("kernels", time.time()))
    if not only_q8:
        check_small_reference()
        check_small_generation()
        check_small_quant_generation()
    check_small_reference(frozen_quant="int8", loss_impl="chunked")
    marks.append(("references", time.time()))
    if only_q8:
        log("[smoke] --only q8: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return

    # A: the main path, attn_impl "auto" (K3), with the final export; its
    # fine-tuned weights are run D's
    model_cfg = LlamaConfig(**TINYLLAMA)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        run_a = run_main_path(model_cfg, "cuda", out_dir=out_dir, keep_decode_params=True)
        decode_params = run_a.pop("decode_params")
        report_run("A", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn auto (K3)", run_a, 3)
        torch.cuda.empty_cache()
        marks.append(("A", time.time()))
        # D: the generation eval of A's fine-tuned weights, freed before the rest
        run_d = run_eval(decode_params, model_cfg)
        del decode_params
        torch.cuda.empty_cache()
        marks.append(("D", time.time()))
        # F: the eval over the int4 / int8 frozen base, quantized while
        # loading A's export
        run_f = run_quantized_eval(os.path.join(out_dir, "final"), model_cfg, run_d["D1"])
        torch.cuda.empty_cache()
        marks.append(("F", time.time()))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # E: as A over the int8 frozen base (K4, K5; int8 head, host offload),
    # with the final export
    out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        run_e = run_main_path(model_cfg, "cuda", out_dir=out_dir, frozen_quant="int8")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    report_run("E", "TinyLlama-1.1B bf16 over the int8 frozen base, bs 4 x seq 512, remat, "
               "attn auto (K3)", run_e, 3)
    compare_int8_run(run_a, run_e, 3)
    torch.cuda.empty_cache()
    # E2: the chunked q8 loss at full width and vocabulary, depth cut to 2
    # layers: K4 on the loss's ragged T = bs * (seq - 1) rows, against the
    # same leg with the dense q8 loss (the same logits bit for bit, so the
    # losses differ by the order of fp32 sums and what one step makes of it)
    shallow = dataclasses.replace(model_cfg, num_hidden_layers=2)
    e2 = {impl: run_main_path(shallow, "cuda", full_ft_steps=1, sparse_steps=2, eval_batches=1,
                              frozen_quant="int8", loss_impl=impl, log_fn=lambda m: None)
          for impl in ("chunked", "full")}
    import numpy as np
    np.testing.assert_allclose(e2["chunked"]["loss"], e2["full"]["loss"], rtol=1e-3)
    log(f"[E2] 2 layers, int8 base, loss_impl chunked vs full: losses {e2['chunked']['loss']} "
        f"vs {e2['full']['loss']}; K4 launches {e2['chunked']['launches']['q8mm_t']} / "
        f"{e2['chunked']['launches']['q8mm_g']} vs {e2['full']['launches']['q8mm_t']} / "
        f"{e2['full']['launches']['q8mm_g']}")
    if e2["chunked"]["launches"]["q8mm_t"] <= e2["full"]["launches"]["q8mm_t"]:
        raise AssertionError("the chunked q8 loss did not launch K4 once per vocabulary chunk")
    torch.cuda.empty_cache()
    marks.append(("E", time.time()))
    # B: the recipe's max_seq_len 2048, bs 2
    run_b = run_main_path(model_cfg, "cuda", bs=2, seq=2048)
    report_run("B", "TinyLlama-1.1B bf16, bs 2 x seq 2048, remat, attn auto (K3)", run_b, 3)
    torch.cuda.empty_cache()
    marks.append(("B", time.time()))
    # C: the einsum path kept alive, otherwise as A at 6 of the 22 layers
    # (depth cut to make room for run E)
    run_c = run_main_path(dataclasses.replace(model_cfg, num_hidden_layers=6), "cuda",
                          attn_impl="einsum")
    report_run("C", "TinyLlama-1.1B width, 6 layers, bf16, bs 4 x seq 512, remat, attn einsum",
               run_c, 3)
    marks.append(("C", time.time()))

    for tag, run in (("A", run_a), ("B", run_b)):
        if not all(run["launches"][n] > 0 for n in TRAIN_KERNELS):
            raise AssertionError(f"run {tag} did not launch every kernel: {run['launches']}")
        if any(run["launches"][n] for n in Q8_KERNELS + ("q4_matmul",)):
            raise AssertionError(f"run {tag} (bf16 base) launched an int8 or int4 kernel: "
                                 f"{run['launches']}")
    if not all(run_e["launches"][n] > 0 for n in TRAIN_KERNELS + Q8_KERNELS):
        raise AssertionError(f"run E did not launch every kernel: {run_e['launches']}")
    if any(run_e["launches_warmup"][n] for n in Q8_KERNELS):
        raise AssertionError(f"run E's warm-up launched an int8 kernel: "
                             f"{run_e['launches_warmup']}")
    c = run_c["launches"]
    if any(c[n] for n in K3_KERNELS) or c["block_grad"] <= 0 or c["masked_adam"] <= 0:
        raise AssertionError(f"run C (einsum) launches: {c}")

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda",
                "source": f"sparse_matrix_tuning_tpu_torch/csrc/{source}",
                "replaces": f"sparse_matrix_tuning_tpu/ops/pallas/{replaces}",
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms}

    kernels = [
        entry("block_grad", "block_grad.cu", "block_grad.py:56",
              run_a["launches"]["block_grad"], k1_err, k1_time["ms"], k1_time["plain_ms"],
              k1_time["bound"], k1_time["lib_ms"]),
        entry("masked_adam", "masked_adam.cu", "masked_adam.py:35",
              run_a["launches"]["masked_adam"], k2_err, k2_time["ms"], k2_time["plain_ms"],
              k2_time["bound"], k2_time["lib_ms"]),
    ] + [entry(name, "attention.cu",
               "attention.py:154" if name == "attn_fwd" else "attention.py:188",
               run_a["launches"][name], k3_err[name], *k3_time[name]) for name in K3_KERNELS
         ] + [entry(name, "cached_attention.cu", "cached_attention.py:123",
                    run_d[leg]["launches"][name], k7_err[name], *k7_time[name])
              for name, leg in (("cached_attn", "D1"), ("cached_attn_q8", "D3"),
                                ("cached_attn_combine", "D5"))
              ] + [entry(name, "q8_matmul.cu", f"q8_matmul.py:{line}",
                         run_e["launches"][name], k4_err[name], *k4_time[name])
                   for name, line in (("q8mm_t", 104), ("q8mm_g", 133))
                   ] + [entry("block_correction", "correction.cu", "correction.py:69",
                              run_e["launches"]["block_correction"], k5_err, *k5_time),
                        entry("q4_matmul", "q4_matmul.cu", "q4_matmul.py:94",
                              run_f["F1"]["launches"]["q4_matmul"], k6_err, *k6_time)]
    log("[smoke] seconds by phase: " + ", ".join(
        f"{name} {t - prev:.1f}" for (name, t), (_, prev) in zip(marks, [("", t_start)] + marks)))
    log(f"[smoke] time_ms: {TIMER_COUNTS['timings']} timings, {TIMER_COUNTS['retries']} "
        "re-timed behind a longer spin")
    log(f"[smoke] all phases passed in {time.time() - t_start:.1f} s")
    smi = shutil.which("nvidia-smi")
    if smi:  # the card's name and power limit, again beside the numbers
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        log(out.stdout.strip().splitlines()[0] if out.stdout.strip() else "[nvidia-smi] no output")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
