#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sparse_matrix_tuning_tpu_torch) on
one CUDA GPU (written for an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build the CUDA kernels (csrc/*.cu) with nvcc for sm_90a, timed;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, with its time beside the plain version's and a library
     path's: K1/K2 at the two widest TinyLlama linears (K1 through its
     plan and at seven forced plans of tile rows and T splits, two launches
     equal bit for bit, a planted fault: one split dropped from the sum);
     K3 (attention
     forward, delta, dK/dV over the planned q-head partitions with its
     reduce, dQ) at five shapes (K3_SHAPES), with a dropped partition the
     check must reject and two dK/dV launches equal bit for bit, timed at
     the first three beside torch SDPA's forward and backward, dK/dV at
     every partition count, with each path's fwd+bwd peak memory; K7
     (cached attention, bf16/fp32 and int8 caches) at eleven shapes
     (K7_SHAPES), each with planted faults the check must reject, split
     over the cache and combined where the rows fit one CTA (a dropped
     split rejected, repeat launches equal), timed at eight beside torch
     SDPA with a boolean mask and at several split counts; the row
     quantization in front of K4 at six shapes (RQ_SHAPES: bf16 / fp32,
     with and without the g form's fold of the weight scales, rows of
     zeros, ragged T, rows on .5 ties, magnitudes 1e-2 to 10, rows holding
     a NaN or an inf), equal to its plain version bit for bit, with a
     planted fault (the scale as amax / 127), timed at two; the int8 paths'
     quantization and matmuls under set_sync_debug_mode("error"); K4 (the
     int8 matmul with fused scales, t and g forms) at eleven shapes
     (K4_SHAPES: the TinyLlama linears and head, a ragged chunk, Llama-3-8B's
     gate, the int8 eval decode's gate/up, k/v, q/o and down at 64 rows,
     ragged decode rows), equal to its plain version
     bit for bit, with a planted fault, timed at eight beside torch._int_mm
     plus the scale pass and beside cuBLAS bf16; K5
     (the block correction) at nine cases (K5_SHAPES: both orientations,
     ragged T, bf16 and fp32, unsorted coordinates with repeats, one run
     of 24, F3's decode rows), each bf16 case at every tile shape of
     K5_PLANS, two launches equal bit for bit, with a planted fault, timed
     at three by tile shape beside bmm + index_add_; each timed kernel
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
     seq 512, attention "auto" (K3), with the final HF export checked (its
     smt_plan.json gives the blocks per linear: K1 and K5 are timed at the
     min, median and max, utils/time_sparse.py's cases); E,
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
     device;
  8. run G (after F, before E), continuation training over the int8 scan
     state, as `cli.fine_tune --frozen_quant int8 --sparse_from_plan`
     runs it: A's export quantized while it loads, A's smt_plan.json,
     SMTTrainer.sparse_scan_from_hf and fit, 4 sparse steps at bs 4 x seq
     512, 2 eval batches, the final export; quantize-on-load seconds, its
     peak and what stays resident, the peak over fit, sparse ms/step, eval
     ms and host-device syncs in a sparse step, each against run E's (no
     more syncs than E's), every kernel of the path launched (K1, K2, K3,
     K4 t and g, one row quantization per K4 call, K5), no dense layer
     weight or head on the device, and the export bit for bit A's but for
     the trained blocks, which equal the trainables; each line beside the
     card's name and power limit. Among the references, the same path at
     a tiny fp32 size (a padded plan with a module absent from one layer)
     on the GPU against the CPU, losses within 1e-3;
  9. runs H and I (after E, before B), channel mode: H as A with
     --channel_sparsity at the CLI's 30 attention and 30 MLP channels (a
     warm-up that only harvests |activation| saliency: K3 forward, no K3
     backward, no K2; the sparse steps K3 and K2 on the (O, n) columns, no
     K1, K5, K4 or K6), with its export checked as A's (the frozen weights
     bit for bit, the selected columns the trainables); I, H's export and
     channel plan under --frozen_quant int8 --sparse_from_plan, as G (K4 t
     and g, one row quantization per K4 call, K2, no K1 or K5; no more
     syncs a sparse step than E's; the export bit for bit H's but for the
     trained columns), then two greedy decode legs over I's trained state
     (I8 the int8 base, K4; I4 the base requantized to int4, K6), 16
     prompts, 32 new tokens. Among the references, H's path and I's at
     the tiny fp32 size, GPU against CPU;
 10. run J (after I), channel mode with --frozen_quant int8 from a
     warm-up at full depth, as A otherwise: at 22 layers the conversion
     builds the int8 scan state (scan_phase.build_scan_sparse_state, its
     stacks (L, 1) placeholders beside the host store, q and q_head), so
     the sparse phase launches K4 t and g with one row quantization per
     call, K3 and K2, no K1, K5 or K6; the export checked as A's against
     merged_params_from_scan, ms/step, peak, syncs (no more than E's) and
     the int8 greedy decode leg J8, beside run I's. Among the references,
     J's path at the tiny fp32 size widened to 12 layers, GPU against CPU;
 11. runs R and R2 (after J), resume: R in matrix mode, bf16, --dropout
     0.1, 2 warm-up + 3 sparse steps at full depth, straight and stopped
     twice (after the warm-up checkpoint at step 2, inside the sparse
     phase at step 4), each stop restored into a fresh SMTTrainer from
     {output_dir}/ckpt; R2 the same in J's layout (channel int8 scan state),
     stopped once at step 4. Losses, eval loss and every state leaf equal
     the straight run's bit for bit; no K3 launch in a training step under
     dropout.
Before the references, K6 (the int4 unpack-matmul) runs at eight shapes
(K6_SHAPES: the TinyLlama linears at the eval decode's 64 rows, 16 and a
ragged 7, Llama-3-8B's gate) and on the layer views of a stack (K6s),
against its plain version within a limit derived from the two fp32
summation orders, one launch a call, two launches equal bit for bit, with
two planted faults the check must reject, timed
beside cuBLAS bf16 on the dequantized weight; and a tiny fp32 generation
over the int8 and int4 bases (planned and empty plan, bf16 and int8
cache, greedy and beam-4) on the GPU against the CPU, tokens identical.
The line before the last is a JSON object of the kernels' numbers; the
last line is {"ok": true, "device": {...}}. `--only q8` stops after the
build, the row quantization and no-synchronisation checks, the K4 / K5
checks and the tiny int8 reference; `--only q4` after
the build, the K6 checks and the tiny quantized generation; `--only attn`
after the build and the K3 / K7 checks; `--only sparse` after the build and
the K1 / K2 / K5 checks; `--only scan` runs the build, the tiny 12-layer
channel int8 reference, J and R; none of them prints a result.
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
# forced bf16 K1 plans (rows of a block per CTA, T splits; the splits capped
# at the chunks of T), checked at every K1 shape and timed at the first
K1_PLANS = [(128, 1), (128, 2), (128, 4), (64, 1), (64, 2), (64, 4), (64, 8)]
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
K3_TOL["fp16"] = K3_TOL["bf16"]  # the fp16 bodies are held to the bf16 bounds
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
    (64, 2048, 5632, "bf16", "TinyLlama gate/up at the int8 eval decode (F2: 16 prompts x 4 "
     "beams)", True),
    (64, 2048, 256, "bf16", "TinyLlama k/v at the int8 eval decode", True),
    (64, 2048, 2048, "bf16", "TinyLlama q/o at the int8 eval decode", True),
    (64, 5632, 2048, "bf16", "TinyLlama down at the int8 eval decode", True),
    (37, 2048, 2048, "bf16", "ragged decode rows, q/o", False),
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
    (2048, 256, 2048, "bf16", True, "TinyLlama k/v forward: one run of 24", False),
    (64, 5632, 2048, "bf16", True, "F3's decode rows (16 prompts x 4 beams), gate/up forward",
     True),
    (37, 2048, 5632, "bf16", False, "ragged decode rows, grad_input", False),
]
# the bf16 K5 tile shapes (token rows, out columns per CTA), each checked at
# every bf16 case and timed at the timed ones
K5_PLANS = [(128, 256), (64, 256), (64, 128), (64, 64)]
# K5 against its plain version. Both sum the same products in fp32 in another
# order and round once, so in bf16 they are equal or one bf16 ulp apart:
# |diff| <= 2^-7 |want|, plus an absolute term for sums near zero. fp32: the
# JAX suite's correction tolerance (tests/test_scan_ops.py:147).
K5_TOL = {"bf16": (2.0 ** -7, 1e-4), "fp32": (1e-5, 1e-5)}
K5_TOL["fp16"] = K5_TOL["bf16"]  # held to the bf16 bound
Q8_KERNELS = K4_KERNELS + ("row_quant", "block_correction")
# the row quantization in front of K4 (T, K, x dtype, fold the weight scales,
# what, timed): bit for bit against the plain version
RQ_SHAPES = [
    (2048, 2048, "bf16", False, "TinyLlama gate/up input, the main path", True),
    (2048, 5632, "bf16", True, "the g form's fold over gate/up's output gradient", True),
    (2044, 2048, "fp32", False, "the q8 loss's hidden states, ragged T", False),
    (37, 2048, "bf16", False, "ragged decode rows", False),
    (64, 4096, "fp32", True, "fp32 fold over a head chunk", False),
    (9, 100, "bf16", True, "a row length off the 16-byte vectors", False),
]
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
K6_STACK = (3, 64, 2048, 2048)
# runs R and R2 (resume) at TinyLlama's width, depth cut to keep the whole
# script near half its time limit: R (per-layer state) 8 layers, R2 12, the
# least depth at which channel + int8 takes the scan state (J's layout)
R_LAYERS, R2_LAYERS = 8, 12  # K6s: layers, T, I, O; K6 on the views of layers 1 and 2
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
PEAK_OPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12, "int8": 1979e12}


def log(msg):
    print(msg, flush=True)


def torch_dtype(name):
    import torch
    return {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}[name]


def elem_bytes(name):
    return 4 if name == "fp32" else 2


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

CARD = {"smi": "nvidia-smi not available"}  # name and power limit, beside run G's numbers


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
        CARD["smi"] = line
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
    """K1 at K1_SHAPES (bf16) and one fp32 shape, n = 24 coordinates with
    repeats, through the wrapper (its plan), against the plain version at
    the JAX suite's tolerance; two launches equal bit for bit; every bf16
    shape also at the forced plans of K1_PLANS (the split sum in the
    launch at 1 to 8 splits, 64- and 128-row tiles); a planted fault (one
    split's partial dropped from the sum, in the kernel's order) the check
    must reject; times at the main shape by plan beside the plain version,
    the library (bmm on gathered panels) and the bound."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, timing = 0.0, None
    for t, o, i in K1_SHAPES:
        g2 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev, torch.bfloat16)
        x2 = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev, torch.bfloat16)
        rb_np, cb_np = _coords(rng, K1_N, o // 256, i // 256)
        rb = torch.from_numpy(rb_np).to(dev)
        cb = torch.from_numpy(cb_np).to(dev)
        p = k1.plan(K1_N, t, n_sm)
        got = k1.block_grad(g2, x2, rb, cb)
        again = k1.block_grad(g2, x2, rb, cb)
        torch.cuda.synchronize()
        want = k1.block_grad_plain(g2, x2, rb, cb)  # fp32 products of the same bf16 values
        assert got.shape == (K1_N, 256, 256) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=K1_ATOL)
        if not torch.equal(got, again):
            raise AssertionError(f"K1 T={t}: two launches differ ({p})")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        forced = []
        for bm, splits in K1_PLANS:
            splits = min(splits, -(-t // 64))
            f1 = k1._launch(g2, x2, rb, cb, bm, splits)
            f2 = k1._launch(g2, x2, rb, cb, bm, splits)
            torch.cuda.synchronize()
            torch.testing.assert_close(f1, want, rtol=K1_RTOL, atol=K1_ATOL)
            if not torch.equal(f1, f2):
                raise AssertionError(f"K1 T={t}: two launches at bm {bm}, {splits} splits differ")
            worst = max(worst, float((f1 - want).abs().max()))
            forced.append(f"{bm}x256/{splits}")
        # the planted fault: one split's partial left out of the sum
        f_splits = max(2, p.splits)
        fault = k1.block_grad_split_model(g2, x2, rb, cb, f_splits, drop=f_splits - 1)
        if torch.allclose(fault, want, rtol=K1_RTOL, atol=K1_ATOL):
            raise AssertionError(f"K1 T={t}: the check passes a planted fault (a split dropped)")
        log(f"[K1 block_grad] bf16 T={t} (O,I)=({o},{i}) n={K1_N}: max_abs_err {err:.3e}; plan "
            f"{p.bm}x256 tiles, {p.splits} splits, {p.grid} CTAs; two launches equal; forced "
            f"plans {', '.join(forced)} within tolerance and repeatable; planted fault "
            f"(split {f_splits - 1} of {f_splits} dropped) rejected, max abs err "
            f"{float((fault - want).abs().max()):.3e}")
        if timing is None:  # the main shape: T=2048, (5632, 2048)
            def lib():
                g_rows = g2.reshape(t, -1, 256).index_select(1, rb.long()).transpose(0, 1)
                x_cols = x2.reshape(t, -1, 256).index_select(1, cb.long()).transpose(0, 1)
                return torch.bmm(g_rows.transpose(1, 2), x_cols)
            ms = time_ms(lambda: k1.block_grad(g2, x2, rb, cb))
            plain_ms = time_ms(lambda: k1.block_grad_plain(g2, x2, rb, cb))
            lib_ms = time_ms(lib)
            ms2 = time_ms(lambda: k1.block_grad(g2, x2, rb, cb))
            by_plan = {f"{bm}x256/{sp}": time_ms(lambda: k1._launch(g2, x2, rb, cb, bm, sp))
                       for bm, sp in K1_PLANS}
            flop = 2.0 * K1_N * t * 256 * 256
            # the row / column panels of the selected blocks, read once, and
            # the fp32 blocks written
            nbytes = (len(set(rb_np)) + len(set(cb_np))) * t * 256 * 2 + K1_N * 256 * 256 * 4
            timing = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, ms_repeat=ms2,
                          shape=f"T={t} (O,I)=({o},{i}) n={K1_N} bf16",
                          tflops=flop / (min(ms, ms2) * 1e-3) / 1e12,
                          bound=bound(nbytes, flop, "bf16"), by_plan=by_plan)
    # the fp32 variant (taken by --dtype fp32 runs)
    t, o, i = K1_SHAPES[3]
    g2 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev)
    x2 = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev)
    rb_np, cb_np = _coords(rng, K1_N, o // 256, i // 256)
    rb, cb = torch.from_numpy(rb_np).to(dev), torch.from_numpy(cb_np).to(dev)
    got = k1.block_grad(g2, x2, rb, cb)
    torch.cuda.synchronize()
    want = k1.block_grad_plain(g2, x2, rb, cb)
    torch.testing.assert_close(got, want, rtol=K1_F32_RTOL, atol=K1_F32_ATOL)
    log(f"[K1 block_grad] fp32 T={t} (O,I)=({o},{i}) n={K1_N}: "
        f"max_abs_err {float((got - want).abs().max()):.3e}")
    log(f"[K1 block_grad] time at {timing['shape']}: kernel {timing['ms']:.4f} ms "
        f"(repeat {timing['ms_repeat']:.4f}), plain {timing['plain_ms']:.4f} ms, "
        f"library bmm on gathered bf16 panels {timing['lib_ms']:.4f} ms; "
        f"kernel {timing['tflops']:.1f} TFLOP/s; bound {timing['bound'][0]:.3e} ms "
        f"({timing['bound'][1]}); by plan (tile/splits): " + ", ".join(
            f"{k} {v:.4f}" for k, v in timing["by_plan"].items()))
    return worst, timing


def _k2_case(n, seed, zero_every=0):
    """K2 at (n, 256, 256) fp32 against its plain version over 3 steps from
    one state, at K2_RTOL / K2_ATOL; with zero_every > 0 every
    zero_every-th block's grad is 0, as a padded entry's is in the scan
    state's stacks (only the weight decay moves it). Then the kernel, the
    plain version and torch._foreach timed on the same tensors. Returns
    (max_abs_err, timing)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda.masked_adam import masked_adam, masked_adam_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, 256, 256)

    def rand(scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def grad():
        g = rand(0.1)
        if zero_every:
            g[::zero_every] = 0.0
        return g

    kernel_state = [rand(0.02), torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)]
    plain_state = [t.clone() for t in kernel_state]
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.1, 1e-3
    worst = 0.0
    for step in range(1, 4):
        g = grad()
        c = torch.tensor(float(step), device=dev)
        scalars = torch.stack([torch.tensor(lr, device=dev), torch.tensor(b1, device=dev),
                               torch.tensor(b2, device=dev), torch.tensor(eps, device=dev),
                               torch.tensor(wd, device=dev), 1.0 - torch.pow(b1, c),
                               1.0 - torch.pow(b2, c)]).float()
        masked_adam(*kernel_state[:1], g, *kernel_state[1:], scalars)
        torch.cuda.synchronize()
        masked_adam_plain(plain_state[0], g, plain_state[1], plain_state[2], scalars)
        for got, want in zip(kernel_state, plain_state):
            torch.testing.assert_close(got, want, rtol=K2_RTOL, atol=K2_ATOL)
            worst = max(worst, float((got - want).abs().max()))
        log(f"[K2 masked_adam] n={n}{f', every {zero_every}th grad 0' if zero_every else ''} "
            f"step {step}: p/m/v max_abs_err {worst:.3e}")
    del plain_state

    p, m, v = kernel_state
    g = grad()

    def lib():  # torch._foreach Adam ops over the same tensors
        torch._foreach_mul_([m], b1)
        torch._foreach_add_([m], [g], alpha=1 - b1)
        torch._foreach_mul_([v], b2)
        torch._foreach_addcmul_([v], [g], [g], value=1 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div([v], 1 - b2 ** 3))
        torch._foreach_add_(denom, eps)
        torch._foreach_mul_([p], 1 - lr * wd)
        torch._foreach_addcdiv_([p], [m], denom, value=-lr / (1 - b1 ** 3))

    # torch._foreach splits a large tensor over many launches: at n 3,080,
    # 20 calls outran the launch queue (time_ms raised)
    reps = 20 if n <= 1024 else 5
    ms = time_ms(lambda: masked_adam(p, g, m, v, scalars), reps=reps)
    plain_ms = time_ms(lambda: masked_adam_plain(p, g, m, v, scalars), reps=reps)
    lib_ms = time_ms(lib, reps=reps)
    ms2 = time_ms(lambda: masked_adam(p, g, m, v, scalars), reps=reps)
    nbytes = 7 * 4 * p.numel()  # p, g, m, v read; p, m, v written
    timing = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, ms_repeat=ms2,
                  shape=f"n={n} (n,256,256) fp32",
                  gbps=nbytes / (min(ms, ms2) * 1e-3) / 1e9,
                  bound=bound(nbytes, 12 * p.numel(), "fp32"))  # ~12 flops per element
    log(f"[K2 masked_adam] time at {timing['shape']}: kernel {ms:.4f} ms "
        f"(repeat {ms2:.4f}), plain {plain_ms:.4f} ms, library torch._foreach "
        f"{lib_ms:.4f} ms; kernel {timing['gbps']:.0f} GB/s of 28 B/element; bound "
        f"{timing['bound'][0]:.3e} ms ({timing['bound'][1]})")
    return worst, timing


def check_masked_adam():
    return _k2_case(K1_N, 1)


def check_masked_adam_stacks(stacked_blocks):
    """K2 at run G's shapes: one launch over a module's whole padded stack,
    (L * n_max, 256, 256), for each distinct size in
    run G's stacked_blocks, every 4th block's grad 0 (the padding). Returns
    [{"n", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
    "bound_by"}] (the card beside them in the log)."""
    import torch
    out = []
    for n in sorted({shape[0] * shape[1] for shape in stacked_blocks.values()}):
        err, t = _k2_case(n, 2, zero_every=4)
        out.append(dict(n=n, max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                        library_ms=t["lib_ms"], bound_ms=t["bound"][0], bound_by=t["bound"][1]))
        torch.cuda.empty_cache()
    log(f"[K2 masked_adam] at run G's stacks: " + "; ".join(
        f"n={r['n']} err {r['max_abs_err']:.1e} kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f}, torch._foreach {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}"
        for r in out) + f" ({CARD['smi']})")
    return out


def _k3_case(b, s, hq, hkv, hd, dtype, rng):
    """One K3 shape: every kernel against its plain version on the same
    inputs. Returns ({tensor: max abs err}, {kernel: max abs err}, the
    inputs of _k3_times)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3

    dev, dt = torch.device("cuda"), torch_dtype(dtype)
    half = dtype != "fp32"  # the mma bodies, bf16 and fp16

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
    plan = k3.plan_partitions(b, s, hq, hkv) if half else 1
    info = {"P": plan}
    if half and g > 1:
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
        # both round the same fp32 sum (in another order) to bf16 (fp16) once
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
    e = elem_bytes(dtype)
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
                f"{n} {ms:.3e} ms ({by})" for n, (ms, by) in bounds.items()))
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
                    f"{comb[0]:.4f} ms, plain {comb[1]:.4f} ms; bound {comb_bnd[0]:.3e} ms "
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
                f"bound {bnd[0]:.3e} ms ({bnd[1]})")
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
    dt = torch_dtype(dtype)
    t_form = form == "q8mm_t"
    act = torch.randn((t, k if t_form else o), generator=gen, device=w.device).to(dt)
    # the dense matmul that frozen_quant none runs: fp16 in an fp16 model, else bf16
    lo = dt if dtype == "fp16" else torch.bfloat16
    wb, ab = w.to(lo), act.to(lo)
    if t_form:
        aq, sa = row_quant(act)
        kernel = lambda: k4.q8mm_t(aq, sa, wq, sw, dt)
        plain = lambda a=aq: k4.q8mm_t_plain(a, sa, wq, sw, dt)
        lib = lambda: ((torch._int_mm(aq, wq.t()).float() * sa) * sw).to(dt)
        cublas = lambda: torch.matmul(ab, wb.t())
    else:
        aq, sa = row_quant(act, sw)
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
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
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
                    f"scale pass {lib_ms:.4f} ms; bound {bnd[0]:.3e} ms ({bnd[1]})")
                log(f"[K4 {form}] cuBLAS bf16 matmul of the unquantized operands at {shape}: "
                    f"{bf16_ms:.4f} ms")
                main.setdefault(form, (ms, plain_ms, bnd, lib_ms))
            del kernel, plain, lib, cublas
        del w, wq, sw
        torch.cuda.empty_cache()
    return worst, main


def _rq_rows(t, k, dt, fold, gen):
    """x (T, K) for the row quantization check (and sw (K,) with `fold`):
    rows of magnitudes 1e-2 to 10, the first row zeros, and from the fourth
    on every fourth row built so that its values over the scale sit exactly
    on .5 ties (the row's max 127 * 2^e, the others (j + 0.5) * 2^e; with
    the fold, sw a power of two, so the products stay exact); rows 1, 2
    and 5 hold a NaN, an inf and a -inf."""
    import torch
    dev = "cuda"
    sw = None
    if fold:
        sw = torch.exp2(torch.randint(-10, -4, (k,), generator=gen, device=dev).float())
    mag = torch.pow(10.0, torch.rand((t, 1), generator=gen, device=dev) * 3 - 2)
    v = torch.randn((t, k), generator=gen, device=dev) * mag
    ties = torch.arange(3, t, 4, device=dev)
    if len(ties):
        e = torch.randint(-12, -2, (len(ties), 1), generator=gen, device=dev).float()
        j = torch.randint(-127, 127, (len(ties), k), generator=gen, device=dev).float()
        row = (j + 0.5) * torch.exp2(e)
        row[:, 0] = 127 * torch.exp2(e[:, 0])
        v[ties] = row / (sw if fold else 1.0)
    v[0] = 0
    if t > 5:  # a NaN in row 1, an inf in row 2 and a -inf in row 5
        v[1, k // 3], v[2, k // 2], v[5, k - 1] = float("nan"), float("inf"), float("-inf")
    return v.to(dt), sw


def _nan_diff(a, b):
    """The largest |a - b| over elements, where NaN against NaN and an inf
    against the same inf count 0 (a NaN against a number gives NaN)."""
    import torch
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, torch.zeros_like(a), (a - b).abs()).max())


def _rq_case(t, k, dtype, fold, what, timed, gen, plant=False):
    """One row quantization shape (RQ_SHAPES' fields): xq and sx equal to the
    plain version bit for bit, NaN / inf rows included; with `plant` the
    planted fault (at a main-path shape: at a few rows every scale may
    round alike); timed if `timed`. Returns (err, (ms, plain_ms, bound,
    None) or None)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq
    dt = torch_dtype(dtype)
    x, sw = _rq_rows(t, k, dt, fold, gen)
    before = sum(rq.LAUNCHES.values())
    xq, sx = rq.row_quant(x, sw)
    torch.cuda.synchronize()
    if sum(rq.LAUNCHES.values()) != before + 1:
        raise AssertionError("row_quant: not one launch per call")
    xq_p, sx_p = rq.row_quant_plain(x, sw)
    # bit for bit, a NaN scale against a NaN scale
    err = max(_nan_diff(xq, xq_p), _nan_diff(sx, sx_p))
    if not err == 0:
        raise AssertionError(
            f"row_quant T={t} K={k} {dtype} fold={fold}: {int((xq != xq_p).sum())} values and "
            f"{int((sx != sx_p).sum())} scales differ from the plain version (max abs err "
            f"{err:.3e})")
    x32 = x.float() * (sw if fold else 1.0)
    n_ties = int(((x32 / sx_p).abs().frac() == 0.5).sum())
    n_nan, n_inf = int(torch.isnan(sx).sum()), int(torch.isinf(sx).sum())
    if t > 5 and (n_nan != 1 or n_inf != 2 or (xq[[1, 2, 5]] != 0).any()):
        raise AssertionError(f"row_quant: want the NaN row's scale NaN, the inf rows' inf and "
                             f"their values 0; got {n_nan} NaN and {n_inf} inf scales")
    info = f"{n_ties} values on .5 ties, {n_nan} NaN and {n_inf} inf rows"
    if plant:
        # the planted fault: the scale as a division by 127 (by a tensor:
        # PyTorch's CUDA division by a Python scalar multiplies by its
        # reciprocal)
        amax = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-8)
        sx_f = amax / torch.full_like(amax, 127.0)
        if _nan_diff(sx_f, sx) == 0:
            raise AssertionError("row_quant: the check passes a planted fault (amax / 127)")
        info += (f"; planted fault (amax / 127) rejected: {int((sx_f != sx).sum())} of {t} "
                 "scales differ")
    log(f"[row_quant] T={t} K={k} {dtype} x{', sw folded' if fold else ''} ({what}): xq and "
        f"sx equal to the plain version bit for bit (max abs err {err:.3e}); {info}")
    if not timed:
        return err, None
    e = x.element_size()
    nbytes = t * k * e + t * k + 4 * t + (4 * k if fold else 0)
    bnd = bound(nbytes, (5 if fold else 4) * t * k, "fp32")
    ms = time_ms(lambda: rq.row_quant(x, sw))
    plain_ms = time_ms(lambda: rq.row_quant_plain(x, sw), reps=5)
    ms2 = time_ms(lambda: rq.row_quant(x, sw))
    log(f"[row_quant] time at T={t} K={k} {dtype}{' fold' if fold else ''}: kernel "
        f"{ms:.4f} ms (repeat {ms2:.4f}, {nbytes / (min(ms, ms2) * 1e-3) / 1e9:.0f} GB/s "
        f"of {nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms; bound {bnd[0]:.3e} ms "
        f"({bnd[1]})")
    return err, (ms, plain_ms, bnd, None)


def check_row_quant():
    """K4's prologue, the row quantization kernel, at RQ_SHAPES (_rq_case):
    xq and sx equal to the plain version bit for bit (rows of zeros, ragged
    T, rows on .5 ties, magnitudes 1e-2 to 10, rows holding a NaN or an
    inf, with and without the fold of sw); the planted fault (the scale as
    amax / 127, a division) rejected; times beside the plain version and
    the bound (no single PyTorch call computes it). Then row_quant,
    _quant_kv and the int8 / int4 matmuls on CUDA tensors run under
    torch.cuda.set_sync_debug_mode("error"): no call makes the host wait
    for the device. Returns (worst err, (ms, plain_ms, bound, None) at the
    first shape)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    main = None
    worst = 0.0
    for t, k, dtype, fold, what, timed in RQ_SHAPES:
        err, timing = _rq_case(t, k, dtype, fold, what, timed, gen, plant=main is None)
        worst = max(worst, err)
        main = main or timing
    check_no_sync()
    return worst, main


def check_no_sync():
    """The int8 paths' host-side code makes no host-device synchronisation:
    row_quant (kernel route, plain and folded), the KV quantization of an
    int8 cache, the int8 matmuls (training and decode plans) and the int4
    decode matmul, each once warm, then again under
    set_sync_debug_mode("error"), which raises on a synchronising call."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import _quant_kv
    from sparse_matrix_tuning_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    x = torch.randn((64, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    xt = torch.randn((512, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((64, 5632), generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn((16, 4, 1, 64), generator=gen, device="cuda").to(torch.bfloat16)
    wq, sw = quant.quantize_weight(torch.randn((5632, 2048), generator=gen, device="cuda"))
    w4, s4 = quant.quantize_weight_int4(torch.randn((5632, 2048), generator=gen, device="cuda"))
    calls = {
        "row_quant": lambda: quant.row_quant(x),
        "row_quant with sw folded": lambda: quant.row_quant(g, sw),
        "_quant_kv": lambda: _quant_kv(kv),
        "q8_matmul_t, decode rows": lambda: quant.q8_matmul_t(x, wq, sw),
        "q8_matmul_t, 512 rows": lambda: quant.q8_matmul_t(xt, wq, sw),
        "q8_matmul (g form), decode rows": lambda: quant.q8_matmul(g, wq, sw),
        "q4_matmul_t": lambda: quant.q4_matmul_t(x, w4, s4),
    }
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls.values():
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[sync] no host-device synchronisation under set_sync_debug_mode('error') in: "
        + ", ".join(calls))


def _k5_close(got, want, dtype):
    rtol, atol = K5_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + rtol * want.float().abs()).all()), float(diff.max())


def check_block_correction():
    """K5 at K5_SHAPES: n = 24 unsorted coordinates with repeated out
    blocks, repeated in blocks and a repeated pair, through the wrapper
    (its plan), against the plain version on a copy; two launches equal bit
    for bit; bf16 cases also at every tile shape of K5_PLANS; a planted
    fault (the last j of one run dropped) the check must reject; n = 0
    leaves out untouched; times by tile shape beside the plain version,
    the library (bmm on gathered panels, then index_add_) and the bound.
    Returns (worst err, (ms, plain_ms, bound, library ms) at the first
    shape, {case: ms at the plan} of the timed cases)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, main, timed_ms = 0.0, None, {}
    for t, o, i, dtype, transpose, what, timed in K5_SHAPES:
        dt = torch_dtype(dtype)
        out0 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev, dt)
        src = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev, dt)
        delta = torch.from_numpy(
            rng.standard_normal((K5_N, 256, 256), dtype=np.float32) * np.float32(0.02)).to(dev, dt)
        io, ii = _coords(rng, K5_N, o // 256, i // 256)
        sched = k5.correction_schedule(io, ii, dev)
        got = k5.block_correction(out0.clone(), src, delta, sched, transpose)
        again = k5.block_correction(out0.clone(), src, delta, sched, transpose)
        torch.cuda.synchronize()
        want = k5.block_correction_plain(out0.clone(), src, delta, io, ii, transpose)
        ok, err = _k5_close(got, want, dtype)
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"K5 {what}: max abs err {err:.3e} against the plain version, "
                                 f"over rtol/atol {K5_TOL[dtype]}")
        if not torch.equal(got, again):
            raise AssertionError(f"K5 {what}: two launches differ")
        untouched = torch.ones(o // 256, dtype=torch.bool)
        untouched[torch.from_numpy(io).long()] = False
        cols = untouched.repeat_interleave(256).to(dev)
        if not torch.equal(got[:, cols], out0[:, cols]):
            raise AssertionError(f"K5 {what}: an out block no coordinate names changed")
        forced = []
        for bm, bn in (K5_PLANS if dtype == "bf16" else []):
            f1 = k5._launch(out0.clone(), src, delta, sched, transpose, bm, bn)
            f2 = k5._launch(out0.clone(), src, delta, sched, transpose, bm, bn)
            torch.cuda.synchronize()
            f_ok, f_err = _k5_close(f1, want, dtype)
            if not f_ok or not torch.equal(f1, f2):
                raise AssertionError(f"K5 {what}: {bm} x {bn} tiles: max abs err {f_err:.3e}, "
                                     f"repeat equal {torch.equal(f1, f2)}")
            err = max(err, f_err)
            forced.append(f"{bm}x{bn}")
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
        p = k5.plan(sched.n_runs, t, n_sm) if dtype == "bf16" else None
        log(f"[K5 block_correction] {shape} ({what}): max_abs_err {err:.3e} (rtol/atol "
            f"{K5_TOL[dtype]}), {sched.n_runs} runs" +
            (f", plan {p.bm}x{p.bn} tiles, {p.grid} CTAs; forced tiles {', '.join(forced)} "
             "within tolerance and repeatable" if p else "") +
            f"; two launches equal; planted fault rejected (max abs err {f_err:.3e}); n = 0 "
            "leaves out untouched")
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
            by_plan = {f"{bm}x{bn}": time_ms(
                lambda: k5._launch(buf, src, delta, sched, transpose, bm, bn))
                for bm, bn in K5_PLANS}
            e = 2 if dtype == "bf16" else 4
            # touched out tiles read and written, source panels and delta read
            nbytes = (2 * len(set(io)) + len(set(ii))) * t * 256 * e + K5_N * 65536 * e
            flop = 2.0 * K5_N * t * 65536
            bnd = bound(nbytes, flop, dtype)
            log(f"[K5 block_correction] time at {shape}: kernel {ms:.4f} ms (repeat {ms2:.4f}, "
                f"{flop / (min(ms, ms2) * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"library bmm on gathered panels + index_add_ {lib_ms:.4f} ms; bound "
                f"{bnd[0]:.3e} ms ({bnd[1]}); by tile shape: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in by_plan.items()))
            if main is None:
                main = (ms, plain_ms, bnd, lib_ms)
            timed_ms[what] = ms
        torch.cuda.empty_cache()
    return worst, main, timed_ms


def check_q4_matmul():
    """K6 at K6_SHAPES against its plain version within the summation-order limit (q4_matmul.order_limit), with two
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
        # the two fp32 summation orders' first-order bound
        limit = k6.order_limit(x, w4, s4, k6.splits_for(w4.shape[0], w4.shape[1], n_sm), want)
        diff = (got.float() - want.float()).abs()
        return bool((diff <= limit).all()), float(diff.max()), float((diff / limit).max())

    for t, i, o, dtype, what, timed in K6_SHAPES:
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        w4, s4 = quantize_weight_int4(torch.randn((o, i), generator=gen, device="cuda") / i ** 0.5)
        x = torch.randn((t, i), generator=gen, device="cuda").to(torch.bfloat16)
        before = k6.LAUNCHES
        got = k6.q4mm_t(x, w4, s4, dt)
        again = k6.q4mm_t(x, w4, s4, dt)
        torch.cuda.synchronize()
        if k6.LAUNCHES != before + 2:
            raise AssertionError(f"K6 T={t} I={i} O={o}: not one launch per call")
        if not torch.equal(got, again):
            raise AssertionError(f"K6 T={t} I={i} O={o}: two launches on the same inputs differ")
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
            f"summation-order limit), splits {k6.splits_for(o, i // 2, n_sm)}, one launch a call, "
            "two launches equal bit for bit; planted faults rejected (planes swapped, last "
            "group's scale dropped)")
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
                f"{lib_ms:.4f} ms, dequantize + matmul {deq_ms:.4f} ms; bound {bnd[0]:.3e} ms "
                f"({bnd[1]})")
            if main is None:
                main = (ms, plain_ms, bnd, lib_ms)
            del wdq, kernel
        if t == k6.MAX_ROWS:  # the decode's shapes: times by split count
            planned = k6.splits_for(o, i // 2, n_sm)
            by = {sp: time_ms(lambda sp=sp: k6._launch(x, w4, s4, dt, sp))
                  for sp in sorted({1, 2, 4, 8, 16, planned}) if sp <= i // 256}
            log(f"[K6 q4_matmul] at {shape} by split count (planned {planned}): " + ", ".join(
                f"{sp} {ms_:.4f} ms" for sp, ms_ in by.items()))
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
# the fp16 bodies (--dtype fp16)
# ---------------------------------------------------------------------------

# each fp16 body at run M's (and M8's) shapes: K1 on gate/up at T 2048 (O
# 5632, I 2048) with n 24 and 4 blocks; K3 at b4 s512 hq32 hkv4, hd 64 and
# 128 (the planned P = 4 > 1); the row quantization over gate/up's input and
# the g form's fold over its output gradient; K4 t and g on gate/up; K5 at
# run E's gate/up forward and grad_input plans
FP16_K1 = [(2048, 5632, 2048, 24), (2048, 5632, 2048, 4)]
FP16_K3 = [(4, 512, 32, 4, 64), (4, 512, 32, 4, 128)]
FP16_RQ = [(2048, 2048, "fp16", False, "gate/up input (fp16), run M8", True),
           (2048, 5632, "fp16", True, "the g form's fold over gate/up's fp16 output gradient",
            True)]
FP16_K4 = (2048, 2048, 5632)   # T, K, O: gate/up
FP16_K5 = [(2048, 5632, 2048, True, "gate/up forward (run M8)"),
           (2048, 2048, 5632, False, "gate/up grad_input (run M8)")]
FP16_K3_KERNELS = tuple(f"{n}_fp16" for n in K3_KERNELS)
FP16_TRAIN_KERNELS = ("block_grad_fp16", "masked_adam") + FP16_K3_KERNELS
FP16_Q8_KERNELS = ("q8mm_t_fp16", "q8mm_g_fp16", "row_quant_fp16", "block_correction_fp16")
# the tiny fp16 references' initial loss scale: raised so that the first
# steps of both phases overflow in the backward and are skipped until the
# scale has come down (on the CPU: 4 + 1 overflowed steps of 4 + 4 over the
# dense base, 4 + 0 over the int8 base; the same flags at 0.97x and 1.03x
# the scale, so no step sits on the edge of fp16's range)
FP16_REF_LOSS_SCALE = 2.0 ** 24


def _same_nonfinite(what, got, want):
    """A planted inf or NaN: the kernel's output is non-finite exactly where
    the plain version's is (and somewhere). Returns that count."""
    import torch
    g, w = ~torch.isfinite(got.float()), ~torch.isfinite(want.float())
    if not w.any():
        raise AssertionError(f"{what}: the planted input left the plain version finite")
    if not torch.equal(g, w):
        raise AssertionError(f"{what}: non-finite at {int((g & ~w).sum())} elements where the "
                             f"plain version is finite, finite at {int((w & ~g).sum())} where it "
                             "is not")
    return int(w.sum())


def _fp16_block_grad(rng, n_sm):
    """K1's fp16 body at FP16_K1 through its plan and every forced plan,
    against the plain version at the bf16 tolerance, two launches equal, a
    planted inf in g and NaN in x; timed at each n."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    dev, worst, times = torch.device("cuda"), 0.0, {}
    for t, o, i, n in FP16_K1:
        g2 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev, torch.half)
        x2 = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev, torch.half)
        rb_np, cb_np = _coords(rng, n, o // 256, i // 256)
        rb, cb = torch.from_numpy(rb_np).to(dev), torch.from_numpy(cb_np).to(dev)
        p = k1.plan(n, t, n_sm)
        got, again = k1.block_grad(g2, x2, rb, cb), k1.block_grad(g2, x2, rb, cb)
        torch.cuda.synchronize()
        want = k1.block_grad_plain(g2, x2, rb, cb)
        torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=K1_ATOL)
        if not torch.equal(got, again):
            raise AssertionError(f"K1 fp16 n={n}: two launches differ")
        err = float((got - want).abs().max())
        for bm, splits in K1_PLANS:
            f = k1._launch(g2, x2, rb, cb, bm, min(splits, -(-t // 64)))
            torch.cuda.synchronize()
            torch.testing.assert_close(f, want, rtol=K1_RTOL, atol=K1_ATOL)
            err = max(err, float((f - want).abs().max()))
        worst = max(worst, err)
        g_bad, x_bad = g2.clone(), x2.clone()
        g_bad[7, int(rb_np[0]) * 256 + 3] = float("inf")
        x_bad[9, int(cb_np[1]) * 256 + 5] = float("nan")
        bad = _same_nonfinite("K1 fp16", k1.block_grad(g_bad, x_bad, rb, cb),
                              k1.block_grad_plain(g_bad, x_bad, rb, cb))

        def lib():
            g_rows = g2.reshape(t, -1, 256).index_select(1, rb.long()).transpose(0, 1)
            x_cols = x2.reshape(t, -1, 256).index_select(1, cb.long()).transpose(0, 1)
            return torch.bmm(g_rows.transpose(1, 2), x_cols)

        ms = time_ms(lambda: k1.block_grad(g2, x2, rb, cb))
        plain_ms = time_ms(lambda: k1.block_grad_plain(g2, x2, rb, cb))
        lib_ms = time_ms(lib)
        flop = 2.0 * n * t * 256 * 256
        nbytes = (len(set(rb_np)) + len(set(cb_np))) * t * 256 * 2 + n * 256 * 256 * 4
        times[n] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound=bound(nbytes, flop, "fp16"))
        log(f"[K1 block_grad fp16] T={t} (O,I)=({o},{i}) n={n}: max_abs_err {err:.3e} (plan "
            f"{p.bm}x256/{p.splits}, and the {len(K1_PLANS)} forced plans); two launches equal; "
            f"planted inf in g and NaN in x: {bad} non-finite where the plain version's are; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f}, library bmm on gathered fp16 panels "
            f"{lib_ms:.4f}, bound {times[n]['bound'][0]:.3e} ms ({times[n]['bound'][1]})")
    return worst, times


def _fp16_attention_nonfinite(q, k, v, do, sm, o_ref, lse_ref):
    """Planted non-finite inputs through the five fp16 K3 kernels: a NaN in
    the last query row of q-head 0 (forward), an inf in the last row of dO
    of q-head 1 (backward, the clean forward's o and lse): each output
    non-finite exactly where the plain version's is. Returns the counts."""
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
    counts = {}
    qb = q.clone()
    qb[0, -1, 0, 0] = float("nan")
    (o, lse), (o_p, lse_p) = k3.attn_fwd(qb, k, v, sm), k3.attn_fwd_plain(qb, k, v, sm)
    counts["o"] = _same_nonfinite("K3 attn_fwd fp16 o", o, o_p)
    counts["lse"] = _same_nonfinite("K3 attn_fwd fp16 lse", lse, lse_p)
    dob = do.clone()
    dob[0, -1, 1, 0] = float("inf")
    delta_p = k3.attn_bwd_delta_plain(o_ref, dob)
    counts["delta"] = _same_nonfinite("K3 attn_bwd_delta fp16", k3.attn_bwd_delta(o_ref, dob),
                                      delta_p)
    dk, dv = k3.attn_bwd_dkdv(q, k, v, dob, lse_ref, delta_p, sm)  # the planned P > 1 and reduce
    dk_p, dv_p = k3.attn_bwd_dkdv_plain(q, k, v, dob, lse_ref, delta_p, sm)
    counts["dk"] = _same_nonfinite("K3 attn_bwd_dkdv fp16 dk", dk, dk_p)
    counts["dv"] = _same_nonfinite("K3 attn_bwd_dkdv fp16 dv", dv, dv_p)
    counts["dq"] = _same_nonfinite("K3 attn_bwd_dq fp16", k3.attn_bwd_dq(q, k, v, dob, lse_ref,
                                                                          delta_p, sm),
                                   k3.attn_bwd_dq_plain(q, k, v, dob, lse_ref, delta_p, sm))
    return counts


def _fp16_attention(rng):
    """K3's five fp16 kernels at FP16_K3 (_k3_case: against the plain
    versions at the bf16 bounds, dK/dV over the planned partitions with the
    reduce, a dropped partition rejected, two launches equal), the planted
    non-finite inputs, and the times at the first shape beside SDPA fp16."""
    import torch
    worst, main = {n: 0.0 for n in K3_KERNELS}, None
    for i, (b, s, hq, hkv, hd) in enumerate(FP16_K3):
        errs, per_kernel, info, args = _k3_case(b, s, hq, hkv, hd, "fp16", rng)
        for n, e in per_kernel.items():
            worst[n] = max(worst[n], e)
        q, k, v, do, sm, o_ref, lse_ref, _ = args
        bad = _fp16_attention_nonfinite(q, k, v, do, sm, o_ref, lse_ref)
        shape = f"b{b} s{s} hq{hq} hkv{hkv} hd{hd} fp16"
        log(f"[K3 attention fp16] {shape}: planned P={info['P']}; max_abs_err " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()) + "; planted fault rejected (a dropped "
            f"partition), two launches equal; planted NaN in q / inf in dO, non-finite as the "
            "plain version: " + ", ".join(f"{n} {c}" for n, c in bad.items()))
        if i == 0:
            t = _k3_times(*args)
            bounds = _k3_bounds(b, s, hq, hkv, hd, "fp16", info["P"])
            log(f"[K3 attention fp16] time at {shape}: " + "; ".join(
                f"{n} {t[n][0]:.4f} ms (plain {t[n][1]:.4f}, bound {bounds[n][0]:.3e} "
                f"{bounds[n][1]})" for n in K3_KERNELS if t[n][0] is not None) +
                f"; torch SDPA fp16 fwd {t['sdpa_fwd']:.4f}, bwd {t['sdpa_bwd']:.4f}; dK/dV by "
                "partitions: " + ", ".join(f"P={p} {ms:.4f}" for p, ms in t["dkdv_by_P"].items()))
            main = {n: (*t[n], bounds[n], t["sdpa_fwd"] if n == "attn_fwd" else None)
                    for n in K3_KERNELS if t[n][0] is not None}
        del args
        torch.cuda.empty_cache()
    return worst, main


def _fp16_q8(gen):
    """K4's fp16 epilogue, both forms, on gate/up (_k4_case: bit for bit the
    plain version, the planted fault), with a NaN row scale and an
    overflowing weight (t) or row (g) scale planted: the same NaN and inf
    bits as the plain version; timed beside torch._int_mm + the scale pass
    and cuBLAS fp16."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
    from sparse_matrix_tuning_tpu_torch.ops.quant import quantize_weight, row_quant
    t, k, o = FP16_K4
    w = torch.randn((o, k), generator=gen, device="cuda") / k ** 0.5
    wq, sw = quantize_weight(w)
    out = {}
    for form in K4_KERNELS:
        err, info, (kernel, plain, lib, cublas) = _k4_case(form, w, wq, sw, t, "fp16", gen)
        t_form = form == "q8mm_t"
        act = torch.randn((t, k if t_form else o), generator=gen, device="cuda").half()
        aq, sa = row_quant(act) if t_form else row_quant(act, sw)
        sa_bad = sa.clone()
        sa_bad[3] = float("nan")
        if t_form:
            sw_bad = sw.clone()
            sw_bad[7] = 1e30   # overflows fp16: inf
            got = k4.q8mm_t(aq, sa_bad, wq, sw_bad, torch.half)
            want = k4.q8mm_t_plain(aq, sa_bad, wq, sw_bad, torch.half)
        else:
            sa_bad[4] = 1e30
            got = k4.q8mm_g(aq, sa_bad, wq, torch.half)
            want = k4.q8mm_g_plain(aq, sa_bad, wq, torch.half)
        bad = _same_nonfinite(f"K4 {form} fp16", got, want)
        if _nan_diff(got, want) != 0:
            raise AssertionError(f"K4 {form} fp16: the planted non-finite outputs differ in bits")
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=5)
        lib_ms = time_ms(lib)
        cublas_ms = time_ms(cublas)
        n_out, n_act = (o, k) if t_form else (k, o)
        nbytes = t * n_act + o * k + 4 * t + (4 * o if t_form else 0) + t * n_out * 2
        bnd = bound(nbytes, 2.0 * t * o * k, "int8")
        log(f"[K4 {form} fp16] T={t} K={k} O={o} fp16 out: equal to the plain version bit for "
            f"bit; {info}; planted NaN and overflowing scales: {bad} non-finite, bit for bit "
            f"the plain version's; kernel {ms:.4f} ms, plain {plain_ms:.4f}, library "
            f"torch._int_mm + scale pass {lib_ms:.4f}, cuBLAS fp16 of the unquantized operands "
            f"{cublas_ms:.4f}; bound {bnd[0]:.3e} ms ({bnd[1]})")
        out[form] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bnd, lib_ms=lib_ms,
                         cublas_fp16_ms=cublas_ms)
        del kernel, plain, lib, cublas
    return out


def _fp16_correction(rng, n_sm):
    """K5's fp16 body at FP16_K5 through its plan and every tile shape,
    against the plain version at the bf16 bound, two launches equal, a
    planted inf in src; timed beside bmm + index_add_ in fp16."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5
    dev, worst, main = torch.device("cuda"), 0.0, {}
    for t, o, i, transpose, what in FP16_K5:
        out0 = torch.from_numpy(rng.standard_normal((t, o), dtype=np.float32)).to(dev, torch.half)
        src = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(dev, torch.half)
        delta = torch.from_numpy(rng.standard_normal((K5_N, 256, 256), dtype=np.float32)
                                 * np.float32(0.02)).to(dev, torch.half)
        io, ii = _coords(rng, K5_N, o // 256, i // 256)
        sched = k5.correction_schedule(io, ii, dev)
        p = k5.plan(sched.n_runs, t, n_sm)
        got = k5.block_correction(out0.clone(), src, delta, sched, transpose)
        again = k5.block_correction(out0.clone(), src, delta, sched, transpose)
        torch.cuda.synchronize()
        want = k5.block_correction_plain(out0.clone(), src, delta, io, ii, transpose)
        ok, err = _k5_close(got, want, "fp16")
        if not ok or not torch.equal(got, again) or not torch.isfinite(got).all():
            raise AssertionError(f"K5 fp16 {what}: max abs err {err:.3e}, repeat equal "
                                 f"{torch.equal(got, again)}")
        for bm, bn in K5_PLANS:
            f = k5._launch(out0.clone(), src, delta, sched, transpose, bm, bn)
            torch.cuda.synchronize()
            f_ok, f_err = _k5_close(f, want, "fp16")
            if not f_ok:
                raise AssertionError(f"K5 fp16 {what}: {bm} x {bn} tiles: max abs err {f_err:.3e}")
            err = max(err, f_err)
        worst = max(worst, err)
        src_bad = src.clone()
        src_bad[5, int(ii[0]) * 256 + 7] = float("inf")
        bad = _same_nonfinite(f"K5 fp16 {what}",
                              k5.block_correction(out0.clone(), src_bad, delta, sched, transpose),
                              k5.block_correction_plain(out0.clone(), src_bad, delta, io, ii,
                                                        transpose))
        buf = out0.clone()
        io_t, ii_t = torch.from_numpy(io).long().to(dev), torch.from_numpy(ii).long().to(dev)

        def lib():
            panels = src.reshape(t, -1, 256).index_select(1, ii_t).transpose(0, 1)
            corr = torch.bmm(panels, delta.transpose(1, 2) if transpose else delta)
            buf.view(t, -1, 256).index_add_(1, io_t, corr.transpose(0, 1))

        ms = time_ms(lambda: k5.block_correction(buf, src, delta, sched, transpose))
        plain_ms = time_ms(lambda: k5.block_correction_plain(buf, src, delta, io, ii, transpose),
                           reps=5)
        lib_ms = time_ms(lib)
        nbytes = (2 * len(set(io)) + len(set(ii))) * t * 256 * 2 + K5_N * 65536 * 2
        bnd = bound(nbytes, 2.0 * K5_N * t * 65536, "fp16")
        log(f"[K5 block_correction fp16] T={t} out {o} src {i} n={K5_N} "
            f"{'D^T' if transpose else 'D'} ({what}): max_abs_err {err:.3e} (plan {p.bm}x{p.bn}, "
            f"and every tile shape); two launches equal; planted inf in src: {bad} non-finite "
            f"where the plain version's are; kernel {ms:.4f} ms, plain {plain_ms:.4f}, library "
            f"bmm + index_add_ fp16 {lib_ms:.4f}; bound {bnd[0]:.3e} ms ({bnd[1]})")
        main[what] = dict(ms=ms, plain_ms=plain_ms, bound=bnd, lib_ms=lib_ms)
        torch.cuda.empty_cache()
    return worst, main


def check_fp16_kernels():
    """Every fp16 body at run M's and M8's shapes against its plain version
    (K1, K3, K5 at their bf16 bounds; the row quantization and K4 bit for
    bit), each with planted non-finite inputs, timed beside its plain
    version, its library call and its bound (fp16 peak 989 TFLOP/s, 3.35
    TB/s). Returns {kernel name: (max_abs_err, ms, plain_ms, bound, library
    ms, extra fields)}."""
    import numpy as np
    import torch
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    k1_err, k1_t = _fp16_block_grad(rng, n_sm)
    m = k1_t[FP16_K1[0][3]]
    res["block_grad_fp16"] = (k1_err, m["ms"], m["plain_ms"], m["bound"], m["lib_ms"],
                              {"ms_by_n": {n: v["ms"] for n, v in k1_t.items()}})
    k3_err, k3_t = _fp16_attention(rng)
    for n in K3_KERNELS:
        res[f"{n}_fp16"] = (k3_err[n], *k3_t[n], {})
    rq_err, rq_main = 0.0, None
    for t, k, dtype, fold, what, timed in FP16_RQ:
        err, timing = _rq_case(t, k, dtype, fold, what, timed, gen, plant=rq_main is None)
        rq_err = max(rq_err, err)
        rq_main = rq_main or timing
    res["row_quant_fp16"] = (rq_err, *rq_main, {})
    for form, r in _fp16_q8(gen).items():
        res[f"{form}_fp16"] = (r["err"], r["ms"], r["plain_ms"], r["bound"], r["lib_ms"],
                               {"cublas_fp16_ms": r["cublas_fp16_ms"]})
    k5_err, k5_t = _fp16_correction(rng, n_sm)
    first = k5_t[FP16_K5[0][4]]
    res["block_correction_fp16"] = (k5_err, first["ms"], first["plain_ms"], first["bound"],
                                    first["lib_ms"], {"ms_by_case": {w: v["ms"]
                                                                     for w, v in k5_t.items()}})
    torch.cuda.empty_cache()
    return res


def check_small_fp16_reference(frozen_quant="none", scan_layers="auto"):
    """Tiny fp16 two-phase runs with dynamic loss scaling from
    FP16_REF_LOSS_SCALE, on the GPU (the fp16 bodies) against the CPU (plain
    versions): the overflow flags and loss scales equal step for step, the
    losses and the eval loss within rtol 1e-3, the same plan, and the GPU
    run through the fp16 bodies only (no bf16 launch of K1 or K3). Both
    sides take the fused attention ("fullk": K3 on the GPU, its plain
    version on the CPU): the einsum attention rounds dP = dO V^T to fp16
    and overflows at a scale where K3, which keeps dP in fp32, does not
    (on the card: the int8 run's first sparse step, at 2^24)."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(vocab_size=512)
    kw = dict(dtype="fp16", bs=4, seq=64, full_ft_steps=4, sparse_steps=4, eval_batches=1,
              ratios=(0.05, 0.05), log_fn=lambda m: None, frozen_quant=frozen_quant,
              attn_impl="fullk",
              cfg_extra={"init_loss_scale": FP16_REF_LOSS_SCALE, "scan_layers": scan_layers})
    gpu = run_main_path(cfg, "cuda", **kw)
    cpu = run_main_path(cfg, "cpu", **kw)
    tag = f"frozen_quant {frozen_quant}, scan_layers {scan_layers}"
    if gpu["overflow"] != cpu["overflow"] or gpu["loss_scale"] != cpu["loss_scale"]:
        raise AssertionError(f"tiny fp16 run ({tag}): overflow flags / scales differ, GPU "
                             f"{gpu['overflow']} {gpu['loss_scale']}, CPU {cpu['overflow']} "
                             f"{cpu['loss_scale']}")
    if not any(gpu["overflow"]) or all(gpu["overflow"]):
        raise AssertionError(f"tiny fp16 run ({tag}): want some steps overflowed and some not, "
                             f"got {gpu['overflow']}")
    np.testing.assert_allclose(gpu["loss"] + [gpu["eval_loss"]], cpu["loss"] + [cpu["eval_loss"]],
                               rtol=1e-3)
    if gpu["plan"]["fingerprint"] != cpu["plan"]["fingerprint"]:
        raise AssertionError(f"tiny fp16 run ({tag}): GPU and CPU plans differ")
    la = gpu["launches"]
    needed = ("block_grad_fp16", "masked_adam", "attn_fwd_fp16", "attn_bwd_delta_fp16",
              "attn_bwd_dkdv_fp16", "attn_bwd_dq_fp16") + (
        ("q8mm_t_fp16", "q8mm_g_fp16", "row_quant_fp16") if frozen_quant == "int8" else ())
    if scan_layers != "on" and frozen_quant == "int8":
        needed += ("block_correction_fp16",)
    if not all(la[n] > 0 for n in needed) or any(la[n] for n in ("block_grad",) + K3_KERNELS):
        raise AssertionError(f"tiny fp16 run ({tag}): launches {la}")
    log(f"[reference] tiny fp16 run, {tag}, init loss scale {FP16_REF_LOSS_SCALE:.0f}, GPU fp16 "
        f"bodies vs CPU plain: overflow {gpu['overflow']} and loss scales {gpu['loss_scale']} "
        f"equal step for step; losses {gpu['loss']} vs {cpu['loss']}, eval loss "
        f"{gpu['eval_loss']:.6f} vs {cpu['eval_loss']:.6f}; same plan; GPU launches {la}")


def check_fp16_run(m, ref, tag, ref_tag, int8=False):
    """Run M (M8: int8 base) against A (E): finite losses, the fp16 bodies
    launched and the 16-bit ones of bf16 not (the int8 head keeps its fp32
    K4 and row quantization: the hidden states go to it in fp32, as in
    JAX), one row quantization a K4 call, and no more than one host sync a
    sparse step above the bf16 run's."""
    lm = m["launches"]
    need = FP16_TRAIN_KERNELS + (FP16_Q8_KERNELS if int8 else ())
    if not all(lm[n] > 0 for n in need) or any(lm[n] for n in ("block_grad",) + K3_KERNELS):
        raise AssertionError(f"run {tag} launches: {lm}")
    if int8:
        if lm["block_correction"]:
            raise AssertionError(f"run {tag}: K5's bf16 or fp32 body launched: {lm}")
        if lm["row_quant"] + lm["row_quant_fp16"] != sum(lm[n] for n in (
                "q8mm_t", "q8mm_g", "q8mm_t_fp16", "q8mm_g_fp16")):
            raise AssertionError(f"run {tag}: not one row quantization launch per K4 call: {lm}")
    elif any(lm[n] for n in Q8_KERNELS + FP16_Q8_KERNELS + ("q4_matmul",)):
        raise AssertionError(f"run {tag} (fp16 base) launched an int8 or int4 kernel: {lm}")
    if any(ref["launches"][n] for n in FP16_TRAIN_KERNELS[:1] + FP16_K3_KERNELS
           + FP16_Q8_KERNELS):
        raise AssertionError(f"run {ref_tag} (bf16) launched an fp16 body: {ref['launches']}")
    if m["sparse_step_syncs"] > ref["sparse_step_syncs"] + 1:
        raise AssertionError(f"run {tag}: {m['sparse_step_syncs']} host syncs a sparse step, "
                             f"{ref_tag} {ref['sparse_step_syncs']}")
    log(f"[{tag}] loss scale by step {m['loss_scale']}, overflow {m['overflow']}; host-device "
        f"syncs a sparse step {m['sparse_step_syncs']} against {ref_tag}'s "
        f"{ref['sparse_step_syncs']} ({CARD['smi']})")


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
    from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq
    k2.LAUNCHES = 0
    k6.LAUNCHES = 0
    for counts in (k1.LAUNCHES, k3.LAUNCHES, k7.LAUNCHES, k4.LAUNCHES, rq.LAUNCHES,
                   k5.LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches():
    """Every kernel's launch count since the last reset_launches(), the fp16
    bodies under their own names ("..._fp16")."""
    from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7
    from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q4_matmul as k6
    from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4
    from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq
    return {**k1.LAUNCHES, "masked_adam": k2.LAUNCHES, **k3.LAUNCHES, **k7.LAUNCHES,
            **k4.LAUNCHES, **rq.LAUNCHES, **k5.LAUNCHES, "q4_matmul": k6.LAUNCHES}


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
                  keep_decode_params=False, frozen_quant="none", loss_impl="auto",
                  count_syncs=False, mode="matrix", keep_state=False, decode_leg=False,
                  cfg_extra=None):
    """SMTTrainer.fit through warm-up -> conversion -> sparse -> eval ->
    final export, with per-phase step times and peak memory; mode "matrix"
    (the block ratios) or "channel" (--channel_sparsity at the CLI's 30
    attention and 30 MLP channels: a warm-up that only harvests
    activations, then whole input columns train). Checks finiteness, a
    non-empty plan, the merged weights (frozen ones bitwise the
    conversion-time weights, selected blocks or columns the trainables),
    the export against merged_params(), and, with frozen_quant="int8" (host
    offload and the int8 head follow), that no dense layer weight or head
    is left on the device: in channel mode at 12 layers or more the
    conversion builds the int8 scan state (scan_phase.resolve_scan_layers),
    whose stacks must then be (L, 1) placeholders with the host store
    holding them. Returns a summary, with trainer.decode_params()
    under "decode_params" if asked for, and with count_syncs the eval ms
    (eval_ms) and the host-device syncs of one more sparse step
    (sparse_step_syncs), both after the checks. keep_state: the
    conversion runs at the last warm-up step's end, and each trainable
    leaf's change over the sparse steps and its Adam m are kept on the host
    (_scan_reference_faults reads them); decode_leg: run_scan_decode's int8
    leg over the trained scan state, last. cfg_extra: more SMTConfig fields
    (init_loss_scale, scan_layers). Under fp16 each step's loss scale and
    overflow flag are kept ("loss_scale", "overflow"; a step whose loss
    overflowed is skipped by fit and not among them)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree, init_params
    from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK
    from sparse_matrix_tuning_tpu_torch.train.convert import LAYER_LINEARS
    from sparse_matrix_tuning_tpu_torch.train.steps import _use_chunked_loss
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = SMTConfig(
        data_path=["synthetic"], model_name_or_path="random-init", dtype=dtype,
        gradient_checkpointing=True, matrix_sparsity=mode == "matrix",
        channel_sparsity=mode == "channel", full_ft_steps=full_ft_steps,
        downsample_attention_blocks_ratio=ratios[0],
        downsample_mlp_blocks_ratio=ratios[1],
        # recipes/smt_commonsense.sh hyper-parameters
        ft_learning_rate=9.865e-6, smt_lr=9.865e-6, calculate_strategy="abs_mean",
        per_device_ft_batch_size=bs, per_device_eval_batch_size=bs,
        max_seq_len=seq, seq_buckets=[seq], num_ft_epochs=1, eval_step=0,
        save_steps=0, log_steps=1, throughput_steps=10 ** 9, seed=1234,
        attn_impl=attn_impl, output_dir=out_dir, frozen_quant=frozen_quant,
        loss_impl=loss_impl, **(cfg_extra or {}))
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

    summary = {"n_params": n_params, "step_ms": [], "phase": [], "loss": [], "grad_norm": [],
               "peak": {}, "loss_scale": [], "overflow": []}
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
        if trainer.phase == "sparse":
            summary["grad_norm"].append(float(metrics["grad_norm"]))
        if "loss_scale" in metrics:
            summary["loss_scale"].append(float(metrics["loss_scale"]))
            summary["overflow"].append(bool(metrics["overflow"]))
        if step == full_ft_steps:
            summary["peak"]["warmup"] = peak_and_reset()
            summary["launches_warmup"] = launches()
            # dense weights at conversion: the master cast to the param dtype
            at_conversion = trainer.merged_params()
            snap["params"] = {li: {m: w.to("cpu") for m, w in layer.items()}
                              for li, layer in at_conversion["layers"].items()}
            snap["lm_head"] = at_conversion["lm_head"].to("cpu")
            del at_conversion
            if keep_state:
                trainer.maybe_convert()
                snap["trainable"] = {k: t.detach().to("cpu", copy=True)
                                     for k, t in trainer.state["trainable"].items()}
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
    summary["plan"] = {"mode": plan.mode, "linears": len(plan.linears), "blocks": sum(
        lp.n_blocks for lp in plan.linears.values()), "channels": sum(
        lp.n_channels for lp in plan.linears.values()),
        "trainable_params": plan.trainable_params, "fingerprint": plan.fingerprint()}

    # int8 frozen base with host offload: no dense (O, I) layer weight and
    # no head is left on the device, only their 1-element placeholders (over
    # the scan state: (L, 1) stacks, the host store holding every stack)
    summary["offloaded"] = None
    summary["scan"] = trainer._scan
    if frozen_quant == "int8":
        if trainer._scan:
            stacked = trainer.state["params"]["layers_stacked"]
            dense = [m for m in LAYER_LINEARS if tuple(stacked[m].shape) != (
                model_cfg.num_hidden_layers, 1) or m not in (trainer._host_frozen or {})]
        else:
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
                trained = trained_entries(trainer, ks).detach().to("cpu", w.dtype)
                if plan.mode == "channel":
                    mask[:, list(lp.channels)] = True
                    if not torch.equal(w[:, plan.channel_index(ks, "cpu")], trained):
                        raise AssertionError(f"{li}.{mod}: selected columns differ from the "
                                             "trainables")
                else:
                    for rb, cb in lp.blocks:
                        mask[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = True
                    w4 = w.view(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
                    rbs, cbs = plan.block_index(ks, "cpu")
                    if not torch.equal(w4[rbs, :, cbs, :], trained):
                        raise AssertionError(f"{li}.{mod}: selected blocks differ from the "
                                             "trainables")
                if not torch.equal(w[~mask], before[~mask]):
                    raise AssertionError(f"{li}.{mod} changed outside its selected "
                                         f"{'columns' if plan.mode == 'channel' else 'blocks'}")
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
    if keep_state:
        summary["change"] = {k: trainer.state["trainable"][k].detach().to("cpu") - t
                             for k, t in snap["trainable"].items()}
        summary["m"] = {k: t.to("cpu") for k, t in trainer.state["m"].items()}
    if keep_decode_params:
        summary["decode_params"] = trainer.decode_params()
        if count_syncs:  # the step it counts must not move the weights handed on
            from sparse_matrix_tuning_tpu_torch.models.llama import tree_map
            summary["decode_params"] = tree_map(torch.clone, summary["decode_params"])
    if count_syncs:
        summary.update(eval_and_syncs(trainer, train_ds, eval_ds, bs, seq))
    if decode_leg:
        summary["decode"] = run_scan_decode(trainer, model_cfg, tag="J", legs=("8",))
    return summary


def trained_entries(trainer, ks):
    """Linear ks's trained blocks (n, 256, 256) or columns (O, n), in its
    plan's order, from the per-layer state or from the stacks of the scan
    state (whose valid entries come first, in plan order)."""
    trainable = trainer.state["trainable"]
    if not trainer._scan:
        return trainable[ks]
    lp = trainer.plan.linears[ks]
    t = trainable[lp.module][lp.layer]
    return t[:, :lp.n_channels] if trainer.plan.mode == "channel" else t[:lp.n_blocks]


def eval_and_syncs(trainer, train_ds, eval_ds, bs, seq):
    """The eval loss over eval_ds, timed ({"eval_ms"}: all its batches), and
    the host-device syncs of one more sparse step on the first training
    batch ({"sparse_step_syncs"}, counted as utils/profile_steps._syncs
    counts them, the loss's read included)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.data.sft import batch_iterator
    from sparse_matrix_tuning_tpu_torch.utils.profile_steps import _syncs

    batches = list(batch_iterator(eval_ds, bs, 0, [seq], 1234, 0, shuffle=False,
                                  drop_last=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.evaluate(batches)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    batch = next(batch_iterator(train_ds, bs, 0, [seq], 1234, 0))
    syncs = _syncs(lambda: float(trainer.train_step(batch)["loss"]))
    return {"eval_ms": eval_ms, "eval_batches": len(batches), "sparse_step_syncs": syncs}


def check_small_reference(frozen_quant="none", loss_impl="auto", mode="matrix"):
    """Tiny fp32 two-phase run on the GPU (attn_impl "auto": K3) against the
    same run on the CPU (plain versions, einsum attention): losses and plan
    must agree, and every kernel of the path must have launched on the GPU.
    With frozen_quant="int8" the sparse phase runs K4 and K5 (with
    loss_impl="chunked", K4 also on the loss's ragged T = bs * (seq - 1)). The bf16 base holds
    the losses to rtol 1e-4. The int8 base to 1e-3: its integer products are
    exact on both devices, but an activation that differs in its last fp32
    bit between them can round to the neighbouring int8 step. mode
    "channel": run H's path (K3 and K2, no K1)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(vocab_size=512)
    kw = dict(dtype="fp32", bs=4, seq=64, full_ft_steps=2, sparse_steps=4,
              eval_batches=1, ratios=(0.05, 0.05), log_fn=lambda m: None,
              frozen_quant=frozen_quant, loss_impl=loss_impl, mode=mode)
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
    if mode == "channel":
        needed = tuple(n for n in needed if n != "block_grad")
        if gpu["launches"]["block_grad"]:
            raise AssertionError(f"tiny channel run launched K1: {gpu['launches']}")
    if not all(gpu["launches"][n] > 0 for n in needed):
        raise AssertionError(f"tiny GPU run did not launch every kernel: {gpu['launches']}")
    worst = float(np.max(np.abs(np.array(gpu["loss"]) - np.array(cpu["loss"]))
                         / np.abs(np.array(cpu["loss"]))))
    log(f"[reference] tiny fp32 {mode} run, frozen_quant {frozen_quant}, loss "
        f"{gpu['loss_path']}, GPU "
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
        f"{s['selected_elems_changed'][1]}, selected {'columns' if s['plan']['mode'] == 'channel' else 'blocks'} "
        "equal to the trainables"
        + (f"; {s['offloaded']} dense weights offloaded to the host, none left on the device"
           if s["offloaded"] is not None else ""))
    log(f"[{tag}] kernel launches: {s['launches']} (warm-up: {s['launches_warmup']})")
    if "sparse_step_syncs" in s:
        log(f"[{tag}] eval {s['eval_ms']:.1f} ms for {s['eval_batches']} batches; host-device "
            f"syncs in a sparse step {s['sparse_step_syncs']} ({CARD['smi']})")


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
             ("q8mm_t", "row_quant", "block_correction")),
            ("F2", "int8", None, 64, ("q8mm_t", "row_quant", "cached_attn"),
             ("q4_matmul", "block_correction")),
            ("F3", "int4", plan, 64, ("q4_matmul", "block_correction", "cached_attn"),
             ("q8mm_t", "row_quant"))):
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


def time_at_plan_n(plan_path):
    """The blocks per linear of run A's exported plan (smt_plan.json): the
    min, median and max n over the attention and the MLP linears, logged;
    then K1 and K5 timed at those n (utils/time_sparse.py's cases: K1 at
    A's T on gate/up and q, K5 at E's gate/up forward and grad_input and at
    F3's decode rows). Returns {"n": {...}, "times": [...]}."""
    from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
    from sparse_matrix_tuning_tpu_torch.utils.time_sparse import time_cases

    with open(plan_path) as f:
        plan = SMTPlan.from_json(f.read())
    stats = {}
    for group, mods in (("attention", ("q_proj", "k_proj", "v_proj")),
                        ("mlp", ("gate_proj", "up_proj", "down_proj"))):
        ns = sorted(lp.n_blocks for lp in plan.linears.values() if lp.module in mods)
        if ns:
            stats[group] = dict(linears=len(ns), blocks=sum(ns), min=ns[0],
                                median=statistics.median_low(ns), max=ns[-1])
    ns = sorted(lp.n_blocks for lp in plan.linears.values())
    stats["all"] = dict(linears=len(ns), blocks=sum(ns), min=ns[0],
                        median=statistics.median_low(ns), max=ns[-1])
    log(f"[plan n] run A's smt_plan.json, blocks per planned linear: " + "; ".join(
        f"{g} {v['linears']} linears, {v['blocks']} blocks, min {v['min']}, median "
        f"{v['median']}, max {v['max']}" for g, v in stats.items()))
    n_values = sorted({stats["all"]["min"], stats["all"]["median"], stats["all"]["max"]})
    return {"n": stats, "times": time_cases(n_values, time_ms, bound, log)}


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


# ---------------------------------------------------------------------------
# continuation training over the int8 scan state (--sparse_from_plan)
# ---------------------------------------------------------------------------

SCAN_KERNELS = TRAIN_KERNELS + Q8_KERNELS  # every kernel run G must launch


def run_scan_continuation(model_dir, plan_path, model_cfg, device, *, dtype="bf16", bs=4,
                          seq=512, sparse_steps=4, eval_batches=2, out_dir=None,
                          count_syncs=False, keep_state=False, decode_legs=False):
    """Runs G and I: what `cli.fine_tune --frozen_quant int8
    --sparse_from_plan` runs, SMTTrainer.sparse_scan_from_hf (the checkpoint
    in model_dir quantized while it loads into the int8 scan state, the
    plan from plan_path, matrix or channel) then fit: `sparse_steps` sparse
    steps, the eval loss, the final export. Recipe learning rate, remat,
    attention "auto", int8 head. Checks: finite losses, no dense layer
    weight or head on the device, and the export against the checkpoint it
    was loaded from: every tensor bit for bit but the valid trained blocks
    (or columns), which equal the trainables. Returns a summary (launches
    zeroed just before fit, read just after; losses and grad norms by step;
    with keep_state, on the host, each module's trainables' change over fit
    and its Adam moment m; with decode_legs, run_scan_decode's legs over
    the trained state, last, as they consume it)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, SMTPlan
    from sparse_matrix_tuning_tpu_torch.train.convert import LAYER_LINEARS
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    device = torch.device(device)
    cuda = device.type == "cuda"
    with open(plan_path) as f:
        plan = SMTPlan.from_json(f.read())
    cfg = SMTConfig(
        data_path=["synthetic"], model_name_or_path=model_dir, dtype=dtype,
        gradient_checkpointing=True, matrix_sparsity=plan.mode == "matrix",
        channel_sparsity=plan.mode == "channel", frozen_quant="int8",
        sparse_from_plan=plan_path, ft_learning_rate=9.865e-6, smt_lr=9.865e-6,
        per_device_ft_batch_size=bs, per_device_eval_batch_size=bs, max_seq_len=seq,
        seq_buckets=[seq], num_ft_epochs=1, eval_step=0, save_steps=0, log_steps=1,
        throughput_steps=10 ** 9, seed=1234, output_dir=out_dir)
    train_ds = synthetic_sft(sparse_steps * bs, seq, model_cfg.vocab_size, 1)
    eval_ds = synthetic_sft(eval_batches * bs, seq, model_cfg.vocab_size, 2)
    tag = "I" if plan.mode == "channel" else "G"
    gib = 1024 ** 3
    summary = {"step_ms": [], "loss": [], "grad_norm": []}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = SMTTrainer.sparse_scan_from_hf(cfg, model_dir, plan, total_steps=sparse_steps,
                                             model_cfg=model_cfg, device=device)
    if cuda:
        torch.cuda.synchronize()
        summary["load_peak_gib"] = (torch.cuda.max_memory_allocated() - before) / gib
        summary["resident_gib"] = (torch.cuda.memory_allocated() - before) / gib
        torch.cuda.reset_peak_memory_stats()
    summary["load_s"] = time.perf_counter() - t0
    state = trainer.state
    stacked = state["params"]["layers_stacked"]
    dense = [m for m in LAYER_LINEARS
             if m in stacked and tuple(stacked[m].shape) != (model_cfg.num_hidden_layers, 1)]
    if dense or state["params"]["lm_head"].dim() == 2 or "q_head" not in state:
        raise AssertionError(f"run {tag}: dense layer weights {dense} or a dense head on the "
                             "device, or no int8 head")
    summary["stacked_blocks"] = {m: tuple(t.shape) for m, t in state["trainable"].items()}

    marks = {"exit": 0.0}

    def on_metrics(step, metrics):
        summary["step_ms"].append((time.perf_counter() - marks["exit"]) * 1e3)
        summary["loss"].append(float(metrics["loss"]))
        summary["grad_norm"].append(float(metrics["grad_norm"]))
        marks["exit"] = time.perf_counter()

    start = ({m: t.detach().to("cpu", copy=True) for m, t in state["trainable"].items()}
             if keep_state else None)
    reset_launches()
    if cuda:
        torch.cuda.synchronize()
    marks["exit"] = time.perf_counter()
    history = trainer.fit(train_ds, eval_ds, pad_token_id=0, on_metrics=on_metrics)
    if cuda:
        torch.cuda.synchronize()
    summary["launches"] = launches()
    summary["eval_and_export_s"] = time.perf_counter() - marks["exit"]
    summary["eval_loss"] = history["eval_loss"][-1]
    if cuda:
        summary["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / gib
    if not all(np.isfinite(summary["loss"] + [summary["eval_loss"]])):
        raise AssertionError(f"run {tag}: non-finite loss {summary['loss']}, "
                             f"{summary['eval_loss']}")
    if keep_state:
        summary["change"] = {m: state["trainable"][m].detach().to("cpu") - t
                             for m, t in start.items()}
        summary["m"] = {m: t.to("cpu") for m, t in state["m"].items()}

    # the export against the checkpoint it was loaded from
    if out_dir:
        src = load_hf_params(model_dir, model_cfg, dtype=cfg.param_dtype, device="cpu")
        got = load_hf_params(os.path.join(out_dir, "final"), model_cfg, dtype=cfg.param_dtype,
                             device="cpu")
        equal, blocks = 0, 0
        for top in ("embed_tokens", "norm", "lm_head"):
            if not torch.equal(got[top], src[top]):
                raise AssertionError(f"run {tag}'s export changed {top}")
            equal += 1
        for li, layer in src["layers"].items():
            for mod, w in layer.items():
                g = got["layers"][li][mod]
                meta = state["idx"].get(mod)
                keep = [] if meta is None else torch.nonzero(meta["valid"][int(li)]).reshape(-1)
                if not len(keep):
                    if not torch.equal(g, w):
                        raise AssertionError(f"run {tag}'s export changed unplanned {li}.{mod}")
                    equal += 1
                    continue
                mask = torch.zeros(w.shape, dtype=torch.bool)
                t = state["trainable"][mod][int(li)].detach().to("cpu", g.dtype)
                if "ci" in meta:   # the valid trained columns
                    ci = meta["ci"][int(li)].to("cpu")[keep.to("cpu")].long()
                    mask[:, ci] = True
                    if not torch.equal(g[:, ci], t[:, keep.to("cpu")]):
                        raise AssertionError(f"run {tag}'s export: {li}.{mod} columns differ "
                                             "from the trainables")
                    blocks += len(keep)
                else:
                    g4 = g.view(w.shape[0] // BLOCK, BLOCK, w.shape[1] // BLOCK, BLOCK)
                    for j in keep.tolist():
                        rb, cb = int(meta["rb"][int(li), j]), int(meta["cb"][int(li), j])
                        mask[rb * BLOCK:(rb + 1) * BLOCK, cb * BLOCK:(cb + 1) * BLOCK] = True
                        if not torch.equal(g4[rb, :, cb, :], t[j]):
                            raise AssertionError(f"run {tag}'s export: {li}.{mod} block ({rb}, "
                                                 f"{cb}) differs from the trainable")
                        blocks += 1
                if not torch.equal(g[~mask], w[~mask]):
                    raise AssertionError(f"run {tag}'s export changed {li}.{mod} outside its "
                                         "trained entries")
        summary["export_equal_tensors"], summary["export_blocks"] = equal, blocks
        del src, got
    if count_syncs:
        summary.update(eval_and_syncs(trainer, train_ds, eval_ds, bs, seq))
    if decode_legs:
        summary["decode"] = run_scan_decode(trainer, model_cfg)
    return summary


# the decode legs over a channel scan state (run I's, J's): (leg suffix,
# frozen base, the kernels each must launch, those it must not)
SCAN_DECODE_LEGS = (
    ("8", "int8", ("q8mm_t", "row_quant", "cached_attn"),
     ("q4_matmul", "block_correction", "block_grad", "masked_adam")),
    ("4", "int4", ("q4_matmul", "cached_attn"),
     ("q8mm_t", "row_quant", "block_correction", "block_grad", "masked_adam")))


def run_scan_decode(trainer, cfg, new_tokens=32, tag="I", legs=("8", "4")):
    """The decode legs of run I (or J) over its trained scan state, as the
    eval CLI decodes a quantized base: eval/generate.decode_params_from_scan
    (each planned module's column delta built once, the exact bf16 head
    back from the host) through the harness, 16 prompts, greedy, bf16 cache,
    `new_tokens` new tokens; I8 over the int8 base (K4), then I4 over the
    base requantized to int4 (K6 at the decode rows), which consumes the
    int8 base. Each: conversion s, the launches of its path. Returns {leg:
    summary}, the legs tagged tag + suffix."""
    import gc

    import torch
    from sparse_matrix_tuning_tpu_torch.eval.generate import decode_params_from_scan

    examples = synthetic_eval_examples(16, StandInTokenizer(cfg.vocab_size), seed=11)
    out = {}
    for suffix, fq, need, forbid in SCAN_DECODE_LEGS:
        if suffix not in legs:
            continue
        leg_tag = tag + suffix
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = decode_params_from_scan(trainer.state, cfg, trainer._host_frozen,
                                         frozen_quant=fq, consume=fq == "int4")
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t0
        leg = eval_leg(leg_tag, f"run {tag}'s channel scan state, {fq} base, greedy, "
                       f"{new_tokens} new tokens (decode params built in {conv_s:.2f} s)", params,
                       cfg, examples, num_beams=1, max_new_tokens=new_tokens)
        bad = [n for n in need if leg["launches"][n] <= 0] + [n for n in forbid
                                                               if leg["launches"][n]]
        if bad:
            raise AssertionError(f"run {leg_tag} launches {leg['launches']}: wrong for {bad}")
        leg["conversion_s"] = conv_s
        out[leg_tag] = leg
        del params
    if len(out) == 2:
        a, b = out[tag + "8"], out[tag + "4"]
        log(f"[{tag}] decode legs: {tag}8 {a['decode_ms']:.2f} ms/step, {tag}4 "
            f"{b['decode_ms']:.2f} ms/step; token agreement {tag}4 vs {tag}8 "
            f"{float((a['tokens'] == b['tokens']).mean()):.4f} (random weights, int4 against "
            "int8 noise)")
    return out


# What the tiny continuation's steps did, per module, as a share of the
# CPU run's: the norm of (GPU - CPU) over the trainables' change and over
# Adam's first moment m (linear in the grads: it holds the backward, K1
# and K5's grad_input form, which the losses at the recipe's rate cannot
# show; zeroed block grads move the losses by under 1e-4). An activation
# one fp32 bit apart can take the other int8 step, and Adam's sign-like
# first updates spread that: on an H100 the GPU run reads up to 7.9e-2
# and 2.7e-2 (q_proj, one block; the other modules 3.2-4.8e-2 and
# 1.5-1.9e-2), the port against JAX on the CPU 4.1e-2 and 1.1e-2
# (tests/test_torch_scan_train.py); zeroed block grads read 1.0.
SCAN_CHANGE_RTOL, SCAN_M_RTOL = 0.2, 0.1


def _scan_reference_faults(gpu, cpu):
    """The tiny continuation's GPU run against its CPU run: losses, eval
    loss and grad norms within 1e-3 (the int8 base's bound,
    check_small_reference), and per module the trainables' change and m
    within SCAN_CHANGE_RTOL / SCAN_M_RTOL. Returns (faults, the shares by
    leaf and module)."""
    import numpy as np
    faults, worst = [], {"change": {}, "m": {}}
    for what, got, want in (("losses", gpu["loss"] + [gpu["eval_loss"]],
                             cpu["loss"] + [cpu["eval_loss"]]),
                            ("grad norms", gpu["grad_norm"], cpu["grad_norm"])):
        if not np.allclose(got, want, rtol=1e-3, atol=0):
            faults.append(f"{what} {got} vs {want}")
    for leaf, rtol in (("change", SCAN_CHANGE_RTOL), ("m", SCAN_M_RTOL)):
        for mod, want in cpu[leaf].items():
            share = float((gpu[leaf][mod] - want).norm() / want.norm())
            worst[leaf][mod] = share
            if not share <= rtol:
                faults.append(f"{mod} {leaf}: {share:.3e} of the CPU run's norm (limit {rtol})")
    return faults, worst


def _shares(by_mod):
    return "{" + ", ".join(f"{mod} {x:.3e}" for mod, x in by_mod.items()) + "}"


def check_small_scan_reference(mode="matrix"):
    """Tiny fp32 continuation over the int8 scan state, the kernels on the
    GPU against their plain versions on the CPU: a random tiny checkpoint
    and a plan with padded modules and a module absent from one layer, run
    G's path (mode "channel": run I's, a channel plan) on both devices;
    _scan_reference_faults finds none, and every kernel of the path
    launched. Then, in matrix mode, a planted fault, K1's block grads
    zeroed on the GPU, must be found."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
    from sparse_matrix_tuning_tpu_torch.ops import sparse_linear
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan

    cfg = LlamaConfig.tiny(vocab_size=512)
    shapes = {"q_proj": (256, 256), "gate_proj": (512, 256), "up_proj": (512, 256),
              "down_proj": (256, 512)}
    if mode == "channel":
        picks = {("q_proj", 0): (3, 17, 200), ("gate_proj", 0): (1, 255),
                 ("gate_proj", 1): (100, 7, 8), ("up_proj", 0): (1,), ("up_proj", 1): (2,),
                 ("down_proj", 1): (511, 0, 300)}
        plan = SMTPlan("channel", {f"{l}.{m}": LinearPlan(m, l, *shapes[m], channels=ch)
                                   for (m, l), ch in picks.items()})
    else:
        picks = {("q_proj", 0): ((0, 0),), ("gate_proj", 0): ((0, 0), (1, 0)),
                 ("gate_proj", 1): ((1, 0),), ("up_proj", 0): ((0, 0),),
                 ("up_proj", 1): ((1, 0),), ("down_proj", 1): ((0, 0), (0, 1))}
        plan = SMTPlan("matrix", {f"{l}.{m}": LinearPlan(m, l, *shapes[m], blocks)
                                  for (m, l), blocks in picks.items()})
    d = tempfile.mkdtemp(prefix="smoke_scan_ref_", dir=os.path.join(REPO, "build"))
    real_block_grad = sparse_linear.block_grad
    try:
        save_hf_format(init_params(cfg, seed=0, dtype=torch.float32), cfg, d)
        plan_path = os.path.join(d, "smt_plan.json")
        with open(plan_path, "w") as f:
            f.write(plan.to_json())
        kw = dict(dtype="fp32", bs=4, seq=64, sparse_steps=4, eval_batches=1, keep_state=True)
        gpu = run_scan_continuation(d, plan_path, cfg, "cuda", **kw)
        cpu = run_scan_continuation(d, plan_path, cfg, "cpu", **kw)
        if mode == "matrix":
            sparse_linear.block_grad = lambda g, x, rb, cb: torch.zeros_like(
                real_block_grad(g, x, rb, cb))
            planted = run_scan_continuation(d, plan_path, cfg, "cuda", **kw)
    finally:
        sparse_linear.block_grad = real_block_grad
        shutil.rmtree(d, ignore_errors=True)
    faults, worst = _scan_reference_faults(gpu, cpu)
    if faults:
        raise AssertionError(f"tiny {mode} scan continuation, GPU vs CPU: " + "; ".join(faults))
    # fp32 attention walks each group whole: no partitions, no reduce; the
    # channel path has no block grad or block correction
    needed = tuple(n for n in SCAN_KERNELS if n != "attn_bwd_dkdv_reduce" and not (
        mode == "channel" and n in ("block_grad", "block_correction")))
    if not all(gpu["launches"][n] > 0 for n in needed):
        raise AssertionError(f"tiny scan run did not launch every kernel: {gpu['launches']}")
    rel = lambda a, b: float(np.max(np.abs(np.array(a) - np.array(b)) / np.abs(np.array(b))))
    if mode == "channel":
        if gpu["launches"]["block_grad"] or gpu["launches"]["block_correction"]:
            raise AssertionError(f"tiny channel scan run launched K1 or K5: {gpu['launches']}")
        log(f"[reference] tiny fp32 channel continuation over the int8 scan state (padded "
            f"plan), GPU kernels vs CPU plain: losses {gpu['loss']} (worst rel diff "
            f"{rel(gpu['loss'], cpu['loss']):.2e}), grad norms {gpu['grad_norm']} (worst rel "
            f"diff {rel(gpu['grad_norm'], cpu['grad_norm']):.2e}), eval loss "
            f"{gpu['eval_loss']:.6f} vs {cpu['eval_loss']:.6f}; per module, (GPU - CPU) as a "
            f"share of the CPU's norm: trainables' change {_shares(worst['change'])} (limit "
            f"{SCAN_CHANGE_RTOL}), m {_shares(worst['m'])} (limit {SCAN_M_RTOL}); GPU launches "
            f"{gpu['launches']}")
        return
    planted_faults, planted_worst = _scan_reference_faults(planted, cpu)
    if not planted_faults:
        raise AssertionError("tiny scan continuation: zeroed block grads were not found")
    log(f"[reference] tiny fp32 continuation over the int8 scan state (padded plan), GPU "
        f"kernels vs CPU plain: losses {gpu['loss']} (worst rel diff "
        f"{rel(gpu['loss'], cpu['loss']):.2e}), grad norms {gpu['grad_norm']} (worst rel diff "
        f"{rel(gpu['grad_norm'], cpu['grad_norm']):.2e}), eval loss {gpu['eval_loss']:.6f} vs "
        f"{cpu['eval_loss']:.6f}; per module, (GPU - CPU) as a share of the CPU's norm: "
        f"trainables' change {_shares(worst['change'])} (limit {SCAN_CHANGE_RTOL}), m "
        f"{_shares(worst['m'])} (limit {SCAN_M_RTOL}); GPU launches {gpu['launches']}")
    log(f"[reference] planted fault, K1's block grads zeroed: found ({len(planted_faults)} "
        f"faults; change {_shares(planted_worst['change'])}, m {_shares(planted_worst['m'])}; "
        f"first: {planted_faults[0]}); its losses within "
        f"{rel(planted['loss'], gpu['loss']):.2e} of the true GPU run's")


def report_scan_run(g, e, n_warmup, tag="G", src="A"):
    """Run G's (or I's) numbers, each beside the card, and held against run
    E's; src names the run whose export and plan it continues."""
    gib = 1024 ** 3
    card = f"({CARD['smi']})"
    g_ms = statistics.median(g["step_ms"][1:])
    e_ms = statistics.median(e["step_ms"][n_warmup + 1:])
    entries = "columns" if tag == "I" else "blocks"
    log(f"[{tag}] TinyLlama-1.1B, {src}'s export quantized while loading into the int8 scan "
        f"state, {src}'s plan (stacked {entries} {g['stacked_blocks']}), bs 4 x seq 512, remat, "
        f"attn auto (K3), int8 head: losses {g['loss']}, eval loss {g['eval_loss']:.4f} {card}")
    log(f"[{tag}] quantize-on-load {g['load_s']:.2f} s, its peak {g['load_peak_gib']:.2f} GiB, "
        f"resident {g['resident_gib']:.3f} GiB; peak over fit {g['peak_gib']:.2f} GiB "
        f"(E's later sparse steps {e['peak']['later_sparse_steps'] / gib:.2f} GiB) {card}")
    log(f"[{tag}] sparse ms/step {[round(x, 1) for x in g['step_ms']]} (median {g_ms:.1f} over "
        f"steps 2-{len(g['step_ms'])}) vs E's median {e_ms:.1f}; eval {g['eval_ms']:.1f} ms for "
        f"{g['eval_batches']} batches vs E's {e['eval_ms']:.1f}; host-device syncs in a sparse "
        f"step {g['sparse_step_syncs']} vs E's {e['sparse_step_syncs']} {card}")
    log(f"[{tag}] eval + 2 exports {g['eval_and_export_s']:.1f} s; export: "
        f"{g['export_equal_tensors']} tensors bit-equal to {src}'s export, {g['export_blocks']} "
        f"trained {entries} equal to the trainables; kernel launches {g['launches']} {card}")


def check_scan_run(g, e, tag="G"):
    """Run G's launches: every kernel of its path, one row quantization per
    K4 call, no int4 kernel; and no more syncs a sparse step than E's. Run
    I (tag "I", channel mode): the same without K1 and K5, which it must not
    launch."""
    lg = g["launches"]
    path = SCAN_KERNELS if tag == "G" else tuple(
        n for n in SCAN_KERNELS if n not in ("block_grad", "block_correction"))
    bad = [n for n in path if lg[n] <= 0]
    if bad or lg["q4_matmul"] or (tag == "I" and (lg["block_grad"] or lg["block_correction"])):
        raise AssertionError(f"run {tag} launches {lg}: missing {bad}, or a kernel off its path")
    if lg["row_quant"] != lg["q8mm_t"] + lg["q8mm_g"]:
        raise AssertionError(f"run {tag}: not one row quantization launch per K4 call: {lg}")
    if g["sparse_step_syncs"] > e["sparse_step_syncs"]:
        raise AssertionError(f"run {tag} syncs {g['sparse_step_syncs']} times a sparse step, run "
                             f"E {e['sparse_step_syncs']}")


def check_channel_run(h):
    """Run H's launches as the JAX channel path runs: the warm-up is a
    forward only (K3 forward; no K3 backward, no K2), the sparse steps and
    the eval launch K3 forward and backward and K2, and no K1, K5, K4, row
    quantization or K6 (the column products are matmuls)."""
    warm = h["launches_warmup"]
    rest = {n: c - warm[n] for n, c in h["launches"].items()}
    off_path = ("block_grad",) + Q8_KERNELS + ("q4_matmul",)
    bad = ([n for n in ("attn_fwd",) if warm[n] <= 0]
           + [n for n in K3_KERNELS[1:] + ("masked_adam",) + off_path if warm[n]]
           + [n for n in K3_KERNELS + ("masked_adam",) if rest[n] <= 0]
           + [n for n in off_path if rest[n]])
    if bad:
        raise AssertionError(f"run H launches: warm-up {warm}, after it {rest}: wrong for {bad}")


def check_small_deep_channel_reference():
    """Run J's path at the tiny fp32 size widened to 12 layers: channel
    mode with --frozen_quant int8 from a warm-up, which converts into the
    int8 scan state (scan_phase.resolve_scan_layers); the card's run (K3,
    K4 with its row quantization, K2) against the port on the CPU (plain
    versions): the same plan, every kernel of the path launched, and
    _scan_reference_faults finds none (losses, eval loss and grad norms
    within 1e-3, the int8 bound INT8_LOSS_RTOL; per module the trainables'
    change and m within SCAN_CHANGE_RTOL / SCAN_M_RTOL). Without the q/k LR
    boost: at 3x on q/k the grad norms part by 1.0e-3 at step 3 on an
    NVIDIA H100 80GB HBM3 at 700 W, over the 1e-3 bound."""
    import dataclasses

    import numpy as np
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), num_hidden_layers=12)
    kw = dict(dtype="fp32", bs=4, seq=64, full_ft_steps=2, sparse_steps=4, eval_batches=1,
              log_fn=lambda m: None, frozen_quant="int8", mode="channel", keep_state=True)
    gpu = run_main_path(cfg, "cuda", **kw)
    cpu = run_main_path(cfg, "cpu", **kw)
    if not (gpu["scan"] and cpu["scan"]):
        raise AssertionError("tiny 12-layer channel int8 run: not over the scan state")
    if gpu["plan"]["fingerprint"] != cpu["plan"]["fingerprint"]:
        raise AssertionError("tiny 12-layer channel int8 run: GPU and CPU plans differ")
    faults, worst = _scan_reference_faults(gpu, cpu)
    if faults:
        raise AssertionError("tiny 12-layer channel int8 run, GPU vs CPU: " + "; ".join(faults))
    # fp32 attention walks each group whole: no partitions, no reduce
    needed = tuple(n for n in K3_KERNELS if n != "attn_bwd_dkdv_reduce") + (
        "masked_adam", "q8mm_t", "q8mm_g", "row_quant")
    lg = gpu["launches"]
    if not all(lg[n] > 0 for n in needed) or lg["block_grad"] or lg["block_correction"]:
        raise AssertionError(f"tiny 12-layer channel int8 run launches: {lg}")
    rel = float(np.max(np.abs(np.array(gpu["loss"]) - np.array(cpu["loss"]))
                       / np.abs(np.array(cpu["loss"]))))
    log(f"[reference] tiny fp32 channel run at 12 layers, --frozen_quant int8 from a warm-up "
        f"(converted into the int8 scan state), GPU kernels vs CPU plain: losses {gpu['loss']} "
        f"(worst rel diff {rel:.2e}), grad norms {gpu['grad_norm']}, eval loss "
        f"{gpu['eval_loss']:.6f} vs {cpu['eval_loss']:.6f}, same plan; per module, (GPU - CPU) "
        f"as a share of the CPU's norm: trainables' change {_shares(worst['change'])} (limit "
        f"{SCAN_CHANGE_RTOL}), m {_shares(worst['m'])} (limit {SCAN_M_RTOL}); GPU launches {lg}")


def check_deep_channel_run(j, e):
    """Run J's launches and state: the warm-up a forward only (K3 forward;
    no K3 backward, K2 or int8 kernel), the sparse phase over the int8 scan
    state (K3, K2, K4 t and g with one row quantization per K4 call; no K1,
    K5 or K6), and no more syncs a sparse step than E's."""
    if not j["scan"] or not j["offloaded"]:
        raise AssertionError(f"run J did not train over the offloaded int8 scan state: scan "
                             f"{j['scan']}, host store {j['offloaded']}")
    warm = j["launches_warmup"]
    rest = {n: c - warm[n] for n, c in j["launches"].items()}
    bad = ([n for n in ("attn_fwd",) if warm[n] <= 0]
           + [n for n in K3_KERNELS[1:] + ("masked_adam",) + Q8_KERNELS + ("q4_matmul",)
              if warm[n]]
           + [n for n in K3_KERNELS + ("masked_adam",) + K4_KERNELS + ("row_quant",)
              if rest[n] <= 0]
           + [n for n in ("block_grad", "block_correction", "q4_matmul") if rest[n]])
    if bad or rest["row_quant"] != rest["q8mm_t"] + rest["q8mm_g"]:
        raise AssertionError(f"run J launches: warm-up {warm}, after it {rest}: wrong for {bad}")
    if e is not None and j["sparse_step_syncs"] > e["sparse_step_syncs"]:
        raise AssertionError(f"run J syncs {j['sparse_step_syncs']} times a sparse step, run E "
                             f"{e['sparse_step_syncs']}")


def report_deep_channel_run(j, i, n_warmup):
    """Run J's sparse-phase numbers beside run I's (the same layout, loaded
    from a checkpoint rather than converted from a warm-up)."""
    gib = 1024 ** 3
    card = f"({CARD['smi']})"
    j_ms = statistics.median(j["step_ms"][n_warmup + 1:])
    i_ms = statistics.median(i["step_ms"][1:])
    leg, ileg = j["decode"]["J8"], i["decode"]["I8"]
    log(f"[J] over the int8 scan state built from the warm-up: sparse ms/step median {j_ms:.1f} "
        f"vs I's {i_ms:.1f}; later-step peak {j['peak']['later_sparse_steps'] / gib:.2f} GiB vs "
        f"I's fit peak {i['peak_gib']:.2f}; eval {j['eval_ms']:.1f} ms for {j['eval_batches']} "
        f"batches vs I's {i['eval_ms']:.1f}; host-device syncs in a sparse step "
        f"{j['sparse_step_syncs']} vs I's {i['sparse_step_syncs']}; J8 greedy decode "
        f"{leg['decode_ms']:.2f} ms/step vs I8 {ileg['decode_ms']:.2f} {card}")


class Interrupted(Exception):
    """Raised from fit's on_metrics: the run stops as if its process died."""


def run_resume(model_cfg, *, mode="matrix", frozen_quant="none", dropout=0.1, full_ft_steps=2,
               sparse_steps=3, stops=(2, 4), bs=4, seq=512, eval_batches=1):
    """Run R: `cli.fine_tune --dropout 0.1 [--resume_from]` at run A's
    geometry, bf16, remat, the recipe's rates: `full_ft_steps` warm-up and
    `sparse_steps` sparse steps straight through, and the same run stopped
    after each step of `stops` (killed during the next step, after the
    checkpoint of --save_steps gcd(stops) was written) and restored from
    {output_dir}/ckpt into a fresh SMTTrainer, which fit continues. The
    losses, the eval loss and every leaf of the final state must equal the
    straight run's bit for bit: K1's split sum and K3's dK/dV reduce run in
    a fixed order, the dropout masks are seeded by (seed, step, layer), and
    the channel path's index_add_ adds exact zeros at its padded entries
    (its valid columns are distinct). Under dropout no K3 kernel may launch
    in a step that takes gradients, as in JAX (channel mode's warm-up is a
    forward only, without dropout). Returns a summary."""
    import dataclasses
    import gc
    import math

    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree, init_params
    from sparse_matrix_tuning_tpu_torch.train.checkpoint import STATE_FILE, restore_checkpoint
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    mcfg = dataclasses.replace(model_cfg, attention_dropout=dropout)
    n_steps = full_ft_steps + sparse_steps
    train_ds = synthetic_sft(n_steps * bs, seq, mcfg.vocab_size, 1)
    eval_ds = synthetic_sft(eval_batches * bs, seq, mcfg.vocab_size, 2)
    tag = "R" if mode == "matrix" else "R2"

    def config(out_dir):
        return SMTConfig(
            data_path=["synthetic"], model_name_or_path="random-init", dtype="bf16",
            gradient_checkpointing=True, matrix_sparsity=mode == "matrix",
            channel_sparsity=mode == "channel", full_ft_steps=full_ft_steps,
            downsample_attention_blocks_ratio=0.0084, downsample_mlp_blocks_ratio=0.0084,
            ft_learning_rate=9.865e-6, smt_lr=9.865e-6, calculate_strategy="abs_mean",
            per_device_ft_batch_size=bs, per_device_eval_batch_size=bs, max_seq_len=seq,
            seq_buckets=[seq], num_ft_epochs=1, eval_step=0, save_steps=math.gcd(*stops),
            log_steps=10 ** 9, throughput_steps=10 ** 9, seed=1234, output_dir=out_dir,
            frozen_quant=frozen_quant, dropout=dropout)

    def segment(out_dir, resume, stop):
        """A fresh trainer (restored from out_dir/ckpt if `resume`) and fit,
        stopped once step `stop` is done: (losses, trainer, history,
        training launches, restore s)."""
        trainer = SMTTrainer(config(out_dir), mcfg,
                             init_params(mcfg, seed=0, dtype=torch.bfloat16, device="cuda"),
                             total_steps=n_steps, device="cuda")
        restore_s = None
        if resume:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_checkpoint(os.path.join(out_dir, "ckpt"), trainer)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        losses, seen = [], {}

        def on_metrics(step, metrics):
            if stop is not None and step > stop:
                raise Interrupted
            losses.append(float(metrics["loss"]))
            if step == full_ft_steps:
                seen["warmup"] = launches()
            if step == n_steps:
                seen["launches"] = launches()

        reset_launches()
        try:
            history = trainer.fit(train_ds, eval_ds, pad_token_id=0, on_metrics=on_metrics)
        except Interrupted:
            trainer = history = None
        free()
        return losses, trainer, history, seen, restore_s

    t0 = time.perf_counter()
    losses, straight, history, seen, _ = segment(None, False, None)
    train_launches = seen["launches"]
    # the steps that take gradients: all of them in matrix mode; in channel
    # mode the sparse ones (its warm-up is a forward that draws no mask, as
    # in JAX, and keeps the fused attention)
    grad_launches = train_launches if mode == "matrix" else {
        n: c - seen["warmup"][n] for n, c in train_launches.items()}
    straight_s = time.perf_counter() - t0
    want = {k: v.detach().clone() for k, v in flatten_tree(
        {k: v for k, v in straight.state.items() if k != "sched"}).items()}
    want_eval = history["eval_loss"][-1]
    scan, plan_fp = straight._scan, straight.plan.fingerprint()
    del straight, history
    free()

    out_dir = tempfile.mkdtemp(prefix="smoke_resume_", dir=os.path.join(REPO, "build"))
    got_losses, restores, ckpt_gib = [], [], []
    t0 = time.perf_counter()
    try:
        prev = 0
        for stop in tuple(stops) + (None,):
            part, trainer, history, _, restore_s = segment(out_dir, bool(prev), stop)
            got_losses += part
            if restore_s is not None:
                restores.append(round(restore_s, 2))
            if stop is not None:
                ckpt_gib.append(round(os.path.getsize(os.path.join(out_dir, "ckpt", STATE_FILE))
                                      / 1024 ** 3, 3))
            prev = stop
        got = flatten_tree({k: v for k, v in trainer.state.items() if k != "sched"})
        if set(got) != set(want):
            raise AssertionError(f"run {tag}: the resumed state's leaves differ from the "
                                 f"straight run's: {sorted(set(got) ^ set(want))[:6]}")
        differ = [k for k, v in got.items() if not torch.equal(v, want[k])]
        resumed_eval = history["eval_loss"][-1]
        resumed_fp = trainer.plan.fingerprint()
        del trainer, got
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    resumed_s = time.perf_counter() - t0
    if got_losses != losses or differ or resumed_eval != want_eval or resumed_fp != plan_fp:
        raise AssertionError(
            f"run {tag}: the resumed run is not the straight run bit for bit: losses "
            f"{got_losses} vs {losses}, eval {resumed_eval} vs {want_eval}, leaves differing "
            f"{differ[:6]} ({len(differ)}), plans equal {resumed_fp == plan_fp}")
    need = ("masked_adam",) + (("block_grad",) if mode == "matrix" else K4_KERNELS)
    if not all(train_launches[n] > 0 for n in need):
        raise AssertionError(f"run {tag}: launches in training {train_launches}")
    if dropout > 0 and any(grad_launches[n] for n in K3_KERNELS):
        raise AssertionError(f"run {tag}: K3 launched in a training step under dropout: "
                             f"{grad_launches}")
    summary = {"losses": losses, "eval_loss": want_eval, "scan": scan, "stops": list(stops),
               "leaves": len(want), "launches": train_launches, "restore_s": restores,
               "ckpt_gib": ckpt_gib, "straight_s": straight_s, "resumed_s": resumed_s}
    log(f"[{tag}] TinyLlama-1.1B width at {model_cfg.num_hidden_layers} layers, bf16, {mode} mode, "
        f"--frozen_quant {frozen_quant}, --dropout "
        f"{dropout}, bs {bs} x seq {seq}, {full_ft_steps} warm-up + {sparse_steps} sparse steps"
        f"{' over the int8 scan state' if scan else ''}: straight losses {losses}, eval "
        f"{want_eval:.6f}; stopped after steps {list(stops)} and resumed into fresh trainers: "
        f"losses, eval loss and all {len(want)} state leaves bit for bit equal; checkpoint "
        f"state.pt {ckpt_gib} GiB, restores {restores} s; straight {straight_s:.1f} s, "
        f"interrupted and resumed {resumed_s:.1f} s; training launches {train_launches} "
        f"({CARD['smi']})")
    return summary


def main(argv=None):
    """`--only q8` stops after the build, the row quantization, K4 / K5
    checks and the tiny int8 references; `--only q4` after the build, the K6 checks and the tiny
    quantized generation; `--only attn` after the build and the K3 / K7
    checks; `--only sparse` after the build and the K1 / K2 / K5 checks
    (short first calls for a new kernel); `--only scan` runs the build, the
    tiny 12-layer channel int8 reference, run J and runs R and R2 (a short
    call for the conversion into the scan state and resume); `--only fp16`
    runs the build, the fp16 bodies' checks and the tiny fp16 references;
    none prints a result line. With no arguments every phase runs."""
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "q8"], ["--only", "q4"], ["--only", "attn"],
                    ["--only", "sparse"], ["--only", "scan"], ["--only", "fp16"]):
        raise SystemExit("usage: python3 chip_smoke.py [--only q8|q4|attn|sparse|scan|fp16]")
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

    if only == "fp16":
        check_fp16_kernels()
        marks.append(("kernels", time.time()))
        for fq, sl in (("none", "auto"), ("int8", "auto"), ("none", "on")):
            check_small_fp16_reference(fq, sl)
        marks.append(("references", time.time()))
        log("[smoke] --only fp16: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "attn":
        check_attention()
        check_cached_attention()
        marks.append(("kernels", time.time()))
        log("[smoke] --only attn: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "sparse":
        check_block_grad()
        check_masked_adam()
        check_block_correction()
        marks.append(("kernels", time.time()))
        log("[smoke] --only sparse: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "scan":
        check_small_deep_channel_reference()
        marks.append(("references", time.time()))
        model_cfg = LlamaConfig(**TINYLLAMA)
        run_j = run_main_path(model_cfg, "cuda", mode="channel", frozen_quant="int8",
                              count_syncs=True, decode_leg=True)
        report_run("J", "TinyLlama-1.1B bf16, --channel_sparsity --frozen_quant int8 from a "
                   "warm-up, bs 4 x seq 512, remat, attn auto (K3)", run_j, 3)
        check_deep_channel_run(run_j, None)
        del run_j
        torch.cuda.empty_cache()
        marks.append(("J", time.time()))
        run_resume(dataclasses.replace(model_cfg, num_hidden_layers=R_LAYERS))
        run_resume(dataclasses.replace(model_cfg, num_hidden_layers=R2_LAYERS), mode="channel",
                   frozen_quant="int8", stops=(4,))
        marks.append(("R", time.time()))
        log("[smoke] --only scan: seconds by phase: " + ", ".join(
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
    rq_err, rq_time = check_row_quant()
    k4_err, k4_time = check_q8_matmul()
    k5_err, k5_time, k5_timed = check_block_correction()
    if not only_q8:
        k6_err, k6_time = check_q4_matmul()
        fp16 = check_fp16_kernels()
    marks.append(("kernels", time.time()))
    if not only_q8:
        check_small_reference()
        check_small_generation()
        check_small_quant_generation()
        check_small_scan_reference()
        check_small_reference(mode="channel")
        check_small_scan_reference(mode="channel")
        check_small_deep_channel_reference()
        for fq, sl in (("none", "auto"), ("int8", "auto"), ("none", "on")):
            check_small_fp16_reference(fq, sl)
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
        run_a = run_main_path(model_cfg, "cuda", out_dir=out_dir, keep_decode_params=True,
                              count_syncs=True)
        decode_params = run_a.pop("decode_params")
        report_run("A", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn auto (K3)", run_a, 3)
        torch.cuda.empty_cache()
        sparse_times = time_at_plan_n(os.path.join(out_dir, "final", "smt_plan.json"))
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
        # G: continuation training over the int8 scan state from A's export
        # and A's plan (--sparse_from_plan), with its own final export
        g_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
        try:
            run_g = run_scan_continuation(os.path.join(out_dir, "final"),
                                          os.path.join(out_dir, "final", "smt_plan.json"),
                                          model_cfg, "cuda", out_dir=g_dir, count_syncs=True)
        finally:
            shutil.rmtree(g_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        marks.append(("G", time.time()))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # E: as A over the int8 frozen base (K4, K5; int8 head, host offload),
    # with the final export
    out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        run_e = run_main_path(model_cfg, "cuda", out_dir=out_dir, frozen_quant="int8",
                              count_syncs=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    report_run("E", "TinyLlama-1.1B bf16 over the int8 frozen base, bs 4 x seq 512, remat, "
               "attn auto (K3)", run_e, 3)
    compare_int8_run(run_a, run_e, 3)
    report_scan_run(run_g, run_e, 3)
    check_scan_run(run_g, run_e)
    torch.cuda.empty_cache()
    k2_stacks = check_masked_adam_stacks(run_g["stacked_blocks"])
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
    # M: A in fp16 with dynamic loss scaling (from 2^16); M8: E in fp16, over
    # the int8 base; each with its export checked against merged_params()
    fp16_runs = {}
    for tag, fq, ref, ref_tag in (("M", "none", run_a, "A"), ("M8", "int8", run_e, "E")):
        m_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
        try:
            fp16_runs[tag] = run_main_path(model_cfg, "cuda", dtype="fp16", out_dir=m_dir,
                                           frozen_quant=fq, count_syncs=True)
        finally:
            shutil.rmtree(m_dir, ignore_errors=True)
        report_run(tag, "TinyLlama-1.1B fp16 (dynamic loss scaling from 2^16)"
                   + (" over the int8 frozen base" if fq == "int8" else "")
                   + ", bs 4 x seq 512, remat, attn auto (K3)", fp16_runs[tag], 3)
        check_fp16_run(fp16_runs[tag], ref, tag, ref_tag, int8=fq == "int8")
        torch.cuda.empty_cache()
    run_m, run_m8 = fp16_runs["M"], fp16_runs["M8"]
    marks.append(("M", time.time()))
    # H: channel mode (--channel_sparsity at the CLI's 30 attention and 30 MLP
    # channels) as A, with its export; I: its continuation over the int8 scan
    # state (--frozen_quant int8 --sparse_from_plan, H's export and channel
    # plan), held against E, then I's decode legs over the trained state
    h_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        run_h = run_main_path(model_cfg, "cuda", out_dir=h_dir, mode="channel", count_syncs=True)
        report_run("H", "TinyLlama-1.1B bf16, --channel_sparsity (30 + 30 channels), bs 4 x "
                   "seq 512, remat, attn auto (K3)", run_h, 3)
        check_channel_run(run_h)
        torch.cuda.empty_cache()
        marks.append(("H", time.time()))
        i_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
        try:
            run_i = run_scan_continuation(os.path.join(h_dir, "final"),
                                          os.path.join(h_dir, "final", "smt_plan.json"),
                                          model_cfg, "cuda", out_dir=i_dir, count_syncs=True,
                                          decode_legs=True)
        finally:
            shutil.rmtree(i_dir, ignore_errors=True)
    finally:
        shutil.rmtree(h_dir, ignore_errors=True)
    report_scan_run(run_i, run_e, 3, tag="I", src="H")
    check_scan_run(run_i, run_e, tag="I")
    torch.cuda.empty_cache()
    marks.append(("I", time.time()))
    # J: channel mode with --frozen_quant int8 from a warm-up at full depth:
    # the conversion builds the int8 scan state (K4 and its row quantization
    # in the sparse phase), with its export and the int8 decode leg
    j_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=build_dir)
    try:
        run_j = run_main_path(model_cfg, "cuda", out_dir=j_dir, mode="channel",
                              frozen_quant="int8", count_syncs=True, decode_leg=True)
    finally:
        shutil.rmtree(j_dir, ignore_errors=True)
    report_run("J", "TinyLlama-1.1B bf16, --channel_sparsity --frozen_quant int8 from a warm-up "
               "(30 + 30 channels), bs 4 x seq 512, remat, attn auto (K3)", run_j, 3)
    check_deep_channel_run(run_j, run_e)
    report_deep_channel_run(run_j, run_i, 3)
    torch.cuda.empty_cache()
    marks.append(("J", time.time()))
    # R: resume under dropout, matrix mode over the per-layer state, stopped
    # in the warm-up and in the sparse phase; R2: once in J's layout
    run_r = run_resume(dataclasses.replace(model_cfg, num_hidden_layers=R_LAYERS))
    run_r2 = run_resume(dataclasses.replace(model_cfg, num_hidden_layers=R2_LAYERS),
                        mode="channel", frozen_quant="int8", stops=(4,))
    torch.cuda.empty_cache()
    marks.append(("R", time.time()))
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
    le = run_e["launches"]
    if le["row_quant"] != le["q8mm_t"] + le["q8mm_g"]:  # every int8 linear and the q8 head
        raise AssertionError(f"run E: not one row quantization launch per K4 call: {le}")
    f2 = run_f["F2"]["launches"]
    if f2["row_quant"] != f2["q8mm_t"]:
        raise AssertionError(f"run F2: not one row quantization launch per K4 call: {f2}")
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

    def at_plan_n(kernel):  # ms by case and n at run A's plan n (time_at_plan_n)
        return {f"{r['what']} n={r['n']}": r["ms"] for r in sparse_times["times"]
                if r["kernel"].startswith(kernel)}

    lg = run_g["launches"]
    kernels = [
        dict(entry("block_grad", "block_grad.cu", "block_grad.py:56",
                   run_a["launches"]["block_grad"], k1_err, k1_time["ms"], k1_time["plain_ms"],
                   k1_time["bound"], k1_time["lib_ms"]),
             ms_by_plan=k1_time["by_plan"], ms_at_plan_n=at_plan_n("K1"),
             plan_n=sparse_times["n"]["all"],
             launches_by_run={"A": run_a["launches"]["block_grad"], "G": lg["block_grad"]}),
        dict(entry("masked_adam", "masked_adam.cu", "masked_adam.py:35",
                   run_a["launches"]["masked_adam"], k2_err, k2_time["ms"], k2_time["plain_ms"],
                   k2_time["bound"], k2_time["lib_ms"]),
             launches_by_run={"A": run_a["launches"]["masked_adam"], "G": lg["masked_adam"]},
             at_g_stacks=k2_stacks),
    ] + [entry(name, "attention.cu",
               "attention.py:154" if name == "attn_fwd" else "attention.py:188",
               run_a["launches"][name], k3_err[name], *k3_time[name]) for name in K3_KERNELS
         ] + [entry(name, "cached_attention.cu", "cached_attention.py:123",
                    run_d[leg]["launches"][name], k7_err[name], *k7_time[name])
              for name, leg in (("cached_attn", "D1"), ("cached_attn_q8", "D3"),
                                ("cached_attn_combine", "D5"))
              ] + [dict(entry(name, "q8_matmul.cu", f"q8_matmul.py:{line}",
                              run_e["launches"][name], k4_err[name], *k4_time[name]),
                        launches_by_run={"E": run_e["launches"][name], "G": lg[name]})
                   for name, line in (("q8mm_t", 104), ("q8mm_g", 133))
                   ] + [dict(entry("row_quant", "row_quant.cu", "",
                                   run_e["launches"]["row_quant"], rq_err, *rq_time),
                             # not a Pallas kernel: the row quantization XLA fuses in
                             # front of q8mm_t_core / q8mm_g_core (q8_matmul.py:159-177)
                             replaces="sparse_matrix_tuning_tpu/ops/quant.py:32",
                             launches_by_run={"E": run_e["launches"]["row_quant"],
                                              "F2": run_f["F2"]["launches"]["row_quant"],
                                              "G": lg["row_quant"]}),
                        dict(entry("block_correction", "correction.cu", "correction.py:69",
                                   run_e["launches"]["block_correction"], k5_err, *k5_time),
                             launches_by_run={"E": run_e["launches"]["block_correction"],
                                              "F3": run_f["F3"]["launches"]["block_correction"],
                                              "G": lg["block_correction"]},
                             ms_timed_cases=k5_timed, ms_at_plan_n=at_plan_n("K5")),
                        entry("q4_matmul", "q4_matmul.cu", "q4_matmul.py:94",
                              run_f["F1"]["launches"]["q4_matmul"], k6_err, *k6_time)]
    # the fp16 bodies, launched by runs M and M8 (K4's, the row
    # quantization's and K5's by M8 only)
    fp16_src = {"block_grad": ("block_grad.cu", "block_grad.py:56"),
                "row_quant": ("row_quant.cu", ""),
                "block_correction": ("correction.cu", "correction.py:69"),
                "q8mm_t": ("q8_matmul.cu", "q8_matmul.py:104"),
                "q8mm_g": ("q8_matmul.cu", "q8_matmul.py:133"),
                **{n: ("attention.cu", "attention.py:154" if n == "attn_fwd"
                       else "attention.py:188") for n in K3_KERNELS}}
    for base, (src, replaces) in fp16_src.items():
        name = f"{base}_fp16"
        err, ms, plain_ms, bnd, lib_ms, extra = fp16[name]
        main_run = run_m8 if base in ("row_quant", "block_correction", "q8mm_t", "q8mm_g") \
            else run_m
        e = dict(entry(name, src, replaces, main_run["launches"][name], err, ms, plain_ms, bnd,
                       lib_ms), **extra,
                 launches_by_run={"M": run_m["launches"][name], "M8": run_m8["launches"][name]})
        if base == "row_quant":
            e["replaces"] = "sparse_matrix_tuning_tpu/ops/quant.py:32"
        kernels.append(e)
    # every kernel's launches in the channel runs: H, I and I's decode legs,
    # J and its decode leg; and in R and R2's training steps
    runs = {"H": run_h["launches"], "I": run_i["launches"],
            **{tag: leg["launches"] for tag, leg in run_i["decode"].items()},
            "J": run_j["launches"], "J8": run_j["decode"]["J8"]["launches"],
            "R": run_r["launches"], "R2": run_r2["launches"]}
    for k in kernels:
        k.setdefault("launches_by_run", {}).update(
            {tag: counts[k["name"]] for tag, counts in runs.items()
             if not k["name"].endswith("_fp16")})
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
