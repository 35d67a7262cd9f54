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
     dropout;
 12. data parallelism (after D; `--only dp` runs the build, A, D1 and
     these): P0, two gloo ranks on cuda:0 against one process at the same
     global batch, tiny fp32, dense and over --frozen_quant int8, rank 1's
     rows thinned to 4 labels each (thin_rows), losses within P0_RTOL /
     P0_INT8_RTOL and the dense pair's grad norms within P0_RTOL every
     step, equal fingerprints; P, A's
     path over two gloo ranks at A's global batch, losses within
     P_VS_A_RTOL and warm-up grad norms within P_GNORM_RTOL of A's, the
     ranks' master / m / v and trainables / m / v bit-equal, MB and ms
     all-reduced per step, the blocks where P's plan leaves A's with their
     scores (log_selection_margin); PE, the eval harness split by rank
     stride over A's export, tokens equal D1's; PN, NCCL: one rank (two
     on a two-card machine), bucketed sums exact, one step;
 13. the fsdp axis (in the same spawn as P, a (1, 2, 1) mesh over the
     same two gloo ranks; parallel/fsdp.py): F0, tiny fp32 dense and
     int8 at (1, 2, 1) and dense at (2, 2, 1) over four gloo ranks,
     against the same one-process references as P0 at P0's bounds, every
     kernel launched on each rank; F, A's path at (1, 2, 1) at A's global
     batch, held to A at P's bounds, with per rank the ms/step by phase,
     the gathered, reduce-scattered and all-reduced bytes and calls a
     step, the state's bytes here against the full leaves', the gathered
     layers alive at once and the warm-up and sparse peaks beside P's,
     each rank's warm-up peak at least FSDP_PEAK_GAIN_GIB under P's; FE,
     rank 0's export equal to the gathered state on each rank; FN, the
     fsdp collectives and fsdp.gather's forward and backward through
     NCCL (PN's rank), exact; FS, the scan layouts under fsdp at (1, 2,
     1), at FS_LAYERS in the whole script (matrix --scan_layers on
     --frozen_quant int8 held to E, its sparse peak a rank under one
     process's run of the same path, channel + int8 at depth held to J,
     each run here at that depth) and at 22 layers under `--only fs`;
 14. the tensor axis (in the same spawns as P and F0; `--only tp` runs
     the build, A and these; parallel/tensor.py): T0, the tiny pair in
     fp32 and fp16 at (1, 1, 2) over the two gloo ranks and at (1, 2, 2)
     over four, against one process (fp32 at P0's bounds; fp16 losses
     within P0_INT8_RTOL, the same loss scales and overflow flags), K1,
     K2 and K3 launched on every rank, each rank 1/T of every tensor-split
     leaf; T, A's path at (1, 1, 2) at A's global batch (TinyLlama's
     widths, K3 on each rank's 16 query and 2 kv heads; every layer under
     `--only tp`, T_LAYERS in the whole script, T, TQ and TS each held to
     A or E run at the same depth), held to A at P's
     bounds, with per rank the ms/step, the tensor all-reduces' and
     all-gathers' bytes and calls a step, the state's bytes against A's
     whole state, the peaks beside P's, F's and A's, the launches and the
     blocks where T's plan leaves A's; TE, T's export equal to one
     process's export of the gathered state (the plan's one-process
     scatter of the gathered trainables); TN (`--only nccl` on four
     cards), T0 and T over NCCL at (1, 2, 2);
 15. the int8 base and head under the tensor axis (--frozen_quant int8 on
     a tensor mesh, in the same spawns as T0 and T; `--only tp` runs E as
     well): TQ0, the tiny int8 pair in fp32 and fp16 at (1, 1, 2) and (1,
     2, 2) against one process (losses within P0_INT8_RTOL, the same loss
     scales and overflow flags), every kernel of the int8 path launched
     on every rank, the split row quantization's row_amax and
     row_quant_amax among them, 1/T of every tensor-split leaf; TQ, E's
     path at (1, 1, 2) over the two gloo ranks (bs 4 a rank, T's depth),
     held to E at P's bounds, with per rank the ms/step, the tensor
     collectives' MB and calls a step (activations and amax apart), the
     int8 base and head bytes beside E's, the peaks beside T's and E's and
     the launches, one row quantization (fused or split) a K4 call; TQE,
     its export (merged_params, not written to disk: a TinyLlama run with
     an output dir writes ~7 GB, two HF saves and a checkpoint, and T's TE
     writes and reads back the files through the same code) equal to one
     process's export of the gathered state; TQN
     (`--only nccl` on four cards), TQ0 and TQ over NCCL at (1, 2, 2). The
     row quantization check holds the split entries at every RQ_SHAPES
     shape and at the shapes TQ gives each rank (RQ_TQ_SHAPES: o / down's
     x, q, k/v and gate/up's g * sw, the int8 head's chunk cut at the
     ranks' boundary): equal to their plain twins and, over the two
     ranks' columns with the MAX of their amaxes, to the whole row's
     quantization bit for bit, NaN and inf rows included; a planted
     rank-local amax rejected; timed at TQ's main shape;
 16. the scan layouts under the tensor axis (--scan_layers on on a tensor
     mesh, in the same spawns as T0 and T; `--only tp` runs them too):
     TS0, the tiny pair in fp32 and fp16 over the dense and the int8 base
     at (1, 1, 2) and (1, 2, 2) against one process's --scan_layers on run
     (P0's bounds, P0_INT8_RTOL over int8 and fp16, the same loss scales
     and overflow flags), K1, K2, K3 and K5 (smt_linear_dyn on each rank's
     window of valid entries) launched on every rank, over int8 K4 and the
     row quantization's three entries too, 1/T of every tensor-split leaf,
     the export against one process's export of the gathered state; TS,
     E's path with --scan_layers on at (1, 1, 2) over the two gloo ranks
     (bs 4 a rank, T's depth), held to E at P's bounds, with
     per rank the ms/step, the tensor collectives' MB and calls a step
     (activations, amax and the block grads' sum apart; the sum at most
     the plan's valid blocks' bytes), the stacked int8 base, head, host
     store and padded stacks' bytes beside the whole state's, the peaks
     beside E's and TQ's, and the launches; TSE, its export
     (merged_params, gathered layer by layer over both axes, not written)
     equal to one process's export of the gathered state and host store;
     TSN (`--only nccl` on four cards), TS0 and TS over NCCL at (1, 2, 2);
 17. channel mode under the tensor axis (--channel_sparsity on a tensor
     mesh, in the same spawns; `--only tp` runs them too): TC0, the tiny
     pair in fp32 and fp16 in channel mode per layer and with
     --scan_layers on over the dense and the int8 base, at (1, 1, 2) and
     (1, 2, 2) against one process (P0's bounds, P0_INT8_RTOL over int8
     and fp16, the same plan, loss scales and overflow flags), K2 and K3
     (over int8 K4 and the row quantization's three entries) launched on
     every rank and K1 and K5 not; TC, H's path at (1, 1, 2) over the two
     gloo ranks (bs 4 a rank, every TinyLlama layer), held to H, and TCJ,
     J's path (channel + int8 at depth, converted into the int8 scan state
     with its host store), held to J, each with per rank the ms/step, the
     tensor MB and calls a step (activations, amax, taps and column grads
     apart), act_acc, stacked, host store and column bytes beside the
     reference's, the peaks and the launches; TCE, their exports (not
     written) equal to one process's export of the gathered state; TCN
     (`--only nccl` on four cards), TC0, TC and TCJ over NCCL at (1, 2, 2);
 18. Qwen2.5-1.5B's widths (QWEN: q/k/v biases, a tied head, head dim 128,
     12 query and 2 kv heads), written from a seed as a local qwen2
     checkpoint and read by the qwen2 loader (models/hf_io; on a mesh
     each rank its blocks): Q, one process, matrix mode, bf16, bs 4 x seq
     512, through warm-up, conversion, sparse steps, eval and the export,
     K1, K2 and K3 (hd 128, group 6) launched, at T_LAYERS layers in the
     whole script (before the data-parallel spawn) and 28 under `--only
     tp`, then K1 against its plain version at Q's whole linears and QT's
     rank panels (gate/up's 4,480 rows and down's 4,480 columns in
     4,608-wide panels, k/v's 128 rows in one block) with Q's selected
     blocks, timed at down_proj (check_block_grad_qwen); QT0, the tiny tied, biased pair at (1, 1, 2) and (1, 2, 2) over
     QT0_CASES (fp32, fp16 and int8; per layer and scan; matrix and
     channel; with and without --dropout) against one process at P0's
     bounds; QT, Q's path at (1, 1, 2) over the two gloo ranks held to Q
     at P's bounds with the same plan, each rank half of the embedding's
     columns, the biases whole and no lm_head, K3 on 6 query and 1 kv head
     a rank, the tied head's gathered bytes a step and the selected blocks
     that straddle the shards (gate/up's 4,480 rows, down's 4,480 columns,
     k/v's 128 rows) logged; QTE, QT's export read back, equal to one
     process's export of the gathered state bit for bit, with Q's tensors
     (names, shapes, dtypes); QTD (`--only tp`), Q and QT under --dropout
     0.1 (QD the one-process run); QTN (`--only nccl`, four cards), QT0 and
     QT over NCCL at (1, 2, 2);
 19. N, the host's data path (before A): over one epoch of A's training
     set at A's global batch and bucket, the C++ collator
     (data/native.native_batch_iterator, which fit trains from through
     PrefetchLoader's thread) against the numpy collator
     (data/sft.batch_iterator) bit for bit on every array, each timed in
     ms a batch; every run through fit logs how long fit waited on the
     loader's queue before each step (LoaderClock wraps the prefetcher
     here, the package counts nothing);
 20. PF (after the data-parallel spawn): A's path at T_LAYERS under
     --profile_dir (steps PF_START .. PF_START + PF_STEPS - 1: the last
     warm-up step and two sparse steps) and
     --do_gradient_distribution_analysis with an output_dir under build/:
     the same losses, eval loss, plan and launches as A at that depth, bit
     for bit; the Chrome trace exists, parses and holds K1, K2 and K3
     kernel events under their launch names (PF_TRACE_NAMES), K2's as many
     as it launches a sparse step times the sparse steps traced; both
     histogram PNGs (attention, MLP) decode; the traced steps' ms beside
     the untraced ones and A's, the trace's stop and export timed; PN1
     (`--only nccl`), A's path at (N, 1, 1) over NCCL, a card a rank,
     every rank collating the global batch, held to A as P is;
 21. a tensor axis that cuts the attention heads, at QH_SHAPE (1, 1, 4),
     four gloo ranks on cuda:0 in the four-rank spawn of F0 (`--only tp`:
     of T0's (1, 2, 2)): QH0, the tiny fp32 pairs kv_cut (4 q / 2 kv
     heads of 64: half a kv head a rank) and q_cut (6 q / 2 kv heads of
     128: 1.5 q heads a rank) against one process at P0's bounds, K1, K2
     and K3 launched on every rank, K3 on each rank's whole kv group;
     QH, Q's path (2 kv heads: k/v's 256 rows, 64 a rank) held to Q as QT
     is (P's bounds, Q's plan up to near-ties, the tied, biased layout,
     the export held through merged_params), at T_LAYERS in the whole
     script and 28 layers under `--only tp`, with per rank the q/k/v
     gathers' and their grads' sums' MB and calls a step apart from the
     other tensor collectives, K3's heads and launches, state bytes and
     peaks beside QT's; QHN (`--only nccl`, four cards), QH over NCCL at
     (1, 1, 4) in QTN's spawn.
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
channel int8 reference, J and R; `--only tp` the build, A, E, H, J, T0,
TQ0, TS0, TC0, T, TE, TQ, TQE, TS, TSE, TC, TCJ and TCE, then Q, QD, QT0,
QT, QTE, QTD, QH0 and QH at 28 layers; `--only host` the build, N, A at
T_LAYERS and PF; none of them prints a result.
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
# Qwen2.5-1.5B (Qwen/Qwen2.5-1.5B config.json): model_type qwen2, q/k/v
# biases, a tied head; its checkpoint is written from a seed (write_qwen)
QWEN = dict(vocab_size=151936, hidden_size=1536, intermediate_size=8960,
            num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
            max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=1000000.0,
            tie_word_embeddings=True)
QWEN_BIAS_STD = 0.1   # the seeded q/k/v biases, N(0, 0.1)
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
    (4, 512, 12, 2, 128, "bf16", "Qwen2.5-1.5B, run Q"),
    (4, 512, 6, 1, 128, "bf16", "Qwen2.5-1.5B, a rank's heads at tensor 2 (QT)"),
    (2, 1000, 32, 4, 64, "bf16", "ragged"),
    (2, 700, 8, 2, 64, "fp32", "fp32"),
]
K3_TIMED = 5
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
# the split row quantization (row_amax, the MAX of the ranks' amaxes,
# row_quant_amax) at the shapes TQ gives it on each rank at (1, 1, 2): the
# whole row (T, K, x dtype, fold the weight scales) cut after `cut` columns
# into the two ranks' parts (what, timed: on the first part, TQ's main
# shape)
RQ_TQ_SHAPES = [
    (2048, 5632, "bf16", True, 2816, "gate/up's g * sw, column-parallel backward: TQ's main "
     "shape", True),
    (2048, 5632, "bf16", False, 2816, "down_proj's input, row-parallel forward", False),
    (2048, 2048, "bf16", False, 1024, "o_proj's input, row-parallel forward", False),
    (2048, 2048, "bf16", True, 1024, "q's g * sw, column-parallel backward", False),
    (2048, 256, "bf16", True, 128, "k/v's g * sw, column-parallel backward", False),
    (2044, 4096, "fp32", True, 3712, "the int8 head's g * sw over the chunk [12288, 16384), "
     "cut at rank 1's first row 16000", False),
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
K6_STACK = (3, 64, 2048, 2048)  # K6s: layers, T, I, O; K6 on the views of layers 1 and 2
# runs R and R2 (resume) at TinyLlama's width, depth cut to keep the whole
# script near half its time limit: R (per-layer state) 4 layers (8 until the
# fsdp phases came), R2 12, the least depth at which channel + int8 takes
# the scan state (J's layout)
R_LAYERS, R2_LAYERS = 4, 12
# the whole script's depth of T, TQ and TS (held to A and E run at that
# depth): cut from TinyLlama's 22 to keep the script inside its time limit
# beside TC and TCJ, which run every layer; `--only tp` runs all 22
T_LAYERS = 4
# the whole script's depth of FS (the scan layouts under fsdp), held to E
# and J run at that depth: matrix at T_LAYERS, channel + int8 at the least
# depth at which it takes the scan state (R2_LAYERS); cut from 22 to keep
# the script inside its time limit on a slow host (1,208.3 s with 22 on
# one H100, PERF.md); `--only fs` runs all 22
FS_LAYERS = {"matrix": T_LAYERS, "channel": R2_LAYERS}
# PF: A's path at T_LAYERS traced over steps 2..4 of its 3 warm-up + 4
# sparse steps (the last warm-up step and two sparse steps)
PF_START, PF_STEPS = 2, 3
# the traced kernels' launch names (their __global__ functions, bf16
# bodies) by launch counter
PF_TRACE_NAMES = {"block_grad": "block_grad_wgmma_kernel", "masked_adam": "masked_adam_kernel",
                  "attn_fwd": "attn_fwd_mma", "attn_bwd_delta": "attn_bwd_delta_kernel",
                  "attn_bwd_dkdv": "attn_bwd_dkdv_mma",
                  "attn_bwd_dkdv_reduce": "attn_bwd_dkdv_reduce_kernel",
                  "attn_bwd_dq": "attn_bwd_dq_mma"}
# N: epochs of A's training set each collator is timed over
N_EPOCHS = 20
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


def _k1_library(g2, x2, rb, cb):
    """K1's function in PyTorch calls: bmm of the gathered row and column
    panels, in the inputs' dtype."""
    import torch
    t = g2.shape[0]
    g_rows = g2.reshape(t, -1, 256).index_select(1, rb.long()).transpose(0, 1)
    x_cols = x2.reshape(t, -1, 256).index_select(1, cb.long()).transpose(0, 1)
    return torch.bmm(g_rows.transpose(1, 2), x_cols)


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
                return _k1_library(g2, x2, rb, cb)
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


def check_block_grad_qwen(run_q, model_cfg, parts=2, tokens=2048):
    """K1 (bf16) at the inputs Q and QT give it at Qwen2.5-1.5B's widths:
    for each linear module, the layer of Q's plan with the most selected
    blocks, at those blocks (K1_N seeded ones where Q selected none), on
    Q's whole (T, O) and (T, I) and on each of `parts` ranks' block-aligned
    panels as the per-layer tensor path builds them (fsdp.block_window,
    the rank's slice placed in its zeroed panel: gate/up's 4,480 rows in
    4,608, down's 4,480 columns, k/v's 128 rows in one block), against the
    plain version at K1_RTOL / K1_ATOL, through the wrapper's plan and
    every forced plan of K1_PLANS, two launches equal. Timed at Q's
    down_proj beside the plain version, the library and the bound.
    Returns (max_abs_err, timing)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import COL_PARALLEL, block_window

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    d, f = model_cfg.hidden_size, model_cfg.intermediate_size
    kv = model_cfg.num_key_value_heads * model_cfg.head_dim
    dims = {"q_proj": (d, d), "k_proj": (kv, d), "v_proj": (kv, d), "o_proj": (d, d),
            "gate_proj": (f, d), "up_proj": (f, d), "down_proj": (d, f)}
    worst, timing, cases = 0.0, None, []

    def hold(what, g2, x2, rb, cb):
        got, again = k1.block_grad(g2, x2, rb, cb), k1.block_grad(g2, x2, rb, cb)
        torch.cuda.synchronize()
        want = k1.block_grad_plain(g2, x2, rb, cb)
        torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=K1_ATOL)
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {what}: two launches differ")
        err = float((got - want).abs().max())
        for bm, splits in K1_PLANS:
            forced = k1._launch(g2, x2, rb, cb, bm, min(splits, -(-tokens // 64)))
            torch.cuda.synchronize()
            torch.testing.assert_close(forced, want, rtol=K1_RTOL, atol=K1_ATOL)
            err = max(err, float((forced - want).abs().max()))
        p = k1.plan(rb.shape[0], tokens, n_sm)
        cases.append(f"{what} (T,O,I)=({tokens},{g2.shape[1]},{x2.shape[1]}) n={rb.shape[0]} "
                     f"plan {p.bm}x256/{p.splits} err {err:.2e}")
        return err

    for mod, (o, i) in dims.items():
        chosen = {}
        for key, r, c in run_q["selected"]:
            if key.split(".", 1)[1] == mod:
                chosen.setdefault(key, []).append((r, c))
        if chosen:
            blocks = max(chosen.values(), key=len)
            rb_np = np.array([r for r, _ in blocks], np.int64)
            cb_np = np.array([c for _, c in blocks], np.int64)
        else:   # one of them on the block that straddles the ranks' edge
            rb_np, cb_np = (a.astype(np.int64) for a in _coords(rng, K1_N, o // 256, i // 256))
            (rb_np if mod in COL_PARALLEL else cb_np)[-1] = \
                ((o if mod in COL_PARALLEL else i) // parts) // 256
        g2 = torch.randn((tokens, o), generator=gen, device=dev).to(torch.bfloat16)
        x2 = torch.randn((tokens, i), generator=gen, device=dev).to(torch.bfloat16)
        rb = torch.from_numpy(rb_np.astype(np.int32)).to(dev)
        cb = torch.from_numpy(cb_np.astype(np.int32)).to(dev)
        tag = f"{mod} ({'Q' if chosen else 'seeded'} blocks)"
        worst = max(worst, hold(f"Q {tag}", g2, x2, rb, cb))
        col = mod in COL_PARALLEL
        width = (o if col else i) // parts
        for t in range(parts):
            first = (t * width, width)
            win = block_window(rb_np, cb_np, first if col else None, None if col else first, dev)
            if win is None:
                continue
            _, wrb, wcb, (r_lo, r_n), (c_lo, c_n) = win
            lo, n = (r_lo, r_n) if col else (c_lo, c_n)
            src = g2 if col else x2
            panel = src.new_zeros((tokens, n * 256))
            panel[:, t * width - lo * 256:(t + 1) * width - lo * 256] = \
                src[:, t * width:(t + 1) * width]
            gp, xp = (panel, x2) if col else (g2, panel)
            worst = max(worst, hold(f"QT rank {t} {tag}", gp, xp, wrb.to(torch.int32),
                                    wcb.to(torch.int32)))
        if mod == "down_proj":
            def lib():
                return _k1_library(g2, x2, rb, cb)
            n = len(rb_np)
            nbytes = (len(set(rb_np)) + len(set(cb_np))) * tokens * 256 * 2 + n * 256 * 256 * 4
            timing = dict(ms=time_ms(lambda: k1.block_grad(g2, x2, rb, cb)),
                          plain_ms=time_ms(lambda: k1.block_grad_plain(g2, x2, rb, cb)),
                          lib_ms=time_ms(lib), shape=f"T={tokens} (O,I)=({o},{i}) n={n} bf16",
                          bound=bound(nbytes, 2.0 * n * tokens * 256 * 256, "bf16"))
        del g2, x2
    torch.cuda.empty_cache()
    log(f"[K1 block_grad] Qwen2.5-1.5B, Q's whole linears and QT's rank panels at tensor "
        f"{parts}: max_abs_err {worst:.3e} over {len(cases)} cases (and the {len(K1_PLANS)} "
        f"forced plans each; two launches equal): " + "; ".join(cases))
    log(f"[K1 block_grad] Qwen2.5-1.5B time at {timing['shape']}: kernel {timing['ms']:.4f} ms, "
        f"plain {timing['plain_ms']:.4f} ms, library bmm on gathered bf16 panels "
        f"{timing['lib_ms']:.4f} ms; bound {timing['bound'][0]:.3e} ms ({timing['bound'][1]}) "
        f"({CARD['smi']})")
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
    split_err = _rq_split_case(x, sw, xq, sx, f"T={t} K={k} {dtype} fold={fold}", plant)
    if not timed:
        return err, split_err, None
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
    return err, split_err, {"row_quant": (ms, plain_ms, bnd, None)}


def _rq_tq_case(t, k, dtype, fold, cut, what, timed, gen):
    """The split row quantization at one RQ_TQ_SHAPES shape: the whole row's
    plain quantization held against the two ranks' parts (_rq_split_case,
    the planted rank-local amax rejected); if `timed`, row_amax and
    row_quant_amax timed on the first part (the rank's columns), beside
    their plain twins and the bound. Returns (err, {entry: (ms, plain_ms,
    bound, None)} or None)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq
    x, sw = _rq_rows(t, k, torch_dtype(dtype), fold, gen)
    xq, sx = rq.row_quant_plain(x, sw)
    shape = f"T={t} K={k} {dtype}{' fold' if fold else ''} cut at {cut} ({what})"
    err = _rq_split_case(x, sw, xq, sx, shape, True, cut)
    if not timed:
        return err, None
    # the rank's part: the amax pass (x read, 4 B a row written) and the
    # quantization with a given amax (x and the amax read, xq and sx written)
    xp = x[:, :cut].contiguous()
    swp = None if sw is None else sw[:cut].contiguous()
    amax = rq.row_amax(xp, swp)
    e, fold_b = x.element_size(), 4 * cut if fold else 0
    split = {}
    for name, fn, plain, nb, ops in (
            ("row_amax", lambda: rq.row_amax(xp, swp), lambda: rq.row_amax_plain(xp, swp),
             t * cut * e + 4 * t + fold_b, (3 if fold else 2) * t * cut),
            ("row_quant_amax", lambda: rq.row_quant_amax(xp, amax, swp),
             lambda: rq.row_quant_amax_plain(xp, amax, swp),
             t * cut * e + 4 * t + t * cut + 4 * t + fold_b, (4 if fold else 3) * t * cut)):
        b = bound(nb, ops, "fp32")
        k_ms = min(time_ms(fn), time_ms(fn))
        p_ms = time_ms(plain, reps=5)
        split[name] = (k_ms, p_ms, b, None)
        log(f"[{name}] time at a rank's T={t} K={cut} {dtype}{' fold' if fold else ''}: kernel "
            f"{k_ms:.4f} ms ({nb / (k_ms * 1e-3) / 1e9:.0f} GB/s of {nb / 1e6:.1f} MB), plain "
            f"{p_ms:.4f} ms; bound {b[0]:.3e} ms ({b[1]})")
    return err, split


def _rq_split_case(x, sw, xq_ref, sx_ref, what, plant, cut=None):
    """The row quantization split at the amax (the tensor axis, where a row
    lies across the ranks): row_amax and row_quant_amax equal their plain
    twins bit for bit; row_quant_amax with the row's own amax equals the
    fused launch's xq and sx; the columns cut in two after `cut` (default
    half), each part quantized with the MAX of the parts' amaxes (their
    int32 bit patterns, as parallel/tensor.tensor_amax reduces them),
    concatenate to the fused values, NaN and inf rows included. With
    `plant`, the planted fault (a rank-local amax: each part quantized with
    its own) must be rejected. Returns the largest difference (0)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import row_quant as rq
    before = dict(rq.LAUNCHES)
    amax = rq.row_amax(x, sw)
    got_q, got_s = rq.row_quant_amax(x, amax, sw)
    torch.cuda.synchronize()
    fp16 = "_fp16" if x.dtype == torch.float16 else ""
    for name in ("row_amax", "row_quant_amax"):
        if rq.LAUNCHES[name + fp16] != before[name + fp16] + 1:
            raise AssertionError(f"{name}: not one launch per call")
    err = max(_nan_diff(amax, rq.row_amax_plain(x, sw)),
              *(_nan_diff(a, b) for a, b in zip((got_q, got_s),
                                                rq.row_quant_amax_plain(x, amax, sw))),
              _nan_diff(got_q, xq_ref), _nan_diff(got_s, sx_ref))
    k = x.shape[1]
    half = k // 2 if cut is None else cut
    parts = [(slice(0, half), None if sw is None else sw[:half].contiguous()),
             (slice(half, k), None if sw is None else sw[half:].contiguous())]
    xs = [x[:, c].contiguous() for c, _ in parts]
    amaxes = [rq.row_amax(xp, swp) for xp, (_, swp) in zip(xs, parts)]
    whole = torch.maximum(*(a.view(torch.int32) for a in amaxes)).view(torch.float32)
    split = [rq.row_quant_amax(xp, whole, swp) for xp, (_, swp) in zip(xs, parts)]
    err = max(err, _nan_diff(torch.cat([q for q, _ in split], 1), xq_ref),
              *(_nan_diff(s_, sx_ref) for _, s_ in split))
    if not err == 0:
        raise AssertionError(f"row_amax / row_quant_amax {what}: differ from the plain twins or "
                             f"from the fused launch (max abs err {err:.3e})")
    info = ""
    if plant:
        local = [rq.row_quant_amax(xp, a, swp) for xp, a, (_, swp) in zip(xs, amaxes, parts)]
        if _nan_diff(torch.cat([q for q, _ in local], 1), xq_ref) == 0:
            raise AssertionError("row_quant_amax: the check passes a planted rank-local amax")
        info = (f"; planted rank-local amax rejected: "
                f"{int((torch.cat([q for q, _ in local], 1) != xq_ref).sum())} values differ")
    log(f"[row_amax / row_quant_amax] {what}: equal to the plain twins, to the whole row's "
        f"quantization with the row's own amax, and over columns [0, {half}) and [{half}, {k}) "
        f"with the MAX of their amaxes, bit for bit{info}")
    return err


def check_row_quant():
    """K4's prologue, the row quantization kernel, at RQ_SHAPES (_rq_case):
    xq and sx equal to the plain version bit for bit (rows of zeros, ragged
    T, rows on .5 ties, magnitudes 1e-2 to 10, rows holding a NaN or an
    inf, with and without the fold of sw); the planted fault (the scale as
    amax / 127, a division) rejected; times beside the plain version and
    the bound (no single PyTorch call computes it); at each shape the split
    entries row_amax and row_quant_amax too (_rq_split_case: bit for bit
    against their plain twins and the fused launch, over two column halves
    with the MAX of their amaxes, a planted rank-local amax rejected); the
    split entries again at the shapes TQ gives them (RQ_TQ_SHAPES,
    _rq_tq_case), timed at TQ's main shape. Then row_quant, _quant_kv and
    the int8 / int4 matmuls on CUDA tensors run under
    torch.cuda.set_sync_debug_mode("error"): no call makes the host wait
    for the device. Returns (worst err, worst err of the split entries,
    {entry: (ms, plain_ms, bound, None)}: row_quant at the first timed
    RQ_SHAPES shape, the split entries at TQ's main shape)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    main = None
    worst, worst_split = 0.0, 0.0
    for t, k, dtype, fold, what, timed in RQ_SHAPES:
        err, split_err, timing = _rq_case(t, k, dtype, fold, what, timed, gen,
                                          plant=main is None)
        worst, worst_split = max(worst, err), max(worst_split, split_err)
        main = main or timing
    for shape in RQ_TQ_SHAPES:
        split_err, timing = _rq_tq_case(*shape, gen)
        worst_split = max(worst_split, split_err)
        main.update(timing or {})
    check_no_sync()
    return worst, worst_split, main


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
# the split entries' fp16 bodies at TQ's main shape in fp16 (RQ_TQ_SHAPES)
FP16_RQ_TQ = (2048, 5632, "fp16", True, 2816, "gate/up's fp16 g * sw, column-parallel backward",
              True)
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
            return _k1_library(g2, x2, rb, cb)

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
    rq_err, split_err, rq_main = 0.0, 0.0, None
    for t, k, dtype, fold, what, timed in FP16_RQ:
        err, s_err, timing = _rq_case(t, k, dtype, fold, what, timed, gen,
                                      plant=rq_main is None)
        rq_err, split_err = max(rq_err, err), max(split_err, s_err)
        rq_main = rq_main or timing
    s_err, timing = _rq_tq_case(*FP16_RQ_TQ, gen)
    split_err = max(split_err, s_err)
    rq_main.update(timing)
    for name, e in (("row_quant", rq_err), ("row_amax", split_err),
                    ("row_quant_amax", split_err)):
        res[f"{name}_fp16"] = (e, *rq_main[name], {})
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


def thin_rows(batch, rows, keep=4):
    """The global batch with all but the first `keep` valid labels of
    `rows` masked: those rows then count a few tokens against the other
    rows' full counts (P0's uneven ranks)."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.data.sft import IGNORE_INDEX
    labels = np.array(batch["labels"], copy=True)
    for i in rows:
        labels[i, np.flatnonzero(labels[i] != IGNORE_INDEX)[keep:]] = IGNORE_INDEX
    return {**batch, "labels": labels}


def block_scores(cfg, acc):
    """Each target linear's 256 x 256 block scores as matrix selection
    reads them (train/convert.compute_matrix_selection), on the host."""
    from sparse_matrix_tuning_tpu_torch.smt.select import block_stats, block_stats_final
    from sparse_matrix_tuning_tpu_torch.train.convert import _to_numpy, harvest_strategy
    final = block_stats_final if cfg.saliency_accumulation == "per_step_stats" else block_stats
    return {ks: _to_numpy(final(g, harvest_strategy(cfg, ks.split(".", 1)[1])))
            for ks, g in acc.items()}


_SEEDED = {}  # repr(model config) -> its seed-0 fp32 params on the host


def seeded_params(model_cfg, dtype, device):
    """init_params(model_cfg, seed=0, dtype=dtype, device=device), drawn once
    a process and configuration: the fp32 numpy draw (~17 s at TinyLlama's
    1.1 B parameters, every run's start before) stays on the host (~11 GB
    over the script's configurations), and each call gets a copy cast to
    `dtype` on `device`, bit for bit what init_params gives (the same fp32
    numbers, the same rounding)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params, tree_map
    key = repr(model_cfg)
    if key not in _SEEDED:
        _SEEDED[key] = init_params(model_cfg, seed=0, dtype=torch.float32, device="cpu")
    return tree_map(lambda t: t.to(device=device, dtype=dtype, copy=True), _SEEDED[key])


class LoaderClock:
    """For the length of a `with`, data/native.PrefetchLoader as fit
    takes it yields through a clock: `waits` holds how long each next()
    waited on the loader's queue (ms, in fit's order, skipped batches
    too). The package itself counts nothing."""

    def __enter__(self):
        from sparse_matrix_tuning_tpu_torch.data import native
        self.real, self.waits = native.PrefetchLoader, []
        waits = self.waits

        class Timed(self.real):
            def __iter__(self):
                it = super().__iter__()
                try:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        waits.append((time.perf_counter() - t0) * 1e3)
                        yield batch
                finally:
                    it.close()   # releases the loader's thread

        native.PrefetchLoader = Timed
        return self

    def __exit__(self, *exc):
        from sparse_matrix_tuning_tpu_torch.data import native
        native.PrefetchLoader = self.real


def run_main_path(model_cfg, device, *, dtype="bf16", bs=4, seq=512,
                  full_ft_steps=3, sparse_steps=4, eval_batches=2,
                  ratios=(0.0084, 0.0084), attn_impl="auto", out_dir=None, log_fn=log,
                  keep_decode_params=False, frozen_quant="none", loss_impl="auto",
                  count_syncs=False, mode="matrix", keep_state=False, decode_leg=False,
                  cfg_extra=None, mesh=None, thin=(), hf_dir=None):
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
    overflowed is skipped by fit and not among them). mesh: this process is
    a data-parallel rank (parallel/mesh.py; bs is per rank, the data from
    the global batch size): each step's all-reduced bytes and ms are kept
    ("reduced_bytes", "reduce_ms"), the ranks' master, m and v must be bit
    for bit equal after the warm-up and the trainables, m and v after fit
    ("checksums" holds the leaves compared), and the per-layer int8 base
    keeps its dense weights on the device, as JAX's rule has it. Over
    the fsdp axis (a mesh with F > 1: bs is per rank, the global batch bs *
    D * F) the ranks hold different shards: the replicas compared are the
    ranks of one data group after the warm-up and the gathered trainables,
    m and v after fit; each step's collective counters are kept
    ("collectives": all-reduced, gathered and reduce-scattered bytes and
    calls) and the state's bytes on this rank beside the full leaves'
    ("state_bytes", after the trainer's build and after the conversion);
    the merged weights and the export are the gathered state. thin:
    rows of every global training batch that keep only 4 valid labels
    (thin_rows). The warm-up steps' grad norms are kept
    ("warmup_grad_norm"), and in matrix mode the block scores selection
    read ("block_scores") and the blocks it chose ("selected"). hf_dir: the
    params are read from this local HF checkpoint (write_qwen's: the qwen2
    loader, models/hf_io.load_hf_params, or on a mesh that splits them
    load_hf_params_sharded, each rank reading its blocks), model_cfg its
    config. With cfg_extra's dropout the model's attention dropout is set
    from it, as the CLI sets it. fit takes its training batches from the
    C++ collator's prefetch thread; "loader_wait_ms" holds how long it
    waited on the loader before each step (LoaderClock)."""
    import dataclasses
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.hf_io import (
        load_hf_config, load_hf_params, load_hf_params_sharded)
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree, lm_head_weight
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
    if hf_dir is not None:
        if load_hf_config(hf_dir) != model_cfg:
            raise AssertionError(f"{hf_dir}: its config differs from {model_cfg}")
    if cfg.dropout > 0:   # the CLI's configure_dropout
        model_cfg = dataclasses.replace(model_cfg, attention_dropout=cfg.dropout)
    n_steps = full_ft_steps + sparse_steps
    global_bs = bs * (mesh.batch_shards if mesh is not None else 1)
    train_ds = synthetic_sft(n_steps * global_bs, seq, model_cfg.vocab_size, 1)
    eval_ds = synthetic_sft(eval_batches * global_bs, seq, model_cfg.vocab_size, 2)

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
    psh = None
    if hf_dir is None:
        params = seeded_params(model_cfg, cfg.param_dtype, device)
    elif mesh is not None and (mesh.fsdp > 1 or mesh.tensor > 1):
        params, psh = load_hf_params_sharded(hf_dir, mesh, model_cfg, dtype=cfg.param_dtype,
                                             device=device)
    else:
        params = load_hf_params(hf_dir, model_cfg, dtype=cfg.param_dtype, device=device)
    n_params = sum(p.numel() if psh is None else int(np.prod(psh.full_shape(f"master/{k}", p)))
                   for k, p in flatten_tree(params).items())
    trainer = SMTTrainer(cfg, model_cfg, params, total_steps=n_steps, device=device,
                         **({"mesh": mesh} if mesh is not None else {}), param_sharding=psh)
    del params
    if thin:
        step_of = trainer.train_step
        trainer.train_step = lambda batch: step_of(thin_rows(batch, thin))
    sync()
    log_fn(f"[main] {n_params:,} params, init + trainer {time.time() - t0:.1f} s, "
           f"saliency_accumulation={cfg.saliency_accumulation}")

    summary = {"n_params": n_params, "step_ms": [], "phase": [], "loss": [], "grad_norm": [],
               "warmup_grad_norm": [], "peak": {}, "loss_scale": [], "overflow": [],
               "reduced_bytes": [], "reduce_ms": [], "checksums": 0, "collectives": [],
               "state_bytes": {"build": state_bytes(trainer)},
               # the head's, the embedding's and the biases' master shape and bytes here
               "leaf_bytes": {k: (tuple(t.shape), t.numel() * t.element_size())
                              for k, t in flatten_tree(trainer.state["master"]).items()
                              if k in ("embed_tokens", "lm_head") or k.endswith("_bias")}}
    reduced = {"bytes": 0, "seconds": 0.0, "stats": {}}  # at the last step's end
    sh = trainer.sharding

    def same_replicas(what, keys, gathered=False, whole=None):
        """Bit-equal leaves on every rank (under fsdp: the ranks of a data
        group, or with `gathered` the full leaves on every rank, taken from
        `whole`, the whole state, where given)."""
        from sparse_matrix_tuning_tpu_torch.parallel.mesh import (
            assert_same, gather_objects, leaf_checksums)
        leaves = flatten_tree({k: trainer.state[k] for k in keys})
        if sh is not None and gathered:
            leaves = flatten_tree({k: whole[k] for k in keys}) if whole is not None else \
                {k: sh.full(k, t) for k, t in leaves.items()}
        elif sh is not None:
            sums = gather_objects(leaf_checksums(leaves), mesh)
            f = mesh.fsdp * mesh.tensor   # the ranks of data index 0 hold each slice once
            if any(sums[r] != sums[r % f] for r in range(mesh.world)):
                raise AssertionError(f"{what}: the leaf checksums differ within a data group")
            summary["checksums"] += len(leaves)
            return
        assert_same(f"{what}: the leaf checksums", leaf_checksums(leaves), mesh)
        summary["checksums"] += len(leaves)
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
        if mesh is not None:
            summary["reduced_bytes"].append(mesh.stats["bytes"] - reduced["bytes"])
            summary["reduce_ms"].append((REDUCE_S[0] - reduced["seconds"]) * 1e3)
            summary["collectives"].append({k: v - reduced["stats"].get(k, 0)
                                           for k, v in mesh.stats.items()})
            reduced.update(bytes=mesh.stats["bytes"], seconds=REDUCE_S[0],
                           stats=dict(mesh.stats))
        summary["phase"].append(trainer.phase)
        summary["loss"].append(float(metrics["loss"]))
        if trainer.phase == "sparse":
            summary["grad_norm"].append(float(metrics["grad_norm"]))
        elif "grad_norm" in metrics:
            summary["warmup_grad_norm"].append(float(metrics["grad_norm"]))
        if "loss_scale" in metrics:
            summary["loss_scale"].append(float(metrics["loss_scale"]))
            summary["overflow"].append(bool(metrics["overflow"]))
        if step == full_ft_steps:
            summary["peak"]["warmup"] = peak_and_reset()
            summary["launches_warmup"] = launches()
            if "acc" in trainer.state:
                acc = trainer.state["acc"]
                if sh is not None:
                    acc = {ks: sh.full(f"acc/{ks}", g) for ks, g in acc.items()}
                summary["block_scores"] = block_scores(cfg, acc)
            if mesh is not None:
                same_replicas("after the warm-up", ("master", "m", "v"))
            # dense weights at conversion: the master cast to the param dtype
            at_conversion = trainer.merged_params()
            snap["params"] = {li: {m: w.to("cpu") for m, w in layer.items()}
                              for li, layer in at_conversion["layers"].items()}
            snap["lm_head"] = lm_head_weight(at_conversion, model_cfg).to("cpu")
            if mesh is not None and mesh.tensor > 1:   # TE's reference: the rest as well
                snap["top"] = {k: w.to("cpu") for k, w in at_conversion.items()
                               if k != "layers"}
            del at_conversion
            if keep_state:
                trainer.maybe_convert()
                snap["trainable"] = {k: t.detach().to("cpu", copy=True)
                                     for k, t in trainer.state["trainable"].items()}
            sync()
            peak_and_reset()
        elif step == full_ft_steps + 1:
            summary["peak"]["conversion_and_first_sparse"] = peak_and_reset()
            summary["state_bytes"]["sparse"] = state_bytes(trainer)
        elif step == n_steps:
            summary["peak"]["later_sparse_steps"] = peak_and_reset()
        marks["exit"] = time.perf_counter()

    peak_and_reset()
    sync()
    marks["exit"] = time.perf_counter()
    if mesh is not None:
        mesh.reset_stats()
        REDUCE_S[0] = 0.0
    with LoaderClock() as clock:
        history = trainer.fit(train_ds, eval_ds, pad_token_id=0, on_metrics=on_metrics)
    sync()
    t_fit_end = time.perf_counter()
    summary["loader_wait_ms"] = clock.waits
    whole = None
    if sh is not None and trainer._scan:   # the whole scan state, gathered once on every rank
        whole = {k: sh.full_tree(v, k, device=device) for k, v in trainer.state.items()
                 if isinstance(v, dict) and k != "sched"}
    if mesh is not None:
        same_replicas("after fit", ("trainable", "m", "v"), gathered=True, whole=whole)
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
    summary["selected"] = sorted((f"{lp.layer}.{lp.module}", rb, cb)
                                 for lp in plan.linears.values() for rb, cb in lp.blocks)
    summary["channels"] = sorted((f"{lp.layer}.{lp.module}", c)
                                 for lp in plan.linears.values() for c in lp.channels)

    # int8 frozen base with host offload: no dense (O, I) layer weight and
    # no head is left on the device, only their 1-element placeholders (over
    # the scan state: (L, 1) stacks, the host store holding every stack)
    summary["offloaded"] = None
    summary["scan"] = trainer._scan
    if frozen_quant == "int8" and mesh is not None and not trainer._scan:
        if trainer._host_frozen is not None or "q" not in trainer.state:
            raise AssertionError("a rank's per-layer int8 base offloaded its dense weights or "
                                 "has no int8 base")
    elif frozen_quant == "int8":
        if trainer._scan:
            stacked = trainer.state["params"]["layers_stacked"]
            dense = [m for m in LAYER_LINEARS if tuple(stacked[m].shape) != (
                model_cfg.num_hidden_layers, 1) or m not in (trainer._host_frozen or {})]
        else:
            dense = [f"{li}.{m}" for li, layer in trainer.state["params"]["layers"].items()
                     for m, w in layer.items() if w.dim() == 2]
        head = trainer.state["params"].get("lm_head")   # a tied head is the embedding
        if dense or (head is not None and head.dim() == 2):
            raise AssertionError(f"dense weights left on the device after conversion: "
                                 f"{dense[:4]}, lm_head {None if head is None else head.shape}")
        if "q" not in trainer.state or "q_head" not in trainer.state:
            raise AssertionError("the int8 run has no int8 base or no int8 head in its state")
        summary["offloaded"] = len(trainer._host_frozen)

    # merged weights: bitwise the conversion-time weights outside the
    # selected blocks, the trainables (in the param dtype) inside them
    merged = trainer.merged_params()
    after = merged["layers"]
    stacks = whole["trainable"] if whole is not None else None
    if not torch.equal(lm_head_weight(merged, model_cfg).to("cpu"), snap["lm_head"]):
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
                trained = trained_entries(trainer, ks, stacks).detach().to("cpu", w.dtype)
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
    summary["export_shapes"] = {k: (tuple(t.shape), str(t.dtype))
                                for k, t in flatten_tree(merged).items()}

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
    if whole is not None:
        summary["fse_tensors"] = one_process_export_equal(trainer, merged, whole)
    if mesh is not None and mesh.tensor > 1 and not trainer._scan:   # the scan state: FSE's
        summary["te_tensors"] = tensor_export_equal(trainer, merged, snap)
    del whole
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


def state_bytes(trainer):
    """The state's tensor bytes on this rank and those of the full leaves:
    {"here", "full"} over every leaf, {"split_here", "split_full"} over
    the sharded ones (fsdp or tensor; here = full without either),
    {"tsplit_here", "tsplit_full"} over the tensor-split ones ("tslice":
    their tensor slices gathered over fsdp, 1/T of the whole),
    {"host_here", "host_full"} over the host store of frozen weights (the
    scan state's under fsdp and tensor: this rank's slices), {"q_here",
    "q_full"} over the int8 base and head (the q and q_head leaves), of
    which {"qhead_here", "qhead_full"} the head's, {"pad_here",
    "pad_full"} over the scan state's padded stacks (trainable, base, m,
    v), {"act_here", "act_full"} over channel mode's activation sums
    (act_acc) and {"train_here", "train_full"} over the trainables."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
    sh = trainer.sharding
    out = dict.fromkeys(("here", "full", "split_here", "split_full", "tsplit_here",
                         "tsplit_full", "tslice", "host_here", "host_full", "q_here",
                         "q_full", "qhead_here", "qhead_full", "pad_here", "pad_full",
                         "act_here", "act_full", "train_here", "train_full"), 0)

    def full_of(k, t):
        here = t.numel() * t.element_size()
        return here, (here if sh is None else
                      int(np.prod(sh.full_shape(k, t), dtype=np.int64)) * t.element_size())

    for k, t in flatten_tree({k: v for k, v in trainer.state.items() if k != "sched"}).items():
        here, full = full_of(k, t)
        out["here"] += here
        out["full"] += full
        if full != here:
            out["split_here"] += here
            out["split_full"] += full
        top = k.split("/")[0]
        if top in ("q", "q_head"):
            out["q_here"] += here
            out["q_full"] += full
        if top == "q_head":
            out["qhead_here"] += here
            out["qhead_full"] += full
        if trainer._scan and top in ("trainable", "base", "m", "v"):
            out["pad_here"] += here
            out["pad_full"] += full
        kind = {"act_acc": "act", "trainable": "train"}.get(top)
        if kind is not None:
            out[f"{kind}_here"] += here
            out[f"{kind}_full"] += full
        if sh is not None and sh.tdim(k) is not None:
            out["tsplit_here"] += here
            out["tsplit_full"] += full
            # the rank's tensor slice, gathered over fsdp: 1/T of the leaf
            out["tslice"] += here * (sh.f if sh.dim(k) is not None else 1)
    for k, t in (trainer._host_frozen or {}).items():
        here, full = full_of(f"host/{k}", t)
        out["host_here"] += here
        out["host_full"] += full
    return out


def one_process_export_equal(trainer, merged, whole):
    """FSE: the scan state's export under fsdp (merged_params, gathered
    layer by layer from the ranks' slices) against what one process exports
    from the same state: `whole`, the whole state every rank gathered, and
    the host store gathered here, through merged_params_from_scan without a
    sharding; every tensor must be equal bit for bit. Returns the number of
    tensors compared."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
    from sparse_matrix_tuning_tpu_torch.train.scan_phase import merged_params_from_scan
    sh, device = trainer.sharding, trainer.device
    host = {k: sh.full(f"host/{k}", w.to(device)).to("cpu")
            for k, w in (trainer._host_frozen or {}).items()}
    one = flatten_tree(merged_params_from_scan(whole, trainer.plan, trainer.model_cfg,
                                               host or None))
    got = flatten_tree(merged)
    if set(one) != set(got):
        raise AssertionError(f"FSE: export keys differ: {sorted(set(one) ^ set(got))[:6]}")
    for k, t in one.items():
        if not torch.equal(got[k].to("cpu"), t.to("cpu")):
            raise AssertionError(f"FSE: the fsdp export's {k} differs from one process's export "
                                 "of the gathered state")
    del host
    return len(one)


def tensor_export_equal(trainer, merged, snap):
    """TE: the export under the tensor axis (merged_params: the dense
    weights gathered over both axes, whose blocks each rank wrote into its
    two-axis slice) against what one process exports from the same
    training: the weights gathered at conversion (snap, taken before any
    sparse step) with the final trainables, gathered, scattered in by the
    plan's one-process scatter; every tensor must be equal bit for bit.
    Returns the number of tensors compared."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
    sh = trainer.sharding
    layers = {li: {m: w.to(trainer.device, copy=True) for m, w in layer.items()}
              for li, layer in snap["params"].items()}
    trainable = {k: sh.full(f"trainable/{k}", t) for k, t in trainer.state["trainable"].items()}
    trainer.plan.scatter(layers, trainable)
    got, one = flatten_tree(merged), flatten_tree({**snap["top"], "layers": layers})
    if set(one) != set(got):
        raise AssertionError(f"TE: export keys differ: {sorted(set(one) ^ set(got))[:6]}")
    for k, t in one.items():
        if not torch.equal(got[k].to("cpu"), t.to("cpu")):
            raise AssertionError(f"TE: the tensor-parallel export's {k} differs from one "
                                 "process's export of the gathered state")
    return len(one)


def trained_entries(trainer, ks, stacks=None):
    """Linear ks's trained blocks (n, 256, 256) or columns (O, n), in its
    plan's order, from the per-layer state (gathered under fsdp) or from
    the stacks of the scan state (whose valid entries come first, in plan
    order; under fsdp `stacks`, the whole stacks gathered once)."""
    trainable = trainer.state["trainable"]
    if not trainer._scan:
        if trainer.sharding is not None:
            return trainer.sharding.full(f"trainable/{ks}", trainable[ks])
        return trainable[ks]
    lp = trainer.plan.linears[ks]
    t = (stacks or trainable)[lp.module][lp.layer]
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
    wait = s["loader_wait_ms"]
    log(f"[{tag}] fit's wait on the C++ collator's prefetch queue, ms before each step: "
        f"warm-up {[round(x, 3) for x in wait[:n_warmup]]}, sparse "
        f"{[round(x, 3) for x in wait[n_warmup:]]}")
    if "sparse_step_syncs" in s:
        log(f"[{tag}] eval {s['eval_ms']:.1f} ms for {s['eval_batches']} batches; host-device "
            f"syncs in a sparse step {s['sparse_step_syncs']} ({CARD['smi']})")


def check_collator(model_cfg, bs=4, seq=512, n_steps=7):
    """N: one epoch of A's training set (synthetic_sft, seed 1; A's global
    batch and its one bucket) through the C++ collator and the numpy one,
    bit for bit on every array; each timed over N_EPOCHS epochs, the
    median epoch's ms a batch (the C++ library built before)."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.data import native
    from sparse_matrix_tuning_tpu_torch.data.sft import batch_iterator
    found = native.library_path().exists()
    t0 = time.perf_counter()
    lib = native.build()
    built = "found" if found else f"built by g++ in {time.perf_counter() - t0:.2f} s"
    ds = synthetic_sft(n_steps * bs, seq, model_cfg.vocab_size, 1)
    arena = native.TokenArena.from_dataset(ds)
    kw = dict(batch_size=bs, pad_token_id=0, buckets=[seq], seed=1234, epoch=0)
    got = list(native.native_batch_iterator(arena, **kw))
    want = list(batch_iterator(ds, **kw))
    if len(got) != len(want) or len(got) != n_steps:
        raise AssertionError(f"N: {len(got)} native batches against {len(want)} numpy ones")
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            if g[k].dtype != w[k].dtype or g[k].shape != w[k].shape or \
                    not np.array_equal(g[k], w[k]):
                raise AssertionError(f"N: batch {i} {k} differs from batch_iterator's")

    def ms_a_batch(make):
        per_epoch = []
        for _ in range(N_EPOCHS):
            t = time.perf_counter()
            n = sum(1 for _ in make())
            per_epoch.append((time.perf_counter() - t) * 1e3 / n)
        return statistics.median(per_epoch)
    native_ms = ms_a_batch(lambda: native.native_batch_iterator(arena, **kw))
    numpy_ms = ms_a_batch(lambda: batch_iterator(ds, **kw))
    log(f"[N] the C++ collator ({os.path.relpath(lib, REPO)}, {built}) "
        f"over one epoch of A's training set, {n_steps} batches of {bs} x {seq}: bit for bit "
        f"batch_iterator's on every array; ms a batch, median of {N_EPOCHS} epochs: C++ "
        f"{native_ms:.4f}, numpy {numpy_ms:.4f} ({CARD['smi']})")
    return {"native_ms": native_ms, "numpy_ms": numpy_ms, "batches": n_steps}


def run_profiled(ref, layers):
    """PF: A's path at `layers` under --profile_dir (steps PF_START ..
    PF_START + PF_STEPS - 1) and --do_gradient_distribution_analysis, an
    output_dir under build/, held to `ref`, A's run at that depth in this
    process: losses, eval loss, plan and launches bit for bit (the
    profiler and the collator change no arithmetic); one trace, which
    parses and holds K1, K2 and K3 kernel events under their launch names
    (PF_TRACE_NAMES), K2's as many as it launches a sparse step times the
    sparse steps traced (no step outside the window leaked in); the two
    histogram PNGs (attention, MLP) decode. Logs the profiler's overhead:
    the traced steps' ms beside the untraced ones and ref's, and the
    trace's stop and export."""
    import re
    from PIL import Image
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": layers})
    n_warm, n_sparse = 3, 4
    root = tempfile.mkdtemp(prefix="smoke_pf_", dir=os.path.join(REPO, "build"))
    prof, out = os.path.join(root, "prof"), os.path.join(root, "out")
    stops, real_stop = [], SMTTrainer._stop_profile

    def timed_stop(self):
        t0, tracing = time.perf_counter(), self._profiler is not None
        real_stop(self)
        if tracing:
            stops.append(time.perf_counter() - t0)
    SMTTrainer._stop_profile = timed_stop
    try:
        pf = run_main_path(cfg, "cuda", out_dir=out, full_ft_steps=n_warm,
                           sparse_steps=n_sparse,
                           cfg_extra=dict(profile_dir=prof, profile_start=PF_START,
                                          profile_steps=PF_STEPS,
                                          do_gradient_distribution_analysis=True))
        traces = sorted(os.listdir(prof))
        want = f"trace_steps_{PF_START}_{PF_START + PF_STEPS}.json"
        if traces != [want]:
            raise AssertionError(f"PF: traces {traces}, not [{want}]")
        trace_mb = os.path.getsize(os.path.join(prof, want)) / 1e6
        with open(os.path.join(prof, want)) as f:
            events = json.load(f)["traceEvents"]
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        sizes = []
        for name in pngs:
            with Image.open(os.path.join(out, name)) as img:
                img.load()
                sizes.append(img.size)
    finally:
        SMTTrainer._stop_profile = real_stop
        shutil.rmtree(root, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(1 for e in kernels if re.search(rf"\b{fn}\b", e.get("name", "")))
              for k, fn in PF_TRACE_NAMES.items()}
    traced = range(PF_START, PF_START + PF_STEPS)
    sparse_traced = sum(1 for i in traced if i >= n_warm)
    k2_sparse = ref["launches"]["masked_adam"] - ref["launches_warmup"]["masked_adam"]
    k2_step = k2_sparse // n_sparse
    if pf["loss"] != ref["loss"] or pf["eval_loss"] != ref["eval_loss"] or \
            pf["plan"] != ref["plan"] or pf["launches"] != ref["launches"]:
        raise AssertionError(f"PF: losses {pf['loss']} + eval {pf['eval_loss']}, plan "
                             f"{pf['plan']['fingerprint'][:16]}, launches {pf['launches']} "
                             f"against A at {layers} layers: {ref['loss']} + eval "
                             f"{ref['eval_loss']}, {ref['plan']['fingerprint'][:16]}, "
                             f"{ref['launches']}")
    if not kernels or not all(counts.values()):
        raise AssertionError(f"PF: kernel events of the trace by launch name {counts} "
                             f"({len(kernels)} kernel events)")
    if k2_sparse % n_sparse or counts["masked_adam"] != k2_step * sparse_traced:
        raise AssertionError(f"PF: {counts['masked_adam']} K2 events in the trace, not "
                             f"{k2_step} a sparse step x {sparse_traced} sparse steps traced")
    if len(pngs) != 2 or not all(m in "".join(pngs) for m in ("q_proj", "down_proj")) or \
            not all(w > 0 and h > 0 for w, h in sizes):
        raise AssertionError(f"PF: histograms {pngs} of sizes {sizes}")
    ms, ref_ms = pf["step_ms"], ref["step_ms"]
    untraced = [i for i in range(len(ms)) if i not in traced]
    log(f"[PF] A's path at {layers} layers under --profile_dir (steps {PF_START}.."
        f"{PF_START + PF_STEPS - 1}, {sparse_traced} of them sparse) and "
        f"--do_gradient_distribution_analysis: losses, eval loss, plan "
        f"{pf['plan']['fingerprint'][:16]} and launches bit for bit A's at {layers} layers; "
        f"trace {want} {trace_mb:.1f} MB, {len(events)} events, {len(kernels)} kernel events, "
        f"by launch name {counts} (K2 {k2_step} a sparse step); histograms {pngs} {sizes} "
        f"({CARD['smi']})")
    log(f"[PF] ms/step, traced steps {[round(ms[i], 1) for i in traced]} (A at {layers} "
        f"layers {[round(ref_ms[i], 1) for i in traced]}), untraced "
        f"{[round(ms[i], 1) for i in untraced]} (A {[round(ref_ms[i], 1) for i in untraced]}); "
        f"step {PF_START + PF_STEPS} includes the trace's stop and export, "
        f"{[round(x, 2) for x in stops]} s; eval + exports {pf['eval_and_export_s']:.1f} s "
        f"(A {ref['eval_and_export_s']:.1f} s without an output_dir)")
    pf.update(trace_counts=counts, trace_mb=trace_mb, stop_s=stops)
    return pf


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
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
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
                             seeded_params(mcfg, torch.bfloat16, "cuda"),
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


# ---------------------------------------------------------------------------
# data parallelism (--mesh_shape D,1,1): P, P0, PE over gloo ranks sharing
# the card, PN over NCCL
# ---------------------------------------------------------------------------

# P against A at the same global batch (bs 2 x 2 ranks = A's bs 4): bf16 on
# both, the ranks' products at half A's rows and the grads summed in
# another order. Losses: the prediction written before the first run
# (PERF.md, section 6; measured 9.0e-5). Warm-up grad norms (taken before
# the clip, so a reduce that drops a rank or averages where it must sum
# moves them by 30-50%, which Adam's update would hide from the losses):
# stated before their first run.
P_VS_A_RTOL = 1e-3
P_GNORM_RTOL = 5e-2
# P0 (tiny, fp32) against one process: JAX's own mesh bound
# (tests/test_sharding.py:55) on the losses and every step's grad norm,
# and the int8 bound on the losses over the int8 base (there a last-bit
# difference flips an int8 rounding, and the sparse steps' grad norms
# drift by ~1e-3 against one process: they are reported, not held).
# Rank 1's rows (2 and 3 of each global batch of 4) keep 4 valid labels
# each against rank 0's tens, so dividing by each rank's own count (DDP's
# mean of per-rank means, B1 reverted) moves the dense pair's losses by
# ~5e-3 and its grad norms by ~0.7, far outside the bound.
P0_RTOL, P0_INT8_RTOL = 2e-4, 1e-3
P0_KW = dict(dtype="fp32", seq=64, full_ft_steps=2, sparse_steps=4, eval_batches=1,
             ratios=(0.05, 0.05), log_fn=lambda m: None, thin=(2, 3))
# F's warm-up peak on a rank under P's: half of the fp32 master and two
# moments (12.3 GiB at TinyLlama) leaves each of the two ranks
FSDP_PEAK_GAIN_GIB = 5.0
PE_PROMPTS = 16
DP_TIMEOUT_S = 600  # a collective that waits longer fails the rank
REDUCE_S = [0.0]  # a rank's seconds in its collectives, between device syncs


def _time_collectives():
    """Wrap torch.distributed's all_reduce, all_gather_into_tensor and
    reduce_scatter_tensor in this rank so that each call is timed between
    two device syncs into REDUCE_S: the collective's own time, whatever the
    backend does asynchronously."""
    import torch
    import torch.distributed as dist

    def timed(orig):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            REDUCE_S[0] += time.perf_counter() - t0
            return out
        return call

    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        setattr(dist, name, timed(getattr(dist, name)))


def _rank_setup():
    import torch
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
    _build.load()  # built by the parent before the spawn


def _gloo_takes_cuda(rank, world):
    """Whether this torch's gloo backend takes CUDA tensors for all_reduce
    and broadcast (with the right values), or the error it raised."""
    import torch
    import torch.distributed as dist
    try:
        t = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        b = torch.full((8,), float(rank), device="cuda", dtype=torch.bfloat16)
        dist.broadcast(b, src=0)
        ok = bool((t == world * (world + 1) / 2).all()) and bool((b == 0).all())
        return {"ok": ok, "error": None if ok else "wrong values"}
    except Exception as e:  # reported, not staged through the host
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _pe_job(mesh, export_dir):
    """PE: the eval harness over A's export, the prompts split by rank
    stride (run_dataset_eval with the mesh), D1's settings."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig
    from sparse_matrix_tuning_tpu_torch.eval.harness import make_generate_fn, run_dataset_eval
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig(**TINYLLAMA)
    params = load_hf_params(export_dir, cfg, dtype=torch.bfloat16, device=mesh.device)
    tok = StandInTokenizer(cfg.vocab_size)
    examples = synthetic_eval_examples(PE_PROMPTS, tok, seed=11)
    gen = GenerationConfig(max_new_tokens=256, num_beams=4, repetition_penalty=1.1,
                           eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                           cache_dtype="bfloat16")
    fn = make_generate_fn(params, cfg, tok, gen, batch_size=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_dataset_eval("boolq", examples, fn, mesh=mesh)
    torch.cuda.synchronize()
    return {"tokens": np.concatenate(tok.decoded), "launches": launches(),
            "outputs": [p["raw_output"] for p in res["predictions"]],
            "wall_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 1024 ** 3}


def dp_rank(rank, world, port, jobs, out_dir, shape=None, backend="gloo"):
    """One gloo rank on cuda:0 (torch.multiprocessing spawn target; with
    backend "nccl" one NCCL rank on cuda:rank, no CUDA-tensor check): the
    CUDA-tensor check, then each job of `jobs` over a (world, 1, 1) mesh:
    ("P0", frozen_quant) the tiny fp32 pair, ("P", layers) TinyLlama as run
    A at A's global batch (bs 4 / world a rank), ("PE", export_dir) the rank-split eval; and over a
    (1, world, 1) mesh, the fsdp axis (or `shape` where given): ("F0",
    frozen_quant) the tiny fp32 pair at bs 4 / world a rank, ("F", (layers,
    export_dir)) TinyLlama as run A at A's global batch with the export
    (FE); and over a (1, world / 2, 2) mesh, the tensor axis: ("T0", dtype)
    the tiny pair in fp32 or fp16, ("T", (layers, export_dir)) TinyLlama as
    run A at A's global batch with the export (TE), the same over the
    int8 base ("TQ0", dtype; "TQ", layers: --frozen_quant int8, as run E,
    its export checked as merged_params and not written: hold_t), and over
    the scan state ("TS0", TS0_CASES' "{frozen_quant} {dtype}": the tiny
    pair with --scan_layers on; "TS", layers: run E with --scan_layers on,
    its export checked against one process's export of the gathered state,
    not written: hold_ts), and in channel mode ("TC0", TC0_CASES: the tiny
    pair per layer and over the scan state; "TC", layers: run H; "TCJ",
    layers: run J; their exports checked, not written: hold_tc), and the
    Qwen jobs ("QT0", (QT0_CASES' case, the tiny qwen2 checkpoint): the tiny
    tied, biased pair; "QT", (layers, checkpoint, export dir): Q's path with
    its export; "QTD", (layers, checkpoint): the same under --dropout 0.1;
    hold_qwen). Writes {out_dir}/dp.{rank}.pt."""
    import torch
    import torch.distributed as dist
    _rank_setup()
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.parallel import fsdp as fsdp_mod
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import init_distributed, make_mesh
    device = init_distributed(torch.device("cuda", 0 if backend == "gloo" else rank),
                              backend=backend, init_method=f"tcp://localhost:{port}", rank=rank,
                              world_size=world, timeout_s=DP_TIMEOUT_S)
    out = {"backend": dist.get_backend(), "gloo_cuda": None}
    if backend == "gloo":
        out["gloo_cuda"] = _gloo_takes_cuda(rank, world)
        if not out["gloo_cuda"]["ok"]:
            raise RuntimeError(f"rank {rank}: gloo does not take CUDA tensors on this torch: "
                               f"{out['gloo_cuda']['error']}")
    mesh = make_mesh((world, 1, 1), device=device) if shape is None else None
    fmesh = make_mesh(shape or (1, world, 1), device=device)
    # the tensor axis: (1, world / 2, 2)
    tmesh = make_mesh((1, world // 2, 2), device=device) \
        if any(tag in ("T0", "T", "TQ0", "TQ", "TS0", "TS", "TC0", "TC", "TCJ", "QT0", "QT",
                       "QTD") for tag, _ in jobs) else None
    # the tensor axis over every rank, (1, 1, world): where T cuts the heads
    hmesh = make_mesh((1, 1, world), device=device) \
        if any(tag in ("QH0", "QH") for tag, _ in jobs) else None
    _time_collectives()
    for tag, arg in jobs:
        t0 = time.time()
        if tag == "P0":
            s = run_main_path(LlamaConfig.tiny(vocab_size=512), device, bs=2, mesh=mesh,
                              frozen_quant=arg, **P0_KW)
        elif tag == "P":
            cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": arg})
            s = run_main_path(cfg, device, bs=4 // world, mesh=mesh,
                              log_fn=(lambda m: log(f"[P rank {rank}] {m}")))
        elif tag == "F0":
            fsdp_mod.LIVE.update(now=0, peak=0)
            s = run_main_path(LlamaConfig.tiny(vocab_size=512), device, bs=4 // world,
                              mesh=fmesh, frozen_quant=arg, **P0_KW)
        elif tag == "F":
            fsdp_mod.LIVE.update(now=0, peak=0)
            cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": arg[0]})
            s = run_main_path(cfg, device, bs=4 // world, mesh=fmesh, out_dir=arg[1],
                              log_fn=(lambda m: log(f"[F rank {rank}] {m}")))
        elif tag == "T0":
            s = run_main_path(LlamaConfig.tiny(vocab_size=512), device,
                              bs=4 // tmesh.batch_shards, mesh=tmesh, **{**P0_KW, "dtype": arg})
        elif tag == "T":
            cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": arg[0]})
            s = run_main_path(cfg, device, bs=4 // tmesh.batch_shards, mesh=tmesh,
                              out_dir=arg[1], log_fn=(lambda m: log(f"[T rank {rank}] {m}")))
        elif tag == "TQ0":
            s = run_main_path(LlamaConfig.tiny(vocab_size=512), device,
                              bs=4 // tmesh.batch_shards, mesh=tmesh, frozen_quant="int8",
                              **{**P0_KW, "dtype": arg})
        elif tag == "TQ":
            cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": arg})
            s = run_main_path(cfg, device, bs=4 // tmesh.batch_shards, mesh=tmesh,
                              frozen_quant="int8",
                              log_fn=(lambda m: log(f"[TQ rank {rank}] {m}")))
        elif tag == "TS0":
            fq, dt = arg.split()
            s = run_main_path(LlamaConfig.tiny(vocab_size=512), device,
                              bs=4 // tmesh.batch_shards, mesh=tmesh, frozen_quant=fq,
                              cfg_extra={"scan_layers": "on"}, **{**P0_KW, "dtype": dt})
        elif tag == "TS":
            cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": arg})
            s = run_main_path(cfg, device, bs=4 // tmesh.batch_shards, mesh=tmesh,
                              frozen_quant="int8", cfg_extra={"scan_layers": "on"},
                              log_fn=(lambda m: log(f"[TS rank {rank}] {m}")))
        elif tag == "TC0":
            s = tc0_run(arg, device, 4 // tmesh.batch_shards, tmesh)
        elif tag in ("TC", "TCJ"):
            cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": arg})
            s = run_main_path(cfg, device, bs=4 // tmesh.batch_shards, mesh=tmesh, mode="channel",
                              frozen_quant="int8" if tag == "TCJ" else "none",
                              log_fn=(lambda m: log(f"[{tag} rank {rank}] {m}")))
        elif tag == "QT0":
            s = qt0_run(arg[0], device, 4 // tmesh.batch_shards, arg[1], tmesh)
        elif tag in ("QT", "QTD"):
            s = run_main_path(qwen_cfg(arg[0]), device, bs=4 // tmesh.batch_shards, mesh=tmesh,
                              hf_dir=arg[1], out_dir=arg[2] if tag == "QT" else None,
                              cfg_extra={"dropout": 0.1} if tag == "QTD" else None,
                              log_fn=(lambda m: log(f"[{tag} rank {rank}] {m}")))
        elif tag == "QH0":
            s = run_main_path(qh0_cfg(arg), device, bs=4, mesh=hmesh, **P0_KW)
            s["cut_heads"] = _cut_heads_of(qh0_cfg(arg), hmesh)
        elif tag == "QH":
            s = run_main_path(qwen_cfg(arg[0]), device, bs=4, mesh=hmesh, hf_dir=arg[1],
                              log_fn=(lambda m: log(f"[QH rank {rank}] {m}")))
            s["cut_heads"] = _cut_heads_of(qwen_cfg(arg[0]), hmesh)
        elif tag == "FS0":
            fsdp_mod.LIVE.update(now=0, peak=0)
            s = fs0_run(arg, device, 4 // world, fmesh)
        elif tag == "FS":
            fsdp_mod.LIVE.update(now=0, peak=0)
            s = fs_run(arg, device, 4 // world, fmesh,
                       log_fn=(lambda m: log(f"[FS rank {rank}] {m}")))
        else:
            s = _pe_job(mesh, arg)
        s["seconds"] = time.time() - t0
        s["live_peak"] = fsdp_mod.LIVE["peak"]
        out[_job_key(tag, arg)] = s
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(out_dir, f"dp.{rank}.pt"))
    dist.destroy_process_group()


def _cut_heads_of(model_cfg, mesh):
    """This rank's attention where T cuts the heads (models/llama.cut_heads):
    {"first", "kv", "hq", "col"}: its whole kv groups' first kv head and
    count, the q heads K3 runs on them, where its o_proj columns begin."""
    from sparse_matrix_tuning_tpu_torch.models.llama import cut_heads
    cut = cut_heads(model_cfg, mesh)
    if cut is None:
        raise AssertionError(f"{mesh.shape}: T divides the heads of {model_cfg}")
    g = model_cfg.num_attention_heads // model_cfg.num_key_value_heads
    return {"first": cut[0], "kv": cut[1], "hq": cut[1] * g, "col": cut[2]}


def _job_key(tag, arg):
    """Where dp_rank keeps a job's summary: "F", "T", "TQ", "TS", "TC",
    "TCJ", "QT", "QTD", "QH", "FS:{mode}", "QT0:{case}", or "{tag}:{arg}"."""
    if tag in ("F", "T", "TQ", "TS", "TC", "TCJ", "QT", "QTD", "QH"):
        return tag
    if tag == "QT0":
        return f"QT0:{arg[0]}"
    return f"FS:{arg[1]}" if tag == "FS" else f"{tag}:{arg}"


# FS0: the tiny fp32 scan layouts, "dense" and "int8" --scan_layers on in
# matrix mode over the fp32 and the int8 base (2 layers), "channel"
# channel + int8 at 12 layers (the "auto" scan); P0's settings
FS0_RUNS = ("dense", "int8", "channel")
# the kernels each must launch on every rank (fp32 attention walks each
# group whole: no dK/dV reduce; channel mode runs no K1 or K5)
FS0_KERNELS = {
    "dense": tuple(n for n in TRAIN_KERNELS if n != "attn_bwd_dkdv_reduce"),
    "int8": tuple(n for n in TRAIN_KERNELS if n != "attn_bwd_dkdv_reduce") + Q8_KERNELS,
    "channel": ("masked_adam", "attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")
    + K4_KERNELS + ("row_quant",)}


def fs0_run(name, device, bs, mesh=None):
    """FS0 case `name` (FS0_RUNS) through run_main_path, in one process or
    as a rank of `mesh` (bs a rank)."""
    import dataclasses
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    tiny = LlamaConfig.tiny(vocab_size=512)
    kw = dict(bs=bs, **({"mesh": mesh} if mesh is not None else {}), **P0_KW)
    if name == "channel":
        return run_main_path(dataclasses.replace(tiny, num_hidden_layers=12), device,
                             mode="channel", frozen_quant="int8", **kw)
    return run_main_path(tiny, device, frozen_quant="int8" if name == "int8" else "none",
                         cfg_extra={"scan_layers": "on"}, **kw)


def fs_run(arg, device, bs, mesh=None, log_fn=log):
    """FS: (layers, mode, export dir): TinyLlama over the int8 base in the
    scan layout, --scan_layers on in matrix mode (E's settings otherwise),
    or channel + int8 at depth under "auto" (J's), with the export."""
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    layers, mode, export_dir = arg
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": layers})
    return run_main_path(cfg, device, bs=bs, out_dir=export_dir, mode=mode, frozen_quant="int8",
                         cfg_extra={"scan_layers": "on"} if mode == "matrix" else None,
                         log_fn=log_fn, **({"mesh": mesh} if mesh is not None else {}))


def hold_fs0(shape, name, got, ref, tag="FS0"):
    """FS0 case `name` on an fsdp mesh against one process (P0's bounds:
    losses and dense grad norms within 2e-4, int8 losses within 1e-3; the
    same fingerprint; every kernel of the case launched on each rank; one
    gathered layer alive at a time; each rank holding 1/F of every sharded
    leaf and of the host store)."""
    import numpy as np
    int8 = name != "dense"
    rtol = P0_INT8_RTOL if int8 else P0_RTOL
    fps = {g["plan"]["fingerprint"] for g in got} | {ref["plan"]["fingerprint"]}
    if len(fps) != 1:
        raise AssertionError(f"{tag} {shape} {name}: plan fingerprints differ: {fps}")
    if any(g["loss"] != got[0]["loss"] for g in got):
        raise AssertionError(f"{tag} {shape} {name}: the ranks' losses differ")
    f = shape[1]
    for r, g in enumerate(got):
        if not g["scan"] or not all(g["launches"][n] > 0 for n in FS0_KERNELS[name]):
            raise AssertionError(f"{tag} {shape} {name} rank {r}: scan {g['scan']}, launches "
                                 f"{g['launches']}")
        sb = g["state_bytes"]["sparse"]
        if sb["split_here"] * f != sb["split_full"] or sb["host_here"] * f != sb["host_full"]:
            raise AssertionError(f"{tag} {shape} {name} rank {r}: not 1/{f} of the sharded "
                                 f"leaves or of the host store: {sb}")
        if g["live_peak"] != 1:
            raise AssertionError(f"{tag} {shape} {name} rank {r}: {g['live_peak']} gathered "
                                 "layers alive at once")
    norms, ref_norms = (np.array(r["warmup_grad_norm"] + r["grad_norm"]) for r in (got[0], ref))
    np.testing.assert_allclose(got[0]["loss"] + [got[0]["eval_loss"]],
                               ref["loss"] + [ref["eval_loss"]], rtol=rtol)
    if not int8:
        np.testing.assert_allclose(norms, ref_norms, rtol=rtol)
    worst = float(np.max(np.abs(np.array(got[0]["loss"]) - np.array(ref["loss"]))
                         / np.abs(np.array(ref["loss"]))))
    worst_norm = float(np.max(np.abs(norms - ref_norms) / ref_norms))
    c = got[0]["collectives"]
    sb = got[0]["state_bytes"]["sparse"]
    log(f"[{tag}] tiny fp32 scan layout {name} at {shape}, {len(got)} ranks against one process "
        f"at global batch 4 (rows 2-3 thinned): losses worst rel diff {worst:.2e}, grad norms "
        f"{worst_norm:.2e} (bound {rtol} on {'the losses; grad norms reported' if int8 else 'both'}"
        f"); eval {got[0]['eval_loss']:.6f} vs {ref['eval_loss']:.6f}; same plan "
        f"{ref['plan']['fingerprint'][:16]}; state a rank {sb['here']:,} of {sb['full']:,} B "
        f"(sharded {sb['split_here']:,} / {sb['split_full']:,}), host store "
        f"{sb['host_here']:,} / {sb['host_full']:,} B; gathered MB/step "
        f"{[round(x['gather_bytes'] / 1e6, 2) for x in c]}, reduce-scattered MB/step "
        f"{[round(x['scatter_bytes'] / 1e6, 2) for x in c]}; rank 0 launches {got[0]['launches']}")


def hold_fs(tag, shape, backend, fs, ref, ref_tag, layers, peak=None):
    """FS: TinyLlama's scan layouts on an fsdp mesh against the one-process
    run `ref` of the same path (J for channel + int8; E for --scan_layers on
    in matrix mode, whose warm-up is the same and whose sparse phase runs
    the int8 base in the per-layer layout): F's bounds (losses within 1e-3,
    warm-up grad norms within 5e-2); the ranks' losses and plans equal;
    every kernel of the path launched on each rank; each rank's sharded
    leaves and host store exactly 1/F of the whole; the export read back
    (FE's check) and equal to one process's export of the gathered state
    (FSE); with peak, (what, bytes), each rank's sparse-phase peak under
    it (one process's run of the same path). Logs per rank ms/step, the collectives' bytes, calls
    and ms, the state's bytes and the peaks."""
    import numpy as np
    gib = 1024 ** 3
    mode = fs[0]["plan"]["mode"]
    needed = SCAN_KERNELS if mode == "matrix" else \
        K3_KERNELS + ("masked_adam",) + K4_KERNELS + ("row_quant",)
    never = () if mode == "matrix" else ("block_grad", "block_correction", "q4_matmul")
    if any(s["loss"] != fs[0]["loss"] or s["plan"] != fs[0]["plan"] for s in fs):
        raise AssertionError(f"{tag} {mode}: the ranks' losses or plans differ")
    f = shape[1]
    for r, s in enumerate(fs):
        sb = s["state_bytes"]["sparse"]
        bad = [n for n in needed if s["launches"][n] <= 0] + [n for n in never
                                                             if s["launches"][n]]
        if not s["scan"] or not s["offloaded"] or bad:
            raise AssertionError(f"{tag} {mode} rank {r}: scan {s['scan']}, host store "
                                 f"{s['offloaded']}, launches wrong for {bad}: {s['launches']}")
        if sb["split_here"] * f != sb["split_full"] or sb["host_here"] * f != sb["host_full"] \
                or not sb["host_here"]:
            raise AssertionError(f"{tag} {mode} rank {r}: not 1/{f} of the sharded leaves or of "
                                 f"the host store: {sb}")
        if not s["export_tensors_equal"] or not s.get("fse_tensors"):
            raise AssertionError(f"{tag}E {mode} rank {r}: the export was not checked")
        if s["live_peak"] != 1:
            raise AssertionError(f"{tag} {mode} rank {r}: {s['live_peak']} gathered layers "
                                 "alive at once")
    r_loss = ref["loss"] + [ref["eval_loss"]]
    f_loss = fs[0]["loss"] + [fs[0]["eval_loss"]]
    rel = np.abs(np.array(f_loss) - np.array(r_loss)) / np.abs(np.array(r_loss))
    r_norm, f_norm = np.array(ref["warmup_grad_norm"]), np.array(fs[0]["warmup_grad_norm"])
    rel_norm = np.abs(f_norm - r_norm) / r_norm if len(r_norm) else np.zeros(1)
    path = ("all-gather and reduce-scatter built from gloo's all_reduce" if backend == "gloo"
            else "NCCL all_gather_into_tensor and reduce_scatter_tensor")
    what = ("--scan_layers on, matrix" if mode == "matrix" else
            "channel + int8 at depth (scan_layers auto)")
    log(f"[{tag}] TinyLlama-1.1B bf16 {what} over the int8 base, "
        f"{layers} layers, fsdp {shape} over "
        f"{len(fs)} {backend} ranks ({path}) x bs {4 // len(fs)} x seq 512: losses {f_loss} vs "
        f"{ref_tag}'s {r_loss}, worst rel diff {float(rel.max()):.2e} (bound {P_VS_A_RTOL}); "
        f"warm-up grad norms worst rel diff {float(rel_norm.max()):.2e} (bound {P_GNORM_RTOL}); "
        f"plan {fs[0]['plan']['fingerprint'][:16]} on every rank, {ref_tag}'s "
        f"{ref['plan']['fingerprint'][:16]} ({CARD['smi']})")
    n_warm = 3
    for r, s in enumerate(fs):
        ms, c, sb = s["step_ms"], s["collectives"], s["state_bytes"]
        log(f"[{tag}] {mode} rank {r}: warm-up ms/step {[round(x, 1) for x in ms[:n_warm]]}, "
            f"sparse {[round(x, 1) for x in ms[n_warm:]]} ({ref_tag}: "
            f"{[round(x, 1) for x in ref['step_ms']]}); collective ms/step "
            f"{[round(x, 1) for x in s['reduce_ms']]}; gathered MB / calls a step "
            f"{[(round(x['gather_bytes'] / 1e6, 1), x['gather_calls']) for x in c]}; "
            f"reduce-scattered MB / calls "
            f"{[(round(x['scatter_bytes'] / 1e6, 1), x['scatter_calls']) for x in c]}; "
            f"all-reduced MB / calls {[(round(x['bytes'] / 1e6, 1), x['calls']) for x in c]}")
        log(f"[{tag}] {mode} rank {r}: scan state bytes here / full "
            f"{sb['sparse']['here'] / gib:.3f} / {sb['sparse']['full'] / gib:.3f} GiB (sharded "
            f"leaves {sb['sparse']['split_here']:,} / {sb['sparse']['split_full']:,} B), host "
            f"store {sb['sparse']['host_here'] / gib:.3f} / {sb['sparse']['host_full'] / gib:.3f}"
            f" GiB; peak GiB {({k: round(v / gib, 2) for k, v in s['peak'].items() if v})} beside "
            f"{ref_tag}'s {({k: round(v / gib, 2) for k, v in ref['peak'].items() if v})}"
            + (f" and {peak[0]} sparse peak {peak[1] / gib:.2f}" if peak is not None else "")
            + f"; launches {s['launches']}; {s['seconds']:.1f} s")
    log(f"[{tag}E] {mode}: rank 0's export ({fs[0]['export_tensors_equal']} tensors) read back "
        f"on each rank equals the gathered state, and its {fs[0]['fse_tensors']} tensors equal "
        "one process's export of the gathered state and host store bit for bit")
    if rel.max() > P_VS_A_RTOL:
        raise AssertionError(f"{tag} {mode}: losses part from {ref_tag}'s by "
                             f"{float(rel.max()):.2e} > {P_VS_A_RTOL}")
    if len(f_norm) != len(r_norm) or rel_norm.max() > P_GNORM_RTOL:
        raise AssertionError(f"{tag} {mode}: warm-up grad norms {f_norm.tolist()} part from "
                             f"{ref_tag}'s {r_norm.tolist()} by more than {P_GNORM_RTOL}")
    if peak is not None:
        for r, s in enumerate(fs):
            if s["peak"]["later_sparse_steps"] >= peak[1]:
                raise AssertionError(f"{tag} {mode} rank {r}: sparse-phase peak "
                                     f"{s['peak']['later_sparse_steps'] / gib:.2f} GiB not under "
                                     f"{peak[0]} {peak[1] / gib:.2f}")


def pn_rank(rank, world, port, out_dir):
    """PN: NCCL, one rank a card: init, a bucketed all-reduce (fp32 under
    and over the cap, bf16, int32) whose sums must be exact, then one tiny
    fp32 warm-up step at a global batch of 4 rows, held against the same
    step in one process (world 1: bit for bit, the one rank's all-reduce
    being the identity)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    _rank_setup()
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.data.sft import batch_iterator
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
    from sparse_matrix_tuning_tpu_torch.parallel import mesh as mesh_mod
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import (
        all_reduce_, init_distributed, leaf_checksums, make_mesh)
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    t0 = time.time()
    device = init_distributed(torch.device("cuda", rank), backend="nccl",
                              init_method=f"tcp://localhost:{port}", rank=rank,
                              world_size=world, timeout_s=DP_TIMEOUT_S)
    mesh = make_mesh((world, 1, 1), device=device)
    init_s = time.time() - t0
    mesh_mod.BUCKET_MIB = 1  # this rank's process only: several buckets
    want = world * (world + 1) // 2
    ts = [torch.full((n,), rank + 1, dtype=dt, device=device) for n, dt in (
        (1000, torch.float32), (300_000, torch.float32), (4096, torch.bfloat16),
        (77, torch.int32), (5, torch.float32))]
    all_reduce_(ts, mesh)
    buckets = {"calls": mesh.stats["calls"], "bytes": mesh.stats["bytes"]}
    if not all(bool((t == want).all()) for t in ts):
        raise AssertionError(f"PN rank {rank}: NCCL bucket all-reduce sums are wrong")
    tiny = LlamaConfig.tiny(vocab_size=512)
    cfg = dict(data_path=["synthetic"], model_name_or_path="random-init", dtype="fp32",
               matrix_sparsity=True, full_ft_steps=2, downsample_attention_blocks_ratio=0.05,
               downsample_mlp_blocks_ratio=0.05, max_seq_len=64, seq_buckets=[64], seed=1234,
               eval_step=0, save_steps=0)
    batch = next(batch_iterator(synthetic_sft(4, 64, tiny.vocab_size, 1), 4, 0, [64], 1234, 0))

    def one_step(m):
        params = init_params(tiny, seed=0, dtype=torch.float32, device=device)
        trainer = SMTTrainer(SMTConfig(**cfg, mesh_shape=[world, 1, 1] if m else None), tiny,
                             params, total_steps=2, device=device,
                             **({"mesh": m} if m else {}))
        loss = float(trainer.train_step(batch)["loss"])
        return loss, leaf_checksums({k: v for k, v in trainer.state["master"]["layers"]["0"]
                                    .items()})

    loss, sums = one_step(mesh)
    out = {"backend": dist.get_backend(), "world": world, "init_s": init_s, "buckets": buckets,
           "loss": loss}
    if rank == 0:
        ref_loss, ref_sums = one_step(None)
        out["ref_loss"] = ref_loss
        if world == 1 and (loss != ref_loss or sums != ref_sums):
            raise AssertionError(f"PN: the one NCCL rank's step differs from one process's: "
                                 f"loss {loss} vs {ref_loss}")
        np.testing.assert_allclose(loss, ref_loss, rtol=P0_RTOL)
    out["fn"] = fn_collectives(rank, world, device)
    torch.save(out, os.path.join(out_dir, f"pn.{rank}.pt"))
    dist.destroy_process_group()


def fn_collectives(rank, world, device):
    """FN: the fsdp axis's collectives through NCCL at (1, world, 1):
    all_gather_ and reduce_scatter_ of fp32, bf16 and int8 tensors (whose
    results are exact: small integers), then fsdp.gather's forward and its
    backward's reduce-scatter through autograd, each held exactly to what
    the ranks' inputs make."""
    import torch
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import gather
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import (
        all_gather_, make_mesh, reduce_scatter_)
    mesh = make_mesh((1, world, 1), device=device)

    def vals(r, n, dt):
        return ((torch.arange(n, device=device) % 7) + 3 * r).to(dt)

    cases = []
    for dt, n in ((torch.float32, 4099), (torch.bfloat16, 1000), (torch.int8, 517)):
        got = all_gather_(vals(rank, n, dt), mesh)
        want = torch.cat([vals(r, n, dt) for r in range(world)])
        full = torch.cat([vals(r + rank, n, dt) for r in range(world)])
        mine = reduce_scatter_(full.clone(), mesh)
        want_rs = sum(torch.cat([vals(r + q, n, dt) for r in range(world)]).float()
                      for q in range(world))[rank * n:(rank + 1) * n].to(dt)
        if not (torch.equal(got, want) and torch.equal(mine, want_rs)):
            raise AssertionError(f"FN: {dt} all-gather or reduce-scatter is not exact")
        cases.append(f"{str(dt).split('.')[-1]} x {n}")
    shard = (vals(rank, 12, torch.float32).reshape(3, 4) + 1).requires_grad_(True)
    w = torch.arange(3 * 4 * world, device=device, dtype=torch.float32).reshape(3, 4 * world)
    (full,) = gather(mesh, [shard], [1])
    want = torch.cat([vals(r, 12, torch.float32).reshape(3, 4) + 1 for r in range(world)], 1)
    (full * w * (rank + 1)).sum().backward()
    grad_want = w[:, rank * 4:(rank + 1) * 4] * sum(range(1, world + 1))
    if not (torch.equal(full.detach(), want) and torch.equal(shard.grad, grad_want)):
        raise AssertionError("FN: fsdp.gather forward or backward is not exact")
    path = ("built from all_reduce (gloo)" if torch.distributed.get_backend() == "gloo" else
            "all_gather_into_tensor / reduce_scatter_tensor (nccl)")
    return {"mesh": mesh.shape, "cases": cases, "path": path, "stats": dict(mesh.stats)}


def check_fsdp(ranks, refs, run_a, p, layers, t_layers, t_refs, q=None):
    """F0 and F from the data-parallel spawn (two gloo ranks at (1, 2, 1))
    and F0 at (2, 2, 1) from a spawn of four, held against one process
    (hold_f0, hold_f): F with its export (FE) and each rank's warm-up peak
    at least FSDP_PEAK_GAIN_GIB under P's; T0, TQ0 and T (the tensor axis,
    at (1, 1, 2) in the pair and T0 and TQ0 at (1, 2, 2) in the four;
    hold_t0, hold_t; TS0, the same over the scan state, and TC0, in
    channel mode: hold_tensor_tiny); T, TQ and TS at t_layers against
    t_refs' "A" and "E" (one process at that depth; "E" None: no TQ or
    TS ran); with q (prepare_qwen's), QT0 in the four too, and QT0 and
    QT (hold_qwen), and in the four at QH_SHAPE QH0 and QH (hold_qh0,
    hold_qh). Returns rank 0's summaries (and every rank's TC and TCJ: TC
    is held once H has run, TCJ once J has)."""
    t0 = time.time()
    quad = _spawn(dp_rank, 4, [("F0", "none")] + [("FS0", n) for n in FS0_RUNS]
                  + tensor_tiny_jobs() + (qt0_jobs(q) + qh_jobs(q) if q else []),
                  after=((2, 2, 1),))
    log(f"[F0] 4 gloo ranks on cuda:0 at (2, 2, 1), F0 and FS0, and T0, TQ0, TS0 and TC0 at "
        f"(1, 2, 2){', QT0 and, at ' + str(QH_SHAPE) + ', QH0 and QH' if q else ''}: "
        f"{time.time() - t0:.1f} s for the spawn; seconds by job on rank 0: "
        f"{ {k: round(v['seconds'], 1) for k, v in quad[0].items() if isinstance(v, dict) and 'seconds' in v} }")
    for fq in ("none", "int8"):
        hold_f0((1, 2, 1), fq, [r[f"F0:{fq}"] for r in ranks], refs)
    hold_f0((2, 2, 1), "none", [r["F0:none"] for r in quad], refs)
    for shape, got in (((1, 2, 1), ranks), ((2, 2, 1), quad)):
        for n in FS0_RUNS:
            hold_fs0(shape, n, [r[f"FS0:{n}"] for r in got], refs[f"FS0:{n}"])
    f = [r["F"] for r in ranks]
    hold_f("F", (1, 2, 1), "gloo", f, run_a, layers, p)
    # T0 and T: the tensor axis, at (1, 1, 2) in the pair and (1, 2, 2) in the quad
    for shape, got in (((1, 1, 2), ranks), ((1, 2, 2), quad)):
        hold_tensor_tiny(shape, got, refs)
    hold_t("T", (1, 1, 2), "gloo", [r["T"] for r in ranks], t_refs["A"], t_layers,
           {"P rank 0": p[0], "F rank 0": f[0]})
    if t_refs["E"] is not None:
        hold_t("TQ", (1, 1, 2), "gloo", [r["TQ"] for r in ranks], t_refs["E"], t_layers,
               {"T rank 0": ranks[0]["T"]}, fq="int8")
        hold_ts("TS", (1, 1, 2), "gloo", [r["TS"] for r in ranks], t_refs["E"], t_layers,
                {"TQ rank 0": ranks[0]["TQ"]})
    qwen = {}
    if q is not None:
        qwen = {"Q": q["Q"], "QT": hold_qwen(q, ranks, quad), "K1 qwen": q["K1"],
                **{f"QT0 {c}": ranks[0][f"QT0:{c}"] for c in QT0_CASES}}
        hold_qh0(quad, refs)
        hold_qh("QH", [r["QH"] for r in quad], q["Q"], q["layers"],
                beside={"QT rank 0": qwen["QT"]})
        qwen.update({"QH": quad[0]["QH"],
                     **{f"QH0 {n}": quad[0][f"QH0:{n}"] for n in QH0_MODELS}})
    gib = 1024 ** 3
    for r in range(2):
        gain = (p[r]["peak"]["warmup"] - f[r]["peak"]["warmup"]) / gib
        if gain < FSDP_PEAK_GAIN_GIB:
            raise AssertionError(f"F rank {r}: warm-up peak {f[r]['peak']['warmup'] / gib:.2f} "
                                 f"GiB is only {gain:.2f} GiB under P's (want "
                                 f">= {FSDP_PEAK_GAIN_GIB})")
    return {"F": f[0], "F0": ranks[0]["F0:none"], "F0 int8": ranks[0]["F0:int8"],
            "F0 (2,2,1)": quad[0]["F0:none"], "T": ranks[0]["T"], "TQ": ranks[0].get("TQ"),
            "TS": ranks[0].get("TS"), "TC ranks": [r.get("TC") for r in ranks],
            "TCJ ranks": [r.get("TCJ") for r in ranks],
            **{f"TC0 {c}": ranks[0][f"TC0:{c}"] for c in TC0_CASES},
            **{f"{k} {d}": ranks[0][f"{k}:{d}"] for d in T0_DTYPES for k in ("T0", "TQ0")},
            **{f"{k} {d} (1,2,2)": quad[0][f"{k}:{d}"] for d in T0_DTYPES
               for k in ("T0", "TQ0")},
            **{f"FS0 {n}": ranks[0][f"FS0:{n}"] for n in FS0_RUNS},
            **{f"FS0 {n} (2,2,1)": quad[0][f"FS0:{n}"] for n in FS0_RUNS},
            # every rank's FS summary, held to E, G and J when they have run (hold_fs)
            "FS": {m: [r[f"FS:{m}"] for r in ranks] for m in ("matrix", "channel")
                   if f"FS:{m}" in ranks[0]}, **qwen}


def hold_f0(shape, fq, got, refs, tag="F0"):
    """The tiny fp32 pair on an fsdp mesh against one process (P0's
    bounds: losses and dense grad norms within 2e-4, int8 losses within
    1e-3, the same fingerprint, every kernel launched on each rank)."""
    import numpy as np
    ref, rtol = refs[fq], (P0_RTOL if fq == "none" else P0_INT8_RTOL)
    fps = {g["plan"]["fingerprint"] for g in got} | {ref["plan"]["fingerprint"]}
    if len(fps) != 1:
        raise AssertionError(f"{tag} {shape} {fq}: plan fingerprints differ: {fps}")
    if any(g["loss"] != got[0]["loss"] for g in got):
        raise AssertionError(f"{tag} {shape} {fq}: the ranks' losses differ")
    needed = tuple(n for n in TRAIN_KERNELS if n != "attn_bwd_dkdv_reduce") + (
        Q8_KERNELS if fq == "int8" else ())
    for r, g in enumerate(got):
        if not all(g["launches"][n] > 0 for n in needed):
            raise AssertionError(f"{tag} {shape} {fq} rank {r} did not launch every kernel: "
                                 f"{g['launches']}")
    norms, ref_norms = (np.array(r["warmup_grad_norm"] + r["grad_norm"]) for r in (got[0], ref))
    np.testing.assert_allclose(got[0]["loss"] + [got[0]["eval_loss"]],
                               ref["loss"] + [ref["eval_loss"]], rtol=rtol)
    if fq == "none":
        np.testing.assert_allclose(norms, ref_norms, rtol=rtol)
    worst = float(np.max(np.abs(np.array(got[0]["loss"]) - np.array(ref["loss"]))
                         / np.abs(np.array(ref["loss"]))))
    worst_norm = float(np.max(np.abs(norms - ref_norms) / ref_norms))
    c = got[0]["collectives"]
    log(f"[{tag}] tiny fp32 at {shape}, frozen_quant {fq}, {len(got)} ranks against one "
        f"process at global batch 4 (rows 2-3 thinned): losses worst rel diff {worst:.2e}, "
        f"grad norms {worst_norm:.2e} (bound {rtol} on "
        f"{'both' if fq == 'none' else 'the losses; grad norms reported'}); eval "
        f"{got[0]['eval_loss']:.6f} vs {ref['eval_loss']:.6f}; same plan "
        f"{ref['plan']['fingerprint'][:16]}; {got[0]['checksums']} leaves compared; "
        f"gathered MB/step {[round(x['gather_bytes'] / 1e6, 2) for x in c]}, reduce-"
        f"scattered MB/step {[round(x['scatter_bytes'] / 1e6, 2) for x in c]}; gathered "
        f"layers alive at once {max(g['live_peak'] for g in got)}; rank 0 launches "
        f"{got[0]['launches']}")


def hold_f(tag, shape, backend, f, run_a, layers, p=None):
    """A's path on an fsdp mesh against A (P's bounds: losses within 1e-3,
    warm-up grad norms within 5e-2; the ranks' losses and plans equal,
    every kernel launched on each rank, the export read back on each rank
    (FE)); per rank the ms/step, the collectives' bytes and calls a step,
    the state's bytes and the peaks beside P's (where p is given) or A's."""
    import numpy as np
    if any(s["loss"] != f[0]["loss"] or s["plan"] != f[0]["plan"] for s in f):
        raise AssertionError(f"{tag}: the ranks' losses or plans differ")
    for r, s in enumerate(f):
        if not all(s["launches"][n] > 0 for n in TRAIN_KERNELS):
            raise AssertionError(f"{tag} rank {r} did not launch every kernel: {s['launches']}")
        if not s["export_tensors_equal"]:
            raise AssertionError(f"{tag}E rank {r}: the export was not read back")
    a_loss = run_a["loss"] + [run_a["eval_loss"]]
    f_loss = f[0]["loss"] + [f[0]["eval_loss"]]
    rel = np.abs(np.array(f_loss) - np.array(a_loss)) / np.abs(np.array(a_loss))
    a_norm, f_norm = np.array(run_a["warmup_grad_norm"]), np.array(f[0]["warmup_grad_norm"])
    rel_norm = np.abs(f_norm - a_norm) / a_norm
    gib = 1024 ** 3
    path = ("all-gather and reduce-scatter built from gloo's all_reduce" if backend == "gloo"
            else "NCCL all_gather_into_tensor and reduce_scatter_tensor")
    log(f"[{tag}] TinyLlama-1.1B bf16, {layers} layers, fsdp {shape} over {len(f)} {backend} "
        f"ranks ({path}) x bs {4 // len(f)} x seq 512 (A's global batch), 3 warm-up + 4 "
        f"sparse steps: "
        f"losses {f_loss} vs A's {a_loss}, worst rel diff {float(rel.max()):.2e} (bound "
        f"{P_VS_A_RTOL}); warm-up grad norms {f_norm.tolist()} vs A's {a_norm.tolist()}, worst "
        f"rel diff {float(rel_norm.max()):.2e} (bound {P_GNORM_RTOL}); plan "
        f"{f[0]['plan']['fingerprint'][:16]} on every rank, A's "
        f"{run_a['plan']['fingerprint'][:16]}; gathered trainables, m and v bit-equal across "
        f"ranks ({CARD['smi']})")
    log_selection_margin(run_a, f[0], tag=tag)
    n_warm = 3
    beside = ("P", p) if p is not None else ("A", [run_a] * len(f))
    for r, s in enumerate(f):
        ms, c = s["step_ms"], s["collectives"]
        sb = s["state_bytes"]
        log(f"[{tag}] rank {r}: warm-up ms/step {[round(x, 1) for x in ms[:n_warm]]}, sparse "
            f"{[round(x, 1) for x in ms[n_warm:]]} ({beside[0]} rank 0: "
            f"{[round(x, 1) for x in beside[1][0]['step_ms']]}); collective ms/step "
            f"{[round(x, 1) for x in s['reduce_ms']]}; gathered MB / calls a step "
            f"{[(round(x['gather_bytes'] / 1e6, 1), x['gather_calls']) for x in c]}; "
            f"reduce-scattered MB / calls "
            f"{[(round(x['scatter_bytes'] / 1e6, 1), x['scatter_calls']) for x in c]}; "
            f"all-reduced MB / calls {[(round(x['bytes'] / 1e6, 1), x['calls']) for x in c]}")
        log(f"[{tag}] rank {r}: state bytes here / full: warm-up "
            f"{sb['build']['here'] / gib:.3f} / {sb['build']['full'] / gib:.3f} GiB (sharded "
            f"leaves {sb['build']['split_here']:,} / {sb['build']['split_full']:,} B), sparse "
            f"{sb['sparse']['here'] / gib:.3f} / {sb['sparse']['full'] / gib:.3f} GiB (sharded "
            f"{sb['sparse']['split_here']:,} / {sb['sparse']['split_full']:,} B); peak GiB "
            f"{ {k: round(v / gib, 2) for k, v in s['peak'].items() if v is not None} } beside "
            f"{beside[0]} rank {r if p is not None else 0}'s "
            f"{ {k: round(v / gib, 2) for k, v in beside[1][r]['peak'].items() if v is not None} }"
            f"; gathered layers alive at once {s['live_peak']}; launches K1 "
            f"{s['launches']['block_grad']}, K2 {s['launches']['masked_adam']}, K3 fwd "
            f"{s['launches']['attn_fwd']}, dK/dV {s['launches']['attn_bwd_dkdv']}; "
            f"{s['seconds']:.1f} s")
    log(f"[{tag}E] rank 0's export ({f[0]['export_tensors_equal']} tensors) read back on each "
        f"rank equals the gathered state bit for bit")
    if rel.max() > P_VS_A_RTOL:
        raise AssertionError(f"{tag}: losses part from A's by {float(rel.max()):.2e} > "
                             f"{P_VS_A_RTOL}")
    if len(f_norm) != len(a_norm) or rel_norm.max() > P_GNORM_RTOL:
        raise AssertionError(f"{tag}: warm-up grad norms {f_norm.tolist()} part from A's "
                             f"{a_norm.tolist()} by more than {P_GNORM_RTOL}")


# T0: the tiny pair on a tensor mesh, fp32 (P0's bounds) and fp16 (the
# int8 bound on the losses, the same overflow flags and scales)
T0_DTYPES = ("fp32", "fp16")
# the split row quantization's two entries (ops/cuda/row_quant.py), which
# the int8 base under the tensor axis launches on every rank
RQ_SPLIT_KERNELS = ("row_amax", "row_quant_amax")
TQ_KERNELS = TRAIN_KERNELS + Q8_KERNELS + RQ_SPLIT_KERNELS
# TS0: the tiny pair over the scan state under the tensor axis (--scan_layers
# on), "{frozen_quant} {dtype}"; over the dense base the scan state's
# smt_linear_dyn corrects through K5 as well
TS0_CASES = ("none fp32", "none fp16", "int8 fp32", "int8 fp16")
TS_DENSE_KERNELS = TRAIN_KERNELS + ("block_correction",)
# TC0: the tiny pair in channel mode under the tensor axis, "{layout}
# {dtype}": per layer ("layer"), --scan_layers on over the fp32 ("scan")
# and the int8 base ("int8"); P0's settings
TC0_CASES = tuple(f"{lay} {dt}" for lay in ("layer", "scan", "int8") for dt in T0_DTYPES)
# what channel mode launches on every rank (the columns' products are
# matmuls: no K1 or K5); over the int8 scan state K4 and the row
# quantization's three entries as well
TC_KERNELS = ("masked_adam",) + K3_KERNELS
TCJ_KERNELS = TC_KERNELS + K4_KERNELS + ("row_quant",) + RQ_SPLIT_KERNELS


def _fp16_names(names):
    return tuple(n if n == "masked_adam" else f"{n}_fp16" for n in names)


def _tensor_state_held(tag, x, ref, n_t, int8):
    """Each rank's tensor-split leaves exactly 1/n_t of the whole, and its
    whole state the reference's, over the build and the sparse phase; over
    the int8 base (where one process leaves its dense weights for the host
    after the conversion) the sparse phase's int8 base and head instead:
    the reference's bytes in all, fewer on the rank."""
    for phase in ("build", "sparse"):
        sb, want = x["state_bytes"][phase], ref["state_bytes"][phase]
        whole = (sb["q_here"] < sb["q_full"] == want["q_full"] if int8 and phase == "sparse"
                 else sb["full"] == want["full"])
        if not sb["tsplit_here"] or sb["tslice"] * n_t != sb["tsplit_full"] or not whole:
            raise AssertionError(f"{tag}: not 1/{n_t} of the tensor-split leaves, or not the "
                                 f"reference's whole state in the {phase} phase: {sb} vs {want}")


def _one_row_quant_a_k4_call(tag, lx):
    """One row quantization, fused or split, a K4 call (E's rule), and each
    split one an amax launch and a quantize launch."""
    if lx["row_quant"] + lx["row_quant_amax"] != lx["q8mm_t"] + lx["q8mm_g"] \
            or lx["row_amax"] != lx["row_quant_amax"]:
        raise AssertionError(f"{tag}: not one row quantization a K4 call: {lx}")


def hold_t0(shape, dtype, got, refs, tag="T0", fq="none", scan=False, mode="matrix", ref=None,
            dropout=False):
    """The tiny pair on a tensor mesh against one process, over the dense
    base or (fq "int8": TQ0) the int8 base and head, in the per-layer
    layout or (scan: TS0, --scan_layers on) over the scan state, in matrix
    or (TC0) channel mode: the same plan; the ranks' losses equal; fp32
    losses and grad norms over the dense base within P0_RTOL, else the
    losses within P0_INT8_RTOL (grad norms reported: an int8 rounding
    flips), fp16 with the same loss scales and overflow flags; K1, K2 and
    K3 launched on every rank, over the int8 base K4 (t and g), the row
    quantization's three entries and K5 too (their fp16 bodies under
    fp16), over the scan state K5 over either base; in channel mode K2
    and K3 (over int8 K4 and the row quantization's entries) and no K1 or
    K5; each rank's state held by _tensor_state_held. ref: the one-process
    run to hold them to (else the one of `refs` the case names); dropout:
    the training forwards ran the einsum attention (no K3 backward; the
    eval's K3 forward stays)."""
    import numpy as np
    fp16, int8, channel = dtype == "fp16", fq == "int8", mode == "channel"
    if ref is None and channel:
        ref = refs[f"channel {'int8' if int8 else 'scan' if scan else 'layer'} {dtype}"]
    elif ref is None:
        ref = refs[("scan " if scan else "") + {
            (False, False): "none", (True, False): "fp16", (False, True): "int8",
            (True, True): "int8 fp16"}[fp16, int8]]
    rtol = P0_INT8_RTOL if fp16 or int8 else P0_RTOL
    what = (f"{tag} {shape} {mode} {dtype}{' scan' if scan else ''}{' int8' if int8 else ''}"
            f"{' dropout' if dropout else ''}")
    fps = {g["plan"]["fingerprint"] for g in got} | {ref["plan"]["fingerprint"]}
    if len(fps) != 1:
        raise AssertionError(f"{what}: plan fingerprints differ: {fps}")
    if any(g["loss"] != got[0]["loss"] for g in got):
        raise AssertionError(f"{what}: the ranks' losses differ")
    if channel:
        names = TCJ_KERNELS if int8 else TC_KERNELS
    else:
        names = TQ_KERNELS if int8 else TS_DENSE_KERNELS if scan else TRAIN_KERNELS
    names = tuple(n for n in names if "dkdv_reduce" not in n
                  and not (dropout and n.startswith("attn_bwd")))
    needed = _fp16_names(names) if fp16 else names
    off = ("block_grad", "block_correction") if channel else ()
    for r, g in enumerate(got):
        if not all(g["launches"][n] > 0 for n in needed) or g["scan"] != scan \
                or (scan and not g.get("fse_tensors")) \
                or any(g["launches"][n] + g["launches"][f"{n}_fp16"] for n in off):
            raise AssertionError(f"{what} rank {r}: scan {g['scan']}, TSE "
                                 f"{g.get('fse_tensors')}, or not every kernel of the path "
                                 f"launched (or K1 / K5 in channel mode): {g['launches']}")
        _tensor_state_held(f"{what} rank {r}", g, ref, shape[2], int8)
    if fp16 and (got[0]["loss_scale"], got[0]["overflow"]) != (ref["loss_scale"],
                                                                ref["overflow"]):
        raise AssertionError(f"{what}: loss scales or overflow flags differ: "
                             f"{got[0]['loss_scale']} {got[0]['overflow']} vs "
                             f"{ref['loss_scale']} {ref['overflow']}")
    norms, ref_norms = (np.array(x["warmup_grad_norm"] + x["grad_norm"]) for x in (got[0], ref))
    np.testing.assert_allclose(got[0]["loss"] + [got[0]["eval_loss"]],
                               ref["loss"] + [ref["eval_loss"]], rtol=rtol)
    if rtol == P0_RTOL:
        np.testing.assert_allclose(norms, ref_norms, rtol=rtol)
    worst = float(np.max(np.abs(np.array(got[0]["loss"]) - np.array(ref["loss"]))
                         / np.abs(np.array(ref["loss"]))))
    finite = np.isfinite(norms) & np.isfinite(ref_norms)
    worst_norm = float(np.max(np.abs(norms - ref_norms)[finite] / ref_norms[finite]))
    c = got[0]["collectives"]
    extra = ""
    if int8:
        sb = got[0]["state_bytes"]["sparse"]
        extra = (f"; amax MB / calls a step "
                 f"{[(round(x['tensor_amax_bytes'] / 1e6, 3), x['tensor_amax_calls']) for x in c]}"
                 f"; rank 0 q bytes {sb['q_here']:,} of {sb['q_full']:,}")
    log(f"[{tag}] tiny {dtype}{' --channel_sparsity' if channel else ''}"
        f"{' --frozen_quant int8' if int8 else ''}"
        f"{' --scan_layers on' if scan else ''}{' --dropout 0.1' if dropout else ''} at {shape}, "
        f"{len(got)} "
        f"ranks against one process at global batch 4 (rows 2-3 thinned): losses worst rel diff "
        f"{worst:.2e}, grad norms {worst_norm:.2e} (bound {rtol} on "
        f"{'both' if rtol == P0_RTOL else 'the losses; grad norms reported'}); eval "
        f"{got[0]['eval_loss']:.6f} vs {ref['eval_loss']:.6f}; same plan "
        f"{ref['plan']['fingerprint'][:16]}"
        + (f"; loss scales {got[0]['loss_scale']} and overflow flags {got[0]['overflow']} as "
           "one process's" if fp16 else "")
        + f"; tensor MB / calls a step "
        f"{[(round(x['tensor_bytes'] / 1e6, 2), x['tensor_calls']) for x in c]}{extra}"
        + (f"; {'column' if channel else 'block'}-grad parts summed MB / calls a step "
           f"{[(round(x['grad_parts_bytes'] / 1e6, 3), x['grad_parts_calls']) for x in c]}"
           if scan or channel else "")
        + (f"; TSE {got[0].get('fse_tensors')} tensors" if scan else
           f"; TE {got[0].get('te_tensors')} tensors") + "; rank 0 launches "
        f"{ {n: got[0]['launches'][n] for n in needed} }")


def hold_t(tag, shape, backend, t, ref, layers, beside=None, fq="none", model="TinyLlama-1.1B",
           name=None, dropout=False, files=True):
    """A's path (or, fq "int8": E's, TQ) on a tensor mesh against A (or E)
    run in one process (P's bounds: losses within 1e-3, warm-up grad norms
    within 5e-2; the ranks' losses and plans equal; K1, K2 and K3 launched
    on every rank, over the int8 base K4 t and g, the row quantization's
    three entries and K5 too, with one row quantization a K4 call; each
    rank's state held by _tensor_state_held; the export equal to one
    process's export of the gathered state (TE: read back from the files;
    TQE: merged_params, which the export writes)); per rank the ms/step,
    the collectives' bytes and calls a step (over the int8 base the amax
    all-reduces apart), the state's bytes and the peaks beside the runs of
    `beside` ({name: rank 0's summary}) and the reference's. model, name:
    the model's and the reference run's names in the log (name: "E" or
    "A" by default); dropout: the training forwards ran the einsum
    attention (no K3 backward launched); files: the run wrote its export
    (else merged_params is held, as over the int8 base). Returns
    log_selection_margin's numbers for rank 0's plan against the
    reference's."""
    import numpy as np
    int8 = fq == "int8"
    name = name or ("E" if int8 else "A")
    if any(x["loss"] != t[0]["loss"] or x["plan"] != t[0]["plan"] for x in t):
        raise AssertionError(f"{tag}: the ranks' losses or plans differ")
    needed = tuple(n for n in (TQ_KERNELS if int8 else TRAIN_KERNELS)
                   if not (dropout and n.startswith("attn_bwd")))
    for r, x in enumerate(t):
        lx = x["launches"]
        if not all(lx[n] > 0 for n in needed):
            raise AssertionError(f"{tag} rank {r} did not launch every kernel: {lx}")
        if int8:
            _one_row_quant_a_k4_call(f"{tag} rank {r}", lx)
        if not x.get("te_tensors") or not (int8 or not files or x["export_tensors_equal"]):
            raise AssertionError(f"{tag}E rank {r}: the export was not checked")
        _tensor_state_held(f"{tag} rank {r}", x, ref, shape[2], int8)
    r_loss = ref["loss"] + [ref["eval_loss"]]
    t_loss = t[0]["loss"] + [t[0]["eval_loss"]]
    rel = np.abs(np.array(t_loss) - np.array(r_loss)) / np.abs(np.array(r_loss))
    r_norm, t_norm = np.array(ref["warmup_grad_norm"]), np.array(t[0]["warmup_grad_norm"])
    rel_norm = np.abs(t_norm - r_norm) / r_norm
    gib = 1024 ** 3
    log(f"[{tag}] {model} bf16{' --frozen_quant int8 (int8 base and head)' if int8 else ''}"
        f"{' --dropout 0.1' if dropout else ''}, {layers} layers, tensor {shape} over {len(t)} "
        f"{backend} ranks x bs "
        f"{4 // (shape[0] * shape[1])} x seq 512 ({name}'s global batch), 3 warm-up + 4 sparse "
        f"steps: losses {t_loss} vs {name}'s {r_loss}, worst rel diff {float(rel.max()):.2e} "
        f"(bound {P_VS_A_RTOL}); warm-up grad norms {t_norm.tolist()} vs {name}'s "
        f"{r_norm.tolist()}, worst rel diff {float(rel_norm.max()):.2e} (bound {P_GNORM_RTOL}); "
        f"sparse grad norms {t[0]['grad_norm']} vs {name}'s {ref['grad_norm']}; plan "
        f"{t[0]['plan']['fingerprint'][:16]} on every rank, {name}'s "
        f"{ref['plan']['fingerprint'][:16]} ({CARD['smi']})")
    margin = log_selection_margin(ref, t[0], tag=tag, ref=name)
    n_warm = 3
    peaks = {name: ref["peak"], **{k: v["peak"] for k, v in (beside or {}).items()}}
    for r, x in enumerate(t):
        ms, c, sb = x["step_ms"], x["collectives"], x["state_bytes"]
        amax = (f"; amax MB / calls a step "
                f"{[(round(v['tensor_amax_bytes'] / 1e6, 3), v['tensor_amax_calls']) for v in c]}"
                if int8 else "")
        log(f"[{tag}] rank {r}: warm-up ms/step {[round(v, 1) for v in ms[:n_warm]]}, sparse "
            f"{[round(v, 1) for v in ms[n_warm:]]} ({name}: "
            f"{[round(v, 1) for v in ref['step_ms']]}"
            + "".join(f"; {k}: {[round(v, 1) for v in s['step_ms']]}"
                      for k, s in (beside or {}).items())
            + f"); collective ms/step {[round(v, 1) for v in x['reduce_ms']]}; tensor all-reduced "
            f"and gathered MB / calls a step "
            f"{[(round(v['tensor_bytes'] / 1e6, 1), v['tensor_calls']) for v in c]}{amax}; fsdp "
            f"gathered MB / calls {[(round(v['gather_bytes'] / 1e6, 1), v['gather_calls']) for v in c]}"
            f"; reduce-scattered MB / calls "
            f"{[(round(v['scatter_bytes'] / 1e6, 1), v['scatter_calls']) for v in c]}; grads "
            f"all-reduced MB / calls {[(round(v['bytes'] / 1e6, 1), v['calls']) for v in c]}")
        q = (f"; int8 base and head bytes here {sb['sparse']['q_here']:,} of "
             f"{sb['sparse']['q_full']:,} ({name} holds {ref['state_bytes']['sparse']['q_full']:,})"
             if int8 else "")
        log(f"[{tag}] rank {r}: state bytes here / full: warm-up "
            f"{sb['build']['here'] / gib:.3f} / {sb['build']['full'] / gib:.3f} GiB "
            f"(tensor-split leaves {sb['build']['tsplit_here']:,} / "
            f"{sb['build']['tsplit_full']:,} B), sparse {sb['sparse']['here'] / gib:.3f} / "
            f"{sb['sparse']['full'] / gib:.3f} GiB (tensor-split "
            f"{sb['sparse']['tsplit_here']:,} / {sb['sparse']['tsplit_full']:,} B){q}; peak GiB "
            f"{ {k: round(v / gib, 2) for k, v in x['peak'].items() if v is not None} } beside "
            + "; ".join(f"{who}'s { {k: round(v / gib, 2) for k, v in pk.items() if v is not None} }"
                        for who, pk in peaks.items())
            + "; launches " + ", ".join(f"{n} {x['launches'][n]}" for n in (
                ("q8mm_t", "q8mm_g", "row_quant") + RQ_SPLIT_KERNELS + ("block_correction",)
                if int8 else ()) + ("block_grad", "masked_adam", "attn_fwd", "attn_bwd_dkdv"))
            + f"; {x['seconds']:.1f} s")
    if int8 or not files:
        log(f"[{tag}E] the export's {t[0]['te_tensors']} tensors (merged_params, gathered over "
            "both axes) equal one process's export (the weights gathered at conversion, the "
            "final trainables gathered and scattered in by the plan's one-process scatter) bit "
            "for bit on every rank")
    else:
        log(f"[{tag}E] rank 0's export ({t[0]['export_tensors_equal']} tensors) read back on "
            f"each rank equals the gathered state, and its {t[0]['te_tensors']} tensors equal one "
            "process's export (the weights gathered at conversion, the final trainables gathered "
            "and scattered in by the plan's one-process scatter) bit for bit")
    if rel.max() > P_VS_A_RTOL:
        raise AssertionError(f"{tag}: losses part from {name}'s by {float(rel.max()):.2e} > "
                             f"{P_VS_A_RTOL}")
    if len(t_norm) != len(r_norm) or rel_norm.max() > P_GNORM_RTOL:
        raise AssertionError(f"{tag}: warm-up grad norms {t_norm.tolist()} part from {name}'s "
                             f"{r_norm.tolist()} by more than {P_GNORM_RTOL}")
    return margin


def tensor_refs(refs=None):
    """The one-process tiny references of T0, TQ0, TS0 (fp32 and fp16,
    over the dense and the int8 base, per layer and, keys "scan ...",
    --scan_layers on) and TC0 (keys "channel {TC0_CASES}"), those not in
    `refs` run here."""
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    tiny = LlamaConfig.tiny(vocab_size=512)
    refs = dict(refs or {})
    for scan in ("", "scan "):
        for key, fq, dtype in (("none", "none", "fp32"), ("fp16", "none", "fp16"),
                               ("int8", "int8", "fp32"), ("int8 fp16", "int8", "fp16")):
            if scan + key not in refs:
                refs[scan + key] = run_main_path(
                    tiny, "cuda", bs=4, frozen_quant=fq, **{**P0_KW, "dtype": dtype},
                    **({"cfg_extra": {"scan_layers": "on"}} if scan else {}))
    for case in TC0_CASES:
        if f"channel {case}" not in refs:
            refs[f"channel {case}"] = tc0_run(case, "cuda", 4)
    return refs


def tc0_run(case, device, bs, mesh=None):
    """TC0 case `case` ("{layout} {dtype}", TC0_CASES): the tiny pair in
    channel mode per layer or with --scan_layers on over the fp32 or the
    int8 base, P0's settings, in one process or as a rank of `mesh` (bs a
    rank)."""
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    layout, dtype = case.split()
    return run_main_path(LlamaConfig.tiny(vocab_size=512), device, bs=bs, mode="channel",
                         frozen_quant="int8" if layout == "int8" else "none",
                         cfg_extra=None if layout == "layer" else {"scan_layers": "on"},
                         **({"mesh": mesh} if mesh is not None else {}),
                         **{**P0_KW, "dtype": dtype})


def hold_tc0(shape, got, refs, tag="TC0"):
    """TC0: every TC0_CASES pair in channel mode on a tensor mesh against
    one process (hold_t0 in channel mode)."""
    for case in TC0_CASES:
        layout, dtype = case.split()
        hold_t0(shape, dtype, [r[f"TC0:{case}"] for r in got], refs, tag=tag,
                fq="int8" if layout == "int8" else "none", scan=layout != "layer",
                mode="channel")


def hold_ts0(shape, got, refs, tag="TS0"):
    """TS0: every TS0_CASES pair on a tensor mesh, over the scan state,
    against one process (hold_t0 with scan)."""
    for case in TS0_CASES:
        fq, dt = case.split()
        hold_t0(shape, dt, [r[f"TS0:{case}"] for r in got], refs, tag=tag, fq=fq, scan=True)


def hold_ts(tag, shape, backend, ts, ref, layers, beside=None):
    """TS: E's path with --scan_layers on over the int8 scan state on a
    tensor mesh, against E run in one process (P's bounds: losses within
    1e-3, warm-up grad norms within 5e-2; the ranks' losses and plans
    equal); on every rank the scan state with its host store, K1, K2, K3,
    K4 t and g, the row quantization's three entries and K5 launched, one
    row quantization a K4 call, 1/T of every tensor-split stack and q leaf
    and 1/(F T) of the host store, the padded stacks whole over tensor
    (1/F over fsdp), the block grads summed over the tensor group at the
    valid entries only (at most the plan's blocks' bytes a sparse step),
    and TSE: the export (merged_params, gathered layer by layer over both
    axes, not written) equal to one process's export of the gathered
    state and host store. Logs per rank the ms/step, the tensor
    collectives' MB and calls a step (activations, amax and block grads
    apart), the state's bytes against the whole state's, and the peaks
    beside E's and the runs of `beside` ({name: summary}: rank 0's TQ;
    G's fit peak), then raises for what failed."""
    import numpy as np
    gib = 1024 ** 3
    _, f, t = shape
    valid_bytes = ts[0]["plan"]["blocks"] * 256 * 256 * 4
    n_warm = 3
    failed = []
    if any(x["loss"] != ts[0]["loss"] or x["plan"] != ts[0]["plan"] for x in ts):
        failed.append("the ranks' losses or plans differ")
    for r, x in enumerate(ts):
        lx, sb = x["launches"], x["state_bytes"]["sparse"]
        bad = [n for n in TQ_KERNELS if lx[n] <= 0]
        if not x["scan"] or not x["offloaded"] or bad:
            failed.append(f"rank {r}: scan {x['scan']}, host store {x['offloaded']}, not "
                          f"launched: {bad}")
        try:
            _one_row_quant_a_k4_call(f"{tag} rank {r}", lx)
        except AssertionError as e:
            failed.append(str(e))
        if not x.get("fse_tensors"):
            failed.append(f"rank {r}: the export was not checked ({tag}E)")
        if not sb["tsplit_here"] or sb["tslice"] * t != sb["tsplit_full"] \
                or not sb["host_here"] or sb["host_here"] * f * t != sb["host_full"] \
                or not sb["pad_here"] or sb["pad_here"] * f != sb["pad_full"]:
            failed.append(f"rank {r}: not 1/{t} of the tensor-split leaves, 1/{f * t} of the "
                          f"host store and 1/{f} of the padded stacks: {sb}")
        parts = [c["grad_parts_bytes"] for c in x["collectives"][n_warm:]]
        if not all(0 < b <= valid_bytes for b in parts):
            failed.append(f"rank {r}: block-grad sums of {parts} B a sparse step, not within "
                          f"the valid entries' {valid_bytes:,} B")
    r_loss = ref["loss"] + [ref["eval_loss"]]
    t_loss = ts[0]["loss"] + [ts[0]["eval_loss"]]
    rel = np.abs(np.array(t_loss) - np.array(r_loss)) / np.abs(np.array(r_loss))
    r_norm, t_norm = np.array(ref["warmup_grad_norm"]), np.array(ts[0]["warmup_grad_norm"])
    rel_norm = np.abs(t_norm - r_norm) / r_norm
    log(f"[{tag}] TinyLlama-1.1B bf16 --scan_layers on --frozen_quant int8 (the int8 scan "
        f"state, host store, int8 head), {layers} layers, tensor {shape} over {len(ts)} "
        f"{backend} ranks x bs {4 // (f * shape[0])} x seq 512 (E's global batch), 3 warm-up + "
        f"4 sparse steps: losses {t_loss} vs E's {r_loss}, worst rel diff "
        f"{float(rel.max()):.2e} (bound {P_VS_A_RTOL}); warm-up grad norms worst rel diff "
        f"{float(rel_norm.max()):.2e} (bound {P_GNORM_RTOL}); sparse grad norms "
        f"{ts[0]['grad_norm']} vs E's {ref['grad_norm']}; plan "
        f"{ts[0]['plan']['fingerprint'][:16]} on every rank, E's "
        f"{ref['plan']['fingerprint'][:16]}, {ts[0]['plan']['blocks']} blocks "
        f"({valid_bytes:,} B of block grads) ({CARD['smi']})")
    peaks = {"E": ref["peak"], **{k: v["peak"] for k, v in (beside or {}).items()
                                  if "peak" in v}}
    for r, x in enumerate(ts):
        ms, c, sb = x["step_ms"], x["collectives"], x["state_bytes"]["sparse"]

        def per_step(key):
            pre = f"{key}_" if key else ""
            return [(round(v[f"{pre}bytes"] / 1e6, 3), v[f"{pre}calls"]) for v in c]
        log(f"[{tag}] rank {r}: warm-up ms/step {[round(v, 1) for v in ms[:n_warm]]}, sparse "
            f"{[round(v, 1) for v in ms[n_warm:]]} (E: {[round(v, 1) for v in ref['step_ms']]}"
            + "".join(f"; {k}: {[round(v, 1) for v in s['step_ms']]}"
                      for k, s in (beside or {}).items() if "step_ms" in s)
            + f"); collective ms/step {[round(v, 1) for v in x['reduce_ms']]}; tensor MB / calls "
            f"a step: activations {per_step('tensor')}, amax {per_step('tensor_amax')}, block "
            f"grads {per_step('grad_parts')}; all-reduced in all {per_step('')}; fsdp gathered "
            f"{per_step('gather')}, reduce-scattered {per_step('scatter')}")
        log(f"[{tag}] rank {r}: bytes here / whole: stacked int8 base (q) "
            f"{sb['q_here'] - sb['qhead_here']:,} / {sb['q_full'] - sb['qhead_full']:,}, int8 "
            f"head {sb['qhead_here']:,} / {sb['qhead_full']:,}, host store {sb['host_here']:,} / "
            f"{sb['host_full']:,}, padded stacks (trainable, base, m, v) {sb['pad_here']:,} / "
            f"{sb['pad_full']:,}, tensor-split leaves {sb['tsplit_here']:,} / "
            f"{sb['tsplit_full']:,}, state {sb['here'] / gib:.3f} / {sb['full'] / gib:.3f} GiB; "
            f"peak GiB { {k: round(v / gib, 2) for k, v in x['peak'].items() if v is not None} } "
            "beside " + "; ".join(
                f"{who}'s { {k: round(v / gib, 2) for k, v in pk.items() if v is not None} }"
                for who, pk in peaks.items())
            + "".join(f"; {k}'s fit peak {v['peak_gib']:.2f}" for k, v in (beside or {}).items()
                      if "peak_gib" in v)
            + "; launches " + ", ".join(f"{n} {x['launches'][n]}" for n in (
                ("q8mm_t", "q8mm_g", "row_quant") + RQ_SPLIT_KERNELS
                + ("block_correction", "block_grad", "masked_adam", "attn_fwd", "attn_bwd_dkdv")))
            + f"; {x['seconds']:.1f} s")
    if rel.max() > P_VS_A_RTOL:
        failed.append(f"losses part from E's by {float(rel.max()):.2e} > {P_VS_A_RTOL}")
    if len(t_norm) != len(r_norm) or rel_norm.max() > P_GNORM_RTOL:
        failed.append(f"warm-up grad norms {t_norm.tolist()} part from E's {r_norm.tolist()} by "
                      f"more than {P_GNORM_RTOL}")
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    log(f"[{tag}E] the export's {ts[0]['fse_tensors']} tensors (merged_params_from_scan, each "
        "layer gathered over both axes, the host store's slices among them) equal one "
        "process's export of the gathered state and host store bit for bit on every rank")


def _gib(peaks):
    """{phase: peak GiB} of a run's peaks in bytes (None where not measured)."""
    return {k: round(v / 1024 ** 3, 2) for k, v in peaks.items() if v is not None}


def hold_tc(tag, shape, backend, tc, ref, ref_tag, layers, beside=None):
    """TC (H's path: channel mode per layer over the dense base) or TCJ
    (J's: channel + int8 at depth, converted into the int8 scan state with
    its host store) on a tensor mesh against H or J run in one process
    (P's bound on the losses, 1e-3; the channel warm-up trains nothing, so
    it has no grad norms; the ranks' losses and plans equal): on every rank
    the reference's layout, K2 and K3 launched (TCJ: K4 t and g and the
    row quantization's three entries too, one a K4 call) and no K1 or K5;
    act_acc's (S, C) sums at 1/T a rank and the reference's bytes in all;
    1/T of every tensor-split leaf (TCJ: 1/(F T) of the host store); the
    columns whole over tensor, their grads summed whole over the tensor
    group (at most the columns' bytes a sparse step); TCE: the export
    (merged_params, not written) equal to one process's export of the
    gathered state (per layer: the weights gathered at conversion with the
    final columns scattered in; TCJ: the whole scan state and host store).
    Logs per rank the ms/step, the tensor MB and calls a step (activations,
    amax, taps and column grads apart), the act_acc, stacked, host store and
    column bytes beside the reference's, the peaks beside the reference's
    and `beside`'s ({name: summary}), the launches, and how many of the
    reference's channels the plan selected too (a near-tie of bf16
    activation sums may part them); then raises for what failed."""
    import numpy as np
    gib = 1024 ** 3
    _, f, t = shape
    scan = ref["scan"]   # J trains over the int8 scan state, H per layer
    names = TCJ_KERNELS if scan else TC_KERNELS
    n_warm = 3
    failed = []
    if any(x["loss"] != tc[0]["loss"] or x["plan"] != tc[0]["plan"] for x in tc):
        failed.append("the ranks' losses or plans differ")
    for r, x in enumerate(tc):
        lx, sb, wb = x["launches"], x["state_bytes"]["sparse"], x["state_bytes"]["build"]
        bad = [n for n in names if lx[n] <= 0] + [n for n in ("block_grad", "block_correction")
                                                  if lx[n]]
        if x["scan"] != scan or (scan and not x["offloaded"]) or bad:
            failed.append(f"rank {r}: scan {x['scan']}, host store {x['offloaded']}, launched "
                          f"wrongly: {bad}")
        if scan:
            try:
                _one_row_quant_a_k4_call(f"{tag} rank {r}", lx)
            except AssertionError as e:
                failed.append(str(e))
        if not x.get("fse_tensors" if scan else "te_tensors"):
            failed.append(f"rank {r}: the export was not checked ({tag}E)")
        want_act = ref["state_bytes"]["build"]["act_full"]
        if not wb["act_here"] or wb["act_here"] * t != wb["act_full"] or wb["act_full"] != want_act:
            failed.append(f"rank {r}: act_acc {wb['act_here']:,} of {wb['act_full']:,} B, not "
                          f"1/{t} of the reference's {want_act:,}")
        if not sb["tsplit_here"] or sb["tslice"] * t != sb["tsplit_full"] \
                or (scan and (not sb["host_here"] or sb["host_here"] * f * t != sb["host_full"])) \
                or sb["train_here"] * f != sb["train_full"]:
            failed.append(f"rank {r}: not 1/{t} of the tensor-split leaves, 1/{f * t} of the "
                          f"host store, or the columns not whole over tensor: {sb}")
        parts = [c["grad_parts_bytes"] for c in x["collectives"][n_warm:]]
        if not all(0 < b <= sb["train_full"] for b in parts):
            failed.append(f"rank {r}: column-grad sums of {parts} B a sparse step, not within "
                          f"the columns' {sb['train_full']:,} B")
    r_loss = ref["loss"] + [ref["eval_loss"]]
    t_loss = tc[0]["loss"] + [tc[0]["eval_loss"]]
    rel = np.abs(np.array(t_loss) - np.array(r_loss)) / np.abs(np.array(r_loss))
    mine, theirs = set(map(tuple, tc[0]["channels"])), set(map(tuple, ref["channels"]))
    log(f"[{tag}] TinyLlama-1.1B bf16 --channel_sparsity (30 + 30 channels)"
        + (" --frozen_quant int8 (the int8 scan state, host store, int8 head)" if scan else "")
        + f", {layers} layers, tensor {shape} over {len(tc)} {backend} ranks x bs "
        f"{4 // (f * shape[0])} x seq 512 ({ref_tag}'s global batch), 3 warm-up + 4 sparse "
        f"steps: losses {t_loss} vs {ref_tag}'s {r_loss}, worst rel diff {float(rel.max()):.2e} "
        f"(bound {P_VS_A_RTOL}); sparse grad norms {tc[0]['grad_norm']} vs {ref_tag}'s "
        f"{ref['grad_norm']}; plan {tc[0]['plan']['fingerprint'][:16]} on every rank, "
        f"{ref_tag}'s {ref['plan']['fingerprint'][:16]}: {len(mine & theirs)} of "
        f"{len(theirs)} channels in both ({CARD['smi']})")
    peaks = {ref_tag: ref["peak"], **{k: v["peak"] for k, v in (beside or {}).items()}}
    rb = ref["state_bytes"]
    for r, x in enumerate(tc):
        ms, c = x["step_ms"], x["collectives"]
        sb, wb = x["state_bytes"]["sparse"], x["state_bytes"]["build"]

        def per_step(key):
            pre = f"{key}_" if key else ""
            return [(round(v[f"{pre}bytes"] / 1e6, 3), v[f"{pre}calls"]) for v in c]
        log(f"[{tag}] rank {r}: warm-up ms/step {[round(v, 1) for v in ms[:n_warm]]}, sparse "
            f"{[round(v, 1) for v in ms[n_warm:]]} ({ref_tag}: "
            f"{[round(v, 1) for v in ref['step_ms']]}"
            + "".join(f"; {k}: {[round(v, 1) for v in s['step_ms']]}"
                      for k, s in (beside or {}).items())
            + f"); collective ms/step {[round(v, 1) for v in x['reduce_ms']]}; tensor MB / calls "
            f"a step: activations {per_step('tensor')}, amax {per_step('tensor_amax')}, taps "
            f"{per_step('taps')}, column grads {per_step('grad_parts')}; all-reduced in all "
            f"{per_step('')}; fsdp gathered {per_step('gather')}, reduce-scattered "
            f"{per_step('scatter')}")
        log(f"[{tag}] rank {r}: bytes here / whole ({ref_tag} holds): act_acc "
            f"{wb['act_here']:,} / {wb['act_full']:,} ({rb['build']['act_full']:,}), columns "
            f"(trainable) {sb['train_here']:,} / {sb['train_full']:,} "
            f"({rb['sparse']['train_full']:,}), stacked int8 base (q) "
            f"{sb['q_here'] - sb['qhead_here']:,} / {sb['q_full'] - sb['qhead_full']:,}, int8 "
            f"head {sb['qhead_here']:,} / {sb['qhead_full']:,}, host store {sb['host_here']:,} / "
            f"{sb['host_full']:,} ({rb['sparse']['host_full']:,}), tensor-split leaves "
            f"{sb['tsplit_here']:,} / {sb['tsplit_full']:,}, state {sb['here'] / gib:.3f} / "
            f"{sb['full'] / gib:.3f} GiB ({rb['sparse']['here'] / gib:.3f}); peak GiB "
            f"{_gib(x['peak'])} beside "
            + "; ".join(f"{who}'s {_gib(pk)}" for who, pk in peaks.items())
            + "; launches " + ", ".join(f"{n} {x['launches'][n]}" for n in (
                ("q8mm_t", "q8mm_g", "row_quant") + RQ_SPLIT_KERNELS
                + ("block_grad", "block_correction", "masked_adam", "attn_fwd", "attn_bwd_dkdv")))
            + f"; {x['seconds']:.1f} s")
    if rel.max() > P_VS_A_RTOL:
        failed.append(f"losses part from {ref_tag}'s by {float(rel.max()):.2e} > {P_VS_A_RTOL}")
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    log(f"[{tag}E] the export's {tc[0]['fse_tensors' if scan else 'te_tensors']} tensors "
        "(merged_params, gathered over both axes) equal one process's export of the gathered "
        "state bit for bit on every rank")


def tensor_tiny_jobs():
    """The tiny pairs of the tensor axis: T0, TQ0, TS0 and TC0."""
    return [("T0", d) for d in T0_DTYPES] + [("TQ0", d) for d in T0_DTYPES] + \
        [("TS0", c) for c in TS0_CASES] + [("TC0", c) for c in TC0_CASES]


def hold_tensor_tiny(shape, got, refs, n=""):
    """T0, TQ0, TS0 and TC0 of a spawn at `shape` against one process (the
    tags with `n`: "N" over NCCL)."""
    for d in T0_DTYPES:
        hold_t0(shape, d, [r[f"T0:{d}"] for r in got], refs, tag=f"T{n}0")
        hold_t0(shape, d, [r[f"TQ0:{d}"] for r in got], refs, tag=f"TQ{n}0", fq="int8")
    hold_ts0(shape, got, refs, tag=f"TS{n}0")
    hold_tc0(shape, got, refs, tag=f"TC{n}0")


# ---------------------------------------------------------------------------
# Qwen2.5-1.5B: q/k/v biases and a tied head, in one process and under the
# tensor axis
# ---------------------------------------------------------------------------

# QT0: the tiny tied, biased pair (write_qwen at LlamaConfig.tiny's widths)
# on a tensor mesh, "{mode} {layout} {base} {dtype}[ dropout]": every value
# of each dimension (fp32, fp16 and int8; per layer and scan; matrix and
# channel; with and without --dropout) in at least one case
QT0_CASES = ("matrix layer dense fp32", "matrix layer dense fp32 dropout",
             "matrix layer dense fp16", "matrix layer int8 fp32",
             "matrix scan dense fp32 dropout", "matrix scan int8 fp32",
             "channel layer dense fp32 dropout", "channel scan int8 fp32")


# QH0 / QH: a tensor axis that cuts the attention heads, at (1, 1, 4): QH0
# the tiny fp32 pairs of tests/test_torch_tensor_cut_heads.py, kv_cut
# (LlamaConfig.tiny: 4 q / 2 kv heads of 64, half a kv head a rank) and
# q_cut (hidden 768, 6 q / 2 kv heads of 128: 1.5 q heads and half a kv
# head a rank); QH Q's path (12 q / 2 kv heads of 128: half a kv head a rank)
QH_SHAPE = (1, 1, 4)
QH0_MODELS = {"kv_cut": {}, "q_cut": dict(hidden_size=768, intermediate_size=1024,
                                          num_attention_heads=6, num_key_value_heads=2)}


def qwen_cfg(layers):
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(**{**QWEN, "num_hidden_layers": layers})


def qh0_cfg(name):
    import dataclasses
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=512), **QH0_MODELS[name])


def tiny_qwen_cfg():
    import dataclasses
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=512), tie_word_embeddings=True)


def write_qwen(model_cfg, path):
    """A local qwen2 checkpoint of `model_cfg` (a tied head) at `path`:
    init_params' seed-0 weights in bf16 with seeded N(0, QWEN_BIAS_STD)
    q/k/v biases, model.safetensors written by models/hf_io.save_hf_format
    and config.json with model_type qwen2, read back by load_hf_config as
    `model_cfg`. Returns the seconds it took."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_config, save_hf_format
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params
    t0 = time.time()
    params = init_params(model_cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(7)
    kv = model_cfg.num_key_value_heads * model_cfg.head_dim
    for layer in params["layers"].values():
        for m, n in (("q_proj", model_cfg.hidden_size), ("k_proj", kv), ("v_proj", kv)):
            b = rng.standard_normal(n, dtype=np.float32) * np.float32(QWEN_BIAS_STD)
            layer[f"{m}_bias"] = torch.from_numpy(b).to(torch.bfloat16)
    save_hf_format(params, model_cfg, path)
    hf = {**model_cfg.to_hf(), "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"]}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    if load_hf_config(path) != model_cfg:
        raise AssertionError(f"{path}: the qwen2 config does not read back as {model_cfg}")
    return time.time() - t0


def qt0_run(case, device, bs, hf_dir, mesh=None):
    """QT0 case `case` (QT0_CASES) through run_main_path from the tiny
    qwen2 checkpoint at hf_dir, P0's settings, in one process or as a rank
    of `mesh` (bs a rank)."""
    mode, layout, base, dtype = case.split()[:4]
    extra = {"scan_layers": "on"} if layout == "scan" else {}
    if case.endswith("dropout"):
        extra["dropout"] = 0.1
    return run_main_path(tiny_qwen_cfg(), device, bs=bs, mode=mode,
                         frozen_quant="int8" if base == "int8" else "none",
                         cfg_extra=extra or None, hf_dir=hf_dir,
                         **({"mesh": mesh} if mesh is not None else {}),
                         **{**P0_KW, "dtype": dtype})


def hold_qt0(shape, got, refs, tag="QT0"):
    """QT0: every QT0_CASES pair on a tensor mesh against one process
    (hold_t0 with the case's reference), and each rank's tied, biased
    layout (qwen_layout)."""
    for case in QT0_CASES:
        mode, layout, base, dtype = case.split()[:4]
        ranks = [r[f"QT0:{case}"] for r in got]
        hold_t0(shape, dtype, ranks, None, tag=tag, fq="int8" if base == "int8" else "none",
                scan=layout == "scan", mode=mode, ref=refs[case],
                dropout=case.endswith("dropout"))
        qwen_layout(f"{tag} {shape} {case}", shape, ranks, tiny_qwen_cfg())


def qwen_layout(what, shape, ranks, model_cfg):
    """Each rank's warm-up state holds the embedding's V/F rows of its D/T
    hidden columns (exactly 1/(F T) of its bytes), every q/k/v bias whole
    and no lm_head leaf. Returns rank 0's embedding bytes and the whole's."""
    f, t = shape[1], shape[2]
    v, d = model_cfg.vocab_size, model_cfg.hidden_size
    kv = model_cfg.num_key_value_heads * model_cfg.head_dim
    for r, x in enumerate(ranks):
        leaves = x["leaf_bytes"]
        biases = {k: s for k, (s, _) in leaves.items() if k.endswith("_bias")}
        want = {f"layers/{li}/{m}_bias": (n,) for li in range(model_cfg.num_hidden_layers)
                for m, n in (("q_proj", d), ("k_proj", kv), ("v_proj", kv))}
        if "lm_head" in leaves or leaves["embed_tokens"][0] != (v // f, d // t) \
                or biases != want:
            raise AssertionError(f"{what} rank {r}: the embedding is not its (V/F, D/T) block, "
                                 f"a bias is not whole, or there is an lm_head: "
                                 f"{ {k: s for k, (s, _) in leaves.items() if 'bias' not in k} }, "
                                 f"biases {biases == want}")
    return ranks[0]["leaf_bytes"]["embed_tokens"][1], v * d * 4


def qwen_windows(x, model_cfg, t=2):
    """Of a run's selected blocks, those that straddle a tensor shard's
    edge at tensor t: gate/up on their output rows, down on its input
    columns (intermediate / t), k/v on their rows (kv rows / t), q on its
    rows and o on its columns (hidden / t): {module: (shard edge, blocks
    straddling it, blocks selected)}."""
    edges = {"gate_proj": (model_cfg.intermediate_size // t, 1),
             "up_proj": (model_cfg.intermediate_size // t, 1),
             "down_proj": (model_cfg.intermediate_size // t, 2),
             "k_proj": (model_cfg.num_key_value_heads * model_cfg.head_dim // t, 1),
             "v_proj": (model_cfg.num_key_value_heads * model_cfg.head_dim // t, 1),
             "q_proj": (model_cfg.hidden_size // t, 1)}
    out = {}
    for mod, (edge, which) in edges.items():
        blocks = [sel for sel in x["selected"] if sel[0].split(".", 1)[1] == mod]
        cut = [sel for sel in blocks if sel[which] * 256 < edge < (sel[which] + 1) * 256]
        out[mod] = (edge, len(cut), len(blocks))
    return out


def hold_qt(tag, shape, backend, qt, q, layers, dropout=False, files=True, beside=None):
    """QT (or, dropout: QTD): Q's path on a tensor mesh against Q run in
    one process, by hold_t (P's bounds: losses within 1e-3, warm-up grad
    norms within 5e-2; the ranks' losses and plans equal; K1, K2 and K3 (on
    each rank's hq 6 / hkv 1 heads; under dropout no K3 backward) launched
    on every rank; the export against one process's export of the
    gathered state, QTE), Q's plan (a block swapped only on a near-tie of
    bf16 arithmetic: its distance to Q's last selected block of its group,
    relative to its own score in Q, within the spread of the ranks' scores
    over Q's selected blocks, each relative to its own score in Q:
    log_selection_margin's numbers), each rank's tied, biased
    layout (qwen_layout), the export's tensors Q's (names, shapes and
    dtypes: no lm_head, the biases), and per rank the tied head's gathered
    bytes and calls a step and the selected blocks that straddle the ranks'
    shards. files False: the run wrote no export (merged_params is held);
    beside: {name: rank 0's summary} whose ms/step and peaks are logged
    beside each rank's."""
    model_cfg = qwen_cfg(layers)
    margin = hold_t(tag, shape, backend, qt, q, layers, beside, model="Qwen2.5-1.5B",
                    name="QD" if dropout else "Q", dropout=dropout, files=files and not dropout)
    if margin is not None:
        spread, gaps = margin
        far = {k: g for k, g in gaps.items() if g > spread}
        if far:
            raise AssertionError(f"{tag}: blocks {far} leave the one-process plan by more than "
                                 f"the scores' spread {spread:.2e}: not a near-tie")
    here, whole = qwen_layout(tag, shape, qt, model_cfg)
    for r, x in enumerate(qt):
        if x["export_shapes"] != q["export_shapes"] or "lm_head" in x["export_shapes"]:
            raise AssertionError(f"{tag}E rank {r}: the export's tensors are not Q's")
        c = x["collectives"]
        log(f"[{tag}] rank {r}: tied head gathered MB / calls a step "
            f"{[(round(v['tied_bytes'] / 1e6, 1), v['tied_calls']) for v in c]} (each a "
            f"{model_cfg.vocab_size} x {model_cfg.hidden_size} gather over the tensor group); "
            f"grad parts summed over the tensor group (the warm-up's: the q/k/v bias grads), "
            f"MB / calls a step "
            f"{[(round(v['grad_parts_bytes'] / 1e6, 4), v['grad_parts_calls']) for v in c]}")
    log(f"[{tag}] layout: each rank's fp32 master embedding {here:,} B of {whole:,} "
        f"(its {model_cfg.hidden_size // shape[2]} hidden columns), the "
        f"{3 * layers} q/k/v biases whole, no lm_head; the export's "
        f"{len(q['export_shapes'])} tensors (no lm_head) have Q's names, shapes and dtypes")
    log(f"[{tag}] selected blocks straddling the tensor shards (module: shard edge, "
        f"straddling, selected): {qwen_windows(qt[0], model_cfg, shape[2])}")


def hold_qh0(got, refs, tag="QH0"):
    """QH0: the tiny fp32 pairs whose heads T = 4 cuts (QH0_MODELS) at
    QH_SHAPE against one process at P0's bounds (hold_t0: the same plan,
    K1, K2 and K3 launched on every rank, 1/T of every tensor-split leaf),
    K3 on each rank's whole kv groups; the heads' gathers logged apart."""
    for name in QH0_MODELS:
        ranks = [r[f"QH0:{name}"] for r in got]
        hold_t0(QH_SHAPE, "fp32", ranks, None, tag=f"{tag} {name}", ref=refs[f"QH0:{name}"])
        _heads_held(f"{tag} {name}", ranks, qh0_cfg(name))


def _heads_held(tag, ranks, model_cfg):
    """Every training step of every rank gathered q/k/v over the tensor
    group ("heads_*": a gather and, in a training step, the grads' sum for
    each layer); logs each rank's kv groups, K3's q / kv heads on them and
    the heads' MB / calls a step beside all tensor collectives'."""
    hd = model_cfg.head_dim
    for r, x in enumerate(ranks):
        c, cut = x["collectives"], x["cut_heads"]
        if any(v["heads_calls"] < 2 * model_cfg.num_hidden_layers for v in c):
            raise AssertionError(f"{tag} rank {r}: a step gathered q/k/v fewer than twice a "
                                 f"layer: {[v['heads_calls'] for v in c]}")
        log(f"[{tag}] rank {r}: kv heads {cut['first']}..{cut['first'] + cut['kv'] - 1} of "
            f"{model_cfg.num_key_value_heads} with their {cut['hq']} q heads (K3 at hq "
            f"{cut['hq']} hkv {cut['kv']} hd {hd}), its o_proj columns from {cut['col']} of "
            f"their {cut['hq'] * hd}; q/k/v gathered and their grads summed MB / calls a step "
            f"{[(round(v['heads_bytes'] / 1e6, 2), v['heads_calls']) for v in c]} of the tensor "
            f"collectives' {[(round(v['tensor_bytes'] / 1e6, 2), v['tensor_calls']) for v in c]};"
            f" K3 launches fwd {x['launches']['attn_fwd']}, dK/dV "
            f"{x['launches']['attn_bwd_dkdv']}")


def hold_qh(tag, qh, q, layers, backend="gloo", beside=None):
    """QH (QHN over NCCL): Q's path at QH_SHAPE, where T = 4 cuts Qwen2.5-
    1.5B's 2 kv heads (k/v's 256 rows, 64 a rank), held to Q as QT is
    (hold_qt: P's bounds, Q's plan up to near-ties, each rank's tied,
    biased layout; the export held through merged_params, not written),
    with the heads' gathers apart (_heads_held) and each rank's state
    bytes and peaks beside `beside`'s (QT rank 0)."""
    _heads_held(tag, qh, qwen_cfg(layers))
    hold_qt(tag, QH_SHAPE, backend, qh, q, layers, files=False, beside=beside)


def qh_jobs(q):
    """QH0's tiny pairs and QH, Q's path at QH_SHAPE (a spawn of four)."""
    return [("QH0", n) for n in QH0_MODELS] + [("QH", (q["layers"], q["dir"]))]


def qh0_refs():
    """QH0's one-process references, "QH0:{name}"."""
    return {f"QH0:{n}": run_main_path(qh0_cfg(n), "cuda", bs=4, **P0_KW) for n in QH0_MODELS}


def prepare_qwen(layers, dropout=False):
    """Q (and, dropout: QD, Q under --dropout 0.1) in this process from a
    qwen2 checkpoint of Qwen2.5-1.5B's widths at `layers` (write_qwen), K1
    at Q's and QT's shapes and blocks (check_block_grad_qwen), and the
    one-process references of QT0 from the tiny one: {"layers", "dir",
    "tiny_dir", "export_dir" (QT's, empty), "Q", "QD", "K1", "refs",
    "dirs"}. The caller removes "dirs"."""
    import torch
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    dirs = [tempfile.mkdtemp(prefix="smoke_qwen_", dir=build) for _ in range(4)]
    q = {"layers": layers, "dir": dirs[0], "tiny_dir": dirs[1], "export_dir": dirs[2],
         "dirs": dirs, "QD": None}
    t0 = time.time()
    write_s = write_qwen(qwen_cfg(layers), q["dir"])
    write_qwen(tiny_qwen_cfg(), q["tiny_dir"])
    size = sum(os.path.getsize(os.path.join(q["dir"], n)) for n in os.listdir(q["dir"]))
    log(f"[Q] wrote a qwen2 checkpoint of Qwen2.5-1.5B's widths at {layers} layers (tied head, "
        f"seeded q/k/v biases N(0, {QWEN_BIAS_STD})): {size / 1e9:.3f} GB in {write_s:.1f} s")
    q["Q"] = run_main_path(qwen_cfg(layers), "cuda", hf_dir=q["dir"], out_dir=dirs[3])
    report_run("Q", f"Qwen2.5-1.5B bf16 ({layers} layers, qwen2 checkpoint: q/k/v biases, tied "
               "head), bs 4 x seq 512, remat, attn auto (K3 at hd 128, group 6)", q["Q"], 3)
    if not all(q["Q"]["launches"][n] > 0 for n in TRAIN_KERNELS):
        raise AssertionError(f"run Q did not launch every kernel: {q['Q']['launches']}")
    qwen_layout("Q", (1, 1, 1), [q["Q"]], qwen_cfg(layers))
    shutil.rmtree(dirs[3], ignore_errors=True)
    torch.cuda.empty_cache()
    q["K1"] = check_block_grad_qwen(q["Q"], qwen_cfg(layers))
    if dropout:
        q["QD"] = run_main_path(qwen_cfg(layers), "cuda", hf_dir=q["dir"],
                                cfg_extra={"dropout": 0.1})
        report_run("QD", f"Qwen2.5-1.5B bf16 ({layers} layers) --dropout 0.1, bs 4 x seq 512, "
                   "remat, attn auto (the einsum in training, K3 in eval)", q["QD"], 3)
        torch.cuda.empty_cache()
    q["refs"] = {c: qt0_run(c, "cuda", 4, q["tiny_dir"]) for c in QT0_CASES}
    log(f"[Q] Q{', QD' if dropout else ''} and the QT0 references: {time.time() - t0:.1f} s")
    return q


def qt0_jobs(q):
    """The tiny tied, biased pairs of QT0, from prepare_qwen's checkpoint."""
    return [("QT0", (c, q["tiny_dir"])) for c in QT0_CASES]


def qwen_jobs(q):
    """A spawn's Qwen jobs: QT0, QT and, where QD ran, QTD."""
    return qt0_jobs(q) + [("QT", (q["layers"], q["dir"], q["export_dir"]))] + (
        [("QTD", (q["layers"], q["dir"]))] if q["QD"] is not None else [])


def hold_qwen(q, pair, quad=None, shape=(1, 1, 2), backend="gloo", n=""):
    """QT0 (at `shape` from `pair`, at (1, 2, 2) from `quad` where given),
    QT with QTE, and QTD where it ran, against Q, QD and the references of
    prepare_qwen. Returns rank 0's QT summary."""
    hold_qt0(shape, pair, q["refs"], tag=f"QT{n}0")
    if quad is not None:
        hold_qt0((1, 2, 2), quad, q["refs"], tag=f"QT{n}0")
    hold_qt(f"QT{n}", shape, backend, [r["QT"] for r in pair], q["Q"], q["layers"])
    if q["QD"] is not None:
        hold_qt(f"QT{n}D", shape, backend, [r["QTD"] for r in pair], q["QD"], q["layers"],
                dropout=True)
    return pair[0]["QT"]


def run_tensor(run_a, run_e, run_h, run_j, layers):
    """`--only tp`: the tensor axis over gloo ranks sharing the card, held
    against A, E, H and J run here: T0, TQ0, TS0 and TC0 (the tiny pair,
    fp32 and fp16, over the dense and the int8 base, per layer and over the
    scan state, in matrix and channel mode) at (1, 1, 2) in the spawn of T,
    TQ, TS, TC and TCJ (A's, E's, E's with --scan_layers on, H's and J's
    at (1, 1, 2) with TE, TQE, TSE and TCE), and at (1, 2, 2) over four
    ranks. Then Qwen2.5-1.5B at its 28 layers: Q and QD in this process,
    QT, QTE and QTD in the spawn of T, QT0 in both spawns (prepare_qwen,
    hold_qwen). Returns rank 0's summaries."""
    refs = tensor_refs()
    refs.update(qh0_refs())
    q = prepare_qwen(QWEN["num_hidden_layers"], dropout=True)
    t_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
    t0 = time.time()
    tiny = tensor_tiny_jobs()
    try:
        pair = _spawn(dp_rank, 2, tiny + [("T", (layers, t_dir)), ("TQ", layers), ("TS", layers),
                                          ("TC", layers), ("TCJ", layers)] + qwen_jobs(q),
                      after=((1, 2, 1),))
        t_quad = time.time()
        quad = _spawn(dp_rank, 4, tiny + qt0_jobs(q) + qh_jobs(q), after=((2, 2, 1),))
    finally:
        for d in [t_dir] + q["dirs"]:
            shutil.rmtree(d, ignore_errors=True)
    seconds = {k: round(v["seconds"], 1) for k, v in pair[0].items()
               if isinstance(v, dict) and "seconds" in v}
    quad_seconds = {k: round(v["seconds"], 1) for k, v in quad[0].items()
                    if isinstance(v, dict) and "seconds" in v}
    log(f"[T] 2 gloo ranks on cuda:0 at (1, 1, 2), T0, TQ0, TS0, TC0, QT0, T, TQ, TS, TC, TCJ, "
        f"QT and QTD, and 4 at (1, 2, 2), T0, TQ0, TS0, TC0 and QT0, and at {QH_SHAPE} QH0 and "
        f"QH: {time.time() - t0:.1f} s (the four's spawn {time.time() - t_quad:.1f} s); seconds "
        f"by job on rank 0: {seconds}; of the four: {quad_seconds}")
    for shape, got in (((1, 1, 2), pair), ((1, 2, 2), quad)):
        hold_tensor_tiny(shape, got, refs)
    hold_qwen(q, pair, quad)
    hold_qh0(quad, refs)
    t = [r["T"] for r in pair]
    hold_t("T", (1, 1, 2), "gloo", t, run_a, layers)
    hold_t("TQ", (1, 1, 2), "gloo", [r["TQ"] for r in pair], run_e, layers, {"T rank 0": t[0]},
           fq="int8")
    hold_ts("TS", (1, 1, 2), "gloo", [r["TS"] for r in pair], run_e, layers,
            {"TQ rank 0": pair[0]["TQ"]})
    hold_tc("TC", (1, 1, 2), "gloo", [r["TC"] for r in pair], run_h, "H", layers,
            {"T rank 0": t[0]})
    hold_tc("TCJ", (1, 1, 2), "gloo", [r["TCJ"] for r in pair], run_j, "J", layers,
            {"TS rank 0": pair[0]["TS"]})
    hold_qh("QH", [r["QH"] for r in quad], q["Q"], q["layers"], beside={"QT rank 0": pair[0]["QT"]})
    return {"T": pair[0]["T"], "TQ": pair[0]["TQ"], "TS": pair[0]["TS"], "TC": pair[0]["TC"],
            "TCJ": pair[0]["TCJ"], "QH": quad[0]["QH"],
            **{f"{k} {d}": pair[0][f"{k}:{d}"] for d in T0_DTYPES for k in ("T0", "TQ0")},
            **{f"{k} {d} (1,2,2)": quad[0][f"{k}:{d}"] for d in T0_DTYPES
               for k in ("T0", "TQ0")}}


def run_fsdp_nccl(run_a, layers):
    """`--only nccl` (two or more cards): the fsdp axis over NCCL, one rank
    a card, at (1, N, 1) and, with four cards, (2, 2, 1): FN0, the tiny
    fp32 pair against one process, and FN1, A's path against A, with its
    export (hold_f0, hold_f); with four cards TN, the tensor axis at (1, N
    / 2, 2) (TN0 the tiny pair, TN A's path; TQN0 and TQN the same over the
    int8 base against E; TSN0 and TSN over the scan state; TCN0, TCN and
    TCJN in channel mode against H and J; run_tensor_nccl); then FSN, the
    scan layouts at (1, N, 1) against E and J (run_fsdp_scan)."""
    import torch
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    n = torch.cuda.device_count()
    tiny = LlamaConfig.tiny(vocab_size=512)
    refs = {fq: run_main_path(tiny, "cuda", bs=4, frozen_quant=fq, **P0_KW)
            for fq in ("none", "int8")}
    for shape in [(1, n, 1)] + ([(2, n // 2, 1)] if n >= 4 else []):
        fe_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
        t0 = time.time()
        try:
            ranks = _spawn(dp_rank, n, [("F0", "none"), ("F0", "int8"), ("F", (layers, fe_dir))],
                           after=(shape, "nccl"))
        finally:
            shutil.rmtree(fe_dir, ignore_errors=True)
        log(f"[FN1] {n} NCCL ranks, one a card, at {shape}: {time.time() - t0:.1f} s for the "
            f"spawn and the runs")
        for fq in ("none", "int8"):
            hold_f0(shape, fq, [r[f"F0:{fq}"] for r in ranks], refs, tag="FN0")
        hold_f("FN1", shape, "nccl", [r["F"] for r in ranks], run_a, layers)
    run_e = run_main_path(LlamaConfig(**TINYLLAMA), "cuda", frozen_quant="int8")
    run_j = run_main_path(LlamaConfig(**TINYLLAMA), "cuda", mode="channel", frozen_quant="int8")
    if n >= 4:
        run_h = run_main_path(LlamaConfig(**TINYLLAMA), "cuda", mode="channel")
        run_tensor_nccl(run_a, run_e, run_h, run_j, layers, refs)
    # FSN: the scan layouts over NCCL at (1, N, 1), held to E and J run here
    run_fsdp_scan(run_e, run_j, layers, world=n, backend="nccl", tag="FSN")


def run_data_nccl(run_a, layers):
    """PN1 (`--only nccl`, two or more cards): A's path over the data axis
    at (N, 1, 1) over NCCL, one rank a card, at A's global batch (bs 4 / N
    a rank): every rank collates the global batch in C++ and keeps its
    rows; held to A as P is (hold_p)."""
    import torch
    n = torch.cuda.device_count()
    t0 = time.time()
    ranks = _spawn(dp_rank, n, [("P", layers)], after=(None, "nccl"))
    log(f"[PN1] {n} NCCL ranks, one a card, at ({n}, 1, 1): {time.time() - t0:.1f} s for the "
        f"spawn and the run")
    p = [r[f"P:{layers}"] for r in ranks]
    log_selection_margin(run_a, p[0], tag="PN1")
    hold_p("PN1", (n, 1, 1), "nccl", p, run_a, layers)


def run_tensor_nccl(run_a, run_e, run_h, run_j, layers, refs):
    """TN, TQN, TSN and TCN (`--only nccl`, four cards or more): the tensor
    axis over NCCL, one rank a card, at (1, N / 2, 2): TN0, TQN0, TSN0 and
    TCN0, the tiny pair in fp32 and fp16 over the dense and the int8 base,
    per layer and over the scan state, in matrix and channel mode, against
    one process, and TN, TQN, TSN, TCN and TCJN, A's, E's, E's with
    --scan_layers on, H's and J's against A, E, H and J with their exports
    (hold_tensor_tiny, hold_t, hold_ts, hold_tc)."""
    import torch
    n = torch.cuda.device_count()
    refs = tensor_refs(refs)
    shape = (1, n // 2, 2)
    t_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
    t0 = time.time()
    try:
        ranks = _spawn(dp_rank, n, tensor_tiny_jobs()
                       + [("T", (layers, t_dir)), ("TQ", layers), ("TS", layers), ("TC", layers),
                          ("TCJ", layers)],
                       after=((1, n, 1), "nccl"))
    finally:
        shutil.rmtree(t_dir, ignore_errors=True)
    log(f"[TN] {n} NCCL ranks, one a card, at {shape}: {time.time() - t0:.1f} s")
    hold_tensor_tiny(shape, ranks, refs, n="N")
    t = [r["T"] for r in ranks]
    hold_t("TN", shape, "nccl", t, run_a, layers)
    hold_t("TQN", shape, "nccl", [r["TQ"] for r in ranks], run_e, layers, {"T rank 0": t[0]},
           fq="int8")
    hold_ts("TSN", shape, "nccl", [r["TS"] for r in ranks], run_e, layers,
            {"TQN rank 0": ranks[0]["TQ"]})
    hold_tc("TCN", shape, "nccl", [r["TC"] for r in ranks], run_h, "H", layers,
            {"TN rank 0": t[0]})
    hold_tc("TCJN", shape, "nccl", [r["TCJ"] for r in ranks], run_j, "J", layers,
            {"TSN rank 0": ranks[0]["TS"]})
    run_qwen_nccl()


def run_qwen_nccl():
    """QTN (`--only nccl`, four cards or more): Q's path
    at Qwen2.5-1.5B's 28 layers and the tiny QT0 pairs over NCCL, one rank
    a card, at (1, N / 2, 2), against Q and the references run here
    (prepare_qwen, hold_qwen); on four cards in the same spawn QHN, Q's
    path at QH_SHAPE, where T cuts the heads (hold_qh)."""
    import torch
    n = torch.cuda.device_count()
    shape = (1, n // 2, 2)
    q = prepare_qwen(QWEN["num_hidden_layers"])
    qh = [("QH", (q["layers"], q["dir"]))] if n == QH_SHAPE[2] else []
    t0 = time.time()
    try:
        ranks = _spawn(dp_rank, n, qwen_jobs(q) + qh, after=((1, n, 1), "nccl"))
    finally:
        for d in q["dirs"]:
            shutil.rmtree(d, ignore_errors=True)
    log(f"[QTN] {n} NCCL ranks, one a card, at {shape}, QT0 and QT"
        f"{f', QH at {QH_SHAPE}' if qh else ''}: {time.time() - t0:.1f} s")
    hold_qwen(q, ranks, shape=shape, backend="nccl", n="N")
    if qh:
        hold_qh("QHN", [r["QH"] for r in ranks], q["Q"], q["layers"], backend="nccl",
                beside={"QTN rank 0": ranks[0]["QT"]})


def run_fsdp_scan(run_e, run_j, layers, world=2, backend="gloo", tag="FS"):
    """`--only fs` (two gloo ranks on the one card) and `--only nccl` (FSN,
    one NCCL rank a card): FS at (1, world, 1), held to E and J run in
    this process (hold_fs); over gloo FS0 too, at (1, 2, 1) in the same
    spawn and at (2, 2, 1) over four ranks (hold_fs0)."""
    gloo = backend == "gloo"
    shape = (1, world, 1)
    refs = {n: fs0_run(n, "cuda", 4) for n in FS0_RUNS} if gloo else {}
    dirs = [tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
            for _ in range(2)]
    jobs = ([("FS0", n) for n in FS0_RUNS] if gloo else []) + \
        [("FS", (layers, m, d)) for m, d in zip(("matrix", "channel"), dirs)]
    t0 = time.time()
    try:
        ranks = _spawn(dp_rank, world, jobs, after=(shape, backend))
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    log(f"[{tag}] {world} {backend} ranks at {shape}: {time.time() - t0:.1f} s for the spawn "
        f"and its jobs")
    if gloo:
        quad = _spawn(dp_rank, 4, [("FS0", n) for n in FS0_RUNS], after=((2, 2, 1),))
        for sh, got in ((shape, ranks), ((2, 2, 1), quad)):
            for n in FS0_RUNS:
                hold_fs0(sh, n, [r[f"FS0:{n}"] for r in got], refs[n])
    hold_fs(tag, shape, backend, [r["FS:matrix"] for r in ranks], run_e, "E", layers)
    hold_fs(tag, shape, backend, [r["FS:channel"] for r in ranks], run_j, "J", layers)


def _spawn(fn, world, *args, after=()):
    """fn(rank, world, port, *args, out_dir, *after) in `world` processes;
    returns what each rank saved."""
    import torch
    import torch.multiprocessing as mp
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import free_port
    out_dir = tempfile.mkdtemp(prefix="smoke_dp_", dir=os.path.join(REPO, "build"))
    torch.cuda.empty_cache()
    mp.spawn(fn, args=(world, free_port(), *args, out_dir, *after), nprocs=world, join=True)
    got = [torch.load(os.path.join(out_dir, f"{fn.__name__[:2]}.{r}.pt"), weights_only=False)
           for r in range(world)]
    shutil.rmtree(out_dir, ignore_errors=True)
    return got


def log_selection_margin(run_a, run_p, tag="P", ref="A"):
    """Where P's (or F's, `tag`) plan leaves A's: each block that one
    selected and the other did not, with its score in both runs, beside the score of the
    last block A selected in that group (attention or MLP) and how far
    P's scores sit from A's over A's selected blocks, each relative to its
    own score in A (a swap inside that spread is a near-tie, not a wrong
    reduction). Returns (that spread's max, {swapped block: its distance
    to A's last block of its group relative to its own score in A, the
    spread's unit}), or None where the plans are equal."""
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.models.llama import ATTN_TARGETS
    a_sel, p_sel = set(run_a["selected"]), set(run_p["selected"])
    if a_sel == p_sel:
        log(f"[{tag}] selection: the same {len(a_sel)} blocks as {ref}'s")
        return None
    sa, sp = run_a["block_scores"], run_p["block_scores"]

    def group(ks):
        return "attention" if ks.split(".", 1)[1] in ATTN_TARGETS else "mlp"

    spread = np.array([abs(sp[k][r, c] - sa[k][r, c]) / sa[k][r, c] for k, r, c in a_sel])
    lines, gaps = [], {}
    for k, r, c in sorted(a_sel ^ p_sel):
        last = min(sa[kk][rr, cc] for kk, rr, cc in a_sel if group(kk) == group(k))
        gaps[(k, r, c)] = abs(sa[k][r, c] - last) / sa[k][r, c]
        lines.append(f"{k} ({r},{c}) {ref + ' only' if (k, r, c) in a_sel else tag + ' only'}: "
                     f"{ref} {sa[k][r, c]:.6e}, {tag} {sp[k][r, c]:.6e}; {ref}'s last "
                     f"{group(k)} block {last:.6e}, gap {gaps[(k, r, c)]:.2e} of its score")
    log(f"[{tag}] selection: {len(a_sel ^ p_sel) // 2} of {len(a_sel)} blocks swapped; {tag}'s "
        f"scores of {ref}'s selected blocks sit within {np.median(spread):.2e} (median) / "
        f"{spread.max():.2e} (max) of {ref}'s; " + "; ".join(lines))
    return float(spread.max()), gaps


def hold_p(tag, shape, backend, p, run_a, layers):
    """P (and PN1 over NCCL): A's path over the data axis at A's global
    batch, each rank's summary in `p`, held to A: the ranks' losses and
    plans equal, every training kernel launched on each rank, losses within
    P_VS_A_RTOL and warm-up grad norms within P_GNORM_RTOL of A's; per rank
    ms/step, all-reduced MB and ms a step, peaks, launches and fit's wait on
    the collator's queue."""
    import numpy as np
    if any(x["loss"] != p[0]["loss"] or x["plan"] != p[0]["plan"] for x in p):
        raise AssertionError(f"{tag}: the ranks' losses or plans differ")
    for r, s in enumerate(p):
        if not all(s["launches"][n] > 0 for n in TRAIN_KERNELS):
            raise AssertionError(f"{tag} rank {r} did not launch every kernel: {s['launches']}")
    a_loss = run_a["loss"] + [run_a["eval_loss"]]
    p_loss = p[0]["loss"] + [p[0]["eval_loss"]]
    rel = np.abs(np.array(p_loss) - np.array(a_loss)) / np.abs(np.array(a_loss))
    a_norm, p_norm = np.array(run_a["warmup_grad_norm"]), np.array(p[0]["warmup_grad_norm"])
    rel_norm = np.abs(p_norm - a_norm) / a_norm
    log(f"[{tag}] TinyLlama-1.1B bf16, {layers} layers, {len(p)} {backend} ranks at {shape} x "
        f"bs {4 // len(p)} x seq 512 (A's global batch), 3 warm-up + 4 sparse steps: losses "
        f"{p_loss} vs A's {a_loss}, worst rel diff {float(rel.max()):.2e} (bound "
        f"{P_VS_A_RTOL}); warm-up grad norms {p_norm.tolist()} vs A's {a_norm.tolist()}, "
        f"worst rel diff {float(rel_norm.max()):.2e} (bound {P_GNORM_RTOL}); plan "
        f"{p[0]['plan']['fingerprint'][:16]} on every rank, A's "
        f"{run_a['plan']['fingerprint'][:16]}; {p[0]['checksums']} leaves bit-equal across "
        f"ranks (master, m, v after the warm-up; trainables, m, v after fit)")
    n_warm = 3
    for r, s in enumerate(p):
        ms = s["step_ms"]
        log(f"[{tag}] rank {r}: warm-up ms/step {[round(x, 1) for x in ms[:n_warm]]}, sparse "
            f"{[round(x, 1) for x in ms[n_warm:]]} (A: {[round(x, 1) for x in run_a['step_ms']]}); "
            f"all-reduced MB/step {[round(b / 1e6, 3) for b in s['reduced_bytes']]}, all-reduce "
            f"ms/step {[round(x, 1) for x in s['reduce_ms']]}; peak GiB "
            f"{ {k: round(v / 1024 ** 3, 2) for k, v in s['peak'].items() if v is not None} }; "
            f"launches K1 {s['launches']['block_grad']}, K2 "
            f"{s['launches']['masked_adam']}, K3 fwd {s['launches']['attn_fwd']}, dK/dV "
            f"{s['launches']['attn_bwd_dkdv']}; wait on the collator's queue ms/step "
            f"{[round(x, 3) for x in s['loader_wait_ms']]}; {s['seconds']:.1f} s")
    if rel.max() > P_VS_A_RTOL:
        raise AssertionError(f"{tag}: losses part from A's by {float(rel.max()):.2e} > "
                             f"{P_VS_A_RTOL}")
    if len(p_norm) != len(a_norm) or rel_norm.max() > P_GNORM_RTOL:
        raise AssertionError(f"{tag}: warm-up grad norms {p_norm.tolist()} part from A's "
                             f"{a_norm.tolist()} by more than {P_GNORM_RTOL}")


def run_data_parallel(run_a, d1, export_dir, p_layers, fs=True, t_layers=None, tq=True,
                      qwen_layers=None, fs_layers=None):
    """P0, P and PE in two gloo ranks on the one card (one spawn), held
    against one process: P0 against its tiny references run here, P
    against A, PE against D1; in the same spawn the fsdp axis (F0, F, FS0,
    FS) and the tensor axis (T0, TQ0, TS0 and TC0; T and, with tq, TQ and
    TS at t_layers, A's depth by default, held to A, or to A and E run
    here at that depth; TC and TCJ at A's depth, held to H and J once they
    have run; check_fsdp). With qwen_layers, Q at that depth in this
    process and QT with QTE in the same spawn, QT0 in both spawns
    (prepare_qwen, hold_qwen), and QH0 and QH at QH_SHAPE in check_fsdp's
    spawn of four (hold_qh0, hold_qh). Then PN over NCCL. Returns the rank-0
    summaries, every rank's TC and TCJ summaries under "TC ranks" and
    "TCJ ranks", and A's and E's runs at t_layers under "A cut" and "E
    cut". fs_layers: FS's depth by mode (p_layers by default)."""
    t_layers = p_layers if t_layers is None else t_layers
    fs_layers = fs_layers or {"matrix": p_layers, "channel": p_layers}
    import numpy as np
    from sparse_matrix_tuning_tpu_torch.data.sft import batch_iterator
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

    tiny = LlamaConfig.tiny(vocab_size=512)
    refs = {fq: run_main_path(tiny, "cuda", bs=4, frozen_quant=fq, **P0_KW)
            for fq in ("none", "int8")}
    refs = tensor_refs(refs)
    refs.update({f"FS0:{n}": fs0_run(n, "cuda", 4) for n in FS0_RUNS})
    if qwen_layers:
        refs.update(qh0_refs())
    # T, TQ and TS at t_layers: their one-process references at that depth
    cut = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": t_layers})
    t_refs = {"A": run_a if t_layers == p_layers else run_main_path(cut, "cuda"),
              "E": run_main_path(cut, "cuda", frozen_quant="int8") if tq else None}
    q = prepare_qwen(qwen_layers) if qwen_layers else None
    first = thin_rows(next(batch_iterator(synthetic_sft(24, 64, 512, 1), 4, 0, [64], 1234, 0)),
                      P0_KW["thin"])
    valid = (first["labels"][:, 1:] != -100).sum(axis=1)
    dirs = [tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
            for _ in range(4)]
    jobs = [("P0", "none"), ("P0", "int8"), ("P", p_layers), ("PE", export_dir),
            ("F0", "none"), ("F0", "int8"), ("F", (p_layers, dirs[0]))] + \
        [("FS0", n) for n in FS0_RUNS] + \
        ([("FS", (fs_layers["matrix"], "matrix", dirs[1])),
          ("FS", (fs_layers["channel"], "channel", dirs[2]))] if fs else []) + \
        [("T0", d) for d in T0_DTYPES] + [("T", (t_layers, dirs[3]))] + \
        [("TQ0", d) for d in T0_DTYPES] + ([("TQ", t_layers)] if tq else []) + \
        [("TS0", c) for c in TS0_CASES] + ([("TS", t_layers)] if tq else []) + \
        [("TC0", c) for c in TC0_CASES] + \
        ([("TC", p_layers), ("TCJ", p_layers)] if tq else []) + (qwen_jobs(q) if q else [])
    t0 = time.time()
    try:
        ranks = _spawn(dp_rank, 2, jobs)
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    # QT0 at (1, 2, 2) and QH at QH_SHAPE read q's checkpoints in check_fsdp's spawn
    log(f"[dp] 2 ranks on cuda:0 over {ranks[0]['backend']} (NCCL refuses two ranks on one "
        f"device); gloo takes CUDA tensors for all_reduce and broadcast: "
        f"{[r['gloo_cuda'] for r in ranks]}; {time.time() - t0:.1f} s for the spawn and P0, P, "
        f"PE, F0, F, FS0, FS, T0, T, TQ0, TQ, TS0, TS, TC0, TC, TCJ, QT0, QT ({CARD['smi']}); "
        f"seconds "
        f"by job on "
        f"rank 0: "
        f"{ {k: round(v['seconds'], 1) for k, v in ranks[0].items() if isinstance(v, dict) and 'seconds' in v} }")
    for fq, rtol in (("none", P0_RTOL), ("int8", P0_INT8_RTOL)):
        ref, got = refs[fq], [r[f"P0:{fq}"] for r in ranks]
        fps = {g["plan"]["fingerprint"] for g in got} | {ref["plan"]["fingerprint"]}
        if len(fps) != 1:
            raise AssertionError(f"P0 {fq}: plan fingerprints differ: {fps}")
        if got[0]["loss"] != got[1]["loss"]:
            raise AssertionError(f"P0 {fq}: the ranks' losses differ")
        # fp32 attention walks each group whole: no dK/dV reduce
        needed = tuple(n for n in TRAIN_KERNELS if n != "attn_bwd_dkdv_reduce") + (
            Q8_KERNELS if fq == "int8" else ())
        for r, g in enumerate(got):
            if not all(g["launches"][n] > 0 for n in needed):
                raise AssertionError(f"P0 {fq} rank {r} did not launch every kernel: "
                                     f"{g['launches']}")
        norms, ref_norms = (np.array(r["warmup_grad_norm"] + r["grad_norm"]) for r in (got[0], ref))
        np.testing.assert_allclose(got[0]["loss"] + [got[0]["eval_loss"]],
                                   ref["loss"] + [ref["eval_loss"]], rtol=rtol)
        if fq == "none":
            np.testing.assert_allclose(norms, ref_norms, rtol=rtol)
        worst = float(np.max(np.abs(np.array(got[0]["loss"]) - np.array(ref["loss"]))
                             / np.abs(np.array(ref["loss"]))))
        worst_norm = float(np.max(np.abs(norms - ref_norms) / ref_norms))
        log(f"[P0] tiny fp32, frozen_quant {fq}: 2 ranks against one process at global batch "
            f"4, valid tokens by row of the first batch {valid.tolist()} (rank 0 rows 0-1, "
            f"rank 1 rows 2-3, thinned to 4 labels a row): losses {got[0]['loss']} vs "
            f"{ref['loss']}, worst rel diff {worst:.2e}, grad norms {norms.tolist()} vs "
            f"{ref_norms.tolist()}, worst rel diff {worst_norm:.2e} (bound {rtol} on "
            f"{'both' if fq == 'none' else 'the losses; grad norms reported'}); "
            f"eval {got[0]['eval_loss']:.6f} vs "
            f"{ref['eval_loss']:.6f}; same plan {ref['plan']['fingerprint'][:16]}; "
            f"{got[0]['checksums']} leaves bit-equal across ranks; rank 0 launches "
            f"{got[0]['launches']}")

    p = [r[f"P:{p_layers}"] for r in ranks]
    log_selection_margin(run_a, p[0])
    hold_p("P", (2, 1, 1), "gloo", p, run_a, p_layers)

    pe = [r[f"PE:{export_dir}"] for r in ranks]
    for r, s in enumerate(pe):
        want = d1["tokens"][r::2]
        if s["tokens"].shape != want.shape or not (s["tokens"] == want).all():
            raise AssertionError(f"PE rank {r}: tokens differ from D1's for its prompts")
        if s["launches"]["cached_attn"] <= 0:
            raise AssertionError(f"PE rank {r} did not launch K7: {s['launches']}")
    d1_text = StandInTokenizer(TINYLLAMA["vocab_size"]).batch_decode(d1["tokens"])
    if pe[0]["outputs"] != d1_text:
        raise AssertionError("PE: rank 0's gathered completions differ from D1's")
    log(f"[PE] the eval harness over A's export split by rank stride, {PE_PROMPTS} prompts, "
        f"beam-4, 256 new tokens: each rank's tokens equal D1's for its prompts "
        f"{[s['tokens'].shape for s in pe]}; rank 0 gathered all {len(pe[0]['outputs'])} "
        f"completions in prompt order, equal to D1's; walls {[round(s['wall_s'], 2) for s in pe]} "
        f"s (D1 {d1['wall_s']:.2f} s alone), peaks {[round(s['peak_gib'], 2) for s in pe]} GiB "
        f"(D1 {d1['peak_gib']:.2f}); K7 launches {[s['launches']['cached_attn'] for s in pe]}")

    try:
        fsdp = check_fsdp(ranks, refs, run_a, p, p_layers, t_layers, t_refs, q)
    finally:
        for d in (q or {}).get("dirs", ()):
            shutil.rmtree(d, ignore_errors=True)

    import torch
    n_cards = torch.cuda.device_count()
    t0 = time.time()
    pn = _spawn(pn_rank, min(n_cards, 2))
    log(f"[PN] {'two NCCL ranks, one a card' if n_cards >= 2 else 'one NCCL rank (one card)'}: "
        f"backend {pn[0]['backend']}, init {pn[0]['init_s']:.1f} s, bucket all-reduce "
        f"{pn[0]['buckets']} with exact sums, one tiny fp32 step loss {pn[0]['loss']!r} vs one "
        f"process {pn[0]['ref_loss']!r}; {time.time() - t0:.1f} s")
    log(f"[FN] the fsdp collectives over NCCL at mesh {pn[0]['fn']['mesh']}: all_gather_ and "
        f"reduce_scatter_ of {pn[0]['fn']['cases']} exact, fsdp.gather forward and backward "
        f"exact; path {pn[0]['fn']['path']}, counters {pn[0]['fn']['stats']}")
    return {"P": p[0], "P0": ranks[0]["P0:none"], "P0 int8": ranks[0]["P0:int8"], "PE": pe[0],
            "PN": pn[0], "A cut": t_refs["A"], "E cut": t_refs["E"], **fsdp}


def main(argv=None):
    """`--only q8` stops after the build, the row quantization, K4 / K5
    checks and the tiny int8 references; `--only q4` after the build, the K6 checks and the tiny
    quantized generation; `--only attn` after the build and the K3 / K7
    checks; `--only sparse` after the build and the K1 / K2 / K5 checks
    (short first calls for a new kernel); `--only scan` runs the build, the
    tiny 12-layer channel int8 reference, run J and runs R and R2 (a short
    call for the conversion into the scan state and resume); `--only fp16`
    runs the build, the fp16 bodies' checks and the tiny fp16 references;
    `--only dp` the build, A with its export, D1, then P0, P, PE, F0, F, FE,
    FS0, T0, T, TE, TQ0, PN and FN (FS needs E, G and J: `--only fs`; TQ
    needs E: `--only tp`); `--only fs` the build, E and J, then FS0, FS and FSE
    (run_fsdp_scan); `--only tp` the build, A, E, H and J, then the tensor
    axis: T0, TQ0, TS0, TC0, T, TE, TQ, TQE, TS, TSE, TC, TCJ and TCE
    (run_tensor), then Q, QD, QT0, QT, QTE, QTD, QH0 and QH at
    Qwen2.5-1.5B's 28 layers; `--only nccl` (two or more cards) the build,
    A, PN1 (the data axis at (N, 1, 1), run_data_nccl), then the fsdp axis
    over NCCL, one rank a card (run_fsdp_nccl, FSN and, on four cards, TN,
    QTN and QHN among it); `--only host` the build, N (check_collator), A at T_LAYERS and PF
    (run_profiled); none prints a result line. With no arguments every
    phase runs, on one card."""
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "q8"], ["--only", "q4"], ["--only", "attn"],
                    ["--only", "sparse"], ["--only", "scan"], ["--only", "fp16"],
                    ["--only", "dp"], ["--only", "fs"], ["--only", "nccl"], ["--only", "tp"],
                    ["--only", "host"]):
        raise SystemExit("usage: python3 chip_smoke.py "
                         "[--only q8|q4|attn|sparse|scan|fp16|dp|fs|nccl|tp|host]")
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
    if only == "dp":
        model_cfg = LlamaConfig(**TINYLLAMA)
        out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
        try:
            run_a = run_main_path(model_cfg, "cuda", out_dir=out_dir, keep_decode_params=True)
            report_run("A", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn auto (K3)", run_a, 3)
            params = run_a.pop("decode_params")
            d1 = eval_leg("D1", "bf16 cache, beam-4, K7", params, model_cfg,
                          synthetic_eval_examples(PE_PROMPTS, StandInTokenizer(
                              model_cfg.vocab_size), seed=11))
            del params
            marks.append(("A, D1", time.time()))
            run_data_parallel(run_a, d1, os.path.join(out_dir, "final"),
                              model_cfg.num_hidden_layers, fs=False, tq=False)
            marks.append(("P0, P, PE, F0, F, FE, FS0, T0, T, TE, TQ0, PN, FN", time.time()))
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        log("[smoke] --only dp: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "fs":
        model_cfg = LlamaConfig(**TINYLLAMA)
        run_e = run_main_path(model_cfg, "cuda", frozen_quant="int8")
        report_run("E", "TinyLlama-1.1B bf16 over the int8 frozen base, bs 4 x seq 512, remat, "
                   "attn auto (K3)", run_e, 3)
        run_j = run_main_path(model_cfg, "cuda", mode="channel", frozen_quant="int8")
        report_run("J", "TinyLlama-1.1B bf16, --channel_sparsity --frozen_quant int8 from a "
                   "warm-up, bs 4 x seq 512, remat, attn auto (K3)", run_j, 3)
        torch.cuda.empty_cache()
        marks.append(("E, J", time.time()))
        run_fsdp_scan(run_e, run_j, model_cfg.num_hidden_layers)
        marks.append(("FS0, FS, FSE", time.time()))
        log("[smoke] --only fs: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "tp":
        model_cfg = LlamaConfig(**TINYLLAMA)
        run_a = run_main_path(model_cfg, "cuda")
        report_run("A", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn auto (K3)", run_a, 3)
        torch.cuda.empty_cache()
        run_e = run_main_path(model_cfg, "cuda", frozen_quant="int8")
        report_run("E", "TinyLlama-1.1B bf16 over the int8 frozen base, bs 4 x seq 512, remat, "
                   "attn auto (K3)", run_e, 3)
        torch.cuda.empty_cache()
        run_h = run_main_path(model_cfg, "cuda", mode="channel")
        report_run("H", "TinyLlama-1.1B bf16, --channel_sparsity (30 + 30 channels), bs 4 x "
                   "seq 512, remat, attn auto (K3)", run_h, 3)
        check_channel_run(run_h)
        torch.cuda.empty_cache()
        run_j = run_main_path(model_cfg, "cuda", mode="channel", frozen_quant="int8")
        report_run("J", "TinyLlama-1.1B bf16, --channel_sparsity --frozen_quant int8 from a "
                   "warm-up, bs 4 x seq 512, remat, attn auto (K3)", run_j, 3)
        check_deep_channel_run(run_j, None)
        torch.cuda.empty_cache()
        marks.append(("A, E, H, J", time.time()))
        run_tensor(run_a, run_e, run_h, run_j, model_cfg.num_hidden_layers)
        marks.append(("T0, TQ0, TS0, TC0, T, TE, TQ, TQE, TS, TSE, TC, TCJ, TCE, Q, QD, QT0, "
                      "QT, QTE, QTD, QH0, QH", time.time()))
        log("[smoke] --only tp: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "nccl":
        if torch.cuda.device_count() < 2:
            raise SystemExit("--only nccl needs two or more cards (one NCCL rank a card)")
        model_cfg = LlamaConfig(**TINYLLAMA)
        run_a = run_main_path(model_cfg, "cuda")
        report_run("A", "TinyLlama-1.1B bf16, bs 4 x seq 512, remat, attn auto (K3)", run_a, 3)
        marks.append(("A", time.time()))
        run_data_nccl(run_a, model_cfg.num_hidden_layers)
        marks.append(("PN1", time.time()))
        run_fsdp_nccl(run_a, model_cfg.num_hidden_layers)
        marks.append(("FN0, FN1", time.time()))
        log("[smoke] --only nccl: seconds by phase: " + ", ".join(
            f"{name} {t - prev:.1f}" for (name, t), (_, prev)
            in zip(marks, [("", t_start)] + marks)))
        return
    if only == "host":
        model_cfg = LlamaConfig(**TINYLLAMA)
        check_collator(model_cfg)
        marks.append(("N", time.time()))
        cut = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": T_LAYERS})
        run_a = run_main_path(cut, "cuda")
        report_run("A", f"TinyLlama-1.1B width, {T_LAYERS} layers, bf16, bs 4 x seq 512, remat, "
                   "attn auto (K3)", run_a, 3)
        marks.append(("A", time.time()))
        run_profiled(run_a, T_LAYERS)
        marks.append(("PF", time.time()))
        log("[smoke] --only host: seconds by phase: " + ", ".join(
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
    rq_err, rq_split_err, rq_time = check_row_quant()
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

    # N: the C++ collator that fit trains from, against the numpy one
    model_cfg = LlamaConfig(**TINYLLAMA)
    check_collator(model_cfg)
    marks.append(("N", time.time()))
    # A: the main path, attn_impl "auto" (K3), with the final export; its
    # fine-tuned weights are run D's
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
        # P0, P, PE: data parallelism over two gloo ranks sharing the card
        # (P held to A, PE to D1 over A's export); F0, F, FE the fsdp axis;
        # PN and FN over NCCL
        run_dp = run_data_parallel(run_a, run_d["D1"], os.path.join(out_dir, "final"),
                                   model_cfg.num_hidden_layers, t_layers=T_LAYERS,
                                   qwen_layers=T_LAYERS, fs_layers=FS_LAYERS)
        marks.append(("P (with Q, QT0, QT, QTE)", time.time()))
        # PF: A's path at T_LAYERS traced and its saliency drawn, held to
        # A's run at that depth (made for T in run_data_parallel)
        run_pf = run_profiled(run_dp["A cut"], T_LAYERS)
        torch.cuda.empty_cache()
        marks.append(("PF", time.time()))
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
    # FS: the scan layouts under fsdp at FS_LAYERS, run in the data-parallel
    # spawn, held to one process's runs at that depth: --scan_layers on
    # (matrix, int8 base) to E with its sparse peak a rank under one
    # process's of the same path, channel + int8 at depth to J
    fs_one = fs_run((FS_LAYERS["matrix"], "matrix", None), "cuda", 4)   # E cut: T_LAYERS
    hold_fs("FS", (1, 2, 1), "gloo", run_dp["FS"]["matrix"], run_dp["E cut"], "E",
            FS_LAYERS["matrix"], peak=("one process's", fs_one["peak"]["later_sparse_steps"]))
    del fs_one
    j_cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": FS_LAYERS["channel"]})
    run_j_fs = run_main_path(j_cfg, "cuda", mode="channel", frozen_quant="int8")
    hold_fs("FS", (1, 2, 1), "gloo", run_dp["FS"]["channel"], run_j_fs, "J",
            FS_LAYERS["channel"])
    del run_j_fs
    torch.cuda.empty_cache()
    # TC and TCJ: channel mode under the tensor axis, run in the
    # data-parallel spawn, held now that H and J have run (TCE with them)
    hold_tc("TC", (1, 1, 2), "gloo", run_dp["TC ranks"], run_h, "H",
            model_cfg.num_hidden_layers, {"T rank 0": run_dp["T"]})
    hold_tc("TCJ", (1, 1, 2), "gloo", run_dp["TCJ ranks"], run_j, "J",
            model_cfg.num_hidden_layers, {"TS rank 0": run_dp["TS"]})
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
    k1_qwen_err, k1_qwen = run_dp["K1 qwen"]
    kernels = [
        dict(entry("block_grad", "block_grad.cu", "block_grad.py:56",
                   run_a["launches"]["block_grad"], max(k1_err, k1_qwen_err), k1_time["ms"],
                   k1_time["plain_ms"], k1_time["bound"], k1_time["lib_ms"]),
             ms_by_plan=k1_time["by_plan"], ms_at_plan_n=at_plan_n("K1"),
             at_qwen={"shape": k1_qwen["shape"], "max_abs_err": k1_qwen_err,
                      "ms": k1_qwen["ms"], "plain_ms": k1_qwen["plain_ms"],
                      "bound_ms": k1_qwen["bound"][0], "library_ms": k1_qwen["lib_ms"]},
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
                                   run_e["launches"]["row_quant"], rq_err, *rq_time["row_quant"]),
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
    # the split row quantization's entries, launched by TQ, the int8 base
    # under the tensor axis (rank 0; every rank launches its own)
    for name in RQ_SPLIT_KERNELS:
        kernels.append(dict(entry(name, "row_quant.cu", "", run_dp["TQ"]["launches"][name],
                                  rq_split_err, *rq_time[name]),
                            replaces="sparse_matrix_tuning_tpu/ops/quant.py:32"))
    # the fp16 bodies, launched by runs M and M8 (K4's, the row
    # quantization's and K5's by M8 only)
    fp16_src = {"block_grad": ("block_grad.cu", "block_grad.py:56"),
                "row_quant": ("row_quant.cu", ""),
                **{n: ("row_quant.cu", "") for n in RQ_SPLIT_KERNELS},
                "block_correction": ("correction.cu", "correction.py:69"),
                "q8mm_t": ("q8_matmul.cu", "q8_matmul.py:104"),
                "q8mm_g": ("q8_matmul.cu", "q8_matmul.py:133"),
                **{n: ("attention.cu", "attention.py:154" if n == "attn_fwd"
                       else "attention.py:188") for n in K3_KERNELS}}
    for base, (src, replaces) in fp16_src.items():
        name = f"{base}_fp16"
        err, ms, plain_ms, bnd, lib_ms, extra = fp16[name]
        # the split entries' fp16 bodies run on the tensor axis only: TQ0's
        # fp16 pair (rank 0)
        main_run = run_dp["TQ0 fp16"] if base in RQ_SPLIT_KERNELS else run_m8 \
            if base in ("row_quant", "block_correction", "q8mm_t", "q8mm_g") else run_m
        e = dict(entry(name, src, replaces, main_run["launches"][name], err, ms, plain_ms, bnd,
                       lib_ms), **extra,
                 launches_by_run={"M": run_m["launches"][name], "M8": run_m8["launches"][name],
                                  "TQ0 fp16": run_dp["TQ0 fp16"]["launches"][name]})
        if base in ("row_quant",) + RQ_SPLIT_KERNELS:
            e["replaces"] = "sparse_matrix_tuning_tpu/ops/quant.py:32"
        kernels.append(e)
    # every kernel's launches in the channel runs: H, I and I's decode legs,
    # J and its decode leg; and in R and R2's training steps
    runs = {"H": run_h["launches"], "I": run_i["launches"],
            **{tag: leg["launches"] for tag, leg in run_i["decode"].items()},
            "J": run_j["launches"], "J8": run_j["decode"]["J8"]["launches"],
            "R": run_r["launches"], "R2": run_r2["launches"],
            # rank 0 of the data-parallel runs (each rank launches its own)
            "P": run_dp["P"]["launches"], "P0": run_dp["P0"]["launches"],
            "P0 int8": run_dp["P0 int8"]["launches"], "PE": run_dp["PE"]["launches"],
            # rank 0 of the fsdp runs
            "F fsdp": run_dp["F"]["launches"], "F0": run_dp["F0"]["launches"],
            "F0 int8": run_dp["F0 int8"]["launches"],
            "F0 (2,2,1)": run_dp["F0 (2,2,1)"]["launches"],
            **{f"FS {m}": ranks[0]["launches"] for m, ranks in run_dp["FS"].items()},
            **{k: run_dp[k]["launches"] for k in run_dp
               if k.startswith(("FS0 ", "T0 ", "TQ0 ", "TC0 ", "QT0 ", "QH0 "))},
            # rank 0 of the tensor runs (each rank launches on its heads and windows)
            "T tensor": run_dp["T"]["launches"], "TQ tensor": run_dp["TQ"]["launches"],
            "TS tensor": run_dp["TS"]["launches"],
            "TC tensor": run_dp["TC ranks"][0]["launches"],
            "TCJ tensor": run_dp["TCJ ranks"][0]["launches"],
            # Qwen2.5-1.5B's widths: Q in one process, QT rank 0 (hq 6 / hkv 1 a rank)
            "Q": run_dp["Q"]["launches"], "QT tensor": run_dp["QT"]["launches"],
            "QH tensor": run_dp["QH"]["launches"],
            # A's path at T_LAYERS under --profile_dir
            "PF": run_pf["launches"]}
    for k in kernels:
        k.setdefault("launches_by_run", {}).update(
            {tag: counts[k["name"]] for tag, counts in runs.items()
             if not k["name"].endswith("_fp16")})
        if k["name"] in run_pf["trace_counts"]:   # its kernel events in PF's trace
            k["pf_trace_events"] = run_pf["trace_counts"][k["name"]]
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
