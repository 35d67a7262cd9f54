"""Time the chunked loss and run A's warm-up step on one CUDA GPU:

    python sparse_matrix_tuning_tpu_torch/utils/time_loss.py [--root DIR]

At chip_smoke.py's run A (TinyLlama-1.1B geometry, random weights from a
seed, bf16, bs 4 x seq 512, remat, attention "auto", vocab_chunk 4096):
  * "loss": ops/loss.chunked_causal_lm_loss forward and backward (grads of
    the hidden states and of the head) on seeded inputs, the median of 20
    synchronised calls after 3 untimed ones;
  * "warmup_step": the trainer's warm-up step (it takes the chunked loss at
    this vocabulary), the median of 5 synchronised steps after 2 untimed
    ones, on synthetic batches as utils/profile_steps.py makes them.
`--root`: the checkout whose `sparse_matrix_tuning_tpu_torch` is timed
(default this one), so that two trees can be timed in turns with one script
(the loss's and the trainer's signatures are those of PR 12 on). Prints the
card's name and power limit and one JSON line.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    # run by path, its own directory leads sys.path, and its logging.py would
    # shadow the standard library's
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

import argparse
import json
import shutil
import statistics
import subprocess
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BS, SEQ, VOCAB_CHUNK = 4, 512, 4096


def _wall_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def time_loss(model_cfg, device, reps: int = 20) -> list:
    """The chunked loss's forward + backward at A's shape, ms per call."""
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.loss import chunked_causal_lm_loss
    gen = torch.Generator(device=device).manual_seed(0)
    d, v = model_cfg.hidden_size, model_cfg.vocab_size
    hidden = torch.randn((BS, SEQ, d), device=device, generator=gen).to(torch.bfloat16)
    head = (torch.randn((v, d), device=device, generator=gen) * 0.02).to(torch.bfloat16)
    labels = torch.randint(3, v, (BS, SEQ), device=device, generator=gen)
    labels[:, :SEQ // 8] = -100
    hidden.requires_grad_(True)
    head.requires_grad_(True)

    def call():
        hidden.grad = head.grad = None
        chunked_causal_lm_loss(hidden, head, labels, VOCAB_CHUNK).backward()

    for _ in range(3):
        call()
    return [_wall_ms(call) for _ in range(reps)]


def time_warmup(model_cfg, device, steps: int = 5) -> list:
    """A's warm-up step through the trainer, ms per step."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    cfg = SMTConfig(data_path=["synthetic"], model_name_or_path="random-init", dtype="bf16",
                    matrix_sparsity=True, full_ft_steps=steps + 3,
                    downsample_attention_blocks_ratio=0.0084,
                    downsample_mlp_blocks_ratio=0.0084, ft_learning_rate=9.865e-6,
                    smt_lr=9.865e-6, calculate_strategy="abs_mean",
                    per_device_ft_batch_size=BS, max_seq_len=SEQ, seq_buckets=[SEQ],
                    seed=1234, vocab_chunk=VOCAB_CHUNK)
    rng = np.random.default_rng(0)

    def batch():
        ids = rng.integers(3, model_cfg.vocab_size, (BS, SEQ)).astype(np.int32)
        labels = ids.copy()
        labels[:, : SEQ // 8] = -100
        return {"input_ids": ids, "labels": labels, "attention_mask": np.ones_like(ids)}

    trainer = SMTTrainer(cfg, model_cfg,
                         init_params(model_cfg, seed=0, dtype=torch.bfloat16, device=device),
                         total_steps=100, device=device)
    for _ in range(2):
        trainer.train_step(batch())
    walls = []
    for _ in range(steps):
        b = batch()
        walls.append(_wall_ms(lambda: float(trainer.train_step(b)["loss"])))
    if trainer.phase != "warmup":
        raise AssertionError(f"timed a {trainer.phase} step, not a warm-up step")
    return walls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose sparse_matrix_tuning_tpu_torch is timed")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_loss needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree under {root}")
    _build.load()
    model_cfg = LlamaConfig()  # TinyLlama-1.1B geometry
    device = torch.device("cuda")
    loss = time_loss(model_cfg, device)
    torch.cuda.empty_cache()
    warmup = time_warmup(model_cfg, device)
    smi = shutil.which("nvidia-smi")
    card = None
    if smi:
        card = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"root": root, "card": card,
                      "loss_ms": statistics.median(loss), "loss_runs_ms": loss,
                      "warmup_step_ms": statistics.median(warmup),
                      "warmup_runs_ms": warmup}), flush=True)


if __name__ == "__main__":
    main()
