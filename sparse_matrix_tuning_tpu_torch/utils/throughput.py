"""Throughput / FLOPs reporting.

Reference print_throughput + calculate_flops (deepspeed_helpers.py:470-525)
use the Megatron-LM formula; it is kept for comparability, beside
tokens/sec/device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


def calculate_flops(checkpoint_activations_factor: int, batch_size: int,
                    seq_length: int, num_layers: int, hidden_size: int,
                    vocab_size: int) -> float:
    """Megatron-LM GPT FLOPs per iteration
    (reference deepspeed_helpers.py:502-510):
    24 * ckpt_factor * B * s * L * h^2 * (1 + s/6h + V/16Lh)."""
    return (24 * checkpoint_activations_factor * batch_size * seq_length *
            num_layers * (hidden_size ** 2)) * (
        1.0 + (seq_length / (6.0 * hidden_size)) +
        (vocab_size / (16.0 * num_layers * hidden_size)))


# NVIDIA H100 SXM data-sheet peak: 989 TFLOP/s bf16 dense (no sparsity) at
# the 700 W power limit. A data-sheet value, not a measurement; a card set
# below 700 W reaches less.
H100_BF16_PEAK_FLOPS = 989e12


@dataclass
class ThroughputReporter:
    """Rank-0, every-N-steps throughput print (reference print_throughput,
    cadence fine_tune.py:779-783)."""
    batch_size: int
    seq_length: int
    num_layers: int
    hidden_size: int
    vocab_size: int
    num_devices: int = 1
    checkpoint_activations_factor: int = 4
    every: int = 200
    _t0: Optional[float] = field(default=None, repr=False)
    _step0: int = 0

    def start(self, step: int = 0):
        self._t0 = time.time()
        self._step0 = step

    def maybe_report(self, step: int) -> Optional[dict]:
        if self._t0 is None:
            self.start(step)
            return None
        if step == self._step0 or (step - self._step0) % self.every:
            return None
        elapsed = time.time() - self._t0
        iters = step - self._step0
        sec_per_iter = elapsed / iters
        flops = calculate_flops(self.checkpoint_activations_factor,
                                self.batch_size, self.seq_length,
                                self.num_layers, self.hidden_size,
                                self.vocab_size)
        tokens = self.batch_size * self.seq_length
        flops_per_device = flops / sec_per_iter / max(self.num_devices, 1)
        report = {
            "step": step,
            "sec_per_iter": sec_per_iter,
            "samples_per_sec": self.batch_size / sec_per_iter,
            "tokens_per_sec_per_device": tokens / sec_per_iter / max(self.num_devices, 1),
            "tflops_per_device": flops_per_device / 1e12,
            "mfu_vs_h100_datasheet": flops_per_device / H100_BF16_PEAK_FLOPS,
        }
        self._t0 = time.time()
        self._step0 = step
        return report
