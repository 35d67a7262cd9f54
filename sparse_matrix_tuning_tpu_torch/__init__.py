"""sparse_matrix_tuning_tpu_torch — Sparse Matrix Tuning (SMT) in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `sparse_matrix_tuning_tpu` (the JAX package, kept beside it as
the reference): a full fine-tuning warm-up gathers gradient saliency, the
most salient 256x256 blocks of q/k/v/gate/up/down are selected, and the
sparse phase gives gradients and Adam state to those blocks only. The
module layout and function names mirror the JAX package, so each module's
counterpart is found by path. Matrix mode, bf16/fp32, one device, over a
dense or int8 frozen base; the generation eval over the dense weights or
an int8 / int4 frozen base quantized while loading. Each Pallas kernel of
the JAX package has a hand-written CUDA counterpart, built from csrc/ at
first use.

This package imports torch and numpy only — never jax.
"""

__version__ = "0.1.0"

BLOCK = 256  # SMT block dimension (reference deepspeed/smt/smt.py:22)
