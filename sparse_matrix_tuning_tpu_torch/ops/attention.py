"""Causal GQA training attention ("fullk") as a torch.autograd.Function —
twin of `sparse_matrix_tuning_tpu.ops.pallas.attention.fullk_attention`.

The forward keeps (q, k, v, o, lse) for the backward, which recomputes the
probabilities tile by tile; no (S, S) score or probability tensor is kept
in device memory. On CUDA tensors both directions run the K3 kernels
(ops/cuda/attention.py); on CPU tensors their plain versions. The
attention mask is not an input: the result is exact for causal attention
over right-padded batches (pad keys sit causally after every real query;
the loss drops pad-query rows), which the trainer checks once.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sparse_matrix_tuning_tpu_torch.ops.cuda.attention import attn_bwd, attn_fwd


class _FullKAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        o, lse = attn_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attn_bwd(q, k, v, o, lse, do.contiguous(), ctx.sm_scale)
        return dq, dk, dv, None


def fullk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Causal GQA attention. q: (B,S,Hq,hd); k/v: (B,S,Hkv,hd), contiguous;
    returns (B,S,Hq,hd) in q's dtype. Right-padding safe; no dropout."""
    return _FullKAttention.apply(q, k, v, sm_scale)
