"""Cross-entropy over a chunked vocabulary: the LM head matmul fused with
the loss, so the full (B, S, V) fp32 logits tensor is never materialised
(PyTorch twin of `sparse_matrix_tuning_tpu.ops.loss`).

An online log-sum-exp walks over vocab chunks; only one chunk's logits
(T, vocab_chunk) are alive at a time. The backward recomputes each chunk's
logits (the JAX twin checkpoints its scan body) and adds
(softmax_chunk - onehot_chunk) @ head_chunk into grad_hidden, so backward
memory is flat too.

Two heads share the one core (`_ChunkedLSELoss`):
  * chunked_causal_lm_loss    — exact bf16/fp32 head matmul; the head gets
    its gradient too (it trains in the warm-up)
  * chunked_causal_lm_loss_q8 — int8 frozen head (head_quant): hidden is
    row-quantized ONCE, each chunk's logits are one K4 product in fp32
    (ops/cuda/q8_matmul.py, ragged T = B*(S-1)), and grad_hidden is the
    straight-through int8 grad_input of ops/sparse_linear.frozen_q8_linear

The last chunk is simply shorter where the JAX twin pads the vocabulary to
the chunk multiple and masks the pad with -inf: the same sums.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.q8_matmul import q8mm_t
from sparse_matrix_tuning_tpu_torch.ops.quant import q8_matmul, row_quant

IGNORE_INDEX = -100


class _ChunkedLSELoss(torch.autograd.Function):
    """loss(h2 (T, D), labels (T,)) over an exact head (V, D) or, when
    head is None, the int8 head (wq, sw) with h2 already quantized to
    (xq, sx)."""

    @staticmethod
    def _chunk_logits(h2, head, wq, sw, xq, sx, lo, hi):
        if head is not None:
            return torch.matmul(h2, head[lo:hi].t()).float()
        return q8mm_t(xq, sx, wq[lo:hi], sw[lo:hi], torch.float32)

    @staticmethod
    def forward(ctx, h2, labels, vocab_chunk, head, wq, sw, xq, sx):
        v = head.shape[0] if head is not None else wq.shape[0]
        t = labels.reshape(-1).long()
        valid = t != IGNORE_INDEX
        tsafe = torch.where(valid, t, torch.zeros_like(t))
        tt = h2.shape[0]
        m = torch.full((tt,), float("-inf"), dtype=torch.float32, device=h2.device)
        se = torch.zeros((tt,), dtype=torch.float32, device=h2.device)
        tgt = torch.zeros((tt,), dtype=torch.float32, device=h2.device)
        for lo in range(0, v, vocab_chunk):
            hi = min(lo + vocab_chunk, v)
            logits = _ChunkedLSELoss._chunk_logits(h2, head, wq, sw, xq, sx, lo, hi)
            new_m = torch.maximum(m, logits.amax(dim=-1))
            se = se * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=-1)
            m = new_m
            local = tsafe - lo                      # target logit, if in this chunk
            in_chunk = (local >= 0) & (local < hi - lo)
            picked = logits.gather(1, local.clamp(0, hi - lo - 1)[:, None])[:, 0]
            tgt = torch.where(in_chunk, picked, tgt)
        lse = m + torch.log(se)
        denom = torch.clamp(valid.sum(), min=1)
        loss = torch.where(valid, lse - tgt, torch.zeros_like(lse)).sum() / denom
        ctx.save_for_backward(h2, head, wq, sw, xq, sx, lse, tsafe, valid, denom)
        ctx.vocab_chunk = vocab_chunk
        return loss

    @staticmethod
    def backward(ctx, gout):
        h2, head, wq, sw, xq, sx, lse, tsafe, valid, denom = ctx.saved_tensors
        v = head.shape[0] if head is not None else wq.shape[0]
        coef = gout.float() * valid.float() / denom     # d loss / d token loss
        grad_h = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
        want_head = head is not None and ctx.needs_input_grad[3]
        grad_head = torch.empty_like(head) if want_head else None
        for lo in range(0, v, ctx.vocab_chunk):
            hi = min(lo + ctx.vocab_chunk, v)
            logits = _ChunkedLSELoss._chunk_logits(h2, head, wq, sw, xq, sx, lo, hi)
            gl = torch.exp(logits - lse[:, None])        # softmax over the whole vocab
            local = tsafe - lo
            in_chunk = (local >= 0) & (local < hi - lo)
            gl.scatter_add_(1, local.clamp(0, hi - lo - 1)[:, None],
                            -in_chunk.float()[:, None])
            gl *= coef[:, None]
            if head is not None:
                glc = gl.to(h2.dtype)
                grad_h += torch.matmul(glc, head[lo:hi]).float()
                if want_head:
                    grad_head[lo:hi] = torch.matmul(glc.t(), h2)
            else:
                grad_h += q8_matmul(gl, wq[lo:hi], sw[lo:hi])
        return grad_h.to(h2.dtype), None, None, grad_head, None, None, None, None


def chunked_causal_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                           labels: torch.Tensor, vocab_chunk: int = 4096) -> torch.Tensor:
    """hidden: (B, S, D) final decoder states (pre-head); head: (V, D);
    labels: (B, S) with -100 ignore. Shifted CE, mean over valid tokens."""
    d = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, d)               # (T, D)
    return _ChunkedLSELoss.apply(h, labels[:, 1:], vocab_chunk, head, None, None, None, None)


def chunked_causal_lm_loss_q8(hidden: torch.Tensor, head_wq: torch.Tensor,
                              head_sw: torch.Tensor, labels: torch.Tensor,
                              vocab_chunk: int = 4096) -> torch.Tensor:
    """chunked_causal_lm_loss over an int8 frozen head (head_wq (V, D)
    int8, head_sw (V,) fp32, train/convert.py build_q_head). The hidden
    states are row-quantized ONCE (not per chunk) and the LSE stays fp32.
    Logit values are bitwise what the dense-path frozen_q8_linear head
    gives, so the chunked and dense q8 losses agree to fp32 reduction
    order."""
    d = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, d).float()       # (T, D)
    xq, sx = row_quant(h.detach())
    return _ChunkedLSELoss.apply(h, labels[:, 1:], vocab_chunk, None, head_wq, head_sw, xq, sx)
