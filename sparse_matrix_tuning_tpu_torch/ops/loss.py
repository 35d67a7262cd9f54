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

grad_hidden is summed as the JAX twin's autodiff sums it: its scan's
transpose walks the chunks in reverse and carries the sum in the hidden
states' dtype (fp16, bf16 or fp32), each chunk's term an fp32 product
(the fp32 cotangent times the head chunk) cast to that dtype before it is
added. The port does the same, so an fp16 or bf16 warm-up sums its
grad_hidden as JAX does (tests/test_torch_tensor.py pins it against
jax.grad of the JAX function).

Under the tensor axis (parallel/tensor.py) the head holds this rank's V/T
vocabulary rows: each rank walks the global chunk grid [c * chunk, (c +
1) * chunk) cut to its rows (a chunk that straddles two ranks is a piece
on each), then the running max is MAX-reduced over the tensor group, the
rescaled sums of exps and the target logits (zero off the rank's rows)
SUM-reduced, and the backward's grad_hidden is this rank's part, summed
over the group by a to_tensor_region in front of the hidden states
(the caller's for the exact head, chunked_causal_lm_loss_q8's own for
the int8 head). The int8 head's backward row-quantizes g * sw per global
chunk, as the JAX twin does over its padded vocabulary: the amax of a
straddling chunk is MAX-reduced over the group (one all-reduce of a
(T, straddling chunks) amax serves them all; none where every rank
boundary falls on the grid), so each rank quantizes its piece as one
process quantizes the chunk. vocab_parallel_causal_lm_loss is the
full-logits form over the same split.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.q8_matmul import q8mm_t
from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import row_amax
from sparse_matrix_tuning_tpu_torch.ops.quant import q8_matmul, row_quant
from sparse_matrix_tuning_tpu_torch.parallel.tensor import (
    from_tensor_region, tensor_all_reduce, tensor_amax, to_tensor_region)

IGNORE_INDEX = -100


def _combine_over_tensor(m, se, tgt, mesh):
    """The running max, sum of exps and target logit of the whole
    vocabulary from each rank's over its rows: MAX of the maxes, SUM of the
    sums rescaled to it, SUM of the target logits (zero off a rank's rows)."""
    m_all = tensor_all_reduce(m, mesh, "max")
    st = tensor_all_reduce(torch.stack([se * torch.exp(m - m_all), tgt]), mesh, "sum")
    return m_all, st[0], st[1]


def _chunk_pieces(v: int, vocab_chunk: int, offset: int = 0, parts: int = 1):
    """The global chunk grid of a vocabulary of v * parts rows cut to the
    rows [offset, offset + v) of one rank: [(lo, hi, chunk)] in local rows,
    and the chunks that straddle a rank boundary (the same on every rank)."""
    total = v * parts
    pieces = [(max(c, offset) - offset, min(c + vocab_chunk, total, offset + v) - offset,
               c // vocab_chunk) for c in range(0, total, vocab_chunk)
              if c < offset + v and c + vocab_chunk > offset]
    straddle = [c // vocab_chunk for c in range(0, total, vocab_chunk)
                if any(c < k * v < min(c + vocab_chunk, total) for k in range(1, parts))]
    return pieces, straddle


class _ChunkedLSELoss(torch.autograd.Function):
    """loss(h2 (T, D), labels (T,)) over an exact head (V, D) or, when
    head is None, the int8 head (wq, sw) with h2 already quantized to
    (xq, sx). tensor: the mesh when the head holds this rank's vocabulary
    rows from offset (module notes)."""

    @staticmethod
    def _chunk_logits(h2, head, wq, sw, xq, sx, lo, hi):
        if head is not None:
            return torch.matmul(h2, head[lo:hi].t()).float()
        return q8mm_t(xq, sx, wq[lo:hi], sw[lo:hi], torch.float32)

    @staticmethod
    def forward(ctx, h2, labels, vocab_chunk, head, wq, sw, xq, sx, denom=None, tensor=None,
                offset=0):
        v = head.shape[0] if head is not None else wq.shape[0]
        t = labels.reshape(-1).long()
        valid = t != IGNORE_INDEX
        tsafe = torch.where(valid, t, torch.zeros_like(t))
        tt = h2.shape[0]
        m = torch.full((tt,), float("-inf"), dtype=torch.float32, device=h2.device)
        se = torch.zeros((tt,), dtype=torch.float32, device=h2.device)
        tgt = torch.zeros((tt,), dtype=torch.float32, device=h2.device)
        pieces, straddle = _chunk_pieces(v, vocab_chunk, offset,
                                        1 if tensor is None else tensor.tensor)
        for lo, hi, _ in pieces:
            logits = _ChunkedLSELoss._chunk_logits(h2, head, wq, sw, xq, sx, lo, hi)
            new_m = torch.maximum(m, logits.amax(dim=-1))
            se = se * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=-1)
            m = new_m
            local = tsafe - (offset + lo)           # target logit, if in this chunk
            in_chunk = (local >= 0) & (local < hi - lo)
            picked = logits.gather(1, local.clamp(0, hi - lo - 1)[:, None])[:, 0]
            tgt = torch.where(in_chunk, picked, tgt)
        if tensor is not None:
            m, se, tgt = _combine_over_tensor(m, se, tgt, tensor)
        lse = m + torch.log(se)
        denom = torch.clamp(valid.sum(), min=1) if denom is None else denom.reshape(())
        loss = torch.where(valid, lse - tgt, torch.zeros_like(lse)).sum() / denom
        ctx.save_for_backward(h2, head, wq, sw, xq, sx, lse, tsafe, valid, denom)
        ctx.pieces, ctx.straddle, ctx.offset, ctx.tensor = pieces, straddle, offset, tensor
        return loss

    @staticmethod
    def _chunk_grad(ctx, h2, head, wq, sw, xq, sx, lse, tsafe, coef, lo, hi):
        """(softmax - onehot) * coef of the rows lo:hi, fp32 (T, hi - lo)."""
        gl = torch.exp(_ChunkedLSELoss._chunk_logits(h2, head, wq, sw, xq, sx, lo, hi)
                       - lse[:, None])        # softmax over the whole vocab
        local = tsafe - (ctx.offset + lo)
        in_chunk = (local >= 0) & (local < hi - lo)
        gl.scatter_add_(1, local.clamp(0, hi - lo - 1)[:, None], -in_chunk.float()[:, None])
        gl *= coef[:, None]
        return gl

    @staticmethod
    def backward(ctx, gout):
        h2, head, wq, sw, xq, sx, lse, tsafe, valid, denom = ctx.saved_tensors
        coef = gout.float() * valid.float() / denom     # d loss / d token loss
        grad_of = partial(_ChunkedLSELoss._chunk_grad, ctx, h2, head, wq, sw, xq, sx, lse,
                          tsafe, coef)
        # the int8 head: the whole-chunk amax of g * sw for the chunks that
        # straddle a rank boundary, one MAX all-reduce (module notes)
        held, amax = {}, {}
        if head is None and ctx.straddle:
            cols = torch.zeros((h2.shape[0], len(ctx.straddle)), dtype=torch.float32,
                               device=h2.device)
            for lo, hi, c in ctx.pieces:
                if c in ctx.straddle:
                    held[c] = grad_of(lo, hi)
                    cols[:, ctx.straddle.index(c)] = row_amax(held[c], sw[lo:hi])[:, 0]
            cols = tensor_amax(cols, ctx.tensor)
            amax = {c: cols[:, j:j + 1].contiguous() for j, c in enumerate(ctx.straddle)}
        # summed in h2's dtype over the chunks in reverse, each chunk's fp32
        # term cast first, as the JAX scan's transpose sums it (module notes)
        grad_h = torch.zeros(h2.shape, dtype=h2.dtype, device=h2.device)
        want_head = head is not None and ctx.needs_input_grad[3]
        grad_head = torch.empty_like(head) if want_head else None
        for lo, hi, c in reversed(ctx.pieces):
            gl = held.pop(c) if c in held else grad_of(lo, hi)
            if head is not None:
                grad_h += torch.matmul(gl, head[lo:hi].float()).to(h2.dtype)
                if want_head:
                    grad_head[lo:hi] = torch.matmul(gl.to(h2.dtype).t(), h2)
            else:
                grad_h += q8_matmul(gl, wq[lo:hi], sw[lo:hi], amax=amax.get(c)).to(h2.dtype)
        return grad_h, None, None, grad_head, None, None, None, None, None, None, None


def chunked_causal_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                           labels: torch.Tensor, vocab_chunk: int = 4096,
                           denom: Optional[torch.Tensor] = None, tensor=None) -> torch.Tensor:
    """hidden: (B, S, D) final decoder states (pre-head); head: (V, D);
    labels: (B, S) with -100 ignore. Shifted CE, mean over valid tokens, or
    the token-loss sum over `denom` (models/llama.causal_lm_loss).
    tensor: the mesh when head is this rank's (V/T, D) vocabulary rows and
    hidden the output of to_tensor_region (module notes)."""
    d = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, d)               # (T, D)
    offset = 0 if tensor is None else tensor.tensor_index * head.shape[0]
    return _ChunkedLSELoss.apply(h, labels[:, 1:], vocab_chunk, head, None, None, None, None,
                                 denom, tensor, offset)


def vocab_parallel_causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, mesh,
                                  denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """models/llama.causal_lm_loss over this rank's vocabulary rows of the
    logits (B, S, V/T) under the tensor axis: the log-sum-exp from the MAX
    of the ranks' maxes (no grad: it cancels) and the SUM of their sums of
    exps, the target logit SUMmed (zero off the rank's rows); both sums
    through from_tensor_region, whose backward is the identity (the loss is
    whole on every rank). The grad of the local logits is then the local
    part of softmax - onehot."""
    logits = logits[:, :-1, :].float()
    targets = labels[:, 1:].long()
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    n = logits.shape[-1]
    local = safe - mesh.tensor_index * n
    here = (local >= 0) & (local < n)
    m = tensor_all_reduce(logits.detach().amax(dim=-1), mesh, "max")
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    st = from_tensor_region(torch.stack([se, torch.where(here, picked, torch.zeros_like(picked))]),
                            mesh)
    tok_loss = torch.where(valid, m + torch.log(st[0]) - st[1], torch.zeros_like(m))
    if denom is None:
        denom = torch.clamp(valid.sum(), min=1)
    return tok_loss.sum() / denom.reshape(())


def chunked_causal_lm_loss_q8(hidden: torch.Tensor, head_wq: torch.Tensor,
                              head_sw: torch.Tensor, labels: torch.Tensor,
                              vocab_chunk: int = 4096,
                              denom: Optional[torch.Tensor] = None, tensor=None) -> torch.Tensor:
    """chunked_causal_lm_loss over an int8 frozen head (head_wq (V, D)
    int8, head_sw (V,) fp32, train/convert.py build_q_head). The hidden
    states are row-quantized ONCE (not per chunk) and the LSE stays fp32.
    Logit values are bitwise what the dense-path frozen_q8_linear head
    gives, so the chunked and dense q8 losses agree to fp32 reduction
    order. tensor: the mesh when head_wq / head_sw are this rank's (V/T,
    D) / (V/T,) vocabulary rows: the fp32 hidden states pass through
    to_tensor_region here, so the ranks' grad parts are summed in fp32, as
    JAX sums its fp32 product before the cast (module notes)."""
    d = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, d).float()       # (T, D)
    offset = 0
    if tensor is not None:
        h = to_tensor_region(h, tensor)
        offset = tensor.tensor_index * head_wq.shape[0]
    xq, sx = row_quant(h.detach())
    return _ChunkedLSELoss.apply(h, labels[:, 1:], vocab_chunk, None, head_wq, head_sw, xq, sx,
                                 denom, tensor, offset)
