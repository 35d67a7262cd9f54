"""Block-sparse linear as a torch.autograd.Function (matrix mode, bf16 or
fp32) — twin of `sparse_matrix_tuning_tpu.ops.sparse_linear.smt_linear`.

  * forward is ONE dense matmul `y = x @ W.T`: the dense weight already
    holds the current block values (the sparse step scatters them in once
    per optimizer step — the scatter-at-update invariant), so the trainable
    blocks are an input only for autograd's sake.
  * backward returns grad_x = g @ W and a gradient for the selected
    256x256 blocks only, (n, 256, 256) in the blocks' dtype. The frozen W
    gets None: no dense weight-sized cotangent is ever allocated.
  * grad-blocks implementations: "kernel" (K1, ops/cuda/block_grad.py, on
    CUDA tensors) or "oracle" (its plain PyTorch version); "auto" picks by
    the tensor's device.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.block_grad import (
    block_grad, block_grad_plain as _block_grad_weight_plain)
from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, key_str


def _resolve_impl(impl: str, device) -> str:
    """"auto" -> "kernel" for CUDA tensors, "oracle" otherwise. An explicit
    "kernel" on a non-CUDA tensor raises: there is no fallback."""
    device = torch.device(device)
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "oracle"
    if impl == "kernel":
        if device.type != "cuda":
            raise ValueError(f"sparse_impl='kernel' needs CUDA tensors, got {device}")
        return impl
    if impl == "oracle":
        return impl
    raise ValueError(f"unknown sparse_impl {impl!r}")


class _SMTLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, w, rb, cb, impl: str):
        ctx.save_for_backward(x, w, rb, cb)
        ctx.impl = impl
        ctx.blocks_dtype = blocks.dtype
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w, rb, cb = ctx.saved_tensors
        grad_x = torch.matmul(g, w) if ctx.needs_input_grad[0] else None
        grad_blocks = None
        if ctx.needs_input_grad[1]:
            g2 = g.reshape(-1, g.shape[-1]).contiguous()
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            if ctx.impl == "kernel":
                grad_blocks = block_grad(g2, x2, rb, cb)
            else:
                grad_blocks = _block_grad_weight_plain(g2, x2, rb, cb)
            grad_blocks = grad_blocks.to(ctx.blocks_dtype)
        return grad_x, grad_blocks, None, None, None, None


def smt_linear(x: torch.Tensor, blocks: torch.Tensor, w: torch.Tensor,
               lp: LinearPlan, impl: str = "oracle",
               index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """y = x @ W.T with gradients routed to the selected blocks only.

    x: (..., in_dim); blocks: (n_blocks, 256, 256) trainable (fp32 master);
    w: (out_dim, in_dim) dense weight ALREADY containing the current block
    values, frozen (no gradient). index: the plan's cached (rb, cb) int32
    tensors on x's device (built from lp when omitted)."""
    impl = _resolve_impl(impl, x.device)
    if index is None:
        index = (torch.as_tensor(lp.row_blocks(), device=x.device),
                 torch.as_tensor(lp.col_blocks(), device=x.device))
    rb, cb = index
    return _SMTLinear.apply(x, blocks, w, rb, cb, impl)


def make_sparse_linear_dispatch(plan, trainable: Mapping[str, torch.Tensor],
                                impl: str = "auto"):
    """The `linear(x, w, module, layer)` hook for models.llama.forward:
    planned linears compute through smt_linear, everything else is a plain
    dense matmul."""
    if plan.mode != "matrix":
        raise NotImplementedError(f"plan mode {plan.mode!r}: only matrix mode is ported")

    def linear(x, w, module: str, layer_idx: int):
        ks = key_str(module, layer_idx)
        lp = plan.linears.get(ks)
        if lp is None:
            return torch.matmul(x, w.t())
        return smt_linear(x, trainable[ks], w, lp, impl,
                          index=plan.block_index(ks, x.device, torch.int32))
    return linear
