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

Over an int8 frozen base (`smt_linear_q8`, `frozen_q8_linear`; twins of
the JAX functions of the same names) the dense weight is quantized once
(ops/quant.py) and the sparse phase computes

    y      = q8(x) @ Wq.T * sx * sw  +  sum_j  x[:, cb_j] @ delta_j.T
    grad_x = q8(g*sw) @ Wq * sg      +  sum_j  g[:, rb_j] @ delta_j
    delta_j = blocks_j - base_j,   base_j = dequant(Wq)[rb_j, cb_j]

so the SELECTED blocks see zero quantization error (W_eff[rb, cb] =
blocks exactly) and only the frozen rest carries int8 noise. The base
products are K4 (ops/cuda/q8_matmul.py), both corrections K5
(ops/cuda/correction.py), each on CUDA tensors, their plain versions on
CPU tensors; the block gradient is the same K1 formula as above.

Decode over the stacked scan state (`smt_linear_dyn`, forward only; twin
of the JAX function of that name) takes the block coordinates of one
layer, padded to the module's largest count with `valid` marking the real
ones, and a frozen base that is int4 ({"w4", "s4"}: K6 through
ops/quant.q4_matmul_t), int8 ({"wq", "sw"}: K4) or dense ({"w"}):

    y = base(x) + sum_j x[:, cb_j] @ delta_j^T   at rows rb_j
    delta_j = (blocks_j - base_j) * valid_j, in x's dtype

The correction is K5 over the valid entries only (a padded entry's delta
is 0). JAX's decode adds the entries one by one, rounding to the output
dtype after each (its "oracle" chain, `_dyn_correction`); K5 rounds once
per out block. In fp32 the two differ by a few ulps of the output, far
below the tests' tolerances.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.block_grad import (
    block_grad, block_grad_plain as _block_grad_weight_plain)
from sparse_matrix_tuning_tpu_torch.ops.cuda.correction import (
    CorrectionSchedule, block_correction, correction_schedule)
from sparse_matrix_tuning_tpu_torch.ops.quant import (
    dequantize_weight_int4, q4_matmul_t, q8_matmul, q8_matmul_t)
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


def _grad_blocks(g, x, rb, cb, impl: str, dtype) -> torch.Tensor:
    """grad_blocks[j] = g[:, rb_j]^T @ x[:, cb_j], (n, 256, 256) in `dtype`."""
    g2 = g.reshape(-1, g.shape[-1]).contiguous()
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fn = block_grad if impl == "kernel" else _block_grad_weight_plain
    return fn(g2, x2, rb, cb).to(dtype)


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
            grad_blocks = _grad_blocks(g, x, rb, cb, ctx.impl, ctx.blocks_dtype)
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


# ---------------------------------------------------------------------------
# Matrix sparsity over an int8 frozen base
# ---------------------------------------------------------------------------

class _SMTLinearQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, wq, sw, base, rb, cb, fwd_sched, bwd_sched, impl: str):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y2 = q8_matmul_t(x2, wq, sw)                      # (T, O), a new tensor
        delta = (blocks - base).to(x.dtype)               # (n, 256, 256)
        # y[:, rb] += x[:, cb] @ delta.T, in place
        block_correction(y2, x2, delta, fwd_sched, transpose=True)
        ctx.save_for_backward(x, wq, sw, delta, rb, cb)
        ctx.bwd_sched = bwd_sched
        ctx.impl = impl
        ctx.blocks_dtype = blocks.dtype
        return y2.reshape(*x.shape[:-1], wq.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, wq, sw, delta, rb, cb = ctx.saved_tensors
        grad_x = grad_blocks = None
        if ctx.needs_input_grad[0]:
            g2 = g.reshape(-1, g.shape[-1]).contiguous()
            gx2 = q8_matmul(g2, wq, sw)                   # (T, I), a new tensor
            # grad_x[:, cb] += g[:, rb] @ delta, in place
            block_correction(gx2, g2, delta, ctx.bwd_sched)
            grad_x = gx2.reshape(x.shape)
        if ctx.needs_input_grad[1]:
            grad_blocks = _grad_blocks(g, x, rb, cb, ctx.impl, ctx.blocks_dtype)
        return grad_x, grad_blocks, None, None, None, None, None, None, None, None


def smt_linear_q8(x: torch.Tensor, blocks: torch.Tensor, wq: torch.Tensor,
                  sw: torch.Tensor, base_blocks: torch.Tensor, lp: LinearPlan,
                  impl: str = "auto",
                  index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  schedules: Optional[Tuple[CorrectionSchedule, CorrectionSchedule]] = None
                  ) -> torch.Tensor:
    """Block-sparse linear over an int8 frozen base (module notes).

    wq (O, I) int8, sw (O,) fp32, base_blocks (n, 256, 256) fp32: the
    dequantized frozen values of the selected blocks; all three frozen (no
    gradient). index / schedules: the plan's cached (rb, cb) int32 tensors
    and K5 schedules on x's device (built from lp when omitted)."""
    impl = _resolve_impl(impl, x.device)
    if index is None:
        index = (torch.as_tensor(lp.row_blocks(), device=x.device),
                 torch.as_tensor(lp.col_blocks(), device=x.device))
    if schedules is None:
        schedules = lp.q8_schedules(x.device)
    return _SMTLinearQ8.apply(x, blocks, wq, sw, base_blocks, *index, *schedules, impl)


class _FrozenQ8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, sw):
        ctx.save_for_backward(wq, sw)
        return q8_matmul_t(x, wq, sw)

    @staticmethod
    def backward(ctx, g):
        wq, sw = ctx.saved_tensors
        return (q8_matmul(g, wq, sw) if ctx.needs_input_grad[0] else None), None, None


def frozen_q8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(Wq).T for a fully-frozen linear (no selected blocks,
    e.g. o_proj, or the lm-head): int8 forward, int8 grad_input, no weight
    gradient. Straight-through: autograd through round/clip would give zero
    input gradients."""
    return _FrozenQ8Linear.apply(x, wq, sw)


class _FrozenQ4Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w4, s4):
        ctx.save_for_backward(w4, s4)
        return q4_matmul_t(x, w4, s4)

    @staticmethod
    def backward(ctx, g):
        w4, s4 = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return torch.matmul(g, dequantize_weight_int4(w4, s4, g.dtype)), None, None


def frozen_q4_linear(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant4(W).T for a fully-frozen linear over the int4 base
    (decode; ops/quant.py int4 notes). Straight-through input gradient
    against the dequantized weight, as in JAX; no weight gradient. The
    stacked form (JAX's frozen_q4_linear_stacked) is this function on the
    layer views w4s[l], s4s[l]."""
    return _FrozenQ4Linear.apply(x, w4, s4)


# ---------------------------------------------------------------------------
# Decode over the stacked scan state (forward of smt_linear_dyn)
# ---------------------------------------------------------------------------

def _base_matmul(x: torch.Tensor, frozen: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The frozen base's product: {"w4", "s4"} int4, {"wq", "sw"} int8,
    {"w"} dense."""
    if "w4" in frozen:
        return q4_matmul_t(x, frozen["w4"], frozen["s4"])
    if "wq" in frozen:
        return q8_matmul_t(x, frozen["wq"], frozen["sw"])
    return torch.matmul(x, frozen["w"].t())


def _dyn_delta(blocks, base_blocks, valid, dtype) -> torch.Tensor:
    return ((blocks - base_blocks) * valid.to(blocks.dtype)[:, None, None]).to(dtype)


def dyn_correction(blocks, base_blocks, rb, cb, valid, dtype, device
                   ) -> Tuple[torch.Tensor, CorrectionSchedule]:
    """One layer's forward correction: (delta of the valid entries, in
    `dtype`, contiguous; K5's schedule for them on `device`). Constant over
    a decode, so eval/generate.decode_params_from_scan builds it once."""
    keep = torch.nonzero(valid.to("cpu")).reshape(-1)
    delta = _dyn_delta(blocks, base_blocks, valid, dtype)[keep.to(blocks.device)]
    sched = correction_schedule(rb.to("cpu")[keep].numpy(), cb.to("cpu")[keep].numpy(), device)
    return delta.contiguous(), sched


def _dyn_forward(x, frozen, delta, sched) -> torch.Tensor:
    y = _base_matmul(x, frozen)
    y2 = y.reshape(-1, y.shape[-1])
    # y[:, rb] += x[:, cb] @ delta^T, in place (y is a new tensor)
    block_correction(y2, x.reshape(-1, x.shape[-1]).contiguous(), delta, sched, transpose=True)
    return y


def smt_linear_dyn(x, blocks, rb, cb, valid, frozen, base_blocks, correction=None):
    """Block-sparse linear over a frozen base with one layer's padded block
    coordinates (module notes), forward only: blocks / base_blocks (n,
    256, 256), rb / cb (n,) int, valid (n,) bool. correction: the
    precomputed `dyn_correction(...)` pair (built here when omitted).
    The backward waits for the continuation-training slice."""
    if torch.is_grad_enabled() and (x.requires_grad or blocks.requires_grad):
        raise NotImplementedError("smt_linear_dyn: the backward (continuation training from "
                                  "the scan state) is not ported; call it under no_grad")
    if correction is None:
        correction = dyn_correction(blocks, base_blocks, rb, cb, valid, x.dtype, x.device)
    return _dyn_forward(x, frozen, *correction)


# ---------------------------------------------------------------------------
# Model dispatch
# ---------------------------------------------------------------------------

def make_sparse_linear_dispatch(plan, trainable: Mapping[str, torch.Tensor],
                                impl: str = "auto", qweights=None):
    """The `linear(x, w, module, layer)` hook for models.llama.forward:
    planned linears compute through smt_linear, everything else is a plain
    dense matmul.

    qweights (int8 frozen base): {"{layer}.{module}": {"wq", "sw"[,
    "base"]}} for every layer linear; planned linears then run the
    block-corrected q8 path, unplanned frozen ones the plain q8 path, and
    `w` is not read (it may be the offloaded weight's placeholder)."""
    if plan.mode != "matrix":
        raise NotImplementedError(f"plan mode {plan.mode!r}: only matrix mode is ported")

    def linear(x, w, module: str, layer_idx: int):
        ks = key_str(module, layer_idx)
        lp = plan.linears.get(ks)
        qw = qweights.get(ks) if qweights is not None else None
        if lp is None:
            if qw is not None:
                return frozen_q8_linear(x, qw["wq"], qw["sw"])
            return torch.matmul(x, w.t())
        index = plan.block_index(ks, x.device, torch.int32)
        if qw is not None:
            return smt_linear_q8(x, trainable[ks], qw["wq"], qw["sw"], qw["base"], lp, impl,
                                 index=index, schedules=plan.q8_schedules(ks, x.device))
        return smt_linear(x, trainable[ks], w, lp, impl, index=index)
    return linear
