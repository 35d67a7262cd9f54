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

Over the stacked scan state (`smt_linear_dyn`, twin of the JAX custom
VJP of that name: continuation training and decode) a linear takes the
block coordinates of one layer, padded to the module's largest count with
`valid` marking the real ones, and a frozen base that is int4 ({"w4",
"s4"}: K6 through ops/quant.q4_matmul_t), int8 ({"wq", "sw"}: K4) or dense
({"w"}), which is never updated:

    y          = base(x) + sum_j x[:, cb_j] @ delta_j^T   at rows rb_j
    grad_x     = base_T(g) + sum_j g[:, rb_j] @ delta_j   at cols cb_j
    grad_j     = g[:, rb_j]^T @ x[:, cb_j] if valid_j, else 0
    delta_j    = (blocks_j - base_j) * valid_j, in x's dtype

Both corrections are K5 and the block grads K1, each over the valid entries
only (a padded entry's delta and grad are 0), from a schedule built once
per layer (`dyn_schedule`). JAX adds the entries one by one, rounding to
the output dtype after each (its "oracle" chain, `_dyn_correction`); K5
rounds once per out block. In fp32 the two differ by a few ulps of the
output, far below the tests' tolerances.

Channel mode (twins of the JAX `smt_channel_linear` and
`smt_channel_linear_dyn`) trains whole input COLUMNS W[:, ci] of a
linear, (O, n) fp32. `smt_channel_linear` computes through the dense
weight that already holds the current columns, as `smt_linear` does;
over the scan state's frozen base, `smt_channel_linear_dyn` computes

    y         = base(x) + x[:, ci] @ delta^T
    grad_x    = base_T(g) + (g @ delta) added into the columns ci
    grad_cols = g^T @ x[:, ci], times valid
    delta     = (cols - base_cols) * valid, in x's dtype

Its products are thin (n columns) and stay plain matmuls, as they are XLA
dot_generals in JAX; each has an fp32 output, as JAX asks for with
preferred_element_type, and the fp32 sums are added before the cast to
the output dtype. The column scatter of grad_x is `index_add_`: a padded
entry duplicates a valid one, and its delta and so its g @ delta are 0,
so it adds exact zeros.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

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
# The stacked scan state: smt_linear_dyn
# ---------------------------------------------------------------------------

def _base_matmul(x: torch.Tensor, frozen: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The frozen base's product: {"w4", "s4"} int4, {"wq", "sw"} int8,
    {"w"} dense."""
    if "w4" in frozen:
        return q4_matmul_t(x, frozen["w4"], frozen["s4"])
    if "wq" in frozen:
        return q8_matmul_t(x, frozen["wq"], frozen["sw"])
    return torch.matmul(x, frozen["w"].t())


def _base_matmul_T(g: torch.Tensor, frozen: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """grad_x of the frozen base: K4's g form over int8; over int4 (a decode
    base) and a dense base, a matmul with the (dequantized) weight."""
    if "w4" in frozen:
        return torch.matmul(g, dequantize_weight_int4(frozen["w4"], frozen["s4"], g.dtype))
    if "wq" in frozen:
        return q8_matmul(g, frozen["wq"], frozen["sw"])
    return torch.matmul(g, frozen["w"])


class DynSchedule(NamedTuple):
    """What one layer's padded block coordinates give the kernels, built once
    (a host sync) and reused every step: the positions of the valid entries
    and their coordinates on the device, K5's forward schedule (out = rb,
    in = cb) and its grad_input schedule (out = cb, in = rb)."""
    n: int                 # padded count
    keep: torch.Tensor     # (k,) int64, the valid entries' positions
    rb: torch.Tensor       # (k,) int32
    cb: torch.Tensor       # (k,) int32
    fwd: CorrectionSchedule
    bwd: CorrectionSchedule


def _valid_coords(rb, cb, valid):
    """The valid entries' positions and coordinates, on the host."""
    keep = torch.nonzero(valid.to("cpu")).reshape(-1)
    return keep, rb.to("cpu")[keep], cb.to("cpu")[keep]


def dyn_schedule(rb, cb, valid, device) -> DynSchedule:
    """The DynSchedule of one layer's (n,) rb / cb / valid on `device`."""
    keep, rbk, cbk = _valid_coords(rb, cb, valid)
    return DynSchedule(int(valid.shape[0]), keep.to(device),
                       rbk.to(device, torch.int32), cbk.to(device, torch.int32),
                       correction_schedule(rbk.numpy(), cbk.numpy(), device),
                       correction_schedule(cbk.numpy(), rbk.numpy(), device))


def _dyn_delta(blocks, base_blocks, keep, dtype) -> torch.Tensor:
    """(blocks - base) of the valid entries, in `dtype`, contiguous: the
    padded entries' deltas are 0 and are left out."""
    if not keep.numel():   # no launch for a layer without blocks of this module
        return blocks.new_empty((0, *blocks.shape[1:]), dtype=dtype)
    return (blocks.index_select(0, keep) - base_blocks.index_select(0, keep)).to(dtype)


@torch.no_grad()
def dyn_correction(blocks, base_blocks, rb, cb, valid, dtype, device
                   ) -> Tuple[torch.Tensor, CorrectionSchedule]:
    """One layer's forward correction: (delta of the valid entries, in
    `dtype`, contiguous; K5's schedule for them on `device`). Constant over
    a decode, so eval/generate.decode_params_from_scan builds it once."""
    keep, rbk, cbk = _valid_coords(rb, cb, valid)
    return (_dyn_delta(blocks, base_blocks, keep.to(blocks.device), dtype),
            correction_schedule(rbk.numpy(), cbk.numpy(), device))


def _dyn_forward(x2, frozen, delta, sched) -> torch.Tensor:
    y = _base_matmul(x2, frozen)
    # y[:, rb] += x[:, cb] @ delta^T, in place (y is a new tensor)
    return block_correction(y, x2, delta, sched, transpose=True)


class _SMTLinearDyn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, base_blocks, frozen, sched: DynSchedule):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        delta = _dyn_delta(blocks, base_blocks, sched.keep, x.dtype)
        y = _dyn_forward(x2, frozen, delta, sched.fwd)
        keys = tuple(sorted(frozen))
        ctx.save_for_backward(x2, delta, *(frozen[k] for k in keys))
        ctx.keys, ctx.sched, ctx.x_shape = keys, sched, x.shape
        ctx.blocks_dtype = blocks.dtype
        return y.reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x2, delta, *frozen = ctx.saved_tensors
        sched = ctx.sched
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        grad_x = grad_blocks = None
        if ctx.needs_input_grad[0]:
            gx2 = _base_matmul_T(g2, dict(zip(ctx.keys, frozen)))   # a new tensor
            # grad_x[:, cb] += g[:, rb] @ delta, in place
            block_correction(gx2, g2, delta, sched.bwd)
            grad_x = gx2.reshape(ctx.x_shape)
        if ctx.needs_input_grad[1] and sched.keep.numel():
            # K1 over the valid entries only; the padded ones' grads are 0
            # (and None, autograd's zero, where no entry is valid)
            gb = block_grad(g2, x2, sched.rb, sched.cb).to(ctx.blocks_dtype)
            if gb.shape[0] == sched.n:   # every entry valid: keep is 0..n-1
                grad_blocks = gb
            else:
                grad_blocks = gb.new_zeros((sched.n, *gb.shape[1:])).index_copy_(
                    0, sched.keep, gb)
        return grad_x, grad_blocks, None, None, None


def smt_linear_dyn(x, blocks, rb, cb, valid, frozen, base_blocks, correction=None,
                   schedule: Optional[DynSchedule] = None):
    """Block-sparse linear over a frozen base with one layer's padded block
    coordinates (module notes): blocks / base_blocks (n, 256, 256), rb / cb
    (n,) int, valid (n,) bool; frozen {"w4", "s4"}, {"wq", "sw"} or {"w"}.
    Gradients go to x and blocks (a padded entry's is 0), as JAX's custom
    VJP gives them: grad_x = base_T(g) + K5 with rb / cb swapped, the block
    grads K1 over the valid entries.

    schedule: the layer's DynSchedule (built here when omitted, which costs
    a host sync: a training step passes the one its state holds).
    correction: a decode's precomputed `dyn_correction(...)` pair, in
    place of the schedule; it has no backward."""
    if correction is not None:
        if torch.is_grad_enabled() and (x.requires_grad or blocks.requires_grad):
            raise ValueError("smt_linear_dyn: a precomputed decode correction has no "
                             "backward; pass the layer's DynSchedule to train")
        return _dyn_forward(x.reshape(-1, x.shape[-1]).contiguous(), frozen,
                            *correction).reshape(*x.shape[:-1], -1)
    if schedule is None:
        schedule = dyn_schedule(rb, cb, valid, x.device)
    return _SMTLinearDyn.apply(x, blocks, base_blocks, frozen, schedule)


# ---------------------------------------------------------------------------
# Channel sparsity
# ---------------------------------------------------------------------------

def _grad_cols(g2: torch.Tensor, x_sel: torch.Tensor) -> torch.Tensor:
    """g^T @ x[:, ci] with an fp32 output: (O, n)."""
    return torch.matmul(g2.t().float(), x_sel.float())


class _SMTChannelLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cols, w, ci):
        ctx.save_for_backward(x, w, ci)
        ctx.cols_dtype = cols.dtype
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w, ci = ctx.saved_tensors
        grad_x = torch.matmul(g, w) if ctx.needs_input_grad[0] else None
        grad_cols = None
        if ctx.needs_input_grad[1]:
            x_sel = x.reshape(-1, x.shape[-1]).index_select(1, ci)
            grad_cols = _grad_cols(g.reshape(-1, g.shape[-1]), x_sel).to(ctx.cols_dtype)
        return grad_x, grad_cols, None, None


def smt_channel_linear(x: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                       lp: LinearPlan, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W.T with gradients routed to the selected input-channel
    columns only.

    cols: (out_dim, n_channels) trainable columns W[:, lp.channels] (fp32
    master); w: (out_dim, in_dim) dense weight ALREADY containing the
    current columns, frozen (no gradient). index: the plan's cached int64
    channel tensor on x's device (built from lp when omitted)."""
    if index is None:
        index = torch.as_tensor(lp.channels, dtype=torch.int64, device=x.device)
    return _SMTChannelLinear.apply(x, cols, w, index)


def chan_delta(cols, base_cols, valid, dtype) -> torch.Tensor:
    """(cols - base_cols) * valid in `dtype`: (O, n), 0 at padded entries."""
    return ((cols - base_cols) * valid.to(cols.dtype)[None, :]).to(dtype)


def _chan_forward(x2, frozen, delta, ci) -> torch.Tensor:
    y = _base_matmul(x2, frozen)
    corr = torch.matmul(x2.index_select(1, ci).float(), delta.float().t())   # (T, O) fp32
    return corr.add_(y).to(y.dtype)


class _SMTChannelLinearDyn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cols, base_cols, ci, valid, frozen):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        delta = chan_delta(cols, base_cols, valid, x.dtype)
        y = _chan_forward(x2, frozen, delta, ci)
        keys = tuple(sorted(frozen))
        ctx.save_for_backward(x2, delta, ci, valid, *(frozen[k] for k in keys))
        ctx.keys, ctx.x_shape, ctx.cols_dtype = keys, x.shape, cols.dtype
        return y.reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x2, delta, ci, valid, *frozen = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        grad_x = grad_cols = None
        if ctx.needs_input_grad[0]:
            gx = _base_matmul_T(g2, dict(zip(ctx.keys, frozen)))        # (T, I), a new tensor
            gd = torch.matmul(g2.float(), delta.float())                 # (T, n) fp32
            grad_x = gx.float().index_add_(1, ci, gd).to(gx.dtype).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            grad_cols = _grad_cols(g2, x2.index_select(1, ci))
            grad_cols = (grad_cols * valid.to(grad_cols.dtype)[None, :]).to(ctx.cols_dtype)
        return grad_x, grad_cols, None, None, None, None


def smt_channel_linear_dyn(x, cols, ci, valid, frozen, base_cols, correction=None):
    """Channel-sparse linear over a frozen base with one layer's padded
    channel indices (module notes): cols / base_cols (O, n), ci (n,) int,
    valid (n,) bool; frozen {"w4", "s4"}, {"wq", "sw"} or {"w"}. Gradients
    go to x and cols (a padded entry's is 0), as JAX's custom VJP gives
    them. Reads no index on the host: a step makes no host-device sync.

    correction: a decode's precomputed `chan_correction(...)` pair (the
    delta in x's dtype, ci), constant over the decode; it has no
    backward."""
    if correction is not None:
        if torch.is_grad_enabled() and (x.requires_grad or cols.requires_grad):
            raise ValueError("smt_channel_linear_dyn: a precomputed decode correction has no "
                             "backward")
        return _chan_forward(x.reshape(-1, x.shape[-1]).contiguous(), frozen,
                             *correction).reshape(*x.shape[:-1], -1)
    return _SMTChannelLinearDyn.apply(x, cols, base_cols, ci, valid, frozen)


@torch.no_grad()
def chan_correction(cols, base_cols, ci, valid, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's decode correction in channel mode: (delta in `dtype`,
    ci), built once by eval/generate.decode_params_from_scan."""
    return chan_delta(cols, base_cols, valid, dtype), ci


# ---------------------------------------------------------------------------
# Model dispatch
# ---------------------------------------------------------------------------

def make_sparse_linear_dispatch(plan, trainable: Mapping[str, torch.Tensor],
                                impl: str = "auto", qweights=None):
    """The `linear(x, w, module, layer)` hook for models.llama.forward:
    planned linears compute through smt_linear (matrix mode) or
    smt_channel_linear (channel mode), everything else is a plain dense
    matmul.

    qweights (int8 frozen base, matrix mode): {"{layer}.{module}": {"wq",
    "sw"[, "base"]}} for every layer linear; planned linears then run the
    block-corrected q8 path, unplanned frozen ones the plain q8 path, and
    `w` is not read (it may be the offloaded weight's placeholder)."""
    if plan.mode == "channel" and qweights is not None:
        raise ValueError("channel mode over an int8 base runs over the scan state "
                         "(train/scan_phase.py), not this dispatch")

    def linear(x, w, module: str, layer_idx: int):
        ks = key_str(module, layer_idx)
        lp = plan.linears.get(ks)
        qw = qweights.get(ks) if qweights is not None else None
        if lp is None:
            if qw is not None:
                return frozen_q8_linear(x, qw["wq"], qw["sw"])
            return torch.matmul(x, w.t())
        if plan.mode == "channel":
            return smt_channel_linear(x, trainable[ks], w, lp, index=plan.channel_index(ks, x.device))
        index = plan.block_index(ks, x.device, torch.int32)
        if qw is not None:
            return smt_linear_q8(x, trainable[ks], qw["wq"], qw["sw"], qw["base"], lp, impl,
                                 index=index, schedules=plan.q8_schedules(ks, x.device))
        return smt_linear(x, trainable[ks], w, lp, impl, index=index)
    return linear
