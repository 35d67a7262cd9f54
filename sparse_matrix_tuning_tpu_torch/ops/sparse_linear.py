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

Under the tensor axis (`smt_linear_dyn(tensor=)`) the frozen base is this
rank's slice of the layer's weight (a column-parallel one its output rows,
a row-parallel one its input columns; int8: wq and sw as
`smt_linear_q8(tensor=)` takes them), and the layer's schedule is the
rank's window (`dyn_schedule(tensor=)`): the valid entries whose row
block (column-parallel) or column block (row-parallel) meets the slice,
picked by `valid` first (a padded entry may share a valid one's
coordinates), at their coordinates in the block-aligned window around
it. K5 and K1 run on them through zero-padded panels where a block
straddles the slice, as `smt_linear_q8(tensor=)` runs them, and the block
grads land at the entries' positions in the padded stack: each rank's
parts of the valid entries, zero elsewhere, which the step sums over the
tensor group. A rank whose window holds no entry launches neither and
joins the base product's collectives all the same.

Under the tensor axis (parallel/tensor.py) a planned linear holds this
rank's tensor slice of its weight: a column-parallel one its output rows,
a row-parallel one its input columns (`smt_linear(tensor=)`). The plan's
global (row, column) blocks are mapped into the block-aligned window
around the slice (parallel/fsdp.block_window); a block straddling the
slice's edge gets a zero-padded 256-row (or 256-column) panel, so K1's
256x256 contract is unchanged, and the grads of the blocks this rank
touches are its parts of them: summed over the tensor group (the
windows are disjoint, so the sum is their concatenation), they are the
blocks' grads, which the step does once per step (train/steps.py).

Over the int8 base under the tensor axis (`smt_linear_q8(tensor=)`,
`frozen_q8_linear(tensor=, split=)`) wq and sw are the rank's slices
(a row-parallel sw whole) and base whole. K5 corrects only the window's
blocks, each (blocks - base)[sel], through zero-padded panels where a
block straddles the slice: a column-parallel linear adds its forward
correction into a panel of output rows and reads g from one in its
backward, a row-parallel one reads x from a panel of input columns and
adds its grad_x correction into one. A row that lies across the ranks (a
row-parallel x, a column-parallel g * sw) is row-quantized with the whole
row's amax (ops/quant.py). A rank whose window holds no block joins every
collective all the same.

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

Under the tensor axis (`tensor=`, a ChannelWindow built once on the host)
a channel linear computes on the rank's slice of its weight: a column-
parallel rank (its output rows, x whole) corrects and grads its rows of
the columns, a row-parallel rank (its input columns, x its columns, g
whole) the valid entries whose column lies in its slice, picked by
`valid` first (a padded entry repeats a valid one's column, which would
count twice). The columns' grads are the rank's parts, zero elsewhere,
summed over the tensor group by the step; over an int8 base the row
that lies across the ranks takes the whole row's amax, as the block
linears'.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.block_grad import (
    block_grad, block_grad_plain as _block_grad_weight_plain)
from sparse_matrix_tuning_tpu_torch.ops.cuda.correction import (
    CorrectionSchedule, block_correction, correction_schedule)
from sparse_matrix_tuning_tpu_torch.ops.quant import (
    dequantize_weight_int4, q4_matmul_t, q8_matmul, q8_matmul_t)
from sparse_matrix_tuning_tpu_torch.parallel.fsdp import (
    COL_PARALLEL, block_window, column_window)
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, LinearPlan, key_str


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


def _panel(t: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """t (T, m) placed at columns start.. of a zeroed (T, n) panel (t
    itself where it fills the panel)."""
    if start == 0 and t.shape[1] == n:
        return t.contiguous()
    out = t.new_zeros((t.shape[0], n))
    out[:, start:start + t.shape[1]] = t
    return out


def _windowed_correction(out2, src2, delta, sched: CorrectionSchedule, transpose: bool,
                         panel, into_panel: bool) -> torch.Tensor:
    """block_correction of out2 (a new tensor) by src2 and delta; with a
    tensor window's panel, through it: into a zero-padded panel of out2's
    columns (into_panel, then cut back) or from one of src2's. Returns
    the corrected out2."""
    if panel is None or not delta.shape[0]:
        return block_correction(out2, src2, delta, sched, transpose)
    if into_panel:
        out = _panel(out2, *panel)
        block_correction(out, src2, delta, sched, transpose)
        return out[:, panel[0]:panel[0] + out2.shape[1]].contiguous()
    return block_correction(out2, _panel(src2, *panel), delta, sched, transpose)


class _SMTLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, w, rb, cb, impl: str, sel=None, panels=(None, None)):
        ctx.save_for_backward(x, w, rb, cb, sel)
        ctx.impl, ctx.panels = impl, panels
        ctx.blocks_shape, ctx.blocks_dtype = blocks.shape, blocks.dtype
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w, rb, cb, sel = ctx.saved_tensors
        grad_x = torch.matmul(g, w) if ctx.needs_input_grad[0] else None
        grad_blocks = None
        if ctx.needs_input_grad[1]:
            if rb is None:   # no block touches this rank's slice
                grad_blocks = g.new_zeros(ctx.blocks_shape, dtype=ctx.blocks_dtype)
            else:
                rows, cols = ctx.panels
                if rows is not None:   # column-parallel: this rank's output rows
                    g = _panel(g.reshape(-1, g.shape[-1]), *rows)
                if cols is not None:   # row-parallel: its input columns
                    x = _panel(x.reshape(-1, x.shape[-1]), *cols)
                grad_blocks = _grad_blocks(g, x, rb, cb, ctx.impl, ctx.blocks_dtype)
                if sel is not None:
                    grad_blocks = grad_blocks.new_zeros(ctx.blocks_shape).index_copy_(
                        0, sel, grad_blocks)
        return grad_x, grad_blocks, None, None, None, None, None, None


def smt_linear(x: torch.Tensor, blocks: torch.Tensor, w: torch.Tensor,
               lp: LinearPlan, impl: str = "oracle",
               index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               tensor=None) -> torch.Tensor:
    """y = x @ W.T with gradients routed to the selected blocks only.

    x: (..., in_dim); blocks: (n_blocks, 256, 256) trainable (fp32 master);
    w: (out_dim, in_dim) dense weight ALREADY containing the current block
    values, frozen (no gradient). index: the plan's cached (rb, cb) int32
    tensors on x's device (built from lp when omitted).

    tensor: under the tensor axis (module notes), SMTPlan.tensor_window's
    (window, first) of this rank; w is then the rank's slice of the weight,
    whose first (row, column) of the full weight is `first`, and the block
    grads are the rank's parts (zero for the blocks it does not touch)."""
    impl = _resolve_impl(impl, x.device)
    if tensor is None:
        if index is None:
            index = (torch.as_tensor(lp.row_blocks(), device=x.device),
                     torch.as_tensor(lp.col_blocks(), device=x.device))
        return _SMTLinear.apply(x, blocks, w, *index, impl)
    window, first = tensor
    if window is None:
        return _SMTLinear.apply(x, blocks, w, None, None, impl)
    sel, rb, cb, (r_lo, r_n), (c_lo, c_n) = window
    panels = (None if r_n is None else (first[0] - r_lo * 256, r_n * 256),
              None if c_n is None else (first[1] - c_lo * 256, c_n * 256))
    if len(sel) == blocks.shape[0]:   # the window takes every block, in order
        sel = None
    return _SMTLinear.apply(x, blocks, w, rb, cb, impl, sel, panels)


# ---------------------------------------------------------------------------
# Matrix sparsity over an int8 frozen base
# ---------------------------------------------------------------------------

def _split(module: str) -> str:
    """Which dim of a layer linear the tensor axis splits: "out" for the
    column-parallel ones (their output rows), "in" for the row-parallel
    ones (their input columns)."""
    return "out" if module in COL_PARALLEL else "in"


class _SMTLinearQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, wq, sw, base, rb, cb, fwd_sched, bwd_sched, impl: str,
                tp=None):
        # tp (the tensor axis): (mesh, split, sel, panel), module notes
        mesh, split, sel, panel = tp if tp is not None else (None, None, None, None)
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        # (T, O), a new tensor; a row-parallel input's rows lie across the ranks
        y2 = q8_matmul_t(x2, wq, sw, tensor=mesh if split == "in" else None)
        delta = None
        if rb is not None:
            # y[:, rb] += x[:, cb] @ delta.T (into the window's panel of y, or from x's)
            delta = _window_delta(blocks, base, sel, x.dtype)
            y2 = _windowed_correction(y2, x2, delta, fwd_sched, True, panel, split == "out")
        ctx.save_for_backward(x2, wq, sw, delta, rb, cb, sel)
        ctx.bwd_sched, ctx.impl, ctx.tp = bwd_sched, impl, (mesh, split, panel)
        ctx.x_shape, ctx.blocks_shape, ctx.blocks_dtype = x.shape, blocks.shape, blocks.dtype
        return y2.reshape(*x.shape[:-1], y2.shape[1])

    @staticmethod
    def backward(ctx, g):
        x2, wq, sw, delta, rb, cb, sel = ctx.saved_tensors
        mesh, split, panel = ctx.tp
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        grad_x = grad_blocks = None
        if ctx.needs_input_grad[0]:
            # (T, I), a new tensor; a column-parallel g * sw row lies across the ranks
            gx2 = q8_matmul(g2, wq, sw, tensor=mesh if split == "out" else None)
            if rb is not None:
                # grad_x[:, cb] += g[:, rb] @ delta (into the window's panel of grad_x, or from g's)
                gx2 = _windowed_correction(gx2, g2, delta, ctx.bwd_sched, False, panel,
                                           split == "in")
            grad_x = gx2.reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            if rb is None:   # no block touches this rank's slice
                grad_blocks = g.new_zeros(ctx.blocks_shape, dtype=ctx.blocks_dtype)
            else:
                gg = _panel(g2, *panel) if split == "out" else g2
                xx = _panel(x2, *panel) if split == "in" else x2
                grad_blocks = _grad_blocks(gg, xx, rb, cb, ctx.impl, ctx.blocks_dtype)
                if sel is not None:
                    grad_blocks = grad_blocks.new_zeros(ctx.blocks_shape).index_copy_(
                        0, sel, grad_blocks)
        return grad_x, grad_blocks, None, None, None, None, None, None, None, None, None


def _window_delta(blocks, base, sel, dtype) -> torch.Tensor:
    """(blocks - base) of the blocks `sel` (every block where None), in
    `dtype`."""
    if sel is not None:
        blocks, base = blocks.index_select(0, sel), base.index_select(0, sel)
    return (blocks - base).to(dtype)


def smt_linear_q8(x: torch.Tensor, blocks: torch.Tensor, wq: torch.Tensor,
                  sw: torch.Tensor, base_blocks: torch.Tensor, lp: LinearPlan,
                  impl: str = "auto",
                  index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  schedules: Optional[Tuple[CorrectionSchedule, CorrectionSchedule]] = None,
                  tensor=None) -> torch.Tensor:
    """Block-sparse linear over an int8 frozen base (module notes).

    wq (O, I) int8, sw (O,) fp32, base_blocks (n, 256, 256) fp32: the
    dequantized frozen values of the selected blocks; all three frozen (no
    gradient). index / schedules: the plan's cached (rb, cb) int32 tensors
    and K5 schedules on x's device (built from lp when omitted).

    tensor: under the tensor axis, (mesh, window, first) with window and
    first SMTPlan.tensor_window's of this rank, and schedules
    SMTPlan.tensor_q8_schedules' (None where the window is): wq and sw are
    then the rank's slices (sw whole for a row-parallel linear), base_blocks
    whole. K5 corrects the window's blocks through zero-padded panels where
    a block straddles the slice, as smt_linear's K1 does; the output (a
    row-parallel linear's partial sum) and the block grads are the rank's
    parts, and the row quantization of a row that lies across the ranks
    takes the whole row's amax (ops/quant.py)."""
    impl = _resolve_impl(impl, x.device)
    if tensor is not None:
        mesh, window, first = tensor
        split = _split(lp.module)
        if window is None:
            tp = (mesh, split, None, None)
            return _SMTLinearQ8.apply(x, blocks, wq, sw, base_blocks, None, None, None, None,
                                      impl, tp)
        sel, rb, cb, (r_lo, r_n), (c_lo, c_n) = window
        panel = (first[0] - r_lo * 256, r_n * 256) if split == "out" else \
            (first[1] - c_lo * 256, c_n * 256)
        if len(sel) == blocks.shape[0]:   # the window takes every block, in order
            sel = None
        return _SMTLinearQ8.apply(x, blocks, wq, sw, base_blocks, rb, cb, *schedules, impl,
                                  (mesh, split, sel, panel))
    if index is None:
        index = (torch.as_tensor(lp.row_blocks(), device=x.device),
                 torch.as_tensor(lp.col_blocks(), device=x.device))
    if schedules is None:
        schedules = lp.q8_schedules(x.device)
    return _SMTLinearQ8.apply(x, blocks, wq, sw, base_blocks, *index, *schedules, impl)


class _FrozenQ8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, sw, mesh=None, split=None):
        ctx.save_for_backward(wq, sw)
        ctx.mesh, ctx.split = mesh, split
        return q8_matmul_t(x, wq, sw, tensor=mesh if split == "in" else None)

    @staticmethod
    def backward(ctx, g):
        wq, sw = ctx.saved_tensors
        grad_x = None
        if ctx.needs_input_grad[0]:
            grad_x = q8_matmul(g, wq, sw, tensor=ctx.mesh if ctx.split == "out" else None)
        return grad_x, None, None, None, None


def frozen_q8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, tensor=None,
                     split: Optional[str] = None) -> torch.Tensor:
    """y = x @ dequant(Wq).T for a fully-frozen linear (no selected blocks,
    e.g. o_proj, or the lm-head): int8 forward, int8 grad_input, no weight
    gradient. Straight-through: autograd through round/clip would give zero
    input gradients.

    tensor (the mesh) and split: under the tensor axis, wq and sw are this
    rank's output rows (split "out": a column-parallel linear, or the int8
    head's vocabulary rows; the backward's g * sw rows lie across the ranks)
    or its input columns (split "in": a row-parallel linear, x the rank's
    columns; the forward's rows lie across the ranks). The result is the
    rank's output slice or partial sum, as the dense linear's is."""
    return _FrozenQ8Linear.apply(x, wq, sw, tensor, split)


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

def _base_matmul(x: torch.Tensor, frozen: Mapping[str, torch.Tensor], tensor=None
                 ) -> torch.Tensor:
    """The frozen base's product: {"w4", "s4"} int4, {"wq", "sw"} int8,
    {"w"} dense. tensor: the mesh where x's rows lie across the tensor
    group (a row-parallel int8 linear: the whole row's amax)."""
    if "w4" in frozen:
        return q4_matmul_t(x, frozen["w4"], frozen["s4"])
    if "wq" in frozen:
        return q8_matmul_t(x, frozen["wq"], frozen["sw"], tensor=tensor)
    return torch.matmul(x, frozen["w"].t())


def _base_matmul_T(g: torch.Tensor, frozen: Mapping[str, torch.Tensor], tensor=None
                   ) -> torch.Tensor:
    """grad_x of the frozen base: K4's g form over int8 (tensor: the mesh
    where g * sw's rows lie across the group, a column-parallel linear);
    over int4 (a decode base) and a dense base, a matmul with the
    (dequantized) weight."""
    if "w4" in frozen:
        return torch.matmul(g, dequantize_weight_int4(frozen["w4"], frozen["s4"], g.dtype))
    if "wq" in frozen:
        return q8_matmul(g, frozen["wq"], frozen["sw"], tensor=tensor)
    return torch.matmul(g, frozen["w"])


class DynSchedule(NamedTuple):
    """What one layer's padded block coordinates give the kernels, built once
    (a host sync) and reused every step: the positions of the entries the
    kernels run on and their coordinates on the device, K5's forward
    schedule (out = rb, in = cb) and its grad_input schedule (out = cb, in =
    rb). Under the tensor axis (dyn_schedule(tensor=)) the entries are the
    valid ones in the rank's window, at window coordinates, and `panel` /
    `split` place the window around the rank's slice."""
    n: int                 # padded count
    keep: torch.Tensor     # (k,) int64, the entries' positions in the padded stack
    rb: torch.Tensor       # (k,) int32
    cb: torch.Tensor       # (k,) int32
    fwd: CorrectionSchedule
    bwd: CorrectionSchedule
    n_valid: int           # the layer's valid entries, which come first
    panel: Optional[Tuple[int, int]] = None   # the window's (first column, width) of the slice
    split: Optional[str] = None               # "out" (column-parallel) or "in" (row-parallel)


def _valid_coords(rb, cb, valid):
    """The valid entries' positions and coordinates, on the host."""
    keep = torch.nonzero(valid.to("cpu")).reshape(-1)
    return keep, rb.to("cpu")[keep], cb.to("cpu")[keep]


def dyn_schedule(rb, cb, valid, device, tensor=None) -> DynSchedule:
    """The DynSchedule of one layer's (n,) rb / cb / valid on `device`.

    tensor: (split, first, width) of this rank's slice of the layer's
    weight under the tensor axis: split "out", its output rows first ..
    first + width (a column-parallel linear), or "in", its input columns (a
    row-parallel one). The schedule then holds the valid entries whose row
    (or column) block meets the slice (fsdp.block_window over the valid
    coordinates: a padded entry never enters a window), at their
    coordinates in the block-aligned window around it, and the window's
    panel."""
    keep, rbk, cbk = _valid_coords(rb, cb, valid)
    n_valid, panel, split = int(keep.numel()), None, None
    if tensor is not None:
        split, first, width = tensor
        extent = (first, width)
        win = block_window(rbk.numpy().astype(np.int64), cbk.numpy().astype(np.int64),
                           extent if split == "out" else None,
                           extent if split == "in" else None, "cpu")
        if win is None:
            keep, rbk, cbk = keep[:0], rbk[:0], cbk[:0]
        else:
            sel, rbk, cbk, (r_lo, r_n), (c_lo, c_n) = win
            keep = keep[sel]
            lo, n = (r_lo, r_n) if split == "out" else (c_lo, c_n)
            panel = (first - lo * BLOCK, n * BLOCK)
    return DynSchedule(int(valid.shape[0]), keep.to(device),
                       rbk.to(device, torch.int32), cbk.to(device, torch.int32),
                       correction_schedule(rbk.numpy(), cbk.numpy(), device),
                       correction_schedule(cbk.numpy(), rbk.numpy(), device),
                       n_valid, panel, split)


def _dyn_delta(blocks, base_blocks, keep, dtype) -> torch.Tensor:
    """(blocks - base) of the entries at `keep`, in `dtype`, contiguous:
    the padded entries' deltas are 0 and are left out."""
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
    def forward(ctx, x, blocks, base_blocks, frozen, sched: DynSchedule, mesh=None):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        split, panel = sched.split, sched.panel
        delta = _dyn_delta(blocks, base_blocks, sched.keep, x.dtype)
        # a new tensor; a row-parallel input's rows lie across the ranks
        y = _base_matmul(x2, frozen, mesh if split == "in" else None)
        # y[:, rb] += x[:, cb] @ delta^T (into the window's panel of y, or from x's)
        y = _windowed_correction(y, x2, delta, sched.fwd, True, panel, split == "out")
        keys = tuple(sorted(frozen))
        ctx.save_for_backward(x2, delta, *(frozen[k] for k in keys))
        ctx.keys, ctx.sched, ctx.x_shape, ctx.mesh = keys, sched, x.shape, mesh
        ctx.blocks_dtype = blocks.dtype
        return y.reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x2, delta, *frozen = ctx.saved_tensors
        sched = ctx.sched
        split, panel = sched.split, sched.panel
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        grad_x = grad_blocks = None
        if ctx.needs_input_grad[0]:
            # a new tensor; a column-parallel g * sw row lies across the ranks
            gx2 = _base_matmul_T(g2, dict(zip(ctx.keys, frozen)),
                                 ctx.mesh if split == "out" else None)
            # grad_x[:, cb] += g[:, rb] @ delta (into the window's panel of grad_x, or from g's)
            gx2 = _windowed_correction(gx2, g2, delta, sched.bwd, False, panel, split == "in")
            grad_x = gx2.reshape(ctx.x_shape)
        if ctx.needs_input_grad[1] and sched.keep.numel():
            # K1 over the (windowed) valid entries only; the padded ones'
            # grads are 0 (and None, autograd's zero, where it runs on none)
            gg = _panel(g2, *panel) if split == "out" else g2
            xx = _panel(x2, *panel) if split == "in" else x2
            gb = block_grad(gg, xx, sched.rb, sched.cb).to(ctx.blocks_dtype)
            if gb.shape[0] == sched.n:   # every entry: keep is 0..n-1
                grad_blocks = gb
            else:
                grad_blocks = gb.new_zeros((sched.n, *gb.shape[1:])).index_copy_(
                    0, sched.keep, gb)
        return grad_x, grad_blocks, None, None, None, None


def smt_linear_dyn(x, blocks, rb, cb, valid, frozen, base_blocks, correction=None,
                   schedule: Optional[DynSchedule] = None, tensor=None):
    """Block-sparse linear over a frozen base with one layer's padded block
    coordinates (module notes): blocks / base_blocks (n, 256, 256), rb / cb
    (n,) int, valid (n,) bool; frozen {"w4", "s4"}, {"wq", "sw"} or {"w"}.
    Gradients go to x and blocks (a padded entry's is 0), as JAX's custom
    VJP gives them: grad_x = base_T(g) + K5 with rb / cb swapped, the block
    grads K1 over the valid entries.

    schedule: the layer's DynSchedule (built here when omitted, which costs
    a host sync: a training step passes the one its state holds).
    correction: a decode's precomputed `dyn_correction(...)` pair, in
    place of the schedule; it has no backward.

    tensor (the mesh): under the tensor axis (module notes), frozen is this
    rank's slice of the layer's weight and schedule its window
    (dyn_schedule(tensor=), which attach_schedules builds); the output (a
    row-parallel linear's partial sum) and the block grads are the rank's
    parts."""
    if tensor is not None and (schedule is None or schedule.split is None):
        raise ValueError("smt_linear_dyn(tensor=): pass the rank's windowed DynSchedule "
                         "(dyn_schedule(tensor=), scan_phase.attach_schedules)")
    if correction is not None:
        if torch.is_grad_enabled() and (x.requires_grad or blocks.requires_grad):
            raise ValueError("smt_linear_dyn: a precomputed decode correction has no "
                             "backward; pass the layer's DynSchedule to train")
        return _dyn_forward(x.reshape(-1, x.shape[-1]).contiguous(), frozen,
                            *correction).reshape(*x.shape[:-1], -1)
    if schedule is None:
        schedule = dyn_schedule(rb, cb, valid, x.device)
    return _SMTLinearDyn.apply(x, blocks, base_blocks, frozen, schedule, tensor)


# ---------------------------------------------------------------------------
# Channel sparsity
# ---------------------------------------------------------------------------

class ChannelWindow(NamedTuple):
    """A channel linear's tensor slice under the tensor axis: split "out"
    (a column-parallel linear: its output rows first .. first + width) or
    "in" (a row-parallel one: its input columns), and for "in" the entries
    whose column lies in the slice, picked among the valid ones: their
    positions among the (n,) columns (`sel`) and their columns in the
    slice (`loc`), int64 on the device. Built once, on the host
    (SMTPlan.channel_tensor_window, scan_phase.attach_schedules)."""
    split: str
    first: int
    width: int
    sel: Optional[torch.Tensor] = None
    loc: Optional[torch.Tensor] = None


def channel_window(ci, valid, device, tensor) -> ChannelWindow:
    """The ChannelWindow of the (n,) input channels ci (valid: (n,) bool,
    or None where every entry is valid) on `device`, for tensor = (split,
    first, width) of the rank's slice of the weight. A padded entry
    repeats a valid one's channel: the valid entries are picked before
    the window (fsdp.column_window), so the owner adds each column
    once."""
    split, first, width = tensor
    if split == "out":
        return ChannelWindow(split, first, width)
    ci = np.asarray(ci, np.int64).reshape(-1)
    pos = np.nonzero(np.ones(len(ci), bool) if valid is None else np.asarray(valid, bool))[0]
    got = column_window(ci[pos], (first, width), "cpu")
    sel, loc = (np.zeros(0, np.int64),) * 2 if got is None else \
        (pos[got[0].numpy()], got[1].numpy())
    return ChannelWindow(split, first, width, torch.as_tensor(sel, device=device),
                         torch.as_tensor(loc, device=device))


def _grad_cols(g2: torch.Tensor, x_sel: torch.Tensor) -> torch.Tensor:
    """g^T @ x[:, ci] with an fp32 output: (O, n)."""
    return torch.matmul(g2.t().float(), x_sel.float())


def _window_grad_cols(g2, x2, ci, window: Optional[ChannelWindow], shape, valid=None):
    """The columns' grads g^T @ x[:, ci], fp32 (O, n), times valid where
    given. Under the tensor axis (window) the rank's part of them, zero
    elsewhere: a column-parallel window's rows (g2 holds its output rows,
    x2 is whole), a row-parallel one's entries (x2 holds its input
    columns, ci their columns there, g2 is whole)."""
    if window is not None and window.split == "in":
        out = g2.new_zeros(shape, dtype=torch.float32)
        if window.sel.numel():
            out.index_copy_(1, window.sel, _grad_cols(g2, x2.index_select(1, ci)))
        return out
    gc = _grad_cols(g2, x2.index_select(1, ci))
    if valid is not None:
        gc = gc * valid.to(gc.dtype)[None, :]
    if window is None:
        return gc
    out = gc.new_zeros(shape)
    out[window.first:window.first + window.width] = gc
    return out


class _SMTChannelLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cols, w, ci, window=None):
        ctx.save_for_backward(x, w, ci)
        ctx.cols_dtype, ctx.cols_shape, ctx.window = cols.dtype, cols.shape, window
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w, ci = ctx.saved_tensors
        grad_x = torch.matmul(g, w) if ctx.needs_input_grad[0] else None
        grad_cols = None
        if ctx.needs_input_grad[1]:
            window = ctx.window
            ci = ci if window is None or window.split == "out" else window.loc
            grad_cols = _window_grad_cols(g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1]),
                                          ci, window, ctx.cols_shape).to(ctx.cols_dtype)
        return grad_x, grad_cols, None, None, None


def smt_channel_linear(x: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                       lp: LinearPlan, index: Optional[torch.Tensor] = None,
                       tensor: Optional[ChannelWindow] = None) -> torch.Tensor:
    """y = x @ W.T with gradients routed to the selected input-channel
    columns only.

    cols: (out_dim, n_channels) trainable columns W[:, lp.channels] (fp32
    master); w: (out_dim, in_dim) dense weight ALREADY containing the
    current columns, frozen (no gradient). index: the plan's cached int64
    channel tensor on x's device (built from lp when omitted).

    tensor: under the tensor axis, SMTPlan.channel_tensor_window's
    ChannelWindow of this rank; w is then the rank's slice of the weight
    (its output rows, or its input columns and x the rank's columns), and
    the columns' grads are the rank's parts (module notes), which the step
    sums over the tensor group."""
    if index is None:
        index = torch.as_tensor(lp.channels, dtype=torch.int64, device=x.device)
    return _SMTChannelLinear.apply(x, cols, w, index, tensor)


def chan_delta(cols, base_cols, valid, dtype) -> torch.Tensor:
    """(cols - base_cols) * valid in `dtype`: (O, n), 0 at padded entries."""
    return ((cols - base_cols) * valid.to(cols.dtype)[None, :]).to(dtype)


def _chan_forward(x2, frozen, delta, ci, tensor=None) -> torch.Tensor:
    y = _base_matmul(x2, frozen, tensor)
    if not delta.shape[1]:   # a row-parallel window without an entry
        return y
    corr = torch.matmul(x2.index_select(1, ci).float(), delta.float().t())   # (T, O) fp32
    return corr.add_(y).to(y.dtype)


def _chan_window_delta(cols, base_cols, ci, valid, window: Optional[ChannelWindow],
                       dtype):
    """(the delta this rank's slice corrects by, the columns of x it reads):
    every entry's (O, n) delta and ci; a column-parallel window's rows of
    it; a row-parallel window's entries, at their columns in the slice."""
    if window is None:
        return chan_delta(cols, base_cols, valid, dtype), ci
    if window.split == "out":
        rows = slice(window.first, window.first + window.width)
        return chan_delta(cols[rows], base_cols[rows], valid, dtype), ci
    sel = window.sel
    return (chan_delta(cols.index_select(1, sel), base_cols.index_select(1, sel),
                       valid.index_select(0, sel), dtype), window.loc)


class _SMTChannelLinearDyn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cols, base_cols, ci, valid, frozen, window=None, mesh=None):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        split = None if window is None else window.split
        delta, ci_x = _chan_window_delta(cols, base_cols, ci, valid, window, x.dtype)
        # a row-parallel input's rows lie across the ranks
        y = _chan_forward(x2, frozen, delta, ci_x, mesh if split == "in" else None)
        keys = tuple(sorted(frozen))
        ctx.save_for_backward(x2, delta, ci_x, valid, *(frozen[k] for k in keys))
        ctx.keys, ctx.x_shape, ctx.cols_dtype = keys, x.shape, cols.dtype
        ctx.cols_shape, ctx.window, ctx.mesh = cols.shape, window, mesh
        return y.reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x2, delta, ci, valid, *frozen = ctx.saved_tensors
        window = ctx.window
        split = None if window is None else window.split
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        grad_x = grad_cols = None
        if ctx.needs_input_grad[0]:
            # (T, I), a new tensor; a column-parallel g * sw row lies across the ranks
            gx = _base_matmul_T(g2, dict(zip(ctx.keys, frozen)),
                                ctx.mesh if split == "out" else None)
            if delta.shape[1]:
                gd = torch.matmul(g2.float(), delta.float())             # (T, n) fp32
                gx = gx.float().index_add_(1, ci, gd).to(gx.dtype)
            grad_x = gx.reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            grad_cols = _window_grad_cols(g2, x2, ci, window, ctx.cols_shape,
                                          valid).to(ctx.cols_dtype)
        return grad_x, grad_cols, None, None, None, None, None, None


def smt_channel_linear_dyn(x, cols, ci, valid, frozen, base_cols, correction=None,
                           window: Optional[ChannelWindow] = None, tensor=None):
    """Channel-sparse linear over a frozen base with one layer's padded
    channel indices (module notes): cols / base_cols (O, n), ci (n,) int,
    valid (n,) bool; frozen {"w4", "s4"}, {"wq", "sw"} or {"w"}. Gradients
    go to x and cols (a padded entry's is 0), as JAX's custom VJP gives
    them. Reads no index on the host: a step makes no host-device sync.

    correction: a decode's precomputed `chan_correction(...)` pair (the
    delta in x's dtype, ci), constant over the decode; it has no
    backward.

    tensor (the mesh) and window (the layer's ChannelWindow of this rank,
    scan_phase.attach_schedules): under the tensor axis, frozen is the
    rank's slice of the layer's weight (int8: wq and sw as
    smt_linear_q8(tensor=) takes them, the whole row's amax where a row
    lies across the ranks); a column-parallel rank corrects its output
    rows, a row-parallel one the entries in its input columns (none, where
    its window holds none: it joins the base product's collectives all
    the same); the output (a row-parallel linear's partial sum) and the
    columns' grads are the rank's parts."""
    if tensor is not None and window is None:
        raise ValueError("smt_channel_linear_dyn(tensor=): pass the layer's ChannelWindow "
                         "(scan_phase.attach_schedules)")
    if correction is not None:
        if torch.is_grad_enabled() and (x.requires_grad or cols.requires_grad):
            raise ValueError("smt_channel_linear_dyn: a precomputed decode correction has no "
                             "backward")
        return _chan_forward(x.reshape(-1, x.shape[-1]).contiguous(), frozen,
                             *correction).reshape(*x.shape[:-1], -1)
    return _SMTChannelLinearDyn.apply(x, cols, base_cols, ci, valid, frozen, window, tensor)


@torch.no_grad()
def chan_correction(cols, base_cols, ci, valid, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's decode correction in channel mode: (delta in `dtype`,
    ci), built once by eval/generate.decode_params_from_scan."""
    return chan_delta(cols, base_cols, valid, dtype), ci


# ---------------------------------------------------------------------------
# Model dispatch
# ---------------------------------------------------------------------------

def make_sparse_linear_dispatch(plan, trainable: Mapping[str, torch.Tensor],
                                impl: str = "auto", qweights=None, tensor=None):
    """The `linear(x, w, module, layer)` hook for models.llama.forward:
    planned linears compute through smt_linear (matrix mode) or
    smt_channel_linear (channel mode), everything else is a plain dense
    matmul.

    qweights (int8 frozen base, matrix mode): {"{layer}.{module}": {"wq",
    "sw"[, "base"]}} for every layer linear; planned linears then run the
    block-corrected q8 path, unplanned frozen ones the plain q8 path, and
    `w` is not read (it may be the offloaded weight's placeholder).

    tensor (the tensor axis): the mesh; `w` (and the q leaves) are then
    this rank's tensor slices, planned linears compute through
    smt_linear's (or, over the int8 base, smt_linear_q8's) tensor window,
    in channel mode smt_channel_linear's, and unplanned int8 ones through
    frozen_q8_linear's tensor form."""
    if plan.mode == "channel" and qweights is not None:
        raise ValueError("channel mode over an int8 base runs over the scan state "
                         "(train/scan_phase.py), not this dispatch")

    def linear(x, w, module: str, layer_idx: int):
        ks = key_str(module, layer_idx)
        lp = plan.linears.get(ks)
        qw = qweights.get(ks) if qweights is not None else None
        if lp is None:
            if qw is not None:
                return frozen_q8_linear(x, qw["wq"], qw["sw"], tensor,
                                        None if tensor is None else _split(module))
            return torch.matmul(x, w.t())
        if plan.mode == "channel":
            window = None if tensor is None else plan.channel_tensor_window(
                ks, x.device, tensor.tensor_index, tensor.tensor)
            return smt_channel_linear(x, trainable[ks], w, lp,
                                      index=plan.channel_index(ks, x.device), tensor=window)
        if tensor is not None:
            rank = (x.device, tensor.tensor_index, tensor.tensor)
            window = plan.tensor_window(ks, *rank)
            if qw is not None:   # the int8 base first: `w` is not what it computes over
                return smt_linear_q8(x, trainable[ks], qw["wq"], qw["sw"], qw["base"], lp, impl,
                                     schedules=plan.tensor_q8_schedules(ks, *rank),
                                     tensor=(tensor, *window))
            return smt_linear(x, trainable[ks], w, lp, impl, tensor=window)
        index = plan.block_index(ks, x.device, torch.int32)
        if qw is not None:
            return smt_linear_q8(x, trainable[ks], qw["wq"], qw["sw"], qw["base"], lp, impl,
                                 index=index, schedules=plan.q8_schedules(ks, x.device))
        return smt_linear(x, trainable[ks], w, lp, impl, index=index)
    return linear
