"""Quantized frozen-weight matmul primitives (PyTorch twin of
`sparse_matrix_tuning_tpu.ops.quant`): the int8 base of the SMT sparse
phase, and the int4 base of decoding (second half of this module).

SMT freezes ~99% of the weights after conversion, so they are quantized
ONCE to int8 with per-output-channel scales, and every sparse-phase matmul
that touches them is an int8 product with the scales applied to its int32
result (K4, ops/cuda/q8_matmul.py).

Scales:
  * weights: per-output-channel symmetric, sw[o] = max|W[o,:]| / 127
  * activations: per-row (per-token) dynamic symmetric
  * y = x @ W.T:  y[t,o] = (xq @ Wq.T)[t,o] * sx[t] * sw[o]
  * g @ W (grad_input) folds sw into g BEFORE quantization:
      (g @ W)[t,i] = sum_o g[t,o] sw[o] Wq[o,i] = (rowquant(g*sw) @ Wq) * sg

Row quantization is its own kernel in front of K4 (ops/cuda/row_quant.py),
as XLA fuses it into one pass in front of the JAX package's kernel: a
row's scale needs the whole row before any tile of it can be quantized.

Under the tensor axis (parallel/tensor.py) a row may lie across the ranks
of the tensor group: the input of a row-parallel linear (o/down) in its
forward, and the g * sw of a column-parallel one (q/k/v/gate/up, the int8
head's vocabulary rows) in its backward. JAX computes those products
under GSPMD over the whole row, so its scale is the whole row's. There
(`tensor=` the mesh) the launch is split: each rank's row amax, their MAX
over the group (parallel/tensor.tensor_amax, exact), and the quantization
with it, so each rank's int8 values and scales are its slice of one
process's bit for bit. Each rank's K4 product is then a partial sum,
which the Megatron boundaries sum over the group in the output dtype
(JAX sums the int32 partials before the scale: the gap is that
rounding).
"""

from __future__ import annotations

import math

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.q4_matmul import GROUP, q4mm_t, unpack_planes
from sparse_matrix_tuning_tpu_torch.ops.cuda.q8_matmul import q8mm_g, q8mm_t
from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import reciprocal as _reciprocal
from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import row_amax, row_quant_amax
from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import row_quant as _row_quant_2d
from sparse_matrix_tuning_tpu_torch.parallel.tensor import tensor_amax


def row_quant(x: torch.Tensor, sw: torch.Tensor | None = None, tensor=None,
              amax: torch.Tensor | None = None):
    """Per-row symmetric int8 quantization over the last dim (of x * sw
    when sw is given: the g form's fold of the weight scales).

    Returns (xq int8, sx fp32 with shape (..., 1)); x / sx rounded (half to
    even) to [-127, 127]. The scale is amax times fp32(1/127), as XLA
    compiles the JAX package's division by 127 inside its jitted trainer
    and eval steps; x / sx stays a division, as it does there. On a CUDA
    tensor one kernel launch computes both (ops/cuda/row_quant.py); on
    the CPU its plain version.

    tensor: the mesh, when the row lies across its tensor group (module
    notes): the scale is that of the whole row (collective over the
    group). amax: the whole rows' amaxes (rows, 1) fp32, already reduced
    (the int8 head's chunks, ops/loss.py); not with tensor, which takes
    them itself."""
    if tensor is not None and amax is not None:
        raise ValueError("row_quant: give the whole rows' amax or the tensor mesh, not both")
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    if tensor is not None:
        amax = tensor_amax(row_amax(x2, sw), tensor)
    if amax is None:
        xq, sx = _row_quant_2d(x2, sw)
    else:
        xq, sx = row_quant_amax(x2, amax, sw)
    return xq.reshape(x.shape), sx.reshape(*x.shape[:-1], 1)


def _over(x: torch.Tensor, divisor: float, reciprocal: bool) -> torch.Tensor:
    """x / divisor, or x times the fp32 reciprocal of the constant divisor:
    what XLA compiles a division by a constant into under jit, so the
    port's values equal those JAX computes inside jit-compiled code. The
    reciprocal is made once per device, not copied to the device per call."""
    if reciprocal:
        return x * _reciprocal(divisor, x.device)
    return x / divisor


def quantize_weight(w: torch.Tensor, reciprocal: bool = False, tensor=None):
    """Per-output-channel symmetric int8 for an (out, in) weight.

    Returns (wq int8 (O, I), sw fp32 (O,)). reciprocal: the scale as JAX
    computes it under jit (quantize-on-load, train/scan_phase.py), amax
    times fp32(1/127), instead of eagerly, amax / 127 (the two differ in
    the last bit of some scales). tensor: the mesh, when w is this rank's
    input columns of rows that lie across its tensor group (a tied head's
    embedding): the amax is MAX-reduced over the group first
    (parallel/tensor.tensor_amax, exact), so wq is this rank's columns and
    sw the whole rows' scales of one process's quantization, bit for bit."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1)
    if tensor is not None:
        amax = tensor_amax(amax, tensor)
    sw = _over(torch.clamp(amax, min=1e-8), 127.0, reciprocal)
    wq = torch.clamp(torch.round(w32 / sw[:, None]), -127, 127).to(torch.int8)
    return wq, sw


def dequantize_weight(wq: torch.Tensor, sw: torch.Tensor, dtype=torch.bfloat16):
    return (wq.float() * sw[:, None]).to(dtype)


def q8_matmul_t(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                tensor=None) -> torch.Tensor:
    """y = x @ dequant(Wq).T with dynamic per-row activation quantization.

    x: (..., I) bf16 or fp32; wq: (O, I) int8; sw: (O,) fp32. Returns
    (..., O) in x.dtype. tensor: the mesh of a row-parallel linear, x and
    wq this rank's columns (module notes): y is this rank's partial sum."""
    x2 = x.reshape(-1, x.shape[-1])
    xq, sx = row_quant(x2, tensor=tensor)
    y = q8mm_t(xq, sx, wq, sw, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], wq.shape[0])


def q8_matmul(g: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
              tensor=None, amax: torch.Tensor | None = None) -> torch.Tensor:
    """grad_x = g @ dequant(Wq) (contraction over the OUT dim).

    Folds the per-out-channel scale into g before row quantization, so the
    int8 contraction is exact w.r.t. the folded values. g: (..., O);
    returns (..., I) in g.dtype. tensor: the mesh of a column-parallel
    linear, g, wq and sw this rank's output rows (module notes): the
    result is this rank's partial sum. amax: the rows' amaxes of g * sw
    over the whole row, already reduced (row_quant)."""
    g2 = g.reshape(-1, g.shape[-1])
    gq, sg = row_quant(g2, sw, tensor=tensor, amax=amax)
    y = q8mm_g(gq, sg, wq, out_dtype=g.dtype)
    return y.reshape(*g.shape[:-1], wq.shape[1])


# ---------------------------------------------------------------------------
# Int4 (nibble-packed) frozen base — DECODE path
# ---------------------------------------------------------------------------
#
# Symmetric int4 in [-7, 7] with per-(output-channel, input-group) fp32
# scales, group size INT4_GROUP along the input dim. Packing is SPLIT-HALF:
# packed column k holds original input columns k (low nibble) and k + I/2
# (high nibble), stored as int8 bit patterns, so y = x[:, :I/2] @ lo.T +
# x[:, I/2:] @ hi.T. Values equal the JAX package's bit for bit.
#
# Which matmul runs mirrors the JAX rule (`q4_conforms`):
#   * a conforming weight (packed width and O multiples of 128, group 128)
#     at <= Q4_DECODE_MAX_ROWS rows: K6 (ops/cuda/q4_matmul.py) with x cast
#     to bf16 first, also for an fp32 model, the result cast back to x's dtype;
#   * a conforming weight at more rows (prefill): the weight dequantized to
#     bf16 and a bf16 torch.matmul (a plain large product, as JAX leaves it
#     to XLA);
#   * any other weight: q4_matmul_t_ref, fp32 dequantization, fp32 product.
# The selected SMT blocks keep their exact trained values: the decode
# corrections are gathered against the fp32-dequantized int4 base
# (train/scan_phase.requantize_scan_base_int4).

INT4_GROUP = GROUP
Q4_DECODE_MAX_ROWS = 64


def quantize_weight_int4(w: torch.Tensor, group: int | None = None):
    """(O, I) weight -> (w4 int8 (O, I/2) nibble-packed, s4 fp32 (O, I/group)).
    group defaults to INT4_GROUP when I allows it, else the largest
    power-of-two divisor of I/2 up to it (tiny test models: those take the
    reference matmul). The scales are amax times fp32(1/7), as JAX computes
    them inside jit, where it runs this quantization (lax.map in
    requantize_scan_base_int4)."""
    o, i = w.shape
    if group is None:
        group = INT4_GROUP if i % (2 * INT4_GROUP) == 0 else math.gcd(INT4_GROUP, max(i // 2, 1))
    if i % (2 * group):
        raise ValueError(f"in_dim {i} not a multiple of {2 * group} — int4 packing needs "
                         "whole groups in each half-plane")
    wf = w.float().reshape(o, i // group, group)
    amax = wf.abs().amax(dim=-1)
    s4 = _over(torch.clamp(amax, min=1e-8), 7.0, reciprocal=True)
    q = torch.clamp(torch.round(wf / s4[..., None]), -7, 7).reshape(o, i).to(torch.int32)
    lo, hi = q[:, :i // 2], q[:, i // 2:]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), s4


def unpack_int4(w4: torch.Tensor) -> torch.Tensor:
    """(O, K) packed int8 -> (O, 2K) int8 in the original column order."""
    return torch.cat(unpack_planes(w4), dim=1).to(torch.int8)


def dequantize_weight_int4(w4: torch.Tensor, s4: torch.Tensor,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """The (O, I) weight from its packed int4 form."""
    q = unpack_int4(w4)
    o, i = q.shape
    g = i // s4.shape[1]
    return (q.float().reshape(o, i // g, g) * s4[..., None]).reshape(o, i).to(dtype)


def q4_matmul_t_ref(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant4(W).T against the fp32-dequantized weight, in fp32,
    returned in x.dtype: the reference route."""
    w = dequantize_weight_int4(w4, s4, torch.float32)
    return torch.matmul(x.float(), w.t()).to(x.dtype)


def q4_conforms(w4: torch.Tensor, s4: torch.Tensor) -> bool:
    """The JAX rule for the kernel route (eval/generate.py:303-305): packed
    width a multiple of 128, group 128, O a multiple of 128."""
    o, k = w4.shape[-2], w4.shape[-1]
    return k % INT4_GROUP == 0 and s4.shape[-1] == 2 * (k // INT4_GROUP) and o % 128 == 0


def q4_matmul_t(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant4(W).T in x.dtype, by the route of the module notes."""
    if not q4_conforms(w4, s4):
        return q4_matmul_t_ref(x, w4, s4)
    if x.numel() // x.shape[-1] > Q4_DECODE_MAX_ROWS:
        w = dequantize_weight_int4(w4, s4, torch.bfloat16)
        return torch.matmul(x.to(torch.bfloat16), w.t()).to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    y = q4mm_t(x2, w4, s4, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], w4.shape[0])


def q4_matmul_t_stacked(x: torch.Tensor, w4s: torch.Tensor, s4s: torch.Tensor,
                        layer: int) -> torch.Tensor:
    """y = x @ dequant4(W[layer]).T against an (L, O, I/2) stack: the
    kernel on the layer's contiguous view (no copy). The stack must conform."""
    w4, s4 = w4s[layer], s4s[layer]
    if not q4_conforms(w4, s4):
        raise ValueError(f"q4_matmul_t_stacked: stack {tuple(w4s.shape)} / {tuple(s4s.shape)} "
                         "does not conform (packed width and O multiples of 128, group 128)")
    return q4_matmul_t(x, w4, s4)


def dequantize_stacked_layer_int4(w4s: torch.Tensor, s4s: torch.Tensor, layer: int,
                                  dtype=torch.bfloat16) -> torch.Tensor:
    """Layer `layer`'s (O, I) weight from an (L, O, I/2) stack."""
    return dequantize_weight_int4(w4s[layer], s4s[layer], dtype)
