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
"""

from __future__ import annotations

import math

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.q4_matmul import GROUP, q4mm_t, unpack_planes
from sparse_matrix_tuning_tpu_torch.ops.cuda.q8_matmul import q8mm_g, q8mm_t
from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import reciprocal as _reciprocal
from sparse_matrix_tuning_tpu_torch.ops.cuda.row_quant import row_quant as _row_quant_2d


def row_quant(x: torch.Tensor, sw: torch.Tensor | None = None):
    """Per-row symmetric int8 quantization over the last dim (of x * sw
    when sw is given: the g form's fold of the weight scales).

    Returns (xq int8, sx fp32 with shape (..., 1)); x / sx rounded (half to
    even) to [-127, 127]. The scale is amax times fp32(1/127), as XLA
    compiles the JAX package's division by 127 inside its jitted trainer
    and eval steps; x / sx stays a division, as it does there. On a CUDA
    tensor one kernel launch computes both (ops/cuda/row_quant.py); on
    the CPU its plain version."""
    k = x.shape[-1]
    xq, sx = _row_quant_2d(x.reshape(-1, k).contiguous(), sw)
    return xq.reshape(x.shape), sx.reshape(*x.shape[:-1], 1)


def _over(x: torch.Tensor, divisor: float, reciprocal: bool) -> torch.Tensor:
    """x / divisor, or x times the fp32 reciprocal of the constant divisor:
    what XLA compiles a division by a constant into under jit, so the
    port's values equal those JAX computes inside jit-compiled code. The
    reciprocal is made once per device, not copied to the device per call."""
    if reciprocal:
        return x * _reciprocal(divisor, x.device)
    return x / divisor


def quantize_weight(w: torch.Tensor, reciprocal: bool = False):
    """Per-output-channel symmetric int8 for an (out, in) weight.

    Returns (wq int8 (O, I), sw fp32 (O,)). reciprocal: the scale as JAX
    computes it under jit (quantize-on-load, train/scan_phase.py), amax
    times fp32(1/127), instead of eagerly, amax / 127 (the two differ in
    the last bit of some scales)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1)
    sw = _over(torch.clamp(amax, min=1e-8), 127.0, reciprocal)
    wq = torch.clamp(torch.round(w32 / sw[:, None]), -127, 127).to(torch.int8)
    return wq, sw


def dequantize_weight(wq: torch.Tensor, sw: torch.Tensor, dtype=torch.bfloat16):
    return (wq.float() * sw[:, None]).to(dtype)


def q8_matmul_t(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(Wq).T with dynamic per-row activation quantization.

    x: (..., I) bf16 or fp32; wq: (O, I) int8; sw: (O,) fp32. Returns
    (..., O) in x.dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    xq, sx = row_quant(x2)
    y = q8mm_t(xq, sx, wq, sw, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], wq.shape[0])


def q8_matmul(g: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """grad_x = g @ dequant(Wq) (contraction over the OUT dim).

    Folds the per-out-channel scale into g before row quantization, so the
    int8 contraction is exact w.r.t. the folded values. g: (..., O);
    returns (..., I) in g.dtype."""
    g2 = g.reshape(-1, g.shape[-1])
    gq, sg = row_quant(g2, sw)
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
