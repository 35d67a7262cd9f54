"""Int8 frozen-weight matmul primitives for the SMT sparse phase (PyTorch
twin of the int8 half of `sparse_matrix_tuning_tpu.ops.quant`).

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

Row quantization is plain PyTorch ops and stays outside the kernel, as in
the JAX package: a row's scale needs the whole row before any tile of it
can be quantized.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda.q8_matmul import q8mm_g, q8mm_t


def row_quant(x: torch.Tensor):
    """Per-row symmetric int8 quantization over the last dim.

    Returns (xq int8, sx fp32 with shape (..., 1)); x / sx rounded (half to
    even) to [-127, 127]."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 for an (out, in) weight.

    Returns (wq int8 (O, I), sw fp32 (O,))."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1)
    sw = torch.clamp(amax, min=1e-8) / 127.0
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
    gq, sg = row_quant(g2.float() * sw)
    y = q8mm_g(gq, sg, wq, out_dtype=g.dtype)
    return y.reshape(*g.shape[:-1], wq.shape[1])
