"""K1 block_grad: selected-block weight gradients (csrc/block_grad.cu).

    out[i] = g[:, rb_i*256:+256]^T @ x[:, cb_i*256:+256]   (n, 256, 256) fp32

Replaces the Pallas kernel ops/pallas/block_grad.py of the JAX package.
`block_grad` launches the CUDA kernel on CUDA tensors and raises on what it
does not take; on CPU tensors it runs `block_grad_plain`, the plain PyTorch
version (the twin of the JAX `_block_grad_weight_xla` oracle).
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

BLOCK = 256
LAUNCHES = 0  # kernel launches in this process

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def block_grad_plain(g2: torch.Tensor, x2: torch.Tensor, rb: torch.Tensor,
                     cb: torch.Tensor) -> torch.Tensor:
    """Gather the row/col panels, cast them to fp32 (exact for bf16), one
    batched matmul: (n, 256, 256) fp32."""
    t = g2.shape[0]
    g_rows = g2.reshape(t, -1, BLOCK).index_select(1, rb.long()).transpose(0, 1)
    x_cols = x2.reshape(t, -1, BLOCK).index_select(1, cb.long()).transpose(0, 1)
    return torch.bmm(g_rows.float().transpose(1, 2), x_cols.float())


def _check(g2, x2, rb, cb):
    if x2.device != g2.device or rb.device != g2.device or cb.device != g2.device:
        raise ValueError("block_grad: g2, x2, rb, cb must be on one device")
    if g2.device.index != torch.cuda.current_device():
        raise ValueError(f"block_grad: tensors on {g2.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if g2.dtype not in _DTYPE_CODE or x2.dtype != g2.dtype:
        raise TypeError(f"block_grad: g2/x2 must both be bf16 or fp32, got "
                        f"{g2.dtype}/{x2.dtype}")
    if g2.dim() != 2 or x2.dim() != 2 or g2.shape[0] != x2.shape[0]:
        raise ValueError(f"block_grad: want g2 (T, O), x2 (T, I), got "
                         f"{tuple(g2.shape)}, {tuple(x2.shape)}")
    if g2.shape[1] % BLOCK or x2.shape[1] % BLOCK:
        raise ValueError("block_grad: O and I must be multiples of 256")
    if not (g2.is_contiguous() and x2.is_contiguous()):
        raise ValueError("block_grad: g2 and x2 must be contiguous")
    if g2.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError("block_grad: g2 and x2 must be 16-byte aligned")
    if (rb.dtype != torch.int32 or cb.dtype != torch.int32 or rb.dim() != 1
            or rb.shape != cb.shape or not rb.is_contiguous() or not cb.is_contiguous()):
        raise ValueError("block_grad: rb/cb must be contiguous (n,) int32")
    if max(g2.shape[0], g2.shape[1], x2.shape[1]) >= 2 ** 31:
        raise ValueError("block_grad: dimensions must fit in int32")


def block_grad(g2: torch.Tensor, x2: torch.Tensor, rb: torch.Tensor,
               cb: torch.Tensor) -> torch.Tensor:
    """g2: (T, O), x2: (T, I); rb/cb: (n,) int32 block coordinates, in range
    (LinearPlan validates them). Returns (n, 256, 256) fp32."""
    global LAUNCHES
    if g2.device.type == "cpu":
        return block_grad_plain(g2, x2, rb, cb)
    if g2.device.type != "cuda":
        raise ValueError(f"block_grad: no kernel for device {g2.device}")
    _check(g2, x2, rb, cb)
    t, o = g2.shape
    n = rb.shape[0]
    out = torch.empty((n, BLOCK, BLOCK), dtype=torch.float32, device=g2.device)
    lib = _build.load()
    err = lib.smt_block_grad(
        g2.data_ptr(), x2.data_ptr(), rb.data_ptr(), cb.data_ptr(), out.data_ptr(),
        t, o, x2.shape[1], n, _DTYPE_CODE[g2.dtype],
        torch.cuda.current_stream(g2.device).cuda_stream)
    _build.check(err, "block_grad")
    LAUNCHES += 1
    return out
