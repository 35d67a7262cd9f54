"""K2 masked_adam: in-place Adam over the gathered SMT blocks
(csrc/masked_adam.cu).

    scalars = [lr, b1, b2, eps, wd, bc1, bc2]  (7,) fp32 on the device
    m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
    p = p - lr * ((m/bc1) / (sqrt(v/bc2) + eps) + wd*p)

Replaces the Pallas kernel ops/pallas/masked_adam.py of the JAX package.
`masked_adam` launches the CUDA kernel on CUDA tensors and raises on what
it does not take; on CPU tensors it runs `masked_adam_plain`, the plain
PyTorch version, which computes operation for operation what the kernel
and the Pallas kernel compute.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # kernel launches in this process


@torch.no_grad()
def masked_adam_plain(p, g, m, v, scalars):
    """In-place update of p, m, v; returns (p, m, v)."""
    lr, b1, b2, eps, wd, bc1, bc2 = scalars.unbind(0)
    g = g.float()
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p
    p.copy_(p - lr * update)
    m.copy_(m_new)
    v.copy_(v_new)
    return p, m, v


def _check(p, g, m, v, scalars):
    tensors = (p, g, m, v, scalars)
    if any(t.device != p.device for t in tensors):
        raise ValueError("masked_adam: p, g, m, v, scalars must be on one device")
    if p.device.index != torch.cuda.current_device():
        raise ValueError(f"masked_adam: tensors on {p.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("masked_adam: p, g, m, v and scalars must be fp32")
    if not (p.shape == g.shape == m.shape == v.shape) or scalars.shape != (7,):
        raise ValueError(f"masked_adam: want p/g/m/v of one shape and (7,) "
                         f"scalars, got {tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}, {tuple(scalars.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_adam: tensors must be contiguous")
    if p.numel() % 4 or any(t.data_ptr() % 16 for t in (p, g, m, v)):
        raise ValueError("masked_adam: numel must be a multiple of 4 and "
                         "p/g/m/v 16-byte aligned")
    if p.numel() >= 2 ** 31:
        raise ValueError("masked_adam: numel must fit in int32")


def masked_adam(p, g, m, v, scalars):
    """p/m/v: fp32 (n, 256, 256), updated in place; g: fp32, same shape;
    scalars: (7,) fp32. Returns (p, m, v)."""
    global LAUNCHES
    if p.device.type == "cpu":
        return masked_adam_plain(p, g, m, v, scalars)
    if p.device.type != "cuda":
        raise ValueError(f"masked_adam: no kernel for device {p.device}")
    _check(p, g, m, v, scalars)
    lib = _build.load()
    err = lib.smt_masked_adam(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                              v.data_ptr(), scalars.data_ptr(), p.numel(),
                              torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "masked_adam")
    LAUNCHES += 1
    return p, m, v
