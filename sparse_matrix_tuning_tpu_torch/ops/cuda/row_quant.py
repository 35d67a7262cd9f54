"""K4's prologue: per-row symmetric int8 quantization as one CUDA kernel
(csrc/row_quant.cu).

    row_quant(x):      xq = clamp(rint(x / sx), -127, 127),
                       sx = max(amax_row |x|, 1e-8) * fp32(1/127)
    row_quant(x, sw):  the same over x * sw (the g form folds the weight's
                       per-output-channel scales into g first)

x (T, K) bf16, fp16 or fp32 -> (xq int8 (T, K), sx fp32 (T, 1)). This is what
XLA fuses in front of the JAX package's q8 kernels under jit
(ops/quant.py row_quant, run by ops/pallas/q8_matmul.py
q8_matmul_t_fused / q8_matmul_fused). `row_quant` launches the kernel on
CUDA tensors and raises on what it does not take; on CPU tensors it runs
`row_quant_plain`, whose values the kernel equals bit for bit. LAUNCHES
counts the launches over an fp16 x apart.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

# kernel launches in this process: over bf16 and fp32 x, and over fp16 x
LAUNCHES = {"row_quant": 0, "row_quant_fp16": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_RECIPROCALS = {}  # (device, divisor) -> the fp32 reciprocal of divisor, a 0-dim tensor


def reciprocal(divisor: float, device) -> torch.Tensor:
    """The fp32 reciprocal of a constant as a 0-dim tensor on `device`,
    made once per (device, divisor): no host-to-device copy per call."""
    key = (torch.device(device), float(divisor))
    if key not in _RECIPROCALS:
        _RECIPROCALS[key] = torch.tensor(1.0 / divisor, dtype=torch.float32, device=key[0])
    return _RECIPROCALS[key]


def row_quant_plain(x: torch.Tensor, sw: torch.Tensor | None = None):
    """The plain PyTorch version, over the last dim of x (any leading dims):
    fp32 values (times sw), the row amax, the scale as amax times the fp32
    reciprocal of 127 (as XLA compiles the JAX package's division by 127
    under jit), x / sx as a division rounded half to even."""
    x32 = x.float()
    if sw is not None:
        x32 = x32 * sw
    amax = x32.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-8) * reciprocal(127.0, x32.device)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def _validate(x: torch.Tensor, sw: torch.Tensor | None):
    """What the kernel takes, apart from the device: x (T, K) bf16/fp16/fp32
    contiguous; sw (K,) fp32 contiguous on x's device."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_quant: x must be bf16, fp16 or fp32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"row_quant: want x (T, K) with K > 0, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("row_quant: x must be contiguous")
    if sw is not None:
        if sw.dtype != torch.float32 or sw.dim() != 1 or sw.shape[0] != x.shape[1]:
            raise ValueError(f"row_quant: want sw fp32 ({x.shape[1]},), got {sw.dtype} "
                             f"{tuple(sw.shape)}")
        if sw.device != x.device or not sw.is_contiguous():
            raise ValueError("row_quant: sw must be contiguous and on x's device")
    if x.shape[0] >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError("row_quant: dimensions must fit in int32")


def row_quant(x: torch.Tensor, sw: torch.Tensor | None = None):
    """x (T, K) bf16, fp16 or fp32 [, sw (K,) fp32] -> (xq int8 (T, K), sx fp32
    (T, 1)) = row_quant_plain(x, sw), in one launch on a CUDA tensor."""
    if x.device.type == "cpu":
        return row_quant_plain(x, sw)
    if x.device.type != "cuda":
        raise ValueError(f"row_quant: no kernel for device {x.device}")
    _validate(x, sw)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"row_quant: tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    t, k = x.shape
    xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t == 0:
        return xq, sx
    err = _build.load().smt_row_quant(
        x.data_ptr(), None if sw is None else sw.data_ptr(), xq.data_ptr(), sx.data_ptr(), t, k,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "row_quant")
    LAUNCHES["row_quant_fp16" if x.dtype == torch.float16 else "row_quant"] += 1
    return xq, sx
