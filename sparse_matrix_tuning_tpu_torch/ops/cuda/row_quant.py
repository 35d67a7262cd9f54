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

Under the tensor axis a row may lie across the ranks (ops/quant.py
row_quant(tensor=)), so the launch is split where the whole row is
needed: `row_amax` (the row's amax alone, NaN carried, not clamped) and
`row_quant_amax` (the quantization with a given amax: the MAX of the
ranks' amaxes). With a row's own amax the pair gives row_quant's values
bit for bit. Each has its plain twin and its own LAUNCHES key.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

# kernel launches in this process: over bf16 and fp32 x, and over fp16 x
LAUNCHES = {"row_quant": 0, "row_quant_fp16": 0, "row_amax": 0, "row_amax_fp16": 0,
            "row_quant_amax": 0, "row_quant_amax_fp16": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_RECIPROCALS = {}  # (device, divisor) -> the fp32 reciprocal of divisor, a 0-dim tensor


def reciprocal(divisor: float, device) -> torch.Tensor:
    """The fp32 reciprocal of a constant as a 0-dim tensor on `device`,
    made once per (device, divisor): no host-to-device copy per call."""
    key = (torch.device(device), float(divisor))
    if key not in _RECIPROCALS:
        _RECIPROCALS[key] = torch.tensor(1.0 / divisor, dtype=torch.float32, device=key[0])
    return _RECIPROCALS[key]


def _values(x: torch.Tensor, sw: torch.Tensor | None) -> torch.Tensor:
    x32 = x.float()
    return x32 * sw if sw is not None else x32


def _quantize(x32: torch.Tensor, amax: torch.Tensor):
    sx = torch.clamp(amax, min=1e-8) * reciprocal(127.0, x32.device)
    return torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8), sx


def row_quant_plain(x: torch.Tensor, sw: torch.Tensor | None = None):
    """The plain PyTorch version, over the last dim of x (any leading dims):
    fp32 values (times sw), the row amax, the scale as amax times the fp32
    reciprocal of 127 (as XLA compiles the JAX package's division by 127
    under jit), x / sx as a division rounded half to even."""
    x32 = _values(x, sw)
    return _quantize(x32, x32.abs().amax(dim=-1, keepdim=True))


def row_amax_plain(x: torch.Tensor, sw: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of row_amax: max |x (* sw)| over the last dim,
    (..., 1) fp32, a NaN carried (torch.amax propagates it)."""
    return _values(x, sw).abs().amax(dim=-1, keepdim=True)


def row_quant_amax_plain(x: torch.Tensor, amax: torch.Tensor, sw: torch.Tensor | None = None):
    """The plain version of row_quant_amax: row_quant_plain's values with
    the scale made from `amax` (..., 1) fp32 in place of the row's own."""
    return _quantize(_values(x, sw), amax.reshape(*x.shape[:-1], 1))


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


def _on_card(x: torch.Tensor, sw: torch.Tensor | None, what: str) -> None:
    """Raise unless x (and sw) are what the kernels take on the current card."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    _validate(x, sw)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _count(name: str, x: torch.Tensor) -> None:
    LAUNCHES[name + "_fp16" if x.dtype == torch.float16 else name] += 1


def _args(x, sw):
    return (x.data_ptr(), None if sw is None else sw.data_ptr())


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def row_quant(x: torch.Tensor, sw: torch.Tensor | None = None):
    """x (T, K) bf16, fp16 or fp32 [, sw (K,) fp32] -> (xq int8 (T, K), sx fp32
    (T, 1)) = row_quant_plain(x, sw), in one launch on a CUDA tensor."""
    if x.device.type == "cpu":
        return row_quant_plain(x, sw)
    _on_card(x, sw, "row_quant")
    t, k = x.shape
    xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t == 0:
        return xq, sx
    err = _build.load().smt_row_quant(*_args(x, sw), xq.data_ptr(), sx.data_ptr(), t, k,
                                      _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(err, "row_quant")
    _count("row_quant", x)
    return xq, sx


def row_amax(x: torch.Tensor, sw: torch.Tensor | None = None) -> torch.Tensor:
    """x (T, K) [, sw (K,)] -> amax (T, 1) fp32 = row_amax_plain(x, sw), in one
    launch on a CUDA tensor."""
    if x.device.type == "cpu":
        return row_amax_plain(x, sw)
    _on_card(x, sw, "row_amax")
    t, k = x.shape
    amax = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t == 0:
        return amax
    err = _build.load().smt_row_amax(*_args(x, sw), amax.data_ptr(), t, k,
                                     _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(err, "row_amax")
    _count("row_amax", x)
    return amax


def row_quant_amax(x: torch.Tensor, amax: torch.Tensor, sw: torch.Tensor | None = None):
    """x (T, K), amax (T, 1) fp32 [, sw (K,)] -> (xq, sx) =
    row_quant_amax_plain(x, amax, sw), in one launch on a CUDA tensor."""
    if x.device.type == "cpu":
        return row_quant_amax_plain(x, amax, sw)
    _on_card(x, sw, "row_quant_amax")
    t, k = x.shape
    if amax.dtype != torch.float32 or amax.numel() != t or amax.device != x.device \
            or not amax.is_contiguous():
        raise ValueError(f"row_quant_amax: want amax fp32 ({t}, 1) contiguous on x's device, "
                         f"got {amax.dtype} {tuple(amax.shape)} on {amax.device}")
    xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t == 0:
        return xq, sx
    err = _build.load().smt_row_quant_amax(*_args(x, sw), amax.data_ptr(), xq.data_ptr(),
                                           sx.data_ptr(), t, k, _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(err, "row_quant_amax")
    _count("row_quant_amax", x)
    return xq, sx
