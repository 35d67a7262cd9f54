"""K4 q8_matmul: the int8 frozen-base matmul with fused scales
(csrc/q8_matmul.cu), in its two forms:

    q8mm_t:  out (T, O) = ((xq (T, K) @ wq (O, K)^T)_int32 * sx) * sw
    q8mm_g:  out (T, K) = (gq (T, O) @ wq (O, K))_int32 * sg

Replaces the Pallas kernels `q8mm_t_core` / `q8mm_g_core` of the JAX
package (ops/pallas/q8_matmul.py). Row quantization stays outside, in
ops/quant.py, as there. `q8mm_t` / `q8mm_g` launch the CUDA kernel on CUDA
tensors and raise on what it does not take; on CPU tensors they run the
plain versions, which compute the same integer-exact product.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

LAUNCHES = {"q8mm_t": 0, "q8mm_g": 0}  # kernel launches in this process

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# an fp32 product of int8 values is exact while 127^2 * K < 2^24
_EXACT_SLICE = 1024


def _exact_int_product(a: torch.Tensor, w: torch.Tensor, contract_rows: bool) -> torch.Tensor:
    """a (M, Kc) int8 times w, int32 and exact: w is (N, Kc), contracted
    over its columns, or with contract_rows (Kc, N), contracted over its
    rows. fp32 matmuls over slices of at most 1024 of the contraction (every
    partial sum is an integer below 2^24, so exact in any order) summed in
    int32; integer matmul itself is not implemented on CUDA. TF32 is turned
    off around the product: it would round the operands' sums."""
    kc = a.shape[1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = None
        for s in range(0, kc, _EXACT_SLICE):
            af = a[:, s:s + _EXACT_SLICE].float()
            wf = (w[s:s + _EXACT_SLICE] if contract_rows else w[:, s:s + _EXACT_SLICE].t()).float()
            part = torch.matmul(af, wf).to(torch.int32)
            acc = part if acc is None else acc.add_(part)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return acc


def q8mm_t_plain(xq, sx, wq, sw, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of q8mm_t: exact int32 product, then
    (acc * sx) * sw in fp32, rounded once to out_dtype."""
    acc = _exact_int_product(xq, wq, contract_rows=False)
    return ((acc.float() * sx.reshape(-1, 1)) * sw.reshape(1, -1)).to(out_dtype)


def q8mm_g_plain(gq, sg, wq, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of q8mm_g."""
    acc = _exact_int_product(gq, wq, contract_rows=True)
    return (acc.float() * sg.reshape(-1, 1)).to(out_dtype)


def _check(name, aq, srow, wq, sw, out_dtype, contract, n_out):
    """aq (T, contract) int8, srow (T,)/(T,1) fp32, wq (O, K) int8."""
    tensors = [aq, srow, wq] + ([sw] if sw is not None else [])
    if any(t.device != aq.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if aq.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {aq.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if aq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"{name}: the quantized operands must be int8, got "
                        f"{aq.dtype}/{wq.dtype}")
    if srow.dtype != torch.float32 or (sw is not None and sw.dtype != torch.float32):
        raise TypeError(f"{name}: scales must be fp32")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: out dtype must be bf16 or fp32, got {out_dtype}")
    if aq.dim() != 2 or wq.dim() != 2 or aq.shape[1] != contract:
        raise ValueError(f"{name}: shapes {tuple(aq.shape)} and wq {tuple(wq.shape)} "
                         "do not contract")
    if srow.numel() != aq.shape[0] or (sw is not None and sw.numel() != wq.shape[0]):
        raise ValueError(f"{name}: want one row scale per row and one weight scale "
                         "per output channel")
    if contract % 16 or (sw is None and n_out % 16):
        raise ValueError(f"{name}: the contraction length (and, in the g form, the "
                         f"weight's row length) must be a multiple of 16, got "
                         f"{tuple(wq.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if aq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"{name}: the int8 operands must be 16-byte aligned")
    if max(aq.shape[0], wq.shape[0], wq.shape[1]) >= 2 ** 31:
        raise ValueError(f"{name}: dimensions must fit in int32")


def q8mm_t(xq, sx, wq, sw, out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq (T, K) int8, sx (T, 1) fp32, wq (O, K) int8, sw (O,) fp32 ->
    (T, O) out_dtype. Any T and O; K a multiple of 16."""
    if xq.device.type == "cpu":
        return q8mm_t_plain(xq, sx, wq, sw, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"q8mm_t: no kernel for device {xq.device}")
    t, k = xq.shape[0], wq.shape[1]
    _check("q8mm_t", xq, sx, wq, sw, out_dtype, k, wq.shape[0])
    out = torch.empty((t, wq.shape[0]), dtype=out_dtype, device=xq.device)
    err = _build.load().smt_q8mm_t(
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(),
        t, wq.shape[0], k, _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(err, "q8mm_t")
    LAUNCHES["q8mm_t"] += 1
    return out


def q8mm_g(gq, sg, wq, out_dtype=torch.bfloat16) -> torch.Tensor:
    """gq (T, O) int8, sg (T, 1) fp32, wq (O, K) int8 -> (T, K) out_dtype.
    Any T; O and K multiples of 16."""
    if gq.device.type == "cpu":
        return q8mm_g_plain(gq, sg, wq, out_dtype)
    if gq.device.type != "cuda":
        raise ValueError(f"q8mm_g: no kernel for device {gq.device}")
    t, (o, k) = gq.shape[0], wq.shape
    _check("q8mm_g", gq, sg, wq, None, out_dtype, o, k)
    out = torch.empty((t, k), dtype=out_dtype, device=gq.device)
    err = _build.load().smt_q8mm_g(
        gq.data_ptr(), sg.data_ptr(), wq.data_ptr(), out.data_ptr(), t, o, k,
        _DTYPE_CODE[out_dtype], torch.cuda.current_stream(gq.device).cuda_stream)
    _build.check(err, "q8mm_g")
    LAUNCHES["q8mm_g"] += 1
    return out
