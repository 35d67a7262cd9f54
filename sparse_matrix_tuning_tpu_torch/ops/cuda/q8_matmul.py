"""K4 q8_matmul: the int8 frozen-base matmul with fused scales
(csrc/q8_matmul.cu), in its two forms:

    q8mm_t:  out (T, O) = ((xq (T, K) @ wq (O, K)^T)_int32 * sx) * sw
    q8mm_g:  out (T, K) = (gq (T, O) @ wq (O, K))_int32 * sg

Replaces the Pallas kernels `q8mm_t_core` / `q8mm_g_core` of the JAX
package (ops/pallas/q8_matmul.py). The row quantization in front of them
is its own kernel (ops/cuda/row_quant.py). `q8mm_t` / `q8mm_g` launch the
CUDA kernel on CUDA tensors, with the launch `plan` picked from T and
the output width, and raise on what it does not take; on CPU tensors they run the plain versions, which compute the same
integer-exact product.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

# kernel launches in this process, per form; the fp16 epilogue apart
LAUNCHES = {"q8mm_t": 0, "q8mm_g": 0, "q8mm_t_fp16": 0, "q8mm_g_fp16": 0}

DECODE_ROWS = 64   # up to this many rows, the decode plan's 64-row tiles

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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


@dataclasses.dataclass(frozen=True)
class Q8Plan:
    """One launch: bm x bn output tiles (64 or 128 rows: one or two consumer
    warpgroups) and `grid` persistent CTAs walking them."""
    bm: int
    bn: int
    tiles: int
    grid: int


def plan(form: str, t: int, n_out: int, n_sm: int) -> Q8Plan:
    """The launch plan of one call. form "t" or "g"; t rows, n_out output
    columns.
      * Training rows: 128 x 256 tiles (t form) or 128 x 128 (g form: the
        transposed weight tile is 128 x 128); 64 x 128 where the large tiles
        would leave more than half the SMs idle (k/v's 256 outputs).
      * Decode rows (t <= DECODE_ROWS): 64 x 128 tiles, each CTA over its
        tile's whole contraction (splitting it over CTAs lost at three of
        the four TinyLlama decode shapes on the card, PERF.md).
      * grid: one CTA per tile, at most one per SM."""
    cdiv = lambda a, b: -(-a // b)
    if t <= DECODE_ROWS:
        bm, bn = 64, 128
    else:
        bm, bn = 128, (256 if form == "t" else 128)
        if cdiv(t, bm) * cdiv(n_out, bn) < n_sm // 2:
            bm, bn = 64, 128
    tiles = cdiv(t, bm) * cdiv(n_out, bn)
    return Q8Plan(bm, bn, tiles, min(tiles, n_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _validate(name, aq, srow, wq, sw, out_dtype, contract, n_out):
    """What the kernel takes, apart from the device: aq (T, contract) int8,
    srow (T,)/(T,1) fp32, wq (O, K) int8, sw (O,) fp32 (t form) or None."""
    tensors = [aq, srow, wq] + ([sw] if sw is not None else [])
    if any(t.device != aq.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if aq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"{name}: the quantized operands must be int8, got "
                        f"{aq.dtype}/{wq.dtype}")
    if srow.dtype != torch.float32 or (sw is not None and sw.dtype != torch.float32):
        raise TypeError(f"{name}: scales must be fp32")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: out dtype must be bf16, fp16 or fp32, got {out_dtype}")
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


def _launch(name, fn, ptrs, t, o, k, out_dtype, device):
    """Allocate out, launch, count. The t form gives (T, O) and contracts
    over K; the g form gives (T, K) over O."""
    n_out = o if name == "q8mm_t" else k
    if device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    out = torch.empty((t, n_out), dtype=out_dtype, device=device)
    if t == 0:
        return out
    p = plan(name[-1], t, n_out, _sm_count(device.index))
    err = fn(*ptrs, out.data_ptr(), t, o, k, _DTYPE_CODE[out_dtype], p.bm, p.bn, p.grid,
             torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, name)
    LAUNCHES[name + ("_fp16" if out_dtype == torch.float16 else "")] += 1
    return out


def q8mm_t(xq, sx, wq, sw, out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq (T, K) int8, sx (T, 1) fp32, wq (O, K) int8, sw (O,) fp32 ->
    (T, O) out_dtype. Any T and O; K a multiple of 16."""
    if xq.device.type == "cpu":
        return q8mm_t_plain(xq, sx, wq, sw, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"q8mm_t: no kernel for device {xq.device}")
    _validate("q8mm_t", xq, sx, wq, sw, out_dtype, wq.shape[1], wq.shape[0])
    return _launch("q8mm_t", _build.load().smt_q8mm_t,
                   (xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr()),
                   xq.shape[0], *wq.shape, out_dtype, xq.device)


def q8mm_g(gq, sg, wq, out_dtype=torch.bfloat16) -> torch.Tensor:
    """gq (T, O) int8, sg (T, 1) fp32, wq (O, K) int8 -> (T, K) out_dtype.
    Any T; O and K multiples of 16."""
    if gq.device.type == "cpu":
        return q8mm_g_plain(gq, sg, wq, out_dtype)
    if gq.device.type != "cuda":
        raise ValueError(f"q8mm_g: no kernel for device {gq.device}")
    o, k = wq.shape
    _validate("q8mm_g", gq, sg, wq, None, out_dtype, o, k)
    return _launch("q8mm_g", _build.load().smt_q8mm_g,
                   (gq.data_ptr(), sg.data_ptr(), wq.data_ptr()),
                   gq.shape[0], o, k, out_dtype, gq.device)
