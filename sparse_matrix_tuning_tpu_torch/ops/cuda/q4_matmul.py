"""K6 q4_matmul: the decode matmul over the nibble-packed int4 frozen base
(csrc/q4_matmul.cu).

    q4mm_t:  out (T, O) = sum_g (x_g (T, 128) @ q_g (O, 128)^T) * s4[:, g]

x (T, I) bf16 with T <= 64 rows (decode), w4 (O, I/2) int8 split-half
packed (ops/quant.py int4 notes), s4 (O, I/128) fp32 group scales: each
128-column group's partial is summed in fp32 and scaled, the scaled
partials summed in fp32, rounded once to the output type. Replaces the
Pallas kernels `_q4_matmul_t_2d` (K6) and `_q4_stacked_2d` (K6s) of the
JAX package (ops/pallas/q4_matmul.py); K6s is K6 launched on the layer
view w4[l], s4[l] of a stack. `q4mm_t` launches the CUDA kernel on CUDA
tensors and raises on what it does not take; on CPU tensors it runs
`q4mm_t_plain`, the same per-group arithmetic.
"""

from __future__ import annotations

import functools

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

GROUP = 128       # columns per scale group; O and the packed width are multiples
MAX_ROWS = 64     # the kernel's rows per call (decode: batch x beams)
LAUNCHES = 0      # kernel launches in this process

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def unpack_planes(w4: torch.Tensor):
    """(O, K) packed int8 -> (low, high) int32 planes (O, K): the signed
    values of columns [0, K) and [K, 2K), sign-extended as (n ^ 8) - 8."""
    p = w4.view(torch.uint8).to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, (((p >> 4) & 0xF) ^ 8) - 8


def q4mm_t_plain(x, w4, s4, out_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version: x (T, I), w4 (O, I/2), s4 (O, n_groups);
    the per-group fp32 partials (exact products of x's values and the small
    integers), scaled and summed over the groups in fp32, rounded once."""
    t, (o, _), n_groups = x.shape[0], w4.shape, s4.shape[1]
    q = torch.cat(unpack_planes(w4), dim=1).float()                # (O, I)
    g = q.shape[1] // n_groups
    part = torch.einsum("tgc,ogc->tgo", x.float().reshape(t, n_groups, g),
                        q.reshape(o, n_groups, g))                   # (T, G, O)
    return (part * s4.t()[None]).sum(dim=1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(o: int, k: int, n_sm: int) -> int:
    """Groups per plane split over CTAs: the least divisor of k / 128 that
    gives at least one CTA per SM (o / 128 output tiles each), else one
    group per split."""
    kg, tiles = k // GROUP, o // GROUP
    for d in range(1, kg + 1):
        if kg % d == 0 and tiles * d >= n_sm:
            return d
    return kg


def _check(x, w4, s4, out_dtype):
    if w4.device != x.device or s4.device != x.device:
        raise ValueError("q4mm_t: x, w4 and s4 must be on one device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"q4mm_t: tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if x.dtype != torch.bfloat16 or w4.dtype != torch.int8 or s4.dtype != torch.float32:
        raise TypeError(f"q4mm_t: want x bf16, w4 int8, s4 fp32, got {x.dtype}/{w4.dtype}/"
                        f"{s4.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"q4mm_t: out dtype must be bf16 or fp32, got {out_dtype}")
    if x.dim() != 2 or w4.dim() != 2 or s4.dim() != 2:
        raise ValueError("q4mm_t: want x (T, I), w4 (O, I/2), s4 (O, I/128)")
    (t, i), (o, k) = x.shape, w4.shape
    if i != 2 * k or tuple(s4.shape) != (o, 2 * (k // GROUP)):
        raise ValueError(f"q4mm_t: x {tuple(x.shape)}, w4 {tuple(w4.shape)} and s4 "
                         f"{tuple(s4.shape)} do not match")
    if o % GROUP or k % GROUP:
        raise ValueError(f"q4mm_t: O and the packed width must be multiples of {GROUP}, got "
                         f"w4 {tuple(w4.shape)}")
    if t > MAX_ROWS:
        raise ValueError(f"q4mm_t: at most {MAX_ROWS} rows, got {t}")
    if not (x.is_contiguous() and w4.is_contiguous() and s4.is_contiguous()):
        raise ValueError("q4mm_t: x, w4 and s4 must be contiguous")
    if x.data_ptr() % 16 or w4.data_ptr() % 16 or s4.data_ptr() % 16:
        raise ValueError("q4mm_t: x, w4 and s4 must be 16-byte aligned")
    if max(o * k, t * i) >= 2 ** 31:
        raise ValueError("q4mm_t: sizes must fit in int32")


def q4mm_t(x, w4, s4, out_dtype=torch.float32) -> torch.Tensor:
    """x (T, I) bf16, T <= 64; w4 (O, I/2) int8; s4 (O, I/128) fp32 ->
    (T, O) out_dtype. O and I/2 multiples of 128."""
    global LAUNCHES
    if x.device.type == "cpu":
        return q4mm_t_plain(x, w4, s4, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q4mm_t: no kernel for device {x.device}")
    _check(x, w4, s4, out_dtype)
    (t, _), (o, k) = x.shape, w4.shape
    out = torch.empty((t, o), dtype=out_dtype, device=x.device)
    if t == 0:
        return out
    splits = splits_for(o, k, _sm_count(x.device.index))
    ws = torch.empty((splits, t, o), dtype=torch.float32, device=x.device) if splits > 1 else None
    err = _build.load().smt_q4mm(
        x.data_ptr(), w4.data_ptr(), s4.data_ptr(), None if ws is None else ws.data_ptr(),
        out.data_ptr(), t, o, k, splits, _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "q4mm_t")
    LAUNCHES += 1
    return out
