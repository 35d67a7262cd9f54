"""K6 q4_matmul: the decode matmul over the nibble-packed int4 frozen base
(csrc/q4_matmul.cu).

    q4mm_t:  out (T, O) = sum_g (x_g (T, 128) @ q_g (O, 128)^T) * s4[:, g]

x (T, I) bf16 with T <= 64 rows (decode), w4 (O, I/2) int8 split-half
packed (ops/quant.py int4 notes), s4 (O, I/128) fp32 group scales: each
128-column group's partial is summed in fp32 and scaled, the scaled
partials summed in fp32, rounded once to the output type. Replaces the
Pallas kernels `_q4_matmul_t_2d` (K6) and `_q4_stacked_2d` (K6s) of the
JAX package (ops/pallas/q4_matmul.py); K6s is K6 launched on the layer
view w4[l], s4[l] of a stack. The kernel splits the groups over CTAs
(`splits_for`) and sums the splits in the same launch, in split order
(`q4mm_t_split_model` is that order in plain PyTorch). `q4mm_t` launches
the CUDA kernel on CUDA tensors and raises on what it does not take; on
CPU tensors it runs `q4mm_t_plain`, the same per-group arithmetic.
"""

from __future__ import annotations

import functools

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

GROUP = 128       # columns per scale group; O and the packed width are multiples
MAX_ROWS = 64     # the kernel's rows per call (decode: batch x beams)
TILE_O = 128      # output columns per CTA
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
    """Groups per plane (k / 128) split over CTAs: as many splits as let
    the o / 128 output tiles times the splits fill at most the SMs, at
    least one group a split (the best of 1-16 splits at every
    decode shape on the card, PERF.md)."""
    kg, tiles = k // GROUP, -(-o // TILE_O)
    return max(1, min(kg, n_sm // tiles))


def split_ranges(k: int, splits: int):
    """The groups (per plane) of each split, as the kernel takes them:
    split s covers [s * kg // splits, (s + 1) * kg // splits)."""
    kg = k // GROUP
    return [(s * kg // splits, (s + 1) * kg // splits) for s in range(splits)]


def q4mm_t_split_model(x, w4, s4, splits: int, out_dtype=torch.float32) -> torch.Tensor:
    """A plain model of the kernel's summation order: each split sums, over
    its groups g in order and the low then the high plane, the scaled fp32
    partial of the group's 128 columns; the splits' fp32 sums are added in
    split order 0, 1, ... and rounded once. Within a partial the order of
    the 128 products is torch's (the tensor cores' is not modelled)."""
    t, (o, k) = x.shape[0], w4.shape
    kg = k // GROUP
    lo, hi = (p.float() for p in unpack_planes(w4))
    xf = x.float()
    total = None
    for g0, g1 in split_ranges(k, splits):
        acc = torch.zeros((t, o), dtype=torch.float32, device=x.device)
        for g in range(g0, g1):
            cols = slice(g * GROUP, (g + 1) * GROUP)
            for p, q in ((0, lo), (1, hi)):
                part = xf[:, p * k:(p + 1) * k][:, cols] @ q[:, cols].t()
                acc = acc + part * s4[:, p * kg + g][None, :]
        total = acc if total is None else total + acc
    return total.to(out_dtype)


def order_limit(x, w4, s4, splits, want):
    """Elementwise limit on |K6 - plain| at one shape. Both sum the same
    exact products (a bf16 value times a small integer) in fp32 in another
    order: the 128 of a group, the n_groups scaled partials and, in the
    kernel, the splits. Recursive summation of n terms errs by at most
    (n - 1) u sum |terms| to first order, so the two differ by at most
    2 n u S, S = sum_g |s_g| sum_c |x_c q_c|, n = 128 + n_groups + splits,
    with u = 2^-23 (not 2^-24: the tensor cores' adder may truncate). A bf16
    output adds one rounding of each: one bf16 ulp, 2^-7 |want|."""
    t, (o, _), n_groups = x.shape[0], w4.shape, s4.shape[1]
    qa = torch.cat(unpack_planes(w4), dim=1).abs().float()
    mag = torch.einsum("tgc,ogc->tgo", x.float().abs().reshape(t, n_groups, -1),
                       qa.reshape(o, n_groups, -1))
    mag = (mag * s4.abs().t()[None]).sum(dim=1)
    limit = 2 * (128 + n_groups + splits) * 2.0 ** -23 * mag
    if want.dtype == torch.bfloat16:
        limit = limit + 2.0 ** -7 * want.float().abs()
    return limit


def _validate(x, w4, s4, out_dtype):
    """What the kernel takes, apart from the device."""
    if w4.device != x.device or s4.device != x.device:
        raise ValueError("q4mm_t: x, w4 and s4 must be on one device")
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
    if x.device.type == "cpu":
        return q4mm_t_plain(x, w4, s4, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q4mm_t: no kernel for device {x.device}")
    _validate(x, w4, s4, out_dtype)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"q4mm_t: tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return _launch(x, w4, s4, out_dtype, splits_for(*w4.shape, _sm_count(x.device.index)))


def _launch(x, w4, s4, out_dtype, splits: int) -> torch.Tensor:
    """Allocate out (and the split workspace), launch with `splits`, count.
    The arguments as q4mm_t has checked them; chip_smoke.py also calls it
    with other split counts, to time the plan against them."""
    global LAUNCHES
    (t, _), (o, k) = x.shape, w4.shape
    out = torch.empty((t, o), dtype=out_dtype, device=x.device)
    if t == 0:
        return out
    if not 1 <= splits <= k // GROUP:
        raise ValueError(f"q4mm_t: splits must be in [1, {k // GROUP}], got {splits}")
    ws = cnt = None
    if splits > 1:
        tiles = o // TILE_O
        ws = torch.empty((splits, tiles, -(-t // 16) * 16 * TILE_O), dtype=torch.float32,
                         device=x.device)
        cnt = _build.tile_counters(x.device, tiles, "q4_matmul")
    err = _build.load().smt_q4mm(
        x.data_ptr(), w4.data_ptr(), s4.data_ptr(), None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), out.data_ptr(), t, o, k, splits,
        _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "q4mm_t")
    LAUNCHES += 1
    return out
