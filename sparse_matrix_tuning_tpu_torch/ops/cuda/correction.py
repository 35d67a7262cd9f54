"""K5 block_correction: the exact selected-block correction of the int8
sparse linears, in place (csrc/correction.cu).

    out[:, o_j*256:+256] += src[:, i_j*256:+256] @ D_j        j = 0..n-1
    D_j = delta[j], or delta[j]^T with transpose=True

with fp32 accumulation over each run of equal o and one rounding per
touched out tile. Replaces the Pallas kernel `block_correction_dyn` of the
JAX package (ops/pallas/correction.py) and its sorting wrapper
`block_correction`. `block_correction` launches the CUDA kernel on CUDA
tensors and raises on what it does not take; on CPU tensors it runs
`block_correction_plain`, which rounds once per out block as the kernel
does. The bf16 and fp16 kernels take a launch plan (`plan`: token rows
and out columns per CTA); `block_correction_order_model` is their summation
order in plain PyTorch. LAUNCHES counts the fp16 body apart.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

BLOCK = 256
CHUNK = 64    # contraction elements per pipeline stage
# kernel launches in this process: bf16 and fp32, and the fp16 body
LAUNCHES = {"block_correction": 0, "block_correction_fp16": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the wgmma bodies' tile shapes (token rows, out columns per CTA), bf16 and fp16
HALF_PLANS = ((128, 256), (64, 256), (64, 128), (64, 64))


@dataclass(frozen=True)
class CorrectionSchedule:
    """Block coordinates grouped by out block, for one (idx_out, idx_in)
    list: run r covers the entries run_j[run_start[r]:run_start[r + 1]]
    (positions in the caller's order, so delta needs no permuted copy), all
    with out block run_o[r]; the runs longest first (ties by out block), so
    that the kernel starts the CTAs that take longest first. The int32
    tensors live on `device`; the coordinates themselves stay on the host
    for the plain version."""
    idx_out: Tuple[int, ...]
    idx_in: Tuple[int, ...]
    n_runs: int
    run_o: torch.Tensor
    run_start: torch.Tensor
    run_j: torch.Tensor
    idx_in_dev: torch.Tensor


def correction_schedule(idx_out: Sequence[int], idx_in: Sequence[int],
                        device) -> CorrectionSchedule:
    """Group the coordinates by out block (each run in the caller's order),
    order the runs longest first, and build CSR offsets over them: the
    kernel's precondition, made once per plan."""
    io = np.asarray(idx_out, dtype=np.int64).reshape(-1)
    ii = np.asarray(idx_in, dtype=np.int64).reshape(-1)
    if io.shape != ii.shape:
        raise ValueError("correction_schedule: idx_out and idx_in differ in length")
    if len(io) and (io.min() < 0 or ii.min() < 0):
        raise ValueError("correction_schedule: negative block coordinate")
    blocks, which, counts = np.unique(io, return_inverse=True, return_counts=True)
    longest = np.argsort(-counts, kind="stable")       # run r is out block blocks[longest[r]]
    run_of = np.empty_like(longest)
    run_of[longest] = np.arange(len(longest))
    order = np.argsort(run_of[which.reshape(-1)], kind="stable")
    run_o = blocks[longest]
    run_start = np.append(0, np.cumsum(counts[longest]))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return CorrectionSchedule(tuple(int(v) for v in io), tuple(int(v) for v in ii),
                              len(run_o), dev(run_o), dev(run_start), dev(order), dev(ii))


class CorrectionPlan(NamedTuple):
    bm: int    # token rows per CTA (128: two consumer warpgroups)
    bn: int    # out columns per CTA: 256, or the block split over 2 or 4 CTAs
    grid: int  # CTAs: runs * ceil(T / bm) * (256 / bn)


def plan(runs: int, t: int, n_sm: int) -> CorrectionPlan:
    """128 x 256 tiles when the runs times the 128-row tiles fill the SMs
    (and T is more than one 64-row tile); 64-row tiles below that; and
    where even those leave SMs idle (decode rows, a single run), the 256
    columns split over 4 or 2 CTAs, as many as keep the grid within the
    SMs, so that delta streams through more SMs. At every n timed on the
    card (1 to 140, T 2048 and 64) this was the best tile shape or within
    2% of it (PERF.md)."""
    if t > 64 and runs * -(-t // 128) >= n_sm:
        return CorrectionPlan(128, 256, runs * -(-t // 128))
    tiles = runs * -(-t // 64)
    col_splits = next((s for s in (4, 2) if tiles * s <= n_sm), 1)
    return CorrectionPlan(64, BLOCK // col_splits, tiles * col_splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_correction_plain(out2: torch.Tensor, src2: torch.Tensor, delta: torch.Tensor,
                           idx_out: Sequence[int], idx_in: Sequence[int],
                           transpose: bool = False) -> torch.Tensor:
    """The plain PyTorch version, in place on out2: for each out block, its
    tile and every contribution src_panel @ D_j summed in fp32, then one
    rounding to out2's dtype."""
    runs: dict = {}
    for j, o in enumerate(idx_out):
        runs.setdefault(int(o), []).append(j)
    for o, js in sorted(runs.items()):
        cols = slice(o * BLOCK, (o + 1) * BLOCK)
        acc = out2[:, cols].float()
        for j in js:
            i = int(idx_in[j])
            d = delta[j].float()
            acc = acc + src2[:, i * BLOCK:(i + 1) * BLOCK].float() @ (d.t() if transpose else d)
        out2[:, cols] = acc.to(out2.dtype)
    return out2


def block_correction_order_model(out2, src2, delta, idx_out, idx_in,
                                 transpose: bool = False) -> torch.Tensor:
    """A plain model of the bf16 and fp16 kernels' summation order, in place on
    out2: each out block's fp32 accumulator is seeded from its tile, then
    takes, for each j of its run in the caller's order and each 64-element
    chunk of the contraction in order, that chunk's fp32 product; one
    rounding at the end. Within a chunk the order is torch's (the tensor
    cores' is not modelled); a split of the columns over CTAs does not
    change any element's order."""
    runs: dict = {}
    for j, o in enumerate(idx_out):
        runs.setdefault(int(o), []).append(j)
    for o, js in sorted(runs.items()):
        cols = slice(o * BLOCK, (o + 1) * BLOCK)
        acc = out2[:, cols].float()
        for j in js:
            i = int(idx_in[j])
            d = delta[j].float()
            d = d.t() if transpose else d
            for k0 in range(0, BLOCK, CHUNK):
                panel = src2[:, i * BLOCK + k0:i * BLOCK + k0 + CHUNK].float()
                acc = acc + panel @ d[k0:k0 + CHUNK]
        out2[:, cols] = acc.to(out2.dtype)
    return out2


def _validate(out2, src2, delta, sched):
    """What the kernel takes, apart from the device."""
    if src2.device != out2.device or delta.device != out2.device \
            or sched.run_o.device != out2.device:
        raise ValueError("block_correction: out, src, delta and the schedule must be "
                         "on one device")
    if out2.dtype not in _DTYPE_CODE or src2.dtype != out2.dtype or delta.dtype != out2.dtype:
        raise TypeError(f"block_correction: out, src and delta must all be bf16, fp16 or "
                        f"fp32, "
                        f"got {out2.dtype}/{src2.dtype}/{delta.dtype}")
    if out2.dim() != 2 or src2.dim() != 2 or out2.shape[0] != src2.shape[0]:
        raise ValueError(f"block_correction: want out (T, O), src (T, I), got "
                         f"{tuple(out2.shape)}, {tuple(src2.shape)}")
    if out2.shape[1] % BLOCK or src2.shape[1] % BLOCK:
        raise ValueError("block_correction: O and I must be multiples of 256")
    n = len(sched.idx_out)
    if tuple(delta.shape) != (n, BLOCK, BLOCK):
        raise ValueError(f"block_correction: want delta ({n}, 256, 256), got "
                         f"{tuple(delta.shape)}")
    if max(sched.idx_out) >= out2.shape[1] // BLOCK or max(sched.idx_in) >= src2.shape[1] // BLOCK:
        raise ValueError("block_correction: block coordinate out of range")
    if not (out2.is_contiguous() and src2.is_contiguous() and delta.is_contiguous()):
        raise ValueError("block_correction: out, src and delta must be contiguous")
    # TMA (bf16, fp16) and the 16-byte vector loads (fp32): 16-byte aligned bases;
    # the row strides are multiples of 512 bytes
    if out2.data_ptr() % 16 or src2.data_ptr() % 16 or delta.data_ptr() % 16:
        raise ValueError("block_correction: out, src and delta must be 16-byte aligned")
    if max(out2.shape[0], out2.shape[1], src2.shape[1]) >= 2 ** 31:
        raise ValueError("block_correction: dimensions must fit in int32")


def block_correction(out2: torch.Tensor, src2: torch.Tensor, delta: torch.Tensor,
                     sched: CorrectionSchedule, transpose: bool = False) -> torch.Tensor:
    """out2 (T, O) updated IN PLACE and returned; src2 (T, I); delta
    (n, 256, 256) in their dtype; sched: correction_schedule(idx_out,
    idx_in, device) for the n coordinates, in any order. n = 0 leaves out2
    untouched."""
    if len(sched.idx_out) == 0:
        return out2
    if out2.device.type == "cpu":
        return block_correction_plain(out2, src2, delta, sched.idx_out, sched.idx_in, transpose)
    if out2.device.type != "cuda":
        raise ValueError(f"block_correction: no kernel for device {out2.device}")
    _validate(out2, src2, delta, sched)
    if out2.device.index != torch.cuda.current_device():
        raise ValueError(f"block_correction: tensors on {out2.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    p = plan(sched.n_runs, out2.shape[0], _sm_count(out2.device.index))
    return _launch(out2, src2, delta, sched, transpose, p.bm, p.bn)


def _launch(out2, src2, delta, sched, transpose, bm: int, bn: int) -> torch.Tensor:
    """Launch with (bm, bn) tiles and count. The arguments as
    block_correction has checked them; chip_smoke.py also calls it with
    other plans, to time the plan against them."""
    if out2.dtype != torch.float32 and (bm, bn) not in HALF_PLANS:
        raise ValueError(f"block_correction: no {out2.dtype} kernel for {bm} x {bn} tiles")
    err = _build.load().smt_block_correction(
        out2.data_ptr(), src2.data_ptr(), delta.data_ptr(), sched.run_o.data_ptr(),
        sched.run_start.data_ptr(), sched.run_j.data_ptr(), sched.idx_in_dev.data_ptr(),
        out2.shape[0], out2.shape[1], src2.shape[1], sched.n_runs, len(sched.idx_out),
        int(bool(transpose)), _DTYPE_CODE[out2.dtype], bm, bn,
        torch.cuda.current_stream(out2.device).cuda_stream)
    _build.check(err, "block_correction")
    LAUNCHES["block_correction_fp16" if out2.dtype == torch.float16 else "block_correction"] += 1
    return out2
