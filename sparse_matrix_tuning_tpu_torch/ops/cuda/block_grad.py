"""K1 block_grad: selected-block weight gradients (csrc/block_grad.cu).

    out[i] = g[:, rb_i*256:+256]^T @ x[:, cb_i*256:+256]   (n, 256, 256) fp32

Replaces the Pallas kernel ops/pallas/block_grad.py of the JAX package.
`block_grad` launches the CUDA kernel on CUDA tensors and raises on what it
does not take; on CPU tensors it runs `block_grad_plain`, the plain PyTorch
version (the twin of the JAX `_block_grad_weight_xla` oracle).

The bf16 and fp16 kernels take a launch plan (`plan`): 64 or 128 rows of
a block per CTA and T split over CTAs in 64-token chunks, the splits' fp32
partials summed in the same launch in split order (`block_grad_split_model`
is that order in plain PyTorch). LAUNCHES counts the fp16 body apart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

BLOCK = 256
CHUNK = 64             # tokens per pipeline stage; a split is whole chunks
MIN_SPLIT_CHUNKS = 8   # a split streams at least 512 tokens
# kernel launches in this process: bf16 and fp32, and the fp16 body
LAUNCHES = {"block_grad": 0, "block_grad_fp16": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class BlockGradPlan(NamedTuple):
    bm: int      # rows of a block per CTA: 64 (one consumer warpgroup) or 128 (two)
    splits: int  # T split over this many CTAs per tile
    grid: int    # CTAs: n * (256 / bm) * splits


def plan(n: int, t: int, n_sm: int) -> BlockGradPlan:
    """The tile and T split that won where they were timed on the card
    (n 1 to 140 at T 2048, PERF.md). A CTA's products set its pace, so:
    64 x 256 tiles, which spread a block over four SMs, while they fit one
    wave; past that, 128 x 256 tiles, whose two warpgroups keep an SM's
    tensor cores busier. T is split over 4 or 2 CTAs only while the grid
    stays within half the SMs, each split at least MIN_SPLIT_CHUNKS
    chunks: beyond that the last CTA of a tile, which reads every split's
    partial, costs more than the split saves."""
    bm = 64 if n * (BLOCK // 64) <= n_sm else 128
    tiles = n * (BLOCK // bm)
    chunks = -(-t // CHUNK)
    splits = next((s for s in (4, 2)
                   if tiles * s <= n_sm // 2 and chunks // s >= MIN_SPLIT_CHUNKS), 1)
    return BlockGradPlan(bm, splits, tiles * splits)


def split_ranges(t: int, splits: int):
    """The token range [t0, t1) of each split, as the kernel takes them:
    split s covers chunks [s * C // splits, (s + 1) * C // splits) of the
    C = ceil(t / 64) chunks, the last cut at t."""
    chunks = -(-t // CHUNK)
    return [(s * chunks // splits * CHUNK, min(t, (s + 1) * chunks // splits * CHUNK))
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_grad_plain(g2: torch.Tensor, x2: torch.Tensor, rb: torch.Tensor,
                     cb: torch.Tensor) -> torch.Tensor:
    """Gather the row/col panels, cast them to fp32 (exact for bf16 and fp16), one
    batched matmul: (n, 256, 256) fp32."""
    t = g2.shape[0]
    g_rows = g2.reshape(t, -1, BLOCK).index_select(1, rb.long()).transpose(0, 1)
    x_cols = x2.reshape(t, -1, BLOCK).index_select(1, cb.long()).transpose(0, 1)
    return torch.bmm(g_rows.float().transpose(1, 2), x_cols.float())


def block_grad_split_model(g2, x2, rb, cb, splits: int, drop=None) -> torch.Tensor:
    """A plain model of the bf16 kernel's summation order: each split sums
    the fp32 products of its 64-token chunks in chunk order, and the
    splits' partials are added in split order 0, 1, .... Within a chunk the
    order is torch's (the tensor cores' is not modelled). `drop`: a split
    left out of the sum (the fault a check on the card must reject)."""
    total = None
    for s, (t0, t1) in enumerate(split_ranges(g2.shape[0], splits)):
        part = torch.zeros((rb.shape[0], BLOCK, BLOCK), dtype=torch.float32, device=g2.device)
        for c0 in range(t0, t1, CHUNK):
            c1 = min(c0 + CHUNK, t1)
            part = part + block_grad_plain(g2[c0:c1], x2[c0:c1], rb, cb)
        if s != drop:
            total = part if total is None else total + part
    return total


def _validate(g2, x2, rb, cb):
    """What the kernel takes, apart from the device."""
    if x2.device != g2.device or rb.device != g2.device or cb.device != g2.device:
        raise ValueError("block_grad: g2, x2, rb, cb must be on one device")
    if g2.dtype not in _DTYPE_CODE or x2.dtype != g2.dtype:
        raise TypeError(f"block_grad: g2/x2 must both be bf16, fp16 or fp32, got "
                        f"{g2.dtype}/{x2.dtype}")
    if g2.dim() != 2 or x2.dim() != 2 or g2.shape[0] != x2.shape[0]:
        raise ValueError(f"block_grad: want g2 (T, O), x2 (T, I), got "
                         f"{tuple(g2.shape)}, {tuple(x2.shape)}")
    if g2.shape[1] % BLOCK or x2.shape[1] % BLOCK:
        raise ValueError("block_grad: O and I must be multiples of 256")
    if not (g2.is_contiguous() and x2.is_contiguous()):
        raise ValueError("block_grad: g2 and x2 must be contiguous")
    # TMA (bf16, fp16) and the 16-byte vector loads (fp32): 16-byte aligned bases;
    # the row strides are multiples of 512 bytes
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
    if g2.device.type == "cpu":
        return block_grad_plain(g2, x2, rb, cb)
    if g2.device.type != "cuda":
        raise ValueError(f"block_grad: no kernel for device {g2.device}")
    _validate(g2, x2, rb, cb)
    if g2.device.index != torch.cuda.current_device():
        raise ValueError(f"block_grad: tensors on {g2.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    p = plan(rb.shape[0], g2.shape[0], _sm_count(g2.device.index))
    return _launch(g2, x2, rb, cb, p.bm, p.splits)


def _launch(g2, x2, rb, cb, bm: int, splits: int) -> torch.Tensor:
    """Allocate out (and the split workspace), launch with (bm, splits),
    count. The arguments as block_grad has checked them; chip_smoke.py also
    calls it with other plans, to time the plan against them."""
    (t, o), n = g2.shape, rb.shape[0]
    out = torch.empty((n, BLOCK, BLOCK), dtype=torch.float32, device=g2.device)
    if n == 0:
        return out
    if t == 0:
        return out.zero_()
    half = g2.dtype != torch.float32  # the wgmma bodies, bf16 and fp16
    if half and (bm not in (64, 128) or not 1 <= splits <= -(-t // CHUNK)):
        raise ValueError(f"block_grad: want bm 64 or 128 and splits in [1, {-(-t // CHUNK)}], "
                         f"got {bm}, {splits}")
    ws = cnt = None
    if half and splits > 1:
        ws = torch.empty((splits, n, BLOCK, BLOCK), dtype=torch.float32, device=g2.device)
        cnt = _build.tile_counters(g2.device, n * (BLOCK // bm), "block_grad")
    err = _build.load().smt_block_grad(
        g2.data_ptr(), x2.data_ptr(), rb.data_ptr(), cb.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
        t, o, x2.shape[1], n, bm, splits, _DTYPE_CODE[g2.dtype],
        torch.cuda.current_stream(g2.device).cuda_stream)
    _build.check(err, "block_grad")
    LAUNCHES["block_grad_fp16" if g2.dtype == torch.float16 else "block_grad"] += 1
    return out
