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
does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

BLOCK = 256
LAUNCHES = 0  # kernel launches in this process

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class CorrectionSchedule:
    """Block coordinates grouped by out block, for one (idx_out, idx_in)
    list: run r covers the entries run_j[run_start[r]:run_start[r + 1]]
    (positions in the caller's order, so delta needs no permuted copy), all
    with out block run_o[r]. The int32 tensors live on `device`; the
    coordinates themselves stay on the host for the plain version."""
    idx_out: Tuple[int, ...]
    idx_in: Tuple[int, ...]
    n_runs: int
    run_o: torch.Tensor
    run_start: torch.Tensor
    run_j: torch.Tensor
    idx_in_dev: torch.Tensor


def correction_schedule(idx_out: Sequence[int], idx_in: Sequence[int],
                        device) -> CorrectionSchedule:
    """Sort the coordinates by out block (stable) and build CSR offsets over
    the runs of equal o: the kernel's precondition, made once per plan."""
    io = np.asarray(idx_out, dtype=np.int64).reshape(-1)
    ii = np.asarray(idx_in, dtype=np.int64).reshape(-1)
    if io.shape != ii.shape:
        raise ValueError("correction_schedule: idx_out and idx_in differ in length")
    if len(io) and (io.min() < 0 or ii.min() < 0):
        raise ValueError("correction_schedule: negative block coordinate")
    order = np.argsort(io, kind="stable")
    run_o, first = np.unique(io[order], return_index=True)
    run_start = np.append(first, len(io))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return CorrectionSchedule(tuple(int(v) for v in io), tuple(int(v) for v in ii),
                              len(run_o), dev(run_o), dev(run_start), dev(order), dev(ii))


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


def _check(out2, src2, delta, sched):
    if src2.device != out2.device or delta.device != out2.device \
            or sched.run_o.device != out2.device:
        raise ValueError("block_correction: out, src, delta and the schedule must be "
                         "on one device")
    if out2.device.index != torch.cuda.current_device():
        raise ValueError(f"block_correction: tensors on {out2.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if out2.dtype not in _DTYPE_CODE or src2.dtype != out2.dtype or delta.dtype != out2.dtype:
        raise TypeError(f"block_correction: out, src and delta must all be bf16 or fp32, "
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
    global LAUNCHES
    if len(sched.idx_out) == 0:
        return out2
    if out2.device.type == "cpu":
        return block_correction_plain(out2, src2, delta, sched.idx_out, sched.idx_in, transpose)
    if out2.device.type != "cuda":
        raise ValueError(f"block_correction: no kernel for device {out2.device}")
    _check(out2, src2, delta, sched)
    err = _build.load().smt_block_correction(
        out2.data_ptr(), src2.data_ptr(), delta.data_ptr(), sched.run_o.data_ptr(),
        sched.run_start.data_ptr(), sched.run_j.data_ptr(), sched.idx_in_dev.data_ptr(),
        out2.shape[0], out2.shape[1], src2.shape[1], sched.n_runs, int(bool(transpose)),
        _DTYPE_CODE[out2.dtype], torch.cuda.current_stream(out2.device).cuda_stream)
    _build.check(err, "block_correction")
    LAUNCHES += 1
    return out2
