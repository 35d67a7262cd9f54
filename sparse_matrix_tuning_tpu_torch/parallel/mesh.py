"""The process mesh of data-parallel training (counterpart of
`sparse_matrix_tuning_tpu.parallel.mesh`, its `data` axis).

The JAX package lays a (data, fsdp, tensor) mesh over its devices and
GSPMD inserts the collectives. Here each process of a `torchrun` (or
`torch.multiprocessing`) job holds a full replica on its own device, and
the steps call the collectives themselves:

  * every process builds the identical global batch and keeps its rows
    (rank_rows): rank r owns rows [i*B*D + r*B, i*B*D + (r+1)*B) of
    microbatch i, as JAX spreads each microbatch over the data axis;
  * a microbatch's loss is this rank's token-loss sum over the global
    microbatch's count of valid tokens (data/sft.shard_batch), so the SUM
    over ranks of the losses and grads is the global batch's, which is
    what JAX computes;
  * all_reduce_ sums the grads and the loss in place, in buckets of one
    dtype, after the last microbatch's backward and before anything reads
    them (the fp16 overflow test, the clip norm, the saliency
    accumulators);
  * assert_same checks that the ranks agree (the plan's fingerprint, the
    step).

The fsdp and tensor axes are not ported: make_mesh refuses them by name.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor")
BUCKET_MIB = 64  # the all-reduce's bucket cap


@dataclass
class Mesh:
    """A (data, fsdp, tensor) mesh of processes, one device each, of which
    only `data` may exceed 1. `group` runs the collectives on the device's
    tensors (None: the default group); `cpu_group` is a gloo group for
    object gathers and barriers. `stats` counts what all_reduce_ moved:
    bytes and calls."""
    shape: Tuple[int, int, int]
    rank: int
    device: torch.device
    group: Any = None
    cpu_group: Any = None
    stats: Dict[str, int] = field(default_factory=lambda: {"bytes": 0, "calls": 0})

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def world(self) -> int:
        return int(np.prod(self.shape))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)

    def reset_stats(self) -> None:
        self.stats.update(bytes=0, calls=0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group and return this process's device. Rank and
    world size default to torchrun's RANK and WORLD_SIZE; the device to
    cuda:LOCAL_RANK (a caller may pass its own: two ranks may share one
    card over gloo); the backend to NCCL for a CUDA device and gloo for the
    CPU; the rendezvous to torchrun's env:// (a single process without
    MASTER_ADDR takes a free localhost port); timeout_s bounds each
    collective (torch's default otherwise)."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise RuntimeError(f"world size {world} without MASTER_ADDR: launch the ranks "
                               "with torchrun, or pass init_method")
    if not dist.is_initialized():
        kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                **kw)
    return device


def make_mesh(mesh_shape: Optional[Sequence[int]], world: Optional[int] = None,
              device=None) -> Mesh:
    """The Mesh of the initialised process group: mesh_shape (data, fsdp,
    tensor) must multiply to the world size, as JAX's make_mesh requires
    of its devices; fsdp and tensor above 1 are refused. Collective over
    the ranks where the backend is not gloo (it makes the gloo group)."""
    world = (dist.get_world_size() if dist.is_initialized() else 1) if world is None else world
    shape = tuple(int(s) for s in (mesh_shape or (world, 1, 1)))
    if len(shape) != len(AXES):
        raise ValueError(f"mesh_shape {shape}: give {len(AXES)} sizes, {AXES}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh_shape {shape} != world size {world} (their product must "
                         "equal the number of processes)")
    refuse_sharded_axes(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call init_distributed first")
    cpu_group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(shape, dist.get_rank(), torch.device(device), cpu_group=cpu_group)


def refuse_sharded_axes(shape: Sequence[int]) -> None:
    names = [f"{a} {s}" for a, s in zip(AXES[1:], shape[1:]) if int(s) > 1]
    if names:
        raise NotImplementedError(
            f"mesh_shape {tuple(shape)}: {', '.join(names)} not yet ported to "
            "sparse_matrix_tuning_tpu_torch (the fsdp and then the tensor axis are later "
            f"slices); data parallelism is --mesh_shape {int(np.prod(shape))},1,1")


def rank_rows(batch: Dict[str, Any], mesh: Mesh, accum: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch of accum * D * B rows (numpy or
    torch): of each of the `accum` contiguous microbatches, the rank's
    contiguous B rows, in order, so that the local batch splits into the
    same microbatches (steps.accumulated_value_and_grad)."""
    d, r = mesh.data, mesh.rank
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % (accum * d):
            raise ValueError(f"batch[{k!r}] has {n} rows: not a multiple of accumulation "
                             f"{accum} x data {d}")
        b = n // (accum * d)
        out[k] = v.reshape(accum, d, b, *v.shape[1:])[:, r].reshape(accum * b, *v.shape[1:])
    return out


def all_reduce_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """SUM each tensor over the ranks, in place: packed into contiguous
    buckets of one dtype (and device) of at most BUCKET_MIB MiB (a
    larger tensor is a bucket of its own, reduced where it lies), one
    dist.all_reduce a bucket, the sums copied back. A tensor listed twice
    (the shared activation taps of q/k/v) is reduced once."""
    cap = BUCKET_MIB * 2 ** 20
    groups: Dict[Tuple, list] = {}
    for t in {id(t): t for t in tensors}.values():
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts:
            nbytes = t.numel() * t.element_size()
            if bucket and size + nbytes > cap:
                _reduce_bucket(bucket, mesh)
                bucket, size = [], 0
            bucket.append(t)
            size += nbytes
        if bucket:
            _reduce_bucket(bucket, mesh)


def _reduce_bucket(ts, mesh: Mesh) -> None:
    if len(ts) == 1 and ts[0].is_contiguous():
        flat = ts[0]
        dist.all_reduce(flat, group=mesh.group)
    else:
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    mesh.stats["bytes"] += flat.numel() * flat.element_size()
    mesh.stats["calls"] += 1


def gather_objects(value, mesh: Mesh) -> list:
    """`value` of every rank, in rank order (dist.all_gather_object over
    the gloo group)."""
    out = [None] * mesh.world
    dist.all_gather_object(out, value, group=mesh.cpu_group)
    return out


def assert_same(what: str, value, mesh: Optional[Mesh]) -> None:
    """Raise unless every rank holds an equal `value`, naming the ranks
    whose value differs from rank 0's."""
    if mesh is None or mesh.world == 1:
        return
    values = gather_objects(value, mesh)
    differ = [r for r, v in enumerate(values) if v != values[0]]
    if differ:
        raise RuntimeError(f"{what} differs across ranks: ranks {differ} hold "
                           f"{[values[r] for r in differ]} against rank 0's {values[0]!r}")


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def leaf_checksums(tree: Dict[str, torch.Tensor]) -> Dict[str, Tuple[int, int]]:
    """Two sums of each leaf's bit patterns, computed where the leaf lies:
    the plain sum and one weighted by position (int64, wrapping), keyed as
    the flat tree. Equal checksums on every rank: bit-equal replicas."""
    out = {}
    for k, t in tree.items():
        words = t.detach().contiguous().reshape(-1).view(_WORDS[t.element_size()]).long()
        weight = torch.arange(words.numel(), device=words.device) % 1_000_003 + 1
        out[k] = (int(words.sum()), int((words * weight).sum()))
    return out
