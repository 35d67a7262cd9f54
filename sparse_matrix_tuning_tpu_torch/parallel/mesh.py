"""The process mesh of multi-process training (counterpart of
`sparse_matrix_tuning_tpu.parallel.mesh`, its `data` and `fsdp` axes).

The JAX package lays a (data, fsdp, tensor) mesh over its devices and
GSPMD inserts the collectives. Here each process of a `torchrun` (or
`torch.multiprocessing`) job drives one device, and the steps call the
collectives themselves. JAX reshapes its devices row-major into (D, F, T),
so rank r sits at data index r // F and fsdp index r % F:

  * every process builds the identical global batch and keeps its rows
    (rank_rows): JAX splits the batch over ("data", "fsdp"), so rank r
    owns row slice r of the D*F slices of every microbatch;
  * a microbatch's loss is this rank's token-loss sum over the global
    microbatch's count of valid tokens (data/sft.shard_batch), so the SUM
    over ranks of the losses and grads is the global batch's, which is
    what JAX computes;
  * all_reduce_ sums the grads and the loss in place, in buckets of one
    dtype, over the whole world, the data group or the fsdp group, after
    the last microbatch's backward and before anything reads them (the
    fp16 overflow test, the clip norm, the saliency accumulators);
  * over fsdp (F > 1, parallel/fsdp.py) each rank holds 1/F of the leaves
    JAX shards: all_gather_ gathers a layer's shards while it runs, and
    reduce_scatter_ sums its grads over the fsdp group and keeps this
    rank's slice. On NCCL they are all_gather_into_tensor and
    reduce_scatter_tensor. On gloo (the CPU, and ranks sharing one card)
    both are built from all_reduce, the collective whose CUDA support
    gloo documents: the all-gather sums the ranks' shards placed in a
    zeroed buffer (exact: each element is one shard's value plus zeros),
    the reduce-scatter sums the whole buffer and keeps the rank's slice.
    They move F times the bytes of the NCCL forms, yet with two ranks on
    one NVIDIA H100 80GB HBM3 (700 W) they ran a TinyLlama warm-up step
    twice as fast as gloo's own all-gather and reduce-scatter over host
    copies of the CUDA tensors (PERF.md, PR 14);
  * assert_same checks that the ranks agree (the plan's fingerprint, the
    step).

The tensor axis is not ported: make_mesh refuses it by name.
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
    """A (data, fsdp, tensor) mesh of processes, one device each, with
    tensor 1. `group` runs the collectives over the whole world (None: the
    default group), `data_group` over the ranks of this rank's fsdp index,
    `fsdp_group` over the ranks of its data index (None where the axis
    spans the world); `cpu_group` is a gloo group for object gathers and
    barriers. `stats` counts what the collectives moved: all-reduced bytes
    and calls, and the all-gathers' ("gather_*", the gathered tensors'
    bytes) and reduce-scatters' ("scatter_*", the summed tensors' bytes)."""
    shape: Tuple[int, int, int]
    rank: int
    device: torch.device
    group: Any = None
    cpu_group: Any = None
    data_group: Any = None
    fsdp_group: Any = None
    stats: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(STAT_KEYS, 0))

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def fsdp(self) -> int:
        return self.shape[1]

    @property
    def world(self) -> int:
        return int(np.prod(self.shape))

    @property
    def batch_shards(self) -> int:
        """The row slices of each microbatch: JAX splits the batch over
        ("data", "fsdp")."""
        return self.shape[0] * self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.shape[1]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)

    def reset_stats(self) -> None:
        self.stats.update(dict.fromkeys(STAT_KEYS, 0))

    def axis(self, over: str):
        """(size, group) of the collectives over "world", "data" or "fsdp"."""
        return {"world": (self.world, self.group), "data": (self.data, self.data_group),
                "fsdp": (self.fsdp, self.fsdp_group)}[over]


STAT_KEYS = ("bytes", "calls", "gather_bytes", "gather_calls", "scatter_bytes",
             "scatter_calls")


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
    of its devices, and None puts every rank on fsdp, (1, world, 1), JAX's
    default; tensor above 1 is refused. Collective over the ranks: every
    rank makes the data and fsdp groups in the same order (and the gloo
    group where the backend is not gloo)."""
    world = (dist.get_world_size() if dist.is_initialized() else 1) if world is None else world
    shape = tuple(int(s) for s in (mesh_shape or (1, world, 1)))
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
    mesh = Mesh(shape, dist.get_rank(), torch.device(device), cpu_group=cpu_group)
    d, f = shape[0], shape[1]
    if d > 1 and f > 1:  # one group per data index, then one per fsdp index
        for i in range(d):
            g = dist.new_group([i * f + j for j in range(f)])
            if i == mesh.data_index:
                mesh.fsdp_group = g
        for j in range(f):
            g = dist.new_group([i * f + j for i in range(d)])
            if j == mesh.fsdp_index:
                mesh.data_group = g
    return mesh


def refuse_sharded_axes(shape: Sequence[int]) -> None:
    if int(shape[2]) > 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(shape)}: tensor {int(shape[2])} not yet ported to "
            "sparse_matrix_tuning_tpu_torch (the tensor axis is a later slice); the data and "
            f"fsdp axes are ported, e.g. --mesh_shape 1,{int(np.prod(shape))},1")


def rank_rows(batch: Dict[str, Any], mesh: Mesh, accum: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch of accum * D * F * B rows (numpy
    or torch): of each of the `accum` contiguous microbatches, row slice
    `rank` of its D * F contiguous slices of B rows (JAX's batch split over
    ("data", "fsdp"), row-major), so that the local batch splits into the
    same microbatches (steps.accumulated_value_and_grad)."""
    n_sh, r = mesh.batch_shards, mesh.rank
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % (accum * n_sh):
            raise ValueError(f"batch[{k!r}] has {n} rows: not a multiple of accumulation "
                             f"{accum} x data*fsdp {n_sh}")
        b = n // (accum * n_sh)
        out[k] = v.reshape(accum, n_sh, b, *v.shape[1:])[:, r].reshape(accum * b, *v.shape[1:])
    return out


def all_reduce_(tensors: Iterable[torch.Tensor], mesh: Mesh, over: str = "world") -> None:
    """SUM each tensor over the ranks of `over` ("world", "data" or
    "fsdp"; nothing where the data or fsdp axis is 1), in place: packed into
    contiguous buckets of one dtype (and device) of at most BUCKET_MIB MiB
    (a larger tensor is a bucket of its own, reduced where it lies), one
    dist.all_reduce a bucket, the sums copied back. A tensor listed twice
    (the shared activation taps of q/k/v) is reduced once."""
    size, group = mesh.axis(over)
    if size == 1 and over != "world":
        return
    cap = BUCKET_MIB * 2 ** 20
    groups: Dict[Tuple, list] = {}
    for t in {id(t): t for t in tensors}.values():
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        bucket, nbytes_in = [], 0
        for t in ts:
            nbytes = t.numel() * t.element_size()
            if bucket and nbytes_in + nbytes > cap:
                _reduce_bucket(bucket, mesh, group)
                bucket, nbytes_in = [], 0
            bucket.append(t)
            nbytes_in += nbytes
        if bucket:
            _reduce_bucket(bucket, mesh, group)


def _reduce_bucket(ts, mesh: Mesh, group) -> None:
    if len(ts) == 1 and ts[0].is_contiguous():
        flat = ts[0]
        dist.all_reduce(flat, group=group)
    else:
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    mesh.stats["bytes"] += flat.numel() * flat.element_size()
    mesh.stats["calls"] += 1


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_gather_(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The fsdp group's 1-D shards, in fsdp order: a new (F * n,) tensor.
    NCCL: all_gather_into_tensor. Gloo: built from all_reduce (module
    notes), chosen by the backend."""
    f, group = mesh.axis("fsdp")
    n = shard.numel()
    if _gloo(group):
        out = torch.zeros(f * n, dtype=shard.dtype, device=shard.device)
        out[mesh.fsdp_index * n:(mesh.fsdp_index + 1) * n] = shard.reshape(-1)
        dist.all_reduce(out, group=group)
    else:
        out = torch.empty(f * n, dtype=shard.dtype, device=shard.device)
        dist.all_gather_into_tensor(out, shard.reshape(-1).contiguous(), group=group)
    mesh.stats["gather_bytes"] += out.numel() * out.element_size()
    mesh.stats["gather_calls"] += 1
    return out


def reduce_scatter_(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum a 1-D (F * n,) tensor over the fsdp group and return this rank's
    n-slice of the sum (a new tensor). NCCL: reduce_scatter_tensor. Gloo:
    all_reduce of the whole (in place: `full` is the caller's scratch),
    then the slice (module notes)."""
    f, group = mesh.axis("fsdp")
    n = full.numel() // f
    if _gloo(group):
        dist.all_reduce(full, group=group)
        out = full[mesh.fsdp_index * n:(mesh.fsdp_index + 1) * n].clone()
    else:
        out = torch.empty(n, dtype=full.dtype, device=full.device)
        dist.reduce_scatter_tensor(out, full.contiguous(), group=group)
    mesh.stats["scatter_bytes"] += full.numel() * full.element_size()
    mesh.stats["scatter_calls"] += 1
    return out


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
