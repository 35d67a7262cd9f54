"""The process mesh of multi-process training (counterpart of
`sparse_matrix_tuning_tpu.parallel.mesh`, its data, fsdp and tensor axes).

The JAX package lays a (data, fsdp, tensor) mesh over its devices and
GSPMD inserts the collectives. Here each process of a `torchrun` (or
`torch.multiprocessing`) job drives one device, and the steps call the
collectives themselves. JAX reshapes its devices row-major into (D, F, T),
so rank r = (d * F + f) * T + t sits at data index d, fsdp index f and
tensor index t:

  * every process builds the identical global batch and keeps its rows
    (rank_rows): JAX splits the batch over ("data", "fsdp") only, so the
    rank of batch index d * F + f owns row slice d * F + f of the D*F
    slices of every microbatch, and the T ranks of a tensor group see the
    same rows;
  * a microbatch's loss is this rank's token-loss sum over the global
    microbatch's count of valid tokens (data/sft.shard_batch), so the SUM
    over the batch group (the D*F ranks of one tensor index) of the losses
    and grads is the global batch's, which is what JAX computes;
  * all_reduce_ sums the grads and the loss in place, in buckets of one
    dtype, over the whole world or one axis group ("data", "fsdp",
    "tensor", "batch"), after the last microbatch's backward and before
    anything reads them (the fp16 overflow test, the clip norm, the
    saliency accumulators);
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
  * over tensor (T > 1, parallel/tensor.py) the layers are Megatron's
    column- and row-parallel linears and the head is split over the
    vocabulary: the activations' all-reduces and the embedding's
    all-gather run over the tensor group (counted in "tensor_*");
  * assert_same checks that the ranks agree (the plan's fingerprint, the
    step).
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
    """A (data, fsdp, tensor) mesh of processes, one device each. `group`
    runs the collectives over the whole world (None: the default group),
    `data_group` over the D ranks of this rank's (fsdp, tensor) index,
    `fsdp_group` over the F ranks of its (data, tensor) index,
    `tensor_group` over the T ranks of its (data, fsdp) index and
    `batch_group` over the D*F ranks of its tensor index (each None where
    it spans the world); `cpu_group` is a gloo group for object gathers
    and barriers. `stats` counts what the collectives moved: all-reduced
    bytes and calls, the all-gathers' ("gather_*", the gathered tensors'
    bytes) and reduce-scatters' ("scatter_*", the summed tensors' bytes)
    over fsdp, and the tensor group's all-reduces and all-gathers
    ("tensor_*", the reduced or gathered tensors' bytes), the int8 row
    quantization's amax MAX-reduces over tensor apart ("tensor_amax_*"),
    and, among the all-reduced, the sums of the tensor ranks' block-grad
    (or column-grad) parts ("grad_parts_*", train/steps._sum_parts) and
    the channel warm-up's activation taps with its loss ("taps_*",
    steps.build_channel_warmup_step), and, among the tensor group's
    all-gathers, a tied head's ("tied_*", parallel/tensor.tied_head_rows;
    the gathered tensors' bytes) and, where T cuts the attention heads, the
    q/k/v activations' all-gathers and their grads' reduce-scatters
    ("heads_*", parallel/tensor.gather_heads; the gathered and the summed
    tensors' bytes)."""
    shape: Tuple[int, int, int]
    rank: int
    device: torch.device
    group: Any = None
    cpu_group: Any = None
    data_group: Any = None
    fsdp_group: Any = None
    tensor_group: Any = None
    batch_group: Any = None
    stats: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(STAT_KEYS, 0))

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def fsdp(self) -> int:
        return self.shape[1]

    @property
    def tensor(self) -> int:
        return self.shape[2]

    @property
    def world(self) -> int:
        return int(np.prod(self.shape))

    @property
    def batch_shards(self) -> int:
        """The row slices of each microbatch: JAX splits the batch over
        ("data", "fsdp")."""
        return self.shape[0] * self.shape[1]

    @property
    def batch_index(self) -> int:
        """Which of the batch_shards row slices this rank owns: d * F + f."""
        return self.rank // self.shape[2]

    @property
    def data_index(self) -> int:
        return self.batch_index // self.shape[1]

    @property
    def fsdp_index(self) -> int:
        return self.batch_index % self.shape[1]

    @property
    def tensor_index(self) -> int:
        return self.rank % self.shape[2]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)

    def reset_stats(self) -> None:
        self.stats.update(dict.fromkeys(STAT_KEYS, 0))

    def axis(self, over: str):
        """(size, group) of the collectives over "world", "data", "fsdp",
        "tensor" or "batch" (data x fsdp)."""
        return {"world": (self.world, self.group), "data": (self.data, self.data_group),
                "fsdp": (self.fsdp, self.fsdp_group),
                "tensor": (self.tensor, self.tensor_group),
                "batch": (self.batch_shards, self.batch_group)}[over]


STAT_KEYS = ("bytes", "calls", "gather_bytes", "gather_calls", "scatter_bytes",
             "scatter_calls", "tensor_bytes", "tensor_calls", "tensor_amax_bytes",
             "tensor_amax_calls", "grad_parts_bytes", "grad_parts_calls", "taps_bytes",
             "taps_calls", "tied_bytes", "tied_calls", "heads_bytes", "heads_calls")


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
    default. Collective over the ranks: every rank makes the axis groups
    in the same order (and the gloo group where the backend is not gloo)."""
    world = (dist.get_world_size() if dist.is_initialized() else 1) if world is None else world
    shape = tuple(int(s) for s in (mesh_shape or (1, world, 1)))
    if len(shape) != len(AXES):
        raise ValueError(f"mesh_shape {shape}: give {len(AXES)} sizes, {AXES}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh_shape {shape} != world size {world} (their product must "
                         "equal the number of processes)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call init_distributed first")
    cpu_group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    mesh = Mesh(shape, dist.get_rank(), torch.device(device), cpu_group=cpu_group)
    for axis, members in axis_groups(shape).items():
        if 1 < len(members[0]) < world:  # an axis of 1 or the whole world needs no group
            for ranks in members:
                g = dist.new_group(ranks)
                if mesh.rank in ranks:
                    setattr(mesh, f"{axis}_group", g)
    return mesh


def axis_groups(shape: Sequence[int]) -> Dict[str, list]:
    """{axis: the rank lists of its groups} of a (D, F, T) mesh, rank
    (d * F + f) * T + t: "fsdp" a group per (d, t), "data" per (f, t),
    "tensor" per (d, f), "batch" (data x fsdp) per t; in a fixed order,
    so that every rank creates them alike."""
    d, f, t = (int(s) for s in shape)
    rank = lambda i, j, k: (i * f + j) * t + k  # noqa: E731
    return {"fsdp": [[rank(i, j, k) for j in range(f)] for i in range(d) for k in range(t)],
            "data": [[rank(i, j, k) for i in range(d)] for j in range(f) for k in range(t)],
            "tensor": [[rank(i, j, k) for k in range(t)] for i in range(d) for j in range(f)],
            "batch": [[rank(i, j, k) for i in range(d) for j in range(f)] for k in range(t)]}


def refuse_sharded_axes(shape: Sequence[int], cfg=None) -> None:
    """Refuse, by name, what the tensor axis (tensor above 1) does not yet
    run: of the options of `cfg` (an SMTConfig), --sparse_from_plan. Matrix
    and channel mode over the dense or the int8 base (and head), in the
    per-layer or the scan layout, with or without --dropout, are taken. The
    data and fsdp axes take everything (--sparse_from_plan aside:
    config._check_mesh)."""
    t = int(shape[2])
    if t == 1 or cfg is None:
        return
    if cfg.sparse_from_plan:
        raise NotImplementedError(
            f"mesh_shape {tuple(shape)}: --sparse_from_plan (its JAX entry runs on one device) "
            f"with tensor {t} not yet ported to sparse_matrix_tuning_tpu_torch; the tensor axis "
            "runs matrix and channel mode over the dense or the int8 base, in the per-layer or "
            "the scan layout, with or without --dropout")


def refuse_tensor_model(model_cfg, t: int) -> None:
    """Refuse, by name, a model with a leaf dim that JAX splits over
    "tensor" and T does not divide: q's and k/v's rows (hq * hd, hkv *
    hd), the intermediate width, the hidden width and the vocabulary. JAX's
    _fit keeps such a leaf whole; the port names it instead. A T that cuts
    the attention heads (divides those dims, not the head counts) is
    taken: the layers gather q/k/v for attention (models/llama.cut_heads),
    as are a tied head and q/k/v biases (Qwen2/2.5)."""
    if t == 1:
        return
    c = model_cfg
    hd = c.head_dim
    dims = {"q_proj rows": c.num_attention_heads * hd,
            "k_proj/v_proj rows": c.num_key_value_heads * hd,
            "intermediate_size": c.intermediate_size, "hidden_size": c.hidden_size,
            "vocab_size": c.vocab_size}
    refused = [f"{k} {v}" for k, v in dims.items() if v % t]
    if refused:
        raise NotImplementedError(
            f"tensor {t}: " + ", ".join(refused) + " not yet ported to "
            "sparse_matrix_tuning_tpu_torch under the tensor axis: JAX keeps a leaf dim that "
            "T does not divide whole (its state_shardings' _fit); T must divide every dim "
            "the tensor axis splits")


def rank_rows(batch: Dict[str, Any], mesh: Mesh, accum: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch of accum * D * F * B rows (numpy
    or torch): of each of the `accum` contiguous microbatches, row slice
    batch_index of its D * F contiguous slices of B rows (JAX's batch split
    over ("data", "fsdp"), row-major; a tensor group shares its rows), so
    that the local batch splits into the same microbatches
    (steps.accumulated_value_and_grad)."""
    n_sh, r = mesh.batch_shards, mesh.batch_index
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % (accum * n_sh):
            raise ValueError(f"batch[{k!r}] has {n} rows: not a multiple of accumulation "
                             f"{accum} x data*fsdp {n_sh}")
        b = n // (accum * n_sh)
        out[k] = v.reshape(accum, n_sh, b, *v.shape[1:])[:, r].reshape(accum * b, *v.shape[1:])
    return out


def all_reduce_(tensors: Iterable[torch.Tensor], mesh: Mesh, over: str = "world",
                stat: Optional[str] = None) -> None:
    """SUM each tensor over the ranks of `over` ("world", or an axis group:
    "data", "fsdp", "tensor", "batch"; nothing where it has one rank), in
    place: packed into
    contiguous buckets of one dtype (and device) of at most BUCKET_MIB MiB
    (a larger tensor is a bucket of its own, reduced where it lies), one
    dist.all_reduce a bucket, the sums copied back. A tensor listed twice
    (the shared activation taps of q/k/v) is reduced once. Counted in
    mesh.stats["bytes" / "calls"], and with stat in its own
    "{stat}_bytes" / "_calls" too."""
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
                _reduce_bucket(bucket, mesh, group, stat)
                bucket, nbytes_in = [], 0
            bucket.append(t)
            nbytes_in += nbytes
        if bucket:
            _reduce_bucket(bucket, mesh, group, stat)


def _reduce_bucket(ts, mesh: Mesh, group, stat: Optional[str] = None) -> None:
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
    for key in ("",) if stat is None else ("", f"{stat}_"):
        mesh.stats[f"{key}bytes"] += flat.numel() * flat.element_size()
        mesh.stats[f"{key}calls"] += 1


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _count(mesh: Mesh, over: str, kind: str, t: torch.Tensor) -> None:
    """Count one collective of `kind` ("gather" or "scatter") over `over`:
    the fsdp axis's under gather_* / scatter_*, the tensor axis's under
    tensor_*."""
    key = "tensor" if over == "tensor" else kind
    mesh.stats[f"{key}_bytes"] += t.numel() * t.element_size()
    mesh.stats[f"{key}_calls"] += 1


def all_gather_(shard: torch.Tensor, mesh: Mesh, over: str = "fsdp") -> torch.Tensor:
    """The 1-D shards of the group `over` ("fsdp" or "tensor"), in its
    order: a new (n_ranks * n,) tensor. NCCL: all_gather_into_tensor. Gloo:
    built from all_reduce (module notes), chosen by the backend."""
    f, group = mesh.axis(over)
    index = mesh.fsdp_index if over == "fsdp" else mesh.tensor_index
    n = shard.numel()
    if _gloo(group):
        out = torch.zeros(f * n, dtype=shard.dtype, device=shard.device)
        out[index * n:(index + 1) * n] = shard.reshape(-1)
        dist.all_reduce(out, group=group)
    else:
        out = torch.empty(f * n, dtype=shard.dtype, device=shard.device)
        dist.all_gather_into_tensor(out, shard.reshape(-1).contiguous(), group=group)
    _count(mesh, over, "gather", out)
    return out


def reduce_scatter_(full: torch.Tensor, mesh: Mesh, over: str = "fsdp") -> torch.Tensor:
    """Sum a 1-D (F * n,) tensor over the group `over` ("fsdp" or
    "tensor") and return this rank's n-slice of the sum (a new tensor).
    NCCL: reduce_scatter_tensor. Gloo: all_reduce of the whole (in place:
    `full` is the caller's scratch), then the slice (module notes)."""
    f, group = mesh.axis(over)
    index = mesh.fsdp_index if over == "fsdp" else mesh.tensor_index
    n = full.numel() // f
    if _gloo(group):
        dist.all_reduce(full, group=group)
        out = full[index * n:(index + 1) * n].clone()
    else:
        out = torch.empty(n, dtype=full.dtype, device=full.device)
        dist.reduce_scatter_tensor(out, full.contiguous(), group=group)
    _count(mesh, over, "scatter", full)
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
