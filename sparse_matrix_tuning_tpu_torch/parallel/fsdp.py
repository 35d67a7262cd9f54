"""The fsdp axis (`--mesh_shape D,F,1` with F > 1, and JAX's default mesh
(1, W, 1)): each of the F ranks of an fsdp group holds 1/F of every state
leaf that JAX shards over "fsdp" (`sparse_matrix_tuning_tpu.parallel.mesh`
state_shardings), the ZeRO-3 layout, and the ranks compute what one
process computes at the same global batch.

  * shard_dim copies JAX's PartitionSpecs and its `_fit`: which dim of a
    leaf is split, or None where the leaf stays whole (norms, counters,
    the activation sums, a dim that F does not divide);
  * Sharding.shard_tree keeps this rank's contiguous slice of each such
    leaf (fsdp index f = rank % F takes slice f) and records its dim, keyed
    by the leaf's "/"-joined state path ("master/layers/0/q_proj",
    "trainable/0.q_proj", "q/0.o_proj/sw");
  * gather (an autograd Function) all-gathers a layer's shards, cast to
    the compute dtype first, while the layer runs; its backward
    reduce-scatters their grads, in the shards' dtype, over the fsdp
    group. models/llama.forward runs every layer inside a checkpoint
    region under fsdp, so the backward gathers again instead of saving the
    full weights: one layer's full weights exist at a time (LIVE counts
    them), besides the embedding and the head, which are gathered where
    they are used;
  * the steps then sum a sharded leaf's grad over the data group and a
    whole leaf's over the world (parallel/mesh.all_reduce_);
  * block statistics of sharded accumulators combine their partial sums
    over the fsdp group before any non-linearity (block_stats_sharded): a
    256-block may straddle two shards;
  * write_blocks / write_columns put the updated trainables into this
    rank's shard of their weight: the trainables are sharded on their
    block rows (or output rows), a col-parallel weight on its input
    columns, so the step gathers the trainables first;
  * full_tree gathers a tree leaf by leaf to the host (export, tests);
  * the scan state (train/scan_phase.py): its stacked (L, ...) leaves
    split the dim of their layer leaf plus one (shard_dim), the
    conversion keeps each layer's slice (layer_part) of what it computes
    from the whole layer, and LayerGather.scan_layer gathers layer l's
    views of the stacks inside its checkpoint region. The host store of
    the frozen weights that left the device (JAX's HostShards) holds this
    rank's slices at state paths host/{key}; full_layer rebuilds one
    layer of it, wherever it lies, for the export.

The tensor axis (T > 1, parallel/tensor.py) adds a second split:
tensor_dim copies the tensor half of JAX's state_shardings (q/k/v/gate/up
on their output rows, o/down on their input columns, the embedding on its
hidden columns, the head on its vocabulary rows, the accumulators as their
weights; q/k/v biases, the trainables and their moments stay whole over
tensor; a tied model has no head leaf: LayerGather.head cuts its rows
from the embedding's columns where it is used), and
Sharding records both dims of a leaf. LayerGather still gathers over the
fsdp group only, so each rank computes on its tensor slices; full, full_many
and full_tree gather over both axes (export, eval generation, tests);
block statistics, write_blocks and write_columns work on the two-axis
window of a slice, where a 256-block may straddle both kinds of shard. The
scan state's stacks split over tensor as their layer leaves do (a stacked
weight, q/wq, a column-parallel q/sw and the host store; the trainables,
their base and moments stay whole): layer_part keeps a layer's slice over
both axes, full_layer gathers one over both, and LayerGather.scan_layer
gathers a layer's views over fsdp only.

Every function here that moves data is collective over the fsdp group (and,
where a leaf is split over tensor, over the tensor group): each of its
ranks calls it in the same order.
"""

from __future__ import annotations

import weakref
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh, all_gather_, reduce_scatter_

BLOCK = 256
COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")
PARAM_TOPS = ("embed_tokens", "norm", "layers", "layers_stacked", "lm_head")

# gathered layers alive now and at most (gather's outputs, by weak reference)
LIVE = {"now": 0, "peak": 0}


def _weight_dim(module: str) -> Optional[int]:
    """JAX's megatron layout with the fsdp axis on the other dim: column-
    parallel weights split their input dim (1), row-parallel their output
    dim (0)."""
    if module in COL_PARALLEL:
        return 1
    if module in ROW_PARALLEL:
        return 0
    return None


def _param_dim(sub: Sequence[str]) -> Optional[int]:
    if sub[0] == "embed_tokens":
        return 0
    if sub[0] == "lm_head":
        return 1
    stacked = sub[0] == "layers_stacked" and len(sub) == 2
    if (sub[0] == "layers" and len(sub) == 3) or stacked:
        name = sub[-1]
        if name.endswith("layernorm") or name.endswith("_bias"):
            return None
        return _plus(_weight_dim(name), stacked)
    return None


def _plus(d: Optional[int], stacked: bool) -> Optional[int]:
    """The dim of a layer leaf in its (L, ...) stack: one further."""
    return None if d is None else d + int(stacked)


def shard_dim(path: str, shape: Sequence[int], mode: Optional[str], fsdp: int
              ) -> Optional[int]:
    """The dim of the state leaf at `path` ("/"-joined) that JAX shards
    over fsdp, or None (whole on every rank), for a leaf of `shape`:

      master, params, and the warm-up's m / v: q/k/v/gate/up dim 1, o/down
      dim 0, embed_tokens dim 0, lm_head dim 1, norms and biases whole;
      trainable and the sparse phase's m / v: (n, 256, 256) blocks dim 1,
      channel (O, n) columns dim 0 (mode "matrix" / "channel");
      acc: its weight's dim; act_acc whole (JAX puts its columns on tensor);
      q (the int8 base): wq its weight's, sw dim 0 for row-parallel weights
      only (it indexes the output dim), base blocks dim 1; q_head: wq dim 1,
      sw whole; counters and the loss scaler whole.

    The scan state's stacked leaves (keyed by module, not "{layer}.{module}")
    take the dim of their layer leaf plus one: params/layers_stacked/{mod}
    (the (L, 1) placeholders and the norms stay whole), trainable, base, m
    and v ((L, n, 256, 256) dim 2, channel (L, O, n) dim 1), q/{mod}/wq and
    q/{mod}/sw; idx and the schedules stay whole. host/{key}, the host store
    of the frozen weights that left the device (HostShards), as the leaf it
    holds: a stacked weight, or the lm_head (dim 1).

    As JAX's _fit, a dim that fsdp does not divide, or that the leaf does
    not have, stays whole."""
    keys = path.split("/")
    top = keys[0]
    blocks = 1 if mode == "matrix" else 0
    d: Optional[int] = None
    if top in ("master", "params"):
        d = _param_dim(keys[1:])
    elif top in ("m", "v", "trainable", "base"):
        if keys[1] in PARAM_TOPS:   # the warm-up's moments
            d = _param_dim(keys[1:])
        else:
            d = _plus(blocks, "." not in keys[1])
    elif top == "acc":
        d = _weight_dim(keys[1].split(".", 1)[1])
    elif top == "q":
        stacked = "." not in keys[1]
        module, leaf = keys[1].split(".", 1)[-1], keys[2]
        d = {"wq": _plus(_weight_dim(module), stacked),
             "sw": _plus(0 if module in ROW_PARALLEL else None, stacked),
             "base": 1}[leaf]
    elif top == "q_head":
        d = 1 if keys[1] == "wq" else None
    elif top == "host":
        d = 1 if keys[1] == "lm_head" else _plus(_weight_dim(keys[1]), True)
    return _fit(d, shape, fsdp)


def _fit(d: Optional[int], shape: Sequence[int], size: int) -> Optional[int]:
    """JAX's _fit: a dim the axis does not divide, or that the leaf does not
    have, stays whole."""
    if d is None or d >= len(shape) or shape[d] % size:
        return None
    return d


def _tensor_weight_dim(module: str) -> Optional[int]:
    """The megatron half of JAX's layout: column-parallel weights split
    their output rows (0), row-parallel their input columns (1)."""
    if module in COL_PARALLEL:
        return 0
    if module in ROW_PARALLEL:
        return 1
    return None


def _tensor_param_dim(sub: Sequence[str]) -> Optional[int]:
    if sub[0] == "embed_tokens":
        return 1
    if sub[0] == "lm_head":
        return 0
    stacked = sub[0] == "layers_stacked" and len(sub) == 2
    if (sub[0] == "layers" and len(sub) == 3) or stacked:
        name = sub[-1]
        if name.endswith("layernorm") or name.endswith("_bias"):
            return None
        return _plus(_tensor_weight_dim(name), stacked)
    return None


def tensor_dim(path: str, shape: Sequence[int], mode: Optional[str], tensor: int
               ) -> Optional[int]:
    """The dim of the state leaf at `path` that JAX shards over "tensor", or
    None, for a leaf of `shape` (the tensor half of state_shardings, as
    shard_dim is its fsdp half):

      master, params, the warm-up's m / v: q/k/v/gate/up dim 0, o/down dim
      1, embed_tokens dim 1, lm_head dim 0, norms and biases whole;
      trainable, base and the sparse phase's m / v: whole (trainable_pspec
      names fsdp only); acc: its weight's dim; act_acc its columns (the
      last dim) where it has two dims or more, the (C,) per-step stats
      whole (JAX's P(None, "tensor") cut to the leaf's rank); q: wq its
      weight's, sw dim 0 for column-parallel weights (it indexes the
      output rows); q_head: wq and sw dim 0. The scan state's stacked
      leaves take the dim of their layer leaf plus one.

    As JAX's _fit, a dim that tensor does not divide stays whole."""
    keys = path.split("/")
    top = keys[0]
    d: Optional[int] = None
    if top in ("master", "params"):
        d = _tensor_param_dim(keys[1:])
    elif top in ("m", "v") and keys[1] in PARAM_TOPS:
        d = _tensor_param_dim(keys[1:])
    elif top == "acc":
        d = _tensor_weight_dim(keys[1].split(".", 1)[1]) if "." in keys[1] else \
            _plus(_tensor_weight_dim(keys[1]), True)
    elif top == "act_acc" and len(shape) > 1:
        d = len(shape) - 1
    elif top == "q":
        stacked = "." not in keys[1]
        module, leaf = keys[1].split(".", 1)[-1], keys[2]
        d = {"wq": _plus(_tensor_weight_dim(module), stacked),
             "sw": _plus(0 if module in COL_PARALLEL else None, stacked),
             "base": None}[leaf]
    elif top == "q_head":
        d = 0
    elif top == "host":
        d = 0 if keys[1] == "lm_head" else _plus(_tensor_weight_dim(keys[1]), True)
    return _fit(d, shape, tensor)


class Sharding:
    """This rank's view of a sharded state: the mesh and the dims of every
    split leaf by state path, `dims` over fsdp and `tdims` over tensor (a
    path absent from both is whole)."""

    def __init__(self, mesh: Mesh, dims: Optional[Dict[str, int]] = None,
                 tdims: Optional[Dict[str, int]] = None):
        self.mesh = mesh
        self.dims: Dict[str, int] = dict(dims or {})
        self.tdims: Dict[str, int] = dict(tdims or {})

    @property
    def f(self) -> int:
        return self.mesh.fsdp

    @property
    def t(self) -> int:
        return self.mesh.tensor

    def dim(self, path: str) -> Optional[int]:
        return self.dims.get(path)

    def tdim(self, path: str) -> Optional[int]:
        return self.tdims.get(path)

    def mine(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's contiguous fsdp slice of a full tensor along dim
        (None: the tensor itself)."""
        if dim is None:
            return t
        return t.chunk(self.f, dim)[self.mesh.fsdp_index].contiguous()

    def local(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf `t` at `path` by its recorded
        dims (fsdp and tensor)."""
        d, td = self.dim(path), self.tdim(path)
        if td is not None:
            t = t.chunk(self.t, td)[self.mesh.tensor_index]
        return self.mine(t, d) if d is not None else t.contiguous()

    def _record(self, path: str, d: Optional[int], td: Optional[int]) -> None:
        for table, v in ((self.dims, d), (self.tdims, td)):
            if v is None:
                table.pop(path, None)
            else:
                table[path] = v

    def split_dims(self, path: str, shape, mode: Optional[str] = None):
        """(fsdp dim, tensor dim) of a full leaf of `shape` at `path`, each
        None where its axis has one rank."""
        return (shard_dim(path, shape, mode, self.f) if self.f > 1 else None,
                tensor_dim(path, shape, mode, self.t) if self.t > 1 else None)

    def shard(self, path: str, t: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        """This rank's slice of the full leaf `t` at `path` by shard_dim and
        tensor_dim, recorded; a leaf kept whole is returned as it is."""
        d, td = self.split_dims(path, tuple(t.shape), mode)
        self._record(path, d, td)
        if d is None and td is None:
            return t
        return self.local(path, t)

    def shard_tree(self, tree, prefix: str, mode: Optional[str] = None):
        """shard() of every leaf of a nested dict whose path is prefix/..."""
        if isinstance(tree, Mapping):
            return {k: self.shard_tree(v, f"{prefix}/{k}", mode) for k, v in tree.items()}
        return self.shard(prefix, tree, mode)

    def layer_part(self, path: str, t: torch.Tensor, n_layers: int,
                   mode: Optional[str] = None) -> torch.Tensor:
        """This rank's slice of `t`, one layer of the (n_layers, ...) stack
        at `path`, by the stack's shard_dim and tensor_dim (recorded), as a
        tensor of its own: a stack of the layers' slices is this rank's
        slice of the stack (the scan layouts)."""
        d, td = self.split_dims(path, (n_layers, *t.shape), mode)
        self._record(path, d, td)
        if d is None and td is None:
            return t
        if td is not None:
            t = t.chunk(self.t, td - 1)[self.mesh.tensor_index]
        if d is not None:
            t = t.chunk(self.f, d - 1)[self.mesh.fsdp_index]
        return t.clone(memory_format=torch.contiguous_format)

    def full_layer(self, path: str, t: torch.Tensor, l: int) -> torch.Tensor:
        """Layer l of the full stack at `path` from this rank's slice `t` of
        it, wherever t lies (the host store: moved to the mesh's device for
        the collectives); on the mesh's device where the stack is split.
        Collective over the fsdp and the tensor group for a stack split
        over them, as JAX's host_frozen_global of a HostShards."""
        d, td = self.dim(path), self.tdim(path)
        if d is None and td is None:
            return t[l]
        x = t[l].to(self.mesh.device)
        for dim, over in ((d, "fsdp"), (td, "tensor")):
            if dim is not None:
                x = _gather_flat([x], [dim - 1], self.mesh, over)[0]
        return x

    def zeros(self, path: str, full_shape, dtype, device, mode: Optional[str] = None
              ) -> torch.Tensor:
        """This rank's shard of a zero leaf of `full_shape` at `path`,
        recorded (made at the shard's size)."""
        shape = list(full_shape)
        d, td = self.split_dims(path, shape, mode)
        self._record(path, d, td)
        if d is not None:
            shape[d] //= self.f
        if td is not None:
            shape[td] //= self.t
        return torch.zeros(shape, dtype=dtype, device=device)

    def alias(self, src: str, dst: str, exact: bool = False) -> None:
        """Give the leaves under prefix dst the dims of those under src (the
        warm-up's moments mirror the master); exact: the leaf dst that of
        the leaf src, or whole where src is."""
        for table in (self.dims, self.tdims):
            if exact:
                if src in table:
                    table[dst] = table[src]
                else:
                    table.pop(dst, None)
                continue
            for k, d in list(table.items()):
                if k.startswith(src + "/"):
                    table[dst + k[len(src):]] = d

    def keep(self, paths) -> None:
        """Forget every leaf whose path is not among `paths` (the state's
        after a conversion or restore)."""
        paths = set(paths)
        self.dims = {k: d for k, d in self.dims.items() if k in paths}
        self.tdims = {k: d for k, d in self.tdims.items() if k in paths}

    def full_shape(self, path: str, t: torch.Tensor) -> tuple:
        shape = list(t.shape)
        d, td = self.dim(path), self.tdim(path)
        if d is not None:
            shape[d] *= self.f
        if td is not None:
            shape[td] *= self.t
        return tuple(shape)

    def offset(self, path: str, t: torch.Tensor) -> int:
        """Where this rank's fsdp slice starts along its dim (0 for a leaf
        whole over fsdp)."""
        d = self.dim(path)
        return 0 if d is None else self.mesh.fsdp_index * t.shape[d]

    def window(self, path: str, t: torch.Tensor):
        """((first row, rows), (first column, columns)) of this rank's
        slice `t` of the full 2-D leaf at `path`, over both axes."""
        out = [[0, n] for n in t.shape]
        for d, index in ((self.dim(path), self.mesh.fsdp_index),
                         (self.tdim(path), self.mesh.tensor_index)):
            if d is not None:
                out[d][0] = index * t.shape[d]
        return tuple(tuple(x) for x in out)

    def split_axes(self, path: str) -> tuple:
        """The axes ("fsdp", "tensor") the leaf at `path` is split over."""
        return tuple(a for a, table in (("fsdp", self.dims), ("tensor", self.tdims))
                     if path in table)

    def stat_item(self, path: str, t: torch.Tensor) -> tuple:
        """block_stats_sharded's item of this rank's slice t of the 2-D leaf
        at `path`."""
        rows, cols = self.window(path, t)
        return t, rows, cols, self.full_shape(path, t), self.split_axes(path)

    def full(self, path: str, t: torch.Tensor, over=("fsdp", "tensor")) -> torch.Tensor:
        """The full leaf at `path` on this rank's device (no autograd);
        gathered over the axes of `over` only, where given (a two-axis
        leaf's fsdp rows, or its tensor slices)."""
        return self.full_many([path], [t], over)[0]

    @torch.no_grad()
    def full_many(self, paths: Sequence[str], ts: Sequence[torch.Tensor],
                  over=("fsdp", "tensor")) -> list:
        """full() of several leaves, one all-gather a dtype and axis (fsdp,
        then tensor)."""
        out = list(ts)
        for table, axis in ((self.dims, "fsdp"), (self.tdims, "tensor")):
            split = [i for i, p in enumerate(paths) if p in table] if axis in over else []
            got = _gather_flat([out[i].detach() for i in split],
                               [table[paths[i]] for i in split], self.mesh, axis) \
                if split else []
            for i, t in zip(split, got):
                out[i] = t
        return out

    def full_tree(self, tree, prefix: str, device="cpu", dtype=None):
        """The full leaves of a tree on `device`, in `dtype` where given
        (each shard cast before its gather), gathered one leaf at a time (at
        most one full leaf on the card)."""
        if isinstance(tree, Mapping):
            return {k: self.full_tree(v, f"{prefix}/{k}", device, dtype)
                    for k, v in tree.items()}
        t = self.full(prefix, tree.detach().to(dtype or tree.dtype))
        return t.to(device=device, copy=True)

    def sharded_keys(self, prefix: str, flat: Mapping[str, torch.Tensor]) -> set:
        """The keys of a flat {key: leaf} at prefix/key that are split over
        fsdp."""
        return {k for k in flat if f"{prefix}/{k}" in self.dims}

    def tensor_keys(self, prefix: str, flat: Mapping[str, torch.Tensor]) -> set:
        """The keys of a flat {key: leaf} at prefix/key that are split over
        tensor."""
        return {k for k in flat if f"{prefix}/{k}" in self.tdims}


# ---------------------------------------------------------------------------
# all-gather / reduce-scatter of several leaves, one collective a dtype
# ---------------------------------------------------------------------------

def _by_dtype(ts: Sequence[torch.Tensor]) -> Dict[torch.dtype, list]:
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _gather_flat(shards: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh,
                 over: str = "fsdp") -> list:
    """The full tensors of `shards` (each split along its dim over the
    group `over`), one all_gather_ per dtype over their concatenation."""
    f = mesh.axis(over)[0]
    out = [None] * len(shards)
    for idx in _by_dtype(shards).values():
        flat = torch.cat([shards[i].reshape(-1) for i in idx]) if len(idx) > 1 else \
            shards[idx[0]].reshape(-1)
        full = all_gather_(flat, mesh, over).view(f, -1)
        off = 0
        for i in idx:
            s = shards[i]
            n = s.numel()
            out[i] = torch.cat([full[j, off:off + n].view(s.shape) for j in range(f)], dims[i])
            off += n
    return out


def _scatter_flat(fulls: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh) -> list:
    """This rank's slices of the fsdp group's sums of `fulls`, one
    reduce_scatter_ per dtype."""
    f = mesh.fsdp
    out = [None] * len(fulls)
    for idx in _by_dtype(fulls).values():
        sizes = [fulls[i].numel() // f for i in idx]
        buf = torch.empty((f, sum(sizes)), dtype=fulls[idx[0]].dtype,
                          device=fulls[idx[0]].device)
        off = 0
        for i, n in zip(idx, sizes):
            for j, c in enumerate(fulls[i].chunk(f, dims[i])):
                buf[j, off:off + n].view(c.shape).copy_(c)
            off += n
        mine = reduce_scatter_(buf.view(-1), mesh)
        off = 0
        for i, n in zip(idx, sizes):
            shape = list(fulls[i].shape)
            shape[dims[i]] //= f
            out[i] = mine[off:off + n].view(shape)
            off += n
    return out


class _Gather(torch.autograd.Function):
    """Full tensors of shards (cast to `cast` first where floating);
    backward: the grads, in the shards' dtypes, reduce-scattered."""

    @staticmethod
    def forward(ctx, mesh, dims, cast, *shards):
        ctx.mesh, ctx.dims = mesh, dims
        ctx.dtypes = [s.dtype for s in shards]
        ctx.set_materialize_grads(False)
        parts = [s.to(cast) if cast is not None and s.is_floating_point() else s
                 for s in shards]
        return tuple(_gather_flat(parts, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        need = [n and g is not None for n, g in zip(ctx.needs_input_grad[3:], grads)]
        idx = [i for i, n in enumerate(need) if n]
        got = _scatter_flat([grads[i].to(ctx.dtypes[i]) for i in idx],
                            [ctx.dims[i] for i in idx], ctx.mesh) if idx else []
        out = [None] * len(grads)
        for i, g in zip(idx, got):
            out[i] = g
        return (None, None, None, *out)


def gather(mesh: Mesh, shards: Sequence[torch.Tensor], dims: Sequence[int],
           cast: Optional[torch.dtype] = None) -> list:
    """The full tensors of `shards` (each split along dims[i] over the fsdp
    group), through autograd: the grads reduce-scatter back (_Gather)."""
    return list(_Gather.apply(mesh, tuple(dims), cast, *shards))


def _count_live(tensors) -> None:
    """LIVE["now"] counts one more gathered layer until every tensor of it
    is freed."""
    LIVE["now"] += 1
    LIVE["peak"] = max(LIVE["peak"], LIVE["now"])
    left = [len(tensors)]

    def freed():
        left[0] -= 1
        if left[0] == 0:
            LIVE["now"] -= 1

    for t in tensors:
        weakref.finalize(t, freed)


# the scan dispatch's tree (models/llama.forward_scan's layer_xs) by the
# state key of its sharded leaves; its "idx" and "sched" stay whole
STATE_OF_EX = {"t": "trainable", "base": "base", "q": "q"}


def _leaves(tree, prefix=()):
    """(key path, leaf) of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class LayerGather:
    """What models.llama.forward gathers under fsdp, from a params tree of
    shards at state path `prefix` ("master" in the warm-up, "params" in
    the sparse phase): `top` the embedding, final norm and head where they
    are used, `layer` / `open` a layer's leaves inside its checkpoint
    region. cast: the compute dtype of the params' floating leaves (the
    warm-up's fp32 master). extras: {kind: {key: tensor}} of the sparse
    phase ("trainable" and "q" of state), whose entries "{layer}.{module}"
    are gathered with their layer; make_linear(trainable, q) then builds
    the layer's linear dispatch from the full ones. The sparse phase's
    params are in the compute dtype already: cast and extras never meet.

    The scan state (models/llama.forward_scan): `scan_layer` takes layer
    l's views of the stacks, and `open` gathers the sharded ones and hands
    the full layer's tree to linear_scan(x, w, module, ex), the scan
    dispatch."""

    def __init__(self, sharding: Sharding, prefix: str, cast=None, extras=None,
                 make_linear=None, linear_scan=None):
        if cast is not None and (extras or linear_scan is not None):
            raise ValueError("LayerGather: cast applies to every gathered leaf; the sparse "
                             "phase's extras keep their dtype")
        self.sh, self.prefix, self.cast = sharding, prefix, cast
        self.extras = extras or {}
        self.make_linear = make_linear
        self.linear_scan = linear_scan
        # the tensor axis: the layers compute on their tensor slices
        self.tensor = sharding.mesh if sharding.t > 1 else None

    def _whole(self, t):
        return t.to(self.cast) if self.cast is not None and t.is_floating_point() else t

    def top(self, params, name: str) -> torch.Tensor:
        t = params[name]
        d = self.sh.dim(f"{self.prefix}/{name}")
        if d is None:
            return self._whole(t)
        return gather(self.sh.mesh, [t], [d], self.cast)[0]

    def head(self, params, tied: bool) -> torch.Tensor:
        """The head where it is used: under the tensor axis this rank's
        vocabulary rows, a tied head's cut from the embedding's hidden
        columns (parallel/tensor.tied_head_rows)."""
        if tied and self.tensor is not None:
            from sparse_matrix_tuning_tpu_torch.parallel.tensor import tied_head_rows
            return tied_head_rows(self.top(params, "embed_tokens"), self.tensor)
        return self.top(params, "embed_tokens" if tied else "lm_head")

    def q_head(self, q_head):
        """The int8 head {"wq", "sw"} with wq gathered over fsdp: under the
        tensor axis both stay this rank's vocabulary rows."""
        if q_head is None:
            return None
        dims = {k: self.sh.dim(f"q_head/{k}") for k in q_head}
        return {k: t if dims[k] is None else _gather_flat([t.detach()], [dims[k]], self.sh.mesh)[0]
                for k, t in q_head.items()}

    def layer(self, params, i: int):
        """Layer i's leaves: [(kind, key, shard, dim, None)], kind "params"
        (key the module), "trainable" (key "{i}.{module}") or "q" (key
        ("{i}.{module}", field))."""
        li = str(i)
        out = [("params", k, t, self.sh.dim(f"{self.prefix}/layers/{li}/{k}"), None)
               for k, t in params["layers"][li].items()]
        for ks, t in self.extras.get("trainable", {}).items():
            if ks.split(".", 1)[0] == li:
                out.append(("trainable", ks, t, self.sh.dim(f"trainable/{ks}"), None))
        for ks, entry in self.extras.get("q", {}).items():
            if ks.split(".", 1)[0] == li:
                out += [("q", (ks, k), t, self.sh.dim(f"q/{ks}/{k}"), None)
                        for k, t in entry.items()]
        return out

    def scan_layer(self, stacked_l, ex_l):
        """Layer l of the scan state: [(kind, key, view, dim, n)] of its views
        of params["layers_stacked"] (kind "params", key the name) and of the
        dispatch's tree ex_l (kind "ex", key the path into it), each view's
        dim one less than its stack's fsdp dim (STATE_OF_EX; a non-tensor
        leaf, a schedule, is whole; a tensor slice stays the rank's). A
        planned module's blocks and their base in matrix mode are cut to
        the layer's valid entries, which come first
        (scan_phase.stack_plan_indices): the view holds k of its n padded
        entries, gathered, and open() pads them back to n with zeros, which
        nothing reads (its DynSchedule runs on valid entries only; the
        padded entries' grads are 0). Most of a stack is padding
        (TinyLlama: 4,290 stacked blocks for 280), so this cuts a step's
        gathered bytes."""
        def dim(path):
            d = self.sh.dim(path)
            return None if d is None else d - 1
        out = [("params", k, t, dim(f"{self.prefix}/layers_stacked/{k}"), None)
               for k, t in stacked_l.items()]
        for key, t in _leaves(ex_l):
            state = STATE_OF_EX.get(key[0])
            d = dim("/".join((state,) + key[1:])) \
                if state is not None and isinstance(t, torch.Tensor) else None
            k = getattr(ex_l.get("sched", {}).get(key[-1]), "n_valid", None)
            n = None
            if d is not None and key[0] in ("t", "base") and k is not None \
                    and k < t.shape[0]:
                n, t = t.shape[0], t[:k]
            out.append(("ex", key, t, d, n))
        return out

    def open(self, bundle, linear):
        """(the layer's full params, its linear dispatch) from layer()'s or
        scan_layer()'s bundle: the sharded leaves in one gather, the whole
        ones as they are (the params cast), the cut ones padded back."""
        split = [e for e in bundle if e[3] is not None]
        fulls = gather(self.sh.mesh, [e[2] for e in split], [e[3] for e in split],
                       self.cast) if split else []
        if split:
            _count_live(fulls)
        got = {(e[0], e[1]): t for e, t in zip(split, fulls)}
        lp, tr, q, ex = {}, {}, {}, {}
        for kind, key, t, d, n in bundle:
            full = got[(kind, key)] if d is not None else t
            if n is not None:
                full = torch.cat([full, full.new_zeros((n - full.shape[0], *full.shape[1:]))])
            if kind == "params":
                lp[key] = self._whole(full) if d is None else full
            elif kind == "trainable":
                tr[key] = full
            elif kind == "q":
                q.setdefault(key[0], {})[key[1]] = full
            else:
                node = ex
                for k in key[:-1]:
                    node = node.setdefault(k, {})
                node[key[-1]] = full
        if self.linear_scan is not None:
            scan = self.linear_scan
            linear = lambda x, w, module, idx: scan(x, w, module, ex)  # noqa: E731
        elif self.make_linear is not None:
            linear = self.make_linear(tr, q)
        return lp, linear


# ---------------------------------------------------------------------------
# block statistics of sharded accumulators (F5)
# ---------------------------------------------------------------------------

# the linear partial sum each reducer needs, before its non-linearity
PARTIAL_KIND = {"mean_abs": "sum", "abs_mean": "abs", "L1": "abs", "L2": "sq"}


def _block_sums(x: torch.Tensor, dim: int, offset: int, n_blocks: int) -> torch.Tensor:
    """Sums of x along `dim` by the 256-block (of n_blocks) each of its
    entries falls in, its first entry at `offset` of the full dim."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n_blocks
    if offset % BLOCK == 0 and n % BLOCK == 0:   # aligned: a reshape
        split = list(x.shape)
        split[dim:dim + 1] = [n // BLOCK, BLOCK]
        part = x.reshape(split).sum(dim=dim + 1)
        if n == n_blocks * BLOCK:
            return part
        out = part.new_zeros(shape)
        out.narrow(dim, offset // BLOCK, n // BLOCK).copy_(part)
        return out
    ids = (offset + torch.arange(n, device=x.device)) // BLOCK
    return torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(dim, ids, x)


def block_partials(t: torch.Tensor, rows, cols, full_shape, kind: str) -> torch.Tensor:
    """(R/256, C/256) fp32 sums over each 256-block of the full (R, C)
    tensor of what this rank's slice `t` holds of it, rows rows = (first,
    n) and columns cols = (first, n) of it, of x ("sum"), |x| ("abs") or
    x^2 ("sq"). A block that straddles either edge of the slice (an fsdp
    shard's, a tensor shard's) gets the part that lies here."""
    x = t.float()
    x = x if kind == "sum" else x.abs() if kind == "abs" else x * x
    r, c = full_shape
    return _block_sums(_block_sums(x, 1, cols[0], c // BLOCK), 0, rows[0], r // BLOCK)


def finish_block_stat(p: torch.Tensor, strategy: str, signed: bool = False) -> torch.Tensor:
    """The reducer's statistic of combined partial sums: mean_abs |sum| /
    65536 (signed: the sum / 65536, select.block_stats_step's accumulable
    form), abs_mean sum|x| / 65536, L1 sum|x|, L2 sqrt(sum x^2)."""
    n = float(BLOCK * BLOCK)
    if strategy == "mean_abs":
        return p / n if signed else (p / n).abs()
    if strategy == "abs_mean":
        return p / n
    if strategy == "L1":
        return p
    if strategy == "L2":
        return torch.sqrt(p)
    raise ValueError(f"unknown calculate_strategy {strategy!r}")


def block_stats_sharded(items: Mapping[str, tuple], strategy_of, mesh: Mesh,
                        signed: bool = False) -> Dict[str, torch.Tensor]:
    """{key: (R/256, C/256) statistic} of sharded (R, C) tensors: items
    {key: (slice, rows, cols, full_shape, axes)} (Sharding.stat_item: the
    slice's (first, n) rows and columns and the axes it is split over),
    strategy_of(key) the reducer. The partial sums are SUM-reduced over the
    fsdp group and the tensor group, each over the slices split on that
    axis, in one bucketed all-reduce an axis, then finished
    (finish_block_stat): the non-linearity comes after the combination, as
    on the full tensor."""
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import all_reduce_
    parts = {k: block_partials(t, rows, cols, shape, PARTIAL_KIND[strategy_of(k)])
             for k, (t, rows, cols, shape, _) in items.items()}
    for over in ("fsdp", "tensor"):
        all_reduce_([parts[k] for k, v in items.items() if over in v[4]], mesh, over)
    return {k: finish_block_stat(p, strategy_of(k), signed) for k, p in parts.items()}


# ---------------------------------------------------------------------------
# trainables into this rank's weight shard (F6)
# ---------------------------------------------------------------------------

def block_window(rb: np.ndarray, cb: np.ndarray, rows, cols, device):
    """Where the blocks at (rb, cb) land in a weight slice of rows rows =
    (first, n) and columns cols = (first, n) of the weight (None: every
    row, or every column, the window then starting at block 0): (the
    blocks' indices, their row and column block in the block-aligned
    window around the slice, as tensors on `device`, (first row block,
    row blocks), (first column block, column blocks)), or None when no
    block touches the slice. Built once per plan and slice (smt/plan.py
    caches it)."""
    def span(extent):   # the blocks (lo, hi) the extent touches; (0, None): all
        if extent is None:
            return 0, None
        return extent[0] // BLOCK, -(-(extent[0] + extent[1]) // BLOCK)
    (r_lo, r_hi), (c_lo, c_hi) = span(rows), span(cols)
    keep = np.ones(len(rb), bool)
    if r_hi is not None:
        keep &= (rb >= r_lo) & (rb < r_hi)
    if c_hi is not None:
        keep &= (cb >= c_lo) & (cb < c_hi)
    sel = np.nonzero(keep)[0]
    if not len(sel):
        return None
    return (torch.as_tensor(sel, device=device), torch.as_tensor(rb[sel] - r_lo, device=device),
            torch.as_tensor(cb[sel] - c_lo, device=device),
            (r_lo, None if r_hi is None else r_hi - r_lo),
            (c_lo, None if c_hi is None else c_hi - c_lo))


@torch.no_grad()
def write_blocks(w: torch.Tensor, first, blocks: torch.Tensor, window) -> None:
    """Write full (n, 256, 256) blocks into this rank's slice w of their
    (R, C) weight, whose first row and column of the weight are first =
    (row, column), in place: the parts of each block that lie in the
    slice, placed by block_window's `window`. Where the slice is not
    block-aligned on a dim, a block-aligned window around it takes the
    blocks and the slice's part is copied back."""
    if window is None:
        return
    sel, r, c, (r_lo, r_n), (c_lo, c_n) = window
    starts = (first[0] - r_lo * BLOCK, first[1] - c_lo * BLOCK)
    spans = (w.shape[0] if r_n is None else r_n * BLOCK,
             w.shape[1] if c_n is None else c_n * BLOCK)
    aligned = starts == (0, 0) and tuple(w.shape) == spans
    if aligned:
        win = w
    else:
        win = torch.empty(spans, dtype=w.dtype, device=w.device)
        win[starts[0]:starts[0] + w.shape[0], starts[1]:starts[1] + w.shape[1]].copy_(w)
    w4 = win.view(win.shape[0] // BLOCK, BLOCK, win.shape[1] // BLOCK, BLOCK)
    w4[r, :, c, :] = blocks.index_select(0, sel).to(w.dtype)
    if not aligned:
        w.copy_(win[starts[0]:starts[0] + w.shape[0], starts[1]:starts[1] + w.shape[1]])


def column_window(channels: np.ndarray, cols, device):
    """Where the input columns `channels` land in a weight slice whose
    columns are cols = (first, n) of the weight (None: every column): (the
    channels' positions among them, their columns in the slice), int64
    tensors on `device`, or None when none does. Built once per plan and
    slice (smt/plan.py caches it)."""
    if cols is None:
        return (torch.arange(len(channels), device=device),
                torch.as_tensor(channels, dtype=torch.int64, device=device))
    first, n = cols
    sel = np.nonzero((channels >= first) & (channels < first + n))[0]
    if not len(sel):
        return None
    return (torch.as_tensor(sel, device=device),
            torch.as_tensor(channels[sel] - first, dtype=torch.int64, device=device))


@torch.no_grad()
def write_columns(w: torch.Tensor, first_row: int, cols: torch.Tensor, window) -> None:
    """Write full (O, n_ch) columns into this rank's slice w of their (O,
    I) weight, in place: the slice's rows first_row.. (an output-row split
    over fsdp or tensor) of the columns that lie in its input columns,
    placed by column_window's `window` (Sharding.window gives both)."""
    if window is None:
        return
    sel, at = window
    w[:, at] = cols[first_row:first_row + w.shape[0]].index_select(1, sel).to(w.dtype)
