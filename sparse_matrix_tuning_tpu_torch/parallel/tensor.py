"""The tensor axis (`--mesh_shape D,F,T` with T > 1): Megatron's layout,
with the collectives that GSPMD inserts for the JAX package placed by hand.

JAX shards q/k/v/gate/up on their output rows over "tensor" (column-
parallel), o/down on their input columns (row-parallel), the embedding on
its hidden columns and the head on its vocabulary rows
(`sparse_matrix_tuning_tpu.parallel.mesh` param_pspecs); the T ranks of a
tensor group see the same batch rows. So a decoder layer on rank t

    h = rmsnorm(x)                    x and h whole on every rank
    q, k, v = to_tensor_region(h) @ W_qkv[t].T      its hq/T, hkv/T heads
    x = x + from_tensor_region(attn @ W_o[:, t].T)
    h = rmsnorm(x)
    x = x + from_tensor_region((silu(h W_gate[t].T) * h W_up[t].T) @ W_down[:, t].T)

and the embedding lookup gives this rank's D/T columns, gathered over the
group (gather_from_tensor), while the head's logits are this rank's V/T
vocabulary rows (ops/loss.py: the vocabulary-parallel cross-entropy).

  * to_tensor_region: identity forward, all-reduce backward (each rank's
    partial grad of a whole input to its column-parallel linears);
  * from_tensor_region: all-reduce forward (the row-parallel partial
    sums), identity backward (its grad is whole on every rank);
  * gather_from_tensor: all-gather forward along the last dim, this
    rank's slice of the (whole) grad backward;
  * tensor_all_reduce: a plain SUM or MAX over the group (the loss's);
  * tensor_amax: the MAX over the group of the row amaxes of an int8 row
    quantization (ops/quant.row_quant(tensor=)), exact and carrying a
    NaN, counted apart in mesh.stats["tensor_amax_*"];
  * tied_head_rows: a tied model's head, this rank's V/T vocabulary rows
    of the embedding, which the rank holds on its D/T hidden columns (JAX's
    P("fsdp", "tensor") layout, kept): an all-gather of the columns
    forward, an all-gather of the rows' grads backward, each rank keeping
    its columns. Both gathers are exact (gloo's sums one rank's value and
    zeros), so the head grad reaches the embedding's columns with no sum
    in between, and autograd adds it to the lookup's grad once, as one
    process adds its two grads of the one embedding. A reduce-scatter
    would move the same bytes but sum in an order of its own. Counted in
    "tensor_*" and apart in "tied_*";
  * gather_heads: where T does not divide the head counts (a rank's rows
    of q/k/v cut a head, or a query group), the ranks' column-parallel
    rows gathered along the last dim forward, and backward the grads of
    the whole summed over the group, each rank keeping its rows (laid out
    rank-major for parallel/mesh.reduce_scatter_): each rank's attention
    feeds its own o_proj columns, so the whole's grad is the sum of the
    ranks' parts. Counted in "tensor_*" and apart in "heads_*".

Each is collective over the tensor group (every rank calls it in the
same order; a remat recompute calls them again) and counts its bytes and
calls in mesh.stats["tensor_*"]. On gloo (the CPU, ranks sharing one card)
all-gathers are built from all_reduce, as the fsdp axis's
(parallel/mesh.all_gather_).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh, all_gather_, reduce_scatter_


def _all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum", stat: str = "tensor"
                ) -> torch.Tensor:
    """SUM or MAX of t over the tensor group, in place, counted in
    mesh.stats[stat + "_bytes" / "_calls"]; returns t."""
    reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    dist.all_reduce(t, op=reduce_op, group=mesh.tensor_group)
    mesh.stats[f"{stat}_bytes"] += t.numel() * t.element_size()
    mesh.stats[f"{stat}_calls"] += 1
    return t


def tensor_all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """A new tensor: t's SUM ("sum") or MAX ("max") over the tensor group
    (no autograd: the caller decides what its backward is)."""
    return _all_reduce(t.detach().contiguous().clone(), mesh, op)


def tensor_amax(amax: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The MAX over the tensor group of each rank's amax (fp32, >= 0 or a
    NaN, as |x| gives them), a new tensor: reduced as the int32 bit
    patterns, which order non-negative floats as their values do and put
    every NaN above inf, so a NaN on any rank reaches every rank (a float
    MAX need not carry it: NCCL's fmaxf drops it). Exact: each rank then
    quantizes with the amax of the whole row."""
    bits = amax.detach().contiguous().view(torch.int32).clone()
    return _all_reduce(bits, mesh, "max", "tensor_amax").view(torch.float32)


class _ToTensorRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh), None


class _FromTensorRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor group's x (..., n) concatenated along the last dim."""
    full = all_gather_(x.contiguous(), mesh, "tensor").view(mesh.tensor, *x.shape)
    return torch.cat(full.unbind(0), dim=-1) if mesh.tensor > 1 else full[0]


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[-1] // mesh.tensor
        return g.narrow(-1, mesh.tensor_index * n, n).contiguous(), None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        full = _gather_last(x, mesh)
        _count_heads(mesh, full)
        return full

    @staticmethod
    def backward(ctx, g):
        # the rows of each rank laid out rank-major, summed and scattered
        mesh = ctx.mesh
        n = g.shape[-1] // mesh.tensor
        whole = g.reshape(-1, mesh.tensor, n).transpose(0, 1).contiguous()
        _count_heads(mesh, whole)
        return reduce_scatter_(whole.view(-1), mesh, "tensor").view(*g.shape[:-1], n), None


def _count_heads(mesh: Mesh, t: torch.Tensor) -> None:
    mesh.stats["heads_bytes"] += t.numel() * t.element_size()
    mesh.stats["heads_calls"] += 1


class _TiedHeadRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, mesh):
        ctx.mesh = mesh
        return _tied_gather(emb, mesh, 0)

    @staticmethod
    def backward(ctx, g):
        return _tied_gather(g, ctx.mesh, 1), None


def _tied_gather(x: torch.Tensor, mesh: Mesh, keep: int) -> torch.Tensor:
    """The ranks' slices of x gathered over the tensor group, each cut to
    this rank's share of dim `keep` and joined along the other dim:
    (V, D/T) columns -> (V/T, D) rows for keep 0, and back for keep 1."""
    t, i = mesh.tensor, mesh.tensor_index
    full = all_gather_(x.contiguous(), mesh, "tensor").view(t, *x.shape)
    mesh.stats["tied_bytes"] += full.numel() * full.element_size()
    mesh.stats["tied_calls"] += 1
    n = x.shape[keep] // t
    return torch.cat([p.narrow(keep, i * n, n) for p in full.unbind(0)], dim=1 - keep)


def gather_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The group's column-parallel rows x (..., n) of an activation whose
    heads T cuts, concatenated along the last dim in tensor order (..., T *
    n); backward, this rank's rows of the group's summed grads (module
    notes)."""
    return _GatherHeads.apply(x, mesh)


def tied_head_rows(emb: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A tied model's head on this rank, (V/T, D): its vocabulary rows of
    the embedding, whose (V, D/T) hidden columns `emb` this rank holds
    (module notes)."""
    return _TiedHeadRows.apply(emb, mesh)


def to_tensor_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x, whole on every rank, as the input of column-parallel linears (or
    of the vocabulary-parallel head): its grad is summed over the group."""
    return _ToTensorRegion.apply(x, mesh)


def from_tensor_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the group of the row-parallel partial outputs x."""
    return _FromTensorRegion.apply(x, mesh)


def gather_from_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The group's slices x (..., n) concatenated along the last dim, in
    tensor order: (..., T * n)."""
    return _GatherFromTensor.apply(x, mesh)
