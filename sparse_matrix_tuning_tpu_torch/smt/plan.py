"""SMTPlan — the static description of what is trainable after conversion.

Twin of `sparse_matrix_tuning_tpu.smt.plan`: the same dataclasses, the
same JSON (byte-identical, so the fingerprints agree across packages), and
gather / scatter on torch tensors:

  * gather:  dense weights -> the trainables: (n_blocks, 256, 256) in
             matrix mode (numpy advanced-indexing semantics of
             w4[rb, :, cb, :]), the (out_dim, n_channels) columns
             W[:, channels] in channel mode,
  * scatter: trainables written back IN PLACE into the dense weights, once
             per optimizer step, under torch.no_grad() (the JAX twin's
             functional .at[].set into donated buffers).

The index tensors of both modes are built once per plan and device, so a
step copies nothing from the host.

Over fsdp shards (a parallel/fsdp.Sharding) gather reads each planned
weight whole (an all-gather, one weight at a time) and keeps this rank's
shard of the trainable; scatter gathers the updated trainables and writes
into each weight shard the part that lies in it (parallel/fsdp.py
write_blocks / write_columns): JAX shards a trainable on its block rows
(or output rows) and a column-parallel weight on its input columns, so
the updated blocks do not lie in the rank's own weight shard.

Keys are "{layer}.{module}" strings.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

BLOCK = 256

Key = Tuple[str, int]  # (module_name, layer_number)


def key_str(module: str, layer: int) -> str:
    return f"{layer}.{module}"


def parse_key(s: str) -> Key:
    layer, module = s.split(".", 1)
    return module, int(layer)


@dataclass(frozen=True)
class LinearPlan:
    """Selection for one target linear weight of shape (out_dim, in_dim)."""
    module: str
    layer: int
    out_dim: int
    in_dim: int
    # matrix mode: [(row_block, col_block), ...] in descending saliency order
    blocks: Tuple[Tuple[int, int], ...] = ()
    # channel mode: selected INPUT channels (columns of W)
    channels: Tuple[int, ...] = ()

    def __post_init__(self):
        for rb, cb in self.blocks:
            if not (0 <= rb < self.out_dim // BLOCK and 0 <= cb < self.in_dim // BLOCK):
                raise ValueError(
                    f"block ({rb},{cb}) out of range for {self.module}.{self.layer} "
                    f"({self.out_dim}x{self.in_dim})")
        for c in self.channels:
            if not 0 <= c < self.in_dim:
                raise ValueError(f"channel {c} out of range for in_dim {self.in_dim}")

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def trainable_params(self) -> int:
        if self.blocks:
            return self.n_blocks * BLOCK * BLOCK
        return self.n_channels * self.out_dim

    def row_blocks(self) -> np.ndarray:
        return np.array([rb for rb, _ in self.blocks], dtype=np.int32)

    def col_blocks(self) -> np.ndarray:
        return np.array([cb for _, cb in self.blocks], dtype=np.int32)

    def q8_schedules(self, device):
        """The block-correction schedules of the int8 path on `device`
        (ops/cuda/correction.py): forward (out = row block, in = column
        block) and grad_input (the other way round)."""
        from sparse_matrix_tuning_tpu_torch.ops.cuda.correction import correction_schedule
        rb, cb = self.row_blocks(), self.col_blocks()
        return correction_schedule(rb, cb, device), correction_schedule(cb, rb, device)


@dataclass
class SMTPlan:
    """mode: 'matrix' (256x256 blocks) or 'channel' (input channels)."""
    mode: str
    linears: Dict[str, LinearPlan] = field(default_factory=dict)
    # (key, device, kind) -> (rb, cb) index tensors, the channel index or
    # the int8 path's correction schedules, built once per plan
    _index_cache: Dict = field(default_factory=dict, repr=False, compare=False)

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_selection(cls, mode: str,
                       selected: Mapping[Key, list],
                       dims: Mapping[Key, Tuple[int, int]]) -> "SMTPlan":
        """selected: output of select_submatrices.
        dims: {(module, layer): (out_dim, in_dim)} actual weight shapes."""
        linears = {}
        for (module, layer), idx in selected.items():
            if not idx:
                continue
            out_dim, in_dim = dims[(module, layer)]
            if mode == "matrix":
                lp = LinearPlan(module, layer, out_dim, in_dim,
                                blocks=tuple((int(r), int(c)) for r, c in idx))
            elif mode == "channel":
                lp = LinearPlan(module, layer, out_dim, in_dim,
                                channels=tuple(int(c) for c in idx))
            else:
                raise ValueError(f"unknown mode {mode!r}")
            linears[key_str(module, layer)] = lp
        return cls(mode=mode, linears=linears)

    # -- accounting -----------------------------------------------------------

    @property
    def trainable_params(self) -> int:
        return sum(lp.trainable_params for lp in self.linears.values())

    def get(self, module: str, layer: int) -> LinearPlan | None:
        return self.linears.get(key_str(module, layer))

    # -- gather / scatter -------------------------------------------------------

    def block_index(self, ks: str, device, dtype=torch.int64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rb, cb) index tensors of linear `ks` on `device`, built once per
        plan (int64 for indexing, int32 for the block-grad kernel)."""
        device = torch.device(device)
        cache_key = (ks, str(device), dtype)
        idx = self._index_cache.get(cache_key)
        if idx is None:
            lp = self.linears[ks]
            idx = (torch.as_tensor(lp.row_blocks(), dtype=dtype, device=device),
                   torch.as_tensor(lp.col_blocks(), dtype=dtype, device=device))
            self._index_cache[cache_key] = idx
        return idx

    def tensor_window(self, ks: str, device, index: int, parts: int):
        """(window, first) of linear `ks` on tensor rank `index` of `parts`
        (the tensor axis, ops/sparse_linear.smt_linear(tensor=)): the slice
        is the rank's output rows of a column-parallel module, its input
        columns of a row-parallel one; window is fsdp.block_window of
        the plan's blocks and the slice, int32, built once per plan."""
        cache_key = (ks, str(torch.device(device)), "tensor", index, parts)
        got = self._index_cache.get(cache_key)
        if got is None:
            from sparse_matrix_tuning_tpu_torch.parallel.fsdp import (
                COL_PARALLEL, block_window)
            lp = self.linears[ks]
            if lp.module in COL_PARALLEL:
                n = lp.out_dim // parts
                rows, cols, first = (index * n, n), None, (index * n, 0)
            else:
                n = lp.in_dim // parts
                rows, cols, first = None, (index * n, n), (0, index * n)
            win = block_window(lp.row_blocks().astype(np.int64),
                                  lp.col_blocks().astype(np.int64), rows, cols, device)
            if win is not None:
                win = (win[0], win[1].to(torch.int32), win[2].to(torch.int32), *win[3:])
            got = self._index_cache[cache_key] = (win, first)
        return got

    def tensor_q8_schedules(self, ks: str, device, index: int, parts: int):
        """The int8 path's K5 schedules (LinearPlan.q8_schedules) over the
        blocks of tensor_window(ks, device, index, parts), at their window
        coordinates: (forward, grad_input), or None where no block touches
        the rank's slice; built once per plan, linear, device and rank."""
        cache_key = (ks, str(torch.device(device)), "tensor_q8", index, parts)
        if cache_key not in self._index_cache:
            from sparse_matrix_tuning_tpu_torch.ops.cuda.correction import correction_schedule
            win = self.tensor_window(ks, device, index, parts)[0]
            sched = None
            if win is not None:
                rb, cb = win[1].cpu().numpy(), win[2].cpu().numpy()
                sched = (correction_schedule(rb, cb, device), correction_schedule(cb, rb, device))
            self._index_cache[cache_key] = sched
        return self._index_cache[cache_key]

    def channel_tensor_window(self, ks: str, device, index: int, parts: int):
        """The ChannelWindow (ops/sparse_linear.channel_window) of channel
        linear `ks` on tensor rank `index` of `parts`: the rank's output
        rows of a column-parallel module, its input columns (and the
        channels in them) of a row-parallel one; built once per plan."""
        cache_key = (ks, str(torch.device(device)), "channel_tensor", index, parts)
        got = self._index_cache.get(cache_key)
        if got is None:
            from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import _split, channel_window
            lp = self.linears[ks]
            split = _split(lp.module)
            n = (lp.out_dim if split == "out" else lp.in_dim) // parts
            got = self._index_cache[cache_key] = channel_window(
                lp.channels, None, device, (split, index * n, n))
        return got

    def channel_index(self, ks: str, device) -> torch.Tensor:
        """The selected input channels of linear `ks`, an int64 tensor on
        `device`, built once per plan (channel mode)."""
        device = torch.device(device)
        cache_key = (ks, str(device), "channels")
        idx = self._index_cache.get(cache_key)
        if idx is None:
            idx = torch.as_tensor(self.linears[ks].channels, dtype=torch.int64, device=device)
            self._index_cache[cache_key] = idx
        return idx

    def q8_schedules(self, ks: str, device):
        """LinearPlan.q8_schedules of linear `ks` on `device`, built once
        per plan."""
        cache_key = (ks, str(torch.device(device)), "q8_schedules")
        sched = self._index_cache.get(cache_key)
        if sched is None:
            sched = self._index_cache[cache_key] = self.linears[ks].q8_schedules(device)
        return sched

    def gather(self, layer_params: Mapping[str, Mapping[str, torch.Tensor]],
               dtype=torch.float32, sharding=None, prefix: str = "master"
               ) -> Dict[str, torch.Tensor]:
        """The trainable per planned linear, cast to `dtype` (fp32 master
        copies by default), as new tensors: (n_blocks, 256, 256) in matrix
        mode, (out_dim, n_channels) in channel mode.

        layer_params: params["layers"], i.e. {str(layer): {module: (O, I)}}.
        sharding: layer_params holds fsdp shards at state path
        `prefix`/layers/...; each trainable is this rank's shard, recorded at
        "trainable/{key}" (module notes)."""
        out = {}
        for ks, lp in self.linears.items():
            w = layer_params[str(lp.layer)][lp.module].detach()
            if sharding is not None:
                w = sharding.full(f"{prefix}/layers/{lp.layer}/{lp.module}", w)
            if self.mode == "channel":
                t = w.index_select(1, self.channel_index(ks, w.device)).to(dtype)
            else:
                w4 = w.reshape(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
                rb, cb = self.block_index(ks, w.device)
                t = w4[rb, :, cb, :].to(dtype).contiguous()  # (n, 256, 256)
            out[ks] = t if sharding is None else sharding.shard(f"trainable/{ks}", t, self.mode)
        return out

    @torch.no_grad()
    def scatter(self, layer_params, trainable: Mapping[str, torch.Tensor], sharding=None):
        """Write trainable values back into the dense weights, in place.
        Returns layer_params (the same dicts and tensors). A weight that
        left the device (train/convert.py offload_frozen_to_host leaves a
        1-element placeholder) is skipped: nothing to keep current.
        sharding: the weights (state path "params/layers/...") and the
        trainables are fsdp shards (module notes)."""
        if sharding is not None:
            return self._scatter_sharded(layer_params, trainable, sharding)
        for ks, lp in self.linears.items():
            w = layer_params[str(lp.layer)][lp.module]
            if w.dim() != 2:
                continue
            if self.mode == "channel":
                w[:, self.channel_index(ks, w.device)] = trainable[ks].to(w.dtype)
                continue
            w4 = w.view(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
            rb, cb = self.block_index(ks, w.device)
            w4[rb, :, cb, :] = trainable[ks].to(w.dtype)
        return layer_params

    def _scatter_sharded(self, layer_params, trainable, sharding):
        from sparse_matrix_tuning_tpu_torch.parallel.fsdp import (
            block_window, column_window, write_blocks, write_columns)
        keys = list(self.linears)
        full = sharding.full_many([f"trainable/{ks}" for ks in keys],
                                  [trainable[ks] for ks in keys])
        for ks, t in zip(keys, full):
            lp = self.linears[ks]
            path = f"params/layers/{lp.layer}/{lp.module}"
            w = layer_params[str(lp.layer)][lp.module]
            # the slice's rows and columns over both axes (fsdp, tensor)
            rows, cols = sharding.window(path, w)
            split = (sharding.dim(path), sharding.tdim(path))
            if self.mode == "channel":
                cache_key = (ks, str(w.device), "columns2", cols)
                if cache_key not in self._index_cache:
                    self._index_cache[cache_key] = column_window(
                        np.asarray(lp.channels, np.int64), cols if 1 in split else None,
                        w.device)
                write_columns(w, rows[0], t, self._index_cache[cache_key])
                continue
            cache_key = (ks, str(w.device), "window2", rows, cols)
            if cache_key not in self._index_cache:
                self._index_cache[cache_key] = block_window(
                    lp.row_blocks().astype(np.int64), lp.col_blocks().astype(np.int64),
                    rows if 0 in split else None, cols if 1 in split else None, w.device)
            write_blocks(w, (rows[0], cols[0]), t, self._index_cache[cache_key])
        return layer_params

    # -- (de)serialization --------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "mode": self.mode,
            "linears": {
                ks: {
                    "module": lp.module, "layer": lp.layer,
                    "out_dim": lp.out_dim, "in_dim": lp.in_dim,
                    "blocks": [list(b) for b in lp.blocks],
                    "channels": list(lp.channels),
                } for ks, lp in self.linears.items()
            },
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "SMTPlan":
        raw = json.loads(text)
        linears = {
            ks: LinearPlan(d["module"], d["layer"], d["out_dim"], d["in_dim"],
                           blocks=tuple(tuple(b) for b in d["blocks"]),
                           channels=tuple(d["channels"]))
            for ks, d in raw["linears"].items()
        }
        return cls(mode=raw["mode"], linears=linears)

    def fingerprint(self) -> str:
        """Stable digest of the plan JSON (equal across packages)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()
