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
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """The trainable per planned linear, cast to `dtype` (fp32 master
        copies by default), as new tensors: (n_blocks, 256, 256) in matrix
        mode, (out_dim, n_channels) in channel mode.

        layer_params: params["layers"], i.e. {str(layer): {module: (O, I)}}."""
        out = {}
        for ks, lp in self.linears.items():
            w = layer_params[str(lp.layer)][lp.module].detach()
            if self.mode == "channel":
                out[ks] = w.index_select(1, self.channel_index(ks, w.device)).to(dtype)
                continue
            w4 = w.reshape(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
            rb, cb = self.block_index(ks, w.device)
            out[ks] = w4[rb, :, cb, :].to(dtype).contiguous()  # (n, 256, 256)
        return out

    @torch.no_grad()
    def scatter(self, layer_params, trainable: Mapping[str, torch.Tensor]):
        """Write trainable values back into the dense weights, in place.
        Returns layer_params (the same dicts and tensors). A weight that
        left the device (train/convert.py offload_frozen_to_host leaves a
        1-element placeholder) is skipped: nothing to keep current."""
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
