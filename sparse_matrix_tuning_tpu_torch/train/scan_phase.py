"""The stacked (scan-layout) state of the SMT sparse phase over a quantized
frozen base, and the continuation training and decode over it: twin of
`sparse_matrix_tuning_tpu.train.scan_phase` (matrix and channel mode).

The JAX package runs its deep-model sparse phase as one `lax.scan` over
layers, so its state is keyed per MODULE with stacked (L, ...) leaves:

  params["layers_stacked"][name]   (L, ...) layernorms and biases; (L, 1)
                                   bf16 placeholders for the quantized linears
  q[mod]         {"wq" (L, O, I) int8, "sw" (L, O) fp32}, or after
                 requantize_scan_base_int4 {"w4" (L, O, I/2) int8, "s4"
                 (L, O, I/128) fp32}
  trainable[mod] (L, n_max, 256, 256) fp32 selected blocks; in channel
                 mode (L, O, n_max) fp32 selected columns
  base[mod]      the dequantized frozen values there, like trainable
  idx[mod]       {"rb", "cb": (L, n_max) int32, "valid": (L, n_max) bool};
                 in channel mode {"ci": (L, n_max) int32, "valid"}
  m, v           Adam moments like trainable; count, step: int32 scalars
  sched[mod]     (port only) [layer l's DynSchedule; in channel mode
                 whether layer l has a valid column], see attach_schedules

The port keeps that layout, so a JAX state carries across leaf for leaf
(models/from_jax.scan_state_from_jax), and loops over layers eagerly with
layer-l views (models/llama.forward_scan). Ported: when the trainer takes
this layout (resolve_scan_layers), the conversion of the eager warm-up's
fp32 master into it (build_scan_sparse_state), quantize-on-load
(build_scan_state_from_hf), the sparse step over that state
(build_scan_sparse_step: the int8 base is never updated, each planned
linear adds its delta through ops/sparse_linear.smt_linear_dyn, or
smt_channel_linear_dyn in channel mode), its eval loss, the exact export
(merged_params_from_scan), and the int4 requantization of decoding. The
port adds one non-JAX entry, "sched": each planned module's per-layer
DynSchedules, or in channel mode which layers have a valid column
(attach_schedules), built once when the trainer installs the sparse phase,
so that no step syncs the host on the coordinates. The scan warm-up is
not ported: lax.scan exists to keep XLA's compile time independent of
depth, and the eager warm-up selects the same plans.

Under fsdp (a parallel/fsdp.Sharding, `--mesh_shape D,F,1` with F > 1)
every stacked leaf JAX shards over fsdp is this rank's slice (shard_dim),
and so is the host store (each rank keeps its slices of the offloaded
stacks and head, as JAX's HostShards): the conversion builds them from
the whole layer, forward_scan gathers a layer's slices where it runs, the
step reduce-scatters the trainables' grads into their slices, and
merged_params_from_scan gathers one layer at a time for the export.
Quantize-on-load (--sparse_from_plan) stays on one device, as JAX's.

Under the tensor axis (`--mesh_shape D,F,T` with T > 1) the stacks split
over tensor as JAX's state_shardings split them: a stacked weight,
q/{mod}/wq, a column-parallel q/{mod}/sw and the host store on their
layer leaf's tensor dim plus one, the trainables, their base and moments
whole. In matrix mode each planned (module, layer) runs smt_linear_dyn on
the rank's window of its valid entries (attach_schedules builds the
windows once), and the step sums the ranks' block grads over the tensor
group at the valid entries only: most of a stack is padding, whose grads
are 0 on every rank (TinyLlama: 280 of 4,290 stacked blocks, 73.4 of
1,124.6 MB). In channel mode each (module, layer) with a valid column
runs smt_channel_linear_dyn on the rank's ChannelWindow (its output rows,
or the valid columns in its input columns), and the column stacks' grads
are summed whole.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.hf_io import (
    _hf_to_tree_name, load_hf_config, read_safetensor, safetensors_header)
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, forward_scan
from sparse_matrix_tuning_tpu_torch.ops.quant import (
    dequantize_weight, dequantize_weight_int4, quantize_weight, quantize_weight_int4)
from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import (
    ChannelWindow, _resolve_impl, _split, channel_window, dyn_schedule, frozen_q4_linear,
    frozen_q8_linear, smt_channel_linear_dyn, smt_linear_dyn)
from sparse_matrix_tuning_tpu_torch.smt.optimizer import (
    AdamConfig, clip_by_global_norm, make_qk_lr_scale)
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, SMTPlan
from sparse_matrix_tuning_tpu_torch.train.convert import (
    LAYER_LINEARS, build_q_head, frozen_offload_active, offload_lm_head, resolve_frozen_quant,
    resolve_head_quant)

# the depth from which JAX's scan_layers "auto" takes the scan layout
SCAN_AUTO_MIN_LAYERS = 12


def resolve_scan_layers(cfg: SMTConfig, model_cfg: LlamaConfig, mode: str) -> bool:
    """Whether the sparse phase runs over the stacked scan state (twin of
    the JAX resolve_scan_layers, with the port's own "auto").

    "off" is False. "on" is True in matrix and channel mode and raises
    otherwise, as in JAX; the port then converts its eager warm-up into
    the scan state (build_scan_sparse_state). "auto" is True only in
    channel mode with frozen_quant "int8" at num_hidden_layers >= 12: the
    one case where JAX's scan layout changes WHAT is computed, since it is
    the only route by which JAX's channel mode takes an int8 base and an
    int8 head (convert.resolve_frozen_quant). Matrix mode and the bf16
    base stay on the per-layer path under "auto": there JAX's scan and
    unrolled phases differ only by the order of one fp add, while the
    padded stacks would cost TinyLlama's sparse step 4.6 GiB of peak and
    5.6 ms of device time (PERF.md §7 item 6)."""
    if cfg.scan_layers == "off":
        return False
    supported = mode in ("matrix", "channel")
    if cfg.scan_layers == "on":
        if not supported:
            raise ValueError("scan_layers=on requires matrix or channel mode")
        return True
    return (mode == "channel" and cfg.frozen_quant == "int8"
            and model_cfg.num_hidden_layers >= SCAN_AUTO_MIN_LAYERS)


def stack_plan_indices(plan: SMTPlan, n_layers: int, device=None) -> Dict[str, Dict]:
    """Per-module stacked coordinates, n the module's largest per-layer
    count. Matrix mode: {"rb"/"cb": (L, n) int32, "valid": (L, n) bool};
    channel mode: {"ci": (L, n) int32, "valid": (L, n) bool}. Layers with
    fewer (or no) entries are padded with their first entry (coordinate 0
    when the layer has none): inert, their deltas are masked by `valid`."""
    out = {}
    for mod in sorted({lp.module for lp in plan.linears.values()}):
        per_layer = {lp.layer: lp for lp in plan.linears.values() if lp.module == mod}
        if plan.mode == "channel":
            coords = {l: np.array(lp.channels, np.int32)[:, None]
                      for l, lp in per_layer.items()}
            names = ("ci",)
        else:
            coords = {l: np.stack([lp.row_blocks(), lp.col_blocks()], axis=1)
                      for l, lp in per_layer.items()}
            names = ("rb", "cb")
        n_max = max(len(c) for c in coords.values())
        stacked = np.zeros((len(names), n_layers, n_max), np.int32)
        valid = np.zeros((n_layers, n_max), bool)
        for l, c in coords.items():
            k = len(c)
            stacked[:, l, :k] = c.T
            stacked[:, l, k:] = c[0][:, None]
            valid[l, :k] = True
        out[mod] = {name: torch.from_numpy(a).to(device) for name, a in zip(names, stacked)}
        out[mod]["valid"] = torch.from_numpy(valid).to(device)
    return out


def _gather_blocks(w: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(O, I) weight + (n,) block coordinates -> (n, 256, 256) fp32."""
    w4 = w.reshape(w.shape[0] // BLOCK, BLOCK, w.shape[1] // BLOCK, BLOCK)
    return w4[rb.long(), :, cb.long(), :].float()


def _gather_cols(w: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """(O, I) weight + (n,) channel indices -> (O, n) fp32 columns."""
    return w.index_select(1, ci).float()


def _plan_gather(plan_mode: str, w: torch.Tensor, meta_l: Dict[str, torch.Tensor]) -> torch.Tensor:
    if plan_mode == "channel":
        return _gather_cols(w, meta_l["ci"])
    return _gather_blocks(w, meta_l["rb"], meta_l["cb"])


def plan_mode_of(idx: Dict[str, Dict]) -> str:
    """The plan mode of a scan state's stacked coordinates (its "idx")."""
    return "channel" if any("ci" in meta for meta in idx.values()) else "matrix"


def _stack_linears(mods, n_layers: int, layer_weight: Callable, idx: Dict, plan_mode: str,
                   device, *, dtype: torch.dtype, quantize: bool, reciprocal: bool = False,
                   host: Optional[Dict] = None, host_dtype: Optional[torch.dtype] = None,
                   sharding=None):
    """The per-module stacks of the scan state, one layer weight at a time
    (the transient is one layer linear and its fp32 quantization
    temporaries): w = layer_weight(mod, l), the whole weight on any device,
    moves to `device` in `dtype`, the dtype it is quantized and gathered
    from. With `quantize`, q[mod] stacks its int8 (wq, sw) (reciprocal: the
    scale as JAX computes it under jit) and the base is gathered from the
    dequantized weight; without, the base is a distinct copy of the
    trainables. Planned modules (those of idx) gather their trainables in
    fp32 from w. host: a dict that receives each module's layer weights as
    layer_weight returns them (cast to host_dtype if given), stacked on the
    CPU. A module that needs none of these is not read. sharding (the fsdp
    and tensor axes): every stack keeps this rank's slice of each layer's
    leaves over both axes (Sharding.layer_part, at state paths q/{mod}/wq,
    trainable/{mod}, host/{mod}, ...), taken from the whole layer: a row's
    scale spans the slices of a column-parallel weight, and a block or
    column may lie in another rank's. Returns (q, trainable, base)."""
    def part(path, t):
        return t if sharding is None else sharding.layer_part(path, t, n_layers, plan_mode)

    q, trainable, base = {}, {}, {}
    for mod in mods:
        meta = idx.get(mod)
        if not (quantize or meta is not None or host is not None):
            continue
        hs, ts, bs = [], [], []
        for l in range(n_layers):
            w_src = layer_weight(mod, l).detach()
            if host is not None:
                hs.append(part(f"host/{mod}", w_src.to("cpu", host_dtype or w_src.dtype)))
            w = w_src.to(device=device, dtype=dtype)
            if quantize:
                wq, sw = quantize_weight(w, reciprocal=reciprocal)
                mine = {"wq": part(f"q/{mod}/wq", wq), "sw": part(f"q/{mod}/sw", sw)}
                if l == 0:  # the stacks, filled layer by layer
                    q[mod] = {k: torch.empty((n_layers, *t.shape), dtype=t.dtype, device=device)
                              for k, t in mine.items()}
                for k, t in mine.items():
                    q[mod][k][l] = t
            if meta is not None:
                meta_l = {k: v[l] for k, v in meta.items()}
                ts.append(part(f"trainable/{mod}", _plan_gather(plan_mode, w, meta_l)))
                if quantize:
                    bs.append(part(f"base/{mod}", _plan_gather(
                        plan_mode, dequantize_weight(wq, sw, torch.float32), meta_l)))
            del w, w_src
        if meta is not None:
            trainable[mod] = torch.stack(ts)
            if quantize:
                base[mod] = torch.stack(bs)
            else:
                base[mod] = trainable[mod].clone()
                if sharding is not None:
                    sharding.alias(f"trainable/{mod}", f"base/{mod}", exact=True)
        if host is not None:
            host[mod] = torch.stack(hs)
    return q, trainable, base


def _scan_state(params: Dict, trainable: Dict, base: Dict, idx: Dict, q: Dict, step: int,
                device, cfg: SMTConfig) -> Dict:
    """The scan state's leaves around its stacks: Adam moments and the
    update count at zero, the step carried over, and under fp16 a fresh
    scaler (steps.loss_scaler, as steps.init_sparse_state)."""
    from sparse_matrix_tuning_tpu_torch.train.steps import loss_scaler
    state = {"params": params, "trainable": trainable, "base": base, "idx": idx,
             "m": {k: torch.zeros_like(t) for k, t in trainable.items()},
             "v": {k: torch.zeros_like(t) for k, t in trainable.items()},
             "count": torch.zeros((), dtype=torch.int32, device=device),
             "step": torch.full((), int(step), dtype=torch.int32, device=device),
             **loss_scaler(cfg, device)}
    if q:
        state["q"] = q
    return state


@torch.no_grad()
def build_scan_sparse_state(cfg: SMTConfig, warmup_state: Dict, plan: SMTPlan,
                            model_cfg: LlamaConfig, device=None, sharding=None):
    """The scan sparse state from the eager warm-up's per-layer fp32 master
    (twin of the JAX build_scan_sparse_state, with its
    offload_scan_frozen_to_host), on `device` (default: the master's).
    Returns (state, host_frozen).

    The layer leaves are stacked per module in the param dtype; the
    trainable blocks (or columns) are gathered in fp32 from the fp32
    master. Under the int8 base (resolve_frozen_quant with scan=True) q[mod]
    is quantized from the fp32 master, as JAX quantizes layer_weight(mod,
    l) (eagerly: the scale is amax / 127), and the base is the gather of its
    dequantization; otherwise the base is a distinct copy of the
    trainables. m, v and count start at zero, step is the warm-up's, and
    q_head follows resolve_head_quant. With the host offload
    (frozen_offload_active with scan=True) the dense stacks of the
    quantized modules and an untied head go to host_frozen, in
    build_scan_state_from_hf's layout ({mod: (L, O, I)}, "lm_head"),
    leaving (L, 1) and 1-element placeholders; host_frozen is None
    otherwise.

    sharding (the fsdp and tensor axes): the master is this rank's shards.
    Each layer weight the conversion reads is gathered whole (a one-layer
    transient, collective), quantized and its blocks or columns gathered
    as one process does, and every stacked leaf, and the host store, keeps
    this rank's slice (_stack_linears; dims recorded in `sharding`, the
    host store's at host/{key}): each equals its slice of the one-process
    conversion bit for bit. The stacks of the master's own leaves are its
    shards cast (the cast is elementwise)."""
    master = warmup_state["master"]
    layers = master["layers"]
    device = torch.device(device) if device is not None else master["embed_tokens"].device
    n_layers, dt = model_cfg.num_hidden_layers, cfg.param_dtype
    idx = stack_plan_indices(plan, n_layers, device)
    use_q8 = resolve_frozen_quant(cfg, plan.mode, scan=True) == "int8"
    offload = frozen_offload_active(cfg, plan.mode, scan=True)
    host = {} if offload else None
    linears = [m for m in LAYER_LINEARS if m in layers["0"] and layers["0"][m].dim() == 2]

    def layer_weight(mod, l):
        w = layers[str(l)][mod]
        return w if sharding is None else sharding.full(f"master/layers/{l}/{mod}", w)

    q, trainable, base = _stack_linears(
        linears, n_layers, layer_weight, idx, plan.mode, device,
        dtype=torch.float32, quantize=use_q8, host=host, host_dtype=dt, sharding=sharding)
    stacked = {}
    for name in layers["0"]:
        placeholder = offload and name in q
        if placeholder:
            stacked[name] = torch.zeros((n_layers, 1), dtype=dt, device=device)
        else:
            stacked[name] = torch.stack([layers[str(l)][name].detach().to(device, dt)
                                         for l in range(n_layers)])
        if sharding is not None:   # the master's shards stacked: dims + 1, or whole
            src = f"master/layers/0/{name}"
            d, td = sharding.dim(src), sharding.tdim(src)
            sharding._record(f"params/layers_stacked/{name}",
                             None if d is None or placeholder else d + 1,
                             None if td is None or placeholder else td + 1)
    params = {k: v.detach().to(device, dt, copy=True) for k, v in master.items()
              if k != "layers"}
    params["layers_stacked"] = stacked
    if sharding is not None:
        sharding.alias("master", "params")
    state = _scan_state(params, trainable, base, idx, q, int(warmup_state["step"]), device,
                        cfg)
    if sharding is not None:
        sharding.alias("trainable", "m")
        sharding.alias("trainable", "v")
    if resolve_head_quant(cfg, model_cfg, "int8" if use_q8 else "none") == "int8":
        state["q_head"] = build_q_head(master, model_cfg, sharding)
        if offload:
            state["params"] = offload_lm_head(params, host)
            if sharding is not None:   # the placeholder is whole
                sharding.alias("params/lm_head", "host/lm_head", exact=True)
                sharding._record("params/lm_head", None, None)
    return state, host


def build_scan_state_from_hf(cfg: SMTConfig, model_dir: str, plan: SMTPlan,
                             model_cfg: Optional[LlamaConfig] = None, keep_host: bool = True,
                             device="cuda"):
    """Quantize-on-load: stream a local HF safetensors checkpoint straight
    into the int8 scan state on `device`, one tensor at a time, so the
    full-precision weights never co-reside there (the transient is one layer
    linear in cfg's dtype and its fp32 quantization temporaries). Returns
    (state, host_frozen): host_frozen holds the checkpoint's layer linears,
    stacked per module on the host, for an exact export (None unless
    keep_host)."""
    model_cfg = model_cfg or load_hf_config(model_dir)
    if resolve_frozen_quant(cfg, plan.mode, scan=True) != "int8":
        raise ValueError("quantize-on-load is the int8 path — set --frozen_quant int8; a bf16 "
                         "continuation can load normally and convert")
    device = torch.device(device)
    n_layers = model_cfg.num_hidden_layers
    idx = stack_plan_indices(plan, n_layers, device)

    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not st_files:
        raise FileNotFoundError(f"no .safetensors in {model_dir} (quantize-on-load requires "
                                "safetensors)")
    where = {}  # tree path -> (file, data offset, header entry, hf name)
    for fname in st_files:
        path = os.path.join(model_dir, fname)
        base, header = safetensors_header(path)
        for name, info in header.items():
            tree = _hf_to_tree_name(name)
            if tree is not None:
                where[tree] = (path, base, info, name)

    def read(tree):
        return read_safetensor(*where[tree])

    def to_device(tree):
        return read(tree).to(device=device, dtype=cfg.param_dtype)

    host = {} if keep_host else None
    linears = [m for m in LAYER_LINEARS if ("layers", "0", m) in where]
    # JAX quantizes the param-dtype weight here, under jit
    q, trainable, base = _stack_linears(
        linears, n_layers, lambda mod, l: read(("layers", str(l), mod)), idx, plan.mode, device,
        dtype=cfg.param_dtype, quantize=True, reciprocal=True, host=host)
    stacked: Dict[str, torch.Tensor] = {
        mod: torch.zeros((n_layers, 1), dtype=torch.bfloat16, device=device) for mod in linears}

    # the other per-layer leaves (layernorms, qkv biases)
    others = sorted({tree[2] for tree in where if tree[0] == "layers" and tree[2] not in q})
    for name in others:
        stacked[name] = torch.stack([to_device(("layers", str(l), name))
                                     for l in range(n_layers)])

    params: Dict = {"layers_stacked": stacked}
    for top in ("embed_tokens", "norm", "lm_head"):
        if (top,) in where:
            params[top] = to_device((top,))
    if model_cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    elif "lm_head" not in params:
        raise ValueError(f"checkpoint {model_dir} has no lm_head tensor but "
                         "tie_word_embeddings is False — malformed or mis-configured checkpoint")

    state = _scan_state(params, trainable, base, idx, q, 0, device, cfg)
    if resolve_head_quant(cfg, model_cfg, "int8") == "int8":
        state["q_head"] = build_q_head(params, model_cfg)
        state["params"] = offload_lm_head(params, {} if host is None else host)
    return state, host


@torch.no_grad()
def requantize_scan_base_int4(state: Dict, consume: bool = False):
    """The int8 scan state's frozen base in the nibble-packed int4 layout
    for decoding (ops/quant.py int4 notes): returns (q4, base4) with q4[mod]
    = {"w4" (L, O, I/2) int8, "s4" (L, O, I/128) fp32}, and base4 the
    selected blocks re-gathered from the fp32-DEQUANTIZED int4 base, so the
    decode corrections keep the selected weights exact against it. One
    layer at a time (the transient is one layer's fp32 weight).
    consume=True deletes each int8 module from state["q"] as its int4 twin
    is built (the state is then decode-only)."""
    if "q" not in state:
        raise ValueError("requantize_scan_base_int4 needs an int8 scan state (state['q'] "
                         "missing)")
    q4: Dict = {}
    for mod in sorted(state["q"]):
        wq, sw = state["q"][mod]["wq"], state["q"][mod]["sw"]
        for l in range(wq.shape[0]):
            w4, s4 = quantize_weight_int4(dequantize_weight(wq[l], sw[l], torch.float32))
            if l == 0:
                q4[mod] = {"w4": torch.empty((wq.shape[0], *w4.shape), dtype=w4.dtype,
                                             device=w4.device),
                           "s4": torch.empty((wq.shape[0], *s4.shape), dtype=s4.dtype,
                                             device=s4.device)}
            q4[mod]["w4"][l], q4[mod]["s4"][l] = w4, s4
        del wq, sw
        if consume:
            del state["q"][mod]

    base4: Dict = {}
    for mod, meta in state.get("idx", {}).items():
        w4, s4 = q4[mod]["w4"], q4[mod]["s4"]
        base4[mod] = torch.stack([
            _plan_gather("channel" if "ci" in meta else "matrix",
                         dequantize_weight_int4(w4[l], s4[l], torch.float32),
                         {k: v[l] for k, v in meta.items()})
            for l in range(w4.shape[0])])
    return q4, base4


def make_scan_dispatch(mode: str = "matrix", tensor=None):
    """The linear hook of models/llama.forward_scan and of the decode over
    layer-l views of the scan state: `linear_scan(x, w, module, ex)` with ex
    = {"q", "t", "idx", "base"[, "sched"][, "corr"]} of one layer. Planned
    modules run smt_linear_dyn (matrix mode) or smt_channel_linear_dyn
    (channel mode) over their frozen base (int4, int8, or the dense `w`;
    gradients to x and the trainables), with the layer's entry of "sched"
    (training: attach_schedules) or its precomputed correction from "corr"
    (decode); other quantized modules the plain int4 or int8 linear,
    everything else a dense matmul. In channel mode a layer without a
    valid column of the module ("sched" False, "corr" None) runs the frozen
    linear: its delta and its columns' grads are 0, as JAX computes them.

    tensor (the mesh; training): `w` and the q leaves are this rank's
    tensor slices, a planned module runs smt_linear_dyn(tensor=) on its
    layer's windowed DynSchedule (channel mode: smt_channel_linear_dyn on
    its layer's ChannelWindow, "sched"), an unplanned int8 one the tensor
    form of frozen_q8_linear. Whether a channel layer runs the frozen
    linear is decided by the whole layer's valid columns, the same on
    every rank, so every rank issues the same collectives."""
    if mode not in ("matrix", "channel"):
        raise ValueError(f"unknown plan mode {mode!r}")

    def frozen_linear(x, w, qmod, module):
        if qmod is not None:
            if "w4" in qmod:
                return frozen_q4_linear(x, qmod["w4"], qmod["s4"])
            return frozen_q8_linear(x, qmod["wq"], qmod["sw"], tensor,
                                    None if tensor is None else _split(module))
        return torch.matmul(x, w.t())

    def linear_scan(x, w, module: str, ex):
        qmod = ex.get("q", {}).get(module)
        t = ex["t"].get(module)
        if t is None:
            return frozen_linear(x, w, qmod, module)
        meta = ex["idx"][module]
        frozen = dict(qmod) if qmod is not None else {"w": w}
        if mode == "channel":
            if "corr" in ex:   # decode
                corr = ex["corr"][module]
                live = corr is not None
            else:
                corr, live = None, ex.get("sched", {}).get(module, True)
            if not live:
                return frozen_linear(x, w, qmod, module)
            return smt_channel_linear_dyn(x, t, meta["ci"], meta["valid"], frozen,
                                          ex["base"][module], corr,
                                          live if isinstance(live, ChannelWindow) else None,
                                          tensor)
        return smt_linear_dyn(x, t, meta["rb"], meta["cb"], meta["valid"], frozen,
                              ex["base"][module], ex.get("corr", {}).get(module),
                              ex.get("sched", {}).get(module), tensor)
    return linear_scan


# ---------------------------------------------------------------------------
# Training over the scan state
# ---------------------------------------------------------------------------

def attach_schedules(state: Dict, sharding=None) -> Dict:
    """state["sched"] = {mod: [layer l's entry]}: in matrix mode the
    DynSchedule of every planned (module, layer), the valid entries'
    positions and K5's forward and grad_input schedules on the trainables'
    device; in channel mode whether the layer has a valid column of the
    module (make_scan_dispatch runs the frozen linear where it has none).
    Built once, before the first step (it reads the coordinates on the
    host: the trainer calls it when it installs the sparse phase); the
    steps and the eval read it. A matrix layer's valid entries must come
    first, as stack_plan_indices (and JAX's) lays them out. sharding: under
    the tensor axis each DynSchedule is this rank's window of the layer's
    valid entries (dyn_schedule(tensor=)) around its slice of the module's
    weight, and in channel mode a layer with a valid column holds this
    rank's ChannelWindow (ops/sparse_linear.channel_window: a
    row-parallel module's valid entries in its input columns) in place of
    True. Returns state."""
    sched = {}
    for mod, meta in state["idx"].items():
        if "ci" in meta:
            live = meta["valid"].any(dim=1).tolist()
            window = _tensor_slice(state, sharding, mod)
            sched[mod] = live if window is None else [
                channel_window(ci.to("cpu").numpy(), valid.to("cpu").numpy(),
                               state["trainable"][mod].device, window) if on else False
                for ci, valid, on in zip(meta["ci"], meta["valid"], live)]
        else:
            valid = meta["valid"].to("cpu")
            if not bool((valid[:, :-1] >= valid[:, 1:]).all()):  # fsdp.LayerGather relies on it
                raise ValueError(f"{mod}: a layer's valid entries must come first "
                                 "(stack_plan_indices)")
            window = _tensor_slice(state, sharding, mod)
            sched[mod] = [dyn_schedule(rb, cb, valid, state["trainable"][mod].device, window)
                          for rb, cb, valid in zip(meta["rb"], meta["cb"], meta["valid"])]
    state["sched"] = sched
    return state


def _tensor_slice(state: Dict, sharding, mod: str):
    """(split, first, width) of this rank's tensor slice of module mod's
    weight (its output rows, split "out", for a column-parallel module;
    its input columns, "in", for a row-parallel one), or None without the
    tensor axis."""
    if sharding is None or sharding.t == 1:
        return None
    q = state.get("q", {}).get(mod)
    path, leaf = (f"q/{mod}/wq", q["wq"]) if q is not None else \
        (f"params/layers_stacked/{mod}", state["params"]["layers_stacked"][mod])
    split = _split(mod)
    dim = 1 if split == "out" else 2
    if sharding.tdim(path) != dim:
        raise ValueError(f"{path}: not split over tensor on dim {dim} "
                         f"({sharding.tdim(path)}); the tensor axis splits every layer linear")
    width = sharding.full_shape(path, leaf)[dim] // sharding.t
    return split, sharding.mesh.tensor_index * width, width


def valid_rows(state: Dict) -> Dict[str, Optional[torch.Tensor]]:
    """{mod: the positions of the valid entries in its (L * n) flattened
    stack of blocks} (int64, on the trainables' device; one host sync):
    the only entries whose grads the tensor group sums
    (build_scan_sparse_step). A channel stack (L, O, n) is summed whole
    (None): its first two dims are not its entries, and its bytes are
    few (TinyLlama at 30 + 30 channels: at most 22 x 921,600 B)."""
    return {mod: None if "ci" in meta else torch.nonzero(meta["valid"].reshape(-1)).reshape(
                -1).to(state["trainable"][mod].device)
            for mod, meta in state["idx"].items()}


def _scan_loss(state: Dict, batch: Dict, trainable, cfg: SMTConfig,
               model_cfg: LlamaConfig, lowest_layer: Optional[int],
               dropout_key=None, sharding=None) -> torch.Tensor:
    """The JAX _scan_loss: forward_scan with the scan dispatch, then the
    loss path and head of steps.head_loss (sparse phase; the int8 head
    over hidden.float() on the dense path). sharding: the state holds this
    rank's fsdp shards; each layer of the stacks is gathered where it runs
    (fsdp.LayerGather.scan_layer), the head where it is used; under the
    tensor axis each layer computes on its tensor slices and the head on
    the rank's vocabulary rows."""
    from sparse_matrix_tuning_tpu_torch.train.steps import head_loss
    layer_xs = {"t": trainable, "idx": state["idx"], "base": state["base"],
                "sched": state["sched"]}
    if "q" in state:
        layer_xs["q"] = state["q"]
    tensor = sharding.mesh if sharding is not None and sharding.t > 1 else None
    linear_scan = make_scan_dispatch(plan_mode_of(state["idx"]), tensor)
    gather = None
    if sharding is not None:
        from sparse_matrix_tuning_tpu_torch.parallel.fsdp import LayerGather
        gather = LayerGather(sharding, "params", linear_scan=linear_scan)
    kw = dict(layer_xs=layer_xs, linear_scan=linear_scan,
              attention_mask=batch.get("attention_mask"), remat=cfg.sparse_remat,
              stop_grad_below_layer=lowest_layer, attn_impl=cfg.attn_impl,
              dropout_key=dropout_key, fsdp=gather)
    params = state["params"]
    return head_loss(lambda hidden: forward_scan(params, batch["input_ids"], model_cfg,
                                                 return_hidden=hidden, **kw),
                     params, batch, cfg, model_cfg, sparse=True, q_head=state.get("q_head"),
                     fsdp=gather)


def build_scan_sparse_step(cfg: SMTConfig, model_cfg: LlamaConfig, plan: SMTPlan,
                           lr_sched: Callable, mesh=None, sharding=None) -> Callable:
    """Twin of the JAX build_scan_sparse_step: step(state, batch) ->
    (state, {"loss", "grad_norm", "lr"}), the state updated in place (as
    steps.build_sparse_step). The grads of the stacked trainables are
    clipped on their global norm and Adam updates every entry (K2 once per
    module on CUDA tensors), with the mode's betas. A padded entry's grad
    is 0 as smt_linear_dyn's and smt_channel_linear_dyn's backwards give it
    (JAX masks by `valid` to the same effect), so only the weight decay
    moves it. The qk LR boost is keyed by module name. No scatter: the base
    stays int8 and the delta corrects it. The state carries its "sched"
    (attach_schedules). Under fp16 the loss is scaled and an overflowed
    step skipped, as steps.build_sparse_step does. With a mesh the stacked
    trainables' grads are all-reduced as they are, padded entries
    included (steps.accumulated_value_and_grad). sharding (the fsdp axis):
    the stacks are this rank's shards; each layer's are gathered in its
    forward and its trainables' grads reduce-scattered in its backward,
    then summed over the data group (whole leaves over the world); the
    clip norm sums the shards' squares over fsdp (steps.
    sharded_global_norm); K2 runs on the shards. Under the tensor axis the
    block grads are each rank's parts of its windows' valid entries,
    summed over the tensor group at the valid entries only (valid_rows):
    the padded ones are 0 on every rank, so the sum equals the whole
    stacks' bit for bit (channel mode's column stacks are summed whole);
    the trainables stay whole over tensor, so the clip norm and fp16's
    overflow test see the same grads on every rank."""
    from sparse_matrix_tuning_tpu_torch.train.steps import (
        _skipped, accumulated_value_and_grad, adam_betas, block_adam, dropout_key,
        sharded_global_norm, unscale_and_check)
    adam_cfg = AdamConfig(betas=tuple(adam_betas(cfg, plan.mode)), eps=cfg.adam_eps,
                          weight_decay=cfg.w_decay, grad_clip=cfg.grad_clip)
    adam = block_adam(adam_cfg, make_qk_lr_scale(cfg.qk_lr_times) if cfg.qk_scheduler else None)
    lowest_layer = min(lp.layer for lp in plan.linears.values())
    use_ls = cfg.dtype == "fp16"
    tensor = mesh is not None and mesh.tensor > 1
    rows: Dict[str, torch.Tensor] = {}   # the tensor axis: valid_rows, made at the first step

    def step(state: Dict, batch: Dict) -> tuple:
        trainable = state["trainable"]
        if tensor and not rows:
            rows.update(valid_rows(state))
        for t in trainable.values():
            t.requires_grad_(True)
        impl = _resolve_impl(cfg.sparse_impl, state["count"].device)
        key = dropout_key(cfg, state, sparse=True, mesh=mesh)

        def loss_of(tr, mb):
            raw = _scan_loss(state, mb, tr, cfg, model_cfg, lowest_layer, key, sharding)
            return raw * state["loss_scale"] if use_ls else raw

        sharded = () if sharding is None else sharding.sharded_keys("trainable", trainable)
        vag = accumulated_value_and_grad(loss_of, cfg.gradient_accumulation_steps, mesh, sharded,
                                         rows)
        loss, grads = vag(trainable, batch)
        with torch.no_grad():
            norm_of = partial(sharded_global_norm, mesh=mesh, sharded=sharded)
            ls_metrics = {}
            if use_ls:
                loss, grads, norm, ls_metrics, finite = unscale_and_check(loss, grads, state, cfg,
                                                                          norm_of)
                if not finite:  # skipped: the stacks, moments and count unchanged
                    return _skipped(state, trainable, loss, norm, lr_sched(state["count"]),
                                    ls_metrics)
            else:
                norm = norm_of(grads)
            grads, gnorm = clip_by_global_norm(grads, adam_cfg.grad_clip, norm=norm)
            lr = lr_sched(state["count"])
            adam(impl, grads, state, trainable, lr)
            del grads
            for p in trainable.values():
                p.grad = None
            state["step"].add_(1)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **ls_metrics}

    return step


def build_scan_eval_step(cfg: SMTConfig, model_cfg: LlamaConfig, plan: SMTPlan,
                         sharding=None) -> Callable:
    """The eval loss: the sparse step's forward and loss, no gradient (under
    data parallelism this rank's part, steps.build_eval_step; under fsdp
    over the gathered layers; under the tensor axis on the tensor slices)."""

    @torch.no_grad()
    def step(state, batch) -> torch.Tensor:
        return _scan_loss(state, batch, state["trainable"], cfg, model_cfg, lowest_layer=None,
                          sharding=sharding)

    return step


def _scatter_trained_layer(w: torch.Tensor, meta_host: Dict, l: int) -> None:
    """Layer l's valid trained blocks (or columns) into its (O, I) host
    weight, in place, in w's dtype."""
    j = torch.nonzero(meta_host["valid"][l]).reshape(-1)
    if not j.numel():
        return
    if "ci" in meta_host:
        w[:, meta_host["ci"][l, j].long()] = meta_host["t"][l][:, j].to(w.dtype)
        return
    w4 = w.view(w.shape[0] // BLOCK, BLOCK, w.shape[1] // BLOCK, BLOCK)
    w4[meta_host["rb"][l, j].long(), :, meta_host["cb"][l, j].long(), :] = \
        meta_host["t"][l, j].to(w.dtype)


@torch.no_grad()
def merged_params_from_scan(state: Dict, plan: SMTPlan, model_cfg: LlamaConfig,
                            host_frozen: Optional[Dict] = None, sharding=None) -> Dict:
    """The per-layer HF-layout params of the scan state on the host, with the
    trained blocks (or columns) scattered in: an exact export whatever the
    int8 compute did (twin of the JAX merged_params_from_scan). The frozen
    and unplanned layer weights come from host_frozen (the checkpoint's, as
    loaded) unchanged, or from the device stacks; only the valid entries of
    planned modules are written, into copies. sharding (the fsdp and tensor
    axes): the state and the host store are this rank's slices; each layer
    weight is gathered whole one at a time over both axes
    (Sharding.full_layer, as JAX's host_frozen_global of a HostShards), the
    trainables and the other leaves once each. Collective: every rank of
    the mesh calls it, and every rank returns the whole."""
    def full(path, t):
        if sharding is None:
            return t.to("cpu")
        return sharding.full(path, t.to(sharding.mesh.device)).to("cpu")

    def layer_of(path, t, l):
        return t[l] if sharding is None else sharding.full_layer(path, t, l)

    stacked = state["params"]["layers_stacked"]
    meta_host = {mod: {**{k: v.to("cpu") for k, v in meta.items()},
                       "t": full(f"trainable/{mod}", state["trainable"][mod].detach())}
                 for mod, meta in state["idx"].items()}
    layers: Dict[str, Dict] = {str(l): {} for l in range(model_cfg.num_hidden_layers)}
    for mod, src in stacked.items():
        entry = host_frozen.get(mod) if host_frozen is not None else None
        path = f"host/{mod}" if entry is not None else f"params/layers_stacked/{mod}"
        planned = mod in meta_host
        for l in range(model_cfg.num_hidden_layers):
            w = layer_of(path, entry if entry is not None else src, l)
            if planned and w.dim() == 2:
                w = w.to("cpu", copy=True)   # the scatter must not touch the store
                _scatter_trained_layer(w, meta_host[mod], l)
            layers[str(l)][mod] = w.to("cpu")
    params = {k: full(f"params/{k}", v) for k, v in state["params"].items()
              if k != "layers_stacked"}
    if host_frozen is not None and "lm_head" in host_frozen:
        params["lm_head"] = full("host/lm_head", host_frozen["lm_head"])
    params["layers"] = layers
    return params
