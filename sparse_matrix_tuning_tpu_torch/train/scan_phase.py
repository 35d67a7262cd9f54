"""The stacked (scan-layout) state of the SMT sparse phase, for decoding
from a quantized frozen base: twin of the state half of
`sparse_matrix_tuning_tpu.train.scan_phase` (matrix mode).

The JAX package runs its deep-model sparse phase as one `lax.scan` over
layers, so its state is keyed per MODULE with stacked (L, ...) leaves:

  params["layers_stacked"][name]   (L, ...) layernorms and biases; (L, 1)
                                   bf16 placeholders for the quantized linears
  q[mod]         {"wq" (L, O, I) int8, "sw" (L, O) fp32}, or after
                 requantize_scan_base_int4 {"w4" (L, O, I/2) int8, "s4"
                 (L, O, I/128) fp32}
  trainable[mod] (L, n_max, 256, 256) fp32 selected blocks
  base[mod]      (L, n_max, 256, 256) fp32 dequantized frozen values there
  idx[mod]       {"rb", "cb": (L, n_max) int32, "valid": (L, n_max) bool}

The port keeps that layout, so a JAX state carries across leaf for leaf
(models/from_jax.scan_state_from_jax), and loops over layers eagerly with
layer-l views (w4[l] is free). Ported: quantize-on-load
(build_scan_state_from_hf), the int4 requantization of decoding and the
forward dispatch of the decode (make_scan_dispatch). The scan sparse
training step, its backward and channel mode are not.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.hf_io import (
    _hf_to_tree_name, load_hf_config, read_safetensor, safetensors_header)
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
from sparse_matrix_tuning_tpu_torch.ops.quant import (
    dequantize_weight, dequantize_weight_int4, quantize_weight, quantize_weight_int4)
from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import (
    frozen_q4_linear, frozen_q8_linear, smt_linear_dyn)
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, SMTPlan
from sparse_matrix_tuning_tpu_torch.train.convert import (
    LAYER_LINEARS, build_q_head, offload_lm_head, resolve_head_quant)


def _matrix_only(mode: str):
    if mode != "matrix":
        raise NotImplementedError(f"plan mode {mode!r}: the port's scan state is matrix mode "
                                  "only (channel mode is not ported)")


def stack_plan_indices(plan: SMTPlan, n_layers: int, device=None) -> Dict[str, Dict]:
    """Per-module stacked block coordinates {"rb"/"cb": (L, n) int32,
    "valid": (L, n) bool}, n the module's largest per-layer count. Layers
    with fewer (or no) blocks are padded with their first entry (block
    (0, 0) when the layer has none): inert, their deltas are masked by
    `valid`."""
    _matrix_only(plan.mode)
    out = {}
    for mod in sorted({lp.module for lp in plan.linears.values()}):
        per_layer = {lp.layer: lp for lp in plan.linears.values() if lp.module == mod}
        n_max = max(len(lp.blocks) for lp in per_layer.values())
        rb = np.zeros((n_layers, n_max), np.int32)
        cb = np.zeros((n_layers, n_max), np.int32)
        valid = np.zeros((n_layers, n_max), bool)
        for l in range(n_layers):
            lp = per_layer.get(l)
            if lp is None:
                continue
            k = len(lp.blocks)
            rb[l, :k] = lp.row_blocks()
            cb[l, :k] = lp.col_blocks()
            valid[l, :k] = True
            rb[l, k:] = rb[l, 0]
            cb[l, k:] = cb[l, 0]
        out[mod] = {name: torch.from_numpy(a).to(device)
                    for name, a in (("rb", rb), ("cb", cb), ("valid", valid))}
    return out


def _gather_blocks(w: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(O, I) weight + (n,) block coordinates -> (n, 256, 256) fp32."""
    w4 = w.reshape(w.shape[0] // BLOCK, BLOCK, w.shape[1] // BLOCK, BLOCK)
    return w4[rb.long(), :, cb.long(), :].float()


def _plan_gather(plan_mode: str, w: torch.Tensor, meta_l: Dict[str, torch.Tensor]) -> torch.Tensor:
    _matrix_only(plan_mode)
    return _gather_blocks(w, meta_l["rb"], meta_l["cb"])


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
    _matrix_only(plan.mode)
    if cfg.frozen_quant != "int8":
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

    q, trainable, base, host = {}, {}, {}, {}
    stacked: Dict[str, torch.Tensor] = {}
    for mod in LAYER_LINEARS:
        if ("layers", "0", mod) not in where:
            continue
        meta = idx.get(mod)
        hs, ts, bs = [], [], []
        for l in range(n_layers):
            w_host = read(("layers", str(l), mod))
            if keep_host:
                hs.append(w_host)
            w = w_host.to(device=device, dtype=cfg.param_dtype)
            wq, sw = quantize_weight(w, reciprocal=True)  # JAX quantizes here under jit
            if l == 0:  # the stacks, filled layer by layer
                q[mod] = {"wq": torch.empty((n_layers, *wq.shape), dtype=wq.dtype, device=device),
                          "sw": torch.empty((n_layers, *sw.shape), dtype=sw.dtype, device=device)}
            q[mod]["wq"][l], q[mod]["sw"][l] = wq, sw
            if meta is not None:
                meta_l = {k: v[l] for k, v in meta.items()}
                ts.append(_plan_gather(plan.mode, w, meta_l))
                bs.append(_plan_gather(plan.mode, dequantize_weight(wq, sw, torch.float32), meta_l))
            del w, wq, sw
        if meta is not None:
            trainable[mod] = torch.stack(ts)
            base[mod] = torch.stack(bs)
        if keep_host:
            host[mod] = torch.stack(hs)
        stacked[mod] = torch.zeros((n_layers, 1), dtype=torch.bfloat16, device=device)

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

    # the JAX state's Adam moments and counters ("m", "v", "count", "step")
    # belong to the scan sparse step, which is not ported: no device memory
    # for them here
    state = {"params": params, "trainable": trainable, "base": base, "idx": idx, "q": q}
    if resolve_head_quant(cfg, model_cfg, "int8") == "int8":
        state["q_head"] = build_q_head(params, model_cfg)
        state["params"] = offload_lm_head(params, host)
    return state, (host if keep_host else None)


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
        _matrix_only("channel" if "ci" in meta else "matrix")
        w4, s4 = q4[mod]["w4"], q4[mod]["s4"]
        base4[mod] = torch.stack([
            _plan_gather("matrix", dequantize_weight_int4(w4[l], s4[l], torch.float32),
                         {k: v[l] for k, v in meta.items()})
            for l in range(w4.shape[0])])
    return q4, base4


def make_scan_dispatch(mode: str = "matrix"):
    """The linear hook of the decode over layer-l views of the scan state:
    `linear_scan(x, w, module, ex)` with ex = {"q", "t", "idx", "base"[,
    "corr"]} of one layer. Planned modules run smt_linear_dyn over their
    frozen base (int4, int8, or the dense `w`), other quantized modules the
    plain int4 or int8 linear, everything else a dense matmul. Forward
    only; matrix mode."""
    _matrix_only(mode)

    def linear_scan(x, w, module: str, ex):
        qmod = ex.get("q", {}).get(module)
        t = ex["t"].get(module)
        if t is not None:
            meta = ex["idx"][module]
            frozen = dict(qmod) if qmod is not None else {"w": w}
            return smt_linear_dyn(x, t, meta["rb"], meta["cb"], meta["valid"], frozen,
                                  ex["base"][module], ex.get("corr", {}).get(module))
        if qmod is not None:
            if "w4" in qmod:
                return frozen_q4_linear(x, qmod["w4"], qmod["s4"])
            return frozen_q8_linear(x, qmod["wq"], qmod["sw"])
        return torch.matmul(x, w.t())
    return linear_scan
