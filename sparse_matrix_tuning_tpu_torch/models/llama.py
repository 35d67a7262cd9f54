"""Llama-family decoder in PyTorch (plain dicts of tensors + functions):
the training forward and the KV-cache forward of generation.

Twin of `sparse_matrix_tuning_tpu.models.llama` (per-layer params):
RMSNorm, HF-convention rotary embeddings, grouped-query attention (the
masked einsum, the fused causal K3 kernel, ops/attention.py, or over the
decode cache the K7 kernel, ops/cuda/cached_attention.py), SiLU
gate/up/down MLP, optional Qwen2 QKV biases, untied or tied head.
Parameters keep the JAX tree layout: {"embed_tokens", "norm", "lm_head",
"layers": {"<i>": {module: (out, in) weight}}}, so both packages compute
the same thing on the same weights (models/from_jax.py).

The six SMT target linears route through the `linear(x, w, module,
layer)` dispatch hook; after conversion the planned ones compute through
the block- or column-sparse autograd Functions (ops/sparse_linear.py), and
in the channel warm-up `forward(..., activation_taps=)` records their
inputs' |activation| sums (_tapped). `forward_scan`
runs the same decoder over the stacked layout of the scan state
(train/scan_phase.py), an eager loop over layer views. Attention dropout
(_attn_dropout) draws each layer's mask from a generator seeded by (seed,
step, layer) (dropout_layer_seed), in the einsum attention.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sparse_matrix_tuning_tpu_torch.ops.attention import fullk_attention
from sparse_matrix_tuning_tpu_torch.ops.cuda.attention import HEAD_DIMS
from sparse_matrix_tuning_tpu_torch.ops.cuda.cached_attention import (
    HEAD_DIMS as CACHED_HEAD_DIMS, cached_attention, visible_slots)
from sparse_matrix_tuning_tpu_torch.ops.quant import _over

ATTN_TARGETS = ("q_proj", "k_proj", "v_proj")
MLP_TARGETS = ("gate_proj", "up_proj", "down_proj")
TARGET_MODULES = ATTN_TARGETS + MLP_TARGETS

IGNORE_INDEX = -100  # reference helper.py:23


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        """A block-divisible toy config for tests (all linears >= 256x256)."""
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512)

    @classmethod
    def from_hf(cls, hf_cfg: Mapping[str, Any]) -> "LlamaConfig":
        return cls(
            vocab_size=hf_cfg["vocab_size"],
            hidden_size=hf_cfg["hidden_size"],
            intermediate_size=hf_cfg["intermediate_size"],
            num_hidden_layers=hf_cfg["num_hidden_layers"],
            num_attention_heads=hf_cfg["num_attention_heads"],
            num_key_value_heads=hf_cfg.get("num_key_value_heads",
                                           hf_cfg["num_attention_heads"]),
            max_position_embeddings=hf_cfg.get("max_position_embeddings", 2048),
            rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
            rope_theta=hf_cfg.get("rope_theta", 10000.0),
            tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        )

    def to_hf(self) -> Dict[str, Any]:
        return {
            "architectures": ["LlamaForCausalLM"],
            "model_type": "llama",
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_key_value_heads": self.num_key_value_heads,
            "max_position_embeddings": self.max_position_embeddings,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "tie_word_embeddings": self.tie_word_embeddings,
            "hidden_act": "silu",
            "torch_dtype": "bfloat16",
        }


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Dict:
    """Random init from a numpy seed (tests / synthetic runs). Same scales
    as the JAX init (N(0,1)/sqrt(in) linears, N(0,0.02) embeddings, unit
    norms); the random numbers differ, so parity tests carry JAX weights
    across with models/from_jax.py instead."""
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def dense(out_dim, in_dim):
        return normal((out_dim, in_dim), 1.0 / np.sqrt(in_dim))

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    params: Dict[str, Any] = {
        "embed_tokens": normal((v, d), 0.02),
        "norm": ones(d),
        "layers": {},
    }
    for i in range(cfg.num_hidden_layers):
        params["layers"][str(i)] = {
            "input_layernorm": ones(d),
            "post_attention_layernorm": ones(d),
            "q_proj": dense(d, d),
            "k_proj": dense(kv, d),
            "v_proj": dense(kv, d),
            "o_proj": dense(d, d),
            "gate_proj": dense(f, d),
            "up_proj": dense(f, d),
            "down_proj": dense(d, f),
        }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((v, d), 0.02)
    return params


def tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a/b/c": leaf} with the JAX optimizer's "/"-joined key paths
    (smt/optimizer.py _flatten), which the param-group policies read."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def target_module_dims(params: Mapping[str, Any]) -> Dict[str, tuple]:
    """{module_name: (out_dim, in_dim)} for the six SMT targets."""
    layer0 = params["layers"]["0"]
    return {m: tuple(layer0[m].shape) for m in TARGET_MODULES}


def all_2d_param_shapes(params: Mapping[str, Any]) -> list:
    """Shapes of every 2-D param (the total-block denominator quirk,
    reference fine_tune.py:231-241 — includes embeddings and lm_head)."""
    return [tuple(p.shape) for p in flatten_tree(params).values() if p.dim() == 2]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """HF convention: inv_freq over even dims, cos/sin tiled twice."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv_freq = torch.from_numpy(np.asarray(inv_freq, np.float32)).to(positions.device)
    freqs = positions.float()[..., None] * inv_freq[None, :]  # (..., S, hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # x: (B, S, H, hd); cos/sin: (B, S, hd)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


def default_linear(x: torch.Tensor, w: torch.Tensor, module: str, layer: int) -> torch.Tensor:
    """Dense linear y = x @ W.T (weights stored HF-style as (out, in))."""
    return torch.matmul(x, w.t())


def _attention(q, k, v, mask_bias, dropout_rate: float = 0.0,
               dropout_rng: Optional[torch.Generator] = None,
               keep: Optional[torch.Tensor] = None):
    """Masked einsum attention. q: (B,S,Hq,hd); k/v: (B,S,Hkv,hd); GQA via
    head grouping; mask_bias: (B,1,S,S) additive fp32 bias (0 / min).
    Dropout on the probabilities (_attn_dropout) with a generator, or with
    an explicit (B, Hkv, Hq/Hkv, S, S) keep mask."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    q = q.reshape(b, s, hkv, groups, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores / float(np.sqrt(hd))
    scores = scores + mask_bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = _attn_dropout(probs, dropout_rate, dropout_rng, keep)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, hq * hd)


def _attn_dropout(probs: torch.Tensor, rate: float, rng: Optional[torch.Generator] = None,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention-prob dropout, the JAX twin's (reference configure_dropout
    sets attention_dropout on Llama configs, deepspeed_helpers.py:577-583):
    inverted scaling, zeros elsewhere, in probs' dtype. The keep mask is
    drawn from `rng` (probability 1 - rate), or given; with neither, or at
    rate 0, the probabilities pass unchanged. Torch's Philox bits are not
    JAX's threefry bits, so the masks of the two packages differ; tests
    hand JAX's mask in as `keep`."""
    if rate <= 0.0 or (rng is None and keep is None):
        return probs
    if keep is None:
        keep = torch.rand(probs.shape, generator=rng, device=probs.device) < (1.0 - rate)
    return torch.where(keep, probs / (1.0 - rate), 0.0).to(probs.dtype)


def dropout_layer_seed(key: Tuple[int, int], layer: int) -> int:
    """The seed of layer `layer`'s dropout mask in the step of `key` =
    (base seed, step), JAX's fold_in(fold_in(PRNGKey(base), step), layer)
    as plain integers: derived, never carried, so every forward of a step
    (the scan and the unrolled loop, a remat recompute, a resumed run)
    draws the same masks."""
    entropy = [int(key[0]) % 2 ** 32, int(key[1]) % 2 ** 32, int(layer)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def _dropout_rng(seed: Optional[int], device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def resolve_attn_impl(attn_impl: str, head_dim: int, device, dropout: bool = False) -> str:
    """The attention a forward runs (twin of the JAX resolve_attn_impl and
    of its decoder layer's fused_ok rule).

    "auto" is the JAX rule, fused kernel on the accelerator and einsum off
    it: "fullk" on CUDA tensors when the K3 kernels take the head dim
    (ops/cuda/attention.HEAD_DIMS), "einsum" everywhere else. The kernels
    tile the keys, so there is no sequence-length bound (the JAX kernel's
    VMEM-resident K/V row capped it at 4096). Explicit "fullk" and "flash"
    (K3', the stock Pallas flash attention on the TPU, the same causal
    attention) both run K3 on any device, its plain versions on CPU
    tensors; a head dim the kernels do not take raises.

    dropout (a training forward with attention dropout): every choice
    resolves to the einsum, which applies it, as JAX's fused kernels stand
    aside under dropout (llama.py:318); K3 has no dropout, as JAX's kernel
    has none. Eval draws no mask and keeps the fused kernel."""
    if attn_impl == "auto":
        cuda = torch.device(device).type == "cuda"
        return "fullk" if cuda and head_dim in HEAD_DIMS and not dropout else "einsum"
    if attn_impl in ("fullk", "flash"):
        if head_dim not in HEAD_DIMS:
            raise ValueError(f"attn_impl={attn_impl!r}: the fused attention kernel "
                             f"takes head_dim in {HEAD_DIMS}, not {head_dim}; use "
                             "attn_impl='einsum'")
        return "einsum" if dropout else "fullk"
    if attn_impl == "einsum":
        return attn_impl
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


def _lin(lp: Mapping[str, torch.Tensor], h: torch.Tensor, name: str, linear,
         layer_idx: int) -> torch.Tensor:
    """Linear via the dispatch hook, plus bias when the checkpoint has one
    (Qwen2-style QKV biases; never SMT-selected, frozen after conversion)."""
    y = linear(h, lp[name], name, layer_idx)
    bias = lp.get(f"{name}_bias")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _decoder_layer(lp: Mapping[str, torch.Tensor], x: torch.Tensor, mask_bias,
                   cos, sin, cfg: LlamaConfig, linear, layer_idx: int,
                   attn_impl: str = "einsum", dropout_seed: Optional[int] = None
                   ) -> torch.Tensor:
    b, s, _ = x.shape
    h = _rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    q = _lin(lp, h, "q_proj", linear, layer_idx)
    k = _lin(lp, h, "k_proj", linear, layer_idx)
    v = _lin(lp, h, "v_proj", linear, layer_idx)
    hd = cfg.head_dim
    q = q.reshape(b, s, cfg.num_attention_heads, hd)
    k = k.reshape(b, s, cfg.num_key_value_heads, hd)
    v = v.reshape(b, s, cfg.num_key_value_heads, hd)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    # INVARIANT (fullk): the fused kernel ignores mask_bias and is exact only
    # for causal attention over RIGHT-padded batches (pad keys sit causally
    # after every real query; the loss drops pad-query rows). The trainer
    # checks the batches (trainer._check_right_padding).
    if attn_impl == "fullk":
        attn = fullk_attention(q, k, v, 1.0 / float(np.sqrt(hd))).reshape(b, s, -1)
    else:
        # the generator is made here from its seed, so a remat recompute
        # draws the same mask
        attn = _attention(q, k, v, mask_bias, cfg.attention_dropout,
                          _dropout_rng(dropout_seed, q.device))
    x = x + _lin(lp, attn, "o_proj", linear, layer_idx)

    h = _rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    gate = _lin(lp, h, "gate_proj", linear, layer_idx)
    up = _lin(lp, h, "up_proj", linear, layer_idx)
    x = x + _lin(lp, F.silu(gate) * up, "down_proj", linear, layer_idx)
    return x


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: Mapping[str, Any], input_ids: torch.Tensor, cfg: LlamaConfig,
            attention_mask: Optional[torch.Tensor] = None,
            linear=default_linear,
            remat: bool = True,
            stop_grad_below_layer: Optional[int] = None,
            attn_impl: str = "einsum",
            return_hidden: bool = False,
            activation_taps: Optional[dict] = None,
            dropout_key: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Run the decoder; returns logits (B, S, V) in fp32, or with
    return_hidden the final normed states (B, S, D) before the head (for
    the chunked-vocab loss and the int8 head).

    attn_impl: "einsum" | "fullk" | "flash" | "auto", resolved per call
    from the ids' device and the head dim (resolve_attn_impl).

    remat: recompute each layer in the backward pass
    (torch.utils.checkpoint, non-reentrant, so closures over trainable
    blocks in `linear` still receive gradients). stop_grad_below_layer:
    detach the residual stream at the input of this layer, as the JAX
    twin's stop_gradient; autograd then never visits the frozen layers
    below it.

    activation_taps: when given a dict, it receives each target linear's
    masked |input| summed over the batch, (S, in_dim) fp32 under
    "{layer}.{module}" (the channel-saliency statistic, _tapped); the
    layers then run without remat.

    dropout_key: (base seed, step) of a training step. With
    cfg.attention_dropout > 0 each layer draws its mask from its own
    generator, seeded by dropout_layer_seed(dropout_key, layer), and the
    attention is the einsum (resolve_attn_impl). A forward that records
    gradients at a rate > 0 without a key raises: dropout never turns off
    silently. Eval (no gradient) draws no mask."""
    if activation_taps is not None:
        b, s = input_ids.shape
        mask = attention_mask if attention_mask is not None else torch.ones(
            (b, s), dtype=torch.int32, device=input_ids.device)
        linear = _tapped(linear, activation_taps, mask)
        remat = False
    layers = ((params["layers"][str(i)], linear) for i in range(cfg.num_hidden_layers))
    return _run(params, layers, input_ids, cfg, attention_mask, remat,
                stop_grad_below_layer, attn_impl, return_hidden, dropout_key)


def _tapped(linear, taps: dict, attention_mask: torch.Tensor):
    """The linear dispatch, recording sum_batch |x.float()| * mask per
    target linear: (S, in_dim), the reference's accumulated activation
    after its sum over dim 0 (smt_helper.py:169). q/k/v read one normed
    input, as gate/up do: its tap is computed once and shared."""
    m = attention_mask[..., None].float()
    last = [None, None]   # the last input and its tap

    def tapped(x, w, module, layer_idx):
        if module in TARGET_MODULES:
            if last[0] is not x:
                last[0], last[1] = x, (x.float().abs() * m).sum(0)
            taps[f"{layer_idx}.{module}"] = last[1]
        return linear(x, w, module, layer_idx)
    return tapped


def _unbind_layers(tree):
    """{..: (L, ...) tensor} -> the same nesting of length-L lists of layer
    views, one unbind per leaf (whose backward stacks the L grads once;
    indexing t[l] L times would make L backward nodes, each allocating a
    zero tensor the size of the whole stack). Lists pass through."""
    if isinstance(tree, Mapping):
        return {k: _unbind_layers(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    return tree


def _layer(tree, l: int):
    if isinstance(tree, Mapping):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def forward_scan(params: Mapping[str, Any], input_ids: torch.Tensor, cfg: LlamaConfig, *,
                 layer_xs, linear_scan,
                 attention_mask: Optional[torch.Tensor] = None,
                 remat: bool = True,
                 stop_grad_below_layer: Optional[int] = None,
                 attn_impl: str = "einsum",
                 return_hidden: bool = False,
                 dropout_key: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """forward() over the stacked (scan-layout) params, the twin of the JAX
    forward_scan as an eager loop: params["layers_stacked"] {name: (L,
    ...)} and layer_xs (a tree of (L, ...) tensors, or of length-L lists)
    are taken as layer views, and every linear of layer l runs
    `linear_scan(x, w, module, ex_l)` with ex_l layer l's slice of
    layer_xs. Remat, stop_grad_below_layer, dropout (keyed by the absolute
    layer index, so the masks equal the unrolled forward's) and the rest
    as forward()."""
    stacked = _unbind_layers(params["layers_stacked"])
    xs = _unbind_layers(layer_xs)

    def layer(l):
        ex = _layer(xs, l)
        return _layer(stacked, l), lambda h, w, module, idx: linear_scan(h, w, module, ex)

    layers = (layer(l) for l in range(cfg.num_hidden_layers))
    return _run(params, layers, input_ids, cfg, attention_mask, remat,
                stop_grad_below_layer, attn_impl, return_hidden, dropout_key)


def _run(params, layers, input_ids, cfg: LlamaConfig, attention_mask, remat,
         stop_grad_below_layer, attn_impl, return_hidden, dropout_key=None):
    """The decoder around its layers: `layers` yields each layer's (params,
    linear) in order; layer i's dropout mask is seeded by
    dropout_layer_seed(dropout_key, i)."""
    b, s = input_ids.shape
    dropout = cfg.attention_dropout > 0 and dropout_key is not None
    if cfg.attention_dropout > 0 and dropout_key is None and torch.is_grad_enabled():
        raise ValueError(f"attention_dropout {cfg.attention_dropout} in a forward that records "
                         "gradients, but no dropout_key: pass the step's (seed, step), or "
                         "evaluate under torch.no_grad()")
    attn_impl = resolve_attn_impl(attn_impl, cfg.head_dim, input_ids.device, dropout=dropout)
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)

    x = F.embedding(input_ids, params["embed_tokens"])

    mask_bias = None  # the fused kernel takes no mask
    if attn_impl == "einsum":
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=input_ids.device))
        keep = causal[None, :, :] & (attention_mask[:, None, :] > 0)
        zero = torch.zeros((), dtype=torch.float32, device=input_ids.device)
        neg = torch.full((), torch.finfo(torch.float32).min, dtype=torch.float32,
                         device=input_ids.device)
        mask_bias = torch.where(keep, zero, neg)[:, None, :, :]

    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    use_remat = remat and torch.is_grad_enabled()
    for i, (lp, linear) in enumerate(layers):
        if stop_grad_below_layer is not None and i == stop_grad_below_layer:
            x = x.detach()
        seed = dropout_layer_seed(dropout_key, i) if dropout else None
        if use_remat:
            x = checkpoint(_decoder_layer, lp, x, mask_bias, cos, sin, cfg,
                           linear, i, attn_impl, seed, use_reentrant=False)
        else:
            x = _decoder_layer(lp, x, mask_bias, cos, sin, cfg, linear, i, attn_impl, seed)

    x = _rms_norm(x, params["norm"], cfg.rms_norm_eps)
    if return_hidden:
        return x
    head = lm_head_weight(params, cfg)
    return torch.matmul(x, head.t()).float()


def lm_head_weight(params: Mapping[str, Any], cfg: LlamaConfig) -> torch.Tensor:
    return params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# KV-cache forward (generation)
# ---------------------------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-layer K/V buffers {"<i>": {"k", "v"}}, each (B, Hkv, max_len, hd).

    dtype torch.int8 gives the quantized layout: int8 k/v plus fp32
    per-(slot, head) scales "ks"/"vs" of shape (B, Hkv, 1, max_len); new
    slots are quantized at write time (_kv_write) and dequantized in the
    attention. Zeros, never uninitialised memory: slots not written yet
    are read (with probability 0) by P.V, and a NaN there poisons every
    row."""
    shape = (batch_size, cfg.num_key_value_heads, max_len, cfg.head_dim)
    sshape = (batch_size, cfg.num_key_value_heads, 1, max_len)

    def one():
        if dtype == torch.int8:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
                    "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {str(i): one() for i in range(cfg.num_hidden_layers)}


def cache_batch_axis(params: Mapping[str, Any]) -> int:
    """Axis of the batch dim in KV-cache leaves (beam search reorders along
    it): always 0, the port has no layer-stacked cache."""
    return 0


def _quant_kv(t: torch.Tensor):
    """Symmetric per-(slot, head) int8 quantization of a K/V slice in cache
    axes (B, Hkv, S_new, hd) -> (int8 values, fp32 scales (B, Hkv, 1, S_new)).
    The scale is amax times fp32(1/127), then floored, as XLA compiles the
    JAX package's amax / 127 inside its jitted generate programs."""
    t32 = t.float()
    s = torch.clamp(_over(t32.abs().amax(dim=-1, keepdim=True), 127.0, reciprocal=True),
                    min=1e-10)
    return torch.round(t32 / s).to(torch.int8), s[..., 0][:, :, None, :]


def _kv_write(kv: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
              cache_index: int) -> Dict[str, torch.Tensor]:
    """Write the new tokens' K/V (B, S_new, Hkv, hd) into slots
    [cache_index, cache_index + S_new) of the layer's buffers, in place
    (quantizing when the cache is int8). Returns kv."""
    at = slice(cache_index, cache_index + k.shape[1])
    k = k.transpose(1, 2)  # cache axes (B, Hkv, S_new, hd)
    v = v.transpose(1, 2)
    if "ks" in kv:
        kv["k"][:, :, at], kv["ks"][..., at] = _quant_kv(k)
        kv["v"][:, :, at], kv["vs"][..., at] = _quant_kv(v)
    else:
        kv["k"][:, :, at] = k
        kv["v"][:, :, at] = v
    return kv


def _kv_read(kv: Mapping[str, torch.Tensor], q_dtype, x_dtype):
    """The whole cache as (k_all, v_all) (B, Hkv, S, hd) for the einsum
    attention, dequantized in q's / x's dtype for an int8 cache."""
    k_all = kv["k"].to(q_dtype)
    v_all = kv["v"].to(x_dtype)
    if "ks" in kv:
        k_all = k_all * kv["ks"][..., 0, :][..., None].to(q_dtype)
        v_all = v_all * kv["vs"][..., 0, :][..., None].to(x_dtype)
    return k_all, v_all


def use_cached_attn(cfg: LlamaConfig, device) -> bool:
    """Whether the cached attention runs K7 (twin of the JAX
    _use_cached_attn), from SMT_CACHED_ATTN:

    "off": the masked einsum. "on": K7 on CUDA tensors, its plain version
    on CPU tensors (a head dim K7 does not take raises there). "auto"
    (default): K7 on CUDA tensors whose head dim it takes (64, 128), the
    einsum elsewhere, with a warning on CUDA.

    Not carried over from the JAX rule: the 2048-slot threshold
    (CACHED_ATTN_MIN_SLOTS, an A/B result of the TPU kernel's per-program
    overhead) and supported()'s hd % 128 and max_len % 128 (Mosaic lane
    tiling); K7 masks the ragged tail of S itself."""
    mode = os.environ.get("SMT_CACHED_ATTN", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    if mode == "auto":
        if torch.device(device).type != "cuda":
            return False
        if cfg.head_dim in CACHED_HEAD_DIMS:
            return True
        warnings.warn(f"SMT_CACHED_ATTN=auto: K7 takes head_dim in {CACHED_HEAD_DIMS}, not "
                      f"{cfg.head_dim}; the cached attention runs the masked einsum on "
                      f"{device} (SMT_CACHED_ATTN=off selects it without this warning)",
                      stacklevel=2)
        return False
    raise ValueError(f"SMT_CACHED_ATTN={mode!r}: want auto, on or off")


def _cached_layer(lp: Mapping[str, torch.Tensor], x: torch.Tensor, kv, cache_index: int,
                  mask_bias, cos, sin, cfg: LlamaConfig, linear, layer_idx: int,
                  slot_mask: torch.Tensor):
    """One decoder layer in incremental-decode form; returns (x, kv).
    Attention runs K7 when mask_bias is None, else the masked einsum over
    the dequantized cache."""
    b, s_new, _ = x.shape
    hd = cfg.head_dim
    h = _rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    q = _lin(lp, h, "q_proj", linear, layer_idx).reshape(b, s_new, cfg.num_attention_heads, hd)
    k = _lin(lp, h, "k_proj", linear, layer_idx).reshape(b, s_new, cfg.num_key_value_heads, hd)
    v = _lin(lp, h, "v_proj", linear, layer_idx).reshape(b, s_new, cfg.num_key_value_heads, hd)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    kv = _kv_write(kv, k, v, cache_index)

    if mask_bias is None:
        attn = cached_attention(q, kv, slot_mask, cache_index).to(x.dtype).reshape(b, s_new, -1)
    else:
        k_all, v_all = _kv_read(kv, q.dtype, x.dtype)
        hkv = cfg.num_key_value_heads
        qg = q.reshape(b, s_new, hkv, cfg.num_attention_heads // hkv, hd)
        scores = torch.einsum("bqkgd,bksd->bkgqs", qg, k_all).float()
        scores = scores / float(np.sqrt(hd)) + mask_bias[:, None, None, :, :]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bkgqs,bksd->bqkgd", probs, v_all).reshape(b, s_new, -1)
    x = x + _lin(lp, attn, "o_proj", linear, layer_idx)

    h = _rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    gate = _lin(lp, h, "gate_proj", linear, layer_idx)
    up = _lin(lp, h, "up_proj", linear, layer_idx)
    x = x + _lin(lp, F.silu(gate) * up, "down_proj", linear, layer_idx)
    return x, kv


@torch.no_grad()
def forward_with_cache(params: Mapping[str, Any], input_ids: torch.Tensor,
                       cfg: LlamaConfig, cache, cache_index: int,
                       slot_mask: torch.Tensor, positions: torch.Tensor,
                       linear=default_linear, last_only: bool = False):
    """Incremental forward: write K/V for `input_ids` (B, S_new) at slots
    [cache_index, cache_index + S_new) of `cache` (in place), attend over
    the whole cache gated by `slot_mask` (B, max_len; must already include
    the new tokens' slots), with RoPE at per-example `positions` (B, S_new).
    Returns (logits fp32, cache).

    last_only=True emits logits for the last position only, (B, 1, V): the
    prefill case (left padding puts the last real token last).

    params are per-layer ({"layers": ...}, linears through `linear`) or
    decode params over the int8 / int4 scan state ({"layers_q8": ...},
    eval/generate.decode_params_from_scan; linears through the scan
    dispatch, `linear` unused)."""
    if "layers_stacked" in params and "layers_q8" not in params:
        raise NotImplementedError(
            "forward_with_cache: the dense layer-stacked form is not ported; pass per-layer "
            "params or eval/generate.decode_params_from_scan's")
    b, s_new = input_ids.shape
    x = F.embedding(input_ids, params["embed_tokens"])
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    mask_bias = None  # K7 computes visibility itself
    if not use_cached_attn(cfg, input_ids.device):
        # (B, S_new, max_len): 0 where visible, the finite fp32 minimum elsewhere
        mask_bias = torch.where(visible_slots(slot_mask, cache_index, s_new), 0.0,
                                torch.finfo(torch.float32).min)

    if "layers_q8" in params:
        # decode over the int8 / int4 frozen base of the scan state
        # (eval/generate.decode_params_from_scan): each layer's linears go
        # through the scan dispatch with that layer's views
        from sparse_matrix_tuning_tpu_torch.train.scan_phase import (
            make_scan_dispatch, plan_mode_of)
        linear_scan = make_scan_dispatch(plan_mode_of(params["layers_q8"].get("idx", {})))
        for i, ex in enumerate(params["layers_q8"]["layers"]):
            li = str(i)

            def layer_linear(h, w, module, layer, ex=ex):
                return linear_scan(h, w, module, ex)

            x, cache[li] = _cached_layer(ex["params"], x, cache[li], cache_index, mask_bias, cos,
                                         sin, cfg, layer_linear, i, slot_mask)
    else:
        for i in range(cfg.num_hidden_layers):
            li = str(i)
            x, cache[li] = _cached_layer(params["layers"][li], x, cache[li], cache_index,
                                         mask_bias, cos, sin, cfg, linear, i, slot_mask)
    if last_only:
        x = x[:, -1:, :]
    x = _rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return torch.matmul(x, lm_head_weight(params, cfg).t()).float(), cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """HF-style shifted cross-entropy, mean over non-ignored tokens, fp32."""
    logits = logits[:, :-1, :].float()
    targets = labels[:, 1:].long()
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits, dim=-1)
    tok_loss = -torch.gather(logp, -1, safe[..., None])[..., 0]
    tok_loss = torch.where(valid, tok_loss, torch.zeros_like(tok_loss))
    denom = torch.clamp(valid.sum(), min=1)
    return tok_loss.sum() / denom
