"""K7 cached attention: grouped-query attention of T new tokens over the
decode KV cache (csrc/cached_attention.cu), prefill chunks and decode
steps, in the JAX layout.

    q, o: (B, T, Hq, hd); cache k, v: (B, Hkv, S, hd); slot_mask (B, S)
    slot j is visible to new token t iff j <= cache_index + t and
    slot_mask[b, j]; q-head h reads kv-head h // (Hq // Hkv)
    int8 cache: ks, vs (B, Hkv, 1, S) fp32 scales, folded into the score
    (K) and probability (V) columns

Replaces the Pallas kernel `_cached_attn_call` (bodies `_kernel`,
`_kernel_q8`) of ops/pallas/cached_attention.py in the JAX package, and
`cached_attention(q, kv, slot_mask, cache_index)` is the counterpart of its
entry point, per-layer cache only. The kernel serves a kv head's group in
token-major rows (r = t * g + gi) by addressing q and o in place; the plain
version reshapes to those rows as the JAX entry point does. Rows that see
no slot (left-pad positions in a prefill) come out as zeros in both, where
the JAX code, masking with the finite fp32 minimum, gives the mean of V:
finite either way, and no real row depends on them. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import math

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

HEAD_DIMS = (64, 128)
# kernel launches in this process, per body: bf16/fp32 cache, int8 cache
LAUNCHES = {"cached_attn": 0, "cached_attn_q8": 0}

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def visible_slots(slot_mask: torch.Tensor, cache_index: int, t: int) -> torch.Tensor:
    """(B, T, S) bool: slot j visible to new token i iff j <= cache_index + i
    and slot_mask[b, j] (the mask of models.llama.forward_with_cache)."""
    s = slot_mask.shape[1]
    slots = torch.arange(s, device=slot_mask.device)
    toks = torch.arange(t, device=slot_mask.device)
    causal = slots[None, :] <= cache_index + toks[:, None]
    return causal[None] & (slot_mask[:, None, :] > 0)


def cached_attention_plain(q, k, v, ks, vs, slot_mask, cache_index: int,
                           sm_scale: float) -> torch.Tensor:
    """The Pallas bodies' arithmetic in fp32: the cache cast to q's dtype,
    scores (x ks_j) x sm_scale, softmax over the visible slots (rows with
    none give zeros), probabilities (x vs_j) cast to q's dtype before P.V.
    Returns (B, T, Hq, hd) in q's dtype."""
    b, t, hq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, t, hkv, g, hd).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qf, k.to(q.dtype).float())
    if ks is not None:
        scores = scores * ks.reshape(b, hkv, 1, 1, s)
    scores = scores * sm_scale
    keep = visible_slots(slot_mask, cache_index, t)[:, None, None]  # (B,1,1,T,S)
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    probs = torch.where(keep.any(-1, keepdim=True), probs, torch.zeros((), device=q.device))
    if vs is not None:
        probs = probs * vs.reshape(b, hkv, 1, 1, s)
    o = torch.einsum("bkgts,bksd->btkgd", probs.to(q.dtype).float(), v.to(q.dtype).float())
    return o.reshape(b, t, hq, hd).to(q.dtype)


def check_args(q, k, v, ks, vs, slot_mask, cache_index: int):
    """What the kernel takes, on every device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"cached attention: want q (B,T,Hq,hd), k/v (B,Hkv,S,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, hq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if q.dtype not in _Q_CODE:
        raise TypeError(f"cached attention: q must be bf16 or fp32, got {q.dtype}")
    if k.dtype not in _CACHE_CODE or v.dtype != k.dtype:
        raise TypeError(f"cached attention: the cache must be bf16, fp32 or int8, got "
                        f"{k.dtype}/{v.dtype}")
    if (k.dtype == torch.int8) != (ks is not None) or (ks is None) != (vs is None):
        raise ValueError("cached attention: an int8 cache needs its ks/vs scales, and "
                         "only an int8 cache has them")
    if ks is not None and (ks.shape != (b, hkv, 1, s) or vs.shape != ks.shape
                           or ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError(f"cached attention: ks/vs must be ({b}, {hkv}, 1, {s}) fp32, got "
                         f"{tuple(ks.shape)} {ks.dtype}, {tuple(vs.shape)} {vs.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"cached attention: head_dim {hd} not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"cached attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if slot_mask.shape != (b, s):
        raise ValueError(f"cached attention: slot_mask must be ({b}, {s}), got "
                         f"{tuple(slot_mask.shape)}")
    if not 0 <= cache_index <= s - t:
        raise ValueError(f"cached attention: {t} new tokens at slot {cache_index} do not "
                         f"fit a cache of {s} slots")


def _check_cuda(tensors):
    dev = tensors[0].device
    if any(x.device != dev for x in tensors):
        raise ValueError("cached attention: all tensors must be on one device")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"cached attention: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("cached attention: tensors must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("cached attention: tensors must be 16-byte aligned")
    if max(x.numel() for x in tensors) >= 2 ** 31:
        raise ValueError("cached attention: sizes must fit in int32")


def cached_attention_kernel(q, k, v, ks, vs, slot_mask, cache_index: int,
                            sm_scale: float) -> torch.Tensor:
    """The wrapper: (B, T, Hq, hd) in q's dtype. The new tokens' K/V must
    already be in the cache (models.llama._kv_write runs first)."""
    check_args(q, k, v, ks, vs, slot_mask, cache_index)
    if q.device.type == "cpu":
        return cached_attention_plain(q, k, v, ks, vs, slot_mask, cache_index, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"cached attention: no kernel for device {q.device}")
    slot_mask = slot_mask.to(torch.int32).contiguous()
    quant = ks is not None
    _check_cuda([q, k, v, slot_mask] + ([ks, vs] if quant else []))
    b, t, hq, hd = q.shape
    o = torch.empty_like(q)
    _build.check(_build.load().smt_cached_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr() if quant else None,
        vs.data_ptr() if quant else None, slot_mask.data_ptr(), o.data_ptr(),
        b, t, k.shape[2], hq, k.shape[1], hd, int(cache_index), float(sm_scale),
        _Q_CODE[q.dtype], _CACHE_CODE[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "cached attention")
    LAUNCHES["cached_attn_q8" if quant else "cached_attn"] += 1
    return o


def cached_attention(q, kv, slot_mask, cache_index: int) -> torch.Tensor:
    """Attention over one layer's decode KV cache (the counterpart of the
    JAX entry point ops/pallas/cached_attention.py cached_attention).

    q: (B, T, Hq, hd) rope'd queries of the new tokens; kv: the layer's
    cache dict {"k", "v"[, "ks", "vs"]} (models.llama.init_cache); slot_mask:
    (B, S), 1 for attendable slots; cache_index: first slot of the T new
    tokens. Returns (B, T, Hq, hd) in q's dtype."""
    return cached_attention_kernel(q, kv["k"], kv["v"], kv.get("ks"), kv.get("vs"),
                                   slot_mask, cache_index, 1.0 / math.sqrt(q.shape[3]))
