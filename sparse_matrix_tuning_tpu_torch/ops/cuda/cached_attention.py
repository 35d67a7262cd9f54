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

Split over the cache (flash-decoding, bf16 q): `plan_splits` cuts the
visible slots of a call whose rows fit one CTA into contiguous ranges
(`split_bounds`); the kernel writes each range's unnormalised o and its m,
l to a workspace (`cached_attention_split_plain` is its plain version),
and `cached_attn_combine` merges them in split order.
"""

from __future__ import annotations

import math

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

HEAD_DIMS = (64, 128)
# kernel launches in this process: per body (bf16/fp32 cache, int8
# cache), and the merge of the splits
LAUNCHES = {"cached_attn": 0, "cached_attn_q8": 0, "cached_attn_combine": 0}
H100_SMS = 132

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
    scores = _scores(q, k, ks, sm_scale)
    keep = visible_slots(slot_mask, cache_index, t)[:, None, None]  # (B,1,1,T,S)
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    probs = torch.where(keep.any(-1, keepdim=True), probs, torch.zeros((), device=q.device))
    if vs is not None:
        probs = probs * vs.reshape(b, hkv, 1, 1, s)
    o = torch.einsum("bkgts,bksd->btkgd", probs.to(q.dtype).float(), v.to(q.dtype).float())
    return o.reshape(b, t, hq, hd).to(q.dtype)


def cta_rows(rows: int) -> int:
    """Rows of one bf16 CTA: 16 when a call has at most 16 token-major rows
    (its warps split the slots), else 64."""
    return 16 if rows <= 16 else 64


def cta_slots(hd: int, rows: int) -> int:
    """Slots of one CTA tile of the bf16 kernel (csrc k7_cta_slots)."""
    if rows <= 16:
        return 128 if hd == 128 else 256
    return 64


def visible_end(t: int, cache_index: int, s: int) -> int:
    """One past the last slot the call's last token can see."""
    return min(s, cache_index + t)


def plan_splits(b: int, hkv: int, rows: int, hd: int, kend: int, q_dtype=torch.bfloat16,
                n_sm: int = H100_SMS) -> int:
    """Splits of the cache for a bf16 call of `rows` = T * g token-major
    rows that sees slots [0, kend): 1 unless the rows fit one CTA and the
    b * hkv CTAs are fewer than a quarter of the SMs; then enough splits
    for CTAs on about half the SMs, with at least two CTA tiles a split
    (so none is empty). On the H100 the combine's launch costs more than a
    split saves from 64 CTAs up, and 64 CTAs walked a 16k cache fastest
    (PERF.md, section 6)."""
    if q_dtype != torch.bfloat16 or rows > cta_rows(rows):
        return 1
    ctas = b * hkv
    if 4 * ctas >= n_sm:
        return 1
    tiles = -(-kend // cta_slots(hd, rows))
    return max(1, min(tiles // 2, -(-n_sm // (2 * ctas))))


def split_bounds(kend: int, slots: int, splits: int):
    """[(lo, hi)] slot range of each split: the CTA tiles of `slots` slots
    up to kend, cut into `splits` contiguous runs of tiles (the kernel's
    rule, tile ranges [s * n / splits, (s + 1) * n / splits))."""
    n = -(-kend // slots)
    return [(s * n // splits * slots, min((s + 1) * n // splits * slots, kend))
            for s in range(splits)]


def _scores(q, k, ks, sm_scale):
    b, t, hq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qf = q.reshape(b, t, hkv, hq // hkv, hd).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qf, k.to(q.dtype).float())
    if ks is not None:
        scores = scores * ks.reshape(b, hkv, 1, 1, s)
    return scores * sm_scale


def cached_attention_split_plain(q, k, v, ks, vs, slot_mask, cache_index: int,
                                 sm_scale: float, bounds):
    """Each split's part of the kernel's arithmetic, over the visible slots
    of its range (lo, hi): m = the largest score (-inf if none), l = sum of
    p = exp(score - m), o = sum of p (x vs_j) cast to q's dtype, times v.
    Returns the workspace: o (splits, B, T, Hq, hd), m and l (splits, B, T,
    Hq), fp32."""
    b, t, hq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scores = _scores(q, k, ks, sm_scale)
    keep = visible_slots(slot_mask, cache_index, t)[:, None, None]  # (B,1,1,T,S)
    slots = torch.arange(s, device=q.device)
    vf = v.to(q.dtype).float()
    outs, ms, ls = [], [], []
    for lo, hi in bounds:
        mine = keep & (slots >= lo) & (slots < hi)
        x = scores.masked_fill(~mine, float("-inf"))
        m = x.amax(-1, keepdim=True)
        p = torch.exp(x - torch.where(m == float("-inf"), torch.zeros_like(m), m))
        ls.append(p.sum(-1))
        if vs is not None:
            p = p * vs.reshape(b, hkv, 1, 1, s)
        outs.append(torch.einsum("bkgts,bksd->btkgd", p.to(q.dtype).float(), vf))
        ms.append(m[..., 0])
    to_rows = lambda x: x.permute(0, 3, 1, 2).reshape(b, t, hq)  # (B,Hkv,g,T) -> (B,T,Hq)
    return (torch.stack(outs).reshape(len(bounds), b, t, hq, hd),
            torch.stack([to_rows(m) for m in ms]), torch.stack([to_rows(x) for x in ls]))


def cached_attn_combine_plain(ws_o, ws_m, ws_l, dtype) -> torch.Tensor:
    """o = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M), M the largest m,
    summed in split order; 0 where no split saw a slot. In dtype."""
    big = ws_m.amax(0)
    none = big == float("-inf")
    big = torch.where(none, torch.zeros_like(big), big)
    num = torch.zeros_like(ws_o[0])
    den = torch.zeros_like(ws_l[0])
    for o_s, m_s, l_s in zip(ws_o, ws_m, ws_l):
        f = torch.exp(m_s - big)
        num += o_s * f[..., None]
        den += l_s * f
    o = torch.where(den[..., None] > 0, num / torch.where(den > 0, den, 1.0)[..., None],
                    torch.zeros((), device=num.device))
    return o.to(dtype)


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


def _plan(q, k, cache_index, splits):
    b, t, hq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rows = t * (hq // hkv)
    kend = visible_end(t, cache_index, s)
    if splits is None:
        splits = plan_splits(b, hkv, rows, hd, kend, q.dtype)
    if splits > 1 and (q.dtype != torch.bfloat16 or rows > cta_rows(rows)):
        raise ValueError("cached attention: splits > 1 need bf16 q and rows that fit one CTA "
                         f"(T * g = {rows} > {cta_rows(rows)})")
    if not 1 <= splits <= max(1, -(-kend // cta_slots(hd, rows))) or b * splits > 65535:
        raise ValueError(f"cached attention: {splits} splits for {kend} visible slots")
    return splits


def _launch(q, k, v, ks, vs, slot_mask, cache_index, sm_scale, splits, o, ws):
    b, t, hq, hd = q.shape
    quant = ks is not None
    ptr = lambda x: x.data_ptr() if x is not None else None
    _build.check(_build.load().smt_cached_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs), slot_mask.data_ptr(),
        ptr(o), *(ptr(x) for x in ws), b, t, k.shape[2], hq, k.shape[1], hd,
        int(cache_index), float(sm_scale), _Q_CODE[q.dtype], _CACHE_CODE[k.dtype], splits,
        torch.cuda.current_stream(q.device).cuda_stream), "cached attention")
    LAUNCHES["cached_attn_q8" if quant else "cached_attn"] += 1


def _cuda_inputs(q, k, v, ks, vs, slot_mask):
    if q.device.type != "cuda":
        raise ValueError(f"cached attention: no kernel for device {q.device}")
    slot_mask = slot_mask.to(torch.int32).contiguous()
    _check_cuda([q, k, v, slot_mask] + ([ks, vs] if ks is not None else []))
    return slot_mask


def _workspace(q, splits):
    """(o, m, l) of `splits` splits, fp32, in one allocation (each part
    16-byte aligned)."""
    b, t, hq, hd = q.shape
    n = splits * b * t * hq
    n4 = -(-n // 4) * 4
    buf = torch.empty(n * hd + 2 * n4, dtype=torch.float32, device=q.device)
    m0, l0 = n * hd, n * hd + n4
    return (buf[:m0].view(splits, b, t, hq, hd), buf[m0:m0 + n].view(splits, b, t, hq),
            buf[l0:l0 + n].view(splits, b, t, hq))


def _launch_combine(ws, o):
    ws_o, ws_m, ws_l = ws
    _build.check(_build.load().smt_cached_attn_combine(
        ws_o.data_ptr(), ws_m.data_ptr(), ws_l.data_ptr(), o.data_ptr(), ws_m[0].numel(),
        ws_o.shape[4], ws_o.shape[0], _Q_CODE[o.dtype],
        torch.cuda.current_stream(o.device).cuda_stream), "cached_attn_combine")
    LAUNCHES["cached_attn_combine"] += 1


def cached_attention_partials(q, k, v, ks, vs, slot_mask, cache_index: int, sm_scale: float,
                              splits: int):
    """The split kernel's workspace (o, m, l) at `splits` > 1
    (cached_attention_split_plain on CPU tensors)."""
    check_args(q, k, v, ks, vs, slot_mask, cache_index)
    splits = _plan(q, k, cache_index, splits)
    if splits < 2:
        raise ValueError("cached_attention_partials: the kernel writes partials for splits > 1")
    b, t, hq, hd = q.shape
    if q.device.type == "cpu":
        rows = t * (hq // k.shape[1])
        bounds = split_bounds(visible_end(t, cache_index, k.shape[2]), cta_slots(hd, rows),
                              splits)
        return cached_attention_split_plain(q, k, v, ks, vs, slot_mask, cache_index, sm_scale,
                                            bounds)
    slot_mask = _cuda_inputs(q, k, v, ks, vs, slot_mask)
    ws = _workspace(q, splits)
    _launch(q, k, v, ks, vs, slot_mask, cache_index, sm_scale, splits, None, ws)
    return ws


def cached_attn_combine(ws_o, ws_m, ws_l, dtype) -> torch.Tensor:
    """o (B, T, Hq, hd) in dtype from a split workspace (splits, B, T, Hq,
    hd) and (splits, B, T, Hq) fp32."""
    if ws_o.dim() != 5 or ws_m.shape != ws_o.shape[:4] or ws_l.shape != ws_m.shape \
            or any(x.dtype != torch.float32 for x in (ws_o, ws_m, ws_l)) \
            or ws_o.shape[4] not in HEAD_DIMS or dtype not in _Q_CODE:
        raise ValueError(f"cached_attn_combine: want fp32 (splits, B, T, Hq, hd), hd in "
                         f"{HEAD_DIMS}, m and l (splits, B, T, Hq), a bf16/fp32 output; got "
                         f"{tuple(ws_o.shape)}, {tuple(ws_m.shape)}, {tuple(ws_l.shape)} -> {dtype}")
    if ws_o.device.type == "cpu":
        return cached_attn_combine_plain(ws_o, ws_m, ws_l, dtype)
    if ws_o.device.type != "cuda":
        raise ValueError(f"cached_attn_combine: no kernel for device {ws_o.device}")
    _check_cuda([ws_o, ws_m, ws_l])
    o = torch.empty(ws_o.shape[1:], dtype=dtype, device=ws_o.device)
    _launch_combine((ws_o, ws_m, ws_l), o)
    return o


def cached_attention_kernel(q, k, v, ks, vs, slot_mask, cache_index: int,
                            sm_scale: float, splits=None) -> torch.Tensor:
    """The wrapper: (B, T, Hq, hd) in q's dtype. The new tokens' K/V must
    already be in the cache (models.llama._kv_write runs first). splits:
    plan_splits' choice when None; more than 1 launches
    cached_attn_combine after the kernel."""
    check_args(q, k, v, ks, vs, slot_mask, cache_index)
    splits = _plan(q, k, cache_index, splits)
    if q.device.type == "cpu":
        return cached_attention_plain(q, k, v, ks, vs, slot_mask, cache_index, sm_scale)
    slot_mask = _cuda_inputs(q, k, v, ks, vs, slot_mask)
    o = torch.empty_like(q)
    if splits == 1:
        _launch(q, k, v, ks, vs, slot_mask, cache_index, sm_scale, 1, o, (None, None, None))
        return o
    ws = _workspace(q, splits)
    _launch(q, k, v, ks, vs, slot_mask, cache_index, sm_scale, splits, None, ws)
    _launch_combine(ws, o)
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
