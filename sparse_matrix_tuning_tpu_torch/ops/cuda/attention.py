"""K3 fullk attention: causal GQA training attention, forward and backward
(csrc/attention.cu), in the JAX layout.

    q, o: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); lse, delta: (B, Hq, S) fp32
    q-head h reads kv-head h // (Hq // Hkv); hd in {64, 128}; bf16 or fp32

Replaces the Pallas kernels `_fullk_fwd_impl` / `_fullk_bwd_impl` of
ops/pallas/attention.py in the JAX package. Four kernels, each with a
wrapper of its name and a plain PyTorch version `<name>_plain`: `attn_fwd`
(O and lse), then for the backward `attn_bwd_delta` (rowsum(dO*O)),
`attn_bwd_dkdv` and `attn_bwd_dq`; `attn_bwd` runs the three. A wrapper
launches its kernel on CUDA tensors and raises on what it does not take;
on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

HEAD_DIMS = (64, 128)
# kernel launches in this process, per kernel
LAUNCHES = {"attn_fwd": 0, "attn_bwd_delta": 0, "attn_bwd_dkdv": 0, "attn_bwd_dq": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _causal_scores(q, k, sm_scale):
    """fp32 scores (B, Hkv, g, S, S) of the same values (bf16 products are
    exact in fp32) and the causal mask (S, S)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qf = q.reshape(b, s, hkv, hq // hkv, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * sm_scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return scores, causal


def attn_fwd_plain(q, k, v, sm_scale: float):
    """Causal fp32 softmax, lse = logsumexp of the scores, P cast to v's
    dtype before P.V (ops/pallas/attention.py:83). Returns o (B,S,Hq,hd) in
    q's dtype and lse (B,Hq,S) fp32."""
    b, s, hq, hd = q.shape
    scores, causal = _causal_scores(q, k, sm_scale)
    scores = scores.masked_fill(~causal, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return o.reshape(b, s, hq, hd).to(q.dtype), lse.reshape(b, hq, s)


def attn_bwd_delta_plain(o, do):
    """delta = rowsum(dO * O) in fp32, (B, Hq, S)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, sm_scale):
    """P = exp(S*sm - lse) (fp32, 0 above the diagonal) and
    dS = P (dP - delta) sm cast to q's dtype (attention.py:112), with
    dP = dO V^T; both (B, Hkv, g, S, S)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scores, causal = _causal_scores(q, k, sm_scale)
    p = torch.exp(scores - lse.reshape(b, hkv, g, s, 1)).masked_fill(~causal, 0.0)
    dof = do.reshape(b, s, hkv, g, hd).float()
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = (p * (dp - delta.reshape(b, hkv, g, s, 1)) * sm_scale).to(q.dtype).float()
    return p, ds


def attn_bwd_dkdv_plain(q, k, v, do, lse, delta, sm_scale: float):
    """dK = dS^T Q and dV = P^T dO (P in dO's dtype), each summed over the
    group's q-heads, in k's / v's dtype."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, sm_scale)
    qf = q.reshape(b, s, hkv, hq // hkv, hd).float()
    dof = do.reshape(b, s, hkv, hq // hkv, hd).float()
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(do.dtype).float(), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def attn_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale: float):
    """dQ = dS K in q's dtype."""
    b, s, hq, hd = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, sm_scale)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(b, s, hq, hd)
    return dq.to(q.dtype)


def attn_bwd_plain(q, k, v, o, lse, do, sm_scale: float):
    """The explicit backward formula, kernel by kernel: returns dq, dk, dv
    in the inputs' dtypes."""
    delta = attn_bwd_delta_plain(o, do)
    dk, dv = attn_bwd_dkdv_plain(q, k, v, do, lse, delta, sm_scale)
    return attn_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale), dk, dv


def check_args(q, k, v):
    """What the kernels take, on every device: q (B,S,Hq,hd), k/v
    (B,S,Hkv,hd) of one float dtype, bf16 or fp32, hd in HEAD_DIMS, Hq a
    multiple of Hkv."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"fullk attention: want q (B,S,Hq,hd), k/v (B,S,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fullk attention: q/k/v must all be bf16 or all fp32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"fullk attention: head_dim {q.shape[3]} not in {HEAD_DIMS}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"fullk attention: Hq={q.shape[2]} is not a multiple of "
                         f"Hkv={k.shape[2]}")


def _check_cuda(*tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("fullk attention: all tensors must be on one device")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"fullk attention: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fullk attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fullk attention: tensors must be 16-byte aligned")
    if max(t.numel() for t in tensors) >= 2 ** 31:
        raise ValueError("fullk attention: sizes must fit in int32")


def _device_kind(q, what: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {q.device}")
    return q.device.type


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def attn_fwd(q, k, v, sm_scale: float):
    """Returns o (B,S,Hq,hd) in q's dtype and lse (B,Hq,S) fp32."""
    check_args(q, k, v)
    if _device_kind(q, "attn_fwd") == "cpu":
        return attn_fwd_plain(q, k, v, sm_scale)
    _check_cuda(q, k, v)
    b, s, hq, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _build.check(_build.load().smt_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, s, hq, k.shape[2], hd, float(sm_scale), _DTYPE_CODE[q.dtype], _stream(q)),
        "attn_fwd")
    LAUNCHES["attn_fwd"] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta):
    check_args(q, k, v)
    b, s, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"attn_bwd: do must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, s) or t.dtype != torch.float32:
            raise ValueError(f"attn_bwd: {name} must be ({b}, {hq}, {s}) fp32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def attn_bwd_delta(o, do):
    """delta = rowsum(dO * O): (B, Hq, S) fp32."""
    if o.shape != do.shape or o.dtype != do.dtype or o.dim() != 4 \
            or o.dtype not in _DTYPE_CODE or o.shape[3] not in HEAD_DIMS:
        raise ValueError(f"attn_bwd_delta: want o, do alike (B,S,Hq,hd), bf16/fp32, hd "
                         f"in {HEAD_DIMS}; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if _device_kind(o, "attn_bwd_delta") == "cpu":
        return attn_bwd_delta_plain(o, do)
    _check_cuda(o, do)
    b, s, hq, hd = o.shape
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=o.device)
    _build.check(_build.load().smt_attn_bwd_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, s, hq, hd,
        _DTYPE_CODE[o.dtype], _stream(o)), "attn_bwd_delta")
    LAUNCHES["attn_bwd_delta"] += 1
    return delta


def attn_bwd_dkdv(q, k, v, do, lse, delta, sm_scale: float):
    """dk, dv in k's / v's dtype."""
    _check_bwd(q, k, v, do, lse, delta)
    if _device_kind(q, "attn_bwd_dkdv") == "cpu":
        return attn_bwd_dkdv_plain(q, k, v, do, lse, delta, sm_scale)
    _check_cuda(q, k, v, do, lse, delta)
    b, s, hq, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(_build.load().smt_attn_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, hq, k.shape[2], hd,
        float(sm_scale), _DTYPE_CODE[q.dtype], _stream(q)), "attn_bwd_dkdv")
    LAUNCHES["attn_bwd_dkdv"] += 1
    return dk, dv


def attn_bwd_dq(q, k, v, do, lse, delta, sm_scale: float):
    """dq in q's dtype."""
    _check_bwd(q, k, v, do, lse, delta)
    if _device_kind(q, "attn_bwd_dq") == "cpu":
        return attn_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale)
    _check_cuda(q, k, v, do, lse, delta)
    b, s, hq, hd = q.shape
    dq = torch.empty_like(q)
    _build.check(_build.load().smt_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, s, hq, k.shape[2], hd, float(sm_scale),
        _DTYPE_CODE[q.dtype], _stream(q)), "attn_bwd_dq")
    LAUNCHES["attn_bwd_dq"] += 1
    return dq


def attn_bwd(q, k, v, o, lse, do, sm_scale: float):
    """Gradients of attn_fwd's o: the three backward kernels (or their
    plain versions on CPU tensors). Returns dq, dk, dv in the inputs'
    dtypes."""
    delta = attn_bwd_delta(o, do)
    dk, dv = attn_bwd_dkdv(q, k, v, do, lse, delta, sm_scale)
    return attn_bwd_dq(q, k, v, do, lse, delta, sm_scale), dk, dv
