"""K3 fullk attention: causal GQA training attention, forward and backward
(csrc/attention.cu), in the JAX layout.

    q, o: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); lse, delta: (B, Hq, S) fp32
    q-head h reads kv-head h // (Hq // Hkv); hd in {64, 128}; bf16, fp16 or fp32

Replaces the Pallas kernels `_fullk_fwd_impl` / `_fullk_bwd_impl` of
ops/pallas/attention.py in the JAX package. Five kernels, each with a
wrapper of its name and a plain PyTorch version `<name>_plain`: `attn_fwd`
(O and lse), then for the backward `attn_bwd_delta` (rowsum(dO*O)),
`attn_bwd_dkdv` (over P partitions of each group's q-heads, chosen by
`plan_partitions`; with P > 1 it writes fp32 partials and
`attn_bwd_dkdv_reduce` sums them in partition order) and `attn_bwd_dq`;
`attn_bwd` runs them. A wrapper launches its kernel on CUDA tensors and
raises on what it does not take; on CPU tensors it runs the plain version.
LAUNCHES counts each kernel's fp16 body under its name + "_fp16".
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.ops.cuda import _build

HEAD_DIMS = (64, 128)
KERNELS = ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dkdv_reduce", "attn_bwd_dq")
# kernel launches in this process, per kernel; the fp16 bodies apart
LAUNCHES = {**{n: 0 for n in KERNELS}, **{f"{n}_fp16": 0 for n in KERNELS}}
KEY_TILE = 64       # keys per dK/dV CTA
H100_SMS = 132


def plan_partitions(b: int, s: int, hq: int, hkv: int, n_sm: int = H100_SMS) -> int:
    """q-head partitions P of attn_bwd_dkdv for a bf16 or fp16 launch: the smallest
    divisor P of the group size g = hq / hkv that gives at least two CTAs
    per SM, (S / 64 key tiles) x hkv x b x P >= 2 * n_sm; g when none does."""
    g = hq // hkv
    ctas = -(-s // KEY_TILE) * hkv * b
    for p in range(1, g + 1):
        if g % p == 0 and ctas * p >= 2 * n_sm:
            return p
    return g

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF = (torch.bfloat16, torch.float16)  # the tensor-core bodies


def _count(name: str, dtype: torch.dtype):
    LAUNCHES[name + ("_fp16" if dtype == torch.float16 else "")] += 1


def _causal_scores(q, k, sm_scale):
    """fp32 scores (B, Hkv, g, S, S) of the same values (bf16 and fp16
    products are exact in fp32) and the causal mask (S, S)."""
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


def attn_bwd_dkdv_partials_plain(q, k, v, do, lse, delta, sm_scale: float,
                                 partitions: int) -> torch.Tensor:
    """The fp32 workspace of attn_bwd_dkdv at P = partitions: (2, P, B, S,
    Hkv, hd), [0, p] the dK and [1, p] the dV summed over the q-heads of
    partition p of each group (heads p * g / P .. (p + 1) * g / P - 1)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    p_, ds = _probs_and_ds(q, k, v, do, lse, delta, sm_scale)
    qf = q.reshape(b, s, hkv, partitions, g // partitions, hd).float()
    dof = do.reshape(b, s, hkv, partitions, g // partitions, hd).float()
    ds = ds.reshape(b, hkv, partitions, g // partitions, s, s)
    p_ = p_.to(do.dtype).float().reshape(b, hkv, partitions, g // partitions, s, s)
    dk = torch.einsum("bkpgqs,bqkpgd->pbskd", ds, qf)
    dv = torch.einsum("bkpgqs,bqkpgd->pbskd", p_, dof)
    return torch.stack([dk, dv]).contiguous()


def attn_bwd_dkdv_reduce_plain(ws: torch.Tensor, dtype: torch.dtype):
    """dk, dv: the workspace's partials summed over p = 0, 1, .. in that
    order, cast to dtype."""
    acc = ws[:, 0].clone()
    for p in range(1, ws.shape[1]):
        acc += ws[:, p]
    return acc[0].to(dtype), acc[1].to(dtype)


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
    (B,S,Hkv,hd) of one float dtype, bf16, fp16 or fp32, hd in HEAD_DIMS, Hq
    a multiple of Hkv."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"fullk attention: want q (B,S,Hq,hd), k/v (B,S,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fullk attention: q/k/v must all be bf16 or all fp32, or all fp16, got "
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
    _count("attn_fwd", q.dtype)
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
        raise ValueError(f"attn_bwd_delta: want o, do alike (B,S,Hq,hd), bf16/fp16/fp32, hd "
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
    _count("attn_bwd_delta", o.dtype)
    return delta


def _check_partitions(q, k, partitions: int):
    g = q.shape[2] // k.shape[2]
    if not (1 <= partitions <= g and g % partitions == 0):
        raise ValueError(f"attn_bwd_dkdv: {partitions} partitions do not divide the group of "
                         f"{g} q-heads")
    if partitions > 1 and q.dtype not in _HALF:
        raise ValueError("attn_bwd_dkdv: partitions > 1 need bf16 or fp16 inputs (the fp32 "
                         "kernel walks the whole group)")


def _launch_dkdv(q, k, v, do, lse, delta, sm_scale, partitions, dk, dv, ws):
    b, s, hq, hd = q.shape
    _build.check(_build.load().smt_attn_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr() if dk is not None else None,
        dv.data_ptr() if dv is not None else None, ws.data_ptr() if ws is not None else None,
        b, s, hq, k.shape[2], hd, partitions, float(sm_scale), _DTYPE_CODE[q.dtype],
        _stream(q)), "attn_bwd_dkdv")
    _count("attn_bwd_dkdv", q.dtype)


def _launch_reduce(ws, dk, dv):
    _build.check(_build.load().smt_attn_bwd_dkdv_reduce(
        ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), dk.numel(), ws.shape[1],
        _DTYPE_CODE[dk.dtype], _stream(ws)), "attn_bwd_dkdv_reduce")
    _count("attn_bwd_dkdv_reduce", dk.dtype)


def attn_bwd_dkdv_partials(q, k, v, do, lse, delta, sm_scale: float,
                           partitions: int) -> torch.Tensor:
    """The kernel's fp32 workspace (2, P, B, S, Hkv, hd) at P = partitions
    > 1 (attn_bwd_dkdv_partials_plain on CPU tensors)."""
    _check_bwd(q, k, v, do, lse, delta)
    _check_partitions(q, k, partitions)
    if partitions < 2:
        raise ValueError("attn_bwd_dkdv_partials: the kernel writes partials for P > 1 only")
    if _device_kind(q, "attn_bwd_dkdv") == "cpu":
        return attn_bwd_dkdv_partials_plain(q, k, v, do, lse, delta, sm_scale, partitions)
    _check_cuda(q, k, v, do, lse, delta)
    ws = torch.empty((2, partitions, *k.shape), dtype=torch.float32, device=q.device)
    _launch_dkdv(q, k, v, do, lse, delta, sm_scale, partitions, None, None, ws)
    return ws


def attn_bwd_dkdv_reduce(ws: torch.Tensor, dtype: torch.dtype):
    """dk, dv in dtype from a workspace (2, P, B, S, Hkv, hd) fp32: the sums
    over p in partition order."""
    if ws.dim() != 6 or ws.shape[0] != 2 or ws.dtype != torch.float32 \
            or dtype not in _DTYPE_CODE or ws.shape[5] not in HEAD_DIMS:
        raise ValueError(f"attn_bwd_dkdv_reduce: want an fp32 workspace (2, P, B, S, Hkv, hd), "
                         f"hd in {HEAD_DIMS}, and a bf16/fp16/fp32 output; got {tuple(ws.shape)} "
                         f"{ws.dtype} -> {dtype}")
    if _device_kind(ws, "attn_bwd_dkdv_reduce") == "cpu":
        return attn_bwd_dkdv_reduce_plain(ws, dtype)
    _check_cuda(ws)
    dk = torch.empty(ws.shape[2:], dtype=dtype, device=ws.device)
    dv = torch.empty_like(dk)
    _launch_reduce(ws, dk, dv)
    return dk, dv


def attn_bwd_dkdv(q, k, v, do, lse, delta, sm_scale: float, partitions=None):
    """dk, dv in k's / v's dtype. partitions: the q-head partitions P of the
    kernel, plan_partitions' choice when None (bf16, fp16; fp32 takes 1); P > 1
    launches attn_bwd_dkdv_reduce after it."""
    _check_bwd(q, k, v, do, lse, delta)
    if partitions is None:
        partitions = (plan_partitions(q.shape[0], q.shape[1], q.shape[2], k.shape[2])
                      if q.dtype in _HALF else 1)
    _check_partitions(q, k, partitions)
    if _device_kind(q, "attn_bwd_dkdv") == "cpu":
        return attn_bwd_dkdv_plain(q, k, v, do, lse, delta, sm_scale)
    _check_cuda(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if partitions == 1:
        _launch_dkdv(q, k, v, do, lse, delta, sm_scale, 1, dk, dv, None)
        return dk, dv
    ws = torch.empty((2, partitions, *k.shape), dtype=torch.float32, device=q.device)
    _launch_dkdv(q, k, v, do, lse, delta, sm_scale, partitions, None, None, ws)
    _launch_reduce(ws, dk, dv)
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
    _count("attn_bwd_dq", q.dtype)
    return dq


def attn_bwd(q, k, v, o, lse, do, sm_scale: float):
    """Gradients of attn_fwd's o: the backward kernels (or their plain
    versions on CPU tensors). Returns dq, dk, dv in the inputs'
    dtypes."""
    delta = attn_bwd_delta(o, do)
    dk, dv = attn_bwd_dkdv(q, k, v, do, lse, delta, sm_scale)
    return attn_bwd_dq(q, k, v, do, lse, delta, sm_scale), dk, dv
