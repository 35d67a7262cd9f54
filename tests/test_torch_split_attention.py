"""The algorithms behind the redesigned attention kernels, on the CPU where
their plain versions run: K7's split of the cache (flash-decoding: each
split's unnormalised o, m, l, then the combine) against the plain cached
attention and, inside the KV-cache forward, against the JAX package's
einsum path of `_cached_layer`; K3's dK/dV over q-head partitions (fp32
partials, then the fixed-order reduce) against the plain backward and the
JAX Pallas kernel's gradients in interpret mode; and the two planners.
Tolerances: fp32 1e-5 (the same sums in another order); bf16 1e-2 of the
largest |o| (P rounded to bf16 before or after normalising); the JAX
suites' 2e-3 (cached attention) and (1e-5, 1e-4) (fullk gradients)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.ops.pallas.attention import fullk_attention as jax_fullk
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.ops.cuda import attention as k3
from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7

BF16_REL = 1e-2
JAX_CACHED_TOL = 2e-3          # tests/test_cached_attention.py:85
JAX_GRAD_TOL = (1e-5, 1e-4)    # tests/test_attention_kernel.py, fp32


# ---------------------------------------------------------------------------
# K7: split, then combine
# ---------------------------------------------------------------------------

def _k7_inputs(cache, t, ci, seed=0, b=3, hq=8, hkv=2, hd=64, s=96):
    """q and a cache of `cache` dtype (q bf16 over a bf16 cache, fp32
    otherwise) and a slot mask: row 0 left-padded by 5 slots; row 1 with a
    few masked slots; row 2 sees no slot before ci + 2 (in a decode step
    none at all, in a prefill its first tokens none)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, hd)).astype(np.float32)
    kf = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    vf = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    sm = np.zeros((b, s), np.int32)
    sm[0, 5:ci + t] = 1
    sm[1, :ci + t] = 1
    sm[1, [3, 17, ci - 1]] = 0
    sm[2, ci + 2:ci + t] = 1
    qdt = torch.bfloat16 if cache == "bf16" else torch.float32
    if cache == "int8":
        ks = np.abs(kf).max(-1) / 127.0 + 1e-10
        vs = np.abs(vf).max(-1) / 127.0 + 1e-10
        k = torch.from_numpy(np.round(kf / ks[..., None]).astype(np.int8))
        v = torch.from_numpy(np.round(vf / vs[..., None]).astype(np.int8))
        ks = torch.from_numpy(ks[:, :, None, :].astype(np.float32))
        vs = torch.from_numpy(vs[:, :, None, :].astype(np.float32))
    else:
        cdt = torch.bfloat16 if cache == "bf16" else torch.float32
        k, v = torch.from_numpy(kf).to(cdt), torch.from_numpy(vf).to(cdt)
        ks = vs = None
    return (torch.from_numpy(q).to(qdt), k, v, ks, vs, torch.from_numpy(sm), ci,
            1.0 / math.sqrt(hd))


def _assert_close_to(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        err = float((got.float() - want.float()).abs().max())
        assert err <= BF16_REL * float(want.float().abs().max()), err
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache", ["bf16", "fp32", "int8"])
@pytest.mark.parametrize("t,ci", [(1, 70), (5, 40)], ids=["decode", "prefill"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_then_combine_equals_plain(splits, t, ci, cache):
    args = _k7_inputs(cache, t, ci)
    q, k, v, ks, vs, sm, ci, scale = args
    kend = k7.visible_end(t, ci, k.shape[2])
    bounds = k7.split_bounds(kend, 4, splits)  # 4-slot tiles: 11 .. 18 of them
    ws_o, ws_m, ws_l = k7.cached_attention_split_plain(*args, bounds)
    b, _, hq, hd = q.shape
    assert ws_o.shape == (splits, b, t, hq, hd) and ws_m.shape == ws_l.shape == (splits, b, t, hq)
    got = k7.cached_attn_combine(ws_o, ws_m, ws_l, q.dtype)
    want = k7.cached_attention_plain(*args)
    _assert_close_to(got, want)
    unseen = ~k7.visible_slots(sm, ci, t).any(-1)  # (B, T): rows that see no slot
    assert unseen[2].any() and (got[unseen] == 0).all() and torch.isfinite(got).all()
    # a split that sees nothing of a row leaves it out: m -inf, l 0, o 0
    assert ((ws_m == float("-inf")) == (ws_l == 0)).all()
    assert (ws_o[ws_l == 0] == 0).all()


def test_combine_of_one_split_normalises_it():
    args = _k7_inputs("fp32", 1, 70)
    bounds = k7.split_bounds(71, 256, 1)
    assert bounds == [(0, 71)]
    ws = k7.cached_attention_split_plain(*args, bounds)
    torch.testing.assert_close(k7.cached_attn_combine(*ws, torch.float32),
                               ws[0][0] / torch.where(ws[2][0] > 0, ws[2][0], 1.0)[..., None])


def _split_cached_attention(splits, slots):
    """models.llama's cached_attention through the plain split and the
    combine wrapper (its CPU path)."""
    def fn(q, kv, slot_mask, cache_index):
        t, s = q.shape[1], kv["k"].shape[2]
        bounds = k7.split_bounds(k7.visible_end(t, cache_index, s), slots, splits)
        ws = k7.cached_attention_split_plain(q, kv["k"], kv["v"], kv.get("ks"), kv.get("vs"),
                                             slot_mask, cache_index,
                                             1.0 / math.sqrt(q.shape[3]), bounds)
        return k7.cached_attn_combine(*ws, q.dtype)
    return fn


JCFG = jllama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=512)
PCFG = llama.LlamaConfig(**JCFG.__dict__)
MAXLEN = 64


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, tp.port_params(jp)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_split_cache_forward_matches_jax_einsum(weights, monkeypatch, cache_dtype):
    """A left-padded prefill and two decode steps through forward_with_cache,
    the port's attention split 3 ways over 8-slot tiles, against the JAX
    package's einsum path of _cached_layer: logits at real positions within
    the JAX suite's tolerance."""
    jp, pp = weights
    monkeypatch.setattr(jllama, "_FORCE_CACHED_ATTN", False)
    monkeypatch.setenv("SMT_CACHED_ATTN", "on")
    monkeypatch.setattr(llama, "cached_attention", _split_cached_attention(3, 8))
    assert not jllama._use_cached_attn(JCFG, MAXLEN)
    rng = np.random.default_rng(5)
    lens, width = (9, 20), 20
    ids = np.zeros((2, width), np.int32)
    mask = np.zeros((2, width), np.int32)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(3, 500, n)
        mask[i, width - n:] = 1
    sm = np.zeros((2, MAXLEN), np.int32)
    sm[:, :width] = mask
    pos = np.maximum(mask.cumsum(-1) - 1, 0)
    jcache = jllama.init_cache(JCFG, 2, MAXLEN, dtype=jnp.dtype(cache_dtype))
    pcache = llama.init_cache(PCFG, 2, MAXLEN, dtype=getattr(torch, cache_dtype))
    ci, last = 0, pos[:, -1]
    for step in range(3):
        jl, jcache = jllama.forward_with_cache(jp, jnp.asarray(ids), JCFG, jcache, ci,
                                               jnp.asarray(sm), jnp.asarray(pos))
        pl, pcache = llama.forward_with_cache(pp, torch.from_numpy(ids).long(), PCFG, pcache,
                                              ci, torch.from_numpy(sm), torch.from_numpy(pos))
        jl = np.asarray(jl)
        real = mask.astype(bool) if step == 0 else np.ones(ids.shape, bool)
        assert torch.isfinite(pl).all()
        np.testing.assert_allclose(tp.np32(pl)[real], jl[real], rtol=JAX_CACHED_TOL,
                                   atol=JAX_CACHED_TOL)
        # the next token: JAX's greedy choice, fed to both
        nxt = jl[:, -1].argmax(-1).astype(np.int32)
        ci += ids.shape[1]
        ids, mask = nxt[:, None], np.ones((2, 1), np.int32)
        last = last + 1
        pos = last[:, None].astype(np.int64)
        sm[:, ci] = 1


def test_split_refusals():
    q, k, v, ks, vs, sm, ci, scale = _k7_inputs("fp32", 1, 70)
    with pytest.raises(ValueError, match="bf16 q"):
        k7.cached_attention_kernel(q, k, v, ks, vs, sm, ci, scale, splits=2)
    qb, kb, vb, _, _, _, _, _ = _k7_inputs("bf16", 1, 70)
    with pytest.raises(ValueError, match="splits for 71 visible slots"):
        k7.cached_attention_kernel(qb, kb, vb, None, None, sm, ci, scale, splits=2)  # one tile
    with pytest.raises(ValueError, match="combine"):
        k7.cached_attn_combine(torch.zeros(2, 1, 1, 8, 64), torch.zeros(2, 1, 1, 4),
                               torch.zeros(2, 1, 1, 8), torch.bfloat16)
    assert k7.LAUNCHES == {"cached_attn": 0, "cached_attn_q8": 0, "cached_attn_combine": 0}


# ---------------------------------------------------------------------------
# K3: dK/dV over q-head partitions, then the reduce
# ---------------------------------------------------------------------------

B, S, HKV, HD = 1, 128, 2, 64


def _k3_inputs(g, seed=4):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, g * HKV, HD), (B, S, HKV, HD), (B, S, HKV, HD), (B, S, g * HKV, HD))
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@functools.lru_cache(maxsize=None)
def _jax_dkdv(g):
    """dK, dV of sum(o * w) through the JAX Pallas kernel (interpret mode on
    the CPU, as tests/test_attention_kernel.py runs it)."""
    q, k, v, w = _k3_inputs(g)

    def loss(k_, v_):
        o = jax_fullk(jnp.asarray(q), k_, v_, 1.0 / math.sqrt(HD))
        return jnp.sum(o.astype(jnp.float32) * w)
    return tuple(np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(jnp.asarray(k),
                                                                         jnp.asarray(v)))


@pytest.mark.parametrize("g,partitions", [(1, 1), (2, 1), (2, 2), (8, 1), (8, 2), (8, 8)])
def test_dkdv_partials_and_reduce_equal_plain_and_jax(g, partitions):
    q, k, v, do = (torch.from_numpy(a) for a in _k3_inputs(g))
    sm = 1.0 / math.sqrt(HD)
    o, lse = k3.attn_fwd_plain(q, k, v, sm)
    delta = k3.attn_bwd_delta_plain(o, do)
    ws = k3.attn_bwd_dkdv_partials_plain(q, k, v, do, lse, delta, sm, partitions)
    assert ws.shape == (2, partitions, B, S, HKV, HD) and ws.dtype == torch.float32
    dk, dv = k3.attn_bwd_dkdv_reduce(ws, torch.float32)  # the wrapper's CPU path
    dk_ref, dv_ref = k3.attn_bwd_dkdv_plain(q, k, v, do, lse, delta, sm)
    torch.testing.assert_close(dk, dk_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-5, atol=1e-5)
    jdk, jdv = _jax_dkdv(g)
    np.testing.assert_allclose(dk.numpy(), jdk, *JAX_GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), jdv, *JAX_GRAD_TOL)
    # each partition holds its own heads' share: dropping one changes dK
    if partitions > 1:
        assert not torch.allclose(ws[0, 1:].sum(0), dk_ref, rtol=1e-3, atol=1e-3)


def test_reduce_sums_in_partition_order_and_casts():
    ws = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 1, 4, 2, 64))
                          .astype(np.float32))
    dk, dv = k3.attn_bwd_dkdv_reduce(ws, torch.bfloat16)
    assert dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == (1, 4, 2, 64)
    assert torch.equal(dk, ((ws[0, 0] + ws[0, 1]) + ws[0, 2]).to(torch.bfloat16))
    assert torch.equal(dv, ((ws[1, 0] + ws[1, 1]) + ws[1, 2]).to(torch.bfloat16))


def test_partition_refusals():
    q, k, v, do = (torch.from_numpy(a) for a in _k3_inputs(8))
    lse = torch.zeros(B, 8 * HKV, S)
    with pytest.raises(ValueError, match="do not divide"):
        k3.attn_bwd_dkdv(q, k, v, do, lse, lse, 0.125, partitions=3)
    with pytest.raises(ValueError, match="need bf16"):
        k3.attn_bwd_dkdv(q, k, v, do, lse, lse, 0.125, partitions=2)
    with pytest.raises(ValueError, match="workspace"):
        k3.attn_bwd_dkdv_reduce(torch.zeros(2, 2, 1, 4, 2, 64, dtype=torch.bfloat16),
                                torch.bfloat16)
    assert k3.LAUNCHES == {n: 0 for n in k3.LAUNCHES}


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------

# (B, Hkv, rows = T * g, hd, visible slots, the plan PERF.md records)
K7_PLANS = [
    (64, 4, 8, 64, 301, 1),        # TinyLlama eval decode (D1), 16 prompts x 4 beams
    (16, 4, 8, 64, 301, 1),        # TinyLlama greedy decode (D2)
    (1, 4, 8, 64, 1901, 4),        # TinyLlama, one 1.9k-token prompt (D5)
    (16, 8, 4, 128, 3841, 1),      # Llama-3-8B geometry decode
    (1, 8, 4, 128, 16001, 9),      # one 16k sequence at the 8B geometry
    (1, 8, 4, 128, 600, 2),        # ... short: two CTA tiles a split
    (16, 4, 2048, 64, 256, 1),     # TinyLlama eval prefill: many CTAs already
    (512, 8, 4, 128, 3841, 1),     # a batch of 512 fills the card
    (64, 4, 8, 64, 200, 1),        # one CTA tile: nothing to split
]


@pytest.mark.parametrize("b,hkv,rows,hd,kend,want", K7_PLANS)
def test_split_plan(b, hkv, rows, hd, kend, want):
    splits = k7.plan_splits(b, hkv, rows, hd, kend)
    assert splits == want
    bounds = k7.split_bounds(kend, k7.cta_slots(hd, rows), splits)
    # every visible slot in exactly one split, no split empty, tile-aligned
    assert bounds[0][0] == 0 and bounds[-1][1] == kend
    assert all(hi > lo for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert all(lo % k7.cta_slots(hd, rows) == 0 for lo, _ in bounds)
    assert k7.plan_splits(b, hkv, rows, hd, kend, torch.float32) == 1


def test_split_plan_never_leaves_a_split_empty():
    for b in (1, 3, 16, 64, 300):
        for hkv in (1, 4, 8):
            for rows, hd in ((1, 64), (8, 64), (16, 128), (64, 64)):
                for kend in (1, 63, 64, 65, 255, 257, 1000, 4097, 20000):
                    slots = k7.cta_slots(hd, rows)
                    splits = k7.plan_splits(b, hkv, rows, hd, kend)
                    assert 1 <= splits <= -(-kend // slots)
                    covered = [hi - lo for lo, hi in k7.split_bounds(kend, slots, splits)]
                    assert min(covered) > 0 and sum(covered) == kend


# (B, S, Hq, Hkv, the plan PERF.md records)
K3_PLANS = [(4, 512, 32, 4, 4), (2, 2048, 32, 4, 2), (1, 2048, 32, 8, 2), (2, 1000, 32, 4, 4),
            (64, 2048, 32, 4, 1)]


@pytest.mark.parametrize("b,s,hq,hkv,want", K3_PLANS)
def test_partition_plan(b, s, hq, hkv, want):
    assert k3.plan_partitions(b, s, hq, hkv) == want


def test_partition_plan_divides_the_group():
    for b in (1, 2, 4, 16):
        for s in (64, 500, 512, 2048):
            for hq, hkv in ((32, 4), (32, 8), (8, 8), (12, 4), (32, 1)):
                p = k3.plan_partitions(b, s, hq, hkv)
                g = hq // hkv
                assert 1 <= p <= g and g % p == 0
                ctas = -(-s // 64) * hkv * b
                # the smallest such divisor: one smaller gives too few CTAs
                assert p == g or ctas * p >= 2 * k3.H100_SMS
                assert all(ctas * d < 2 * k3.H100_SMS for d in range(1, p) if g % d == 0)
