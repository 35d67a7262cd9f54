"""The port's cached attention (K7) and KV-cache forward on the CPU, where
the K7 wrapper runs its plain version, against the JAX package: K7 against
the JAX cached_attention (Pallas in interpret mode, on
tests/test_cached_attention.py's inputs), rows that see no slot,
forward_with_cache prefill logits (kernel and einsum legs, fp32 and int8
caches), the cache layout and int8 write, and a decode step from a cache
carried over from JAX. Tolerances are the JAX suite's (2e-3)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.ops.pallas.cached_attention import (
    cached_attention as jax_cached_attention)
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.models.from_jax import cache_from_jax
from sparse_matrix_tuning_tpu_torch.ops.cuda import cached_attention as k7

B, HQ, HKV, HD, S = 2, 8, 4, 128, 256
TOL = 2e-3  # tests/test_cached_attention.py:85


def _inputs(seed, t, quant, dtype="fp32", b=B, hq=HQ, hkv=HKV, hd=HD, s=S):
    """q, the cache and a left-padded slot mask from one seed (the JAX
    suite's _mk), as numpy: (q, {"k","v"[,"ks","vs"]}, slot_mask)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    sm = np.zeros((b, s), np.int32)
    sm[0, 3:40] = 1   # left-padded example
    sm[1, 0:37] = 1
    if quant:
        ks = np.abs(k).max(-1) / 127.0 + 1e-10
        vs = np.abs(v).max(-1) / 127.0 + 1e-10
        kv = {"k": np.round(k / ks[..., None]).astype(np.int8),
              "v": np.round(v / vs[..., None]).astype(np.int8),
              "ks": ks[..., None, :].astype(np.float32), "vs": vs[..., None, :].astype(np.float32)}
    else:
        kv = {"k": k, "v": v}
    return q, kv, sm


def _both(q, kv, sm, dtype):
    """The inputs in each framework; float K/V in `dtype`, int8 as is."""
    def jx(a):
        return jnp.asarray(a) if a.dtype != np.float32 else tp.to_jax(a, dtype)

    def th(a):
        return torch.from_numpy(a) if a.dtype != np.float32 else tp.to_torch(a, dtype)

    jkv = {n: jx(a) for n, a in kv.items() if n in ("k", "v")}
    pkv = {n: th(a) for n, a in kv.items() if n in ("k", "v")}
    for n in ("ks", "vs"):
        if n in kv:
            jkv[n], pkv[n] = jnp.asarray(kv[n]), torch.from_numpy(kv[n])
    return (tp.to_jax(q, dtype), jkv, jnp.asarray(sm)), (tp.to_torch(q, dtype), pkv,
                                                         torch.from_numpy(sm))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["float-cache", "int8-cache"])
@pytest.mark.parametrize("t,ci", [(1, 39), (9, 20), (17, 0)])
def test_plain_matches_jax_kernel(quant, t, ci, dtype):
    (jq, jkv, jsm), (q, kv, sm) = _both(*_inputs(t + 10 * quant, t, quant), dtype)
    got = k7.cached_attention(q, kv, sm, ci)
    assert got.shape == q.shape and got.dtype == q.dtype
    want = np.asarray(jax_cached_attention(jq, jkv, jsm, ci, interpret=True), np.float32)
    # at ci 0 the first tokens of the left-padded row see no slot: zeros
    # here, the mean of V in JAX (test_rows_without_a_visible_slot_are_finite)
    seen = k7.visible_slots(sm, ci, t).any(-1).numpy()
    assert (got[~torch.from_numpy(seen)] == 0).all()
    np.testing.assert_allclose(tp.np32(got)[seen], want[seen], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["float-cache", "int8-cache"])
def test_rows_without_a_visible_slot_are_finite(quant):
    """A prefill over a left-padded prompt: the pad positions' query rows
    see no slot. They come out finite (zeros); every other row matches JAX."""
    t, ci = 12, 0
    q, kv, sm = _inputs(5, t, quant, s=128)
    sm[:] = 0
    sm[0, 4:t] = 1    # 4 pad positions
    sm[1, 7:t] = 1    # 7 pad positions
    (jq, jkv, jsm), (pq, pkv, psm) = _both(q, kv, sm, "fp32")
    got = k7.cached_attention(pq, pkv, psm, ci)
    assert torch.isfinite(got).all()
    want = np.asarray(jax_cached_attention(jq, jkv, jsm, ci, interpret=True))
    for b, first_real in ((0, 4), (1, 7)):
        assert (got[b, :first_real] == 0).all()
        np.testing.assert_allclose(tp.np32(got[b, first_real:]), want[b, first_real:],
                                   rtol=TOL, atol=TOL)


def test_wrapper_refuses_bad_input():
    q, kv, sm = _inputs(0, 1, False, hd=64, s=64)
    pq, pkv = torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in kv.items()}
    psm = torch.from_numpy(sm)
    with pytest.raises(ValueError, match="do not fit"):
        k7.cached_attention(pq, pkv, psm, 64)
    with pytest.raises(ValueError, match="scales"):
        k7.cached_attention(pq, {"k": pkv["k"].to(torch.int8), "v": pkv["v"].to(torch.int8)},
                            psm, 3)
    with pytest.raises(ValueError, match="head_dim"):
        k7.cached_attention(pq[..., :32], {n: x[..., :32] for n, x in pkv.items()}, psm, 3)
    assert k7.LAUNCHES == {"cached_attn": 0, "cached_attn_q8": 0}


# ---------------------------------------------------------------------------
# the KV-cache forward
# ---------------------------------------------------------------------------

# head_dim 128 and 128 slots: the JAX kernel's supported() shapes
JCFG = jllama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                          max_position_embeddings=512)
PCFG = llama.LlamaConfig(**JCFG.__dict__)
MAXLEN = 128


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, tp.port_params(jp)


def _prompts(seed=3, lens=(7, 11), width=12):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), width), np.int32)
    mask = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(3, 500, n)
        mask[i, width - n:] = 1
    return ids, mask


def _jax_prefill(jp, ids, mask, cache_dtype):
    cache = jllama.init_cache(JCFG, ids.shape[0], MAXLEN, dtype=jnp.dtype(cache_dtype))
    sm = np.zeros((ids.shape[0], MAXLEN), np.int32)
    sm[:, :ids.shape[1]] = mask
    positions = np.maximum(mask.cumsum(-1) - 1, 0)
    logits, cache = jllama.forward_with_cache(jp, jnp.asarray(ids), JCFG, cache, 0,
                                              jnp.asarray(sm), jnp.asarray(positions))
    return np.asarray(logits), cache, sm


def _port_prefill(pp, ids, mask, cache_dtype):
    cache = llama.init_cache(PCFG, ids.shape[0], MAXLEN, dtype=getattr(torch, cache_dtype))
    sm = torch.zeros((ids.shape[0], MAXLEN), dtype=torch.int32)
    sm[:, :ids.shape[1]] = torch.from_numpy(mask)
    positions = torch.from_numpy(np.maximum(mask.cumsum(-1) - 1, 0))
    logits, cache = llama.forward_with_cache(pp, torch.from_numpy(ids).long(), PCFG, cache, 0,
                                             sm, positions)
    return logits, cache


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "einsum"])
def test_prefill_logits_match_jax(weights, monkeypatch, kernel, cache_dtype):
    """Kernel leg: JAX through its Pallas kernel (_FORCE_CACHED_ATTN, interpret
    mode), the port through K7's plain version (SMT_CACHED_ATTN=on); einsum
    leg: both masked einsums. Compared at real positions; all finite."""
    jp, pp = weights
    ids, mask = _prompts()
    monkeypatch.setattr(jllama, "_FORCE_CACHED_ATTN", kernel)
    monkeypatch.setenv("SMT_CACHED_ATTN", "on" if kernel else "off")
    assert llama.use_cached_attn(PCFG, "cpu") is kernel
    assert jllama._use_cached_attn(JCFG, MAXLEN) is kernel
    want, _, _ = _jax_prefill(jp, ids, mask, cache_dtype)
    got, _ = _port_prefill(pp, ids, mask, cache_dtype)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    real = mask.astype(bool)
    np.testing.assert_allclose(tp.np32(got)[real], want[real], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_cache_layout_and_write_match_jax(weights, monkeypatch, cache_dtype):
    """init_cache's layout and dtypes, and the cache the prefill writes
    (int8 payloads and scales equal), against JAX's."""
    jp, pp = weights
    monkeypatch.setenv("SMT_CACHED_ATTN", "off")
    ids, mask = _prompts(seed=4)
    _, jcache, _ = _jax_prefill(jp, ids, mask, cache_dtype)
    _, cache = _port_prefill(pp, ids, mask, cache_dtype)
    want = cache_from_jax(tp.numpy_tree(jcache))
    assert set(cache) == set(want) == {"0", "1"}
    for li in cache:
        assert set(cache[li]) == set(want[li])
        for n, x in cache[li].items():
            assert x.shape == want[li][n].shape and x.dtype == want[li][n].dtype, (li, n)
            if x.dtype == torch.int8:
                # a rounding tie may fall either way after fp32 noise: one step
                assert (x.int() - want[li][n].int()).abs().max() <= 1, (li, n)
            else:
                tp.assert_close(x, want[li][n], 1e-5, 1e-5)
    assert cache["0"]["k"].shape == (2, 1, MAXLEN, 128)
    if cache_dtype == "int8":
        assert cache["0"]["ks"].shape == (2, 1, 1, MAXLEN)


def test_quant_kv_matches_jax():
    t = tp.seeded_normal((2, 3, 5, 64), seed=9, scale=3.0)
    t[0, 0, 0] = 0.0  # an all-zero row takes the 1e-10 floor
    vi, s = llama._quant_kv(torch.from_numpy(t))
    jvi, js = jllama._quant_kv(jnp.asarray(t))
    np.testing.assert_array_equal(vi.numpy(), np.asarray(jvi))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert vi.dtype == torch.int8 and s.shape == (2, 3, 1, 5)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_decode_step_from_a_jax_cache(weights, monkeypatch, cache_dtype):
    """Both packages start one decode step from the same (JAX-written)
    cache: the same logits, kernel leg on both sides."""
    jp, pp = weights
    monkeypatch.setattr(jllama, "_FORCE_CACHED_ATTN", True)
    monkeypatch.setenv("SMT_CACHED_ATTN", "on")
    ids, mask = _prompts(seed=6)
    _, jcache, sm = _jax_prefill(jp, ids, mask, cache_dtype)
    cache = cache_from_jax(tp.numpy_tree(jcache))
    slot = ids.shape[1]
    sm[:, slot] = 1
    token = np.array([[17], [301]], np.int32)
    positions = mask.sum(-1, keepdims=True)
    want, _ = jllama.forward_with_cache(jp, jnp.asarray(token), JCFG, jcache, slot,
                                        jnp.asarray(sm), jnp.asarray(positions))
    got, cache = llama.forward_with_cache(pp, torch.from_numpy(token).long(), PCFG, cache,
                                          slot, torch.from_numpy(sm),
                                          torch.from_numpy(positions))
    tp.assert_close(got, np.asarray(want), TOL, TOL)
    assert cache["0"]["k"][:, :, slot].abs().sum() > 0  # written in place


def test_cached_attn_policy(monkeypatch):
    monkeypatch.delenv("SMT_CACHED_ATTN", raising=False)
    assert llama.use_cached_attn(PCFG, "cuda") is True        # auto, hd 128
    assert llama.use_cached_attn(PCFG, "cpu") is False        # auto: einsum off the card
    odd = llama.LlamaConfig(**{**PCFG.__dict__, "hidden_size": 192, "num_attention_heads": 2})
    with pytest.warns(UserWarning, match="head_dim in .* not 96"):
        assert llama.use_cached_attn(odd, "cuda") is False    # hd 96: no kernel
    monkeypatch.setenv("SMT_CACHED_ATTN", "off")
    assert llama.use_cached_attn(PCFG, "cuda") is False
    monkeypatch.setenv("SMT_CACHED_ATTN", "on")
    assert llama.use_cached_attn(PCFG, "cpu") is True
    monkeypatch.setenv("SMT_CACHED_ATTN", "fast")
    with pytest.raises(ValueError, match="SMT_CACHED_ATTN"):
        llama.use_cached_attn(PCFG, "cpu")


def test_cached_attn_policy_warns_only_on_a_hidden_einsum(monkeypatch):
    """auto warns only where it runs the einsum on the card; the einsum off
    the card, or asked for with off, is silent."""
    odd = llama.LlamaConfig(**{**PCFG.__dict__, "hidden_size": 192, "num_attention_heads": 2})
    monkeypatch.delenv("SMT_CACHED_ATTN", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert llama.use_cached_attn(PCFG, "cuda") is True
        assert llama.use_cached_attn(odd, "cpu") is False
        monkeypatch.setenv("SMT_CACHED_ATTN", "off")
        assert llama.use_cached_attn(odd, "cuda") is False


def test_scan_decode_params_are_refused(weights):
    """The dense layer-stacked decode form is not ported (the quantized
    scan form, layers_q8, is: tests/test_torch_q4_decode.py)."""
    _, pp = weights
    with pytest.raises(NotImplementedError, match="layer-stacked form is not ported"):
        llama.forward_with_cache({**pp, "layers_stacked": {}},
                                 torch.zeros((1, 1), dtype=torch.long),
                                 PCFG, {}, 0, torch.ones((1, 4), dtype=torch.int32),
                                 torch.zeros((1, 1), dtype=torch.long))
