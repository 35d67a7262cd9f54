"""The tensor axis at a T that cuts the attention heads (`--mesh_shape
D,F,T` where T divides every leaf dim JAX splits over "tensor", not the
head counts): each rank's q/k/v rows are gathered over the tensor group
(parallel/tensor.gather_heads, whose backward sums the grads over the
group), RoPE and attention run on the whole kv groups that the rank's
o_proj columns meet (models/llama.cut_heads), and the rank keeps its
columns for the row-parallel o_proj.

Two tiny models at T = 4, both block-divisible:

  kv_cut  JaxLlamaConfig.tiny (hidden 256, 4 q / 2 kv heads of 64): a
          rank's q rows are one whole head, its k/v rows half a kv head
  q_cut   hidden 768, 6 q / 2 kv heads of 128, intermediate 1024, vocab
          256: 1.5 q heads and half a kv head a rank

Without a spawn, T tensor ranks as threads (tests/test_torch_tensor.py's
harness), one test for each place a cut head goes wrong: the rank plan of
cut_heads (a rank never reshapes to zero kv heads), RoPE on whole heads
after the gather, the gather's backward sum (gloo's all-reduce and NCCL's
reduce_scatter_tensor layout), whole kv groups for K3's plain twin (a
rank's q heads starting partway into a group), the dropout
mask cut to the kv heads computed (JAX's mask handed in as `keep`
against JAX's decoder layer), q/k/v biases added once. A decoder layer on
the ranks is held to one process's: the output and the grads of the
input, of every weight's slice and of the biases.

One spawn of four gloo ranks at (1, 1, 4) (tests/torch_dp_ranks.py, no
JAX) runs both models in matrix mode over the dense and the int8 base, in
channel mode and over the scan state (--scan_layers on): against JAX's
SMTTrainer on the same mesh (JAX runs its einsum attention there; losses
and eval loss within 1e-4, over the int8 base 1e-3, q_cut's after its first
sparse update within LATER_RTOL; the same plan, every leaf of a rank the
shape of JAX's shard for its device) and against the
port in one process at the tensor axis's bounds (tests/test_torch_
tensor_meshes.py's, none widened).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp
from test_torch_fsdp_scan import _jax_shards, _ranks, jax_mesh
from test_torch_parallel import (
    D1_RTOL_INT8, JAX_CFG, JAX_RTOL, MODEL, N, N_WARMUP, _cfg, batches)
from test_torch_tensor import _RANK, _on_threads
from test_torch_tensor_meshes import _assert_state_close_tp, _assert_within_adam, _step_bounds

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, cut_heads
from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh, refuse_tensor_model
from sparse_matrix_tuning_tpu_torch.parallel.tensor import gather_from_tensor, gather_heads

T = 4
SHAPE = (1, 1, T)
KV_CUT = dict(MODEL)
Q_CUT = dict(MODEL, hidden_size=768, intermediate_size=1024, num_attention_heads=6,
             num_key_value_heads=2)
MODELS = {"kv_cut": KV_CUT, "q_cut": Q_CUT}
# a rank's q heads begin partway into a query group and its columns meet
# two groups (6 q / 3 kv heads of 64 at T = 4: rank 1 holds q heads 1.5 .. 3)
GROUPS_CUT = dict(MODEL, hidden_size=384, intermediate_size=512, num_attention_heads=6,
                  num_key_value_heads=3)
# a rank's q heads meet two groups unevenly (12 q / 3 kv heads of 64 at T = 2:
# rank 0 holds q heads 0 .. 5, four of group 0 and two of group 1)
GROUPS_UNEVEN = dict(MODEL, hidden_size=768, intermediate_size=512, num_attention_heads=12,
                     num_key_value_heads=3)
# one head of 256, q and kv, over two ranks
ONE_HEAD = dict(MODEL, num_attention_heads=1, num_key_value_heads=1)
# fp32: a layer on the ranks against one process, the partial sums of the
# row-parallel o_proj / down_proj and of the gathered q/k/v's grads added
# in another order (measured worst 9.9e-7 of the largest entry)
LAYER_TOL = 1e-5


# ---------------------------------------------------------------------------
# the rank plan; the refusal narrowed to leaf dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,t,want", [
    ((12, 2, 128), 4, [(0, 1, 0), (0, 1, 384), (1, 1, 0), (1, 1, 384)]),   # Qwen2.5-1.5B
    ((12, 2, 128), 8, [(0, 1, 0), (0, 1, 192), (0, 1, 384), (0, 1, 576),
                       (1, 1, 0), (1, 1, 192), (1, 1, 384), (1, 1, 576)]),
    ((32, 4, 64), 8, [(g, 1, c) for g in range(4) for c in (0, 256)]),      # TinyLlama
    ((28, 4, 128), 8, [(0, 1, 0), (0, 1, 448), (1, 1, 0), (1, 1, 448),      # Qwen2.5-7B
                       (2, 1, 0), (2, 1, 448), (3, 1, 0), (3, 1, 448)]),
    ((4, 2, 64), 4, [(0, 1, 0), (0, 1, 64), (1, 1, 0), (1, 1, 64)]),        # kv_cut
    ((6, 2, 128), 4, [(0, 1, 0), (0, 1, 192), (1, 1, 0), (1, 1, 192)]),     # q_cut
    ((6, 3, 64), 4, [(0, 1, 0), (0, 2, 96), (1, 2, 64), (2, 1, 32)]),       # groups cut
    ((12, 2, 128), 2, [None, None]),                                        # T divides both
], ids=["qwen1.5b-4", "qwen1.5b-8", "tinyllama-8", "qwen7b-8", "kv_cut", "q_cut",
        "groups_cut", "divides"])
def test_cut_heads_plan(dims, t, want):
    """cut_heads: each rank's whole kv groups (first, count) and where its
    o_proj columns begin in them; never zero kv heads (hkv // T is 0 for
    Qwen2.5-1.5B at T = 4); the groups hold the rank's columns and no group
    more than they meet; None where T divides both head counts."""
    hq, hkv, hd = dims
    cfg = LlamaConfig(hidden_size=hq * hd, num_attention_heads=hq, num_key_value_heads=hkv)
    got = [cut_heads(cfg, Mesh((1, 1, t), r, torch.device("cpu"))) for r in range(t)]
    assert got == want
    n, width = hq * hd // t, hq // hkv * hd
    for r, c in enumerate(got):
        if c is None:
            continue
        first, count, col = c
        assert count >= 1 and 0 <= col and col + n <= count * width
        assert first * width + col == r * n                      # the rank's first column
        assert (first + count - 1) * width < r * n + n            # its last group is met


def test_refusal_names_leaf_dims_only():
    """refuse_tensor_model takes a T that cuts heads and refuses, by name,
    a leaf dim JAX would keep whole (k/v rows, intermediate width,
    vocabulary)."""
    ok = [LlamaConfig(**m) for m in (KV_CUT, Q_CUT, GROUPS_CUT)]
    ok.append(LlamaConfig(hidden_size=1536, intermediate_size=8960, vocab_size=151936,
                          num_attention_heads=12, num_key_value_heads=2))
    for cfg in ok:
        refuse_tensor_model(cfg, 4)
    refuse_tensor_model(ok[-1], 8)
    for change, name in ((dict(num_key_value_heads=1, hidden_size=24), "k_proj/v_proj rows 6"),
                         (dict(intermediate_size=514), "intermediate_size 514"),
                         (dict(vocab_size=32001), "vocab_size 32001")):
        with pytest.raises(NotImplementedError, match=name + ".*keeps a leaf dim"):
            refuse_tensor_model(LlamaConfig(**{**KV_CUT, **change}), 4)


# ---------------------------------------------------------------------------
# a decoder layer on T thread ranks against one process
# ---------------------------------------------------------------------------

COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")


def _layer_inputs(model, bias=False, rate=0.0, s=16):
    cfg = LlamaConfig(**{**model, "attention_dropout": rate})
    lp = dict(llama.init_params(dataclasses.replace(cfg, num_hidden_layers=1), seed=3)
              ["layers"]["0"])
    if bias:
        for i, m in enumerate(("q_proj", "k_proj", "v_proj")):
            lp[f"{m}_bias"] = torch.from_numpy(tp.seeded_normal((lp[m].shape[0],), 20 + i, 0.5))
    x = torch.from_numpy(tp.seeded_normal((2, s, cfg.hidden_size), 4))
    dy = torch.from_numpy(tp.seeded_normal((2, s, cfg.hidden_size), 5))
    positions = torch.arange(s)[None].repeat(2, 1)
    cos, sin = llama._rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool))
    mask_bias = torch.where(causal, 0.0, torch.finfo(torch.float32).min)[None, None].expand(
        2, 1, s, s).contiguous()
    return cfg, lp, x, dy, cos, sin, mask_bias


def _slice(lp, name, t, i):
    w = lp[name]
    if name in COL:
        return w.chunk(t, 0)[i]
    if name in ROW:
        return w.chunk(t, 1)[i]
    return w


def _run_layer(lp, x, dy, cos, sin, mask_bias, cfg, attn_impl, tensor=None, seed=None):
    """The layer's output and the grads of x and of every leaf of lp (the
    rank's slices under `tensor`)."""
    lp = {k: v.detach().clone().requires_grad_(True) for k, v in lp.items()}
    x = x.detach().clone().requires_grad_(True)
    y = llama._decoder_layer(lp, x, mask_bias, cos, sin, cfg, llama.default_linear, 0,
                             attn_impl, seed, None, tensor)
    y.backward(dy)
    return y.detach(), x.grad, {k: v.grad for k, v in lp.items()}


def _layer_on_ranks(model, t, monkeypatch, attn_impl="einsum", bias=False, rate=0.0, seed=None):
    cfg, lp, x, dy, cos, sin, mask_bias = _layer_inputs(model, bias, rate)
    one = _run_layer(lp, x, dy, cos, sin, mask_bias, cfg, attn_impl, seed=seed)

    def rank(mesh):
        mine = {k: _slice(lp, k, t, mesh.tensor_index) for k in lp}
        before = dict(mesh.stats)
        out = _run_layer(mine, x, dy, cos, sin, mask_bias, cfg, attn_impl, mesh, seed)
        return out, {k: mesh.stats[k] - before[k] for k in ("heads_bytes", "heads_calls")}

    return one, _on_threads(t, monkeypatch, rank), lp


def _assert_layer_matches(one, got, t, tol=LAYER_TOL):
    """Every rank's output and input grad against one process's, each
    weight's grad its slice of one process's, the biases' grads (nonzero
    on the rank's rows only) summing to one process's."""
    y, gx, gw = one
    scale = lambda a: tol * float(a.abs().max())   # noqa: E731
    for r, ((yr, gxr, gwr), _) in enumerate(got):
        torch.testing.assert_close(yr, y, rtol=tol, atol=scale(y))
        torch.testing.assert_close(gxr, gx, rtol=tol, atol=scale(gx))
        for k, g in gw.items():
            if k.endswith("_bias"):
                continue
            want = _slice(gw, k, t, r)
            torch.testing.assert_close(gwr[k], want, rtol=tol, atol=scale(g), msg=f"{r} {k}")
    for k in (k for k in gw if k.endswith("_bias")):
        total = sum(g[k] for (_, _, g), _ in got)
        torch.testing.assert_close(total, gw[k], rtol=tol, atol=scale(gw[k]), msg=k)


@pytest.mark.parametrize("name,t", [("kv_cut", T), ("q_cut", T), ("one_head", 2)])
def test_rope_runs_on_whole_heads(name, t, monkeypatch):
    """RoPE pairs dim i with dim i + hd/2 of one head, so a rank's k rows
    (half a kv head at T = 4; half the one head at T = 2) rotated alone are
    not its slice of the rotated head: the layer rotates after the gather,
    and on the ranks equals one process."""
    model = {"kv_cut": KV_CUT, "q_cut": Q_CUT, "one_head": ONE_HEAD}[name]
    cfg, lp, x, _, cos, sin, _ = _layer_inputs(model)
    k = llama.default_linear(x, lp["k_proj"], "k_proj", 0)
    hd = cfg.head_dim
    whole = llama._apply_rope(k.reshape(2, -1, cfg.num_key_value_heads, hd), cos, sin)
    n = k.shape[-1] // t
    half = k[..., :n].reshape(2, -1, 1, n)
    alone = llama._apply_rope(half, cos[..., :n], sin[..., :n])
    assert not torch.allclose(alone.reshape(2, -1, n), whole.reshape(2, -1, k.shape[-1])[..., :n],
                              atol=1e-3)
    one, got, _ = _layer_on_ranks(model, t, monkeypatch)
    _assert_layer_matches(one, got, t)


class _NcclOnThreads:
    """torch.distributed as the port's parallel modules see it over NCCL:
    get_backend "nccl", all_gather_into_tensor and reduce_scatter_tensor
    built from the thread harness's all_reduce (looked up at each call),
    the rest torch.distributed's."""

    def __getattr__(self, name):
        return getattr(torch.distributed, name)

    @staticmethod
    def get_backend(group=None):
        return "nccl"

    @staticmethod
    def _index(group):
        return (group or tuple(range(T))).index(_RANK.r)

    def all_gather_into_tensor(self, out, inp, group=None):
        buf = torch.zeros(out.numel(), dtype=inp.dtype)
        n, i = inp.numel(), self._index(group)
        buf[i * n:(i + 1) * n] = inp.reshape(-1)
        torch.distributed.all_reduce(buf, group=group)
        out.copy_(buf.view_as(out))

    def reduce_scatter_tensor(self, out, inp, group=None):
        buf = inp.contiguous().clone()
        torch.distributed.all_reduce(buf, group=group)
        out.copy_(buf.view(-1, out.numel())[self._index(group)].view_as(out))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_gather_heads_backward_sums_over_the_group(backend, monkeypatch):
    """gather_heads forward is the ranks' rows in tensor order; backward each
    rank gets its rows of the SUM of the ranks' grads (each rank's
    attention feeds its own o_proj columns), where gather_from_tensor's
    backward keeps its own grad's rows (right only for a grad equal on
    every rank); counted in heads_* (and tensor_*), a call each way. Over
    gloo the sum is an all-reduce of the whole, over NCCL a
    reduce_scatter_tensor of the rows laid out rank-major (its layout held
    here through thread collectives, _NcclOnThreads)."""
    from sparse_matrix_tuning_tpu_torch.parallel import mesh as mesh_mod, tensor as tensor_mod
    if backend == "nccl":
        for mod in (mesh_mod, tensor_mod):
            monkeypatch.setattr(mod, "dist", _NcclOnThreads())
    rows = [torch.from_numpy(tp.seeded_normal((2, 3, 8), 30 + r)) for r in range(T)]
    grads = [torch.from_numpy(tp.seeded_normal((2, 3, 8 * T), 40 + r)) for r in range(T)]

    def rank(mesh):
        i = mesh.tensor_index
        out = {}
        for name, fn in (("heads", gather_heads), ("embed", gather_from_tensor)):
            x = rows[i].clone().requires_grad_(True)
            full = fn(x, mesh)
            full.backward(grads[i])
            out[name] = (full.detach(), x.grad)
        return out, dict(mesh.stats)

    got = _on_threads(T, monkeypatch, rank)
    whole = torch.cat(rows, dim=-1)
    summed = torch.stack(grads).sum(0)
    for i, (out, stats) in enumerate(got):
        assert torch.equal(out["heads"][0], whole) and torch.equal(out["embed"][0], whole)
        torch.testing.assert_close(out["heads"][1], summed[..., 8 * i:8 * (i + 1)],
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(out["embed"][1], grads[i][..., 8 * i:8 * (i + 1)])
        assert not torch.allclose(out["embed"][1], out["heads"][1])
        nbytes = whole.numel() * 4
        assert (stats["heads_calls"], stats["heads_bytes"]) == (2, 2 * nbytes)
        assert stats["tensor_calls"] == 3   # the two gathers and gather_heads' sum


@pytest.mark.parametrize("name,t", [("q_cut", T), ("groups_cut", T), ("groups_uneven", 2)])
def test_whole_kv_groups_for_k3_plain(name, t, monkeypatch):
    """Under attn_impl "fullk" (K3's plain twin on the CPU) a rank runs its
    whole kv groups with all their q heads, and cuts its columns after. K3
    maps q head i to kv head i // (Hq / Hkv) of what it is given: q heads
    beginning partway into a group over their groups' kv heads (q heads
    2 .. 5 of q_cut's groups of 3) are mapped to the wrong kv heads. The
    layer on the ranks equals one process's (groups_cut: rank 1's columns
    begin in q head 1 of group 0 and reach group 1; groups_uneven: rank
    0's q heads are four of group 0 and two of group 1)."""
    from sparse_matrix_tuning_tpu_torch.ops.attention import fullk_attention
    cfg, lp, x, _, cos, sin, _ = _layer_inputs(Q_CUT)
    hd = cfg.head_dim
    qkv = [llama.default_linear(x, lp[m], m, 0).reshape(2, 16, -1, hd)
           for m in ("q_proj", "k_proj", "v_proj")]
    q, k = (llama._apply_rope(a, cos, sin) for a in qkv[:2])
    whole = fullk_attention(q, k, qkv[2], hd ** -0.5)
    alone = fullk_attention(q[:, :, 2:6].contiguous(), k, qkv[2], hd ** -0.5)
    torch.testing.assert_close(alone[:, :, 2:], whole[:, :, 4:6])   # q heads 4, 5: kv head 1
    assert not torch.allclose(alone[:, :, 1], whole[:, :, 3], atol=1e-3)   # q head 3 read kv 0
    model = {"q_cut": Q_CUT, "groups_cut": GROUPS_CUT, "groups_uneven": GROUPS_UNEVEN}[name]
    one, got, _ = _layer_on_ranks(model, t, monkeypatch, attn_impl="fullk")
    _assert_layer_matches(one, got, t)


def _jax_keep(cfg, rng, b=2, s=16):
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    return torch.from_numpy(np.asarray(
        jax.random.bernoulli(rng, 1.0 - cfg.attention_dropout, (b, hkv, hq // hkv, s, s))).copy())


@pytest.mark.parametrize("name", ["kv_cut", "q_cut", "groups_cut"])
def test_dropout_mask_is_cut_to_the_kv_heads_computed(name, monkeypatch):
    """Under --dropout each rank's mask is its computed kv heads' slice of
    the whole mask, heads = (first, hkv) (not hkv // T heads at rank * hkv //
    T): drawn from the layer's seed, every rank's masks equal those slices
    of one process's; handed JAX's own mask (`keep`, cut by the same
    heads), the ranks' layer equals JAX's decoder layer with the key that
    drew it."""
    model = {"kv_cut": KV_CUT, "q_cut": Q_CUT, "groups_cut": GROUPS_CUT}[name]
    rate = 0.1
    cfg, lp, x, dy, cos, sin, mask_bias = _layer_inputs(model, rate=rate)
    original = llama._attn_dropout
    drawn = {}

    def recorded(probs, rate, rng=None, keep=None, rows=None, heads=None):
        again = torch.Generator()
        again.set_state(rng.get_state())
        mask = original(torch.ones_like(probs), rate, again, None, rows, heads) != 0
        drawn.setdefault(getattr(_RANK, "r", -1), []).append((heads, mask))
        return original(probs, rate, rng, keep, rows, heads)

    monkeypatch.setattr(llama, "_attn_dropout", recorded)
    one, got, _ = _layer_on_ranks(model, T, monkeypatch, rate=rate, seed=11)
    _assert_layer_matches(one, got, T)
    whole = drawn.pop(-1)[0][1]
    assert 0.85 < float(whole.float().mean()) < 0.95
    for r in range(T):
        first, count, _ = cut_heads(cfg, Mesh(SHAPE, r, torch.device("cpu")))
        (heads, mine), = drawn[r]
        assert heads == (first, cfg.num_key_value_heads)
        assert torch.equal(mine, whole[:, first:first + count])

    rng = jax.random.PRNGKey(5)
    keep = _jax_keep(cfg, rng)

    def handed(probs, rate, rng=None, keep_=None, rows=None, heads=None):
        cut = keep if heads is None else keep[:, heads[0]:heads[0] + probs.shape[1]]
        return original(probs, rate, None, cut, rows, None)

    monkeypatch.setattr(llama, "_attn_dropout", handed)
    _, got, _ = _layer_on_ranks(model, T, monkeypatch, rate=rate, seed=0)
    jlp = {k: jnp.asarray(v.numpy()) for k, v in lp.items()}
    jcfg = jllama.LlamaConfig(**{**model, "attention_dropout": rate})
    want = jllama._decoder_layer(jlp, jnp.asarray(x.numpy()), jnp.asarray(mask_bias.numpy()),
                                 jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), jcfg,
                                 jllama.default_linear, 0, "einsum", dropout_rng=rng)
    for (y, _, _), _ in got:
        tp.assert_close(y, want, rtol=LAYER_TOL, atol=LAYER_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["kv_cut", "q_cut"])
def test_biases_are_added_once(name, monkeypatch):
    """q/k/v biases are added to each rank's rows before the gather (_lin),
    once: the layer on the ranks equals one process's, and the ranks' bias
    grads (each nonzero on its rows only) sum to one process's."""
    model = {"kv_cut": KV_CUT, "q_cut": Q_CUT}[name]
    one, got, lp = _layer_on_ranks(model, T, monkeypatch, bias=True)
    _assert_layer_matches(one, got, T)
    n = lp["k_proj_bias"].shape[0] // T
    for r, ((_, _, g), stats) in enumerate(got):
        grad = g["k_proj_bias"]
        assert torch.count_nonzero(grad[:r * n]) == 0 and torch.count_nonzero(grad[r * n + n:]) == 0
        assert stats["heads_calls"] == 2   # one gather of [q | k | v], one sum of its grads


# ---------------------------------------------------------------------------
# the trainer: four gloo ranks at (1, 1, 4) against JAX's mesh and one process
# ---------------------------------------------------------------------------

CONFIGS = {"matrix": _cfg(), "int8": _cfg(frozen_quant="int8"), "channel": _cfg("channel"),
           "scan": _cfg(scan_layers="on")}
CASES = [(m, c) for m in MODELS for c in CONFIGS]
# The int8 bound (1e-3) was measured at hidden 256. At q_cut's 768 the int8
# base parts its references after the first sparse update whatever the
# layout (a flipped int8 rounding moves the next update): on this input,
# with the heads whole, JAX's own (1, 1, 2) and (1, 1, 4) meshes read up to
# 2.6e-3 from JAX on one device in the later losses and 2.2e-3 in the eval
# loss, the port at (1, 1, 2) 3.2e-3 from one process, the port in one
# process 2.8e-3 from JAX on one device in the eval loss; the cut heads at
# T = 4 read 1.6e-3 from JAX's mesh (eval 3.0e-3) and 1.5e-3 from one
# process (eval 1.6e-3). Their losses through the first sparse step are held
# to the int8 bound; the later losses and the eval loss to LATER_RTOL, above
# those readings and below a gather whose backward does not sum (0.2 in the
# later losses, 1.7e-2 in the eval loss); the grad norms to the tensor
# axis's int8 bounds (_step_bounds; the cut heads 1.6e-2, a straddling
# k/v block's parts left unsummed 0.40 from the first sparse step on).
LATER_RTOL = {("q_cut", "int8"): 5e-3}


def _id(case):
    return "-".join(case)


def _jax_cfg(model):
    return dataclasses.replace(JAX_CFG, **model)


def _jax_run(spec, model, bs, eval_path):
    """JAX's SMTTrainer on its (1, 1, 4) mesh: losses, plan, eval loss, the
    shard shapes of its warm-up state as placed ({path: {device index:
    shape}}) and of its final state (and host store) as state_shardings
    place them."""
    from test_torch_tensor_meshes import _shard_shapes
    jcfg = _jax_cfg(model)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)  # a fresh copy: donated
    with jax_mesh(SHAPE) as mesh:
        jt = JaxSMTTrainer(JaxSMTConfig(**spec["cfg"]), jcfg, jparams,
                           total_steps=spec["total_steps"], mesh=mesh)
        warm = _shard_shapes(jt.state, mesh, None, placed=True)
        losses = [float(jt.train_step(b)["loss"]) for b in bs]
        final = _jax_shards(jt, mesh) if jt._scan else {
            k: v[0] for k, v in _shard_shapes(jt.state, mesh, jt.plan.mode, placed=False).items()}
        return {"loss": losses, "fingerprint": jt.plan.fingerprint(), "scan": jt._scan,
                "eval_loss": jt.evaluate(torch.load(eval_path, weights_only=False))[1],
                "shards": final, "warm_shards": warm}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one spawn of four ranks at (1, 1, 4), in one process,
    and on JAX's (1, 1, 4) mesh."""
    tmp = tmp_path_factory.mktemp("cut_heads")
    torch.save(batches(2, pads=(32, 20, 12, 6), seed=9), tmp / "eval.pt")
    bs = batches(N)
    torch.save(bs, tmp / "batches.pt")
    specs = []
    for m, model in MODELS.items():
        params = tp.port_params(jax_init_params(jax.random.PRNGKey(0), _jax_cfg(model)))
        torch.save(params, tmp / f"{m}.pt")
        specs += [{"name": _id((m, c)), "cfg": dict(cfg), "model": model, "total_steps": N,
                   "params": str(tmp / f"{m}.pt"), "batches": str(tmp / "batches.pt"),
                   "eval_batches": str(tmp / "eval.pt"), "export": True}
                  for c, cfg in CONFIGS.items()]
    ranks.spawn(ranks.train_ranks, T, tmp, specs, str(tmp), SHAPE)
    out = {}
    for spec, case in zip(specs, CASES):
        got = [torch.load(tmp / f"{spec['name']}.{r}.pt", weights_only=False) for r in range(T)]
        out[case] = {"ranks": got, "d1": ranks.run_scenario(spec),
                     "jax": _jax_run(spec, MODELS[case[0]], bs, tmp / "eval.pt")}
    return out


def _losses(run):
    return [m["loss"] for m in run["metrics"]]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cut_heads_ranks_match_jax_mesh(runs, case):
    """Losses within 1e-4 every step and the eval loss (over the int8 base
    1e-3), the same plan fingerprint, against JAX's SMTTrainer on the same
    (1, 1, 4) mesh, in the same layout (q_cut over the int8 base: the losses
    after the first sparse step and the eval loss within LATER_RTOL)."""
    r0, want = _ranks(runs, case)[0], runs[case]["jax"]
    rtol = D1_RTOL_INT8 if case[1] == "int8" else JAX_RTOL
    later = LATER_RTOL.get(case, rtol)
    assert r0["phase"] == "sparse" and r0["scan"] == want["scan"] == (case[1] == "scan")
    assert r0["fingerprint"] == want["fingerprint"]
    first = slice(0, N_WARMUP + 1)
    np.testing.assert_allclose(_losses(r0)[first], want["loss"][first], rtol=rtol, atol=0)
    np.testing.assert_allclose(_losses(r0)[N_WARMUP + 1:], want["loss"][N_WARMUP + 1:],
                               rtol=later, atol=0)
    np.testing.assert_allclose(r0["eval_loss"], want["eval_loss"], rtol=later)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cut_heads_rank_holds_jax_shard_of_its_device(runs, case):
    """Each rank's warm-up leaves have the shapes of JAX's shards for its
    device as JAX's trainer placed them, and its sparse-phase leaves
    (layer weights or stacks, q / q_head, trainables, base and moments,
    the scan state's host store) those of their state_shardings placement:
    q's rows a rank at 1.5 heads, k/v's at half a kv head."""
    jax_run = runs[case]["jax"]
    want, warm = jax_run["shards"], jax_run["warm_shards"]
    scan = case[1] == "scan"
    tops = ("params/", "q/", "q_head/", "trainable/", "base/", "m/", "v/") + (
        ("host/",) if scan else ())
    for r, g in enumerate(_ranks(runs, case)):
        common = set(g["shapes"][0]) & set(warm)
        assert scan or {k for k in g["shapes"][0] if k.startswith(("master/", "act_acc/"))} \
            <= common, sorted(set(g["shapes"][0]) - common)
        for k in common:
            assert g["shapes"][0][k] == warm[k][r], (r, k, g["shapes"][0][k], warm[k][r])
        mine = {**g["shapes"][1], **(g["host_shapes"] if scan else {})}
        keys = {k for k in mine if k.startswith(tops)}
        assert keys and keys <= set(want), sorted(keys - set(want))
        for k in keys:
            assert mine[k] == want[k], (r, k, mine[k], want[k])
        kv = "k_proj" if not scan else "layers_stacked/k_proj"
        assert any(kv in k for k in g["tdims"]) or case[1] == "int8"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cut_heads_ranks_match_one_process(runs, case):
    """Losses and grad norms (tests/test_torch_tensor_meshes.py's
    _step_bounds), the eval loss, the gathered final state and the export
    (the tensor axis's state rule; over the int8 base every entry within
    Adam's bound) against the port in one process, the same fingerprint
    (q_cut over the int8 base: the losses after the first sparse step and
    the eval loss within LATER_RTOL);
    every rank reports and exports the same; the leaves whole over tensor
    are bit-equal across the group."""
    got, one = _ranks(runs, case), runs[case]["d1"]
    r0 = got[0]
    int8 = case[1] == "int8"
    assert r0["fingerprint"] == one["fingerprint"] and r0["phase"] == one["phase"] == "sparse"
    for r in got[1:]:
        np.testing.assert_equal(r["metrics"], r0["metrics"])
        assert r["eval_loss"] == r0["eval_loss"]
    norms = [(a.get("grad_norm", 0.0), b.get("grad_norm", 0.0))
             for a, b in zip(r0["metrics"], one["metrics"])]
    bounds = _step_bounds(False, int8)
    if case in LATER_RTOL:
        bounds[-1] = (bounds[-1][0], LATER_RTOL[case], bounds[-1][2])
    for sl, rtol, norm_rtol in bounds:
        np.testing.assert_allclose(_losses(r0)[sl], _losses(one)[sl], rtol=rtol, atol=0)
        np.testing.assert_allclose(*zip(*norms[sl]), rtol=norm_rtol)
    np.testing.assert_allclose(r0["eval_loss"], one["eval_loss"],
                               rtol=LATER_RTOL.get(case, D1_RTOL_INT8 if int8 else JAX_RTOL))
    cfg = CONFIGS[case[1]]
    adam_bound = 2 * (cfg["ft_learning_rate"] * cfg["full_ft_steps"]
                      + cfg["smt_lr"] * (N - cfg["full_ft_steps"]))
    rule = _assert_within_adam if int8 else _assert_state_close_tp
    for what in ("full", "export"):
        assert set(r0[what]) == set(one[what]), what
        for k, v in one[what].items():
            for r in got:
                assert torch.equal(r[what][k], r0[what][k]), (what, k)
            # one process over the int8 base leaves its dense weights for
            # the host, a 1-element placeholder: the export stands for them
            if int8 and v.numel() == 1 < r0[what][k].numel():
                continue
            assert v.shape == r0[what][k].shape, (what, k)
            rule(f"{what}/{k}", r0[what][k], v, adam_bound)
    for r, g in enumerate(got):
        peer = got[(r + 1) % T]
        split = set(g["tdims"])
        assert split and split == set(peer["tdims"])
        for k, sums in g["checksums"].items():
            if k not in split:
                assert sums == peer["checksums"][k], (r, k)
