"""The fsdp axis (`--mesh_shape D,F,1`, parallel/fsdp.py): gloo ranks on the
CPU, spawned once per mesh shape by torch.multiprocessing
(tests/torch_dp_ranks.py, which imports no JAX), against the JAX
SMTTrainer on the same mesh over conftest's virtual CPU devices and
against the port in one process at the same global batch. Tiny Llama,
fp32 unless said, inputs from numpy seeds (tests/test_torch_parallel.py's
scenarios and bounds).

  (1, 2, 1)  matrix, accum, channel, fp16, matrix_int8, dropout (F8: each
             rank keeps its rows of the global microbatch's mask; torch's
             masks are not JAX's, so against one process only)
  (2, 2, 1)  matrix, accum (8 rows a batch), clip (F2/F3: grad_clip 0.05
             binds at every step, so a norm that counted a whole leaf's
             squares F times, or a grad summed over the world instead of
             the data group, moves every update)
  (1, 4, 1)  matrix (hidden 256 over 4 shards: 64 columns, every 256-block
             straddles four shards, F5)

Each rank holds exactly 1/F of every leaf that shard_dim splits (F4), and
one layer's gathered weights at a time. The pure functions (shard_dim
against JAX's state_shardings, the partial block statistics, the scatter
into shards, rank order, the sharded HF load) are held without a spawn.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp
from test_torch_parallel import (
    D1_RTOL, D1_RTOL_INT8, FP16_RTOL, JAX_CFG, JAX_RTOL, MODEL, N, _cfg, batches)

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparse_matrix_tuning_tpu.parallel.mesh import set_compute_mesh
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer

# mesh -> {name: (config kwargs, batches kwargs, bound against JAX or None)}
MESHES = {
    (1, 2, 1): {
        "matrix": (_cfg(), {}, JAX_RTOL),
        "accum": (_cfg(per_device_ft_batch_size=1, gradient_accumulation_steps=2),
                  dict(pads=(32, 8, 20, 32)), JAX_RTOL),
        "channel": (_cfg("channel"), {}, JAX_RTOL),
        "fp16": (_cfg(dtype="fp16"), dict(masked_rows=(0, 1)), FP16_RTOL),
        "matrix_int8": (_cfg(frozen_quant="int8"), {}, D1_RTOL_INT8),
        "dropout": (_cfg(dropout=0.1), {}, None),
    },
    (2, 2, 1): {
        "matrix": (_cfg(per_device_ft_batch_size=1), {}, JAX_RTOL),
        "accum": (_cfg(per_device_ft_batch_size=1, gradient_accumulation_steps=2),
                  dict(pads=(32, 8, 20, 32, 12, 32, 4, 26)), JAX_RTOL),
        "clip": (_cfg(per_device_ft_batch_size=1, grad_clip=0.05), {}, JAX_RTOL),
    },
    (1, 4, 1): {
        "matrix": (_cfg(per_device_ft_batch_size=1), {}, JAX_RTOL),
    },
}
CASES = [(shape, name) for shape, sc in MESHES.items() for name in sc]
JAX_CASES = [c for c in CASES if MESHES[c[0]][c[1]][2] is not None]


def _id(case):
    return f"{''.join(map(str, case[0]))}-{case[1]}"


def _jax_run(spec, shape, bs, eval_path):
    jparams = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)  # a fresh copy: donated
    n = int(np.prod(shape))
    try:
        jt = JaxSMTTrainer(JaxSMTConfig(**spec["cfg"]), JAX_CFG, jparams,
                           total_steps=spec["total_steps"],
                           mesh=jax_make_mesh(shape, jax.devices()[:n]))
        metrics = [jt.train_step(b) for b in bs]
        return {"loss": [float(m["loss"]) for m in metrics],
                "flags": [(float(m.get("loss_scale", -1.0)), bool(m.get("overflow", False)))
                          for m in metrics],
                "fingerprint": jt.plan.fingerprint(),
                "eval_loss": jt.evaluate(torch.load(eval_path, weights_only=False))[1]}
    finally:  # the JAX trainer leaves its compute mesh set (trainer.py:68)
        set_compute_mesh(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its mesh (one spawn per mesh), in one process, and on
    JAX's mesh."""
    tmp = tmp_path_factory.mktemp("fsdp")
    params = tp.port_params(jax_init_params(jax.random.PRNGKey(0), JAX_CFG))
    torch.save(params, tmp / "params.pt")
    torch.save(batches(2, pads=(32, 20, 12, 6), seed=9), tmp / "eval.pt")
    out = {}
    for shape, scenarios in MESHES.items():
        specs, bs_of = [], {}
        tag = "".join(map(str, shape))
        for name, (cfg, bkw, _) in scenarios.items():
            bs_of[name] = batches(N, **bkw)
            torch.save(bs_of[name], tmp / f"{tag}_{name}.pt")
            model = {**MODEL, "attention_dropout": cfg.get("dropout", 0.0)}
            specs.append({"name": f"{tag}_{name}", "cfg": dict(cfg), "model": model,
                          "total_steps": N, "params": str(tmp / "params.pt"),
                          "batches": str(tmp / f"{tag}_{name}.pt"),
                          "eval_batches": str(tmp / "eval.pt")})
        world = int(np.prod(shape))
        ranks.spawn(ranks.train_ranks, world, tmp, specs, str(tmp), shape)
        for spec, name in zip(specs, scenarios):
            got = [torch.load(tmp / f"{spec['name']}.{r}.pt", weights_only=False)
                   for r in range(world)]
            out[(shape, name)] = {"ranks": got, "d1": ranks.run_scenario(spec), "jax": (
                _jax_run(spec, shape, bs_of[name], tmp / "eval.pt")
                if (shape, name) in JAX_CASES else None)}
    return out


def _ranks(runs, case):
    for r, got in enumerate(runs[case]["ranks"]):
        assert "error" not in got, f"rank {r}: {got['error']}"
    return runs[case]["ranks"]


def _losses(run):
    return [m["loss"] for m in run["metrics"]]


def _flags(run):
    return [(m.get("loss_scale", -1.0), bool(m.get("overflow", 0.0))) for m in run["metrics"]]


@pytest.mark.parametrize("case", JAX_CASES, ids=_id)
def test_fsdp_ranks_match_jax_mesh(runs, case):
    r0, want = _ranks(runs, case)[0], runs[case]["jax"]
    rtol = MESHES[case[0]][case[1]][2]
    assert r0["fingerprint"] == want["fingerprint"]
    assert _flags(r0) == want["flags"]
    if case[1] == "fp16":
        np.testing.assert_allclose(_losses(r0)[:2], want["loss"][:2], rtol=rtol[0], atol=0)
        np.testing.assert_allclose(_losses(r0)[2:], want["loss"][2:], rtol=rtol[1], atol=0)
        return
    np.testing.assert_allclose(_losses(r0), want["loss"], rtol=rtol, atol=0)
    np.testing.assert_allclose(r0["eval_loss"], want["eval_loss"], rtol=rtol)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_fsdp_ranks_match_one_process(runs, case):
    """Losses, grad norms and the whole final state (gathered; over a
    dense base), eval loss against the port in one process; every rank
    reports the same."""
    got, one = _ranks(runs, case), runs[case]["d1"]
    r0 = got[0]
    rtol = D1_RTOL_INT8 if r0["int8"] else D1_RTOL
    assert r0["fingerprint"] == one["fingerprint"] and r0["phase"] == "sparse"
    assert _flags(r0) == _flags(one)
    for r in got[1:]:
        np.testing.assert_equal(r["metrics"], r0["metrics"])
        assert r["eval_loss"] == r0["eval_loss"] and r["fingerprint"] == r0["fingerprint"]
    np.testing.assert_allclose(_losses(r0), _losses(one), rtol=rtol, atol=0)
    if not r0["int8"]:  # over the int8 base an int8 rounding flips: the norms drift ~1e-3
        np.testing.assert_allclose([m.get("grad_norm", 0.0) for m in r0["metrics"]],
                                   [m.get("grad_norm", 0.0) for m in one["metrics"]], rtol=rtol)
    np.testing.assert_allclose(r0["eval_loss"], one["eval_loss"], rtol=rtol)
    assert set(r0["full"]) == set(one["full"])
    cfg = MESHES[case[0]][case[1]][0]
    adam_bound = 2 * (cfg["ft_learning_rate"] * cfg["full_ft_steps"]
                      + cfg["smt_lr"] * (N - cfg["full_ft_steps"]))
    for k, v in one["full"].items():
        for r in got:
            assert torch.equal(r["full"][k], r0["full"][k]), k
        # over the int8 base the flipped roundings move the grads of most
        # entries (losses within 1e-3): the state is held across the ranks only
        if not r0["int8"]:
            assert_state_close(k, r0["full"][k], v, adam_bound)


# the whole final state against one process: within 1e-4, but for at most
# 0.1% of a leaf's elements, whose grads sit near 0 where Adam's
# m / (sqrt(v) + eps) turns a last-bit difference into any update within
# +-lr: those stay within 2 lr a step (measured: 1 element of 65,536 in
# 121-matrix's q_proj, 5.6e-4 off)
STATE_TOL, STATE_OFF_SHARE = 1e-4, 1e-3


def assert_state_close(what, got, want, adam_bound):
    a, b = tp.np32(got), tp.np32(want)
    off = ~np.isclose(a, b, rtol=STATE_TOL, atol=STATE_TOL)
    assert off.mean() <= STATE_OFF_SHARE, (what, int(off.sum()), a.size)
    assert np.all(np.abs(a - b)[off] <= adam_bound), what


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_each_rank_holds_its_share(runs, case):
    """F4: every leaf shard_dim splits holds exactly 1/F of its full bytes
    on every rank, after the warm-up's build and at the end; the rest are
    whole; at most one layer's gathered weights were alive at a time."""
    shape = case[0]
    for r, got in enumerate(_ranks(runs, case)):
        for phase, table in zip(("warm-up", "sparse"), got["shard_bytes"]):
            split = {k: v for k, v in table.items() if v[0] is not None}
            assert split, phase
            for k, (d, here, full) in table.items():
                assert here * (shape[1] if d is not None else 1) == full, (r, phase, k)
            if phase == "warm-up":
                assert {k.split("/")[0] for k in split} >= {"master", "m", "v"}
            else:
                assert {k.split("/")[0] for k in split} >= {"params", "trainable", "m", "v"}
        assert got["live_peak"] == 1, got["live_peak"]


def test_fp16_overflow_of_one_fsdp_rank_skips_both(runs):
    """F7: rank 0's rows hold no valid token; a step overflows through
    rank 1's rows only, and both ranks skip it with the same scale."""
    r0, r1 = _ranks(runs, ((1, 2, 1), "fp16"))
    flags = _flags(r0)
    assert any(f[1] for f in flags) and not all(f[1] for f in flags), flags
    assert flags == _flags(r1)


def test_clip_binds_and_counts_whole_leaves_once(runs):
    """F2 / F3 at (2, 2, 1): the clip binds at every step (the grad norm
    above grad_clip), and the norms and losses equal one process's (the
    test above); here that the binding is real."""
    r0 = _ranks(runs, ((2, 2, 1), "clip"))[0]
    assert all(m["grad_norm"] > 0.05 * 2 for m in r0["metrics"])


# ---------------------------------------------------------------------------
# no spawn: shard_dim against JAX, rank order, block statistics, the scatter
# ---------------------------------------------------------------------------

def _state_of_shapes(mode, n_layers=1, d=256, f=512, v=256, acc_blocks=False):
    """A state of numpy zeros with the port's (and JAX's) leaf paths and
    full shapes: the warm-up's master / m / v / acc and the sparse phase's
    params / trainable / m / v / q / q_head."""
    z = np.zeros
    layer = {"input_layernorm": z(d), "post_attention_layernorm": z(d),
             "q_proj": z((d, d)), "k_proj": z((d // 2, d)), "v_proj": z((d // 2, d)),
             "o_proj": z((d, d)), "gate_proj": z((f, d)), "up_proj": z((f, d)),
             "down_proj": z((d, f))}
    tree = {"embed_tokens": z((v, d)), "norm": z(d), "lm_head": z((v, d)),
            "layers": {str(i): dict(layer) for i in range(n_layers)}}
    mods = ("q_proj", "gate_proj", "down_proj")
    acc = {f"0.{m}": z(tuple(s // 256 for s in layer[m].shape) if acc_blocks else
                       layer[m].shape) for m in mods}
    trainable = {f"0.{m}": z((3, 256, 256)) if mode == "matrix" else z((layer[m].shape[0], 5))
                 for m in mods}
    q = {f"0.{m}": {"wq": z(layer[m].shape), "sw": z(layer[m].shape[0]),
                    "base": z((3, 256, 256))} for m in ("q_proj", "o_proj", "down_proj")}
    # act_acc: grad_sum's (S, C) sums and per_step_stats' (C,) stats
    warm = {"master": tree, "m": tree, "v": tree, "acc": acc, "count": z(()),
            "act_acc": {"0.q_proj": z((32, d)), "0.down_proj": z(f)}}
    sparse = {"params": tree, "trainable": trainable, "m": trainable, "v": trainable,
              "q": q, "q_head": {"wq": z((v, d)), "sw": z(v)}, "step": z(())}
    return warm, sparse


def _jax_fsdp_dims(state, f, mode):
    from sparse_matrix_tuning_tpu.parallel.mesh import state_shardings
    sh = state_shardings(state, jax_make_mesh((1, f, 1), jax.devices()[:f]), mode)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        key = "/".join(p.key for p in path)
        dims = [i for i, n in enumerate(s.spec)
                if n == "fsdp" or (isinstance(n, tuple) and "fsdp" in n)]
        out[key] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("mode", ["matrix", "channel"])
@pytest.mark.parametrize("dims", [(256, 512, 256, False), (2048, 5632, 32000, True)],
                         ids=["tiny", "tinyllama"])
def test_shard_dim_is_jax_state_shardings(f, mode, dims):
    """shard_dim of every leaf equals the fsdp dim of JAX's
    state_shardings (its PartitionSpecs and _fit) on a (1, F, 1) mesh, at
    the tiny widths and at TinyLlama's (5632 / 4 splits gate/up's inputs
    mid-block; the per-step accumulators' 22 column blocks stay whole at
    F 4)."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import shard_dim
    d, ff, v, acc_blocks = dims
    for state in _state_of_shapes(mode, d=d, f=ff, v=v, acc_blocks=acc_blocks):
        want = _jax_fsdp_dims(state, f, mode)
        shapes = {"/".join(p.key for p in path): leaf.shape
                  for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
        got = {k: shard_dim(k, shape, mode, f) for k, shape in shapes.items()}
        assert got == want
        assert any(x is not None for x in got.values())


def test_rank_order_is_data_major():
    """F1: at (2, 2, 1) rank r = d * F + f takes row slice r of every
    microbatch (JAX's batch split over ("data", "fsdp")), with the global
    microbatch's valid-token count."""
    from sparse_matrix_tuning_tpu_torch.data.sft import shard_batch
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh, rank_rows
    rows = np.arange(16)[:, None] * np.ones((1, 3), np.int64)
    b = batches(1, pads=(32, 8, 20, 32, 12, 32, 4, 26))[0]
    valid = (b["labels"][:, 1:] != -100).sum(axis=1)
    for r in range(4):
        mesh = Mesh((2, 2, 1), r, torch.device("cpu"))
        assert (mesh.data_index, mesh.fsdp_index) == (r // 2, r % 2)
        got = rank_rows({"x": rows}, mesh, accum=2)["x"][:, 0]
        assert got.tolist() == [r * 2, r * 2 + 1, 8 + r * 2, 8 + r * 2 + 1]
        out = shard_batch(b, mesh, accum=2)
        np.testing.assert_array_equal(out["input_ids"], b["input_ids"][[r, 4 + r]])
        assert out["loss_denom"].tolist() == [valid[:4].sum(), valid[4:].sum()]


@pytest.mark.parametrize("f", [2, 3, 4])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("strategy", ["mean_abs", "abs_mean", "L1", "L2"])
def test_block_stats_from_straddling_shards(f, dim, strategy):
    """F5: partial sums of each shard, combined, then the reducer's
    non-linearity equal block_stats (and the signed per-step form
    block_stats_step) of the whole tensor, where shards of 768 / F columns
    or rows cut through the 256-blocks."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import (
        PARTIAL_KIND, block_partials, finish_block_stat)
    from sparse_matrix_tuning_tpu_torch.smt.select import block_stats, block_stats_step
    full = torch.from_numpy(tp.seeded_normal((768, 768), 5 + f + dim))
    shards = full.chunk(f, dim)
    n = shards[0].shape[dim]

    def window(i):  # the shard's (first, n) rows and columns
        return [(i * n, n) if d == dim else (0, 768) for d in (0, 1)]

    total = sum(block_partials(s, *window(i), full.shape, PARTIAL_KIND[strategy])
                for i, s in enumerate(shards))
    np.testing.assert_allclose(finish_block_stat(total, strategy).numpy(),
                               block_stats(full, strategy).numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(finish_block_stat(total, strategy, signed=True).numpy(),
                               block_stats_step(full, strategy).numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("f", [2, 3, 4])
@pytest.mark.parametrize("dim", [0, 1])
def test_scatter_into_shards(f, dim):
    """F6: each shard's write_blocks / write_columns equals its slice of
    plan.scatter over the whole weight, bit for bit, where the shards (768 /
    F rows or columns) cut through the blocks, and blocks lie in other
    ranks' shards."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import (
        block_window, column_window, write_blocks, write_columns)
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    w = torch.from_numpy(tp.seeded_normal((768, 768), 3)).to(torch.bfloat16)
    coords = ((2, 1), (0, 0), (1, 2), (2, 2))
    cols = (5, 700, 300, 256, 255)
    for mode, lp in (("matrix", LinearPlan("q_proj", 0, 768, 768, blocks=coords)),
                     ("channel", LinearPlan("q_proj", 0, 768, 768, channels=cols))):
        plan = SMTPlan(mode, {"0.q_proj": lp})
        t = torch.from_numpy(tp.seeded_normal((4, 256, 256) if mode == "matrix" else (768, 5),
                                              11))
        want = w.clone()
        plan.scatter({"0": {"q_proj": want}}, {"0.q_proj": t})
        for i, (shard, goal) in enumerate(zip(w.chunk(f, dim), want.chunk(f, dim))):
            shard = shard.clone()
            n = shard.shape[dim]
            if mode == "matrix":
                extent = (i * n, n)
                write_blocks(shard, (i * n, 0) if dim == 0 else (0, i * n), t, block_window(
                    lp.row_blocks().astype(np.int64), lp.col_blocks().astype(np.int64),
                    extent if dim == 0 else None, extent if dim == 1 else None, "cpu"))
            else:
                write_columns(shard, i * n if dim == 0 else 0, t, column_window(
                    np.asarray(cols, np.int64), (i * n, n) if dim == 1 else None, "cpu"))
            assert torch.equal(shard, goal), (mode, i)
