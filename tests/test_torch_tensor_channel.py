"""Channel mode under the tensor axis (`--channel_sparsity` on `--mesh_shape
D,F,T`, T > 1), per layer over the dense base and over the scan state
(`--scan_layers on`, dense and int8): gloo ranks on the CPU, spawned once
per mesh shape by torch.multiprocessing (tests/torch_dp_ranks.py, which
imports no JAX), against the JAX SMTTrainer on the same mesh over
conftest's virtual CPU devices and against the port in one process at
the same global batch (tests/test_torch_fsdp_scan.py's runner and
checks). Tiny Llama, 2 layers, 8 + 8 channels, inputs from numpy seeds.

  (1, 1, 2)  channel (per layer), channel_pss (per_step_stats: the (C,)
             statistics whole on every rank), channel_fp16, channel_scan
             (--scan_layers on over the fp32 base), channel_scan_int8
             (over the int8 base, its stacks offloaded to each rank's
             host store of slices); a channel run stopped mid warm-up and
             resumed
  (1, 2, 2)  channel, channel_scan_int8, against JAX's mesh as well

Each rank holds JAX's shard of act_acc (the (S, C) sums' C/T columns, the
(C,) statistics whole), of every weight, q and host store leaf; the
trainable columns, their base and moments stay whole over tensor.

Without a spawn, two tensor ranks as threads (tests/test_torch_tensor.py's
harness): smt_channel_linear(tensor=) and smt_channel_linear_dyn(tensor=)
on each rank's slice against JAX's functions over the whole weight (dense
and int8, a column- and two row-parallel modules), padded entries' grads
exactly 0 and a rank whose window holds no entry; the channel stacks'
tensor sum against the whole sum bit for bit; plan.scatter into two-axis
slices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_channel_scan import GRAD_X_TOL, Y_TOL
from test_torch_fsdp_scan import _ranks, check_jax_mesh, check_one_process, check_share, scan_runs
from test_torch_parallel import D1_RTOL_INT8, FP16_RTOL, JAX_RTOL, MODEL, N_WARMUP, _cfg, batches
from test_torch_tensor import _on_threads
from test_torch_tensor_meshes import (
    _assert_resumed, _assert_state_close_tp, _assert_within_adam, _step_bounds)

from sparse_matrix_tuning_tpu.ops import quant as jquant
from sparse_matrix_tuning_tpu.ops.sparse_linear import (
    smt_channel_linear as jax_channel_linear, smt_channel_linear_dyn as jax_channel_linear_dyn)
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan

_SCAN = dict(scan_layers="on")
_INT8 = dict(scan_layers="on", frozen_quant="int8")
_ONE = dict(per_device_ft_batch_size=1)
# mesh -> {name: (config kwargs, layers)}
MESHES = {
    (1, 1, 2): {
        "channel": (_cfg("channel"), 2),
        "channel_pss": (_cfg("channel", saliency_accumulation="per_step_stats"), 2),
        "channel_fp16": (_cfg("channel", dtype="fp16"), 2),
        "channel_scan": (_cfg("channel", **_SCAN), 2),
        "channel_scan_int8": (_cfg("channel", **_INT8), 2),
    },
    (1, 2, 2): {
        "channel": (_cfg("channel", **_ONE), 2),
        "channel_scan_int8": (_cfg("channel", **_ONE, **_INT8), 2),
    },
}
CASES = [(shape, name) for shape, sc in MESHES.items() for name in sc]
JAX_CASES = [((1, 2, 2), "channel"), ((1, 2, 2), "channel_scan_int8")]


def _id(case):
    return f"{''.join(map(str, case[0]))}-{case[1]}"


def _scan(case):
    return "scan" in case[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its mesh (one spawn per mesh; the (1, 1, 2) one with
    the checkpoint run stopped mid warm-up), in one process, and the
    JAX_CASES on JAX's mesh."""
    tmp = tmp_path_factory.mktemp("tensor_channel")
    torch.save(batches(N_WARMUP + 2), tmp / "ckpt_batches.pt")
    ckpt = {"name": "channel_ckpt", "probe": "checkpoint", "stop": 1,
            "cfg": _cfg("channel", output_dir=str(tmp / "ckpt_out")),
            "model": MODEL, "total_steps": N_WARMUP + 2, "params": str(tmp / "params2.pt"),
            "batches": str(tmp / "ckpt_batches.pt")}
    out = scan_runs(tmp, MESHES, jax_cases=JAX_CASES, extras={(1, 1, 2): [ckpt]})
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("case", JAX_CASES, ids=_id)
def test_tensor_channel_ranks_match_jax_mesh(runs, case):
    """Losses within 1e-4 every step and the eval loss (over the int8 base
    1e-3), the same plan fingerprint, against JAX's SMTTrainer in channel
    mode on the same mesh (per layer, and over its int8 scan state)."""
    check_jax_mesh(runs, case, scan=_scan(case))


def _bounds(case):
    """tests/test_torch_tensor_meshes.py's bounds against one process: the
    losses and grad norms by _step_bounds, the eval loss at the mesh's
    rtol, the final state by the tensor axis's rule (over the int8 base
    every entry within Adam's bound)."""
    cfg = MESHES[case[0]][case[1]][0]
    fp16, int8 = cfg.get("dtype") == "fp16", "frozen_quant" in cfg
    return (_step_bounds, FP16_RTOL[0] if fp16 else D1_RTOL_INT8 if int8 else JAX_RTOL,
            _assert_within_adam if int8 else _assert_state_close_tp)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_tensor_channel_ranks_match_one_process(runs, case):
    """Losses, grad norms (fp16: the same overflow flags), eval loss, the
    gathered final state and the export against the port in one process
    at tests/test_torch_tensor_meshes.py's bounds, the same fingerprint
    (the selection over the gathered statistics); every rank reports and
    exports the same."""
    check_one_process(runs, case, _bounds(case), scan=_scan(case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_tensor_channel_rank_holds_its_share(runs, case):
    """Each rank holds 1/T of every tensor-split leaf (the layer weights or
    stacks, q and the host store; 1/(F T) where fsdp splits it too), the
    trainable columns, base and moments whole over tensor; in the warm-up
    act_acc's (S, C) sums hold C/T columns a rank and the (C,) per-step
    statistics stay whole."""
    check_share(runs, case, scan=_scan(case))
    t = case[0][2]
    pss = MESHES[case[0]][case[1]][0].get("saliency_accumulation") == "per_step_stats"
    for r, g in enumerate(_ranks(runs, case)):
        warm, shapes = g["shard_bytes"][0], g["shapes"][0]
        acts = {k: v for k, v in warm.items() if k.startswith("act_acc/")}
        assert acts, r
        for k, (d, here, full) in acts.items():
            assert d is None and here * (1 if pss else t) == full, (r, k, here, full)
            assert len(shapes[k]) == (1 if pss else 2), (r, k, shapes[k])


@pytest.mark.parametrize("case", JAX_CASES, ids=_id)
def test_each_rank_holds_jax_shard_of_its_device(runs, case):
    """Every warm-up leaf (act_acc's columns among them) has the shape of
    JAX's shard for the rank's device as JAX's trainer placed it, and
    every sparse-phase leaf (layer weights or stacks, q / q_head, the
    columns, base and moments, the host store) that of its state_shardings
    placement. Under --scan_layers on JAX warms up over its scan state,
    which the port does not port (its eager warm-up selects the same
    plan): there each layer's act_acc holds the columns of JAX's stacked
    (L, S, C) shard."""
    jax_run = runs[case]["jax"]
    want, warm = jax_run["shards"], jax_run["warm_shards"]
    tops = ("params/", "q/", "q_head/", "trainable/", "base/", "m/", "v/", "host/")
    for r, g in enumerate(_ranks(runs, case)):
        common = set(g["shapes"][0]) & set(warm)
        acts = [k for k in g["shapes"][0] if k.startswith("act_acc/")]
        assert acts and (_scan(case) or set(acts) <= common), sorted(warm)[:8]
        for k in common:
            assert g["shapes"][0][k] == warm[k][r], (r, k, g["shapes"][0][k], warm[k][r])
        for k in set(acts) - common:   # "act_acc/{layer}.{module}" beside JAX's "act_acc/{module}"
            stacked = warm[f"act_acc/{k.split('.', 1)[1]}"][r]
            assert g["shapes"][0][k][-1] == stacked[-1], (r, k, g["shapes"][0][k], stacked)
        mine = {**g["shapes"][1], **g["host_shapes"]}
        keys = {k for k in mine if k.startswith(tops)}
        assert keys and keys <= set(want), sorted(keys - set(want))
        for k in keys:
            assert mine[k] == want[k], (r, k, mine[k], want[k])


def test_tensor_channel_checkpoint_mid_warmup_resumes_bit_for_bit(runs):
    """At (1, 1, 2) a channel run stopped after its first warm-up step
    (each rank writes its act_acc columns in state.fsdp0.tensor{t}.pt) and
    restored into fresh trainers equals the straight run bit for bit:
    losses and every leaf's checksum after every step, the accumulators
    through the warm-up, the columns after the conversion."""
    got = runs["channel_ckpt"]
    _assert_resumed(got, runs["tmp"] / "ckpt_out" / "ckpt")
    for g in got:
        assert g["saved_phase"] == "warmup"
        assert any(k.startswith("act_acc/") for k in g["straight_sums"][0])
        assert len(set(g["fingerprints"])) == 1


# ---------------------------------------------------------------------------
# the channel linears on each tensor rank's slice, two ranks as threads
# ---------------------------------------------------------------------------

# module -> (O, I), channels, valid: q_proj column-parallel; o_proj
# row-parallel, its padded entry repeating channel 5 inside rank 0's
# columns; down_proj row-parallel with every channel in rank 1's columns,
# rank 0's window empty
CHANNEL_CASES = {
    "q_proj": ((256, 256), [5, 200, 5], [True, True, False]),
    "o_proj": ((256, 256), [5, 200, 5], [True, True, False]),
    "down_proj": ((256, 512), [300, 400, 300], [True, True, False]),
}
T = 2


def _channel_case(module, base):
    (o, i), ci, valid = CHANNEL_CASES[module]
    ci, valid = np.array(ci, np.int32), np.array(valid)
    w = tp.seeded_normal((o, i), 1, 0.05)
    if base == "int8":
        wq, sw = jquant.quantize_weight(jnp.asarray(w))
        frozen = {"wq": np.asarray(wq), "sw": np.asarray(sw)}
        wd = np.asarray(jquant.dequantize_weight(wq, sw, jnp.float32))
    else:
        frozen, wd = {"w": w}, w
    base_cols = wd[:, ci]
    cols = base_cols + tp.seeded_normal((o, len(ci)), 4, 0.02)
    cols[:, ~valid] += 123.0   # a padded entry's value must not matter
    x = tp.seeded_normal((2, 8, i), 2)
    g = tp.seeded_normal((2, 8, o), 3)
    return x, g, cols, ci, valid, frozen, base_cols


def _slice_of(module, mesh, frozen):
    """(split, first, width, slice, the rank's frozen leaves): a column-
    parallel module's output rows ("out") or a row-parallel one's input
    columns ("in") of this rank, and its slice of frozen (a row-parallel
    sw whole)."""
    col = module == "q_proj"
    o, i = CHANNEL_CASES[module][0]
    width = (o if col else i) // T
    first = mesh.tensor_index * width
    cut = slice(first, first + width)
    mine = {k: torch.from_numpy(np.array(
                v[cut] if col else (v[:, cut] if v.ndim == 2 else v)))
            for k, v in frozen.items()}
    return ("out" if col else "in"), first, width, cut, mine


def _assert_summed(module, got, want, padded=()):
    """The ranks' outputs concatenate (column-parallel) or sum (row-
    parallel), grad_x the other way, and the columns' grads sum to JAX's;
    a padded entry's grad is exactly 0 on every rank."""
    col = module == "q_proj"
    ys, gxs, gcs = zip(*got)
    y = torch.cat(ys, -1) if col else sum(ys)
    gx = sum(gxs) if col else torch.cat(gxs, -1)
    for name, a, w, tol in (("y", y, want[0], Y_TOL), ("grad_x", gx, want[1], GRAD_X_TOL),
                            ("grad_cols", sum(gcs), want[2], Y_TOL)):
        np.testing.assert_allclose(tp.np32(a), np.asarray(w), rtol=tol, atol=tol, err_msg=name)
    for r, gc in enumerate(gcs):
        assert all(not gc[:, j].any() for j in padded), (r, padded)


@pytest.mark.parametrize("module", list(CHANNEL_CASES))
def test_smt_channel_linear_tensor_matches_jax(module, monkeypatch):
    """smt_channel_linear(tensor=) on each of two thread ranks (its slice of
    the dense weight holding the current columns, x whole or its columns
    as the layer hands them, SMTPlan.channel_tensor_window's window)
    against jax.vjp of JAX's smt_channel_linear over the whole weight
    (fp32, the channel scan suite's bounds); down_proj's rank 0 holds no
    selected column and its grads are 0."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import smt_channel_linear
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    (o, i), ci, valid = CHANNEL_CASES[module]
    channels = tuple(c for c, v in zip(ci, valid) if v)
    x, g, cols, *_ = _channel_case(module, "dense")
    cols = cols[:, np.array(valid)]
    w = tp.seeded_normal((o, i), 1, 0.05)
    w[:, list(channels)] = cols
    jlp = JaxLinearPlan(module, 0, o, i, channels=channels)

    @jax.jit
    def jax_vjp(x, c, g):
        y, pull = jax.vjp(lambda x, c: jax_channel_linear(x, c, jnp.asarray(w), jlp), x, c)
        return (y,) + pull(g)

    want = jax_vjp(jnp.asarray(x), jnp.asarray(cols), jnp.asarray(g))
    plan = SMTPlan("channel", {"0.m": LinearPlan(module, 0, o, i, channels=channels)})

    def rank(mesh):
        split, first, width, cut, mine = _slice_of(module, mesh, {"w": w})
        window = plan.channel_tensor_window("0.m", "cpu", mesh.tensor_index, T)
        assert (window.split, window.first, window.width) == (split, first, width)
        xi = torch.from_numpy(np.ascontiguousarray(x if split == "out" else x[..., cut]))
        xi.requires_grad_(True)
        ct = torch.from_numpy(cols).requires_grad_(True)
        y = smt_channel_linear(xi, ct, mine["w"], plan.linears["0.m"], tensor=window)
        y.backward(torch.from_numpy(np.ascontiguousarray(g[..., cut] if split == "out" else g)))
        return y.detach(), xi.grad, ct.grad

    got = _on_threads(T, monkeypatch, rank)
    _assert_summed(module, got, want)
    if module == "down_proj":
        assert not got[0][2].any() and got[1][2].abs().min() > 0


@pytest.mark.parametrize("base", ["dense", "int8"])
@pytest.mark.parametrize("module", list(CHANNEL_CASES))
def test_smt_channel_linear_dyn_tensor_matches_jax(module, base, monkeypatch):
    """smt_channel_linear_dyn(tensor=) on each of two thread ranks (its
    slice of the frozen base, its ChannelWindow of the padded channels: a
    row-parallel window takes the valid entries in its columns) against
    jax.vjp of JAX's smt_channel_linear_dyn over the whole weight (fp32,
    the channel scan suite's bounds). The padded entry's grad is exactly 0
    on every rank (its channel lies in o_proj's rank 0 window, where it
    would count twice); down_proj's rank 0 holds no entry, adds no
    correction and joins the int8 amax all-reduce all the same."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import (
        channel_window, smt_channel_linear_dyn)
    from sparse_matrix_tuning_tpu_torch.ops import quant
    x, g, cols, ci, valid, frozen, base_cols = _channel_case(module, base)

    @jax.jit
    def jax_vjp(x, c, g):
        y, pull = jax.vjp(lambda x, c: jax_channel_linear_dyn(
            "oracle", x, c, jnp.asarray(ci), jnp.asarray(valid),
            {k: jnp.asarray(v) for k, v in frozen.items()}, jnp.asarray(base_cols)), x, c)
        return (y,) + pull(g)

    want = jax_vjp(jnp.asarray(x), jnp.asarray(cols), jnp.asarray(g))
    amax_calls = [0] * T
    reduce = quant.tensor_amax

    def counted(amax, mesh):
        amax_calls[mesh.tensor_index] += 1
        return reduce(amax, mesh)

    monkeypatch.setattr(quant, "tensor_amax", counted)

    def rank(mesh):
        split, first, width, cut, mine = _slice_of(module, mesh, frozen)
        window = channel_window(ci, valid, "cpu", (split, first, width))
        xi = torch.from_numpy(np.ascontiguousarray(x if split == "out" else x[..., cut]))
        xi.requires_grad_(True)
        ct = torch.from_numpy(cols).requires_grad_(True)
        y = smt_channel_linear_dyn(xi, ct, torch.from_numpy(ci), torch.from_numpy(valid), mine,
                                   torch.from_numpy(base_cols), window=window, tensor=mesh)
        y.backward(torch.from_numpy(np.ascontiguousarray(g[..., cut] if split == "out" else g)))
        return y.detach(), xi.grad, ct.grad

    got = _on_threads(T, monkeypatch, rank)
    _assert_summed(module, got, want, padded=np.nonzero(~valid)[0])
    if module == "down_proj":
        assert not got[0][2].any()
    if base == "int8":   # one whole-row amax a rank, forward or backward
        assert amax_calls[0] == amax_calls[1] == 1, amax_calls


def test_channel_window_picks_valid_entries_first():
    """A row-parallel window holds the valid entries whose channel lies in
    the rank's columns, at their columns there; a padded entry that
    repeats a valid channel never enters; a column-parallel window is the
    rank's rows alone."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import channel_window
    ci, valid = np.array([300, 5, 260, 5, 5]), np.array([True, True, True, False, False])
    w0 = channel_window(ci, valid, "cpu", ("in", 0, 256))
    w1 = channel_window(ci, valid, "cpu", ("in", 256, 256))
    assert (w0.sel.tolist(), w0.loc.tolist()) == ([1], [5])
    assert (w1.sel.tolist(), w1.loc.tolist()) == ([0, 2], [44, 4])
    none = channel_window(ci, valid, "cpu", ("in", 512, 256))
    assert none.sel.numel() == 0 and none.loc.numel() == 0
    assert channel_window(ci, valid, "cpu", ("out", 128, 128)) == ("out", 128, 128, None, None)


# ---------------------------------------------------------------------------
# the channel stacks' tensor sum, and the scatter into two-axis slices
# ---------------------------------------------------------------------------

def test_channel_stacks_tensor_sum_equals_whole_sum(monkeypatch):
    """steps._sum_parts over two thread ranks with scan_phase.valid_rows of
    a channel scan state: each rank's (L, O, n) stacked column grads, its
    padded columns 0, are summed whole (valid_rows gives None: the first
    two dims of a channel stack are layers and output rows, not entries),
    equal to the sum of the whole stacks bit for bit, and the bytes moved
    are the whole stacks'."""
    from sparse_matrix_tuning_tpu_torch.train.scan_phase import valid_rows
    from sparse_matrix_tuning_tpu_torch.train.steps import _sum_parts
    valid = torch.tensor([[True, True, False], [True, False, False], [False, False, False]])
    state = {"idx": {"down_proj": {"ci": torch.zeros((3, 3), dtype=torch.int32),
                                   "valid": valid}},
             "trainable": {"down_proj": torch.zeros((3, 64, 3))}}
    rows = valid_rows(state)
    assert rows == {"down_proj": None}

    def rank(mesh):
        g = torch.from_numpy(tp.seeded_normal((3, 64, 3), 7 + mesh.tensor_index))
        g *= valid[:, None, :]
        mine = {"down_proj": g.clone()}
        _sum_parts(mine, rows, mesh, "tensor")
        return g, mine["down_proj"], mesh.stats["grad_parts_bytes"]

    got = _on_threads(2, monkeypatch, rank)
    whole = got[0][0] + got[1][0]
    for _, summed, moved in got:
        assert torch.equal(summed, whole) and moved == 3 * 64 * 3 * 4


@pytest.mark.parametrize("module", ["q_proj", "down_proj"])
def test_channel_scatter_into_two_axis_slices(module):
    """plan.scatter over a (1, 2, 2) Sharding's slices of a 768 x 768 weight
    (a column-parallel one's rows on tensor and columns on fsdp, a row-
    parallel one's the other way) equals the slice of the one-process
    scatter bit for bit: each slice takes its rows of the columns that lie
    in its columns."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import Sharding
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    channels = (5, 700, 300, 256, 255, 383, 384)
    plan = SMTPlan("channel", {"0.m": LinearPlan(module, 0, 768, 768, channels=channels)})
    w = torch.from_numpy(tp.seeded_normal((768, 768), 3)).to(torch.bfloat16)
    cols = torch.from_numpy(tp.seeded_normal((768, len(channels)), 11))
    want = w.clone()
    plan.scatter({"0": {module: want}}, {"0.m": cols})
    path = f"params/layers/0/{module}"
    for r in range(4):
        sh = Sharding(Mesh((1, 2, 2), r, torch.device("cpu")))
        mine = sh.shard(path, w)   # the columns stay whole: gathered, no collective
        goal = sh.local(path, want)
        plan.scatter({"0": {module: mine}}, {"0.m": cols}, sh)
        assert sh.dim(path) is not None and sh.tdim(path) is not None
        assert torch.equal(mine, goal), r
