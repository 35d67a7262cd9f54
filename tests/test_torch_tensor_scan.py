"""The scan layouts under the tensor axis (`--scan_layers on` on
`--mesh_shape D,F,T`, T > 1; matrix mode over the fp32 and the int8 base):
gloo ranks on the CPU, spawned once per mesh shape by
torch.multiprocessing (tests/torch_dp_ranks.py, which imports no JAX),
against the JAX SMTTrainer on the same mesh over conftest's virtual CPU
devices and against the port in one process at the same global batch
(tests/test_torch_fsdp_scan.py's runner and checks). Tiny Llama, 2
layers, inputs from numpy seeds.

  (1, 1, 2)  scan, scan_int8 (the stacks offloaded to each rank's host
             store of slices), scan_int8_fp16; an int8 run stopped in
             the sparse phase and resumed
  (1, 2, 2)  scan, scan_int8, against JAX's mesh as well

Hidden 256 over two tensor ranks: q_proj's and o_proj's one 256-block
straddles the ranks' 128-row (128-column) slices, so every rank's window
holds a panel of it. Each rank holds its slice over both axes of every
stacked weight, q leaf and host store leaf (JAX's shard for its device),
the trainables, their base and moments whole over tensor.

Without a spawn, T tensor ranks as threads (tests/test_torch_tensor.py's
harness): smt_linear_dyn(tensor=) on each rank's slice and window against
JAX's smt_linear_dyn over the whole weight, dense and int8, its padded
entries' grads exactly 0 and an empty window; the sum of the block grads
over the tensor group at the valid entries only against the whole
stacks' sum, bit for bit; the scan state's two-axis dims against JAX's
state_shardings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_fsdp_scan import (
    _ranks, _scan_state_of_shapes, check_jax_mesh, check_one_process, check_share, scan_runs)
from test_torch_parallel import D1_RTOL_INT8, FP16_RTOL, JAX_RTOL, MODEL, N_WARMUP, _cfg, batches
from test_torch_tensor import _jax_dims, _on_threads
from test_torch_tensor_meshes import (
    _assert_resumed, _assert_state_close_tp, _assert_within_adam, _step_bounds)

from sparse_matrix_tuning_tpu.ops import quant as jquant
from sparse_matrix_tuning_tpu.ops.sparse_linear import smt_linear_dyn as jax_smt_linear_dyn
from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh

_ON = dict(scan_layers="on")
# mesh -> {name: (config kwargs, layers)}
MESHES = {
    (1, 1, 2): {
        "scan": (_cfg(**_ON), 2),
        "scan_int8": (_cfg(frozen_quant="int8", **_ON), 2),
        "scan_int8_fp16": (_cfg(frozen_quant="int8", dtype="fp16", **_ON), 2),
    },
    (1, 2, 2): {
        "scan": (_cfg(per_device_ft_batch_size=1, **_ON), 2),
        "scan_int8": (_cfg(per_device_ft_batch_size=1, frozen_quant="int8", **_ON), 2),
    },
}
CASES = [(shape, name) for shape, sc in MESHES.items() for name in sc]
JAX_CASES = [((1, 2, 2), "scan"), ((1, 2, 2), "scan_int8")]


def _id(case):
    return f"{''.join(map(str, case[0]))}-{case[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its mesh (one spawn per mesh; the (1, 1, 2) one with
    the int8 checkpoint run), in one process, and the JAX_CASES on JAX's
    mesh."""
    tmp = tmp_path_factory.mktemp("tensor_scan")
    torch.save(batches(N_WARMUP + 3), tmp / "ckpt_batches.pt")
    ckpt = {"name": "scan_ckpt", "probe": "checkpoint", "stop": N_WARMUP + 1,
            "cfg": _cfg(frozen_quant="int8", output_dir=str(tmp / "ckpt_out"), **_ON),
            "model": MODEL, "total_steps": N_WARMUP + 3, "params": str(tmp / "params2.pt"),
            "batches": str(tmp / "ckpt_batches.pt")}
    out = scan_runs(tmp, MESHES, jax_cases=JAX_CASES, extras={(1, 1, 2): [ckpt]})
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("case", JAX_CASES, ids=_id)
def test_tensor_scan_ranks_match_jax_mesh(runs, case):
    """Losses within 1e-4 every step and the eval loss (over the int8 base
    1e-3), the same plan fingerprint, against JAX's SMTTrainer over its
    scan state on the same mesh."""
    check_jax_mesh(runs, case)


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
def test_tensor_scan_ranks_match_one_process(runs, case):
    """Losses, grad norms (fp16: the same overflow flags), eval loss, the
    gathered final state and the export against the port in one process
    at tests/test_torch_tensor_meshes.py's bounds, the same fingerprint;
    every rank reports and exports the same."""
    check_one_process(runs, case, _bounds(case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_tensor_scan_rank_holds_its_share(runs, case):
    """Each rank holds 1/T of every stacked weight, q leaf and host store
    leaf (1/(F T) where fsdp splits it too), the trainables, base and
    moments whole over tensor (1/F over fsdp)."""
    check_share(runs, case)


@pytest.mark.parametrize("case", JAX_CASES, ids=_id)
def test_each_rank_holds_jax_shard_of_its_device(runs, case):
    """Every stacked leaf, q / q_head leaf, trainable / base / m / v and host
    store leaf of a rank has the shape of JAX's shard for its device (the
    state_shardings of JAX's final scan state, the HostShards' sharding of
    its host store)."""
    want = runs[case]["jax"]["shards"]
    tops = ("params/layers_stacked", "q/", "q_head/", "trainable/", "base/", "m/", "v/", "host/")
    for r, g in enumerate(_ranks(runs, case)):
        mine = {**g["shapes"][1], **g["host_shapes"]}
        keys = {k for k in mine if k.startswith(tops)}
        assert keys and keys <= set(want), sorted(keys - set(want))
        for k in keys:
            assert mine[k] == want[k], (r, k, mine[k], want[k])
        assert {k.split("/")[0] for k in keys if k in g["shard_tdims"]} >= (
            {"q", "host", "q_head"} if "int8" in case[1] else {"params"})


def test_tensor_scan_int8_checkpoint_resumes_bit_for_bit(runs):
    """At (1, 1, 2) over the int8 scan state, a run stopped after its first
    sparse step (each rank writes its slices in state.fsdp0.tensor{t}.pt
    and its host store's in frozen_host.fsdp0.tensor{t}.pt) and restored
    into fresh trainers equals the straight run bit for bit, host store
    included."""
    got = runs["scan_ckpt"]
    ckpt = runs["tmp"] / "ckpt_out" / "ckpt"
    _assert_resumed(got, ckpt)
    assert sorted(p.name for p in ckpt.glob("frozen_host*.pt")) == \
        ["frozen_host.fsdp0.tensor0.pt", "frozen_host.fsdp0.tensor1.pt"]
    for g in got:
        assert g["host_equal"] and "lm_head" in g["host_keys"], g["host_keys"]
        assert any(k.startswith("q/") for k in g["resumed_leaves"])


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 2, 2)],
                         ids=lambda s: "".join(map(str, s)))
@pytest.mark.parametrize("offload", [False, True], ids=["dense", "offloaded"])
def test_stacked_two_axis_dims_are_jax_state_shardings(shape, offload):
    """Sharding.split_dims of every leaf of the matrix scan state equals the
    (fsdp, tensor) dims of JAX's state_shardings on the same mesh; the host
    store's slices take the dims of the stacks and of the lm_head they
    hold."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import Sharding
    sh = Sharding(Mesh(shape, 0, torch.device("cpu")))
    state = _scan_state_of_shapes("matrix", offload=offload)
    want = _jax_dims(state, shape, "matrix")
    got = {"/".join(p.key for p in path): sh.split_dims("/".join(p.key for p in path),
                                                        leaf.shape, "matrix")
           for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
    assert got == want
    split_t = {k.split("/")[0] for k, (_, t) in got.items() if t is not None}
    assert split_t >= {"q", "q_head"} | (set() if offload else {"params"})
    assert not split_t & {"trainable", "base", "m", "v"}
    dense = _scan_state_of_shapes("matrix")["params"]
    for name, w in dense["layers_stacked"].items():
        if w.ndim == 3:
            assert sh.split_dims(f"host/{name}", w.shape) == \
                sh.split_dims(f"params/layers_stacked/{name}", w.shape)
    assert sh.split_dims("host/lm_head", dense["lm_head"].shape) == \
        sh.split_dims("params/lm_head", dense["lm_head"].shape)


# ---------------------------------------------------------------------------
# smt_linear_dyn on each tensor rank's window, two ranks as threads
# ---------------------------------------------------------------------------

# module -> (O, I), padded entries (rb, cb, valid): q_proj's and o_proj's
# one block straddles the ranks' halves; gate_proj's and down_proj's blocks
# fall in one rank's half each; down_proj's padded entry sits at (0, 0),
# inside rank 0's columns, which hold no valid entry: an empty window
DYN_CASES = {
    "q_proj": ((256, 256), ([0, 0], [0, 0], [True, False])),
    "gate_proj": ((512, 256), ([1, 0, 0], [0, 0, 0], [True, True, False])),
    "o_proj": ((256, 256), ([0, 0], [0, 0], [True, False])),
    "down_proj": ((256, 512), ([0, 0], [1, 0], [True, False])),
}
# the JAX suite's smt_linear_dyn tolerance (tests/test_torch_scan_train.py)
DYN_RTOL = DYN_ATOL = 2e-5


def _dyn_case(module, base):
    (o, i), (rb, cb, valid) = DYN_CASES[module]
    rb, cb, valid = np.array(rb, np.int32), np.array(cb, np.int32), np.array(valid)
    w = tp.seeded_normal((o, i), 1, 0.05)
    if base == "int8":
        wq, sw = jquant.quantize_weight(jnp.asarray(w))
        frozen = {"wq": np.asarray(wq), "sw": np.asarray(sw)}
        wd = np.asarray(jquant.dequantize_weight(wq, sw, jnp.float32))
    else:
        frozen, wd = {"w": w}, w
    wd4 = wd.reshape(o // 256, 256, i // 256, 256)
    base_blocks = np.stack([wd4[r, :, c, :] for r, c in zip(rb, cb)])
    blocks = base_blocks + tp.seeded_normal(base_blocks.shape, 4, 0.02)
    blocks[~valid] += 123.0   # a padded entry's value must not matter
    x = tp.seeded_normal((2, 8, i), 2)
    g = tp.seeded_normal((2, 8, o), 3)
    return x, g, blocks, rb, cb, valid, frozen, base_blocks


@pytest.mark.parametrize("base", ["dense", "int8"])
@pytest.mark.parametrize("module", list(DYN_CASES))
def test_smt_linear_dyn_tensor_matches_jax(module, base, monkeypatch):
    """smt_linear_dyn(tensor=) on each of two thread ranks (its slice of the
    frozen base, its window of the valid entries, x or g whole or its
    slice as the layer hands them): the outputs concatenate (column-
    parallel) or sum (row-parallel), the grad_x sum (or concatenate), and
    the ranks' block grads sum to jax.vjp of JAX's smt_linear_dyn over
    the whole weight (fp32, 2e-5). A padded entry's grad is exactly 0 on
    every rank; down_proj's rank 0, whose window holds no entry, launches
    no K1 or K5 and joins the int8 amax all-reduce all the same."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import dyn_schedule, smt_linear_dyn
    x, g, blocks, rb, cb, valid, frozen, base_blocks = _dyn_case(module, base)
    col = module in ("q_proj", "gate_proj")

    @jax.jit
    def jax_vjp(x, blocks, g):
        y, pull = jax.vjp(lambda x, b: jax_smt_linear_dyn(
            "oracle", x, b, jnp.asarray(rb), jnp.asarray(cb), jnp.asarray(valid),
            {k: jnp.asarray(v) for k, v in frozen.items()}, jnp.asarray(base_blocks)), x, blocks)
        return (y,) + pull(g)

    want = jax_vjp(jnp.asarray(x), jnp.asarray(blocks), jnp.asarray(g))
    t = 2

    def rank(mesh):
        width = (frozen.get("w", frozen.get("wq")).shape[0 if col else 1]) // t
        first = mesh.tensor_index * width
        cut = slice(first, first + width)
        sched = dyn_schedule(torch.from_numpy(rb), torch.from_numpy(cb),
                             torch.from_numpy(valid), "cpu",
                             ("out" if col else "in", first, width))
        # column-parallel: its output rows (sw's too); row-parallel: its input columns
        mine = {k: torch.from_numpy(np.array(
                    v[cut] if col else (v[:, cut] if v.ndim == 2 else v)))
                for k, v in frozen.items()}
        xi = torch.from_numpy(np.ascontiguousarray(x if col else x[..., cut])).requires_grad_(True)
        bi = torch.from_numpy(blocks).requires_grad_(True)
        y = smt_linear_dyn(xi, bi, torch.from_numpy(rb), torch.from_numpy(cb),
                           torch.from_numpy(valid), mine, torch.from_numpy(base_blocks),
                           schedule=sched, tensor=mesh)
        y.backward(torch.from_numpy(np.ascontiguousarray(g[..., cut] if col else g)))
        grad = bi.grad if bi.grad is not None else torch.zeros_like(bi)
        return y.detach(), xi.grad, grad, sched.keep.tolist()

    got = _on_threads(t, monkeypatch, rank)
    ys, gxs, gbs, keeps = zip(*got)
    y = torch.cat(ys, -1) if col else sum(ys)
    gx = sum(gxs) if col else torch.cat(gxs, -1)
    for name, a, w in (("y", y, want[0]), ("grad_x", gx, want[1]),
                       ("grad_blocks", sum(gbs), want[2])):
        np.testing.assert_allclose(tp.np32(a), np.asarray(w), rtol=DYN_RTOL, atol=DYN_ATOL,
                                   err_msg=name)
    for r, gb in enumerate(gbs):
        assert all(not gb[j].any() for j in np.nonzero(~valid)[0]), r
        assert set(keeps[r]) <= set(np.nonzero(valid)[0].tolist()), (r, keeps[r])
    if module == "down_proj":
        assert keeps[0] == [] and not gbs[0].any() and keeps[1] == [0]


# ---------------------------------------------------------------------------
# the block grads' sum over the tensor group at the valid entries only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", ["tensor", "world"])
def test_valid_only_tensor_sum_equals_whole_stack_sum(over, monkeypatch):
    """steps._sum_parts over two thread ranks: each rank's (L, n, 128, 256)
    stacked grad, its padded entries 0 as K1 leaves them, summed at the
    valid entries (scan_phase.valid_rows) equals the sum of the whole
    stack bit for bit, for moving 5 of the 12 entries' bytes (counted in
    mesh.stats["grad_parts_*"])."""
    from sparse_matrix_tuning_tpu_torch.train.scan_phase import valid_rows
    from sparse_matrix_tuning_tpu_torch.train.steps import _sum_parts
    valid = torch.tensor([[True, True, False, False], [True, False, False, False],
                          [True, True, False, False]])
    state = {"idx": {"q_proj": {"valid": valid}},
             "trainable": {"q_proj": torch.zeros((3, 4, 128, 256))}}
    rows = valid_rows(state)

    def rank(mesh):
        g = torch.from_numpy(tp.seeded_normal((3, 4, 128, 256), 7 + mesh.tensor_index))
        g *= valid[:, :, None, None]
        picked, whole = {"q_proj": g.clone()}, {"q_proj": g.clone()}
        _sum_parts(picked, rows, mesh, over)
        moved = mesh.stats["grad_parts_bytes"]
        _sum_parts(whole, {"q_proj": None}, mesh, over)
        return picked["q_proj"], whole["q_proj"], moved, mesh.stats["grad_parts_bytes"] - moved

    got = _on_threads(2, monkeypatch, rank)
    for picked, whole, moved, moved_whole in got:
        assert torch.equal(picked, whole)
        assert (moved, moved_whole) == (5 * 128 * 256 * 4, 12 * 128 * 256 * 4)
    assert torch.equal(got[0][0], got[1][0])
