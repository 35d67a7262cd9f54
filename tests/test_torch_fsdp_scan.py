"""The scan layouts under fsdp (`--scan_layers on`, and channel + int8 at 12
layers under "auto", on `--mesh_shape D,F,1`): gloo ranks on the CPU,
spawned once per mesh shape by torch.multiprocessing
(tests/torch_dp_ranks.py, which imports no JAX), against the JAX
SMTTrainer on the same mesh over conftest's virtual CPU devices and
against the port in one process at the same global batch. Tiny Llama,
fp32, inputs from numpy seeds (tests/test_torch_parallel.py's scenarios
and bounds).

  (1, 2, 1)  scan (--scan_layers on over the fp32 base), scan_int8 (over
             the int8 base, its stacks offloaded to each rank's host store
             of slices), channel_int8 (channel + int8 at 12 layers, the
             "auto" scan)
  (2, 2, 1)  scan, scan_int8
  (1, 4, 1)  scan, scan_int8 (hidden 256 over 4 shards: every 256-block
             of the stacked trainables and of a column-parallel weight
             straddles four shards)

The conversion gathers each layer's fp32 master whole and keeps this
rank's slice of every stacked leaf (train/scan_phase.build_scan_sparse_state),
so the state, the host store and the export are the one-process
conversion's slices; each rank holds exactly 1/F of every leaf shard_dim
splits, host store included, and one gathered layer at a time. A
checkpoint mid sparse phase resumes bit for bit, host store included.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp
from test_torch_fsdp import _state_of_shapes, assert_state_close
from test_torch_parallel import (
    D1_RTOL, D1_RTOL_INT8, JAX_CFG, JAX_RTOL, MODEL, N, N_WARMUP, _cfg, batches)

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparse_matrix_tuning_tpu.parallel.mesh import set_compute_mesh
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer

# the int8 base against JAX (tests/test_torch_scan_convert.py INT8_LOSS_RTOL)
JAX_RTOL_INT8 = 1e-3
DEEP = 12  # JAX's scan_layers "auto" takes the scan layout from 12 layers

_ON = dict(scan_layers="on")
# mesh -> {name: (config kwargs, layers)}; the (2, 2, 1) and (1, 4, 1)
# meshes run in tests/test_torch_fsdp_scan_meshes.py, in another worker
MESHES = {
    (1, 2, 1): {
        "scan": (_cfg(**_ON), 2),
        "scan_int8": (_cfg(frozen_quant="int8", **_ON), 2),
        "channel_int8": (_cfg("channel", frozen_quant="int8"), DEEP),
    },
}
WIDE_MESHES = {
    (2, 2, 1): {
        "scan": (_cfg(per_device_ft_batch_size=1, **_ON), 2),
        "scan_int8": (_cfg(per_device_ft_batch_size=1, frozen_quant="int8", **_ON), 2),
    },
    (1, 4, 1): {
        "scan": (_cfg(per_device_ft_batch_size=1, **_ON), 2),
        "scan_int8": (_cfg(per_device_ft_batch_size=1, frozen_quant="int8", **_ON), 2),
    },
}
CASES = [(shape, name) for shape, sc in MESHES.items() for name in sc]


def _id(case):
    return f"{''.join(map(str, case[0]))}-{case[1]}"


def _int8(case):
    return "int8" in case[1]


@contextlib.contextmanager
def jax_mesh(shape):
    """JAX's mesh of `shape` over conftest's devices; the compute mesh the
    JAX trainer sets (trainer.py:68) is reset when the block ends, so no
    later test in this process reads it."""
    try:
        yield jax_make_mesh(shape, jax.devices()[:int(np.prod(shape))])
    finally:
        set_compute_mesh(None)


def _jax_shards(jt, mesh):
    """{path: shard shape} of the JAX trainer's final state as its
    state_shardings place it (every device alike), and of its host store
    ("host/{key}") as a HostShards holds it on a mesh of processes: by the
    sharding of the stack (or head) it left (in one process JAX keeps the
    whole array, every shard being addressable)."""
    from sparse_matrix_tuning_tpu.parallel.mesh import state_shardings

    def shapes(tree, rename=lambda k: k):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        sh = jax.tree_util.tree_flatten(state_shardings(tree, mesh, jt.plan.mode))[0]
        return {rename("/".join(getattr(p, "key", str(p)) for p in path)):
                tuple(sh[n].shard_shape(a.shape)) for n, (path, a) in enumerate(flat)}

    host = dict(jt._host_frozen or {})
    head = {"lm_head": host.pop("lm_head")} if "lm_head" in host else {}
    left = {"params": {"layers_stacked": host, **head}}
    return {**shapes(dict(jt.state)),
            **shapes(left, lambda k: "host/" + k.rsplit("/", 1)[-1])}


def _jax_run(spec, shape, bs, eval_path, layers):
    jcfg = dataclasses.replace(JAX_CFG, num_hidden_layers=layers)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)  # a fresh copy: donated
    with jax_mesh(shape) as mesh:
        jt = JaxSMTTrainer(JaxSMTConfig(**spec["cfg"]), jcfg, jparams,
                           total_steps=spec["total_steps"], mesh=mesh)
        # the warm-up state as the trainer placed it: {path: {device index: shard shape}}
        index = {d.id: i for i, d in enumerate(mesh.devices.flat)}
        warm = {"/".join(getattr(p, "key", str(p)) for p in path):
                {index[x.device.id]: tuple(x.data.shape) for x in a.addressable_shards}
                for path, a in jax.tree_util.tree_flatten_with_path(jt.state)[0]}
        losses = [float(jt.train_step(b)["loss"]) for b in bs]
        return {"loss": losses, "fingerprint": jt.plan.fingerprint(),
                "eval_loss": jt.evaluate(torch.load(eval_path, weights_only=False))[1],
                "shards": _jax_shards(jt, mesh), "warm_shards": warm}


def scan_runs(tmp, meshes, jax_cases=None, extras=None):
    """Every case on its mesh (one spawn per mesh), in one process, and on
    JAX's mesh (only the (shape, name) cases of `jax_cases` where given).
    extras: {shape: [spec]} more specs for that mesh's spawn (torch_dp_ranks.
    train_ranks' probes), whose ranks' results land under their names."""
    torch.save(batches(2, pads=(32, 20, 12, 6), seed=9), tmp / "eval.pt")
    for layers in {c[1] for sc in meshes.values() for c in sc.values()}:
        jcfg = dataclasses.replace(JAX_CFG, num_hidden_layers=layers)
        torch.save(tp.port_params(jax_init_params(jax.random.PRNGKey(0), jcfg)),
                   tmp / f"params{layers}.pt")
    out = {}
    for shape, scenarios in meshes.items():
        specs, bs_of = [], {}
        tag = "".join(map(str, shape))
        for name, (cfg, layers) in scenarios.items():
            bs_of[name] = batches(N)
            torch.save(bs_of[name], tmp / f"{tag}_{name}.pt")
            specs.append({"name": f"{tag}_{name}", "cfg": dict(cfg), "export": True,
                          "model": {**MODEL, "num_hidden_layers": layers}, "total_steps": N,
                          "params": str(tmp / f"params{layers}.pt"),
                          "batches": str(tmp / f"{tag}_{name}.pt"),
                          "eval_batches": str(tmp / "eval.pt")})
        world = int(np.prod(shape))
        more = (extras or {}).get(shape, [])
        ranks.spawn(ranks.train_ranks, world, tmp, specs + more, str(tmp), shape)
        for spec in more:
            out[spec["name"]] = [torch.load(tmp / f"{spec['name']}.{r}.pt", weights_only=False)
                                 for r in range(world)]
        for spec, name in zip(specs, scenarios):
            got = [torch.load(tmp / f"{spec['name']}.{r}.pt", weights_only=False)
                   for r in range(world)]
            with_jax = jax_cases is None or (shape, name) in jax_cases
            out[(shape, name)] = {
                "ranks": got, "d1": ranks.run_scenario(spec), "cfg": scenarios[name][0],
                "jax": _jax_run(spec, shape, bs_of[name], tmp / "eval.pt", scenarios[name][1])
                if with_jax else None}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return scan_runs(tmp_path_factory.mktemp("fsdp_scan"), MESHES)


def _ranks(runs, case):
    for r, got in enumerate(runs[case]["ranks"]):
        assert "error" not in got, f"rank {r}: {got['error']}"
    return runs[case]["ranks"]


def _losses(run):
    return [m["loss"] for m in run["metrics"]]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scan_ranks_match_jax_mesh(runs, case):
    check_jax_mesh(runs, case)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scan_ranks_match_one_process(runs, case):
    check_one_process(runs, case)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scan_rank_holds_its_share(runs, case):
    check_share(runs, case)


def check_jax_mesh(runs, case, scan=True):
    """Every step's loss and the eval loss against JAX's SMTTrainer on the
    same mesh (its scan state, sharded by GSPMD; scan False: its
    per-layer state), the same plan."""
    r0, want = _ranks(runs, case)[0], runs[case]["jax"]
    rtol = JAX_RTOL_INT8 if _int8(case) else JAX_RTOL
    assert r0["scan"] == scan and r0["phase"] == "sparse"
    assert r0["fingerprint"] == want["fingerprint"]
    np.testing.assert_allclose(_losses(r0), want["loss"], rtol=rtol, atol=0)
    np.testing.assert_allclose(r0["eval_loss"], want["eval_loss"], rtol=rtol)


def check_one_process(runs, case, bounds=None, scan=True):
    """Losses, grad norms, eval loss, the whole final state (gathered) and
    the export against the port in one process; every rank reports the
    same and exports the same; over the int8 base every rank's decode
    params hold the whole int8 state and the exported head. bounds: in
    place of the fsdp rule (D1_RTOL, over the int8 base D1_RTOL_INT8 on the
    losses), a mesh's own: (steps(fp16, int8) -> [(slice, loss rtol, grad
    norm rtol)], the eval rtol, state_rule(what, got, want, adam_bound) or
    None), the overflow flags then equal one process's. scan: whether the
    case trains over the scan state (False: the per-layer state)."""
    got, one = _ranks(runs, case), runs[case]["d1"]
    r0 = got[0]
    int8 = _int8(case)
    fp16 = runs[case]["cfg"].get("dtype") == "fp16"
    rtol = D1_RTOL_INT8 if int8 else D1_RTOL
    assert (r0["scan"], r0["int8"], r0["host_frozen"]) == (scan, int8, int8)
    assert (one["scan"], one["int8"], one["host_frozen"]) == (scan, int8, int8)
    assert r0["fingerprint"] == one["fingerprint"]
    for r in got[1:]:
        np.testing.assert_equal(r["metrics"], r0["metrics"])
        assert r["eval_loss"] == r0["eval_loss"] and r["fingerprint"] == r0["fingerprint"]
    state_rule = None if int8 else assert_state_close
    if bounds is None:
        np.testing.assert_allclose(_losses(r0), _losses(one), rtol=rtol, atol=0)
        if not int8:  # over the int8 base an int8 rounding flips: the norms drift ~1e-3
            np.testing.assert_allclose([m["grad_norm"] for m in r0["metrics"][N_WARMUP:]],
                                       [m["grad_norm"] for m in one["metrics"][N_WARMUP:]],
                                       rtol=rtol)
    else:
        steps, rtol, state_rule = bounds
        flags = [bool(m.get("overflow", 0.0)) for m in r0["metrics"]]
        assert flags == [bool(m.get("overflow", 0.0)) for m in one["metrics"]]
        norms = [(a.get("grad_norm", 0.0), b.get("grad_norm", 0.0)) if not f else (1.0, 1.0)
                 for a, b, f in zip(r0["metrics"], one["metrics"], flags)]
        for sl, loss_rtol, norm_rtol in steps(fp16, int8):
            np.testing.assert_allclose(_losses(r0)[sl], _losses(one)[sl], rtol=loss_rtol, atol=0)
            np.testing.assert_allclose(*zip(*norms[sl]), rtol=norm_rtol)
    np.testing.assert_allclose(r0["eval_loss"], one["eval_loss"], rtol=rtol)
    cfg = runs[case]["cfg"]
    adam_bound = 2 * (cfg["ft_learning_rate"] * cfg["full_ft_steps"]
                      + cfg["smt_lr"] * (N - cfg["full_ft_steps"]))
    if int8:   # decode_params: the whole int8 state, the head from the host store
        assert {k: v.shape for k, v in r0["decode"].items()} == \
            {k: v.shape for k, v in one["decode"].items()}
        for r in got:
            assert torch.equal(r["decode"]["lm_head"].to(torch.float32),
                               r["export"]["lm_head"].to(torch.float32))
            assert all(torch.equal(v, r0["decode"][k]) for k, v in r["decode"].items())
    for what in ("full", "export"):
        assert set(r0[what]) == set(one[what]), what
        for k, v in one[what].items():
            for r in got:
                assert torch.equal(r[what][k], r0[what][k]), (what, k)
            if state_rule is not None and not fp16:  # fsdp: test_torch_fsdp.py's rule
                state_rule(f"{what}/{k}", r0[what][k], v, adam_bound)


def check_share(runs, case, scan=True):
    """Every leaf shard_dim splits, the stacks and the host store among
    them, holds exactly 1/F of its full bytes on every rank at the end,
    and 1/T more where tensor_dim splits it too (the stacked weights, q and
    the host store; the trainables, their base and moments stay whole over
    tensor); the rest are whole; under fsdp at most one layer's gathered
    leaves were alive at a time (none gathered without it). scan False:
    the per-layer state (its layer weights in place of the stacks, no
    base)."""
    _, f, t = case[0]
    stacks = {"q", "host"} if _int8(case) else {"params/layers_stacked"} if scan else \
        {"params"}
    # over the int8 base the dense stacks left for the host store's slices
    want = stacks | {"trainable", "m", "v"} | ({"base"} if scan else set()) if f > 1 else set()
    want_t = stacks if t > 1 else set()

    def tops(keys):
        return {k.split("/")[0] if not k.startswith("params/layers_stacked") else
                "params/layers_stacked" for k in keys}

    for r, got in enumerate(_ranks(runs, case)):
        table, tdims = got["shard_bytes"][1], got["shard_tdims"]
        split = {k for k, v in table.items() if v[0] is not None}
        for k, (d, here, full) in table.items():
            assert here * (f if d is not None else 1) * (t if k in tdims else 1) == full, (r, k)
        assert tops(split) >= want, (r, tops(split))
        assert tops(tdims) >= want_t and not tops(tdims) & {"trainable", "base", "m", "v"}, \
            (r, tops(tdims))
        assert got["live_peak"] == (1 if f > 1 else 0), got["live_peak"]


def _scan_state_of_shapes(mode, n_layers=3, d=256, f=512, v=256, offload=False):
    """A scan state of numpy zeros with the port's (and JAX's) leaf paths
    and full shapes: params with layers_stacked ((L, 1) placeholders where
    offloaded), the stacked trainable / base / m / v, idx, q, q_head."""
    z = np.zeros
    _, sparse = _state_of_shapes(mode, n_layers=1, d=d, f=f, v=v)
    layer = sparse["params"]["layers"]["0"]
    mods = ("q_proj", "gate_proj", "down_proj")
    stacked = {name: z((n_layers, 1)) if offload and w.ndim == 2 else z((n_layers, *w.shape))
               for name, w in layer.items()}
    t = {m: z((n_layers, 3, 256, 256)) if mode == "matrix" else
         z((n_layers, layer[m].shape[0], 5)) for m in mods}
    idx = {m: {"valid": z((n_layers, 3), bool), **({"rb": z((n_layers, 3), np.int32),
               "cb": z((n_layers, 3), np.int32)} if mode == "matrix" else
              {"ci": z((n_layers, 5), np.int32)})} for m in mods}
    q = {m: {"wq": z((n_layers, *w.shape), np.int8), "sw": z((n_layers, w.shape[0]))}
         for m, w in layer.items() if w.ndim == 2}
    params = {k: w for k, w in sparse["params"].items() if k != "layers"}
    return {"params": {**params, "layers_stacked": stacked}, "trainable": t, "base": t,
            "m": t, "v": t, "idx": idx, "q": q, "q_head": sparse["q_head"], "step": z(())}


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("mode", ["matrix", "channel"])
@pytest.mark.parametrize("dims", [(256, 512, 256), (2048, 5632, 32000)], ids=["tiny", "tinyllama"])
def test_stacked_shard_dim_is_jax_state_shardings(f, mode, dims):
    """shard_dim of every leaf of the scan state equals the fsdp dim of
    JAX's state_shardings on a (1, F, 1) mesh, over the dense and the
    offloaded stacks; the host store's slices ("host/{key}") take the dims
    of the stacks and of the lm_head they hold."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import shard_dim
    from test_torch_fsdp import _jax_fsdp_dims
    d, ff, v = dims
    for offload in (False, True):
        state = _scan_state_of_shapes(mode, d=d, f=ff, v=v, offload=offload)
        want = _jax_fsdp_dims(state, f, mode)
        shapes = {"/".join(p.key for p in path): leaf.shape
                  for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
        got = {k: shard_dim(k, shape, mode, f) for k, shape in shapes.items()}
        assert got == want
        assert {k.split("/")[0] for k, x in got.items() if x is not None} >= \
            {"trainable", "base", "m", "v", "q"}
    dense = _scan_state_of_shapes(mode, d=d, f=ff, v=v)["params"]
    for name, w in dense["layers_stacked"].items():
        if w.ndim == 3:
            assert shard_dim(f"host/{name}", w.shape, mode, f) == \
                shard_dim(f"params/layers_stacked/{name}", w.shape, mode, f)
    assert shard_dim("host/lm_head", dense["lm_head"].shape, mode, f) == 1


@pytest.mark.parametrize("mode", ["matrix", "channel"])
def test_scan_fsdp_checkpoint_resumes_bit_for_bit(tmp_path, mode):
    """A checkpoint at (1, 2, 1) one step into the sparse phase over the
    int8 scan state (each rank its state.fsdp{f}.pt and frozen_host.fsdp{f}.pt)
    resumes bit for bit on both ranks, host store included; a restore at
    (2, 1, 1) is refused by name."""
    model = {**MODEL, "num_hidden_layers": 2}
    params = tp.port_params(jax_init_params(jax.random.PRNGKey(0), JAX_CFG))
    torch.save(params, tmp_path / "params.pt")
    torch.save(batches(N_WARMUP + 3), tmp_path / "batches.pt")
    cfg = _cfg(mode, frozen_quant="int8", output_dir=str(tmp_path / "out"), **_ON)
    spec = {"cfg": cfg, "model": model, "total_steps": N_WARMUP + 3,
            "params": str(tmp_path / "params.pt"), "batches": str(tmp_path / "batches.pt")}
    ranks.spawn(ranks.checkpoint_ranks, 2, tmp_path, spec, N_WARMUP + 1, str(tmp_path),
                (1, 2, 1), (2, 1, 1))
    got = [torch.load(tmp_path / f"ckpt.{r}.pt", weights_only=False) for r in range(2)]
    for r, g in enumerate(got):
        assert g["saved_phase"] == "sparse" and g["phase"] == "sparse"
        assert g["resumed"] == g["straight"], r
        for i, (a, b) in enumerate(zip(g["resumed_sums"], g["straight_sums"])):
            differ = sorted(k for k in a if a[k] != b.get(k))
            assert set(a) == set(b) and not differ, f"rank {r} step {i + 1}: {differ}"
        for k, v in g["straight_leaves"].items():
            assert torch.equal(g["resumed_leaves"][k], v), k
        assert g["host_equal"] and "lm_head" in g["host_keys"], g["host_keys"]
        assert g["refusal"] is not None and "--mesh_shape 1,2,1" in g["refusal"], g["refusal"]
    assert got[0]["straight"] == got[1]["straight"]
    assert sorted(p.name for p in (tmp_path / "out" / "ckpt").glob("*.pt")) == \
        ["frozen_host.fsdp0.pt", "frozen_host.fsdp1.pt", "state.fsdp0.pt", "state.fsdp1.pt"]
