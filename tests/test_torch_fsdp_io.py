"""The fsdp axis's IO on the CPU (tests/test_torch_fsdp.py holds the steps):
gloo ranks spawned by torch.multiprocessing (tests/torch_dp_ranks.py,
which imports no JAX).

  * a checkpoint written at (1, 2, 1) (each rank its shards, rank 0 the
    meta) resumes bit for bit on both ranks, mid warm-up and mid sparse
    phase; a restore at (2, 1, 1) is refused by name;
  * `cli.fine_tune` under torchrun's environment without --mesh_shape
    takes JAX's default mesh (1, 2, 1), loads its shards of the checkpoint
    (load_hf_params_sharded) and trains to an export equal to the
    one-process CLI's at the same global batch;
  * load_hf_params_sharded's slices equal load_hf_params' tensors and the
    JAX package's sharded load, shard for shard;
  * the scan layouts run under fsdp (the "auto" scan at 12 layers, the CLI
    with --scan_layers on); --sparse_from_plan is refused on an fsdp mesh.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp
from test_torch_fsdp import assert_state_close
from test_torch_parallel import D1_RTOL, D1_RTOL_INT8, MODEL, N_WARMUP, _cfg, batches
from test_cli import tiny_hf_dir  # noqa: F401
from test_torch_parallel_eval import _fine_tune_args, tiny_hf  # noqa: F401

from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params

SHAPE = (1, 2, 1)


@pytest.mark.parametrize("stop", [1, N_WARMUP + 1], ids=["warmup", "sparse"])
def test_fsdp_checkpoint_resumes_bit_for_bit_and_refuses_d2(tmp_path, stop):
    params = tp.port_params(jax_init_params(jax.random.PRNGKey(0),
                                            JaxLlamaConfig.tiny(vocab_size=256)))
    torch.save(params, tmp_path / "params.pt")
    torch.save(batches(N_WARMUP + 3), tmp_path / "batches.pt")
    cfg = _cfg(output_dir=str(tmp_path / "out"))
    spec = {"cfg": cfg, "model": MODEL, "total_steps": N_WARMUP + 3,
            "params": str(tmp_path / "params.pt"), "batches": str(tmp_path / "batches.pt")}
    ranks.spawn(ranks.checkpoint_ranks, 2, tmp_path, spec, stop, str(tmp_path), SHAPE,
                (2, 1, 1))
    got = [torch.load(tmp_path / f"ckpt.{r}.pt", weights_only=False) for r in range(2)]
    for r, g in enumerate(got):
        assert g["saved_phase"] == ("warmup" if stop <= N_WARMUP else "sparse")
        assert g["phase"] == "sparse" and g["resumed"] == g["straight"], r
        for i, (a, b) in enumerate(zip(g["resumed_sums"], g["straight_sums"])):
            differ = sorted(k for k in a if a[k] != b.get(k))
            assert set(a) == set(b) and not differ, f"rank {r} step {i + 1}: {differ}"
        assert g["fingerprints"][0] == g["fingerprints"][1]
        for k, v in g["straight_leaves"].items():
            assert torch.equal(g["resumed_leaves"][k], v), k
        assert g["refusal"] is not None and "--mesh_shape 1,2,1" in g["refusal"], g["refusal"]
    assert got[0]["straight"] == got[1]["straight"]
    # the ranks hold different shards of the same state
    assert got[0]["straight_sums"][-1] != got[1]["straight_sums"][-1]
    meta = json.loads((tmp_path / "out" / "ckpt" / "meta.json").read_text())
    assert meta["mesh"] == list(SHAPE)
    assert sorted(p.name for p in (tmp_path / "out" / "ckpt").glob("state*.pt")) == \
        ["state.fsdp0.pt", "state.fsdp1.pt"]


def test_fine_tune_cli_default_mesh_is_fsdp(tiny_hf, tmp_path):  # noqa: F811
    """WORLD_SIZE 2 without --mesh_shape: (1, 2, 1), JAX's default; the
    losses, eval losses, plan and exported weights equal the one-process
    CLI's at the same global batch."""
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    from sparse_matrix_tuning_tpu_torch.models.hf_io import read_safetensors
    argv = _fine_tune_args(tiny_hf, tmp_path / "f2", 2)
    ranks.spawn(ranks.cli_ranks, 2, tmp_path, "sparse_matrix_tuning_tpu_torch.cli.fine_tune",
                argv, str(tmp_path))
    got = [torch.load(tmp_path / f"cli.{r}.pt", weights_only=False)["result"] for r in range(2)]
    want = main(_fine_tune_args(tiny_hf, tmp_path / "d1", 4))
    assert got[0] == got[1]
    assert len(got[0]["train_loss"]) == len(want["train_loss"]) == 3
    np.testing.assert_allclose(got[0]["train_loss"], want["train_loss"], rtol=D1_RTOL, atol=0)
    np.testing.assert_allclose(got[0]["eval_loss"], want["eval_loss"], rtol=D1_RTOL, atol=0)
    f2, d1 = tmp_path / "f2" / "final", tmp_path / "d1" / "final"
    assert (f2 / "smt_plan.json").read_text() == (d1 / "smt_plan.json").read_text()
    a, b = (read_safetensors(str(p / "model.safetensors")) for p in (f2, d1))
    assert set(a) == set(b)
    for k in b:  # three steps at lr 1e-3 (test_torch_fsdp.py's rule for the final state)
        assert_state_close(k, a[k], b[k], adam_bound=2 * 3 * 1e-3)


@pytest.mark.parametrize("f", [2, 4])
def test_sharded_load_is_slices_of_the_full_load(f, tiny_hf_dir):  # noqa: F811
    """Each rank's load_hf_params_sharded equals its slices of
    load_hf_params' tensors bit for bit, and the JAX package's sharded load
    on a (1, F, 1) mesh shard for shard (tests/test_sharded_load.py's
    checkpoint)."""
    from sparse_matrix_tuning_tpu.models.hf_io import (
        load_hf_params_sharded as jax_load_sharded)
    from sparse_matrix_tuning_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from sparse_matrix_tuning_tpu_torch.models.hf_io import (
        load_hf_config, load_hf_params, load_hf_params_sharded)
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh
    d = tiny_hf_dir
    cfg = load_hf_config(d)
    full = flatten_tree(load_hf_params(d, cfg, dtype=torch.float32))
    jmesh = jax_make_mesh((1, f, 1), jax.devices()[:f])
    jax_tree = jax_load_sharded(d, jmesh, None, dtype=np.float32)
    jax_flat = {"/".join(p.key for p in path): a
                for path, a in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    split = 0
    for i in range(f):
        params, sh = load_hf_params_sharded(d, Mesh((1, f, 1), i, torch.device("cpu")), cfg,
                                            dtype=torch.float32)
        mine = flatten_tree(params)
        assert set(mine) == set(full) == set(jax_flat)
        device = jmesh.devices[0, i, 0]
        for k, t in mine.items():
            dim = sh.dim(f"master/{k}")
            want = full[k] if dim is None else full[k].chunk(f, dim)[i]
            assert torch.equal(t, want), k
            shard = [s for s in jax_flat[k].addressable_shards if s.device == device][0]
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data), err_msg=k)
            split += dim is not None
    assert split > 0


@pytest.mark.parametrize("what", ["auto at depth", "scan_layers on", "sparse_from_plan"])
def test_scan_layouts_refused_under_fsdp(what, tiny_hf, tmp_path):  # noqa: F811
    """The scan layouts run under fsdp: the "auto" scan of channel + int8
    at 12 layers over two gloo ranks at (1, 2, 1) against one process (the
    int8 scan state, its host store of slices), and `cli.fine_tune
    --scan_layers on` under torchrun's environment without --mesh_shape
    (JAX's default (1, 2, 1)) against the one-process CLI. The
    continuation's entry (--sparse_from_plan) stays refused on any fsdp
    mesh: JAX's runs on one device (tests/test_torch_parallel.py has the
    config's refusal)."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh
    from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    if what == "sparse_from_plan":
        mesh = Mesh((1, 2, 1), 0, torch.device("cpu"))
        deep = LlamaConfig(**{**MODEL, "num_hidden_layers": 12})
        with pytest.raises(NotImplementedError,
                           match=r"sparse_scan_from_hf.*\(1, 2, 1\).*runs on one device"):
            SMTTrainer.sparse_scan_from_hf(SMTConfig(**_cfg("channel")), "unused",
                                           SMTPlan("channel"), 4, model_cfg=deep, mesh=mesh)
        return
    if what == "scan_layers on":
        from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
        from sparse_matrix_tuning_tpu_torch.models.hf_io import read_safetensors
        argv = _fine_tune_args(tiny_hf, tmp_path / "f2", 2) + ["--scan_layers", "on"]
        ranks.spawn(ranks.cli_ranks, 2, tmp_path, "sparse_matrix_tuning_tpu_torch.cli.fine_tune",
                    argv, str(tmp_path))
        got = [torch.load(tmp_path / f"cli.{r}.pt", weights_only=False)["result"]
               for r in range(2)]
        want = main(_fine_tune_args(tiny_hf, tmp_path / "d1", 4) + ["--scan_layers", "on"])
        assert got[0] == got[1] and len(got[0]["train_loss"]) == 3
        np.testing.assert_allclose(got[0]["train_loss"], want["train_loss"], rtol=D1_RTOL, atol=0)
        np.testing.assert_allclose(got[0]["eval_loss"], want["eval_loss"], rtol=D1_RTOL, atol=0)
        f2, d1 = tmp_path / "f2" / "final", tmp_path / "d1" / "final"
        assert (f2 / "smt_plan.json").read_text() == (d1 / "smt_plan.json").read_text()
        a, b = (read_safetensors(str(p / "model.safetensors")) for p in (f2, d1))
        assert set(a) == set(b)
        for k in b:
            assert_state_close(k, a[k], b[k], adam_bound=2 * 3 * 1e-3)
        return
    jcfg = JaxLlamaConfig.tiny(vocab_size=256)
    params = tp.port_params(jax_init_params(jax.random.PRNGKey(0),
                                            dataclasses.replace(jcfg, num_hidden_layers=12)))
    torch.save(params, tmp_path / "params.pt")
    torch.save(batches(N_WARMUP + 2), tmp_path / "batches.pt")
    torch.save(batches(1, seed=9), tmp_path / "eval.pt")
    spec = {"name": "auto", "cfg": _cfg("channel", frozen_quant="int8"),
            "model": {**MODEL, "num_hidden_layers": 12}, "total_steps": N_WARMUP + 2,
            "params": str(tmp_path / "params.pt"), "batches": str(tmp_path / "batches.pt"),
            "eval_batches": str(tmp_path / "eval.pt")}
    ranks.spawn(ranks.train_ranks, 2, tmp_path, [spec], str(tmp_path), SHAPE)
    got = [torch.load(tmp_path / f"auto.{r}.pt", weights_only=False) for r in range(2)]
    one = ranks.run_scenario(spec)
    for r, g in enumerate(got):
        assert "error" not in g, f"rank {r}: {g['error']}"
        assert (g["scan"], g["int8"], g["host_frozen"], g["phase"]) == (True, True, True, "sparse")
        assert g["fingerprint"] == one["fingerprint"] and g["metrics"] == got[0]["metrics"]
        host = {k: v for k, v in g["shard_bytes"][1].items() if k.startswith("host/")}
        assert host and all(d is not None and 2 * here == full
                            for d, here, full in host.values()), host
    np.testing.assert_allclose([m["loss"] for m in got[0]["metrics"]],
                               [m["loss"] for m in one["metrics"]], rtol=D1_RTOL_INT8, atol=0)
