"""Rank processes of the multi-process tests (tests/test_torch_parallel*.py,
tests/test_torch_fsdp.py).

The targets of torch.multiprocessing.spawn live in this module, which
imports no JAX, so that a rank imports only torch and the port. Each rank
joins a gloo group through a file:// store under the test's tmp_path
(never a fixed port: the suite runs in parallel workers; a collective that
waits longer than TIMEOUT_S fails the rank instead of hanging), builds a
parallel/mesh.Mesh of (world, 1, 1) or of the (data, fsdp, 1) shape it is
given (or of the (data, fsdp, tensor) shape), runs every scenario it is
given on its rows of the global batches, and writes what it saw to
{out_dir}/{name}.{rank}.pt. A scenario that raises writes its traceback
instead, so that only its own test fails.

run_scenario is shared with the tests' one-process (D=1) runs: the same
code at mesh None, at the ranks' one intra-op thread.

Each rank dies with the process that spawned it (a pytest worker lost
mid-spawn leaves no rank waiting out its collectives), and each spawn
prints its wall to stderr.
"""
from __future__ import annotations

import os
import signal
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, flatten_tree, lm_head_weight
from sparse_matrix_tuning_tpu_torch.parallel.mesh import (
    Mesh, init_distributed, leaf_checksums, make_mesh)
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer


TIMEOUT_S = 120


def spawn(target, world: int, tmp_path, *args):
    """Run target(rank, world, store, *args) in `world` spawned processes."""
    store = os.path.join(str(tmp_path), "store")
    t0 = time.monotonic()
    try:
        mp.spawn(target, args=(world, store, *args), nprocs=world, join=True)
    finally:
        print(f"[spawn] {getattr(target, '__name__', target)} x{world}: "
              f"{time.monotonic() - t0:.1f} s", file=sys.stderr, flush=True)


def _die_with_parent() -> None:
    """Linux: SIGKILL this process when the process that spawned it dies
    (prctl PR_SET_PDEATHSIG)."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL), 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _join(rank: int, world: int, store: str, shape=None):
    _die_with_parent()
    torch.set_num_threads(1)
    device = init_distributed(torch.device("cpu"), init_method=f"file://{store}",
                              rank=rank, world_size=world, timeout_s=TIMEOUT_S)
    return make_mesh(shape or (world, 1, 1), device=device)


def state_leaves(trainer):
    return flatten_tree({k: v for k, v in trainer.state.items() if k != "sched"})


def build_trainer(spec, mesh=None):
    cfg = SMTConfig(**spec["cfg"], mesh_shape=list(mesh.shape) if mesh else None)
    model_cfg = LlamaConfig(**spec["model"])
    if "from_hf" in spec:
        with open(spec["plan"]) as f:
            plan = SMTPlan.from_json(f.read())
        return SMTTrainer.sparse_scan_from_hf(cfg, spec["from_hf"], plan, spec["total_steps"],
                                              model_cfg=model_cfg, device="cpu", mesh=mesh)
    params = torch.load(spec["params"], weights_only=True)
    return SMTTrainer(cfg, model_cfg, params, spec["total_steps"], device="cpu", mesh=mesh)


def full_state(trainer):
    """The sparse state's params, trainables and moments, whole, on the
    host (gathered under fsdp)."""
    sh = trainer.sharding
    out = {}
    for top in ("params", "trainable", "m", "v"):
        for k, t in flatten_tree(trainer.state[top]).items():
            path = f"{top}/{k}"
            out[path] = (t if sh is None else sh.full(path, t)).detach().to("cpu", copy=True)
    return out


def shard_bytes(trainer):
    """{state path: (dim, bytes here, the full leaf's bytes)} of the
    state's tensors and of the host store ("host/{key}") (under fsdp; {}
    without)."""
    sh = trainer.sharding
    if sh is None:
        return {}
    leaves = {**state_leaves(trainer),
              **{f"host/{k}": t for k, t in (trainer._host_frozen or {}).items()}}
    return {k: (sh.dim(k), t.numel() * t.element_size(),
                int(torch.Size(sh.full_shape(k, t)).numel()) * t.element_size())
            for k, t in leaves.items()}


def shard_tdims(trainer):
    """{state path: tensor dim} of the state's leaves and of the host store
    ("host/{key}") split over tensor ({} without a sharding)."""
    sh = trainer.sharding
    if sh is None:
        return {}
    keys = list(state_leaves(trainer)) + [f"host/{k}" for k in (trainer._host_frozen or {})]
    return {k: sh.tdim(k) for k in keys if sh.tdim(k) is not None}


def run_scenario(spec, mesh=None):
    """Train on spec's global batches; returns the metrics of every step,
    the plan's fingerprint, the eval loss, the state's leaf checksums, the
    all-reduce's counters, the whole final state (full_state) and, under
    fsdp, the bytes of the shards after the warm-up and at the end
    (shard_bytes, with the tensor dims of the final ones in shard_tdims)
    and the most gathered layers alive at once; with
    spec["export"] the merged params of the HF export (trainer.
    merged_params, collective under fsdp), flat, and over the int8 scan
    state the decode params' head and int8 layers (trainer.decode_params,
    collective too)."""
    if mesh is not None:
        return _scenario(spec, mesh)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the reference: at the ranks' thread count
    try:
        return _scenario(spec, None)
    finally:
        torch.set_num_threads(threads)


def _scenario(spec, mesh):
    from sparse_matrix_tuning_tpu_torch.parallel import fsdp
    trainer = build_trainer(spec, mesh)
    batches = torch.load(spec["batches"], weights_only=False)
    n_master = sum(t.numel() for t in flatten_tree(trainer.state.get("master", {})).values())
    warm_bytes = shard_bytes(trainer)
    warm_shapes = {k: tuple(t.shape) for k, t in state_leaves(trainer).items()}
    fsdp.LIVE.update(now=0, peak=0)
    metrics = []
    for b in batches:
        before = dict(mesh.stats) if mesh is not None else {"bytes": 0}
        m = {k: float(v) for k, v in trainer.train_step(b).items()}
        if mesh is not None:
            m["reduced_bytes"] = mesh.stats["bytes"] - before["bytes"]
        metrics.append(m)
    eval_loss = trainer.evaluate(torch.load(spec["eval_batches"], weights_only=False))[1]
    export = flatten_tree(trainer.merged_params()) if spec.get("export") else None
    decode = None
    if spec.get("export") and trainer._scan and "q" in trainer.state:
        p = trainer.decode_params()   # collective under fsdp
        decode = flatten_tree({"lm_head": lm_head_weight(p, trainer.model_cfg),
                               "q": p["layers_q8"]["q"],
                               "t": p["layers_q8"]["t"], "base": p["layers_q8"]["base"]})
    tokens = None
    if spec.get("generate"):  # greedy decode from the gathered weights (collective)
        from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig, generate
        ids = torch.tensor([[0, 0, 5, 9, 17, 3], [0, 11, 4, 4, 8, 30]])
        tokens = generate(trainer.decode_params(), trainer.model_cfg, ids, (ids > 0).int(),
                          GenerationConfig(max_new_tokens=6, eos_token_id=-1), device="cpu")
    sh = trainer.sharding
    return {"metrics": metrics, "export": export, "decode": decode, "fingerprint": trainer.plan.fingerprint(),
            "full": full_state(trainer), "shard_bytes": (warm_bytes, shard_bytes(trainer)),
            "live_peak": fsdp.LIVE["peak"],
            "n_master": n_master,
            "n_trainable": sum(t.numel() for t in trainer.state["trainable"].values()),
            "eval_loss": eval_loss, "checksums": leaf_checksums(state_leaves(trainer)),
            "phase": trainer.phase, "scan": trainer._scan,
            "host_frozen": trainer._host_frozen is not None, "int8": "q" in trainer.state,
            "stats": dict(mesh.stats) if mesh is not None else None, "tokens": tokens,
            "tdims": sorted(sh.tdims) if sh is not None else [],
            "shard_tdims": shard_tdims(trainer),
            "host_shapes": {f"host/{k}": tuple(t.shape)
                            for k, t in (trainer._host_frozen or {}).items()},
            "shapes": (warm_shapes, {k: tuple(t.shape) for k, t in state_leaves(trainer).items()})}


def overflow_probe(mesh):
    """A planted inf in one tensor rank's slice of a tensor-split grad: the
    clip norm (steps.sharded_global_norm) is inf and unscale_and_check
    skips the step on every rank, stepping every rank's scaler alike."""
    from functools import partial
    from sparse_matrix_tuning_tpu_torch.train.steps import sharded_global_norm, unscale_and_check
    grads = {"split": torch.full((4, 3), 2.0), "whole": torch.ones(5)}
    if mesh.tensor_index == mesh.tensor - 1:
        grads["split"][1, 2] = float("inf")
    state = {"loss_scale": torch.tensor(1024.0), "good_steps": torch.tensor(7, dtype=torch.int32)}
    cfg = SMTConfig(**{"data_path": ["x"], "model_name_or_path": "m", "dtype": "fp16"})
    norm_of = partial(sharded_global_norm, mesh=mesh, sharded=(), tensor_split={"split"})
    _, _, norm, metrics, finite = unscale_and_check(torch.tensor(3.0), grads, state, cfg, norm_of)
    clean = sharded_global_norm({"split": torch.full((4, 3), 2.0), "whole": torch.ones(5)},
                                mesh, (), {"split"})
    return {"finite": finite, "norm": float(norm), "scale": float(state["loss_scale"]),
            "good": int(state["good_steps"]), "clean_norm": float(clean)}


def run_cli(spec, mesh):
    """spec["module"]'s main(spec["argv"]) as torchrun starts it, in the
    process group the ranks joined (the CLI takes it, makes its own mesh and
    ends the group: the last spec of a spawn)."""
    import importlib
    # torchrun's environment; the group is joined already, so the CLI's
    # init_distributed takes it (MASTER_ADDR only names the env:// method)
    os.environ.update(RANK=str(mesh.rank), WORLD_SIZE=str(mesh.world),
                      LOCAL_RANK=str(mesh.rank), MASTER_ADDR="localhost")
    out = importlib.import_module(spec["module"]).main(list(spec["argv"]))
    return {"result": {k: list(v) for k, v in out.items()}}


def train_ranks(rank: int, world: int, store: str, specs, out_dir: str, shape=None):
    """Each spec on this rank: a training scenario (run_scenario), or by
    spec["probe"] the overflow probe, a checkpoint scenario (spec["stop"])
    or a CLI run (run_cli, last)."""
    mesh = _join(rank, world, store, shape)
    for spec in specs:
        try:
            probe = spec.get("probe")
            out = overflow_probe(mesh) if probe == "overflow" else \
                checkpoint_scenario(spec, spec["stop"], mesh) if probe == "checkpoint" else \
                run_cli(spec, mesh) if probe == "cli" else run_scenario(spec, mesh)
        except Exception:  # recorded: the scenario's own test reports it
            out = {"error": traceback.format_exc()}
        torch.save(out, os.path.join(out_dir, f"{spec['name']}.{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def checkpoint_ranks(rank: int, world: int, store: str, spec, stop: int, out_dir: str,
                     shape=None, refuse_at=None):
    """checkpoint_scenario on every rank, written to {out_dir}/ckpt.{rank}.pt."""
    mesh = _join(rank, world, store, shape)
    torch.save(checkpoint_scenario(spec, stop, mesh, refuse_at),
               os.path.join(out_dir, f"ckpt.{rank}.pt"))
    dist.destroy_process_group()


def checkpoint_scenario(spec, stop: int, mesh, refuse_at=None):
    """A straight run and the same stopped after step `stop`
    (trainer._save_resumable: rank 0 writes between barriers; under fsdp
    each rank its shards) and resumed in a fresh trainer on every rank: the
    losses and the leaf checksums after every step (the warm-up's
    accumulators included), the plans' fingerprints and the last leaves of
    both; with refuse_at, the error of a restore into a trainer on a mesh
    of that shape (over the same ranks)."""
    from sparse_matrix_tuning_tpu_torch.train.checkpoint import restore_checkpoint
    batches = torch.load(spec["batches"], weights_only=False)

    def steps(trainer, bs):
        out = []
        for b in bs:
            loss = float(trainer.train_step(b)["loss"])
            out.append((loss, leaf_checksums(state_leaves(trainer))))
        return out

    straight = build_trainer(spec, mesh)
    s_steps = steps(straight, batches)
    first = build_trainer(spec, mesh)
    r_steps = steps(first, batches[:stop])
    saved_phase = first.phase
    first._save_resumable()
    resumed = build_trainer(spec, mesh)
    restore_checkpoint(os.path.join(spec["cfg"]["output_dir"], "ckpt"), resumed)
    r_steps += steps(resumed, batches[stop:])
    refusal = None
    if refuse_at is not None:
        other = Mesh(tuple(refuse_at), mesh.rank, mesh.device, cpu_group=mesh.cpu_group)
        try:
            restore_checkpoint(os.path.join(spec["cfg"]["output_dir"], "ckpt"),
                               build_trainer(spec, other))
        except ValueError as e:
            refusal = str(e)
    hosts = [t._host_frozen or {} for t in (straight, resumed)]
    return {"refusal": refusal, "straight": [x[0] for x in s_steps],
            "resumed": [x[0] for x in r_steps],
            "host_equal": hosts[0].keys() == hosts[1].keys() and all(
                torch.equal(hosts[0][k], hosts[1][k]) for k in hosts[0]),
            "host_keys": sorted(hosts[0]),
            "straight_sums": [x[1] for x in s_steps],
            "resumed_sums": [x[1] for x in r_steps],
            "saved_phase": saved_phase, "phase": resumed.phase,
            "fingerprints": (straight.plan.fingerprint(), resumed.plan.fingerprint()),
            "straight_leaves": {k: v.detach().clone() for k, v in state_leaves(straight).items()},
            "resumed_leaves": {k: v.detach().clone() for k, v in state_leaves(resumed).items()}}


def cli_ranks(rank: int, world: int, store: str, module: str, argv, out_dir: str):
    """A CLI's main(argv) as torchrun starts it: RANK, WORLD_SIZE and the
    rendezvous in the environment (a file:// store in place of
    MASTER_ADDR), the CLI initialising the group itself."""
    import importlib
    _die_with_parent()
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    from sparse_matrix_tuning_tpu_torch.parallel import mesh as mesh_mod
    init = mesh_mod.init_distributed

    def file_store_init(device=None, backend=None, init_method=None, **kw):
        return init(device, backend, init_method or f"file://{store}", timeout_s=TIMEOUT_S,
                    **kw)

    mesh_mod.init_distributed = file_store_init
    out = importlib.import_module(module).main(list(argv))
    torch.save({"result": out if not isinstance(out, dict) or "train_loss" not in out
                else {k: list(v) for k, v in out.items()}},
               os.path.join(out_dir, f"cli.{rank}.pt"))
