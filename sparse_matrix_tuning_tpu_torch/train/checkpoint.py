"""Checkpoint and resume of an SMTTrainer (twin of
`sparse_matrix_tuning_tpu.train.checkpoint`, a capability the reference
lacks: its saves are HF-format weights only).

A checkpoint directory holds the whole train state, so a run resumes mid
warm-up (with its saliency accumulators) or mid sparse phase, over the
per-layer state or the stacked scan state:

  state.pt         the state's tensors keyed by "/"-joined path (integer
                   leaves and the scan state's "idx" included), torch.save;
                   read back only with weights_only=True, onto the trainer's
                   device. The scan state's "sched" is not saved: the
                   trainer rebuilds it (scan_phase.attach_schedules).
  frozen_host.pt   the host store of frozen weights (trainer._host_frozen),
                   when there is one
  state.fsdp{f}.pt in place of state.pt under fsdp (F > 1): the shards of
                   fsdp index f, written by the rank of data index 0 that
                   holds them (the data group's ranks hold equal shards),
                   read by every rank of fsdp index f; an Orbax save of
                   sharded arrays is a collective in the JAX package too;
                   frozen_host.fsdp{f}.pt likewise, the slices of the scan
                   state's host store; under the tensor axis (T > 1)
                   state.fsdp{f}.tensor{t}.pt, the shards of the ranks at
                   (fsdp f, tensor t)
  meta.json        phase, step, total_steps, best_eval_loss, dtype (a restore
                   under another --dtype is refused: fp16 states carry the
                   loss scaler's "loss_scale" and "good_steps"), mesh (a
                   restore at another (data, fsdp, tensor) is refused by
                   name: fit's batch skip counts global batches, and the
                   shards are the saving mesh's); in the sparse phase
                   "resolved": the
                   layout the state was built in
  config.json, plan.json

torch.save rather than safetensors: the integer and boolean leaves and the
bf16 host store load as they were saved. Resume needs no RNG state: the
dropout masks are derived from (seed, step, layer) (models/llama.py).
Over data alone rank 0 writes (trainer._save_resumable) and every rank
restores the same files; under fsdp every rank calls save_checkpoint and
rank 0 writes the meta, config and plan.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan

STATE_FILE, HOST_FILE = "state.pt", "frozen_host.pt"
META_FILE, CONFIG_FILE, PLAN_FILE = "meta.json", "config.json", "plan.json"
RESOLVED_KEYS = ("scan", "host_offload", "frozen_quant", "head_quant")


def _tensors(state: Dict) -> Dict[str, torch.Tensor]:
    """The state's tensor leaves keyed by "/"-joined path ("sched", the
    scan state's schedules, is rebuilt and not saved)."""
    return flatten_tree({k: v for k, v in state.items() if k != "sched"})


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, t in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def _save(obj, path: str) -> None:
    """torch.save through a temporary file, so that an interrupted save
    leaves the last complete checkpoint in place."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _resolved_layout(trainer) -> Dict:
    """The layout a sparse-phase trainer's state was built in: the keys
    whose change alters the state's structure."""
    from sparse_matrix_tuning_tpu_torch.train.convert import resolve_frozen_quant
    return {"scan": bool(trainer._scan),
            "host_offload": trainer._host_frozen is not None,
            "frozen_quant": resolve_frozen_quant(trainer.cfg, trainer.plan.mode,
                                                 scan=bool(trainer._scan)),
            "head_quant": "int8" if "q_head" in trainer.state else "none"}


def _predicted_layout(cfg, model_cfg, plan: SMTPlan, mesh=None) -> Dict:
    """The layout a warm-up trainer's conversion would build for `plan`,
    from the resolvers the trainer's maybe_convert uses."""
    from sparse_matrix_tuning_tpu_torch.train.convert import (
        frozen_offload_active, resolve_frozen_quant, resolve_head_quant)
    from sparse_matrix_tuning_tpu_torch.train.scan_phase import resolve_scan_layers
    scan = resolve_scan_layers(cfg, model_cfg, plan.mode)
    fq = resolve_frozen_quant(cfg, plan.mode, scan=scan)
    return {"scan": scan,
            "host_offload": frozen_offload_active(cfg, plan.mode, scan=scan, mesh=mesh),
            "frozen_quant": fq, "head_quant": resolve_head_quant(cfg, model_cfg, fq)}


def _state_file(trainer, name: str = STATE_FILE) -> str:
    """state.pt or frozen_host.pt, or under fsdp / tensor this rank's
    shards' file (state.fsdp{f}.pt at tensor 1, as before the tensor axis,
    state.fsdp{f}.tensor{t}.pt above)."""
    if trainer.sharding is None:
        return name
    stem, ext = os.path.splitext(name)
    mesh = trainer.mesh
    tensor = f".tensor{mesh.tensor_index}" if mesh.tensor > 1 else ""
    return f"{stem}.fsdp{mesh.fsdp_index}{tensor}{ext}"


def save_checkpoint(path: str, trainer) -> None:
    """Write the trainer's state, host store, plan and meta into `path`.
    Under fsdp every rank calls it: the ranks of data index 0 write their
    shards, rank 0 the rest."""
    os.makedirs(path, exist_ok=True)
    mesh = trainer.mesh
    if trainer.sharding is None or mesh.data_index == 0:
        _save({k: v.detach() for k, v in _tensors(trainer.state).items()},
              os.path.join(path, _state_file(trainer)))
        host_path = os.path.join(path, _state_file(trainer, HOST_FILE))
        if trainer._host_frozen is not None:
            _save(trainer._host_frozen, host_path)
        elif os.path.exists(host_path):
            os.remove(host_path)
    if mesh is not None and not mesh.is_main:
        return
    meta = {"phase": trainer.phase, "step": trainer.step, "total_steps": trainer.total_steps,
            "best_eval_loss": trainer.best_eval_loss, "dtype": trainer.cfg.dtype,
            "mesh": _mesh_shape(trainer)}
    if trainer.phase == "sparse" and trainer.plan is not None:
        # a restore under other flags then fails with the keys named
        meta["resolved"] = _resolved_layout(trainer)
    _write_text(os.path.join(path, CONFIG_FILE), trainer.cfg.to_json())
    plan_path = os.path.join(path, PLAN_FILE)
    if trainer.plan is not None:
        _write_text(plan_path, trainer.plan.to_json())
    elif os.path.exists(plan_path):
        os.remove(plan_path)
    _write_text(os.path.join(path, META_FILE), json.dumps(meta))


def _mesh_shape(trainer) -> list:
    return list(trainer.mesh.shape) if trainer.mesh is not None else [1, 1, 1]


def _check_layout(saved: Optional[Dict], now: Dict) -> None:
    if saved is None:
        return
    diffs = {k: (saved[k], now[k]) for k in RESOLVED_KEYS if k in saved and saved[k] != now[k]}
    if not diffs:
        return
    hints = []
    if "frozen_quant" in diffs:
        hints.append(f"set --frozen_quant to the saved value ({diffs['frozen_quant'][0]!r})")
    if "scan" in diffs:
        hints.append(f"set --scan_layers {'on' if diffs['scan'][0] else 'off'} to match the "
                     "saved state layout")
    if "head_quant" in diffs:
        hints.append(f"set --head_quant explicitly to the saved value "
                     f"({diffs['head_quant'][0]!r}) — 'auto' follows the frozen base")
    if "host_offload" in diffs:
        hints.append(("drop --no_frozen_host_offload" if diffs["host_offload"][0]
                      else "pass --no_frozen_host_offload") + " to match the saved host store")
    raise ValueError("checkpoint was saved with a different resolved sparse-phase layout: "
                     f"{{key: (saved, now)}} = {diffs}. " + "; ".join(hints))


def _spec(t: torch.Tensor):
    return tuple(t.shape), t.dtype


def _check_leaves(what: str, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
    """One error naming every missing, unexpected or reshaped leaf."""
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    differ = {k: (_spec(got[k]), _spec(want[k])) for k in sorted(set(got) & set(want))
              if _spec(got[k]) != _spec(want[k])}
    if missing or extra or differ:
        raise ValueError(
            f"checkpoint {what} does not match the trainer's: missing {missing[:8]}"
            f"{' ...' if len(missing) > 8 else ''}, unexpected {extra[:8]}"
            f"{' ...' if len(extra) > 8 else ''}, (saved, expected) shape and dtype "
            f"{dict(list(differ.items())[:8])}{' ...' if len(differ) > 8 else ''} — was it "
            "written for another model, mode or config?")


def restore_checkpoint(path: str, trainer) -> None:
    """Restore state, phase, plan and host store into an SMTTrainer built
    with the same config and model, on the device it was built for.

    A sparse-phase checkpoint restored into a warm-up trainer converts it
    as the checkpoint's run did: the layout it would build now must equal
    the saved one (a ValueError names each key that differs), the trainer
    takes the plan, its scan flag and host store, and installs the sparse
    phase (the scan schedules are rebuilt, never loaded). Every leaf must
    have the key, shape and dtype the trainer expects, and the checkpoint's
    --dtype must be the trainer's (a ValueError names both)."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("dtype", trainer.cfg.dtype) != trainer.cfg.dtype:
        raise ValueError(f"checkpoint was saved with --dtype {meta['dtype']} but the trainer runs "
                         f"--dtype {trainer.cfg.dtype}: its parameters and its loss-scaler state "
                         f"(fp16 only) do not carry over; resume with --dtype {meta['dtype']}")
    saved_mesh, mesh = meta.get("mesh", [1, 1, 1]), _mesh_shape(trainer)
    if list(saved_mesh) != list(mesh):
        raise ValueError(f"checkpoint was saved at --mesh_shape {','.join(map(str, saved_mesh))} "
                         f"but the trainer runs {','.join(map(str, mesh))}: fit skips the "
                         "global batches already taken, whose size counts the data and fsdp "
                         "axes, and each rank reads the shards of its fsdp and tensor index; "
                         f"resume with --mesh_shape {','.join(map(str, saved_mesh))}")
    plan = None
    if os.path.exists(os.path.join(path, PLAN_FILE)):
        with open(os.path.join(path, PLAN_FILE)) as f:
            plan = SMTPlan.from_json(f.read())
    host_path = os.path.join(path, _state_file(trainer, HOST_FILE))
    host = (torch.load(host_path, weights_only=True, map_location="cpu")
            if os.path.exists(host_path) else None)

    sparse = meta["phase"] == "sparse"
    if not sparse and trainer.phase != "warmup":
        raise ValueError("a warm-up checkpoint restores into a warm-up trainer; this one is "
                         "already in the sparse phase")
    scan = trainer._scan
    template_host = trainer._host_frozen
    if not sparse:
        template = _tensors(trainer.state)
    elif trainer.phase == "warmup":
        from sparse_matrix_tuning_tpu_torch.train.convert import sparse_state_from_plan
        now = _predicted_layout(trainer.cfg, trainer.model_cfg, plan, trainer.mesh)
        _check_layout(meta.get("resolved"), now)
        scan = now["scan"]
        # the state the conversion would build for this plan: its leaves'
        # keys, shapes and dtypes (the values come from the checkpoint)
        built, template_host = sparse_state_from_plan(trainer.cfg, trainer.state, plan,
                                                      trainer.model_cfg, scan=scan,
                                                      mesh=trainer.mesh,
                                                      sharding=trainer.sharding)
        template = _tensors(built)
        del built
    else:
        _check_layout(meta.get("resolved"), _resolved_layout(trainer))
        template = _tensors(trainer.state)
    flat = torch.load(os.path.join(path, _state_file(trainer)), weights_only=True,
                      map_location=trainer.device)
    _check_leaves("state", flat, template)
    _check_leaves("host store", host or {}, template_host or {})
    for k, t in flat.items():
        t.requires_grad_(template[k].requires_grad)
    del template, template_host

    trainer.state = _unflatten(flat)
    trainer.best_eval_loss = meta["best_eval_loss"]
    if sparse:
        trainer.plan, trainer._scan, trainer._host_frozen = plan, scan, host
        trainer.install_sparse_phase()
    from sparse_matrix_tuning_tpu_torch.parallel.mesh import assert_same
    assert_same("the restored step counter", trainer.step, trainer.mesh)
