"""The readings behind tests/test_torch_tensor_cut_heads.py's LATER_RTOL:
q_cut (hidden 768, 6 q / 2 kv heads of 128) over the int8 base, on the
CPU. Prints the relative loss differences by step, of the eval loss, and
of the grad norms:

  cut heads   the port's four ranks at (1, 1, 4) against JAX's SMTTrainer
              on its (1, 1, 4) mesh and against the port in one process
  heads whole JAX's (1, 1, 4) and (1, 1, 2) meshes against JAX on one
              device; the port's two ranks at (1, 1, 2) against one
              process and against JAX's (1, 1, 2) mesh; the port in one
              process against JAX on one device

    python tests/cut_heads_int8_readings.py

It measures the checkout it lives in: a copy with a planted fault reads
that fault.
"""
import os
import pathlib
import shutil
import sys
import tempfile

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_tensor_cut_heads as cut  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402
import torch_parity as tp  # noqa: E402
from test_torch_parallel import N, batches  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.where(b == 0, 1.0, np.abs(b))


def _norms(run):
    return [m.get("grad_norm", 0.0) for m in run["metrics"]]


def _losses(run):   # a JAX run's, or the port's by step
    return run["loss"] if "loss" in run else cut._losses(run)


def _show(what, got, want, norms=False):
    print(f"{what}: losses {_rel(_losses(got), _losses(want))}"
          f", eval {float(_rel(got['eval_loss'], want['eval_loss'])):.3e}"
          + (f", grad norms {_rel(_norms(got), _norms(want))}" if norms else ""))


def _jax_one_device(spec, model, bs, eval_path):
    jcfg = cut._jax_cfg(model)
    jt = cut.JaxSMTTrainer(cut.JaxSMTConfig(**spec["cfg"]), jcfg,
                           cut.jax_init_params(jax.random.PRNGKey(0), jcfg),
                           total_steps=spec["total_steps"])
    return {"loss": [float(jt.train_step(b)["loss"]) for b in bs],
            "eval_loss": jt.evaluate(torch.load(eval_path, weights_only=False))[1]}


def main():
    np.set_printoptions(linewidth=200, precision=3)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cut_heads_int8_"))
    try:
        _readings(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _readings(tmp):
    torch.save(batches(2, pads=(32, 20, 12, 6), seed=9), tmp / "eval.pt")
    bs = batches(N)
    torch.save(bs, tmp / "batches.pt")
    model = cut.MODELS["q_cut"]
    torch.save(tp.port_params(cut.jax_init_params(jax.random.PRNGKey(0), cut._jax_cfg(model))),
               tmp / "q_cut.pt")
    spec = {"name": "q_cut-int8", "cfg": dict(cut.CONFIGS["int8"]), "model": model,
            "total_steps": N, "params": str(tmp / "q_cut.pt"), "batches": str(tmp / "batches.pt"),
            "eval_batches": str(tmp / "eval.pt"), "export": True}
    one = ranks.run_scenario(spec)
    jax_one = _jax_one_device(spec, model, bs, tmp / "eval.pt")
    meshes = {}
    for t in (4, 2):
        cut.SHAPE = (1, 1, t)
        meshes[t] = cut._jax_run(spec, model, bs, tmp / "eval.pt")
        out = tmp / f"t{t}"
        out.mkdir()
        ranks.spawn(ranks.train_ranks, t, out, [spec], str(out), (1, 1, t))
        got = torch.load(out / "q_cut-int8.0.pt", weights_only=False)
        whole = "cut heads" if t == 4 else "heads whole"
        _show(f"[{whole}] port (1, 1, {t}) vs JAX's (1, 1, {t}) mesh", got, meshes[t])
        _show(f"[{whole}] port (1, 1, {t}) vs one process", got, one, norms=True)
        _show(f"[heads whole] JAX (1, 1, {t}) vs JAX on one device", meshes[t], jax_one)
    _show("[heads whole] port in one process vs JAX on one device", one, jax_one)


if __name__ == "__main__":
    main()
