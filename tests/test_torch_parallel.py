"""Data-parallel training (`--mesh_shape D,1,1`, parallel/mesh.py): two gloo
ranks on the CPU, spawned once for the whole module by
torch.multiprocessing (tests/torch_dp_ranks.py, which imports no JAX),
against the JAX SMTTrainer on a (2, 1, 1) mesh over conftest's virtual CPU
devices and against the port in one process at the same global batch.
Tiny Llama, fp32 unless said, inputs from numpy seeds.

Each scenario pins one rule of the port's data parallelism:
  matrix    B1: each rank divides its token-loss sum by the global count
            (rank 1's rows hold far fewer valid tokens than rank 0's)
  accum     B2: under gradient accumulation rank r owns rows r*B.. of every
            microbatch, and each microbatch's denominator is its own
  channel   B5: the ranks' |x| sums are reduced every step, before they are
            accumulated
  fp16      B3: rank 0's rows hold no valid token, so only rank 1's grads
            overflow; the reduce comes first, so both ranks skip together
  dropout   B6: the ranks draw the global microbatch's mask and keep their
            rows, dropping what one process drops
  scan      the int8 scan state of --sparse_from_plan (the stacked grads
            reduced as they are)
  matrix_int8  the per-layer int8 base keeps its weights on the device on
            a mesh (JAX's rule), training as one process does
In every scenario the two ranks end with bit-equal states (B7: checksums
of every leaf, trainables, m and v included) and the same plan.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparse_matrix_tuning_tpu.parallel.mesh import set_compute_mesh
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig, parse_args
from sparse_matrix_tuning_tpu_torch.data.sft import shard_batch
from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
from sparse_matrix_tuning_tpu_torch.parallel import mesh as mesh_mod
from sparse_matrix_tuning_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_, make_mesh, rank_rows, refuse_sharded_axes)
from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan

D = 2
N_WARMUP, N_SPARSE = 2, 3
# fp32 on the CPU: JAX's mesh against the port's ranks, the bound of
# tests/test_torch_train_e2e.py (the JAX suite's own mesh bound is 2e-4,
# tests/test_sharding.py:55; measured worst 1.0e-6)
JAX_RTOL = 1e-4
# the same program at D=2 and D=1: the ranks' products at half the rows and
# the grads summed in another order (measured worst 4.1e-7 relative); over
# the int8 base a last-bit difference may flip an int8 rounding, so the
# port's int8 bound against JAX holds (tests/test_torch_scan_train.py;
# measured 6.0e-4)
D1_RTOL = 1e-5
D1_RTOL_INT8 = 1e-3
# fp16 against JAX: tests/test_torch_fp16.py's bounds, first two steps and
# the rest (measured 7.3e-5)
FP16_RTOL = (1e-3, 3e-2)

JAX_CFG = JaxLlamaConfig.tiny(vocab_size=256)
MODEL = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)


def _cfg(mode="matrix", **kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                full_ft_steps=N_WARMUP, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=0,
                per_device_ft_batch_size=2, per_device_eval_batch_size=2)
    if mode == "channel":
        base.update(channel_sparsity=True, num_attention_channel=8, num_mlp_channel=8)
    else:
        base.update(matrix_sparsity=True, downsample_attention_blocks_ratio=0.05,
                    downsample_mlp_blocks_ratio=0.05)
    base.update(kw)
    return base


def batches(n, pads=(32, 32, 10, 10), seed=0, masked_rows=()):
    """Global batches of 4 rows of tests/torch_parity's learnable pattern,
    row i right-padded from pads[i]; masked_rows hold no valid label."""
    out = []
    for b in tp.lm_batches(n, bsz=len(pads), seq=32, seed=seed):
        for i, p in enumerate(pads):
            b["attention_mask"][i, p:] = 0
            b["labels"][i, p:] = -100
            b["input_ids"][i, p:] = 0
        for i in masked_rows:
            b["labels"][i] = -100
        out.append(b)
    return out


N = N_WARMUP + N_SPARSE
# name -> (config kwargs, model changes, batches kwargs, against JAX)
SCENARIOS = {
    "matrix": (_cfg(), {}, {}, True),
    "accum": (_cfg(per_device_ft_batch_size=1, gradient_accumulation_steps=2), {},
              dict(pads=(32, 8, 20, 32)), True),
    "channel": (_cfg("channel"), {}, {}, True),
    # from the default 2^16 the two warm-up steps overflow, the sparse ones do not
    "fp16": (_cfg(dtype="fp16"), {}, dict(masked_rows=(0, 1)), True),
    "dropout": (_cfg(dropout=0.1), dict(attention_dropout=0.1), {}, False),
    "matrix_int8": (_cfg(frozen_quant="int8"), {}, {}, False),
    "scan": (_cfg(frozen_quant="int8", total_steps=N_SPARSE), {}, {}, False),
}


def _scan_plan(path):
    plan = SMTPlan("matrix", {
        "0.q_proj": LinearPlan("q_proj", 0, 256, 256, blocks=((0, 0),)),
        "1.gate_proj": LinearPlan("gate_proj", 1, 512, 256, blocks=((1, 0),)),
        "0.down_proj": LinearPlan("down_proj", 0, 256, 512, blocks=((0, 1),)),
        "1.down_proj": LinearPlan("down_proj", 1, 256, 512, blocks=((0, 0), (0, 1)))})
    path.write_text(plan.to_json())
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario at D=2 (one spawn), at D=1 in this process, and on
    JAX's (2, 1, 1) mesh."""
    tmp = tmp_path_factory.mktemp("dp")
    params = tp.port_params(jax_init_params(jax.random.PRNGKey(0), JAX_CFG))
    torch.save(params, tmp / "params.pt")
    save_hf_format(params, LlamaConfig(**MODEL), str(tmp / "hf"))
    torch.save(batches(2, pads=(32, 20, 12, 6), seed=9), tmp / "eval.pt")
    specs, jax_batches = [], {}
    for name, (cfg, model, bkw, _) in SCENARIOS.items():
        cfg = dict(cfg)
        n = cfg.pop("total_steps", N)
        bs = batches(n, **bkw)
        jax_batches[name] = bs
        torch.save(bs, tmp / f"{name}.pt")
        spec = {"name": name, "cfg": cfg, "model": {**MODEL, **model}, "total_steps": n,
                "params": str(tmp / "params.pt"), "batches": str(tmp / f"{name}.pt"),
                "eval_batches": str(tmp / "eval.pt")}
        if name == "scan":
            spec.update(from_hf=str(tmp / "hf"), plan=_scan_plan(tmp / "plan.json"))
        specs.append(spec)
    ranks.spawn(ranks.train_ranks, D, tmp, specs, str(tmp))
    out = {}
    for spec in specs:
        name = spec["name"]
        got = [torch.load(tmp / f"{name}.{r}.pt", weights_only=False) for r in range(D)]
        one = ranks.run_scenario(spec)
        jax_run = None
        if SCENARIOS[name][3]:
            # a fresh copy: the JAX trainer donates its params
            jparams = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
            try:
                jt = JaxSMTTrainer(JaxSMTConfig(**spec["cfg"]), JAX_CFG, jparams,
                                   total_steps=spec["total_steps"],
                                   mesh=jax_make_mesh((D, 1, 1), jax.devices()[:D]))
                metrics = [jt.train_step(b) for b in jax_batches[name]]
                jax_run = {"loss": [float(m["loss"]) for m in metrics],
                           "flags": [(float(m.get("loss_scale", -1.0)),
                                      bool(m.get("overflow", False))) for m in metrics],
                           "fingerprint": jt.plan.fingerprint(),
                           "eval_loss": jt.evaluate(torch.load(tmp / "eval.pt",
                                                               weights_only=False))[1]}
            finally:  # the JAX trainer leaves its compute mesh set (trainer.py:68)
                set_compute_mesh(None)
        out[name] = {"ranks": got, "d1": one, "jax": jax_run}
    return out


def _ranks(runs, name):
    for r, got in enumerate(runs[name]["ranks"]):
        assert "error" not in got, f"rank {r}: {got['error']}"
    return runs[name]["ranks"]


def _losses(run):
    return [m["loss"] for m in run["metrics"]]


def _flags(run):
    return [(m.get("loss_scale", -1.0), bool(m.get("overflow", 0.0))) for m in run["metrics"]]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ranks_stay_bit_equal(runs, name):
    r0, r1 = _ranks(runs, name)
    assert r0["checksums"] == r1["checksums"]
    assert {"m", "v", "trainable"} <= {k.split("/")[0] for k in r0["checksums"]}
    np.testing.assert_equal(r0["metrics"], r1["metrics"])  # NaN grad norms of skipped steps
    assert r0["eval_loss"] == r1["eval_loss"]
    assert r0["fingerprint"] == r1["fingerprint"] and r0["phase"] == "sparse"
    assert r0["stats"]["calls"] >= len(r0["metrics"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_ranks_match_one_process(runs, name):
    r0, one = _ranks(runs, name)[0], runs[name]["d1"]
    assert r0["fingerprint"] == one["fingerprint"]
    assert _flags(r0) == _flags(one)
    rtol = D1_RTOL_INT8 if r0["int8"] else D1_RTOL
    np.testing.assert_allclose(_losses(r0), _losses(one), rtol=rtol, atol=0)
    np.testing.assert_allclose(r0["eval_loss"], one["eval_loss"], rtol=rtol)
    assert (r0["scan"], r0["int8"]) == (one["scan"], one["int8"])


@pytest.mark.parametrize("name", [n for n, s in SCENARIOS.items() if s[3]])
def test_two_ranks_match_jax_mesh(runs, name):
    r0, want = _ranks(runs, name)[0], runs[name]["jax"]
    assert r0["fingerprint"] == want["fingerprint"]
    assert _flags(r0) == want["flags"]
    if name == "fp16":
        np.testing.assert_allclose(_losses(r0)[:2], want["loss"][:2], rtol=FP16_RTOL[0], atol=0)
        np.testing.assert_allclose(_losses(r0)[2:], want["loss"][2:], rtol=FP16_RTOL[1], atol=0)
        return
    np.testing.assert_allclose(_losses(r0), want["loss"], rtol=JAX_RTOL, atol=0)
    np.testing.assert_allclose(r0["eval_loss"], want["eval_loss"], rtol=JAX_RTOL)


def test_fp16_overflow_of_one_rank_skips_both(runs):
    """Rank 0's rows hold no valid token (its grads are exactly 0); a step
    overflows only through rank 1's, and both ranks skip it."""
    r0, r1 = _ranks(runs, "fp16")
    flags = [f[1] for f in _flags(r0)]
    assert any(flags) and not all(flags), flags
    assert flags == [f[1] for f in _flags(r1)]


def test_int8_base_stays_on_the_device_on_a_mesh(runs):
    r0, one = _ranks(runs, "matrix_int8")[0], runs["matrix_int8"]["d1"]
    assert r0["int8"] and not r0["host_frozen"] and one["host_frozen"]
    scan = _ranks(runs, "scan")[0]
    assert scan["scan"] and scan["host_frozen"]


def test_reduced_bytes_by_phase(runs):
    """B4: a warm-up step reduces every dense grad, a sparse step the
    selected blocks (or columns, or the scan state's stacks) only, each
    with the loss; a channel warm-up step its loss and its |x| sums (one
    tap per distinct input: q/k/v share one, gate/up another)."""
    for name in ("matrix", "scan", "channel"):
        r0 = _ranks(runs, name)[0]
        got = [m["reduced_bytes"] for m in r0["metrics"]]
        sparse = 4 * r0["n_trainable"] + 4
        if name == "matrix":
            assert got == [4 * r0["n_master"] + 4] * N_WARMUP + [sparse] * N_SPARSE
        elif name == "scan":
            assert got == [sparse] * N_SPARSE
        else:
            taps = 4 * 32 * MODEL["num_hidden_layers"] * (2 * MODEL["hidden_size"]
                                                          + MODEL["intermediate_size"])
            assert got == [4 + taps] * N_WARMUP + [sparse] * N_SPARSE


# ---------------------------------------------------------------------------
# units with no spawn: rank_rows, the denominators, the refusals, buckets
# ---------------------------------------------------------------------------

def _mesh(rank, data=2):
    return Mesh((data, 1, 1), rank, torch.device("cpu"))


@pytest.mark.parametrize("accum", [1, 2, 3])
def test_rank_rows_takes_each_microbatch_slice(accum):
    rows = np.arange(accum * 2 * 3)[:, None] * np.ones((1, 4), np.int64)
    for r in range(2):
        got = rank_rows({"x": rows}, _mesh(r), accum)["x"][:, 0]
        want = [i * 6 + r * 3 + j for i in range(accum) for j in range(3)]
        assert got.tolist() == want
    with pytest.raises(ValueError, match="not a multiple"):
        rank_rows({"x": rows[:-1]}, _mesh(0), accum)


def test_shard_batch_carries_global_microbatch_counts():
    b = batches(1, pads=(32, 8, 20, 32))[0]
    valid = (b["labels"][:, 1:] != -100).sum(axis=1)
    out = shard_batch(b, _mesh(1), accum=2)
    assert out["loss_denom"].tolist() == [valid[0] + valid[1], valid[2] + valid[3]]
    np.testing.assert_array_equal(out["input_ids"], b["input_ids"][[1, 3]])


@pytest.mark.parametrize("shape,err,match", [
    ((1, 2, 1), None, "--sparse_from_plan with fsdp 2 .* runs on one device"),
    ((1, 1, 2), NotImplementedError, "tensor 2 not yet ported"),
    ((2, 2, 1), None, "with fsdp 2 .* use --mesh_shape 4,1,1"),
])
def test_sharded_axes_refused(shape, err, match):
    """The tensor axis is taken in matrix and channel mode over the dense
    or the int8 base, with dropout too, what it does not run refused by
    name (--sparse_from_plan; tests/test_torch_tensor.py has each case);
    the fsdp axis is taken, with the scan layouts too, but not with
    --sparse_from_plan, whose JAX entry runs on one device
    (tests/test_torch_fsdp_io.py runs the scan layouts)."""
    if err is not None:
        unported = SMTConfig(scan_layers="on", sparse_from_plan="plan.json")
        with pytest.raises(err, match=match):
            refuse_sharded_axes(shape, unported)
        with pytest.raises(err, match=match):
            SMTConfig(mesh_shape=list(shape), scan_layers="on", sparse_from_plan="plan.json")
        refuse_sharded_axes(shape, SMTConfig())
        refuse_sharded_axes(shape, SMTConfig(dropout=0.1))
        refuse_sharded_axes(shape, SMTConfig(frozen_quant="int8"))
        refuse_sharded_axes(shape, SMTConfig(channel_sparsity=True))
        assert SMTConfig(mesh_shape=list(shape)).mesh_shape == list(shape)
        assert SMTConfig(mesh_shape=list(shape), frozen_quant="int8").mesh_shape == list(shape)
        return
    refuse_sharded_axes(shape)
    assert SMTConfig(mesh_shape=list(shape)).mesh_shape == list(shape)
    assert SMTConfig(mesh_shape=list(shape), scan_layers="on").scan_layers == "on"
    with pytest.raises(NotImplementedError, match=match):
        SMTConfig(mesh_shape=list(shape), scan_layers="on", sparse_from_plan="plan.json")
    with pytest.raises(NotImplementedError, match="--sparse_from_plan with"):
        SMTConfig(mesh_shape=list(shape), sparse_from_plan="plan.json")


def test_config_mesh_refusals(monkeypatch):
    assert SMTConfig(mesh_shape="2,1,1").mesh_shape == [2, 1, 1]
    assert SMTConfig(mesh_shape=["4", "1", "1"]).mesh_shape == [4, 1, 1]
    with pytest.raises(ValueError, match="data,fsdp,tensor"):
        SMTConfig(mesh_shape="2,1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    flags = ["--data_path", "x", "--model_name_or_path", "m"]
    assert parse_args(flags).mesh_shape == [1, 2, 1]  # JAX's default mesh: every rank on fsdp
    scan = parse_args(flags + ["--scan_layers", "on"])  # the scan layouts train under fsdp
    assert (scan.mesh_shape, scan.scan_layers) == ([1, 2, 1], "on")
    with pytest.raises(NotImplementedError, match="--sparse_from_plan with fsdp 2"):
        parse_args(flags + ["--sparse_from_plan", "plan.json"])
    # the shape against the world is make_mesh's check, at the launch
    assert parse_args(flags + ["--mesh_shape", "4,1,1"]).mesh_shape == [4, 1, 1]
    assert parse_args(flags + ["--mesh_shape", "2", "1", "1"]).mesh_shape == [2, 1, 1]
    assert SMTConfig().mesh_shape is None  # a config built inside a rank is not a launch


def test_make_mesh_checks_the_world():
    with pytest.raises(ValueError, match="!= world size 4"):
        make_mesh((2, 1, 1), world=4)
    with pytest.raises(ValueError, match="!= world size 2"):
        make_mesh([4, 1, 1], world=2)
    with pytest.raises(RuntimeError, match="needs the process group"):
        make_mesh((1, 1, 4), world=4)  # the tensor axis passes the checks
    with pytest.raises(RuntimeError, match="needs the process group"):
        make_mesh((1, 4, 1), world=4)  # the fsdp axis passes the checks
    with pytest.raises(RuntimeError, match="needs the process group"):
        make_mesh(None, world=4)  # (1, 4, 1)


def test_all_reduce_buckets_by_dtype_and_cap(monkeypatch):
    """Tensors pack into buckets of one dtype under the cap (a larger one
    alone), one all_reduce each; the sums land back in place."""
    calls = []

    def fake_all_reduce(t, group=None):
        calls.append((t.dtype, t.numel()))
        t.mul_(2)

    monkeypatch.setattr(torch.distributed, "all_reduce", fake_all_reduce)
    monkeypatch.setattr(mesh_mod, "BUCKET_MIB", 1.0 / 1024)  # 1 KiB
    mesh = _mesh(0)
    a, b, c = torch.ones(100), torch.ones(100), torch.ones(1000)
    h = torch.ones(10, dtype=torch.float16)
    all_reduce_([a, b, c, h, a], mesh)
    assert calls == [(torch.float32, 200), (torch.float32, 1000), (torch.float16, 10)]
    assert all(torch.equal(t, 2 * torch.ones_like(t)) for t in (a, b, c, h))
    assert mesh.stats["calls"] == 3 and mesh.stats["bytes"] == 4 * 1200 + 2 * 10
