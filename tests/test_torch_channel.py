"""Channel mode (--channel_sparsity) of the port against the JAX package,
at LlamaConfig.tiny size (2 layers, fp32, CPU): smt_channel_linear's
forward and gradients against the JAX custom VJP, the plan's column
gather and scatter, the activation taps of the warm-up, channel_stats
against `jax.jit` of the JAX twin, and the two-phase trainer (a warm-up
that only harvests activations, column selection, channel sparse steps,
eval, export) against the JAX trainer step for step, with per_step_stats
and no_limit_mixture variants, the per-layer path's unquantized base
under --frozen_quant int8, and the fine-tune CLI end to end."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_scan_train import _write_cli_ckpt

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.ops.sparse_linear import smt_channel_linear as jax_channel_linear
from sparse_matrix_tuning_tpu.smt import select as jselect
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu.train import steps as jsteps
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.models.from_jax import plan_from_jax
from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
from sparse_matrix_tuning_tpu_torch.ops import sparse_linear
from sparse_matrix_tuning_tpu_torch.smt import select
from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan
from sparse_matrix_tuning_tpu_torch.train import steps
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

JCFG = jllama.LlamaConfig.tiny(vocab_size=256)
PCFG = llama.LlamaConfig.tiny(vocab_size=256)
N_WARMUP, N_SPARSE = 2, 6
# the JAX suite's channel-linear tolerance (tests/test_scan_channel.py:70-84)
LINEAR_TOL = 1e-5
# fp32 on the CPU, the same algorithm in two frameworks, as
# tests/test_torch_train_e2e.py holds the matrix trainer: measured worst
# loss difference 3.0e-7 relative over the 8 steps of these runs.
LOSS_RTOL = 1e-4
# channel_stats: the same sums over the sequence in another order. XLA's
# CPU reduce adds rows in chunks of 32, PyTorch in its own order: measured
# up to 3.6e-7 relative (a few fp32 ulps).
STATS_RTOL = 1e-6


def _cfg_kwargs(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                channel_sparsity=True, full_ft_steps=N_WARMUP, ft_learning_rate=1e-3,
                smt_lr=1e-2, lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=0)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# smt_channel_linear and the plan's columns
# ---------------------------------------------------------------------------

CHANNELS = (2, 7, 100, 159)


def _linear_inputs():
    w = tp.seeded_normal((192, 160), 1, 0.05)
    cols = w[:, list(CHANNELS)] + tp.seeded_normal((192, len(CHANNELS)), 2, 0.01)
    w[:, list(CHANNELS)] = cols          # the dense weight holds the current columns
    x = tp.seeded_normal((2, 8, 160), 3)
    g = tp.seeded_normal((2, 8, 192), 4)
    return w, cols, x, g


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_smt_channel_linear_matches_jax_vjp(dtype):
    """Forward x @ W^T, grad_x = g @ W, and the columns' grads g^T @ x[:, ci]
    with an fp32 output (the fp32 master's dtype), against the JAX custom
    VJP on the same values."""
    w, cols, x, g = _linear_inputs()
    lp_j = JaxLinearPlan("q_proj", 0, 192, 160, channels=CHANNELS)
    wj, xj, gj = (tp.to_jax(a, dtype) for a in (w, x, g))
    y, pull = jax.vjp(lambda x, c: jax_channel_linear(x, c, wj, lp_j, "oracle"), xj,
                      jnp.asarray(cols))
    want = (y,) + pull(gj)

    lp = LinearPlan("q_proj", 0, 192, 160, channels=CHANNELS)
    xt = tp.to_torch(x, dtype).requires_grad_(True)
    ct = torch.from_numpy(cols).requires_grad_(True)
    yt = sparse_linear.smt_channel_linear(xt, ct, tp.to_torch(w, dtype), lp)
    yt.backward(tp.to_torch(g, dtype))
    assert yt.dtype == tp.TORCH_DTYPES[dtype] and ct.grad.dtype == torch.float32
    for name, got, ref in (("y", yt, want[0]), ("grad_x", xt.grad, want[1]),
                           ("grad_cols", ct.grad, want[2])):
        tp.assert_close(got, ref, rtol=LINEAR_TOL, atol=LINEAR_TOL)
    assert ct.grad.shape == (192, len(CHANNELS))


def test_plan_gather_scatter_columns_equal_jax():
    """Channel mode's gather gives W[:, channels] (O, n) fp32 and scatter
    writes the columns back in place, as the JAX plan does (bit for bit);
    the index tensor is built once per device."""
    dims = {("q_proj", 0): (192, 160), ("down_proj", 1): (160, 192)}
    selected = {("q_proj", 0): [100, 2, 7], ("down_proj", 1): [191, 0]}
    jplan = JaxSMTPlan.from_selection("channel", selected, dims)
    plan = plan_from_jax(jplan)
    layers = {"0": {"q_proj": tp.seeded_normal((192, 160), 5)},
              "1": {"down_proj": tp.seeded_normal((160, 192), 6)}}
    want = tp.numpy_tree(jplan.gather({k: {m: jnp.asarray(w) for m, w in v.items()}
                                       for k, v in layers.items()}))
    player = {k: {m: torch.from_numpy(w.copy()) for m, w in v.items()} for k, v in layers.items()}
    got = plan.gather(player)
    tp.assert_same_leaves(got, want)
    new = {ks: t + 1.0 for ks, t in got.items()}
    want_layers = tp.numpy_tree(jplan.scatter(
        {k: {m: jnp.asarray(w) for m, w in v.items()} for k, v in layers.items()},
        {ks: jnp.asarray(t.numpy()) for ks, t in new.items()}))
    assert plan.scatter(player, new) is player
    tp.assert_same_leaves(player, want_layers)
    assert plan.channel_index("0.q_proj", "cpu") is plan.channel_index("0.q_proj", "cpu")


# ---------------------------------------------------------------------------
# the warm-up's statistics
# ---------------------------------------------------------------------------

def test_activation_taps_match_jax():
    """forward(..., activation_taps=) records each target linear's masked
    batch-summed |input|, (S, in_dim), as the JAX forward does; q/k/v (and
    gate/up) read one input and share its tap."""
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    batch = tp.lm_batches(1, pad_from=20)[0]
    jtaps = {}
    jllama.forward(jparams, jnp.asarray(batch["input_ids"]), JCFG,
                   attention_mask=jnp.asarray(batch["attention_mask"]), remat=False,
                   activation_taps=jtaps)
    ptaps = {}
    with torch.no_grad():
        llama.forward(tp.port_params(jparams), torch.from_numpy(batch["input_ids"]).long(), PCFG,
                      attention_mask=torch.from_numpy(batch["attention_mask"]),
                      activation_taps=ptaps)
    assert set(ptaps) == set(jtaps) and len(ptaps) == 2 * 6
    # fp32 activations of two frameworks: sums of |x| of order 1-10, apart
    # by up to 1.5e-6 (measured), also where a tap is near 0
    for ks, want in jtaps.items():
        assert ptaps[ks].shape == want.shape and ptaps[ks].dtype == torch.float32
        tp.assert_close(ptaps[ks], want, rtol=1e-5, atol=1e-5)
    assert ptaps["0.q_proj"] is ptaps["0.v_proj"] and ptaps["1.gate_proj"] is ptaps["1.up_proj"]


@pytest.mark.parametrize("strategy", ["mean_abs", "abs_mean", "L1", "L2"])
def test_channel_stats_match_jit_jax(strategy):
    """select.channel_stats on torch tensors and numpy arrays against
    jax.jit(channel_stats), which the JAX conversion runs; the channels
    that select_channels then picks are the same."""
    rng = np.random.default_rng(0)
    acts = {("q_proj", l): np.abs(rng.standard_normal((64, 256))).astype(np.float32)
            * rng.uniform(0, 4, (64, 1)).astype(np.float32) for l in range(2)}
    jit = jax.jit(jselect.channel_stats, static_argnums=(1,))
    want = {k: np.asarray(jit(jnp.asarray(a), strategy)) for k, a in acts.items()}
    for conv in (torch.from_numpy, np.asarray):
        got = {k: tp.np32(select.channel_stats(conv(a), strategy)) for k, a in acts.items()}
        for k in acts:
            np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL, atol=0)
        assert select.select_channels(got, 30) == jselect.select_channels(want, 30)


def test_warmup_state_and_auto_accumulation_match_jax():
    """Channel accumulators: (max_seq_len, in_dim), or (in_dim,) under
    per_step_stats; "auto" picks per_step_stats above 2 GiB of (S, C)
    accumulators as JAX does (TinyLlama: from seq 1,540)."""
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    for acc in ("grad_sum", "per_step_stats"):
        js = jsteps.init_warmup_state(jparams, JaxSMTConfig(**_cfg_kwargs(
            saliency_accumulation=acc)))
        ps = steps.init_warmup_state(tp.port_params(jparams), SMTConfig(**_cfg_kwargs(
            saliency_accumulation=acc)))
        assert {k: tuple(v.shape) for k, v in ps["act_acc"].items()} == \
            {k: tuple(v.shape) for k, v in js["act_acc"].items()}
        assert {"master", "m", "v"} <= set(ps) and "acc" not in ps
    tl = {"layers": {str(l): {m: torch.empty(s, device="meta") for m, s in (
        ("q_proj", (2048, 2048)), ("k_proj", (256, 2048)), ("v_proj", (256, 2048)),
        ("gate_proj", (5632, 2048)), ("up_proj", (5632, 2048)),
        ("down_proj", (2048, 5632)))} for l in range(22)}}
    for seq, want in ((512, "grad_sum"), (1536, "grad_sum"), (1544, "per_step_stats"),
                      (2048, "per_step_stats")):
        cfg = SMTConfig(**_cfg_kwargs(max_seq_len=seq, seq_buckets=None,
                                      saliency_accumulation="auto"))
        assert steps.resolve_saliency_accumulation(cfg, tl) == want, seq


# ---------------------------------------------------------------------------
# the two-phase trainer against the JAX trainer
# ---------------------------------------------------------------------------

def _run_pair(**kw):
    n = N_WARMUP + N_SPARSE
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    batches = tp.lm_batches(n, pad_from=24)
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg_kwargs(**kw)), JCFG, jparams, total_steps=n)
    pt = SMTTrainer(SMTConfig(**_cfg_kwargs(**kw)), PCFG, tp.port_params(jparams),
                    total_steps=n)
    out = {"jax": jt, "port": pt, "jax_losses": [], "port_losses": [],
           "initial": tp.port_params(jparams)}
    for i, batch in enumerate(batches):
        if i == N_WARMUP:
            out["master_after_warmup"] = {k: v.detach().clone() for k, v in
                                          llama.flatten_tree(pt.state["master"]).items()}
            out["jax_stats"] = tp.numpy_tree(jt.state["act_acc"])
            out["port_stats"] = {k: v.clone() for k, v in pt.state["act_acc"].items()}
        out["jax_losses"].append(float(jt.train_step(batch)["loss"]))
        out["port_losses"].append(float(pt.train_step(batch)["loss"]))
    return out


@pytest.fixture(scope="module")
def pair():
    return _run_pair()


def test_losses_and_plan_match_jax(pair):
    port, jt = pair["port"], pair["jax"]
    assert port.phase == jt.phase == "sparse" and port.plan.mode == "channel"
    np.testing.assert_allclose(pair["port_losses"], pair["jax_losses"], rtol=LOSS_RTOL, atol=0)
    assert pair["port_losses"][-1] < pair["port_losses"][N_WARMUP]
    assert port.plan.to_json() == jt.plan.to_json()
    assert port.plan.fingerprint() == jt.plan.fingerprint()
    # the CLI's defaults: 30 attention and 30 MLP channels in all
    assert sum(lp.n_channels for lp in port.plan.linears.values()) == 60
    for ks, want in pair["jax_stats"].items():
        tp.assert_close(pair["port_stats"][ks], want, rtol=1e-5, atol=1e-5)


def test_warmup_does_not_train(pair):
    """The channel warm-up is a forward only: the master is the initial
    weights after it, as the reference's `continue` leaves them."""
    initial = llama.flatten_tree(pair["initial"])
    for k, v in pair["master_after_warmup"].items():
        assert torch.equal(v, initial[k]), k


def test_sparse_phase_trains_only_the_columns(pair):
    port = pair["port"]
    plan = port.plan
    after = port.state["params"]["layers"]
    initial = pair["initial"]["layers"]
    for li, layer in initial.items():
        for mod, w0 in layer.items():
            w = after[li][mod]
            lp = plan.linears.get(f"{li}.{mod}")
            if lp is None:
                assert torch.equal(w, w0), (li, mod)
                continue
            mask = torch.zeros(w0.shape, dtype=torch.bool)
            mask[:, list(lp.channels)] = True
            assert torch.equal(w[~mask], w0[~mask]), (li, mod)
            assert torch.equal(w[:, list(lp.channels)], port.state["trainable"][f"{li}.{mod}"]
                               .detach()), (li, mod)
            assert not torch.equal(w[mask], w0[mask]), (li, mod)


def test_merged_export_and_eval_match_jax(pair, tmp_path):
    """The merged dense params against the JAX trainer's (relative
    Frobenius norm, as tests/test_torch_train_e2e.py: Adam moves an
    element whose grad is ~0 by ~lr either way; measured worst 1.0e-6),
    the export read back bit for bit, and the eval loss."""
    port, jt = pair["port"], pair["jax"]
    merged = port.merged_params()
    jm = tp.numpy_tree(jt.merged_params())
    for li, layer in merged["layers"].items():
        for m, w in layer.items():
            want = np.asarray(jm["layers"][li][m], np.float32)
            assert np.linalg.norm(tp.np32(w) - want) <= 1e-4 * np.linalg.norm(want), (li, m)
    port.cfg.output_dir = str(tmp_path)
    try:
        port._save("final")
    finally:
        port.cfg.output_dir = None
    assert (tmp_path / "final" / "smt_plan.json").read_text() == port.plan.to_json()
    back = load_hf_params(str(tmp_path / "final"), PCFG, dtype=torch.float32)
    for li, layer in merged["layers"].items():
        for m, w in layer.items():
            assert torch.equal(back["layers"][li][m], w), (li, m)
    batches = tp.lm_batches(2, seed=9)
    assert port.evaluate(batches)[1] == pytest.approx(jt.evaluate(batches)[1], rel=LOSS_RTOL)


@pytest.mark.parametrize("kw", [
    dict(saliency_accumulation="per_step_stats", calculate_strategy="L1"),
    dict(no_limit_mixture=True, calculate_strategy="L2", qk_scheduler=True, w_decay=0.1),
    dict(frozen_quant="int8"),
], ids=["per_step_stats-L1", "no_limit_mixture-L2-qk-wd", "frozen_quant-int8"])
def test_variants_match_jax(kw):
    """Per-step channel stats, one budget over attention and MLP with
    another reducer, the q/k LR boost and weight decay; and --frozen_quant
    int8, which leaves the per-layer channel path unquantized in both
    packages (no int8 base, no int8 head, no offload)."""
    p = _run_pair(**kw)
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=LOSS_RTOL, atol=0)
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
    if kw.get("frozen_quant"):
        for state in (p["port"].state, p["jax"].state):
            assert "q" not in state and "q_head" not in state
        assert p["port"]._host_frozen is None


def test_fine_tune_cli_channel_end_to_end(tmp_path):
    """The CLI with --channel_sparsity on a tiny HF checkpoint: warm-up,
    column selection, sparse steps, eval, the final export and its plan."""
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main
    from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan

    d, data = _write_cli_ckpt(tmp_path)
    out = tmp_path / "out"
    history = main(["--model_name_or_path", d, "--data_path", data, "--output_dir", str(out),
                    "--device", "cpu", "--channel_sparsity", "--full_ft_steps", "2",
                    "--num_attention_channel", "8", "--num_mlp_channel", "8",
                    "--per_device_ft_batch_size", "2", "--per_device_eval_batch_size", "2",
                    "--num_ft_epochs", "1", "--max_seq_len", "64", "--eval_step", "3",
                    "--dtype", "fp32", "--smt_lr", "1e-3"])
    assert len(history["train_loss"]) >= 4 and np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["eval_loss"]).all()
    phases = [json.loads(line)["phase"] for line in
              (out / "metrics.jsonl").read_text().splitlines()]
    assert phases[:2] == ["warmup", "warmup"] and phases[-1] == "sparse"
    plan = SMTPlan.from_json((out / "final" / "smt_plan.json").read_text())
    assert plan.mode == "channel" and sum(lp.n_channels for lp in plan.linears.values()) == 16
