"""Channel mode over the int8 scan state (--channel_sparsity --frozen_quant
int8 --sparse_from_plan with a channel plan) against the JAX package, at
LlamaConfig.tiny size (2 layers, fp32, CPU): smt_channel_linear_dyn's
forward and gradients against the JAX custom VJP over a dense, an int8 and
an int4 base, its padded entries inert; quantize-on-load leaf for leaf;
four scan sparse steps, the eval loss and the export from one carried JAX
state; the int8 and int4 decode over the channel state (prefill logits
and greedy tokens); the trainer entry and the CLI. The plan pads its
modules (uneven per-layer counts) and leaves planned modules out of one
layer."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_scan_train import JCFG, PCFG, SHAPES, VOCAB, _write_ckpt, _write_cli_ckpt

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.ops import quant as jquant
from sparse_matrix_tuning_tpu.ops.sparse_linear import (
    smt_channel_linear_dyn as jax_channel_linear_dyn)
from sparse_matrix_tuning_tpu.smt.optimizer import make_lr_schedule as jax_lr_schedule
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu.train import scan_phase as jscan
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.eval import generate as pgen
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.models.from_jax import plan_from_jax, scan_state_from_jax
from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
from sparse_matrix_tuning_tpu_torch.ops import sparse_linear
from sparse_matrix_tuning_tpu_torch.ops.quant import q8_matmul_t
from sparse_matrix_tuning_tpu_torch.smt.optimizer import make_lr_schedule
from sparse_matrix_tuning_tpu_torch.train import scan_phase
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

# the JAX eval package re-exports a function named generate over its module
jgen = importlib.import_module("sparse_matrix_tuning_tpu.eval.generate")

# uneven per-layer counts (padded); v_proj and down_proj absent from layer 0
SELECTED = {("q_proj", 0): [3, 17, 200], ("q_proj", 1): [9], ("v_proj", 1): [40, 41],
            ("gate_proj", 0): [1, 255], ("gate_proj", 1): [100, 7, 8],
            ("up_proj", 0): [1], ("up_proj", 1): [2], ("down_proj", 1): [511, 0, 300]}
# the JAX suite's tolerances (tests/test_scan_channel.py:106-128): the
# forward and the columns' grads 2e-5, grad_x 2e-4, a zero delta 1e-6
Y_TOL, GRAD_X_TOL, ZERO_DELTA_TOL = 2e-5, 2e-4, 1e-6
# the scan steps, as tests/test_torch_scan_train.py bounds the matrix ones
# (the reason for the int8 bound is there: an activation one fp32 bit
# apart takes the other int8 step, Adam's sign-like first updates spread
# it). Measured over these 4 steps: int8 losses and grad norms up to
# 1.2e-4 apart (the first grad norm 2.1e-5); over the dense base, with
# the q/k LR boost, within 1e-5. The boost (3x the rate on q/k) is held
# on the dense base: over the int8 base it spreads the flips 3x as fast
# (1.3e-3 at step 4 measured, as the matrix steps' 4.1e-3 at 10x the rate).
INT8_LOSS_RTOL, DENSE_RTOL = 1e-3, 1e-5
N_STEPS = 4


def _cfg_kwargs(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                channel_sparsity=True, frozen_quant="int8", sparse_from_plan="smt_plan.json",
                smt_lr=1e-4, w_decay=0.01, lr_scheduler_type="constant", eval_step=0,
                save_steps=0, max_seq_len=32, seq_buckets=[32], seed=0)
    base.update(kw)
    return base


def _configs(**kw):
    return (JaxSMTConfig(**_cfg_kwargs(sparse_impl="oracle", **kw)),
            SMTConfig(**_cfg_kwargs(**kw)))


def _jax_plan():
    dims = {(m, l): SHAPES[m] for m in SHAPES for l in range(2)}
    return JaxSMTPlan.from_selection("channel", SELECTED, dims)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_ckpt(tmp_path_factory.mktemp("channel_scan_ckpt"))


# ---------------------------------------------------------------------------
# smt_channel_linear_dyn against the JAX custom VJP
# ---------------------------------------------------------------------------

def _dyn_inputs(base: str, pad: bool = True):
    """gate_proj-shaped (512, 256) weight, channels (3, 17, 200) and with
    `pad` a fourth entry duplicating the first, invalid, with a junk value
    that must not matter; x of 16 rows, bf16-exact (the port's int4 route
    casts x to bf16 at decode rows, JAX's CPU route does not)."""
    w = tp.seeded_normal((512, 256), 1, 0.05)
    x = np.asarray(jnp.asarray(tp.seeded_normal((2, 8, 256), 2), jnp.bfloat16), np.float32)
    g = tp.seeded_normal((2, 8, 512), 3)
    ci = np.array([3, 17, 200, 3] if pad else [3, 17, 200], np.int32)
    valid = np.array([True, True, True, False][:len(ci)])
    if base == "int8":
        wq, sw = jquant.quantize_weight(jnp.asarray(w))
        frozen = {"wq": np.asarray(wq), "sw": np.asarray(sw)}
        wd = np.asarray(jquant.dequantize_weight(wq, sw, jnp.float32))
    elif base == "int4":
        w4, s4 = jquant.quantize_weight_int4(jnp.asarray(w))
        frozen = {"w4": np.asarray(w4), "s4": np.asarray(s4)}
        wd = np.asarray(jquant.dequantize_weight_int4(w4, s4, jnp.float32))
    else:
        frozen, wd = {"w": w}, w
    base_cols = wd[:, ci]
    cols = base_cols + tp.seeded_normal((512, 4), 4, 0.02)[:, :len(ci)]
    if pad:
        cols[:, 3] += 123.0
    return x, g, cols, ci, valid, frozen, base_cols


def _port_dyn(x, cols, ci, valid, frozen, base_cols, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cols).requires_grad_(True)
    y = sparse_linear.smt_channel_linear_dyn(
        xt, ct, torch.from_numpy(ci), torch.from_numpy(valid),
        {k: torch.from_numpy(np.array(v)) for k, v in frozen.items()},
        torch.from_numpy(base_cols))
    y.backward(torch.from_numpy(g))
    return y, xt.grad, ct.grad


@pytest.mark.parametrize("base", ["dense", "int8", "int4"])
def test_smt_channel_linear_dyn_matches_jax_vjp(base):
    x, g, cols, ci, valid, frozen, base_cols = _dyn_inputs(base)

    @jax.jit
    def jax_vjp(x, cols, g):
        y, pull = jax.vjp(lambda x, c: jax_channel_linear_dyn(
            "oracle", x, c, jnp.asarray(ci), jnp.asarray(valid),
            {k: jnp.asarray(v) for k, v in frozen.items()}, jnp.asarray(base_cols)), x, cols)
        return (y,) + pull(g)

    want = jax_vjp(jnp.asarray(x), jnp.asarray(cols), jnp.asarray(g))
    got = _port_dyn(x, cols, ci, valid, frozen, base_cols, g)
    for name, p, w, tol in (("y", got[0], want[0], Y_TOL), ("grad_x", got[1], want[1], GRAD_X_TOL),
                            ("grad_cols", got[2], want[2], Y_TOL)):
        np.testing.assert_allclose(tp.np32(p), np.asarray(w), rtol=tol, atol=tol, err_msg=name)
    assert got[2][:, 3].abs().max() == 0 and np.abs(np.asarray(want[2])[:, 3]).max() == 0


def test_channel_dyn_zero_delta_is_the_int8_base():
    """Columns equal to the dequantized base: the correction adds nothing,
    y is the int8 base's product (K4's plain version), as in JAX."""
    x, g, _, ci, valid, frozen, base_cols = _dyn_inputs("int8")
    y, _, _ = _port_dyn(x, base_cols, ci, valid, frozen, base_cols, g)
    want = q8_matmul_t(torch.from_numpy(x).reshape(16, 256),
                       *(torch.from_numpy(np.array(frozen[k])) for k in ("wq", "sw")))
    tp.assert_close(y.reshape(16, 512), want, rtol=ZERO_DELTA_TOL, atol=ZERO_DELTA_TOL)


def test_channel_dyn_padded_entries_are_inert():
    """A padded entry (a duplicate channel, invalid, any value) changes
    neither y nor grad_x nor the real entries' grads, and gets 0."""
    x, g, *padded = _dyn_inputs("int8", pad=True)
    _, _, *plain = _dyn_inputs("int8", pad=False)
    got, want = _port_dyn(x, *padded, g), _port_dyn(x, *plain, g)
    tp.assert_close(got[0], want[0], rtol=ZERO_DELTA_TOL, atol=ZERO_DELTA_TOL)
    tp.assert_close(got[1], want[1], rtol=ZERO_DELTA_TOL, atol=ZERO_DELTA_TOL)
    tp.assert_close(got[2][:, :3], want[2], rtol=ZERO_DELTA_TOL, atol=ZERO_DELTA_TOL)
    assert got[2][:, 3].abs().max() == 0


# ---------------------------------------------------------------------------
# the state, the steps, the eval loss and the export
# ---------------------------------------------------------------------------

def test_state_matches_jax_leaf_for_leaf(ckpt):
    jcfg, pcfg = _configs()
    jstate, jhost = jscan.build_scan_state_from_hf(jcfg, ckpt, _jax_plan(), JCFG)
    pstate, phost = scan_phase.build_scan_state_from_hf(pcfg, ckpt, plan_from_jax(_jax_plan()),
                                                        PCFG, device="cpu")
    assert {"m", "v", "count", "step", "q_head"} <= set(pstate)
    tp.assert_same_leaves(pstate, tp.numpy_tree(jstate))
    tp.assert_same_leaves(phost, tp.numpy_tree(jhost))
    assert pstate["idx"]["q_proj"]["ci"].tolist() == [[3, 17, 200], [9, 9, 9]]
    assert pstate["idx"]["q_proj"]["valid"].tolist() == [[True] * 3, [True, False, False]]
    assert pstate["idx"]["down_proj"]["valid"].tolist() == [[False] * 3, [True] * 3]
    assert tuple(pstate["trainable"]["down_proj"].shape) == (2, 256, 3)


def _dense_base(jstate):
    """The JAX state over a dense base: each layer linear its dequantized
    int8 weight ({"w"} in the dispatch), no int8 leaves."""
    jstate = dict(jstate, params=dict(jstate["params"]))
    stacked = dict(jstate["params"]["layers_stacked"])
    for mod, q in jstate.pop("q").items():
        stacked[mod] = jax.vmap(lambda wq, sw: jquant.dequantize_weight(wq, sw, jnp.float32))(
            q["wq"], q["sw"])
    jstate["params"]["layers_stacked"] = stacked
    return jstate


@pytest.fixture(scope="module", params=["int8", "dense"], ids=["int8", "dense-base"])
def stepped(request, ckpt):
    """N_STEPS channel sparse steps of both packages on the same batches,
    from the JAX state carried across; the dense case over the int8
    state's dequantized weights, with the bf16 head and the q/k LR boost."""
    base = request.param
    kw = {}
    if base == "dense":
        kw.update(head_quant="none", smt_lr=1e-3, qk_scheduler=True, qk_lr_times=3)
    jcfg, pcfg = _configs(**kw)
    jplan = _jax_plan()
    jstate, jhost = jscan.build_scan_state_from_hf(jcfg, ckpt, jplan, JCFG)
    if base == "dense":
        jstate = _dense_base(jstate)
    start = tp.numpy_tree(jstate)["trainable"]
    pstate = scan_phase.attach_schedules(scan_state_from_jax(tp.numpy_tree(jstate)))
    jstep = jax.jit(jscan.build_scan_sparse_step(
        jcfg, JCFG, jplan, jax_lr_schedule("constant", jcfg.smt_lr, 0, N_STEPS)))
    pstep = scan_phase.build_scan_sparse_step(
        pcfg, PCFG, plan_from_jax(jplan), make_lr_schedule("constant", pcfg.smt_lr, 0, N_STEPS))
    out = {"jax": [], "port": []}
    for batch in tp.lm_batches(N_STEPS, vocab=VOCAB, pad_from=24):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        out["jax"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(pm["loss"]), float(pm["grad_norm"])))
    return dict(out, base=base, jstate=jstate, pstate=pstate, jhost=jhost, jcfg=jcfg, pcfg=pcfg,
                start=start)


def test_sparse_steps_match_jax(stepped):
    """Losses and grad norms step for step; the channel betas (0.95,
    0.999); padded entries with zero moments, moved by the weight decay
    only. Over the dense base the trainables and moments agree elementwise,
    over the int8 base their norms as tests/test_torch_scan_train.py holds
    the matrix steps'."""
    rtol = INT8_LOSS_RTOL if stepped["base"] == "int8" else DENSE_RTOL
    jl, pl = np.array(stepped["jax"]), np.array(stepped["port"])
    assert pl[0, 0] == pytest.approx(jl[0, 0], rel=1e-5)
    np.testing.assert_allclose(pl[:, 0], jl[:, 0], rtol=rtol, err_msg="losses")
    np.testing.assert_allclose(pl[:, 1], jl[:, 1], rtol=rtol, err_msg="grad norms")
    ps, js = stepped["pstate"], tp.numpy_tree(stepped["jstate"])
    assert int(ps["count"]) == int(js["count"]) == int(ps["step"]) == N_STEPS
    for mod in ps["trainable"]:
        pad = ~ps["idx"][mod]["valid"].numpy()[:, None, :].repeat(
            ps["trainable"][mod].shape[1], axis=1)
        assert not tp.np32(ps["m"][mod])[pad].any() and not tp.np32(ps["v"][mod])[pad].any()
        np.testing.assert_allclose(tp.np32(ps["trainable"][mod])[pad], js["trainable"][mod][pad],
                                   rtol=1e-6, err_msg=mod)
        if stepped["base"] == "int8":
            change = tp.np32(ps["trainable"][mod]) - stepped["start"][mod]
            want = js["trainable"][mod] - stepped["start"][mod]
            assert np.linalg.norm(change - want) <= 0.1 * np.linalg.norm(want), mod
            m, want_m = tp.np32(ps["m"][mod]), js["m"][mod]
            assert np.linalg.norm(m - want_m) <= 0.03 * np.linalg.norm(want_m), mod
        else:
            for leaf in ("trainable", "m", "v"):
                want = js[leaf][mod]
                atol = 0.1 * stepped["pcfg"].smt_lr if leaf == "trainable" else \
                    1e-4 * np.abs(want).max()
                np.testing.assert_allclose(tp.np32(ps[leaf][mod]), want, rtol=1e-4, atol=atol,
                                           err_msg=f"{leaf} {mod}")


def test_eval_loss_matches_jax(stepped):
    batch = tp.lm_batches(1, vocab=VOCAB, seed=9, pad_from=20)[0]
    jplan = _jax_plan()
    want = float(jax.jit(jscan.build_scan_eval_step(stepped["jcfg"], JCFG, jplan))(
        stepped["jstate"], {k: jnp.asarray(v) for k, v in batch.items()}))
    pstate = scan_phase.attach_schedules(scan_state_from_jax(tp.numpy_tree(stepped["jstate"])))
    got = float(scan_phase.build_scan_eval_step(stepped["pcfg"], PCFG, plan_from_jax(jplan))(
        pstate, {k: torch.from_numpy(v).long() for k, v in batch.items()}))
    assert got == pytest.approx(want, rel=INT8_LOSS_RTOL if stepped["base"] == "int8"
                                else DENSE_RTOL)


def test_export_equals_jax_bit_for_bit(stepped):
    """A JAX-trained channel state carried across gives JAX's merged params
    bit for bit: the checkpoint's weights with the valid trained columns
    written in."""
    jplan = _jax_plan()
    jhost = stepped["jhost"]
    want = tp.numpy_tree(jscan.merged_params_from_scan(stepped["jstate"], jplan, JCFG, jhost))
    pstate = scan_state_from_jax(tp.numpy_tree(stepped["jstate"]))
    phost = {k: torch.from_numpy(np.asarray(v)) for k, v in jhost.items()}
    got = scan_phase.merged_params_from_scan(pstate, plan_from_jax(jplan), PCFG, phost)
    tp.assert_same_leaves(got, want)
    w = got["layers"]["1"]["down_proj"]
    assert torch.equal(w[:, [511, 0, 300]], pstate["trainable"]["down_proj"][1])
    assert torch.equal(got["layers"]["0"]["down_proj"], phost["down_proj"][0])


def test_layers_without_a_valid_column_run_the_frozen_linear(ckpt, monkeypatch):
    """attach_schedules marks, once, the (module, layer)s with a valid
    column; a step and the eval run smt_channel_linear_dyn there only (the
    others add a zero delta and get zero grads in JAX, so they run the
    frozen linear), and read no index on the host."""
    calls = []
    real = scan_phase.smt_channel_linear_dyn

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(scan_phase, "smt_channel_linear_dyn", counting)
    _, pcfg = _configs()
    pstate, _ = scan_phase.build_scan_state_from_hf(pcfg, ckpt, plan_from_jax(_jax_plan()),
                                                    PCFG, device="cpu")
    scan_phase.attach_schedules(pstate)
    assert pstate["sched"]["v_proj"] == [False, True] and pstate["sched"]["q_proj"] == [True] * 2
    live = sum(map(sum, pstate["sched"].values()))
    assert live == len(SELECTED) == 8
    step = scan_phase.build_scan_sparse_step(pcfg, PCFG, plan_from_jax(_jax_plan()),
                                             make_lr_schedule("constant", 1e-4, 0, 4))
    batch = {k: torch.from_numpy(v).long() for k, v in tp.lm_batches(1, vocab=VOCAB)[0].items()}
    step(pstate, batch)
    assert len(calls) == 2 * live   # the forward and remat's recompute in the backward
    assert pstate["trainable"]["v_proj"][0].abs().sum() > 0   # the dead layer keeps its values
    assert not pstate["m"]["v_proj"][0].any() and pstate["m"]["v_proj"][1].any()


# ---------------------------------------------------------------------------
# the decode over the channel scan state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_params(ckpt):
    """{frozen_quant: (JAX decode params, the port's)} from one planned JAX
    int8 channel state, its columns moved off the loaded values by a seeded
    perturbation, as training would."""
    jcfg, _ = _configs(head_quant="none")
    jstate, _ = jscan.build_scan_state_from_hf(jcfg, ckpt, _jax_plan(), JCFG, keep_host=False)
    rng = np.random.default_rng(7)
    jstate["trainable"] = {
        m: t + jnp.asarray(0.02 * rng.standard_normal(t.shape).astype(np.float32))
        for m, t in jstate["trainable"].items()}
    pstate = scan_state_from_jax(tp.numpy_tree(jstate))
    out = {}
    for fq in ("int8", "int4"):
        ps = dict(pstate, q=dict(pstate["q"]))  # consume empties a copy
        out[fq] = (jgen.decode_params_from_scan(jstate, JCFG, frozen_quant=fq),
                   pgen.decode_params_from_scan(ps, PCFG, frozen_quant=fq, consume=True))
    return out


def _prompts(seed, lens=(16, 11, 7), width=16):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), width), np.int32)
    mask = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):   # left padded
        ids[i, width - n:] = rng.integers(3, VOCAB, n)
        mask[i, width - n:] = 1
    return ids, mask


@pytest.mark.parametrize("fq", ["int8", "int4"])
def test_decode_params_and_prefill_logits_match_jax(decode_params, fq):
    """The column delta is built once per (module, layer), in the param
    dtype; the prefill logits within 1e-4 of JAX's, as
    tests/test_torch_q4_decode.py holds the matrix decode."""
    jp, pp = decode_params[fq]
    layers = pp["layers_q8"]["layers"]
    corr = layers[1]["corr"]["down_proj"]
    assert tuple(corr[0].shape) == (256, 3) and corr[1].tolist() == [511, 0, 300]
    assert layers[0]["corr"]["down_proj"] is None   # no valid column there
    ids, mask = _prompts(6, lens=(16, 11), width=16)
    cache = jllama.init_cache(JCFG, 2, 16, dtype=jnp.float32, stacked=True)
    positions = np.maximum(mask.cumsum(-1) - 1, 0)
    want, _ = jllama.forward_with_cache(jp, jnp.asarray(ids), JCFG, cache, 0, jnp.asarray(mask),
                                        jnp.asarray(positions))
    pcache = llama.init_cache(PCFG, 2, 16, dtype=torch.float32)
    got, _ = llama.forward_with_cache(pp, torch.from_numpy(ids).long(), PCFG, pcache, 0,
                                      torch.from_numpy(mask), torch.from_numpy(positions).long())
    real = mask.astype(bool)
    np.testing.assert_allclose(tp.np32(got)[real], np.asarray(want)[real], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fq", ["int8", "int4"])
def test_greedy_tokens_match_jax(decode_params, fq):
    jp, pp = decode_params[fq]
    ids, mask = _prompts(11)
    kw = {"max_new_tokens": 6, "eos_token_id": 2, "pad_token_id": 0, "cache_dtype": "float32",
          "num_beams": 1}
    want = jgen.generate(jp, JCFG, ids, mask, jgen.GenerationConfig(**kw))
    got = pgen.generate(pp, PCFG, ids, mask, pgen.GenerationConfig(**kw), device="cpu")
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the trainer entry and the CLI
# ---------------------------------------------------------------------------

def test_trainer_sparse_scan_from_hf_trains_and_exports(ckpt, tmp_path):
    _, pcfg = _configs(smt_lr=1e-2, output_dir=str(tmp_path))
    plan = plan_from_jax(_jax_plan())
    t = SMTTrainer.sparse_scan_from_hf(pcfg, ckpt, plan, total_steps=6, model_cfg=PCFG,
                                       device="cpu")
    assert t.phase == "sparse" and t._host_frozen is not None
    assert t.state["sched"]["down_proj"] == [False, True]
    losses = [float(t.train_step(b)["loss"]) for b in tp.lm_batches(6, vocab=VOCAB)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.isfinite(t.evaluate(tp.lm_batches(1, vocab=VOCAB, seed=5))[1])
    t._save("final")
    back = load_hf_params(str(tmp_path / "final"), PCFG, dtype=torch.float32)
    assert torch.equal(back["layers"]["0"]["gate_proj"][:, [1, 255]],
                       t.state["trainable"]["gate_proj"][0, :, :2].detach())
    assert torch.equal(back["layers"]["0"]["k_proj"], t._host_frozen["k_proj"][0])
    assert "layers_q8" in t.decode_params()


def test_fine_tune_cli_channel_sparse_from_plan(tmp_path):
    """The CLI with a channel plan: quantize-on-load, sparse steps only,
    eval, the final export with the plan."""
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main

    d, data = _write_cli_ckpt(tmp_path)
    plan_path = tmp_path / "smt_plan.json"
    plan_path.write_text(plan_from_jax(_jax_plan()).to_json())
    out = tmp_path / "out"
    history = main(["--model_name_or_path", d, "--data_path", data, "--output_dir", str(out),
                    "--device", "cpu", "--channel_sparsity", "--frozen_quant", "int8",
                    "--sparse_from_plan", str(plan_path), "--per_device_ft_batch_size", "2",
                    "--per_device_eval_batch_size", "2", "--num_ft_epochs", "1",
                    "--max_seq_len", "64", "--eval_step", "3", "--dtype", "fp32",
                    "--smt_lr", "1e-3"])
    assert len(history["train_loss"]) >= 3 and np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["eval_loss"]).all()
    assert (out / "final" / "smt_plan.json").read_text() == plan_path.read_text()
    assert (out / "final" / "model.safetensors").exists()
