"""Continuation training over the int8 scan state (--sparse_from_plan)
against the JAX package, at LlamaConfig.tiny size (2 layers, fp32, CPU):
smt_linear_dyn's forward and gradients against the JAX custom VJP over an
int8, an int4 and a dense base; quantize-on-load leaf for leaf, Adam state
included; four scan sparse steps and the eval loss from one carried state;
the export bit for bit; the trainer entry, the CLI, and K5's schedules
built once; a channel plan accepted by the trainer entry. The plan pads
its modules (uneven per-layer counts) and leaves a planned module out of
one layer."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.ops import quant as jquant
from sparse_matrix_tuning_tpu.ops.sparse_linear import smt_linear_dyn as jax_smt_linear_dyn
from sparse_matrix_tuning_tpu.smt.optimizer import make_lr_schedule as jax_lr_schedule
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu.train import scan_phase as jscan
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.models.from_jax import plan_from_jax, scan_state_from_jax
from sparse_matrix_tuning_tpu_torch.models.hf_io import (
    load_hf_params, read_safetensor, safetensors_header, write_safetensors)
from sparse_matrix_tuning_tpu_torch.ops import sparse_linear
from sparse_matrix_tuning_tpu_torch.smt.optimizer import make_lr_schedule
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, SMTPlan
from sparse_matrix_tuning_tpu_torch.train import scan_phase
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

VOCAB = 256
JCFG = jllama.LlamaConfig.tiny(vocab_size=VOCAB)
PCFG = llama.LlamaConfig.tiny(vocab_size=VOCAB)
SHAPES = {"q_proj": (256, 256), "k_proj": (128, 256), "v_proj": (128, 256),
          "o_proj": (256, 256), "gate_proj": (512, 256), "up_proj": (512, 256),
          "down_proj": (256, 512)}
# uneven per-layer counts (padded), q_proj and down_proj absent from one layer
SELECTED = {("q_proj", 0): [(0, 0)], ("gate_proj", 0): [(1, 0), (0, 0)],
            ("gate_proj", 1): [(0, 0)], ("up_proj", 0): [(1, 0)], ("up_proj", 1): [(0, 0)],
            ("down_proj", 1): [(0, 1), (0, 0)]}
# the JAX suite's smt_linear_dyn tolerance (tests/test_scan_ops.py:92-94)
DYN_RTOL = DYN_ATOL = 2e-5
# int8 sparse steps from one state: tests/test_torch_train_e2e.py's bound.
# Rounding to int8 is not continuous: an activation whose last fp32 bit
# differs between the frameworks (layer norms, sums in another order) can
# take the neighbouring int8 step, and Adam's first updates, lr * sign(g)
# where |g| >> eps, turn the small grad differences that follow into whole
# steps. Measured over these 4 steps: first loss 6.9e-6 apart, then losses
# and grad norms up to 4.1e-3 apart at smt_lr 1e-3 and up to 5.8e-4 at
# smt_lr 1e-4, the rate used here. Over a dense base the same steps agree
# to 6.3e-7 (DENSE_RTOL), which holds the step's logic itself.
INT8_LOSS_RTOL = 1e-3
DENSE_RTOL = 1e-5
# What the int8 steps did to the state, per module, as a share of JAX's:
# the norm of (port - JAX) over the trainables' change in the 4 steps, and
# over the first moment m (linear in the grads, so it holds the backward
# inside the step). Measured: up to 4.1e-2 and 1.1e-2 (the Adam updates of
# near-zero grads flip, as above); with K1's grads zeroed both read 1.0
# (only the weight decay moves the trainables), and the change's norm
# alone then falls by 99.9%.
INT8_CHANGE_RTOL = 0.1
INT8_M_RTOL = 0.03
N_STEPS = 4


def _cfg_kwargs(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                matrix_sparsity=True, frozen_quant="int8", smt_lr=1e-4, w_decay=0.01,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                max_seq_len=32, seq_buckets=[32], seed=0)
    base.update(kw)
    return base


def _configs(**kw):
    return (JaxSMTConfig(**_cfg_kwargs(sparse_impl="oracle", **kw)),
            SMTConfig(**_cfg_kwargs(**kw)))


def _write_ckpt(d):
    rng = np.random.default_rng(0)
    ts = {"model.embed_tokens.weight": rng.standard_normal((VOCAB, 256)) * 0.05,
          "model.norm.weight": 1 + 0.1 * rng.standard_normal(256),
          "lm_head.weight": rng.standard_normal((VOCAB, 256)) * 0.05}
    for l in range(2):
        p = f"model.layers.{l}."
        ts[p + "input_layernorm.weight"] = 1 + 0.1 * rng.standard_normal(256)
        ts[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rng.standard_normal(256)
        for mod, shape in SHAPES.items():
            group = "mlp" if mod in ("gate_proj", "up_proj", "down_proj") else "self_attn"
            ts[f"{p}{group}.{mod}.weight"] = rng.standard_normal(shape) * 0.05
    d.mkdir(parents=True, exist_ok=True)
    write_safetensors({k: torch.from_numpy(v.astype(np.float32)) for k, v in ts.items()},
                      str(d / "model.safetensors"))
    hf = dict(model_type="llama", vocab_size=VOCAB, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
              tie_word_embeddings=False)
    (d / "config.json").write_text(json.dumps(hf))
    return str(d)


def _jax_plan():
    dims = {(m, l): SHAPES[m] for m in SHAPES for l in range(2)}
    return JaxSMTPlan.from_selection("matrix", SELECTED, dims)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_ckpt(tmp_path_factory.mktemp("scan_train_ckpt"))


# ---------------------------------------------------------------------------
# smt_linear_dyn: forward and gradients against the JAX custom VJP
# ---------------------------------------------------------------------------

def _dyn_inputs(base: str):
    """gate_proj-shaped (512, 256) weight, 3 entries with the last padded
    (a junk value: it must not matter), x of 16 rows. x is bf16-exact: the
    port's int4 route casts x to bf16 at decode rows (the TPU kernel's
    rule), JAX's CPU route does not."""
    w = tp.seeded_normal((512, 256), 1, 0.05)
    x = np.asarray(jnp.asarray(tp.seeded_normal((2, 8, 256), 2), jnp.bfloat16), np.float32)
    g = tp.seeded_normal((2, 8, 512), 3)
    rb, cb = np.array([1, 0, 1], np.int32), np.array([0, 0, 0], np.int32)
    valid = np.array([True, True, False])
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
    wd4 = wd.reshape(2, BLOCK, 1, BLOCK)
    base_blocks = np.stack([wd4[r, :, c, :] for r, c in zip(rb, cb)])
    blocks = base_blocks + tp.seeded_normal(base_blocks.shape, 4, 0.02)
    blocks[2] += 123.0
    return x, g, blocks, rb, cb, valid, frozen, base_blocks


@pytest.mark.parametrize("base", ["int8", "int4", "dense"])
def test_smt_linear_dyn_grads_match_jax_vjp(base):
    x, g, blocks, rb, cb, valid, frozen, base_blocks = _dyn_inputs(base)

    # jitted, as every JAX call site of the training step is (the int8 row
    # scales are then amax * fp32(1/127), as the port computes them)
    @jax.jit
    def jax_vjp(x, blocks, g):
        y, pull = jax.vjp(lambda x, b: jax_smt_linear_dyn(
            "oracle", x, b, jnp.asarray(rb), jnp.asarray(cb), jnp.asarray(valid),
            {k: jnp.asarray(v) for k, v in frozen.items()}, jnp.asarray(base_blocks)), x, blocks)
        return (y,) + pull(g)

    want = jax_vjp(jnp.asarray(x), jnp.asarray(blocks), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(blocks).requires_grad_(True)
    y = sparse_linear.smt_linear_dyn(
        xt, bt, torch.from_numpy(rb), torch.from_numpy(cb), torch.from_numpy(valid),
        {k: torch.from_numpy(np.array(v)) for k, v in frozen.items()},
        torch.from_numpy(base_blocks))
    y.backward(torch.from_numpy(g))
    for name, got, w in (("y", y, want[0]), ("grad_x", xt.grad, want[1]),
                         ("grad_blocks", bt.grad, want[2])):
        np.testing.assert_allclose(tp.np32(got), np.asarray(w), rtol=DYN_RTOL, atol=DYN_ATOL,
                                   err_msg=name)
    assert bt.grad[2].abs().max() == 0 and np.abs(np.asarray(want[2][2])).max() == 0


def test_decode_correction_has_no_backward():
    """A decode's precomputed correction serves the forward only: asked
    for a gradient, smt_linear_dyn refuses it instead of dropping it."""
    x, g, blocks, rb, cb, valid, frozen, base_blocks = _dyn_inputs("int8")
    args = [torch.from_numpy(a) for a in (rb, cb, valid)]
    frozen = {k: torch.from_numpy(np.array(v)) for k, v in frozen.items()}
    bt, base_t = torch.from_numpy(blocks), torch.from_numpy(base_blocks)
    corr = sparse_linear.dyn_correction(bt, base_t, *args, torch.float32, "cpu")
    xt = torch.from_numpy(x)
    want = sparse_linear.smt_linear_dyn(xt, bt, *args, frozen, base_t)
    assert torch.equal(sparse_linear.smt_linear_dyn(xt, bt, *args, frozen, base_t, corr), want)
    with pytest.raises(ValueError, match="no backward"):
        sparse_linear.smt_linear_dyn(xt.requires_grad_(True), bt, *args, frozen, base_t, corr)


# ---------------------------------------------------------------------------
# the state, the steps, the eval loss and the export
# ---------------------------------------------------------------------------

def test_state_matches_jax_leaf_for_leaf(ckpt):
    jcfg, pcfg = _configs()
    jstate, jhost = jscan.build_scan_state_from_hf(jcfg, ckpt, _jax_plan(), JCFG)
    pstate, phost = scan_phase.build_scan_state_from_hf(pcfg, ckpt, plan_from_jax(_jax_plan()),
                                                        PCFG, device="cpu")
    jstate = tp.numpy_tree(jstate)
    assert {"m", "v", "count", "step", "q_head"} <= set(pstate)
    tp.assert_same_leaves(pstate, jstate)
    tp.assert_same_leaves(phost, tp.numpy_tree(jhost))
    assert pstate["idx"]["q_proj"]["valid"].tolist() == [[True], [False]]
    assert pstate["idx"]["gate_proj"]["valid"].tolist() == [[True, True], [True, False]]


def _port_step(pcfg):
    sched = make_lr_schedule("constant", pcfg.smt_lr, 0, N_STEPS)
    return scan_phase.build_scan_sparse_step(pcfg, PCFG, plan_from_jax(_jax_plan()), sched)


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


@pytest.fixture(scope="module", params=[("int8", False), ("int8", True), ("dense", False),
                                        ("dense", True)],
                ids=["int8", "int8-qk-boost", "dense-base", "dense-base-qk-boost"])
def stepped(request, ckpt):
    """N_STEPS sparse steps of both packages on the same batches, from the
    JAX state carried across; the dense cases over the int8 state's
    dequantized weights, with the bf16 head."""
    base, qk = request.param
    kw = dict(qk_scheduler=qk, qk_lr_times=3)
    if base == "dense":
        kw.update(head_quant="none", smt_lr=1e-3)
    jcfg, pcfg = _configs(**kw)
    jplan = _jax_plan()
    jstate, jhost = jscan.build_scan_state_from_hf(jcfg, ckpt, jplan, JCFG)
    if base == "dense":
        jstate = _dense_base(jstate)
    start = tp.numpy_tree(jstate)["trainable"]
    pstate = scan_phase.attach_schedules(scan_state_from_jax(tp.numpy_tree(jstate)))
    jstep = jax.jit(jscan.build_scan_sparse_step(
        jcfg, JCFG, jplan, jax_lr_schedule("constant", jcfg.smt_lr, 0, N_STEPS)))
    pstep = _port_step(pcfg)
    out = {"jax": [], "port": []}
    for batch in tp.lm_batches(N_STEPS, vocab=VOCAB, pad_from=24):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        out["jax"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(pm["loss"]), float(pm["grad_norm"])))
    return dict(out, base=base, jstate=jstate, pstate=pstate, jhost=jhost, jcfg=jcfg, pcfg=pcfg,
                start=start)


def test_sparse_steps_match_jax(stepped):
    rtol = INT8_LOSS_RTOL if stepped["base"] == "int8" else DENSE_RTOL
    jl, pl = np.array(stepped["jax"]), np.array(stepped["port"])
    assert pl[0, 0] == pytest.approx(jl[0, 0], rel=1e-5)
    np.testing.assert_allclose(pl[:, 0], jl[:, 0], rtol=rtol, err_msg="losses")
    np.testing.assert_allclose(pl[:, 1], jl[:, 1], rtol=rtol, err_msg="grad norms")
    ps, js = stepped["pstate"], tp.numpy_tree(stepped["jstate"])
    assert int(ps["count"]) == int(js["count"]) == int(ps["step"]) == N_STEPS
    for mod in ps["trainable"]:
        pad = ~ps["idx"][mod]["valid"].numpy()
        # a padded entry has zero grads, so zero moments; weight decay moves it
        assert not tp.np32(ps["m"][mod])[pad].any() and not tp.np32(ps["v"][mod])[pad].any()
        np.testing.assert_allclose(tp.np32(ps["trainable"][mod])[pad], js["trainable"][mod][pad],
                                   rtol=1e-6, err_msg=mod)
        if stepped["base"] == "int8":
            change = tp.np32(ps["trainable"][mod]) - stepped["start"][mod]
            want = js["trainable"][mod] - stepped["start"][mod]
            assert np.linalg.norm(change - want) <= INT8_CHANGE_RTOL * np.linalg.norm(want), mod
            m, want_m = tp.np32(ps["m"][mod]), js["m"][mod]
            assert np.linalg.norm(m - want_m) <= INT8_M_RTOL * np.linalg.norm(want_m), mod
        else:
            # an element whose grad is near 0 moves by up to lr * sign(g) in
            # Adam's first steps, so its last-bit grad differences can move
            # it by a share of lr (2e-5 measured): atol is a tenth of one
            # step; the moments within 1e-4 of their largest value
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
    assert got == pytest.approx(want, rel=INT8_LOSS_RTOL)


def test_export_equals_jax_bit_for_bit(stepped, ckpt):
    """A JAX-trained state carried across gives JAX's merged params bit for
    bit, and the unplanned layer weights are the checkpoint's."""
    jplan = _jax_plan()
    jhost = stepped["jhost"]
    want = tp.numpy_tree(jscan.merged_params_from_scan(stepped["jstate"], jplan, JCFG, jhost))
    pstate = scan_state_from_jax(tp.numpy_tree(stepped["jstate"]))
    phost = {k: torch.from_numpy(np.asarray(v)) for k, v in jhost.items()}
    got = scan_phase.merged_params_from_scan(pstate, plan_from_jax(jplan), PCFG, phost)
    tp.assert_same_leaves(got, want)
    path = ckpt + "/model.safetensors"
    base, header = safetensors_header(path)
    for l in range(2):
        for mod in ("k_proj", "o_proj"):
            name = [n for n in header if n.endswith(f"layers.{l}.self_attn.{mod}.weight")][0]
            assert torch.equal(got["layers"][str(l)][mod],
                               read_safetensor(path, base, header[name], name))
    # the host store itself is left as it was loaded
    assert torch.equal(phost["gate_proj"], torch.from_numpy(np.asarray(jhost["gate_proj"])))


def test_schedules_are_built_once(ckpt, monkeypatch):
    """K5's schedules and the keep indices come from the state's "sched",
    built once before the first step (the trainer does it when it installs
    the sparse phase): the steps and the eval build none."""
    calls = []
    real = sparse_linear.correction_schedule

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(sparse_linear, "correction_schedule", counting)
    _, pcfg = _configs()
    pstate, _ = scan_phase.build_scan_state_from_hf(pcfg, ckpt, plan_from_jax(_jax_plan()),
                                                    PCFG, device="cpu")
    assert not calls and "sched" not in pstate
    scan_phase.attach_schedules(pstate)
    first = len(calls)
    assert first == 2 * 2 * len(pstate["idx"])   # forward and grad_input, per (module, layer)
    step = _port_step(pcfg)
    batches = [{k: torch.from_numpy(v).long() for k, v in b.items()}
               for b in tp.lm_batches(3, vocab=VOCAB)]
    step(pstate, batches[0])
    step(pstate, batches[1])
    scan_phase.build_scan_eval_step(pcfg, PCFG, plan_from_jax(_jax_plan()))(pstate, batches[2])
    assert len(calls) == first


# ---------------------------------------------------------------------------
# the trainer entry and the CLI
# ---------------------------------------------------------------------------

def test_trainer_sparse_scan_from_hf_trains_and_exports(ckpt, tmp_path):
    _, pcfg = _configs(smt_lr=1e-2, output_dir=str(tmp_path))
    plan = plan_from_jax(_jax_plan())
    t = SMTTrainer.sparse_scan_from_hf(pcfg, ckpt, plan, total_steps=6, model_cfg=PCFG,
                                       device="cpu")
    assert t.phase == "sparse" and t._host_frozen is not None and "sched" in t.state
    losses = [float(t.train_step(b)["loss"]) for b in tp.lm_batches(6, vocab=VOCAB)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert t.step == 6 and np.isfinite(t.evaluate(tp.lm_batches(1, vocab=VOCAB, seed=5))[1])
    t._save("final")
    back = load_hf_params(str(tmp_path / "final"), PCFG, dtype=torch.float32)
    merged = t.merged_params()
    for l in range(2):
        for mod in SHAPES:
            assert torch.equal(back["layers"][str(l)][mod], merged["layers"][str(l)][mod])
    w = back["layers"]["1"]["gate_proj"].view(2, BLOCK, 1, BLOCK)
    assert torch.equal(w[0, :, 0, :], t.state["trainable"]["gate_proj"][1, 0].detach())
    assert "layers_q8" in t.decode_params()


@pytest.mark.parametrize("mode", ["channel", "int8-required"])
def test_trainer_entry_refusals(ckpt, mode):
    plan = plan_from_jax(_jax_plan())
    if mode == "channel":
        # channel mode is ported: the entry builds a channel scan state
        # (tests/test_torch_channel_scan.py holds it against JAX)
        plan = SMTPlan.from_selection("channel", {("q_proj", 0): [3, 17], ("down_proj", 1): [5]},
                                      {("q_proj", 0): SHAPES["q_proj"],
                                       ("down_proj", 1): SHAPES["down_proj"]})
        t = SMTTrainer.sparse_scan_from_hf(SMTConfig(**_cfg_kwargs(
            matrix_sparsity=False, channel_sparsity=True, sparse_from_plan="smt_plan.json")),
            ckpt, plan, 4, PCFG, device="cpu")
        assert t.phase == "sparse" and t.plan.mode == "channel"
        assert set(t.state["idx"]["q_proj"]) == {"ci", "valid"}
        assert tuple(t.state["trainable"]["q_proj"].shape) == (2, 256, 2)
        assert tuple(t.state["trainable"]["down_proj"].shape) == (2, 256, 1)
        assert "q_head" in t.state and t.state["sched"] == {"q_proj": [True, False],
                                                            "down_proj": [False, True]}
        return
    with pytest.raises(ValueError, match="--frozen_quant int8"):
        SMTTrainer.sparse_scan_from_hf(SMTConfig(**_cfg_kwargs(frozen_quant="none")), ckpt, plan,
                                       4, PCFG, device="cpu")


def _write_cli_ckpt(tmp_path):
    """_write_ckpt's checkpoint with a tokenizer, and an alpaca JSON:
    (checkpoint dir, data path) for the fine-tune CLI."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    d = tmp_path / "ckpt"
    _write_ckpt(d)
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(["### Instruction: ### Response: the quick brown fox"] * 50,
                            trainers.BpeTrainer(vocab_size=200, special_tokens=[
                                "<pad>", "<unk>", "<s>", "</s>"]))
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>").save_pretrained(d)
    data = tmp_path / "train.json"
    data.write_text(json.dumps([{"instruction": f"Repeat fox {i}",
                                 "output": "the quick brown fox"} for i in range(16)]))
    return str(d), str(data)


def test_fine_tune_cli_sparse_from_plan(tmp_path):
    """The CLI on a tiny HF checkpoint with a tokenizer: quantize-on-load,
    sparse steps only, eval, the final export."""
    from sparse_matrix_tuning_tpu_torch.cli.fine_tune import main

    d, data = _write_cli_ckpt(tmp_path)
    plan_path = tmp_path / "smt_plan.json"
    plan_path.write_text(plan_from_jax(_jax_plan()).to_json())
    out = tmp_path / "out"
    history = main(["--model_name_or_path", str(d), "--data_path", str(data),
                    "--output_dir", str(out), "--device", "cpu", "--matrix_sparsity",
                    "--frozen_quant", "int8", "--sparse_from_plan", str(plan_path),
                    "--per_device_ft_batch_size", "2", "--per_device_eval_batch_size", "2",
                    "--num_ft_epochs", "1", "--max_seq_len", "64", "--eval_step", "3",
                    "--dtype", "fp32", "--smt_lr", "1e-3"])
    assert len(history["train_loss"]) >= 3 and np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["eval_loss"]).all()
    for name in ("model.safetensors", "smt_plan.json", "tokenizer_config.json", "config.json"):
        assert (out / "final" / name).exists(), name
    phases = {json.loads(line)["phase"] for line in
              (out / "metrics.jsonl").read_text().splitlines()}
    assert phases == {"sparse"}
    assert (out / "final" / "smt_plan.json").read_text() == plan_path.read_text()
