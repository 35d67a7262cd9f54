"""The conversion of the eager warm-up into the stacked scan state
(train/scan_phase.build_scan_sparse_state, taken where
resolve_scan_layers says) against the JAX trainer, whose scan_layers
"auto" runs the scan warm-up and scan sparse phase from 12 layers: tiny
Llama (fp32, CPU) widened to 12 layers, tests/torch_parity batches, 2
warm-up + 4 sparse steps. At that depth --channel_sparsity --frozen_quant
int8 trains over an int8 base and head in both packages; selection at
depth gives the JAX plans; scan_layers "on" at 2 layers matches JAX's; the
warm-up builder's host store has quantize-on-load's layout."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.train.scan_phase import resolve_scan_layers as jax_resolve_scan
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
from sparse_matrix_tuning_tpu_torch.train import scan_phase
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

N_WARMUP, N_SPARSE = 2, 4
DEEP = 12
# fp32 on the CPU, the same algorithm in two frameworks
# (tests/test_torch_train_e2e.py): measured worst 9.0e-8 relative on the
# per-layer channel pair at 12 layers.
LOSS_RTOL = 1e-4
# the int8 base (tests/test_torch_train_e2e.py INT8_LOSS_RTOL): an
# activation one fp32 bit apart between the frameworks takes the other int8
# step. The port's eager run over a bf16 base read 6.1e-4 .. 1.14e-3 from
# JAX's int8 scan run; over the int8 scan state 3.4e-4 (scan_layers off:
# 9.0e-8; "on" at 2 layers: 2.5e-7).
INT8_LOSS_RTOL = 1e-3


def _cfg_kwargs(mode: str, **kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                full_ft_steps=N_WARMUP, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=0)
    if mode == "channel":
        base.update(channel_sparsity=True, num_attention_channel=8, num_mlp_channel=8)
    else:
        base.update(matrix_sparsity=True, downsample_attention_blocks_ratio=0.05,
                    downsample_mlp_blocks_ratio=0.05)
    base.update(kw)
    return base


def _models(layers: int):
    return (dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=256), num_hidden_layers=layers),
            dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256), num_hidden_layers=layers))


def _run_pair(mode: str, layers: int = DEEP, n_sparse: int = N_SPARSE, **kw):
    """Both trainers on the same weights and batches; n_sparse 0 stops at
    the conversion."""
    jcfg, pcfg = _models(layers)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    jt = JaxSMTTrainer(JaxSMTConfig(**_cfg_kwargs(mode, **kw)), jcfg, jparams,
                       total_steps=N_WARMUP + N_SPARSE)
    pt = SMTTrainer(SMTConfig(**_cfg_kwargs(mode, **kw)), pcfg, tp.port_params(jparams),
                    total_steps=N_WARMUP + N_SPARSE)
    out = {"jax": jt, "port": pt, "jax_losses": [], "port_losses": []}
    for batch in tp.lm_batches(N_WARMUP + n_sparse, pad_from=24):
        out["jax_losses"].append(float(jt.train_step(batch)["loss"]))
        out["port_losses"].append(float(pt.train_step(batch)["loss"]))
    if not n_sparse:
        jt.maybe_convert()
        pt.maybe_convert()
    return out


@pytest.fixture(scope="module")
def channel_int8_auto():
    return _run_pair("channel", frozen_quant="int8")


def test_channel_int8_at_depth_trains_over_the_int8_scan_state(channel_int8_auto):
    """--channel_sparsity --frozen_quant int8 under "auto" at 12 layers: the
    port converts into the int8 scan state with an int8 head and the host
    store, as JAX does, and its losses stay within the int8 bound of JAX's
    with the same plan (a bf16 base here read up to 1.14e-3)."""
    p = channel_int8_auto
    port, jt = p["port"], p["jax"]
    assert port._scan and jt._scan and port.phase == jt.phase == "sparse"
    assert "q" in port.state and "q_head" in port.state and "q" in jt.state
    assert set(port.state["q"]) == set(jt.state["q"]) == set(scan_phase.LAYER_LINEARS)
    stacked = port.state["params"]["layers_stacked"]
    assert all(tuple(stacked[m].shape) == (DEEP, 1) for m in scan_phase.LAYER_LINEARS)
    assert port.state["params"]["lm_head"].shape == (1,)
    assert set(port._host_frozen) == set(scan_phase.LAYER_LINEARS) | {"lm_head"}
    assert port.plan.fingerprint() == jt.plan.fingerprint()
    np.testing.assert_allclose(p["port_losses"][:N_WARMUP], p["jax_losses"][:N_WARMUP],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=INT8_LOSS_RTOL, atol=0)


def test_channel_int8_scan_state_leaves_match_jax(channel_int8_auto):
    """The built state leaf for leaf against JAX's after the same steps:
    the int8 base quantized from the fp32 master (codes equal but where the
    warm-up masters' last bits part them), stacked coordinates equal, the
    step carried over from the warm-up."""
    port, jt = channel_int8_auto["port"], channel_int8_auto["jax"]
    for mod, entry in port.state["q"].items():
        theirs = jt.state["q"][mod]
        assert np.mean(entry["wq"].numpy() != np.asarray(theirs["wq"])) < 1e-4, mod
        np.testing.assert_allclose(entry["sw"].numpy(), np.asarray(theirs["sw"]), rtol=1e-5)
    for mod, meta in port.state["idx"].items():
        for k, v in meta.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jt.state["idx"][mod][k]))
        assert port.state["trainable"][mod].shape == jt.state["trainable"][mod].shape
    assert int(port.state["step"]) == int(jt.state["step"]) == N_WARMUP + N_SPARSE
    assert int(port.state["count"]) == int(jt.state["count"]) == N_SPARSE


def test_export_and_decode_of_the_converted_state(channel_int8_auto, tmp_path):
    """A scan state that came from a warm-up serves the trainer's export
    and decode: the HF save reads back as merged_params (the host store's
    frozen weights, the trained columns in), which agrees with JAX's merged
    export; decode_params decodes from the int8 state into generate."""
    from sparse_matrix_tuning_tpu_torch.eval import generate as pgen
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    port, jt = channel_int8_auto["port"], channel_int8_auto["jax"]
    merged = port.merged_params()
    port.cfg.output_dir = str(tmp_path)
    try:
        port._save("final")
    finally:
        port.cfg.output_dir = None
    back = llama.flatten_tree(load_hf_params(str(tmp_path / "final"), port.model_cfg,
                                             dtype=torch.float32))
    flat, theirs = llama.flatten_tree(merged), tp.numpy_tree(jt.merged_params())
    assert set(back) == set(flat)
    theirs = llama.flatten_tree(theirs)
    for k, w in flat.items():
        assert torch.equal(back[k], w), k
        # the frozen weights are the warm-up masters', 1e-7 apart, by
        # relative norm as the e2e export is held; a trained column follows
        # its own run's int8 rounding (tests/test_torch_train_e2e.py)
        got, want = tp.np32(w).copy(), np.array(theirs[k], np.float32)
        parts = k.split("/")
        lp = port.plan.linears.get(f"{parts[1]}.{parts[2]}") if parts[0] == "layers" else None
        if lp is not None:
            got[:, list(lp.channels)] = want[:, list(lp.channels)] = 0
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), k
    params = port.decode_params()
    assert "layers_q8" in params
    ids = np.random.default_rng(3).integers(3, 256, (2, 6)).astype(np.int32)
    out = pgen.generate(params, port.model_cfg, ids, np.ones_like(ids),
                        pgen.GenerationConfig(max_new_tokens=3, cache_dtype="float32"),
                        device="cpu")
    assert out.shape == (2, 3) and ((out >= 0) & (out < 256)).all()


def test_channel_int8_scan_off_stays_per_layer():
    """scan_layers=off: both packages keep the per-layer channel path, whose
    base and head stay bf16 (unquantized), within the fp32 bound."""
    p = _run_pair("channel", frozen_quant="int8", scan_layers="off")
    assert not p["port"]._scan and not p["jax"]._scan
    assert "q" not in p["port"].state and "q_head" not in p["port"].state
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("mode", ["matrix", "channel"])
def test_scan_layers_on_at_2_layers_matches_jax(mode):
    """scan_layers=on: the port's eager warm-up converted into the scan
    state over the dense base, against JAX's scan warm-up and scan phase."""
    p = _run_pair(mode, layers=2, scan_layers="on")
    assert p["port"]._scan and p["jax"]._scan and "q" not in p["port"].state
    assert p["port"]._host_frozen is None
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=LOSS_RTOL, atol=0)
    batches = tp.lm_batches(2, seed=9)
    assert p["port"].evaluate(batches)[1] == pytest.approx(p["jax"].evaluate(batches)[1],
                                                           rel=LOSS_RTOL)


@pytest.mark.parametrize("mode,kw", [
    ("matrix", dict(saliency_accumulation="grad_sum")),
    ("channel", dict(saliency_accumulation="grad_sum")),
], ids=["matrix-grad_sum", "channel-grad_sum"])
def test_selection_at_depth_matches_jax(mode, kw):
    """Selection at 12 layers (JAX on its scan warm-up, the port eager):
    the same plan, fingerprint for fingerprint."""
    p = _run_pair(mode, n_sparse=0, **kw)
    assert p["jax"]._scan and p["port"].phase == "sparse"
    assert p["port"].plan.to_json() == p["jax"].plan.to_json()
    assert p["port"].plan.fingerprint() == p["jax"].plan.fingerprint()
    assert len({lp.layer for lp in p["port"].plan.linears.values()}) > 2
    np.testing.assert_allclose(p["port_losses"], p["jax_losses"], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("scan,mode,fq,layers", [
    ("off", "channel", "int8", 22), ("on", "matrix", "none", 2), ("on", "channel", "none", 2),
    ("auto", "channel", "int8", 12), ("auto", "channel", "int8", 11),
    ("auto", "channel", "none", 22), ("auto", "matrix", "int8", 22),
    ("auto", "matrix", "none", 22),
])
def test_resolve_scan_layers(scan, mode, fq, layers):
    """"off" and "on" as JAX; "auto" takes the scan state only where JAX's
    changes what is computed: channel mode over an int8 base at depth."""
    _, pcfg = _models(layers)
    jcfg, _ = _models(layers)
    kw = dict(scan_layers=scan, frozen_quant=fq)
    got = scan_phase.resolve_scan_layers(SMTConfig(**_cfg_kwargs(mode, **kw)), pcfg, mode)
    assert got == (scan == "on" or (scan == "auto" and mode == "channel" and fq == "int8"
                                    and layers >= 12))
    if scan != "auto":
        assert got == jax_resolve_scan(JaxSMTConfig(**_cfg_kwargs(mode, **kw)), jcfg, mode)
    with pytest.raises(ValueError, match="matrix or channel"):
        scan_phase.resolve_scan_layers(SMTConfig(scan_layers="on"), pcfg, "none")


@pytest.mark.parametrize("mode", ["matrix", "channel"])
def test_host_store_has_quantize_on_load_layout(mode, tmp_path):
    """The warm-up builder's state and host store against quantize-on-load
    of the same weights (saved as the HF checkpoint of the master at
    conversion, bf16) with the same plan: the same keys, shapes and dtypes
    leaf for leaf, the host stores equal, and both export the same
    weights through merged_params_from_scan."""
    _, pcfg = _models(2)
    kw = _cfg_kwargs(mode, dtype="bf16", frozen_quant="int8", scan_layers="on")
    pt = SMTTrainer(SMTConfig(**kw), pcfg, llama.init_params(pcfg, seed=0), total_steps=4)
    for batch in tp.lm_batches(N_WARMUP):
        pt.train_step(batch)
    save_hf_format(pt.merged_params(), pcfg, str(tmp_path))
    pt.maybe_convert()
    assert pt._scan
    plan = pt.plan
    hf_state, hf_host = scan_phase.build_scan_state_from_hf(
        SMTConfig(**{**kw, "sparse_from_plan": "plan.json"}), str(tmp_path), plan, pcfg,
        device="cpu")
    mine = llama.flatten_tree({k: v for k, v in pt.state.items() if k != "sched"})
    theirs = llama.flatten_tree(hf_state)
    assert set(mine) == set(theirs)
    for k, t in mine.items():
        assert (tuple(t.shape), t.dtype) == (tuple(theirs[k].shape), theirs[k].dtype), k
    assert int(pt.state["step"]) == N_WARMUP and int(hf_state["step"]) == 0
    assert set(pt._host_frozen) == set(hf_host)
    for k, w in pt._host_frozen.items():
        assert w.device.type == "cpu" and torch.equal(w, hf_host[k]), k
    a = scan_phase.merged_params_from_scan(pt.state, plan, pcfg, pt._host_frozen)
    b = scan_phase.merged_params_from_scan(hf_state, plan, pcfg, hf_host)
    fa, fb = llama.flatten_tree(a), llama.flatten_tree(b)
    assert set(fa) == set(fb)
    for k, w in fa.items():
        assert torch.equal(w, fb[k]), k
