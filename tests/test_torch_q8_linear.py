"""The int8 sparse linears of the port (ops/sparse_linear.py smt_linear_q8,
frozen_q8_linear), the conversion's int8 state (train/convert.py) and the
host offload, against the JAX package on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.ops import quant as jq
from sparse_matrix_tuning_tpu.ops import sparse_linear as jsl
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu.train import convert as jconvert
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.from_jax import plan_from_jax, qstate_from_jax
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, flatten_tree
from sparse_matrix_tuning_tpu_torch.ops import quant as pq
from sparse_matrix_tuning_tpu_torch.ops import sparse_linear as psl
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, LinearPlan, SMTPlan
from sparse_matrix_tuning_tpu_torch.train import convert as pconvert
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

O, I, T = 3 * BLOCK, 2 * BLOCK, 24
# a repeated row block, a repeated column block
BLOCKS = ((0, 0), (2, 1), (0, 1), (1, 0))


@pytest.fixture(scope="module")
def planned():
    """One planned (O, I) linear: weight, quantized base, trainable blocks
    moved off their frozen values, an input and a cotangent, as numpy."""
    w = tp.seeded_normal((O, I), seed=1, scale=0.02)
    x = tp.seeded_normal((2, T // 2, I), seed=2, scale=0.1)
    g = tp.seeded_normal((2, T // 2, O), seed=3, scale=0.1)
    rb = np.array([b[0] for b in BLOCKS])
    cb = np.array([b[1] for b in BLOCKS])
    blocks = w.reshape(O // BLOCK, BLOCK, I // BLOCK, BLOCK)[rb, :, cb, :]
    blocks = blocks + tp.seeded_normal(blocks.shape, seed=4, scale=0.01)
    return dict(w=w, x=x, g=g, blocks=blocks, rb=rb, cb=cb)


def _jax_side(d):
    lp = JaxLinearPlan("q_proj", 0, O, I, blocks=BLOCKS)
    wq, sw = jq.quantize_weight(tp.to_jax(d["w"]))
    base = jconvert.build_qweights({"0": {"q_proj": tp.to_jax(d["w"])}},
                                   JaxSMTPlan("matrix", {"0.q_proj": lp}))["0.q_proj"]["base"]
    return lp, wq, sw, base


def _port_side(d):
    lp = LinearPlan("q_proj", 0, O, I, blocks=BLOCKS)
    wq, sw = pq.quantize_weight(tp.to_torch(d["w"]))
    base = pconvert.build_qweights({"0": {"q_proj": tp.to_torch(d["w"])}},
                                   SMTPlan("matrix", {"0.q_proj": lp}))["0.q_proj"]["base"]
    return lp, wq, sw, base


def test_smt_linear_q8_forward_and_grads_match_jax(planned):
    """fp32 on the CPU: forward, grad_x and grad_blocks of the int8 sparse
    linear against the JAX custom VJP (its default grouped correction); the
    int8 products are exact on both sides, the corrections sum in fp32
    (tests/test_quant.py's rtol 1e-5, atol 1e-5 between its strategies)."""
    d = planned
    lp_j, wq_j, sw_j, base_j = _jax_side(d)
    y_j, vjp = jax.vjp(lambda x, b: jsl.smt_linear_q8(x, b, wq_j, sw_j, base_j, lp_j, "oracle"),
                       tp.to_jax(d["x"]), tp.to_jax(d["blocks"]))
    gx_j, gb_j = vjp(tp.to_jax(d["g"]))

    lp, wq, sw, base = _port_side(d)
    np.testing.assert_array_equal(base.numpy(), np.asarray(base_j))
    x = tp.to_torch(d["x"]).requires_grad_()
    blocks = tp.to_torch(d["blocks"]).requires_grad_()
    y = psl.smt_linear_q8(x, blocks, wq, sw, base, lp, impl="oracle")
    y.backward(tp.to_torch(d["g"]))
    assert y.shape == (2, T // 2, O) and blocks.grad.shape == (len(BLOCKS), BLOCK, BLOCK)
    tp.assert_close(y, y_j, rtol=1e-5, atol=1e-5)
    tp.assert_close(x.grad, gx_j, rtol=1e-5, atol=1e-5)
    tp.assert_close(blocks.grad, gb_j, rtol=1e-5, atol=1e-5)


def test_q8_grad_blocks_bitwise_equal_to_dense_path(planned):
    """grad w.r.t. the trainable blocks is the same formula in the int8 and
    the dense path: identical for an identical cotangent
    (tests/test_quant.py:109)."""
    d = planned
    lp, wq, sw, base = _port_side(d)
    g = tp.to_torch(d["g"])
    grads = []
    for int8 in (True, False):
        blocks = tp.to_torch(d["blocks"]).requires_grad_()
        x = tp.to_torch(d["x"])
        y = (psl.smt_linear_q8(x, blocks, wq, sw, base, lp) if int8
             else psl.smt_linear(x, blocks, tp.to_torch(d["w"]), lp))
        y.backward(g)
        grads.append(blocks.grad)
    assert torch.equal(grads[0], grads[1])


def test_q8_block_correction_is_exact(planned):
    """Moving the trainable blocks changes the output exactly as the dense
    formula does: the int8 noise lives only in the frozen base
    (tests/test_quant.py:80)."""
    d = planned
    lp, wq, sw, base = _port_side(d)
    x = tp.to_torch(d["x"])
    db = tp.to_torch(tp.seeded_normal(d["blocks"].shape, seed=5, scale=0.01))
    b0 = tp.to_torch(d["blocks"])
    diff = psl.smt_linear_q8(x, b0 + db, wq, sw, base, lp) - psl.smt_linear_q8(x, b0, wq, sw, base, lp)
    want = np.zeros((T, O), np.float32)
    x2 = d["x"].reshape(T, I)
    for j, (rb, cb) in enumerate(BLOCKS):
        want[:, rb * BLOCK:(rb + 1) * BLOCK] += x2[:, cb * BLOCK:(cb + 1) * BLOCK] @ db[j].numpy().T
    np.testing.assert_allclose(diff.reshape(T, O).numpy(), want, rtol=1e-4, atol=1e-5)


def test_frozen_q8_linear_matches_jax(planned):
    d = planned
    _, wq_j, sw_j, _ = _jax_side(d)
    y_j, vjp = jax.vjp(lambda x: jsl.frozen_q8_linear(x, wq_j, sw_j), tp.to_jax(d["x"]))
    (gx_j,) = vjp(tp.to_jax(d["g"]))
    _, wq, sw, _ = _port_side(d)
    x = tp.to_torch(d["x"]).requires_grad_()
    y = psl.frozen_q8_linear(x, wq, sw)
    y.backward(tp.to_torch(d["g"]))
    tp.assert_close(y, y_j, rtol=1e-6, atol=0)
    tp.assert_close(x.grad, gx_j, rtol=1e-6, atol=0)
    assert float(x.grad.abs().max()) > 0  # straight-through, not round's zero gradient


def test_frozen_q8_linear_fp16_equals_jitted_jax(planned):
    """--dtype fp16 over the int8 base: the frozen int8 linear's fp16 output
    and fp16 grad_x (the row quantization of x, and of g * sw in the g form,
    then K4's plain forms with their fp16 epilogue) equal jax.jit of the
    JAX linear bit for bit, as its jitted sparse step runs it."""
    d = planned
    _, wq_j, sw_j, _ = _jax_side(d)

    @jax.jit
    def jax_fwd_bwd(x, g):
        y, vjp = jax.vjp(lambda x_: jsl.frozen_q8_linear(x_, wq_j, sw_j), x)
        return y, vjp(g)[0]

    y_j, gx_j = jax_fwd_bwd(tp.to_jax(d["x"], "fp16"), tp.to_jax(d["g"], "fp16"))
    _, wq, sw, _ = _port_side(d)
    x = tp.to_torch(d["x"], "fp16").requires_grad_()
    y = psl.frozen_q8_linear(x, wq, sw)
    y.backward(tp.to_torch(d["g"], "fp16"))
    assert y.dtype == x.grad.dtype == torch.float16
    np.testing.assert_array_equal(tp.np32(y), tp.np32(y_j))
    np.testing.assert_array_equal(tp.np32(x.grad), tp.np32(gx_j))


def test_dispatch_routes_q8(planned):
    """Planned linears take the block-corrected q8 path, unplanned quantized
    ones the plain q8 path (the dense weight, a placeholder, is not read),
    others the dense matmul (tests/test_quant.py:151)."""
    d = planned
    lp, wq, sw, base = _port_side(d)
    plan = SMTPlan("matrix", {"0.q_proj": lp})
    blocks = tp.to_torch(d["blocks"])
    linear = psl.make_sparse_linear_dispatch(
        plan, {"0.q_proj": blocks}, "oracle",
        qweights={"0.q_proj": {"wq": wq, "sw": sw, "base": base}, "0.o_proj": {"wq": wq, "sw": sw}})
    x, w = tp.to_torch(d["x"]), tp.to_torch(d["w"])
    placeholder = torch.zeros(1)
    assert torch.equal(linear(x, placeholder, "q_proj", 0),
                       psl.smt_linear_q8(x, blocks, wq, sw, base, lp, "oracle"))
    assert torch.equal(linear(x, placeholder, "o_proj", 0), psl.frozen_q8_linear(x, wq, sw))
    assert torch.equal(linear(x, w, "up_proj", 1), x @ w.t())


def test_explicit_kernel_on_cpu_raises_for_the_q8_linear(planned):
    d = planned
    lp, wq, sw, base = _port_side(d)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        psl.smt_linear_q8(tp.to_torch(d["x"]), tp.to_torch(d["blocks"]), wq, sw, base, lp,
                          impl="kernel")


# ---------------------------------------------------------------------------
# conversion: the int8 state
# ---------------------------------------------------------------------------

JAX_CFG = JaxLlamaConfig.tiny(vocab_size=256)
CFG = LlamaConfig.tiny(vocab_size=256)


def _smt_kwargs(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                matrix_sparsity=True, full_ft_steps=2,
                downsample_attention_blocks_ratio=0.05, downsample_mlp_blocks_ratio=0.05,
                ft_learning_rate=1e-3, smt_lr=1e-2, lr_scheduler_type="constant",
                eval_step=0, save_steps=0, gradient_checkpointing=False,
                max_seq_len=32, seq_buckets=[32], seed=0)
    base.update(kw)
    return base


def test_build_qweights_and_q_head_equal_jax_and_round_trip():
    jax_params = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
    blocks = {"0.q_proj": ((0, 0),), "1.gate_proj": ((1, 0), (0, 0)), "1.down_proj": ((0, 1),)}
    dims = {"q_proj": (256, 256), "gate_proj": (512, 256), "down_proj": (256, 512)}
    jlin = {ks: JaxLinearPlan(ks.split(".")[1], int(ks[0]), *dims[ks.split(".")[1]], blocks=b)
            for ks, b in blocks.items()}
    jplan = JaxSMTPlan("matrix", jlin)
    q_j = jconvert.build_qweights(jax_params["layers"], jplan)
    head_j = jconvert.build_q_head(jax_params, JAX_CFG)

    params = tp.port_params(jax_params)
    q_p = pconvert.build_qweights(params["layers"], plan_from_jax(jplan))
    head_p = pconvert.build_q_head(params, CFG)
    assert set(q_p) == set(q_j) and len(q_p) == 2 * 7
    for ks, entry in q_p.items():
        assert set(entry) == set(q_j[ks]) and ("base" in entry) == (ks in blocks)
        assert entry["wq"].dtype == torch.int8 and entry["sw"].dtype == torch.float32
        for name, v in entry.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(q_j[ks][name]), err_msg=ks)
    for name in ("wq", "sw"):
        np.testing.assert_array_equal(head_p[name].numpy(), np.asarray(head_j[name]))

    # a JAX state's int8 base carried across keeps its dtypes and values
    carried = qstate_from_jax(tp.numpy_tree({"q": q_j, "q_head": head_j, "step": 3}))
    assert set(carried) == {"q", "q_head"}
    for (ka, a), (kb, b) in zip(sorted(flatten_tree(carried["q"]).items()),
                                sorted(flatten_tree(q_p).items())):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)
    assert carried["q_head"]["wq"].dtype == torch.int8
    assert torch.equal(carried["q_head"]["sw"], head_p["sw"])


def test_quant_policies_resolve_like_jax_off_the_accelerator():
    """frozen_quant "auto" is "none" in the port (as the JAX package off the
    TPU); head_quant "auto" follows the frozen base; explicit values win
    (tests/test_quant.py:206, tests/test_head_quant.py:20)."""
    for fq in ("none", "int8", "auto"):
        for mode in ("matrix", "channel"):
            assert pconvert.resolve_frozen_quant(SMTConfig(frozen_quant=fq), mode) == \
                jconvert.resolve_frozen_quant(JaxSMTConfig(frozen_quant=fq), mode)
    for hq in ("none", "int8", "auto"):
        for fq in ("none", "int8"):
            # the port's config resolves "auto" when it is built, from its own
            # frozen_quant; the JAX one at conversion, from the resolved base
            assert pconvert.resolve_head_quant(SMTConfig(head_quant=hq, frozen_quant=fq), CFG, fq) \
                == jconvert.resolve_head_quant(JaxSMTConfig(head_quant=hq), JAX_CFG, fq)
    assert SMTConfig(frozen_quant="int8").head_quant == "int8"
    assert SMTConfig(frozen_quant="int8", head_quant="none").head_quant == "none"
    assert pconvert.frozen_offload_active(SMTConfig(frozen_quant="int8"), "matrix")
    assert not pconvert.frozen_offload_active(SMTConfig(frozen_quant="int8"), "channel")
    assert not pconvert.frozen_offload_active(SMTConfig(), "matrix")
    assert not pconvert.frozen_offload_active(
        SMTConfig(frozen_quant="int8", frozen_host_offload=False), "matrix")


# ---------------------------------------------------------------------------
# host offload: offloaded and resident runs agree
# ---------------------------------------------------------------------------

def _train(n=6, **kw):
    jax_params = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
    trainer = SMTTrainer(SMTConfig(**_smt_kwargs(frozen_quant="int8", **kw)), CFG,
                         tp.port_params(jax_params), total_steps=n)
    losses = [float(trainer.train_step(b)["loss"]) for b in tp.lm_batches(n)]
    return trainer, losses


@pytest.fixture(scope="module")
def offload_pair():
    return _train(frozen_host_offload=True), _train(frozen_host_offload=False)


def test_offload_state_and_training_identical_to_resident(offload_pair):
    (t_off, l_off), (t_res, l_res) = offload_pair
    assert t_off._host_frozen is not None and t_res._host_frozen is None
    # every quantized dense weight, and the untied head, left as a (1,) placeholder
    for ks in t_off.state["q"]:
        li, mod = ks.split(".", 1)
        assert t_off.state["params"]["layers"][li][mod].shape == (1,)
        assert t_off._host_frozen[ks].dim() == 2
        assert t_res.state["params"]["layers"][li][mod].dim() == 2
    assert t_off.state["params"]["lm_head"].shape == (1,)
    assert t_off._host_frozen["lm_head"].shape == (CFG.vocab_size, CFG.hidden_size)
    # the q8 compute path never reads the dense weights
    # (tests/test_frozen_offload.py:39)
    np.testing.assert_allclose(l_off, l_res, rtol=1e-6)
    assert l_off[-1] < l_off[0]


def test_offload_export_matches_resident_export(offload_pair, tmp_path):
    (t_off, _), (t_res, _) = offload_pair
    flat_off = flatten_tree(t_off.merged_params())
    flat_res = flatten_tree(t_res.merged_params())
    assert flat_off.keys() == flat_res.keys()
    for k, v in flat_off.items():
        assert v.shape == flat_res[k].shape and torch.equal(v, flat_res[k]), k
    # the trained blocks are in the export, the rest is the conversion-time weight
    ks, lp = next(iter(t_off.plan.linears.items()))
    w = t_off.merged_params()["layers"][str(lp.layer)][lp.module]
    w4 = w.view(lp.out_dim // BLOCK, BLOCK, lp.in_dim // BLOCK, BLOCK)
    rb, cb = lp.blocks[0]
    assert torch.equal(w4[rb, :, cb, :], t_off.state["trainable"][ks][0].detach())
    assert torch.equal(t_off.merged_params()["lm_head"], t_off._host_frozen["lm_head"])
    # decode params come back whole, and the HF export reads back equal
    decode = t_off.decode_params()
    assert all(p.dim() == 2 for k, p in flatten_tree(decode).items() if k.endswith("_proj"))
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_params
    t_off.cfg.output_dir = str(tmp_path)
    try:
        t_off._save("final")
    finally:
        t_off.cfg.output_dir = None
    back = flatten_tree(load_hf_params(str(tmp_path / "final"), CFG, dtype=torch.float32))
    for k, v in flat_off.items():
        assert torch.equal(back[k], v), k


def test_offload_eval_runs_q8_forward(offload_pair):
    (t_off, _), (t_res, _) = offload_pair
    batches = tp.lm_batches(2, seed=9)
    ppl, loss = t_off.evaluate(batches)
    assert np.isfinite(loss) and np.isfinite(ppl)
    # the same q8-corrected forward as training: close to, not equal to, the
    # resident run's dense eval (tests/test_frozen_offload.py:65)
    _, loss_res = t_res.evaluate(batches)
    np.testing.assert_allclose(loss, loss_res, rtol=0.05)
    assert loss != loss_res
