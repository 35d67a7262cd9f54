"""Qwen2-shaped models under the tensor axis (`--mesh_shape D,F,T`, T > 1):
q/k/v biases, a tied head and attention dropout, without a spawn. The
ranks of a (1, 1, 2) or (1, 2, 2) mesh run as threads
(tests/test_torch_tensor.py's _on_threads: every torch.distributed
collective the trainer calls replaced by one over the threads of its
group).

  * a tiny tied, biased model trained two-phase by the port in one
    process against the JAX package's SMTTrainer: the same plan, losses
    within tests/test_torch_train_e2e.py's bound, the warm-up's biases and
    tied embedding;
  * the same model at (1, 1, 2) and (1, 2, 2) against one process, over
    the dense and the int8 base and head, per layer and over the scan
    state, in matrix and channel mode, with attention dropout at (1, 1, 2):
    tests/test_torch_tensor_meshes.py's bounds (_step_bounds and the
    tensor axis's state rule), the same fingerprint, the biases whole and
    the embedding on its hidden columns on every rank, no lm_head leaf and
    none in the export (two of the (1, 2, 2) cases against JAX's mesh:
    tests/test_torch_tensor_qwen_mesh.py);
  * each rank's dropout masks its rows' and kv heads' slice of one
    process's, bit for bit, drawn again by a remat recompute;
  * tensor_dim of the bias leaves and of a tied model's embedding against
    JAX's state_shardings, at the tiny widths and Qwen2.5-1.5B's;
  * the split-amax quantization of a tied int8 head equal to one
    process's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_parity as tp
from test_torch_parallel import D1_RTOL_INT8, JAX_RTOL, MODEL, N, N_WARMUP, _cfg, batches
from test_torch_tensor import _RANK, _jax_dims, _on_threads
from test_torch_tensor_meshes import _assert_state_close_tp, _assert_within_adam, _step_bounds

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig
from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

QWEN_MODEL = {**MODEL, "tie_word_embeddings": True}
BIASES = (("q_proj", 256), ("k_proj", 128), ("v_proj", 128))
# the one-process port against JAX: tests/test_torch_train_e2e.py's bound
LOSS_RTOL = 1e-4
# without the lm_head a tied model has 19 blocks: 5% would select none
RATIOS = dict(downsample_attention_blocks_ratio=0.1, downsample_mlp_blocks_ratio=0.1)


def _qwen_cfg(mode="matrix", **kw):
    return _cfg(mode, **({**RATIOS, **kw} if mode == "matrix" else kw))


def _jax_params():
    """JAX's tiny tied model with seeded nonzero q/k/v biases in every layer."""
    cfg = JaxLlamaConfig(**{**JaxLlamaConfig.tiny(vocab_size=256).__dict__,
                            "tie_word_embeddings": True})
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    for li, layer in params["layers"].items():
        for i, (m, n) in enumerate(BIASES):
            layer[f"{m}_bias"] = jnp.asarray(tp.seeded_normal((n,), 10 * int(li) + i, 0.1))
    return cfg, params


# ---------------------------------------------------------------------------
# (a) the one-process port against JAX
# ---------------------------------------------------------------------------

def test_tied_biased_two_phase_run_matches_jax():
    """A tiny tied model with q/k/v biases, trained two-phase (2 warm-up,
    3 sparse steps) by the port in one process and by the JAX package's
    SMTTrainer on the CPU: losses within 1e-4 every step, the same plan
    fingerprint, and after the warm-up the updated biases and the tied
    embedding within 1e-4 of JAX's (relative Frobenius norm, the e2e
    test's rule: Adam's first steps move an element with a grad near 0
    either way)."""
    jcfg, jparams = _jax_params()
    bs = batches(N)
    cfg = _qwen_cfg()
    jt = JaxSMTTrainer(JaxSMTConfig(**cfg), jcfg, jparams, total_steps=N)
    pt = SMTTrainer(SMTConfig(**cfg), LlamaConfig(**QWEN_MODEL), tp.port_params(jparams),
                    total_steps=N, device="cpu")
    assert "lm_head" not in pt.state["master"]
    losses = []
    for i, b in enumerate(bs):
        if i == N_WARMUP:
            want = tp.numpy_tree(jt.state["master"])
            got = pt.state["master"]
            pairs = [(got["embed_tokens"], want["embed_tokens"])] + [
                (got["layers"][li][f"{m}_bias"], want["layers"][li][f"{m}_bias"])
                for li in got["layers"] for m, _ in BIASES]
            for g, w in pairs:
                g, w = tp.np32(g), np.asarray(w, np.float32)
                assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
            moved = tp.np32(got["layers"]["0"]["q_proj_bias"]) - tp.seeded_normal((256,), 0, 0.1)
            assert np.abs(moved).max() > 0
        losses.append((float(pt.train_step(b)["loss"]), float(jt.train_step(b)["loss"])))
    assert pt.phase == jt.phase == "sparse"
    assert pt.plan.fingerprint() == jt.plan.fingerprint()
    np.testing.assert_allclose(*zip(*losses), rtol=LOSS_RTOL, atol=0)


# ---------------------------------------------------------------------------
# (b) the tensor ranks against one process
# ---------------------------------------------------------------------------

def _case_cfg(mode, base, layout, dropout):
    kw = dict(per_device_ft_batch_size=1)
    if base == "int8":
        kw.update(frozen_quant="int8", head_quant="int8")
    if layout == "scan":
        kw.update(scan_layers="on")
    if dropout:
        kw.update(dropout=0.1)
    return _qwen_cfg(mode, **kw)


CASES = [(shape, mode, base, layout, dropout)
         for shape in ((1, 1, 2), (1, 2, 2)) for mode in ("matrix", "channel")
         for base in ("dense", "int8") for layout in ("layer", "scan")
         for dropout in ((False, True) if shape == (1, 1, 2) else (False,))]


def _id(case):
    shape, mode, base, layout, dropout = case
    return "-".join(["".join(map(str, shape)), mode, base, layout] + ["dropout"] * dropout)


@pytest.fixture(scope="module")
def qwen_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qwen")
    torch.save(tp.port_params(_jax_params()[1]), tmp / "params.pt")
    torch.save(batches(N), tmp / "batches.pt")
    torch.save(batches(2, pads=(32, 20, 12, 6), seed=9), tmp / "eval.pt")
    return tmp


def _spec(case, files):
    shape, mode, base, layout, dropout = case
    return {"cfg": _case_cfg(mode, base, layout, dropout),
            "model": {**QWEN_MODEL, "attention_dropout": 0.1 if dropout else 0.0},
            "total_steps": N, "export": True, "params": str(files / "params.pt"),
            "batches": str(files / "batches.pt"), "eval_batches": str(files / "eval.pt")}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_tied_biased_ranks_match_one_process(case, qwen_files, monkeypatch):
    """Every rank's losses, grad norms and eval loss equal; against one
    process at tests/test_torch_tensor_meshes.py's bounds (_step_bounds:
    1e-5 through the first sparse step, then JAX_RTOL and TP_NORM_RTOL;
    over the int8 base and head its int8 bounds), the same fingerprint,
    the gathered final state and the export by the tensor axis's state
    rule (over int8 every entry within Adam's bound). Each rank holds the
    biases whole (bit-equal across its tensor group) and 1/F x 1/T of the
    embedding, its hidden columns over tensor, and no lm_head leaf; the
    export has none."""
    shape, mode, base, layout, dropout = case
    spec = _spec(case, qwen_files)
    cfg = spec["cfg"]
    one = ranks.run_scenario(spec)
    got = _on_threads(shape, monkeypatch, lambda mesh: ranks.run_scenario(spec, mesh))
    r0 = got[0]
    int8 = base == "int8"
    assert r0["fingerprint"] == one["fingerprint"] and r0["phase"] == "sparse"
    assert r0["scan"] == one["scan"] == (layout == "scan")
    for r in got[1:]:
        np.testing.assert_equal(r["metrics"], r0["metrics"])
        assert r["eval_loss"] == r0["eval_loss"]
    norms = [(a.get("grad_norm", 0.0), b.get("grad_norm", 0.0))
             for a, b in zip(r0["metrics"], one["metrics"])]
    for sl, rtol, norm_rtol in _step_bounds(False, int8):
        np.testing.assert_allclose([m["loss"] for m in r0["metrics"]][sl],
                                   [m["loss"] for m in one["metrics"]][sl], rtol=rtol, atol=0)
        np.testing.assert_allclose(*zip(*norms[sl]), rtol=norm_rtol)
    np.testing.assert_allclose(r0["eval_loss"], one["eval_loss"],
                               rtol=D1_RTOL_INT8 if int8 else JAX_RTOL)
    adam_bound = 2 * (cfg["ft_learning_rate"] * cfg["full_ft_steps"]
                      + cfg["smt_lr"] * (N - cfg["full_ft_steps"]))
    rule = _assert_within_adam if int8 else _assert_state_close_tp
    for what in ("full", "export"):
        assert set(r0[what]) == set(one[what]), what
        for k, v in one[what].items():
            for r in got:
                assert torch.equal(r[what][k], r0[what][k]), (what, k)
            if v.numel() == 1 < r0[what][k].numel():   # one process's host placeholder
                continue
            rule(f"{what}/{k}", r0[what][k], v, adam_bound)
    assert "lm_head" not in r0["export"] and "layers/1/k_proj_bias" in r0["export"]
    f, t = shape[1], shape[2]
    for r, g in enumerate(got):
        warm, _ = g["shapes"]
        assert "master/lm_head" not in warm
        assert warm["master/embed_tokens"] == (256 // f, 256 // t)
        for m, n in BIASES:
            assert warm[f"master/layers/0/{m}_bias"] == (n,)
        assert "params/embed_tokens" in g["tdims"]
        assert not any(k.endswith("_bias") for k in g["tdims"])
        peer = got[r - r % t + (r + 1) % t]   # the next rank of its tensor group
        for k, sums in g["checksums"].items():
            if k.endswith("_bias"):
                assert sums == peer["checksums"][k], (r, k)


@pytest.mark.parametrize("layout,stop", [("layer", 1), ("scan", N_WARMUP + 1)],
                         ids=["layer-warmup", "scan-int8-sparse"])
def test_tied_biased_resume_is_bit_for_bit(layout, stop, tmp_path, monkeypatch):
    """At (1, 1, 2) under --dropout 0.1, a tied, biased run stopped in the
    warm-up (per layer) or after its first sparse step (over the int8 scan
    state) and restored into fresh trainers (each rank its
    state.fsdp0.tensor{t}.pt) equals the straight run bit for bit: losses
    and every leaf's checksum after every step."""
    from test_torch_tensor_meshes import _assert_resumed
    kw = dict(scan_layers="on", frozen_quant="int8") if layout == "scan" else {}
    torch.save(tp.port_params(_jax_params()[1]), tmp_path / "params.pt")
    torch.save(batches(N_WARMUP + 3), tmp_path / "batches.pt")
    spec = {"cfg": _qwen_cfg(dropout=0.1, output_dir=str(tmp_path / "out"), **kw),
            "model": {**QWEN_MODEL, "attention_dropout": 0.1}, "total_steps": N_WARMUP + 3,
            "params": str(tmp_path / "params.pt"), "batches": str(tmp_path / "batches.pt")}
    got = _on_threads((1, 1, 2), monkeypatch, lambda mesh: ranks.checkpoint_scenario(spec, stop, mesh))
    _assert_resumed(got, tmp_path / "out" / "ckpt")


# ---------------------------------------------------------------------------
# (c) dropout masks
# ---------------------------------------------------------------------------

def _recording(monkeypatch, masks):
    """Wrap llama._attn_dropout: each call also records its keep mask,
    drawn again from a copy of its generator's state."""
    from sparse_matrix_tuning_tpu_torch.models import llama
    original = llama._attn_dropout

    def recorded(probs, rate, rng=None, keep=None, rows=None, heads=None):
        if rng is not None:
            again = torch.Generator(device=probs.device)
            again.set_state(rng.get_state())
            ones = torch.ones_like(probs)
            masks.setdefault(_rank(), []).append(
                original(ones, rate, again, None, rows, heads) != 0)
        return original(probs, rate, rng, keep, rows, heads)

    monkeypatch.setattr(llama, "_attn_dropout", recorded)


def _rank():
    return getattr(_RANK, "r", -1)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)], ids=lambda s: "".join(map(str, s)))
def test_dropout_masks_are_slices_of_one_process(shape, monkeypatch):
    """One remat warm-up step under --dropout 0.1: each rank's masks, layer
    by layer, equal its rows' and kv heads' slice of one process's masks
    bit for bit (rank (d, f, t) rows f * B.. of the global batch, kv head
    t of 2), and the remat recompute in the backward draws every mask
    again, equal to its forward's."""
    masks = {}
    _recording(monkeypatch, masks)
    cfg = _qwen_cfg(dropout=0.1, gradient_checkpointing=True, per_device_ft_batch_size=1)
    model = LlamaConfig(**{**QWEN_MODEL, "attention_dropout": 0.1})
    params = tp.port_params(_jax_params()[1])
    b = batches(1)[0]
    SMTTrainer(SMTConfig(**cfg), model, params, N, device="cpu").train_step(b)
    whole = masks.pop(-1)

    def rank(mesh):
        SMTTrainer(SMTConfig(**cfg, mesh_shape=list(shape)), model, params, N, device="cpu",
                   mesh=mesh).train_step(b)
        return mesh.batch_index, mesh.tensor_index

    where = _on_threads(shape, monkeypatch, rank)
    n = model.num_hidden_layers
    # the forward's layers, then the backward's recomputes from the top
    layer_of = list(range(n)) + list(range(n - 1, -1, -1))
    assert len(whole) == 2 * n
    assert all(torch.equal(m, whole[layer_of[i]]) for i, m in enumerate(whole))
    rows = 4 // (shape[0] * shape[1])
    for r, (bi, ti) in enumerate(where):
        mine = masks[r]
        assert len(mine) == 2 * n
        for i, m in enumerate(mine):
            want = whole[layer_of[i]][bi * rows:(bi + 1) * rows, ti:ti + 1]
            assert m.shape == want.shape and torch.equal(m, want), (r, i)
        assert 0.85 < float(torch.cat([m.float().reshape(-1) for m in mine]).mean()) < 0.95


# ---------------------------------------------------------------------------
# (d) the layout against JAX, (e) the tied int8 head's quantization
# ---------------------------------------------------------------------------

def _qwen_state(d, f, v, kv, stacked):
    """A warm-up and a sparse state of numpy zeros with a tied model's
    leaves (no lm_head) and q/k/v biases, per layer or stacked (L 2)."""
    z = np.zeros
    layer = {"input_layernorm": z(d), "post_attention_layernorm": z(d),
             "q_proj": z((d, d)), "k_proj": z((kv, d)), "v_proj": z((kv, d)),
             "o_proj": z((d, d)), "gate_proj": z((f, d)), "up_proj": z((f, d)),
             "down_proj": z((d, f)), "q_proj_bias": z(d), "k_proj_bias": z(kv),
             "v_proj_bias": z(kv)}
    tree = {"embed_tokens": z((v, d)), "norm": z(d)}
    if stacked:
        tree["layers_stacked"] = {k: z((2, *a.shape)) for k, a in layer.items()}
    else:
        tree["layers"] = {"0": layer}
    warm = {"master": tree, "m": tree, "v": tree}
    sparse = {"params": tree, "q_head": {"wq": z((v, d)), "sw": z(v)}}
    return warm, sparse


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4)],
                         ids=lambda s: "".join(map(str, s)))
@pytest.mark.parametrize("dims", [(256, 512, 256, 128), (1536, 8960, 151936, 256)],
                         ids=["tiny", "qwen2.5-1.5b"])
@pytest.mark.parametrize("stacked", [False, True], ids=["layer", "scan"])
def test_bias_and_tied_dims_are_jax_state_shardings(shape, dims, stacked):
    """Sharding.split_dims of the bias leaves (whole: JAX's P()), of a tied
    model's embedding (its vocabulary on fsdp, its hidden columns on
    tensor: dim 1) and of the int8 head quantized from it (its rows on
    tensor) equals the (fsdp, tensor) dims of JAX's state_shardings, per
    layer and stacked, at the tiny widths and Qwen2.5-1.5B's."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import Sharding
    sh = Sharding(Mesh(shape, 0, torch.device("cpu")))
    for state in _qwen_state(*dims, stacked):
        want = _jax_dims(state, shape, "matrix")
        got = {"/".join(p.key for p in path): sh.split_dims(
                   "/".join(p.key for p in path), leaf.shape, "matrix")
               for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
        assert got == want
        biases = [k for k in got if k.endswith("_bias")]
        assert biases and all(got[k] == (None, None) for k in biases)
        for k, (fd, td) in got.items():
            if k.endswith("embed_tokens"):
                assert td == 1 and fd == (0 if shape[1] > 1 else None)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)], ids=lambda s: "".join(map(str, s)))
def test_tied_int8_head_quantized_from_split_rows(shape, monkeypatch):
    """build_q_head of a tied model under the tensor axis (each rank its
    embedding columns, the rows' amax MAX-reduced over the group, the int8
    columns gathered): each rank's wq and sw are its vocabulary rows (and
    fsdp columns) of one process's quantization of the whole embedding,
    bit for bit, with a row whose largest entry lies on one rank only."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import Sharding
    from sparse_matrix_tuning_tpu_torch.train.convert import build_q_head
    model = LlamaConfig(**QWEN_MODEL)
    emb = torch.from_numpy(tp.seeded_normal((256, 256), 3, 0.02))
    emb[7, 200] = 5.0   # rank 1's columns at T 2
    want = build_q_head({"embed_tokens": emb}, model)

    def rank(mesh):
        sh = Sharding(mesh)
        master = sh.shard_tree({"embed_tokens": emb}, "master")
        got = build_q_head(master, model, sh)
        return {k: (t, sh.local(f"q_head/{k}", want[k])) for k, t in got.items()}

    for got in _on_threads(shape, monkeypatch, rank):
        for k, (t, w) in got.items():
            assert t.dtype == w.dtype and torch.equal(t, w), k


def test_tied_head_rows_forward_and_grad(monkeypatch):
    """parallel/tensor.tied_head_rows at T 2 on threads: each rank's head
    is its vocabulary rows of the whole embedding, and the grads of the
    ranks' rows reach the ranks' columns exactly (the grad of the whole
    embedding, cut to the rank's columns)."""
    from sparse_matrix_tuning_tpu_torch.parallel.tensor import tied_head_rows
    emb = torch.from_numpy(tp.seeded_normal((64, 32), 4))
    g = torch.from_numpy(tp.seeded_normal((64, 32), 5))

    def rank(mesh):
        t = mesh.tensor_index
        cols = emb[:, 16 * t:16 * (t + 1)].clone().requires_grad_(True)
        head = tied_head_rows(cols, mesh)
        head.backward(g[32 * t:32 * (t + 1)])
        return (torch.equal(head, emb[32 * t:32 * (t + 1)]),
                torch.equal(cols.grad, g[:, 16 * t:16 * (t + 1)]), mesh.stats["tied_calls"])

    assert _on_threads((1, 1, 2), monkeypatch, rank) == [(True, True, 2)] * 2



@pytest.fixture(scope="module")
def qwen_hf_dir(tmp_path_factory):
    """A tiny tied qwen2 checkpoint with q/k/v biases (config.json's
    model_type qwen2), written by the port's save_hf_format."""
    import json
    from sparse_matrix_tuning_tpu_torch.models.hf_io import save_hf_format
    d = tmp_path_factory.mktemp("qwen_ckpt")
    model = LlamaConfig(**QWEN_MODEL)
    save_hf_format(tp.port_params(_jax_params()[1]), model, str(d))
    hf = {**model.to_hf(), "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"]}
    (d / "config.json").write_text(json.dumps(hf))
    return str(d)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)], ids=lambda s: "".join(map(str, s)))
def test_sharded_load_reads_qwen2_checkpoint(shape, qwen_hf_dir):
    """load_hf_params_sharded of a tied qwen2 checkpoint under the tensor
    axis: the .bias tensors whole on every rank, no lm_head leaf, the
    embedding's (fsdp, tensor) block; each leaf its block of load_hf_params'
    tensors bit for bit and the JAX package's sharded load's shard."""
    from sparse_matrix_tuning_tpu.models.hf_io import (
        load_hf_params_sharded as jax_load_sharded)
    from sparse_matrix_tuning_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from sparse_matrix_tuning_tpu_torch.models.hf_io import (
        load_hf_config, load_hf_params, load_hf_params_sharded)
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
    cfg = load_hf_config(qwen_hf_dir)
    assert cfg.tie_word_embeddings
    full = flatten_tree(load_hf_params(qwen_hf_dir, cfg, dtype=torch.float32))
    n = int(np.prod(shape))
    jmesh = jax_make_mesh(shape, jax.devices()[:n])
    jax_flat = {"/".join(p.key for p in path): a for path, a in
                jax.tree_util.tree_flatten_with_path(
                    jax_load_sharded(qwen_hf_dir, jmesh, None, dtype=np.float32))[0]}
    assert set(jax_flat) == set(full) and "lm_head" not in full
    for r in range(n):
        mesh = Mesh(shape, r, torch.device("cpu"))
        params, sh = load_hf_params_sharded(qwen_hf_dir, mesh, cfg, dtype=torch.float32)
        flat = flatten_tree(params)
        assert set(flat) == set(full)
        device = jmesh.devices[np.unravel_index(r, shape)]
        for k, t in flat.items():
            assert torch.equal(t, sh.local(f"master/{k}", full[k])), k
            shard = [s for s in jax_flat[k].addressable_shards if s.device == device][0]
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data), err_msg=k)
            if k.endswith("_bias"):
                assert torch.equal(t, full[k]), k
        assert sh.tdim("master/embed_tokens") == 1
