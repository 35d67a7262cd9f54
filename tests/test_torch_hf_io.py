"""HF interop of the port: its hand-written safetensors writer, read back by
the `safetensors` package, equals the JAX save_hf_format of the same
params; its loader reads JAX-written checkpoints (tied embeddings, Qwen2
biases — the tests/test_hf_io_edge.py cases), .bin checkpoints and HF's own
files."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open

import torch_parity as tp

from sparse_matrix_tuning_tpu.models import hf_io as jhf
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu_torch.models import hf_io
from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig


def _read_np(path):
    with safe_open(str(path), framework="np") as f:
        return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


def _variant(tied=False, bias=False, dtype=jnp.bfloat16):
    jcfg = JaxLlamaConfig(**{**JaxLlamaConfig.tiny().__dict__, "tie_word_embeddings": tied})
    pcfg = LlamaConfig(**{**LlamaConfig.tiny().__dict__, "tie_word_embeddings": tied})
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    if bias:
        jp["layers"]["0"]["q_proj_bias"] = jnp.arange(256, dtype=dtype)
    return jcfg, pcfg, jp


@pytest.mark.parametrize("tied,bias,dtype", [
    (False, False, jnp.bfloat16), (True, False, jnp.float32), (False, True, jnp.float32)],
    ids=["bf16", "tied-fp32", "bias-fp32"])
def test_writer_matches_jax_save(tmp_path, tied, bias, dtype):
    jcfg, pcfg, jp = _variant(tied, bias, dtype)
    jhf.save_hf_format(jp, jcfg, str(tmp_path / "jax"))
    hf_io.save_hf_format(tp.port_params(jp), pcfg, str(tmp_path / "port"))
    want, want_meta = _read_np(tmp_path / "jax" / "model.safetensors")
    got, got_meta = _read_np(tmp_path / "port" / "model.safetensors")
    assert got_meta == want_meta == {"format": "pt"}
    assert sorted(got) == sorted(want)
    assert ("lm_head.weight" in got) == (not tied)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config.json").read_text())


@pytest.mark.parametrize("tied,bias", [(True, False), (False, True)], ids=["tied", "bias"])
def test_loader_reads_jax_checkpoints(tmp_path, tied, bias):
    jcfg, pcfg, jp = _variant(tied, bias, jnp.float32)
    jhf.save_hf_format(jp, jcfg, str(tmp_path))
    cfg = hf_io.load_hf_config(str(tmp_path))
    assert cfg == pcfg
    got = hf_io.load_hf_params(str(tmp_path), cfg, dtype=torch.float32)
    want = tp.numpy_tree(jhf.load_hf_params(str(tmp_path), jcfg, dtype=jnp.float32))
    tp.assert_trees_equal(got, want)
    assert ("lm_head" in got) == (not tied)


def test_round_trip_bf16_and_implicit_tie(tmp_path):
    _, pcfg, jp = _variant(dtype=jnp.bfloat16)
    params = tp.port_params(jp)
    hf_io.save_hf_format(params, pcfg, str(tmp_path / "a"))
    back = hf_io.load_hf_params(str(tmp_path / "a"), pcfg, dtype=torch.bfloat16)
    tp.assert_trees_equal(back, tp.numpy_tree(jp))
    # a checkpoint without lm_head ties implicitly: a copy, not an alias
    tensors = hf_io.read_safetensors(str(tmp_path / "a" / "model.safetensors"))
    del tensors["lm_head.weight"]
    (tmp_path / "b").mkdir()
    hf_io.write_safetensors(tensors, str(tmp_path / "b" / "model.safetensors"))
    (tmp_path / "b" / "config.json").write_text((tmp_path / "a" / "config.json").read_text())
    tied = hf_io.load_hf_params(str(tmp_path / "b"), pcfg)
    assert torch.equal(tied["lm_head"], tied["embed_tokens"])
    assert tied["lm_head"].data_ptr() != tied["embed_tokens"].data_ptr()


def test_loader_reads_bin_checkpoints(tmp_path):
    _, pcfg, jp = _variant(dtype=jnp.float32)
    params = tp.port_params(jp)
    sd = {"model.embed_tokens.weight": params["embed_tokens"],
          "model.norm.weight": params["norm"], "lm_head.weight": params["lm_head"],
          "model.layers.0.rotary_emb.inv_freq": torch.ones(4)}
    for li, layer in params["layers"].items():
        for m, w in layer.items():
            sd[hf_io._tree_to_hf_name(("layers", li, m))] = w
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(pcfg.to_hf()))
    back = hf_io.load_hf_params(str(tmp_path), dtype=torch.float32)
    tp.assert_trees_equal(back, tp.numpy_tree(jp))


def test_config_mapping_and_registry(tmp_path):
    hf = {"model_type": "mistral", "vocab_size": 1000, "hidden_size": 128,
          "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "max_position_embeddings": 4096}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert hf_io.load_hf_config(str(tmp_path)) == LlamaConfig.from_hf(hf)
    hf["model_type"] = "opt"
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(NotImplementedError, match="opt"):
        hf_io.load_hf_config(str(tmp_path))
