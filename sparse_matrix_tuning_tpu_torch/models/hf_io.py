"""HuggingFace interop: load Llama-family checkpoints into the port's
parameter dicts and export merged dense checkpoints HF can load.

Twin of `sparse_matrix_tuning_tpu.models.hf_io`. The safetensors format is
read and written here by hand (no `safetensors` package needed): an 8-byte
little-endian header length, a JSON header mapping each name to
{"dtype", "shape", "data_offsets"} (offsets relative to the end of the
header), then the raw little-endian tensor bytes. `.bin` checkpoints go
through torch.load.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig

# reference deepspeed/helpers/model_names.py — families needing pad_token_id=0
LLAMA3_FAMILY_MARKERS = ("Llama-3", "llama-3", "Meta-Llama-3", "DeepSeek-R1-Distill-Llama")

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors, by hand
# ---------------------------------------------------------------------------

def safetensors_header(path: str) -> Tuple[int, Dict[str, Any]]:
    """(offset of the data, {name: {"dtype", "shape", "data_offsets"}}) of
    one .safetensors file, reading only its header."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return 8 + n, header


def read_safetensor(path: str, base: int, info: Mapping[str, Any], name: str = "") -> torch.Tensor:
    """One tensor of a .safetensors file as a CPU tensor, given the file's
    data offset and the tensor's header entry (safetensors_header)."""
    dtype = _ST_DTYPES[info["dtype"]]
    shape = tuple(info["shape"])
    begin, end = info["data_offsets"]
    if end == begin:
        return torch.empty(shape, dtype=dtype)
    buf = bytearray(end - begin)
    with open(path, "rb") as f:
        f.seek(base + begin)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: truncated data for {name!r}")
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} from one .safetensors file."""
    base, header = safetensors_header(path)
    return {name: read_safetensor(path, base, info, name) for name, info in header.items()}


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write {name: tensor} as one .safetensors file (names in sorted order,
    data packed back to back)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the format pads the header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in blobs:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


# ---------------------------------------------------------------------------
# Name mapping
# ---------------------------------------------------------------------------

def _hf_to_tree_name(name: str) -> Optional[tuple]:
    """HF state-dict key -> path into the param dict; None = skip (buffers)."""
    bias = False
    if name.endswith(".weight"):
        name = name[: -len(".weight")]
    elif name.endswith(".bias"):  # Qwen2-style QKV biases
        name = name[: -len(".bias")]
        bias = True
    else:
        return None
    if bias:
        parts = name.split(".")
        if len(parts) >= 5 and parts[0] == "model" and parts[1] == "layers" \
                and parts[3] in ("self_attn", "mlp"):
            return ("layers", parts[2], f"{parts[4]}_bias")
        return None
    if name == "model.embed_tokens":
        return ("embed_tokens",)
    if name == "model.norm":
        return ("norm",)
    if name == "lm_head":
        return ("lm_head",)
    parts = name.split(".")
    if len(parts) >= 4 and parts[0] == "model" and parts[1] == "layers":
        layer = parts[2]
        sub = parts[3:]
        if sub[0] in ("input_layernorm", "post_attention_layernorm"):
            return ("layers", layer, sub[0])
        if sub[0] in ("self_attn", "mlp") and len(sub) == 2:
            return ("layers", layer, sub[1])
    return None


def _tree_to_hf_name(path: tuple) -> str:
    if path == ("embed_tokens",):
        return "model.embed_tokens.weight"
    if path == ("norm",):
        return "model.norm.weight"
    if path == ("lm_head",):
        return "lm_head.weight"
    _, layer, module = path
    suffix = ".weight"
    if module.endswith("_bias"):
        module, suffix = module[: -len("_bias")], ".bias"
    group = "self_attn" if module.endswith(("q_proj", "k_proj", "v_proj", "o_proj")) \
        else "mlp" if module in ("gate_proj", "up_proj", "down_proj") else None
    if group is None:
        return f"model.layers.{layer}.{module}{suffix}"
    return f"model.layers.{layer}.{group}.{module}{suffix}"


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def load_hf_config(model_dir: str) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    from sparse_matrix_tuning_tpu_torch.models.registry import resolve_family
    resolve_family(raw.get("model_type", "llama"))
    return LlamaConfig.from_hf(raw)


def load_hf_params(model_dir: str, cfg: Optional[LlamaConfig] = None,
                   dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Read a local HF checkpoint dir (safetensors preferred, .bin fallback)
    into a param dict of `dtype` tensors on `device`."""
    cfg = cfg or load_hf_config(model_dir)
    state: Dict[str, torch.Tensor] = {}

    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if st_files:
        for fname in st_files:
            state.update(read_safetensors(os.path.join(model_dir, fname)))
    else:
        bin_files = sorted(f for f in os.listdir(model_dir)
                           if f.startswith("pytorch_model") and f.endswith(".bin"))
        if not bin_files:
            raise FileNotFoundError(f"no safetensors or pytorch_model*.bin in {model_dir}")
        for fname in bin_files:
            state.update(torch.load(os.path.join(model_dir, fname),
                                    map_location="cpu", weights_only=True))

    params: Dict[str, Any] = {"layers": {}}
    for k, v in state.items():
        path = _hf_to_tree_name(k)
        if path is None:
            continue
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v.to(device=device, dtype=dtype)

    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    elif "lm_head" not in params:
        # some checkpoints tie implicitly by omitting lm_head; a copy, so
        # in-place optimizer updates never touch one tensor twice
        params["lm_head"] = params["embed_tokens"].clone()
    return params


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def save_hf_format(params: Mapping[str, Any], cfg: LlamaConfig, output_dir: str,
                   tokenizer=None, dtype=None) -> None:
    """Write model.safetensors + config.json (+ tokenizer) — a vanilla HF
    checkpoint (reference save_hf_format, deepspeed_helpers.py:341-364)."""
    os.makedirs(output_dir, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}

    def visit(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                visit(v, path + (k,))
        else:
            t = node if dtype is None else node.to(dtype)
            flat[_tree_to_hf_name(path)] = t

    visit(dict(params), ())
    if cfg.tie_word_embeddings:
        flat.pop("lm_head.weight", None)

    write_safetensors(flat, os.path.join(output_dir, "model.safetensors"),
                      metadata={"format": "pt"})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf(), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(output_dir)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

def load_hf_tokenizer(model_name_or_path: str, max_seq_len: int = 2048,
                      add_eot_token: bool = False):
    """Reference load_hf_tokenizer/get_tokenizer semantics
    (deepspeed_helpers.py:286-336): fast tokenizer, pad token fixups —
    Llama-3 family gets pad_token_id=0, others fall back to eos."""
    from transformers import AutoTokenizer
    add_special = {"additional_special_tokens": ["<|endoftext|>"]} if add_eot_token else None
    tok = AutoTokenizer.from_pretrained(model_name_or_path, fast_tokenizer=True)
    if add_special:
        tok.add_special_tokens(add_special)
    if any(m in str(model_name_or_path) for m in LLAMA3_FAMILY_MARKERS):
        tok.pad_token_id = 0
    if tok.pad_token is None:
        if tok.eos_token is not None:
            tok.pad_token = tok.eos_token
        else:
            tok.pad_token_id = 0
    tok.model_max_length = max_seq_len
    return tok
