"""Model-family registry — the TPU-native counterpart of the reference's
`get_blocks` layer resolver (smt_helper.py:272-302, which maps Llama/LLaVA/
OPT/Bloom/MPT/Falcon/BigCode/NeoX classes to their decoder-layer list).

Reality check recorded for parity: everything else in the reference is
hard-wired to Llama-style module names — the warm-up grad harvest matches
only `{q,k,v}_proj` / `mlp.*proj` (fine_tune.py:716-768), the layer-number
regex is `model\\.layers\\.(\\d+)\\.` (fine_tune.py:718), and the target set
is fixed (fine_tune.py:217-220) — so OPT/Bloom/MPT/Falcon/BigCode/NeoX would
silently harvest nothing despite appearing in get_blocks. This framework is
honest about the same boundary: families whose checkpoints are
llama-decoder-shaped (rmsnorm + rope + GQA + silu gate/up/down, the set the
reference actually trains and publishes numbers for) are fully supported;
others raise with a clear message instead of silently no-opping.
"""

from __future__ import annotations

from typing import Dict

# model_type (HF config.json) -> notes. All of these are llama-decoder-shaped
# and load through models.llama + models.hf_io unchanged.
SUPPORTED_FAMILIES: Dict[str, str] = {
    "llama": "Llama 1/2/3, TinyLlama, DeepSeek-R1-Distill-Llama, Vicuna, LLaVA text towers",
    "mistral": "Mistral 7B-family (sliding window unused at seq<=4096)",
    "qwen2": "Qwen2/2.5 (QKV biases supported; frozen, never SMT-selected)",
}

# families the reference lists in get_blocks but cannot actually SMT-train
# (module names never match its harvest patterns)
VESTIGIAL_REFERENCE_FAMILIES = (
    "opt", "bloom", "mpt", "falcon", "gpt_bigcode", "gpt_neox", "llava",
)


def resolve_family(model_type: str) -> str:
    mt = model_type.lower()
    if mt in SUPPORTED_FAMILIES:
        return mt
    if mt in VESTIGIAL_REFERENCE_FAMILIES:
        raise NotImplementedError(
            f"model_type {model_type!r}: the reference lists this family in "
            "get_blocks (smt_helper.py:272-302) but its SMT pipeline is "
            "hard-wired to Llama-style module names and would silently "
            "select nothing for it; this framework supports "
            f"{sorted(SUPPORTED_FAMILIES)} end-to-end instead.")
    raise NotImplementedError(
        f"unsupported model_type {model_type!r}; supported: "
        f"{sorted(SUPPORTED_FAMILIES)}")
