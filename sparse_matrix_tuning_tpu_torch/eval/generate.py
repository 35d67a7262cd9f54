"""Batched autoregressive generation over the KV cache: greedy, beam search
and ancestral sampling (temperature / top-k / top-p, HF warper order), with
repetition penalty and EOS handling.

Twin of `sparse_matrix_tuning_tpu.eval.generate` (per-layer params): the
reference's HF `model.generate` with GenerationConfig(num_beams=4,
do_sample=False, repetition_penalty=1.1) of its eval harness. Prompts are
LEFT-padded. The step loop is a Python loop; every layer's attention over
the cache runs K7 on the card (models.llama.forward_with_cache). Beam
search is eval/_beam_impl.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sparse_matrix_tuning_tpu_torch.models.llama import (
    LlamaConfig, forward_with_cache, init_cache,
)

NEG_INF = -1.0e9

CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    num_beams: int = 1
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    eos_token_id: int = 2
    pad_token_id: int = 0
    # "int8" stores the KV cache quantized (per-slot-per-head scales,
    # models/llama.init_cache): half the cache bytes and read traffic
    cache_dtype: str = "bfloat16"
    # sampling: HF logits-processor order — repetition penalty, then
    # temperature, then top-k, then top-p. num_beams must be 1.
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    seed: int = 0


def _apply_repetition_penalty(logits, seen, penalty: float):
    """HF semantics: scores > 0 divided by penalty, scores < 0 multiplied,
    for every token already present in the sequence."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _filter_logits(logits, top_k: int, top_p: float):
    """HF TopK/TopP warper semantics on (B, V) logits: top-k masks
    everything strictly below the k-th largest logit (ties with it
    survive); top-p keeps token i (descending order) iff the probability
    mass strictly before it is <= top_p, which always keeps the top-1."""
    if top_k and top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where(before <= top_p, desc, float("inf"))
        kth = kept.min(dim=-1, keepdim=True).values
        logits = torch.where(logits < kth, NEG_INF, logits)
    return logits


def _scatter_seen(seen, tokens):
    """Mark token ids as seen. tokens: (B,) or (B, S)."""
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    return seen.scatter(1, tokens.long(), True)


def _prefill(params, model_cfg: LlamaConfig, input_ids, attention_mask,
             gen: GenerationConfig, batch: int):
    """The whole prompt in one forward_with_cache call (last position's
    logits only). Returns cache, slot_mask (B, max_len) int32, last logits
    (B, V), real lengths (B,), seen (B, V) bool and the prompt width."""
    p_len = input_ids.shape[1]
    max_len = p_len + gen.max_new_tokens
    dev = input_ids.device
    cache = init_cache(model_cfg, batch, max_len, dtype=CACHE_DTYPES[gen.cache_dtype],
                       device=dev)
    slot_mask = torch.zeros((batch, max_len), dtype=torch.int32, device=dev)
    slot_mask[:, :p_len] = attention_mask
    positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)
    logits, cache = forward_with_cache(params, input_ids, model_cfg, cache, 0, slot_mask,
                                       positions, last_only=True)
    last_logits = logits[:, -1, :]  # left padding: the last slot is real
    real_len = attention_mask.sum(dim=-1)
    seen = torch.zeros((batch, model_cfg.vocab_size), dtype=torch.bool, device=dev)
    seen = _scatter_seen(seen, input_ids)
    return cache, slot_mask, last_logits, real_len, seen, p_len


def _greedy(params, model_cfg: LlamaConfig, input_ids, attention_mask,
            gen: GenerationConfig, generator=None):
    """Single-beam decode loop: greedy argmax, or (gen.do_sample) ancestral
    sampling with temperature / top-k / top-p in HF warper order, drawn
    from `generator`. Returns (B, max_new_tokens) int64."""
    b = input_ids.shape[0]
    cache, slot_mask, last_logits, real_len, seen, p_len = _prefill(
        params, model_cfg, input_ids, attention_mask, gen, b)
    finished = torch.zeros((b,), dtype=torch.bool, device=input_ids.device)
    tokens = []
    for t in range(gen.max_new_tokens):
        logits = _apply_repetition_penalty(last_logits, seen, gen.repetition_penalty)
        if gen.do_sample:
            if gen.temperature != 1.0:
                logits = logits / max(gen.temperature, 1e-6)
            logits = _filter_logits(logits, gen.top_k, gen.top_p)
            token = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                      generator=generator)[:, 0]
        else:
            token = torch.argmax(logits, dim=-1)
        token = torch.where(finished, gen.pad_token_id, token)
        tokens.append(token)
        if t + 1 == gen.max_new_tokens:
            break  # the next logits would not be used
        seen = _scatter_seen(seen, token)
        slot = p_len + t
        slot_mask[:, slot] = (~finished).to(torch.int32)
        finished = finished | (token == gen.eos_token_id)
        logits, cache = forward_with_cache(params, token[:, None], model_cfg, cache, slot,
                                           slot_mask, (real_len + t)[:, None])
        last_logits = logits[:, -1, :]
    return torch.stack(tokens, dim=1)


def _seeded_generator(seed: int, call_idx: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, call_idx): each sampled
    batch of one run draws independent numbers, and a rerun the same ones."""
    state = np.random.SeedSequence([seed, call_idx]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & (2 ** 63 - 1))
    return gen


def generate(params, model_cfg: LlamaConfig, input_ids, attention_mask,
             gen: GenerationConfig, call_idx: int = 0, device="cuda") -> np.ndarray:
    """input_ids/attention_mask: LEFT-padded (B, P) int arrays or tensors.
    Returns generated token ids (B, max_new_tokens) int32, pad-filled after
    EOS. Runs on `device` (the card unless the caller passes "cpu"), where
    `params` must already be.

    call_idx distinguishes successive sampled batches under one seed (the
    generator is seeded from (gen.seed, call_idx))."""
    device = torch.device(device)
    if params["embed_tokens"].device.type != device.type:
        raise ValueError(f"generate: params are on {params['embed_tokens'].device}, "
                         f"generation runs on {device}")
    if gen.do_sample and gen.num_beams != 1:
        raise ValueError("do_sample requires num_beams=1 (sampled beam search is not "
                         "implemented, matching the harness's do_sample=False beam settings)")
    if gen.do_sample and gen.temperature <= 0.0:
        raise ValueError(f"temperature must be > 0 when do_sample=True, got "
                         f"{gen.temperature} (HF's TemperatureLogitsWarper rejects it too; "
                         "use do_sample=False for greedy)")
    if gen.cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"cache_dtype {gen.cache_dtype!r} not in {sorted(CACHE_DTYPES)}")
    input_ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64).to(device)
    attention_mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.int32).to(device)
    if gen.num_beams != 1:
        from sparse_matrix_tuning_tpu_torch.eval._beam_impl import beam_search
        out = beam_search(params, model_cfg, input_ids, attention_mask, gen)
    else:
        generator = _seeded_generator(gen.seed, call_idx, device) if gen.do_sample else None
        out = _greedy(params, model_cfg, input_ids, attention_mask, gen, generator)
    return out.cpu().numpy().astype(np.int32)


def prepare_decode_params(params, model_cfg: LlamaConfig):
    """The params generate decodes from: per-layer params as they are (the
    JAX package stacks layers here for its scan-over-layers decode, which
    the port does not need)."""
    return params


def decode_params_from_scan(state, model_cfg: LlamaConfig, host_frozen=None,
                            frozen_quant: str = "int8", consume: bool = False):
    """Decode params from the int8 scan training state: not ported."""
    raise NotImplementedError(
        "decode_params_from_scan needs the int8 scan training state (ROADMAP slice 3, "
        "on the int8 frozen base of slice 2); decode from trainer.decode_params() "
        "(the merged dense params) instead")
