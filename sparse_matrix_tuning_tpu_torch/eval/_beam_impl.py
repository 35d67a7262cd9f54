"""Beam search with exact HF BeamSearchScorer semantics (twin of
`sparse_matrix_tuning_tpu.eval._beam_impl`):

  * per step, take the top 2K of the K*V continuation scores;
  * EOS candidates ranked < K go into a per-batch finished-hypothesis set
    (score normalised by padded-sequence-length ** length_penalty, the
    decoder-only convention); EOS candidates ranked >= K are dropped;
  * the K beam slots refill with the best non-EOS continuations;
  * at the end, still-active beams are added as hypotheses and the best
    normalised hypothesis wins.
Running to max_new_tokens is equivalent to HF's early_stopping=False check:
later steps can only add hypotheses, never remove them.

Ties: jax.lax.top_k and a stable argsort put the lower index first among
equal values, and the rank < K EOS gate depends on that order, so every
top-k here is a stable descending sort (torch.topk promises no order among
equal values).
"""

from __future__ import annotations

import torch

from sparse_matrix_tuning_tpu_torch.models.llama import (
    LlamaConfig, cache_batch_axis, forward_with_cache,
)

NEG_INF = -1.0e9


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, lower index
    first among equal values (jax.lax.top_k's order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_search(params, model_cfg: LlamaConfig, input_ids, attention_mask, gen):
    """Returns the best hypothesis per prompt, (B, max_new_tokens) int64,
    pad-filled after EOS."""
    from sparse_matrix_tuning_tpu_torch.eval.generate import (
        _apply_repetition_penalty, _prefill, _scatter_seen)

    b = input_ids.shape[0]
    k = gen.num_beams
    n_new = gen.max_new_tokens
    dev = input_ids.device
    cax = cache_batch_axis(params)

    def tile(x):
        return x.repeat_interleave(k, dim=0)

    cache, slot_mask, last_logits, real_len, seen, p_len = _prefill(
        params, model_cfg, input_ids, attention_mask, gen, b)
    cache = {li: {n: t.repeat_interleave(k, dim=cax) for n, t in kv.items()}
             for li, kv in cache.items()}
    slot_mask, last_logits, real_len, seen = map(tile, (slot_mask, last_logits, real_len, seen))

    beam_scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), dtype=torch.float32,
                               device=dev).repeat(b)
    emitted = torch.full((b * k, n_new), gen.pad_token_id, dtype=torch.int64, device=dev)
    hyp_norm = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    hyp_tokens = torch.full((b, k, n_new), gen.pad_token_id, dtype=torch.int64, device=dev)
    batch_base = torch.arange(b, device=dev)[:, None] * k
    rank = torch.arange(2 * k, device=dev)[None, :]

    for t in range(n_new):
        # HF beam search: processors run on log-softmaxed scores
        logprobs = torch.log_softmax(last_logits, dim=-1)
        logprobs = _apply_repetition_penalty(logprobs, seen, gen.repetition_penalty)
        v = logprobs.shape[-1]
        total = (beam_scores[:, None] + logprobs).reshape(b, k * v)
        scores2k, idx2k = _top_k(total, 2 * k)                  # (B, 2K)
        token2k = idx2k % v
        src2k = idx2k // v
        is_eos = token2k == gen.eos_token_id

        # finished hypotheses: EOS candidates with rank < K, normalised by
        # the padded width at add time (p_len + t)
        eligible = is_eos & (rank < k)
        width = float(max(p_len + t, 1))
        cand_norm = torch.where(eligible, scores2k / width ** gen.length_penalty, NEG_INF)
        cand_tokens = emitted[(batch_base + src2k).reshape(-1)].reshape(b, 2 * k, n_new)
        cand_tokens[:, :, t] = torch.where(eligible, token2k, gen.pad_token_id)
        all_norm = torch.cat([hyp_norm, cand_norm], dim=1)           # (B, 3K)
        all_tokens = torch.cat([hyp_tokens, cand_tokens], dim=1)     # (B, 3K, T)
        hyp_norm, top_i = _top_k(all_norm, k)
        hyp_tokens = torch.gather(all_tokens, 1, top_i[:, :, None].expand(-1, -1, n_new))

        # refill the K beam slots with the best non-EOS candidates
        sel = torch.argsort(is_eos.to(torch.int8), dim=1, stable=True)[:, :k]
        token = torch.gather(token2k, 1, sel).reshape(-1)
        src = torch.gather(src2k, 1, sel)
        beam_scores = torch.gather(scores2k, 1, sel).reshape(-1)

        flat_beam = (batch_base + src).reshape(-1)
        emitted = emitted.index_select(0, flat_beam)
        emitted[:, t] = token
        if t + 1 == n_new:
            break  # the next logits would not be used
        cache = {li: {n: x.index_select(cax, flat_beam) for n, x in kv.items()}
                 for li, kv in cache.items()}
        slot_mask = slot_mask.index_select(0, flat_beam)
        seen = _scatter_seen(seen.index_select(0, flat_beam), token)
        rl = real_len.index_select(0, flat_beam)
        slot = p_len + t
        slot_mask[:, slot] = 1
        logits, cache = forward_with_cache(params, token[:, None], model_cfg, cache, slot,
                                           slot_mask, (rl + t)[:, None])
        last_logits = logits[:, -1, :]

    # still-active beams become hypotheses at full width
    final_norm = (beam_scores / float(p_len + n_new) ** gen.length_penalty).reshape(b, k)
    all_norm = torch.cat([hyp_norm, final_norm], dim=1)
    all_tokens = torch.cat([hyp_tokens, emitted.reshape(b, k, n_new)], dim=1)
    best = torch.argmax(all_norm, dim=1)
    return all_tokens[torch.arange(b, device=dev), best]
