"""Generation-eval harness: commonsense and math reasoning accuracy (twin of
`sparse_matrix_tuning_tpu.eval.harness`).

Port of reference evaluation/run_commonsense_parallel.py:
  * prompt = i_prompt.format_map(example) (:270-276), data/prompts.EVAL_PROMPT;
  * per-dataset answer extraction regexes (:66-99), reproduced exactly, and
    the LLM-Adapters convention for the six math sets (last number in the
    completion; option letter for AQuA);
  * accuracy = exact match against example["answer"].lower() (:296-311);
  * predictions dumped to {output_dir}/{dataset}/model_predictions.jsonl
    (:316-322);
  * over a mesh of processes each rank generates every D-th prompt (JAX
    harness.py:151-153) and the completions are gathered back into prompt
    order as Python strings (dist.all_gather_object: none is truncated,
    where JAX's fixed-width byte rows had to be wide enough); rank 0 writes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from sparse_matrix_tuning_tpu_torch.data.prompts import EVAL_PROMPT
from sparse_matrix_tuning_tpu_torch.utils.logging import print_rank_0

COMMONSENSE_DATASETS = ("boolq", "piqa", "social_i_qa", "hellaswag",
                        "winogrande", "ARC-Challenge", "ARC-Easy", "openbookqa")
MATH_DATASETS = ("gsm8k", "SingleEq", "SVAMP", "MultiArith", "AddSub", "AQuA")


def extract_answer(dataset: str, sentence: str) -> str:
    """Reference regexes (run_commonsense_parallel.py:66-99), byte-exact for
    the commonsense sets; math sets follow the LLM-Adapters convention."""
    sentence = sentence.lower()
    sentence_ = sentence.strip()
    if dataset == "boolq":
        pred = re.findall(r"true|false", sentence_)
    elif dataset == "piqa":
        pred = re.findall(r"solution1|solution2", sentence_)
    elif dataset in ("social_i_qa", "ARC-Challenge", "ARC-Easy", "openbookqa"):
        pred = re.findall(r"answer1|answer2|answer3|answer4|answer5", sentence_)
    elif dataset == "hellaswag":
        pred = re.findall(r"ending1|ending2|ending3|ending4", sentence_)
    elif dataset == "winogrande":
        pred = re.findall(r"option1|option2", sentence_)
    elif dataset == "AQuA":
        pred = re.findall(r"\(([abcde])\)", sentence_)
        if not pred:
            pred = re.findall(r"\b([abcde])\b", sentence_)
        pred = pred[:1]
    elif dataset in MATH_DATASETS:
        nums = re.findall(r"-?\d+\.?\d*", sentence_.replace(",", ""))
        return nums[-1].rstrip(".") if nums else ""
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return pred[0] if pred else ""


def _answers_match(dataset: str, target: str, predict: str) -> bool:
    target = str(target).lower().strip()
    if dataset in MATH_DATASETS and dataset != "AQuA":
        try:
            return predict != "" and abs(float(target) - float(predict)) < 1e-4
        except ValueError:
            return target == predict
    return target == predict


def build_prompts(examples: Sequence[dict]) -> List[str]:
    return [EVAL_PROMPT.format_map(e) for e in examples]


def run_dataset_eval(dataset: str, examples: Sequence[dict], generate_fn,
                     output_dir: Optional[str] = None, mesh=None) -> Dict:
    """generate_fn(prompts: List[str]) -> List[str] completions.

    Returns {"dataset", "accuracy", "n", "predictions"} and, with
    output_dir, dumps model_predictions.jsonl like the reference (rank 0
    of a mesh, whose ranks split the prompts by stride)."""
    prompts = build_prompts(examples)
    if mesh is None:
        outputs = list(generate_fn(prompts))
    else:
        from sparse_matrix_tuning_tpu_torch.parallel.mesh import gather_objects
        local = list(generate_fn(prompts[mesh.rank::mesh.world]))
        outputs = [None] * len(prompts)
        for r, outs in enumerate(gather_objects(local, mesh)):
            outputs[r::mesh.world] = outs
    correct = 0
    save_outputs = []
    for example, output in zip(examples, outputs):
        example = dict(example)
        example["raw_output"] = output
        target = str(example["answer"]).lower()
        predict = extract_answer(dataset, output)
        if _answers_match(dataset, target, predict):
            correct += 1
        example["prediction"] = predict
        save_outputs.append(example)

    accuracy = correct / max(len(examples), 1)
    if output_dir and (mesh is None or mesh.is_main):
        ds_dir = os.path.join(output_dir, dataset)
        os.makedirs(ds_dir, exist_ok=True)
        with open(os.path.join(ds_dir, "model_predictions.jsonl"), "w") as f:
            for ex in save_outputs:
                f.write(json.dumps(ex) + "\n")

    print_rank_0("Dataset: {}, accuracy {:.1f}%, number of test data: {}".format(
        dataset, accuracy * 100, len(examples)))
    return {"dataset": dataset, "accuracy": accuracy, "n": len(examples),
            "predictions": save_outputs}


def make_generate_fn(params, model_cfg, tokenizer, gen_cfg, batch_size: int = 16,
                     max_prompt_len: int = 512, device="cuda"):
    """Tokenize LEFT-padded prompt batches -> generate -> decode completions
    (reference generate_completions, run_commonsense_parallel.py:120-220).

    Each batch is padded to batch_size rows and its prompts to a bucket of
    64, 128, ... max_prompt_len tokens, as the JAX harness does (its shapes
    key its compiled programs; here they keep the batches' arithmetic the
    same in both packages). Runs on `device`, where params must be."""
    from sparse_matrix_tuning_tpu_torch.eval.generate import generate, prepare_decode_params

    params = prepare_decode_params(params, model_cfg)

    def pad_to_bucket(n):
        b = 64
        while b < n:
            b *= 2
        return min(b, max_prompt_len)

    # each sampled batch gets a fresh call index, so draws are independent
    # across batches of one run
    call_counter = [0]

    def fn(prompts: List[str]) -> List[str]:
        outs: List[str] = []
        for i in range(0, len(prompts), batch_size):
            chunk = prompts[i:i + batch_size]
            enc = tokenizer(chunk, truncation=True, max_length=max_prompt_len,
                            return_attention_mask=True)
            ids_list = enc["input_ids"]
            longest = pad_to_bucket(max(len(x) for x in ids_list))
            ids = np.full((batch_size, longest), tokenizer.pad_token_id, np.int32)
            mask = np.zeros((batch_size, longest), np.int32)
            for j, x in enumerate(ids_list):  # left padding
                ids[j, longest - len(x):] = x
                mask[j, longest - len(x):] = 1
            tokens = generate(params, model_cfg, ids, mask, gen_cfg,
                              call_idx=call_counter[0], device=device)[:len(chunk)]
            call_counter[0] += 1
            outs.extend(tokenizer.batch_decode(tokens, skip_special_tokens=True))
        return outs

    return fn
