"""SFT data pipeline: JSON/JSONL -> prompts -> tokens -> masked, bucketed
fixed-shape batches.

Semantics follow reference deepspeed/helpers/helper.py:96-288
(SupervisedDataset / preprocess / _tokenize_fn / collator /
make_supervised_data_module) and deepspeed_helpers.py:384-404
(read_json_file), with one TPU-driven change: instead of padding each batch
to its longest sequence (a new XLA program per unique length), batches are
padded up to a small set of static bucket lengths.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from sparse_matrix_tuning_tpu_torch.data.prompts import (
    generate_prompt,
    get_instruction_or_prompt,
    get_output_or_chosen,
    get_question_solution_answer_for_limo,
)

IGNORE_INDEX = -100  # reference helper.py:23


def read_json_file(path: str) -> List[dict]:
    """JSON array or JSONL (reference deepspeed_helpers.py:384-404)."""
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        text = f.read().strip()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        data = [json.loads(line) for line in text.splitlines() if line.strip()]
    if isinstance(data, dict):
        data = data.get("data", [data])
    return data


@dataclass
class SFTDataset:
    """Tokenized examples: per-example input_ids and prompt-masked labels."""
    input_ids: List[np.ndarray]
    labels: List[np.ndarray]

    def __len__(self) -> int:
        return len(self.input_ids)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        return {"input_ids": self.input_ids[i], "labels": self.labels[i]}

    def subset(self, indices: Sequence[int]) -> "SFTDataset":
        return SFTDataset([self.input_ids[i] for i in indices],
                          [self.labels[i] for i in indices])


def build_sft_dataset(data_path: str, tokenizer, max_seq_len: int) -> SFTDataset:
    """Reference SupervisedDataset (helper.py:141-182): Alpaca prompting of
    instruction -> output (+LIMO question/solution branch), tokenize
    source+target, mask the source tokens with -100."""
    examples = read_json_file(data_path)
    if "limo" in data_path.lower():
        sources = [get_question_solution_answer_for_limo(e)[0] for e in examples]
        targets = [get_question_solution_answer_for_limo(e)[1] + tokenizer.eos_token
                   for e in examples]
    else:
        sources = [generate_prompt(instruction=get_instruction_or_prompt(e))
                   for e in examples]
        targets = [f"{get_output_or_chosen(e).replace('</s>', '')}{tokenizer.eos_token}"
                   for e in examples]

    full = [s + t for s, t in zip(sources, targets)]
    full_ids = tokenizer(full, max_length=max_seq_len, truncation=True,
                         return_attention_mask=False)["input_ids"]
    src_ids = tokenizer(sources, max_length=max_seq_len, truncation=True,
                        return_attention_mask=False)["input_ids"]

    input_ids, labels = [], []
    for ids, src in zip(full_ids, src_ids):
        ids = np.asarray(ids, np.int32)
        lab = ids.copy()
        lab[: len(src)] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(lab)
    return SFTDataset(input_ids, labels)


def make_supervised_data(data_path: str, tokenizer, max_seq_len: int,
                         eval_set_ratio: float, seed: int
                         ) -> Tuple[SFTDataset, SFTDataset]:
    """Reference make_supervised_data_module (helper.py:261-288): one JSON
    carved into train/eval by eval_set_ratio with a seeded random split."""
    ds = build_sft_dataset(data_path, tokenizer, max_seq_len)
    n = len(ds)
    train_size = int(n * (1 - eval_set_ratio))
    perm = np.random.default_rng(seed).permutation(n)
    return ds.subset(perm[:train_size]), ds.subset(perm[train_size:])


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def _bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if length <= b:
            return b
    return max(buckets)


def collate(examples: Sequence[Dict[str, np.ndarray]], pad_token_id: int,
            seq_len: int) -> Dict[str, np.ndarray]:
    """Right-pad ids with pad_token_id, labels with -100, mask = ids != pad
    (reference DataCollatorForSupervisedDataset, helper.py:186-205)."""
    bsz = len(examples)
    input_ids = np.full((bsz, seq_len), pad_token_id, np.int32)
    labels = np.full((bsz, seq_len), IGNORE_INDEX, np.int32)
    attention_mask = np.zeros((bsz, seq_len), np.int32)
    for i, ex in enumerate(examples):
        ids = ex["input_ids"][:seq_len]
        lab = ex["labels"][:seq_len]
        input_ids[i, : len(ids)] = ids
        labels[i, : len(lab)] = lab
        attention_mask[i, : len(ids)] = 1
    return {"input_ids": input_ids, "labels": labels,
            "attention_mask": attention_mask}


def batch_iterator(dataset: SFTDataset, batch_size: int, pad_token_id: int,
                   buckets: Sequence[int], seed: int, epoch: int,
                   shuffle: bool = True, drop_last: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Global-batch iterator with fixed shapes.

    Replaces the reference's DataLoader+DistributedSampler
    (fine_tune.py:129-147): here the full global batch is produced on host
    and jit/sharding splits it across the mesh. Each batch is padded to the
    smallest bucket covering its longest member; `drop_last` keeps the batch
    dimension static.
    """
    order = np.arange(len(dataset))
    if shuffle:
        order = np.random.default_rng(hash((seed, epoch)) % (2 ** 31)).permutation(order)
    n_full = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    for bi in range(n_full):
        idx = order[bi * batch_size: (bi + 1) * batch_size]
        if len(idx) < batch_size:  # only when drop_last=False: wrap-pad
            idx = np.concatenate([idx, order[: batch_size - len(idx)]])
        examples = [dataset[i] for i in idx]
        longest = max(len(e["input_ids"]) for e in examples)
        yield collate(examples, pad_token_id, _bucket_for(longest, buckets))


def num_batches(dataset_len: int, batch_size: int, drop_last: bool = True) -> int:
    return dataset_len // batch_size if drop_last else -(-dataset_len // batch_size)
