"""Prompt templates — byte-for-byte parity with the reference.

reference deepspeed/helpers/helper.py:32-62 (generate_prompt, originally
from LLM-Adapters) and evaluation/run_commonsense_parallel.py:57-63
(i_prompt). The trailing spaces after "request." (one in the
with-input/eval variants, two in the instruction-only variants) and the
leading "<s> " literal are part of the template the published accuracies
were trained with, so they are kept verbatim — including the reference's
own quirk that the instruction+input-without-output branch interpolates
`output` (i.e. the literal string "None").
"""

from __future__ import annotations

_PROMPT_WITH_INPUT = (
    "<s> Below is an instruction that describes a task, paired with an input "
    "that provides further context. Write a response that appropriately "
    "completes the request. \n\n### Instruction:\n{instruction}\n\n"
    "### Input:\n{input}\n\n### Response:\n{output}"
)

_PROMPT_NO_INPUT_WITH_OUTPUT = (
    "<s> Below is an instruction that describes a task. Write a response "
    "that appropriately completes the request.  \n\n### Instruction:\n"
    "{instruction}\n\n### Response:\n{output}"
)

_PROMPT_NO_INPUT = (
    "<s> Below is an instruction that describes a task. Write a response "
    "that appropriately completes the request.  \n\n### Instruction:\n"
    "{instruction}\n\n### Response:\n"
)

# evaluation prompt (run_commonsense_parallel.py:57-63) — note ONE trailing
# space after "request." vs two in the training template.
EVAL_PROMPT = (
    "<s> Below is an instruction that describes a task. Write a response "
    "that appropriately completes the request. \n\n### Instruction:\n"
    "{instruction}\n\n### Response:\n"
)


def generate_prompt(instruction=None, input=None, output=None) -> str:
    if instruction and input and output:
        return _PROMPT_WITH_INPUT.format(instruction=instruction, input=input,
                                         output=output)
    elif instruction and input:
        # reference quirk preserved: this branch formats `output` (= None)
        return _PROMPT_NO_INPUT_WITH_OUTPUT.format(instruction=instruction,
                                                   output=output)
    else:
        return _PROMPT_NO_INPUT.format(instruction=instruction)


def get_output_or_chosen(example: dict) -> str:
    if "output" in example:
        return example["output"]
    if "answer" in example:
        return example["answer"]
    raise ValueError("wrong fine-tuning data json format, must include output "
                     "or answer key in the data dict")


def get_instruction_or_prompt(example: dict) -> str:
    if "input" in example and example["input"] != "":
        return example["input"]
    if "instruction" in example:
        return example["instruction"]
    raise ValueError("wrong fine-tuning data json format, must include input "
                     "or instruction key in the data dict")


def get_question_solution_answer_for_limo(example: dict):
    if "question" in example and "solution" in example and "answer" in example:
        return example["question"], example["solution"], example["answer"]
    raise ValueError("wrong LIMO dataset format.")
