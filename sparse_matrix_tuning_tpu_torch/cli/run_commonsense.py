"""Generation-eval entry point (PyTorch port) — the `accelerate launch
run_commonsense_parallel.py` equivalent (reference
evaluation/run_commonsense_parallel.py:325-386):

  python -m sparse_matrix_tuning_tpu_torch.cli.run_commonsense \
      --model_name_or_path /path/to/trained_ckpt \
      --data_path /path/to/commonsense_data \
      --datasets boolq piqa social_i_qa hellaswag winogrande \
                 ARC-Challenge ARC-Easy openbookqa \
      --output_dir /path/to/eval_out

Expects {data_path}/{dataset}/test.json with instruction/answer fields
(reference :270-276). Defaults mirror the reference GenerationConfig:
beam-4, no sampling, repetition_penalty 1.1, max_new_tokens 256. Runs on
the card; `--device cpu` runs the plain versions of the kernels on the CPU.
`--frozen_quant int8|int4` quantizes the checkpoint while loading it and
decodes over the int8 base (K4) or its int4 requantization (K6), with no
dense layer weight on the device (load_decode_params).

Under `torchrun --nproc_per_node N` each process loads the model on its
own card, generates every N-th prompt, and rank 0 writes the gathered
predictions and the summary (eval/harness.run_dataset_eval).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--datasets", type=str, nargs="+",
                   default=["boolq", "piqa", "social_i_qa", "hellaswag",
                            "winogrande", "ARC-Challenge", "ARC-Easy",
                            "openbookqa"])
    p.add_argument("--output_dir", type=str, default="eval_out")
    p.add_argument("--per_device_eval_batch_size", type=int, default=16)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--num_beams", type=int, default=4)
    p.add_argument("--repetition_penalty", type=float, default=1.1)
    p.add_argument("--max_seq_len", type=int, default=8192)
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--frozen_quant", type=str, default="none",
                   choices=["none", "int8", "int4"],
                   help="int8/int4: quantize-on-load, decode over the int8 or "
                        "int4 frozen base (exact bf16 embeddings and head); "
                        "none (default) keeps the exact forward")
    p.add_argument("--kv_cache", type=str, default="auto",
                   choices=["auto", "exact", "int8"],
                   help="int8: quantized KV cache (per-slot-per-head scales), "
                        "half the cache bytes and read traffic; exact: cache "
                        "in --dtype; auto (default) = exact")
    p.add_argument("--seed", type=int, default=1234)
    # sampling (the reference harness is do_sample=False, so accuracy runs
    # leave these off)
    p.add_argument("--do_sample", action="store_true",
                   help="ancestral sampling instead of greedy/beam "
                        "(requires --num_beams 1)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0, help="0 disables")
    p.add_argument("--top_p", type=float, default=1.0, help="1.0 disables")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cuda: the CUDA kernels)")
    return p


def load_decode_params(model_dir: str, frozen_quant: str = "none", dtype: str = "bf16",
                       device="cuda", plan=None):
    """(decode params, LlamaConfig) of a local HF checkpoint on `device`.
    frozen_quant "none": the dense params in `dtype` ("bf16" or "fp32").
    "int8" / "int4": quantize-on-load into the int8 scan state, one tensor
    at a time (train/scan_phase.build_scan_state_from_hf, exact head, no
    host copies), then decode params over the int8 base or its int4
    requantization, each int8 module freed as its int4 twin is built.
    plan: an SMTPlan whose selected blocks the decode keeps exact (the eval
    CLI passes none: the empty plan)."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.eval.generate import decode_params_from_scan
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_config, load_hf_params
    from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
    from sparse_matrix_tuning_tpu_torch.train.scan_phase import build_scan_state_from_hf

    model_cfg = load_hf_config(model_dir)
    cfg = SMTConfig(model_name_or_path=model_dir, dtype=dtype, frozen_quant="int8",
                    head_quant="none")  # decode keeps the exact head
    if frozen_quant == "none":
        return load_hf_params(model_dir, model_cfg, dtype=cfg.param_dtype,
                              device=device), model_cfg
    state, _ = build_scan_state_from_hf(cfg, model_dir, plan or SMTPlan(mode="matrix"),
                                        model_cfg, keep_host=False, device=device)
    return decode_params_from_scan(state, model_cfg, frozen_quant=frozen_quant,
                                   consume=True), model_cfg


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from sparse_matrix_tuning_tpu_torch.eval.generate import GenerationConfig
    from sparse_matrix_tuning_tpu_torch.eval.harness import make_generate_fn, run_dataset_eval
    from sparse_matrix_tuning_tpu_torch.models.hf_io import load_hf_tokenizer
    from sparse_matrix_tuning_tpu_torch.utils.logging import print_rank_0, set_random_seed

    set_random_seed(args.seed)
    if not args.do_sample:
        # the greedy/beam branch never reads the sampling warpers: fail loud
        # instead of silently ignoring them
        defaults = {"temperature": 1.0, "top_k": 0, "top_p": 1.0}
        knobs = [f"--{k}={getattr(args, k)}" for k in defaults
                 if getattr(args, k) != defaults[k]]
        if knobs:
            raise SystemExit(
                f"{', '.join(knobs)} set but --do_sample is off — sampling knobs have no "
                "effect on greedy/beam decoding; pass --do_sample or drop them")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
    device, mesh = torch.device(args.device), None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # the eval shards nothing: it splits the prompts over the processes
        # whatever the training mesh was (JAX's harness strides by process)
        from sparse_matrix_tuning_tpu_torch.parallel.mesh import init_distributed, make_mesh
        device = init_distributed(None if args.device == "cuda" else device)
        mesh = make_mesh(None, device=device)
    params, model_cfg = load_decode_params(args.model_name_or_path, args.frozen_quant,
                                           args.dtype, device)
    # reference tokenizer setup for eval (:228-235): left padding, long cap
    tokenizer = load_hf_tokenizer(args.model_name_or_path, args.max_seq_len)
    tokenizer.padding_side = "left"

    gen_cfg = GenerationConfig(
        max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
        repetition_penalty=args.repetition_penalty,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id or 0,
        cache_dtype=("int8" if args.kv_cache == "int8"
                     else "bfloat16" if args.dtype == "bf16" else "float32"),
        do_sample=args.do_sample, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    generate_fn = make_generate_fn(params, model_cfg, tokenizer, gen_cfg,
                                   batch_size=args.per_device_eval_batch_size, device=device)

    results = {}
    for dataset in args.datasets:
        print_rank_0(f"Handling dataset: {dataset}")
        with open(os.path.join(args.data_path, dataset, "test.json")) as f:
            examples = json.load(f)
        res = run_dataset_eval(dataset, examples, generate_fn, output_dir=args.output_dir,
                               mesh=mesh)
        results[dataset] = res["accuracy"]

    if results:
        avg = sum(results.values()) / len(results)
        print_rank_0(f"Average accuracy over {len(results)} datasets: {avg * 100:.1f}%")
        if mesh is None or mesh.is_main:
            os.makedirs(args.output_dir, exist_ok=True)
            with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
                json.dump({"per_dataset": results, "average": avg}, f, indent=2)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
