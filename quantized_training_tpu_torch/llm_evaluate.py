"""LLM evaluation driver of the port.

Counterpart of the JAX package's ``llm_evaluate.py``, with its flags: the
model (``--model``, ``--model_kwargs``, ``--seq_len``), quantized by
``--quantize`` BEFORE the checkpoint (``--ckpt``) is loaded, so that the
checkpoint's weight wrappers replace wrappers of the same kind, then the
tasks. ``perplexity`` runs ``train.make_eval_step`` over at most
``--max_batches`` batches of ``--eval_ds`` (a dataset JSON, its eval split)
and reports ``exp`` of the mean loss. ``hellaswag`` scores 4-choice
accuracy (``hellaswag.evaluate_hellaswag``) on ``--hellaswag_data`` (a local
JSON or JSONL file) or the hub's validation split, tokenized by
``--hellaswag_tokenizer``. ``arc``, ``piqa`` and ``mc`` score
``mc_eval.evaluate_mc`` on the local JSONL ``--task_data``, which they
require, with the same tokenizer (``ints`` for token-id sets such as the
Markov task) and at most ``--max_rows`` rows. Both take batches of
``--batch_size`` rows. ``--generate N`` samples N tokens after a prompt of
four zeros through ``llama_infer.generate`` (temperature 0.8, a generator
seeded with ``--seed``). The results print as JSON.

It runs on the CUDA card unless ``--cpu`` is given, and raises without a
card.

  python -m quantized_training_tpu_torch.llm_evaluate --ckpt runs/llm_pretrain/<run>/last.pkl \\
      --quantize mixed_precision --tasks perplexity --eval_ds '{"type": "markov"}'
  python -m quantized_training_tpu_torch.llm_evaluate --ckpt runs/llm_finetune/<run>/last.pkl \\
      --quantize mixed_precision --tasks hellaswag mc --hellaswag_data hellaswag.jsonl \\
      --task_data mc.jsonl --hellaswag_tokenizer byte
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import hellaswag, mc_eval, quant, train
from .data import BatchLoader, get_dataset
from .llm_pretrain import device_of, model_config
from .models import llama, llama_infer
from .utils import load_checkpoint

TASKS = ("perplexity", "hellaswag", "arc", "piqa", "mc")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate a Llama with the PyTorch port.")
    parser.add_argument("--model", default="llama2-470m")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())
    parser.add_argument("--seq_len", type=int, default=2048)

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize_lm_head", action="store_true")

    parser.add_argument("--ckpt")
    parser.add_argument("--tasks", nargs="+", default=["perplexity"])
    parser.add_argument("--eval_ds", type=json.loads)
    parser.add_argument("--max_batches", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=8)

    parser.add_argument("--hellaswag_tokenizer", default="llama3")
    parser.add_argument("--hellaswag_data")
    parser.add_argument("--task_data", help="local jsonl for arc/piqa/mc tasks")
    parser.add_argument("--max_rows", type=int)
    parser.add_argument("--generate", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--seed", type=int, default=2024)
    return parser


def perplexity(args, cfg, qparams, device) -> dict:
    """``exp`` of the mean ``make_eval_step`` loss over at most
    ``--max_batches`` batches of ``--eval_ds``'s eval split."""
    if args.eval_ds is None:
        raise ValueError("--eval_ds is required for perplexity")
    if args.eval_ds.get("type") == "synthetic":
        args.eval_ds.setdefault("vocab_size", cfg.vocab_size)
    loader = BatchLoader(get_dataset(seq_len=args.seq_len, eval=True, **args.eval_ds), batch_size=args.batch_size)
    eval_step = train.make_eval_step(cfg)
    total_loss, n = 0.0, 0
    batches = iter(loader)
    for i, (tokens, labels) in enumerate(batches):
        if i >= args.max_batches:
            break
        total_loss += eval_step(qparams, torch.from_numpy(tokens).to(device),
                                torch.from_numpy(labels).to(device)).item()
        n += 1
    batches.close()  # stops the prefetch thread
    loss = total_loss / max(n, 1)
    return {"perplexity": float(np.exp(loss)), "eval_loss": loss}


def main(argv: list[str] | None = None) -> dict:
    """Runs the driver; returns the results and the evaluated parameters
    (``{"results", "params"}``) for a caller in the same process."""
    args = _parser().parse_args(argv)
    for task in args.tasks:
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}")
        if task in ("arc", "piqa", "mc") and not args.task_data:
            raise ValueError(f"--task_data is required for {task}")
    device = device_of(args.cpu, "llm_evaluate")
    cfg = model_config(args.model, max_position_embeddings=args.seq_len, bitnet=args.quantize == "bitnet",
                       **args.model_kwargs)

    params = llama.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)
    # quantize BEFORE loading the checkpoint: its leaves are the wrapper trees
    qparams = quant.quantize_params(params, args.quantize, **args.quantize_kwargs)
    del params
    if args.ckpt:
        state = load_checkpoint(args.ckpt, device)["state"]
        qparams = state[0] if isinstance(state, (tuple, list)) else state["params"]
        print(f"loaded checkpoint {args.ckpt}")

    results = {}
    for task in args.tasks:
        if task == "perplexity":
            results.update(perplexity(args, cfg, qparams, device))
        elif task == "hellaswag":
            results["hellaswag_acc"] = hellaswag.evaluate_hellaswag(
                qparams, cfg, args.hellaswag_tokenizer, data_path=args.hellaswag_data, batch_size=args.batch_size)
        else:
            results[f"{task}_acc"] = mc_eval.evaluate_mc(
                qparams, cfg, task, args.task_data, tokenizer=args.hellaswag_tokenizer, batch_size=args.batch_size,
                max_rows=args.max_rows)

    if args.generate:
        prompt = torch.zeros((1, 4), dtype=torch.int64, device=device)
        with torch.no_grad():
            out = llama_infer.generate(qparams, prompt, cfg, args.generate, temperature=0.8,
                                       generator=torch.Generator(device=device).manual_seed(args.seed))
        results["sample_tokens"] = out[0].tolist()

    print(json.dumps(results, indent=2))
    return {"results": results, "params": qparams}


if __name__ == "__main__":
    main()
