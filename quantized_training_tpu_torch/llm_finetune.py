"""LLM instruction finetuning driver of the port.

Counterpart of the JAX package's ``llm_finetune.py``, with its flags but
``--cache_dir`` (XLA's compilation cache):

- samples from ``--dataset``: ``synthetic`` (256 random-token samples from
  numpy's ``default_rng(0)``, 16 to ``--max_seq_len`` tokens, ids below
  ``--model_kwargs``' ``vocab_size`` or 32000), a local JSONL file of
  ``{"query", "response"}`` rows, or ``metamathqa`` from the hub
  (``datasets`` imported only then); each row in the MetaMathQA template
  (:data:`TEMPLATE`), tokenized by ``--tokenizer`` with bos and eos and cut
  to ``--max_seq_len`` tokens;
- :func:`data_iter`: each epoch a permutation from numpy's
  ``default_rng(--seed)``; a batch is padded to the next multiple of
  ``--seq_len_multiple`` of its longest sample, inputs with 0 and labels
  with -100, so a few shapes recur. The labels are the inputs themselves,
  not shifted by one, as the JAX package writes them, and the loss scores
  position t against ``labels[t]`` (``models/llama.py::loss_fn``), so the
  step trains the model to copy the token it is given (ROADMAP C);
- the model: ``--model`` by name or an HF-format config path, with
  ``remat=True``, ``max_position_embeddings=--max_seq_len`` and BitNet's
  norms for ``--quantize bitnet``; the lm_head is never quantized (it may be
  tied to the embedding); ``--init_ckpt`` replaces the quantized parameters
  with a checkpoint's (``state[0]`` of a train state, else
  ``state["params"]``);
- step i takes the key ``fold_in(--seed, 1_000_000 + i)``; every
  ``--log_interval`` steps (and at the last) the loss, the grad norm, the
  lr, the batch's padded length and the steps per second go to stdout and
  ``runs/llm_finetune/<time>_<run_name>/metrics.jsonl``; every
  ``--ckpt_interval`` steps the model alone to ``last.pkl`` in the same
  directory (``{"state": {"params"}, "meta": {"step"}}``), which
  ``llm_evaluate --ckpt`` reads.

It runs on the CUDA card unless ``--cpu`` is given, and raises without a
card.

  python -m quantized_training_tpu_torch.llm_finetune --model mini_llamas/Llama-2-470m \\
      --init_ckpt runs/llm_pretrain/<run>/last.pkl --dataset data.jsonl --tokenizer byte \\
      --quantize mixed_precision --batch_size 4 --n_steps 100
"""

from __future__ import annotations

import argparse
import json
import math
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from . import optim, quant, train
from .data import get_tokenizer
from .llm_pretrain import device_of, model_config
from .models import llama
from .ops.random import fold_in
from .quant.api import _is_linear_weight_path
from .utils import MetricLogger, load_checkpoint, print_model_stats, save_checkpoint

TEMPLATE = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{query}\n\n"
    "### Response: Let's think step by step. {response}"
)


def data_iter(tokens_list, batch_size: int, seq_len_multiple: int, seed: int):
    """Endless (inputs int32, labels int64) batches: each epoch a
    permutation of the samples, cut into whole batches, each padded to a
    multiple of ``seq_len_multiple`` (inputs 0, labels -100)."""
    rng = np.random.default_rng(seed)
    n = len(tokens_list)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            batch = [tokens_list[j] for j in order[i : i + batch_size]]
            length = max(math.ceil(len(x) / seq_len_multiple) * seq_len_multiple for x in batch)
            inputs = np.zeros((batch_size, length), np.int32)
            labels = np.full((batch_size, length), -100, np.int64)
            for bi, toks in enumerate(batch):
                inputs[bi, : len(toks)] = toks
                labels[bi, : len(toks)] = toks
            yield inputs, labels


def args_vocab(args) -> int:
    return args.model_kwargs.get("vocab_size", 32000)


def load_samples(args, tokenizer):
    """The samples as lists of token ids (see the module's docstring)."""
    if args.dataset == "metamathqa":
        from datasets import load_dataset

        ds = load_dataset("meta-math/MetaMathQA", split="train")
        rows = ({"query": r["query"], "response": r["response"]} for r in ds)
    elif args.dataset == "synthetic":
        rng = np.random.default_rng(0)
        return [rng.integers(0, args_vocab(args), rng.integers(16, args.max_seq_len)).astype(np.int32).tolist()
                for _ in range(256)]
    else:  # a local jsonl
        with open(args.dataset) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    out = []
    for r in rows:
        toks = tokenizer(TEMPLATE.format(**r), add_bos=True, add_eos=True)
        out.append(toks[: args.max_seq_len])
    return out


def not_lm_head(path, leaf) -> bool:
    """The quantize filter: every linear weight but the lm_head's."""
    return _is_linear_weight_path(path) and "lm_head" not in path


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Finetune a Llama with the PyTorch port.")
    parser.add_argument("--model", default="llama2-470m")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())
    parser.add_argument("--init_ckpt", help="pretrained checkpoint to start from")

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())

    parser.add_argument("--dataset", default="synthetic", help="metamathqa | synthetic | path/to/data.jsonl")
    parser.add_argument("--tokenizer", default="llama3")
    parser.add_argument("--max_seq_len", type=int, default=2048)
    parser.add_argument("--seq_len_multiple", type=int, default=256)

    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--n_steps", type=int, default=1000)

    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--optim_kwargs", type=json.loads, default=dict())

    parser.add_argument("--ckpt_interval", type=int, default=1000)
    parser.add_argument("--run_name", default="run")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    return parser


def main(argv: list[str] | None = None) -> dict:
    """Runs the driver; returns the run directory and the final state
    (``{"save_dir", "state"}``) for a caller in the same process."""
    args = _parser().parse_args(argv)
    device = device_of(args.cpu, "llm_finetune")
    cfg = model_config(args.model, max_position_embeddings=args.max_seq_len, remat=True,
                       bitnet=args.quantize == "bitnet", **args.model_kwargs)
    key = args.seed  # an int key (ops/random.py)
    params = llama.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)
    # never quantize the lm_head: it may be tied to the embedding
    qparams = quant.quantize_params(params, args.quantize, filter_fn=not_lm_head, **args.quantize_kwargs)
    if args.init_ckpt:
        state = load_checkpoint(args.init_ckpt, device)["state"]
        qparams = state[0] if isinstance(state, (tuple, list)) else state["params"]
        del state
    print_model_stats(params)
    del params

    optimizer = optim.get_optimizer(args.optim, weight_decay=args.weight_decay, **args.optim_kwargs)
    state = train.init_train_state(qparams, optimizer)
    del qparams
    # eager: the padded length changes from batch to batch, and each length would cost a graph and its pool
    step_fn = train.make_train_step(cfg, optimizer, jit_compile=False)

    tokenizer = get_tokenizer(args.tokenizer) if args.dataset != "synthetic" else None
    samples = load_samples(args, tokenizer)
    print(f"Training dataset size: {len(samples):,}")
    it = data_iter(samples, args.batch_size, args.seq_len_multiple, args.seed)

    save_dir = Path("runs/llm_finetune") / f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{args.run_name}"
    logger = MetricLogger(save_dir)

    step = 0
    time0 = time.time()
    while step < args.n_steps:
        inputs, labels = next(it)
        state, metrics = step_fn(state, torch.from_numpy(inputs).to(device), torch.from_numpy(labels).to(device),
                                 args.lr, fold_in(key, 1_000_000 + step))
        step += 1
        if step % args.log_interval == 0 or step == args.n_steps:
            loss = metrics["loss"].item()  # waits for the step
            time1 = time.time()
            log = dict(loss=loss, grad_norm=metrics["grad_norm"].item(), lr=args.lr, seq_len=int(inputs.shape[1]),
                       steps_per_second=min(args.log_interval, step) / (time1 - time0))
            time0 = time1
            logger.log(log, step)
            print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in log.items()), flush=True)

        if args.ckpt_interval > 0 and step % args.ckpt_interval == 0:
            # the model alone
            save_checkpoint(save_dir / "last.pkl", {"state": {"params": state.params}, "meta": {"step": step}})

    logger.finish()
    print(f"done; artifacts in {save_dir}")
    return {"save_dir": save_dir, "state": state}


if __name__ == "__main__":
    main()
