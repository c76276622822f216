"""Task-accuracy parity of the port (counterpart of the JAX package's
``accuracy_parity.py``): bf16 against quantized training on one task.

Four configurations train the same model from the same initialization on
the same Markov-chain stream for the same number of steps, and each is
scored on the same generated multiple-choice set
(``mc_eval.generate_markov_mc``, the least-summed-continuation-loss recipe):

  bf16; int8 ``mixed_precision``; int8 ``mixed_precision`` with stochastic
  rounding; fp8 e4m3 ``mixed_precision`` with row scales.

The model (4 layers, hidden 256, FFN 1024, vocab 2048, 4 heads of 64) has
every attention and MLP width at least 128, so the default quantize filter
wraps every body linear: the quantized configurations really train through
their int8 or fp8 matmuls (the script asserts that the filter wrapped
some). The optimizer is ``adamw_bf16_sr`` without the SR writeback, lr
``--lr``; step i takes the key i; the chain is ``MarkovTokenDataset(vocab
2048, 512 states, branching 4)`` at ``--seq_len``, batched by ``--batch_size``.
The trained masters are scored through ``merge_masters`` with no key (the SR
configuration's forward rounds from key 0) on ``--eval_rows`` rows of 24
prompt and 6 continuation tokens, in batches of 16.

The eval set is written beside ``--out`` as ``parity_mc.jsonl`` (at the
defaults ``runs/parity_mc.jsonl``, the JAX script's path). One markdown row
a configuration goes to stdout, progress to stderr, and the JSON summary to
``--out``. It runs on the CUDA card unless ``--cpu`` is given, and raises
without a card.

  python -m quantized_training_tpu_torch.accuracy_parity --steps 1200 --out runs/parity.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import optim, quant, train
from .data import BatchLoader
from .data.text import MarkovTokenDataset
from .llm_pretrain import device_of
from .mc_eval import evaluate_mc, generate_markov_mc
from .models import llama
from .utils.tree import tree_leaves

CONFIGS = [
    # (name, scheme, scheme_kwargs)
    ("bf16", None, {}),
    ("int8 mixed-precision", "mixed_precision", {}),
    ("int8 mixed-precision + SR", "mixed_precision", {"stochastic_rounding": True}),
    ("fp8_e4m3 row-scaled", "mixed_precision", {"dtype": "fp8_e4m3"}),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="bf16 against quantized training on one multiple-choice task.")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--seq_len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--eval_rows", type=int, default=400)
    ap.add_argument("--out", default="runs/parity.json")
    ap.add_argument("--configs", type=json.loads, help="subset of config names")
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Runs the configurations; returns the JSON summary."""
    args = _parser().parse_args(argv)
    device = device_of(args.cpu, "accuracy_parity")
    # every linear width >= 128, so that the default quantize filter engages
    cfg = llama.LlamaConfig(vocab_size=2048, hidden_size=256, intermediate_size=1024, num_hidden_layers=4,
                            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=args.seq_len)
    chain = dict(vocab_size=cfg.vocab_size, n_states=512, branching=4)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    eval_path = str(Path(args.out).parent / "parity_mc.jsonl")
    generate_markov_mc(eval_path, n_rows=args.eval_rows, prompt_len=24, cont_len=6, n_choices=4, **chain)
    log(f"eval set: {args.eval_rows} rows at {eval_path}")

    results = []
    for name, scheme, kwargs in CONFIGS:
        if args.configs and name not in args.configs:
            continue
        t0 = time.time()
        params = llama.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        qparams = quant.quantize_params(params, scheme, **kwargs)
        del params
        if scheme is not None:
            n_wrapped = sum(map(quant.is_quant_weight, tree_leaves(qparams, is_leaf=quant.is_quant_weight)))
            assert n_wrapped > 0, "quantization filter skipped everything"
        opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
        state = train.init_train_state(qparams, opt)
        step = train.make_train_step(cfg, opt, jit_compile=train.capture_refusal(qparams) is None)

        ds = MarkovTokenDataset(seq_len=args.seq_len, **chain)
        loader = iter(BatchLoader(ds, batch_size=args.batch_size))
        loss = float("nan")
        for i in range(args.steps):
            tok, lab = (torch.from_numpy(a).to(device) for a in next(loader))
            state, metrics = step(state, tok, lab, args.lr, i)
            if (i + 1) % 200 == 0 or i == args.steps - 1:
                loss = metrics["loss"].item()  # always sampled at the end
                log(f"  {name}: step {i + 1} loss {loss:.4f}")
        loader.close()  # stops the prefetch thread

        trained = quant.merge_masters(quant.virtual_params(state.params), state.params)
        acc = evaluate_mc(trained, cfg, "mc", eval_path, tokenizer="ints", batch_size=16)
        results.append(dict(config=name, accuracy=acc, final_loss=loss, train_s=round(time.time() - t0, 1)))
        log(f"{name}: accuracy {acc:.4f} (loss {loss:.4f}, {results[-1]['train_s']}s)")

    print("\n| Training config | MC accuracy | final loss |")
    print("|---|---|---|")
    for r in results:
        print(f"| {r['config']} | {r['accuracy']:.3f} | {r['final_loss']:.3f} |")
    summary = dict(steps=args.steps, batch_size=args.batch_size, seq_len=args.seq_len, eval_rows=args.eval_rows,
                   results=results)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    log(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
