"""Inference throughput of the port: int8-KV-cache prefill and greedy decode.

Counterpart of the JAX repository's ``benchmark_inference.py`` (:30-97), with
its flags and method: ``models/llama_infer.py::generate`` (the int8 KV cache;
weights under ``--quantize``, bf16 by default) on a prompt of
``--prompt_len`` tokens from seed 1 at each batch of ``--bs``, ``--new_tokens``
greedy tokens; one warm call, then the least wall of 3 calls, each ending in
``torch.cuda.synchronize()``. Generated tokens per second count every
sequence's new tokens over that wall, the prefill included (an upper bound of
the per-step cost, as in JAX).

Prints JAX's JSON line: ``metric``, ``prompt_len``, ``new_tokens``,
``quantize`` and ``results`` (each batch's ``gen_tokens_per_sec`` and
``wall_ms``). JAX's catch-all around each batch is narrowed to
``torch.OutOfMemoryError``: that batch is then left out, any other error
propagates. ``--cpu`` runs the plain versions with the host clock: it exists
to drive the entry point in tests, and its numbers are no device metric.

  python -m quantized_training_tpu_torch.benchmark_inference [--model llama2-1b] [--bs 1 8 32] [--prompt_len 512] [--new_tokens 128] [--quantize mixed_precision] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from . import quant
from .bench import device_name, log, release_memory
from .llm_pretrain import MODELS, device_of
from .models import llama
from .models.llama_infer import generate
from .utils.timing import sync


def timed_generate(params, prompt: torch.Tensor, cfg: llama.LlamaConfig, new_tokens: int) -> tuple:
    """(the tokens, the least wall in seconds of 3 greedy ``generate``
    calls after a warm one)."""
    out = generate(params, prompt, cfg, new_tokens, temperature=0.0)
    out[0, -1].item()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = generate(params, prompt, cfg, new_tokens, temperature=0.0)
        out[0, -1].item()
        sync(prompt.device)
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama2-1b", help="|".join(MODELS))
    p.add_argument("--bs", type=int, nargs="+", default=[1, 8, 32])
    p.add_argument("--prompt_len", type=int, default=512)
    p.add_argument("--new_tokens", type=int, default=128)
    p.add_argument("--quantize", default=None)
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "benchmark_inference")

    cfg = dataclasses.replace(MODELS[args.model], max_position_embeddings=args.prompt_len + args.new_tokens)
    params = llama.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    log(f"device: {device_name(device)}, {args.model}, quantize={args.quantize}, int8 KV cache")
    qparams = quant.quantize_params(params, args.quantize)
    results = []
    for bs in args.bs:
        prompt = torch.randint(0, cfg.vocab_size, (bs, args.prompt_len),
                               generator=torch.Generator(device=device).manual_seed(1), device=device)
        try:
            _, dt = timed_generate(qparams, prompt, cfg, args.new_tokens)
        except torch.OutOfMemoryError as e:
            log(f"bs={bs}: FAILED {type(e).__name__}: {str(e)[:140]}")
            dt = None
        if dt is None:
            release_memory()
            continue
        decode_tps = bs * args.new_tokens / dt  # upper bound incl. prefill amortized
        log(f"bs={bs}: {dt * 1e3:,.0f} ms for prefill({args.prompt_len}) + {args.new_tokens} new -> "
            f"{decode_tps:,.0f} gen tok/s, {dt / args.new_tokens * 1e3:.1f} ms/step upper bound")
        results.append({"batch": bs, "gen_tokens_per_sec": round(decode_tps, 1), "wall_ms": round(dt * 1e3, 1)})

    line = {"metric": f"{args.model}_int8kv_generate_tokens_per_sec", "prompt_len": args.prompt_len,
            "new_tokens": args.new_tokens, "quantize": args.quantize, "results": results}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
