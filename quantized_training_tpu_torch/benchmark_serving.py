"""Continuous-batching serving throughput of the port: windowed against
full-cache decode.

Counterpart of the JAX repository's ``benchmark_serving.py`` (:32-185), with
its flags and method, over ``models/serving.py::Server``, which decodes
each step at the smallest power-of-two attention window that covers the
deepest active slot. An identical request set drains through (a) the
windowed server and (b) one pinned to the single ``max_len`` window
(``window_buckets=(max_len,)``), each after a warm drain of the same set on
the same server; generated tokens per second count every streamed token,
the prefills' included, over a wall that ends in
``torch.cuda.synchronize()``.

``--load uniform``: ``n_slots`` prompts of ``--prompt_len`` tokens from
``np.random.default_rng(0)``, ``--new_tokens`` each. ``--load mixed``:
:func:`_mixed_requests`, 3 x ``n_slots`` requests with the prompt lengths
``MIX_PROMPTS`` and budgets ``MIX_BUDGETS`` in turn, the prompts drawn from
``np.random.default_rng(0)`` as JAX draws them (JAX's prompts, token for
token); then the no-server baseline, static batched ``generate`` over the
same set (:func:`measure_static_generate`). The "windows compiled" are the
keys (window, tokens a call) of the server's ``_decode_fns``.

``--model tiny`` is JAX's CPU smoke-test model (:159-165). ``--cpu`` runs the
plain versions with the host clock: it exists to drive the entry point in
tests, and its numbers are no device metric.

  python -m quantized_training_tpu_torch.benchmark_serving [--model llama2-1b] [--n_slots 8] [--max_len 2048] [--prompt_len 64] [--new_tokens 448] [--quantize mixed_precision] [--decode_chunk 16] [--load uniform|mixed] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from . import quant
from .bench import device_name, log
from .llm_pretrain import MODELS, device_of
from .models import llama
from .models.llama_infer import generate
from .models.serving import Server
from .utils.timing import sync

MIX_PROMPTS = (32, 96, 224, 480)
MIX_BUDGETS = (64, 160, 320, 448)


def tiny(max_len: int) -> llama.LlamaConfig:
    """JAX's CPU smoke-test config (:159-165)."""
    return llama.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=max_len)


def drain(srv: Server, prompts, new_tokens: int) -> int:
    return drain_mixed(srv, [(p, new_tokens) for p in prompts])


def _server(params, cfg, args, window_buckets) -> Server:
    return Server(params, cfg, n_slots=args.n_slots, max_len=args.max_len, window_buckets=window_buckets,
                  decode_chunk=args.decode_chunk)


def _timed(srv: Server, fn, *fn_args) -> float:
    """Tokens/s of ``fn(srv, *fn_args)``, a drain that returns its tokens."""
    sync(srv.device)
    t0 = time.perf_counter()
    n = fn(srv, *fn_args)
    sync(srv.device)
    return n / (time.perf_counter() - t0)


def measure(params, cfg, args, window_buckets):
    """(tok/s, the (window, tokens a call) decode steps made) of the
    uniform load (JAX :43-63): the timed drain after an identical warm one
    on the same server."""
    srv = _server(params, cfg, args, window_buckets)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=args.prompt_len).tolist() for _ in range(args.n_slots)]
    drain(srv, prompts, args.new_tokens)
    return _timed(srv, drain, prompts, args.new_tokens), sorted(srv._decode_fns)


def _mixed_requests(n_req: int, vocab: int):
    """(prompt, budget) of JAX's mixed load (:66-76), prompt lengths and
    budgets in turn."""
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, size=MIX_PROMPTS[i % len(MIX_PROMPTS)]).tolist(),
             MIX_BUDGETS[i % len(MIX_BUDGETS)]) for i in range(n_req)]


def drain_mixed(srv: Server, reqs) -> int:
    for prompt, budget in reqs:
        srv.add_request(prompt, max_new_tokens=budget)
    n = 0
    while srv.pending():
        n += len(srv.step())
    return n


def measure_mixed(params, cfg, args, window_buckets):
    """(tok/s, the (window, tokens a call) decode steps made) of the
    queue-pressure load (JAX :87-103): 3 x n_slots mixed requests; short
    ones finish early and free their slots for queued ones mid-flight."""
    srv = _server(params, cfg, args, window_buckets)
    reqs = _mixed_requests(3 * args.n_slots, cfg.vocab_size)
    drain_mixed(srv, reqs)  # warm: every prefill bucket and window the timed drain reaches
    return _timed(srv, drain_mixed, reqs), sorted(srv._decode_fns)


def static_batches(reqs, n_slots: int, device) -> list:
    """The requests in batches of ``n_slots``, each prompt left-padded with
    token 0 to the longest (its last position is real; the pads are attended
    to, as in JAX)."""
    pmax = max(len(p) for p, _ in reqs)
    batches = []
    for i in range(0, len(reqs), n_slots):
        chunk = reqs[i:i + n_slots]
        arr = np.zeros((len(chunk), pmax), np.int64)
        for j, (prompt, _) in enumerate(chunk):
            arr[j, -len(prompt):] = prompt
        batches.append(torch.from_numpy(arr).to(device))
    return batches


def measure_static_generate(params, cfg, args):
    """(useful tok/s, each batch's tokens) of the no-server baseline over the
    mixed set (JAX :106-134): every batch runs to the largest budget, so
    the useful tokens are the requested ones over the wall of all
    batches."""
    reqs = _mixed_requests(3 * args.n_slots, cfg.vocab_size)
    useful = sum(b for _, b in reqs)
    bmax = max(b for _, b in reqs)
    device = params["embed"]["embedding"].device
    batches = static_batches(reqs, args.n_slots, device)

    def run():
        outs = [generate(params, b, cfg, bmax, max_len=args.max_len) for b in batches]
        for out in outs:
            out[:, -1].cpu()
        return outs

    run()  # warm
    sync(device)
    t0 = time.perf_counter()
    outs = run()
    sync(device)
    return useful / (time.perf_counter() - t0), outs


def mixed_load(params, cfg, args) -> dict:
    """The mixed load through the windowed and the full-window server, then
    static batched ``generate`` (JAX :139-150): their tok/s, the windows
    compiled and the static batches' tokens."""
    tok_w, wins = measure_mixed(params, cfg, args, None)
    log(f"windowed server (mixed load): {tok_w:.1f} tok/s (windows compiled: {wins})")
    tok_f, _ = measure_mixed(params, cfg, args, (args.max_len,))
    log(f"full-window server (mixed load): {tok_f:.1f} tok/s")
    tok_s, outs = measure_static_generate(params, cfg, args)
    log(f"static batched generate (padded): {tok_s:.1f} useful tok/s")
    log(f"windowed/full = {tok_w / tok_f:.3f}x, windowed/static = {tok_w / tok_s:.3f}x")
    return {"windowed": tok_w, "full": tok_f, "static": tok_s, "windows": wins, "static_tokens": outs}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama2-1b", help="|".join([*MODELS, "tiny"]))
    p.add_argument("--n_slots", type=int, default=8)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--prompt_len", type=int, default=64)
    p.add_argument("--new_tokens", type=int, default=448)
    p.add_argument("--quantize", default=None)
    p.add_argument("--decode_chunk", type=int, default=16, help="decode tokens per step() call")
    p.add_argument("--load", choices=("uniform", "mixed"), default="uniform",
                   help="mixed: 3x n_slots requests, mixed prompt lengths/budgets, plus a static batched "
                        "generate() baseline")
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "benchmark_serving")

    cfg = tiny(args.max_len) if args.model == "tiny" else MODELS[args.model]
    cfg = dataclasses.replace(cfg, max_position_embeddings=args.max_len)
    params = quant.quantize_params(llama.init_params(torch.Generator(device=device).manual_seed(0), cfg),
                                   args.quantize)
    log(f"device: {device_name(device)}, {args.model}, "
        f"quantize={args.quantize}, load={args.load}")

    if args.load == "mixed":
        return mixed_load(params, cfg, args)
    tok_w, wins = measure(params, cfg, args, None)
    log(f"windowed decode: {tok_w:.1f} tok/s (windows compiled: {wins})")
    tok_f, _ = measure(params, cfg, args, (args.max_len,))
    log(f"full-window decode: {tok_f:.1f} tok/s")
    log(f"windowed / full = {tok_w / tok_f:.3f}x")
    return {"windowed": tok_w, "full": tok_f, "windows": wins}


if __name__ == "__main__":
    main()
