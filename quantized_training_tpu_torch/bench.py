"""Headline benchmark of the port: int8 mixed-precision Llama pretraining,
tokens per second on one card, against bf16.

Counterpart of the JAX repository's ``bench.py`` (:54-209), with its method:
Llama2-1B at seq 2048 and effective batch 16, run as 4 x 4 gradient
accumulation, the whole train step (forward, backward under the remat
policy, ``adamw_bf16_sr`` without its SR writeback, lr 1e-4), int8
``mixed_precision`` on the forward and both backward matmuls (the fused layer
on the card) against the same step in bf16, in one process. Step i's key is
``fold_in(2, i)``.

:func:`measure` runs 2 warm steps, then ``N_STEPS`` steps reading the loss
after each (synced), then ``N_STEPS`` more with one read at the end
(chained); every wall ends in ``torch.cuda.synchronize()`` and the rate is
tokens over the smaller of the two step times. ``RUNGS`` are tried in order
for int8, the next only after ``torch.OutOfMemoryError`` (any other error
propagates), and bf16 runs at the rung int8 ran at.

Prints JAX's one JSON line: ``value`` the int8 tokens/s, ``vs_baseline``
the int8/bf16 speedup over 1.68 (the original repository's best int8
speedup, on its own GPU), ``detail`` the bf16 rate, the speedup, the batch
and the card's name. Diagnostics, the card's name and power limit among
them, go to stderr.

Two departures from the JAX script: no persistent compile cache (the port
compiles only its kernels, once, ``ops/_build.py``), and no retry under
``QT_FUSED=0`` when every rung fails, which would report the unfused layer's
number in place of a failing fused kernel.

``--cpu`` runs the kernels' plain versions with the host clock: it exists to
drive the entry point in tests, and its numbers are no device metric.

  python -m quantized_training_tpu_torch.bench [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
from typing import NamedTuple

import torch

from . import optim, quant, train
from .benchmark_mm import card_line
from .llm_pretrain import MODELS, device_of
from .models import llama
from .ops.random import fold_in
from .utils.timing import sync

N_STEPS = 8
SEQ = 2048
# (model, batch, seq, accumulation), tried in order (JAX :148-153): the
# headline effective batch 16 as 4 x 4, then the single-batch fallbacks
RUNGS = [("llama2-1b", 4, SEQ, 4), ("llama2-1b", 8, SEQ, 1), ("llama2-1b", 4, SEQ, 1), ("llama2-470m", 8, SEQ, 1)]
LR = 1e-4
KEY = 2
REFERENCE_SPEEDUP = 1.68  # the original repository's best int8/bf16 speedup (its README.md:134)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_name(device: str) -> str:
    """The card's name, where the driver runs on it, else 'cpu'; on the card
    the name and power limit go to stderr first."""
    if device != "cuda":
        return "cpu"
    log(card_line())
    return torch.cuda.get_device_name(0)


class Measured(NamedTuple):
    tokens_per_sec: float
    synced_s: float  # one step's wall in the synced loop
    chained_s: float  # and in the chained loop


def release_memory() -> None:
    """Hands back to the card what a run that ran out of memory left
    cached; called after its exception (and the frames it held) is gone."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def build_step(cfg_name: str, bs: int, seq: int, scheme: str | None, accum: int = 1, device: str = "cuda"):
    """(state, step, tokens, labels): the model's weights from seed 0 under
    ``scheme``, ``adamw_bf16_sr`` without SR, tokens [accum, bs, seq] (or
    [bs, seq]) from seed 1, labels the tokens shifted by one (JAX :54-74)."""
    cfg = dataclasses.replace(MODELS[cfg_name], max_position_embeddings=seq, remat=True)
    params = llama.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = train.init_train_state(quant.quantize_params(params, scheme), optimizer)
    step = train.make_train_step(cfg, optimizer)
    shape = (accum, bs, seq) if accum > 1 else (bs, seq)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator(device=device).manual_seed(1),
                           device=device)
    return state, step, tokens, torch.roll(tokens, -1, dims=-1)


def finite(loss: float, what: str) -> float:
    if not math.isfinite(loss):
        raise FloatingPointError(f"{what}: loss {loss}")
    return loss


def measure(cfg_name: str, bs: int, seq: int, scheme: str | None, accum: int = 1, device: str = "cuda",
            n_steps: int | None = None) -> Measured:
    """Tokens/s of the step (JAX :77-118): 2 warm steps, ``n_steps``
    (``N_STEPS``) synced steps, then as many chained ones."""
    n_steps = N_STEPS if n_steps is None else n_steps
    t0 = time.perf_counter()
    state, step, tokens, labels = build_step(cfg_name, bs, seq, scheme, accum, device)
    for i in range(2):  # warm: the library build, cuBLAS handles, the allocator's pools
        state, m = step(state, tokens, labels, LR, fold_in(KEY, i))
        l0 = m["loss"].item()
    sync(device)
    log(f"  build+warm {time.perf_counter() - t0:.0f}s, loss={l0:.3f}")
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, m = step(state, tokens, labels, LR, fold_in(KEY, 100 + i))
        l1 = m["loss"].item()  # read every step
        sync(device)
    dt_synced = (time.perf_counter() - t0) / n_steps
    finite(l1, "synced loop")
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, m = step(state, tokens, labels, LR, fold_in(KEY, 200 + i))
    l2 = m["loss"].item()  # one read for the whole chain
    sync(device)
    dt_chained = (time.perf_counter() - t0) / n_steps
    finite(l2, "chained loop")
    log(f"  per-step: synced {dt_synced * 1e3:.1f} ms, chained {dt_chained * 1e3:.1f} ms")
    return Measured(accum * bs * seq / min(dt_synced, dt_chained), dt_synced, dt_chained)


def try_measure(configs, scheme: str | None, device: str):
    """The first of ``configs`` (model, batch, seq, accumulation) that
    measures without running out of device memory: (Measured, that config),
    or (None, None)."""
    for cfg_name, bs, seq, accum in configs:
        tag = f"{cfg_name} bs={bs}x{accum} {scheme or 'bf16'}"
        log(f"measuring {tag} ...")
        try:
            got = measure(cfg_name, bs, seq, scheme, accum, device)
        except torch.OutOfMemoryError as e:
            log(f"{tag}: {type(e).__name__}: {str(e)[:160]}")
            got = None
        if got is None:
            release_memory()
            continue
        log(f"{tag}: {got.tokens_per_sec:,.0f} tok/s")
        return got, (cfg_name, bs, seq, accum)
    return None, None


def result_line(int8_toks: float, bf16_toks: float | None, chosen, device_name: str) -> dict:
    """JAX's JSON line (:190-209), key for key."""
    cfg_name, bs, seq, accum = chosen
    speedup = int8_toks / bf16_toks if bf16_toks else float("nan")
    return {
        "metric": f"{cfg_name}_int8_mixed_precision_train_tokens_per_sec_per_chip",
        "value": round(int8_toks, 1),
        "unit": "tok/s",
        "vs_baseline": round(speedup / REFERENCE_SPEEDUP, 4),
        "detail": {
            "bf16_tokens_per_sec": round(bf16_toks, 1) if bf16_toks else None,
            "int8_vs_bf16_speedup": round(speedup, 4),
            "batch_size": bs,
            "grad_accum": accum,
            "effective_batch": bs * accum,
            "seq_len": seq,
            "device": device_name,
        },
    }


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "bench")
    name = device_name(device)
    log(f"benchmarking on {name}")
    int8, chosen = try_measure(RUNGS, "mixed_precision", device)
    if int8 is None:
        log("FATAL: could not measure int8 mixed-precision at any config")
        raise SystemExit(1)
    bf16, _ = try_measure([chosen], None, device)
    line = result_line(int8.tokens_per_sec, bf16.tokens_per_sec if bf16 else None, chosen, name)
    cfg_name, bs, seq, accum = chosen
    log(f"RESULT {cfg_name} bs={bs}x{accum} (eff {bs * accum}): bf16={line['detail']['bf16_tokens_per_sec']} tok/s  "
        f"int8_mp={line['value']:,.1f} tok/s  speedup={line['detail']['int8_vs_bf16_speedup']:.3f}x "
        f"(reference best: {REFERENCE_SPEEDUP}x at bs16)")
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
