"""INT8 mixed-precision training-speed ladder of the port (the original
repository's README table).

Counterpart of the JAX repository's ``benchmark_train_ladder.py`` (:29-140),
with its flags and method: Llama2-1B at seq 2048, the whole train step
(remat, ``adamw_bf16_sr`` without SR, lr 1e-4), stepping through which
matmuls run int8 (forward only, then + grad_input, then + grad_weight; with
``--sr`` also the two stochastic-rounding rungs) against the bf16 baseline,
every rung from the same weights (seed 0) and tokens (seed 1). "INT8
forward" runs the unfused layer with a bf16 backward; from "+ INT8
grad_input" on the layer is the fused one on the card (``quant/fused.py::
_fusable_cfg``).

:func:`measure` runs one warm step, ``N_STEPS`` synced steps (their median)
and ``N_STEPS`` chained ones, every wall ending in
``torch.cuda.synchronize()``, and reports the faster. Prints one markdown row
per rung: tok/s, the speedup over bf16, and the original repository's own
figures on its RTX 4070 Ti (its README.md:123-137) for reference; none is a
number of this port, nor of a TPU.

If the bf16 rung fails the ladder aborts, as in JAX. Another rung that runs
out of device memory is printed as failed and skipped; any other error
propagates (JAX skipped every failing rung). ``--cpu`` runs the plain
versions with the host clock: it exists to drive the entry point in tests,
and its numbers are no device metric.

  python -m quantized_training_tpu_torch.benchmark_train_ladder [--bs 8] [--seq 2048] [--sr] [--accum 1] [--rungs BF16,grad_weight] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from . import optim, quant, train
from .bench import LR, device_name, log, release_memory
from .llm_pretrain import MODELS, device_of
from .models import llama
from .ops.random import fold_in
from .utils.timing import sync

N_STEPS = 6
KEY = 2
# (name, MixedPrecisionConfig's fields, or None for bf16) (JAX :97-108)
RUNGS = [
    ("BF16 baseline", None),
    ("INT8 forward", dict(output=True, grad_input=False, grad_weight=False)),
    ("+ INT8 grad_input", dict(output=True, grad_input=True, grad_weight=False)),
    ("+ INT8 grad_weight", dict(output=True, grad_input=True, grad_weight=True)),
]
SR_RUNGS = [
    ("INT8 fwd + SR", dict(output=True, grad_input=False, grad_weight=False, stochastic_rounding=True)),
    ("all INT8 + SR", dict(output=True, grad_input=True, grad_weight=True, stochastic_rounding=True)),
]
# the original repository's README table (RTX 4070 Ti, Llama2-1B at bs 16)
REFERENCE = {"BF16 baseline": "9,223 (1.00x)", "INT8 forward": "11,751 (1.27x)",
             "+ INT8 grad_input": "13,678 (1.48x)", "+ INT8 grad_weight": "15,517 (1.68x)",
             "INT8 fwd + SR": "10,944 (1.19x)", "all INT8 + SR": "OOM"}


def measure(cfg: llama.LlamaConfig, params, scheme_kwargs: dict | None, bs: int, seq: int, accum: int = 1,
            device: str = "cuda", n_steps: int | None = None) -> float:
    """Tokens/s of one rung (JAX :29-74): ``params`` under
    ``mixed_precision`` with ``scheme_kwargs`` (bf16 for None)."""
    n_steps = N_STEPS if n_steps is None else n_steps
    scheme = None if scheme_kwargs is None else "mixed_precision"
    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = train.init_train_state(quant.quantize_params(params, scheme, **(scheme_kwargs or {})), optimizer)
    # a CUDA graph a step (train.py), but for the SR rungs, whose keys are host integers a graph would repeat
    step = train.make_train_step(cfg, optimizer, jit_compile=train.capture_refusal(state.params) is None)
    shape = (accum, bs, seq) if accum > 1 else (bs, seq)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator(device=device).manual_seed(1),
                           device=device)
    labels = torch.roll(tokens, -1, dims=-1)

    state, m = step(state, tokens, labels, LR, KEY)
    m["loss"].item()
    sync(device)
    ts = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels, LR, fold_in(KEY, i))
        m["loss"].item()
        sync(device)
        ts.append(time.perf_counter() - t0)
    dt = sorted(ts)[len(ts) // 2]
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, m = step(state, tokens, labels, LR, fold_in(KEY, 100 + i))
    m["loss"].item()
    sync(device)
    return accum * bs * seq / min(dt, (time.perf_counter() - t0) / n_steps)


def main(argv: list[str] | None = None) -> list:
    """Runs the ladder; returns its rows (name, tok/s, speedup over the
    first rung measured)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama2-1b", help="|".join(MODELS))
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--sr", action="store_true", help="also measure stochastic-rounding variants")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation micro-steps (effective batch = accum x bs)")
    p.add_argument("--rungs", default=None,
                   help="comma-separated substring filter over rung names (e.g. 'BF16,grad_weight')")
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "benchmark_train_ladder")

    cfg = dataclasses.replace(MODELS[args.model], max_position_embeddings=args.seq, remat=True)
    params = llama.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    rungs = RUNGS + (SR_RUNGS if args.sr else [])
    log(f"device: {device_name(device)}, {args.model} bs={args.bs} seq={args.seq} accum={args.accum} (reference "
        f"table: the original repository's README.md:123-137 on an RTX 4070 Ti)")
    if args.rungs:
        pats = [s.strip() for s in args.rungs.split(",") if s.strip()]
        rungs = [(n, kw) for n, kw in rungs if any(s in n for s in pats)]

    results = []
    base = None
    for name, kw in rungs:
        try:
            toks = measure(cfg, params, kw, args.bs, args.seq, args.accum, device)
        except torch.OutOfMemoryError as e:
            log(f"{name}: FAILED {type(e).__name__}: {str(e)[:120]}")
            toks = None
        if toks is None:
            if kw is None:  # speedups are only meaningful against the bf16 baseline
                raise SystemExit("BF16 baseline failed; aborting ladder")
            release_memory()
            continue
        if base is None:
            base = toks
        results.append((name, toks, toks / base))
        log(f"{name}: {toks:,.0f} tok/s ({toks / base:.2f}x)")

    print("\n| Configuration | tok/s | speedup | reference (4070Ti) |")
    print("|---|---|---|---|")
    for name, toks, sp in results:
        print(f"| {name} | {toks:,.0f} | {sp:.2f}x | {REFERENCE.get(name, '-')} |", flush=True)
    return results


if __name__ == "__main__":
    main()
