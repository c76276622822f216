"""Component timings of the port's train step on the card.

Counterpart of the JAX repository's ``benchmark_step_components.py``
(:70-186), with its flags: where the step's time goes, bracketed by

- the raw GEMMs at the step's shapes, (T, 2048, 2048), (T, 2048, 5632) and
  4096^3 with T = bs x seq tokens: bf16 is ``torch.matmul`` and int8
  ``torch._int_mm`` (int32 out), the library's own products as JAX's were
  XLA's dots (:48-67), not kernels of the port;
- ``quant/core.py::quantize_int8`` along rows at [T, 2048] (K1 on the card),
  its time and effective GiB/s (a bf16 read and an int8 write);
- the whole train step (remat unless ``--no_remat``; ``adamw_bf16_sr``
  without SR, lr 1e-4, tokens [bs, seq] from seed 1) per variant: ``bf16``,
  ``bf16/no-remat`` and ``int8mp`` (``mixed_precision``, the fused layer on
  the card): the median of 4 synced steps after a warm one, tok/s, and
  TFLOPS-equivalent at ``6 x parameters x T`` a step. JAX's
  ``int8mp/pallas`` and ``int8mp/xla`` are one variant here: the ops
  backends are TPU-only. A variant that runs out of device memory is
  printed as failed; any other error propagates.

Each GEMM and the quantize are one call's device time
(``utils/timing.py::time_ms``), where JAX timed differential device-side
loops. ``--cpu`` runs the plain versions with the host clock: it exists to
drive the entry point in tests, and its numbers are no device metric.

  python -m quantized_training_tpu_torch.benchmark_step_components [--model llama2-1b] [--bs 8] [--seq 2048] [--no_remat] [--only_model] [--cpu]
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
from .quant.core import quantize_int8
from .utils.timing import copies, host_ms, sync, time_ms

KEY = 2
# (tag, scheme, config overrides) (JAX :150-156, its two int8 backends one)
VARIANTS = [("bf16", None, {}), ("bf16/no-remat", None, {"remat": False}), ("int8mp", "mixed_precision", {})]


def gemm_shapes(T: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of the raw GEMMs: the step's q/o and gate/up products and
    4096^3 (JAX :104)."""
    return [(T, 2048, 2048), (T, 2048, 5632), (4096, 4096, 4096)]


def bench_matmul(M: int, K: int, N: int, dtype: torch.dtype, timer, device) -> float:
    """TFLOP/s (TOP/s for int8) of the library's [M, K] . [K, N]."""
    gen = torch.Generator(device=device).manual_seed(0)
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=device, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device=device, dtype=torch.int8)
        fn = torch._int_mm
    else:
        a = (torch.randn(M, K, generator=gen, device=device) * 0.1).to(dtype)
        b = (torch.randn(K, N, generator=gen, device=device) * 0.1).to(dtype)
        fn = torch.matmul
    return 2.0 * M * K * N / timer(fn, copies(a, b)) / 1e9


def step_flops(params, T: int) -> float:
    """JAX's dense estimate of a step's work (:133): 6 x parameters x
    tokens, no attention term."""
    return 6 * llama.num_params(params) * T


def run_variant(tag: str, scheme: str | None, over: dict, cfg, params, tokens, labels, flops: float,
                device: str) -> tuple[float, float, float]:
    """(step ms, tok/s, TFLOPS-equivalent) of one variant (JAX :160-186)."""
    vcfg = dataclasses.replace(cfg, **over)
    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = train.init_train_state(quant.quantize_params(params, scheme), optimizer)
    step = train.make_train_step(vcfg, optimizer)
    state, m = step(state, tokens, labels, LR, KEY)
    m["loss"].item()
    sync(device)
    ts = []
    for i in range(4):
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels, LR, fold_in(KEY, i))
        m["loss"].item()
        sync(device)
        ts.append(time.perf_counter() - t0)
    t_step = sorted(ts)[len(ts) // 2]
    T = tokens.numel()
    log(f"[{tag}] full step {t_step * 1e3:,.0f} ms -> {T / t_step:,.0f} tok/s, "
        f"{flops / t_step / 1e12:,.0f} TFLOPS-equiv")
    return t_step * 1e3, T / t_step, flops / t_step / 1e12


def main(argv: list[str] | None = None) -> dict:
    """Runs the three parts; returns their numbers: ``matmul`` {(shape,
    dtype): TFLOP/s}, ``quantize_int8`` (ms, GiB/s), ``variants`` {tag:
    (ms, tok/s, TFLOPS-equivalent) or None where it ran out of memory}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama2-1b", help="|".join(MODELS))
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--only_model", action="store_true", help="skip the raw matmul/quantize microbenches")
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "benchmark_step_components")
    timer = host_ms if device == "cpu" else time_ms
    log(f"device: {device_name(device)}")
    out = {"matmul": {}, "quantize_int8": None, "variants": {}}

    T = args.bs * args.seq
    if not args.only_model:
        for dtype in (torch.bfloat16, torch.int8):
            for shape in gemm_shapes(T):
                tf = bench_matmul(*shape, dtype, timer, device)
                out["matmul"][(shape, str(dtype)[6:])] = tf
                log(f"matmul {shape} {str(dtype)[6:]}: {tf:,.1f} TFLOPS")
        x = torch.randn(T, 2048, generator=torch.Generator(device=device).manual_seed(0), device=device)
        x = x.to(torch.bfloat16)
        ms = timer(lambda x_: quantize_int8(x_, axis=1), copies(x))
        out["quantize_int8"] = (ms, x.numel() * 3 / (ms * 1e-3) / 2**30)
        log(f"quantize_int8 [{T},2048]: {ms:.3f} ms/call ({out['quantize_int8'][1]:.0f} GiB/s effective)")

    cfg = dataclasses.replace(MODELS[args.model], max_position_embeddings=args.seq, remat=not args.no_remat)
    params = llama.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (args.bs, args.seq),
                           generator=torch.Generator(device=device).manual_seed(1), device=device)
    labels = torch.roll(tokens, -1, dims=-1)
    flops = step_flops(params, T)
    log(f"model {args.model}: {llama.num_params(params) / 1e9:.2f}B params, {flops / 1e12:.1f} TFLOP/step")
    for tag, scheme, over in VARIANTS:
        try:
            out["variants"][tag] = run_variant(tag, scheme, over, cfg, params, tokens, labels, flops, device)
        except torch.OutOfMemoryError as e:
            log(f"[{tag}] FAILED {type(e).__name__}: {str(e)[:160]}")
            out["variants"][tag] = None
        if out["variants"][tag] is None:
            release_memory()
    return out


if __name__ == "__main__":
    main()
