"""Where the time of the port's bench.py step goes on one CUDA card.

bench.py's step in the PyTorch port (Llama2-1B at full width and depth,
tokens [4, 4, 2048] as 4 x 4 gradient accumulation, per-layer remat, SDPA,
``adamw_bf16_sr`` without the SR writeback, lr 1e-4, random weights and
tokens from ``--seed``), in up to three configurations: int8
``mixed_precision`` on the producer-fused layer, int8 on the unfused layer
(``quant.set_impl('off')``), and bf16. For each: three unprofiled steps (the
last one's wall time, ending in ``torch.cuda.synchronize()``), then one
step under ``torch.profiler`` with CPU and CUDA activities; the device time
of every kernel, summed by group (the port's int8 GEMMs, its quantize and
producer kernels, B6, cuBLAS GEMMs, attention, the rest: torch's
elementwise and reduction kernels), the device's busy share of the
profiled step's wall time, and the largest kernels by name.

Usage: python3 profile_torch_step.py [--configs fused,unfused,bf16] [--seed N] [--top 12]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from quantized_training_tpu_torch import optim, quant, train
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import random

# kernel-name fragments of each group, first match wins
GROUPS = (
    ("int8 GEMMs K2/B1/B2", ("scaled_mm_s8",)),
    ("producer kernels B7-B10", ("row_quant", "col_quant", "producer_col_absmax", "rmsnorm_bwd_rows",
                                 "reduce_parts")),
    ("quantizes K1/B4/B5", ("quantize_rows", "col_absmax", "col_cast", "quantize_both_rows")),
    ("B6 AdamW", ("fused_adamw",)),
    ("attention (SDPA)", ("flash", "fmha", "sdpa", "attention")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)), "elementwise, reductions, loss, copies")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--configs", default="fused,unfused,bf16")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = dataclasses.replace(llama.LLAMA2_1B, remat=True, attention_impl="auto")
    raw = llama.init_params(torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (4, 4, 2048))).cuda()
    labels = torch.roll(tokens, -1, dims=-1)
    key = random.key_from_generator(torch.Generator().manual_seed(args.seed))
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    for name in args.configs.split(","):
        params = raw if name == "bf16" else quant.quantize_params(raw, "mixed_precision")
        quant.set_impl("off" if name == "unfused" else "auto")
        step = train.make_train_step(cfg, opt)
        state = train.init_train_state(params, opt)
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, tokens, labels, 1e-4, random.fold_in(key, i))
            m["loss"].item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, tokens, labels, 1e-4, random.fold_in(key, 3))
            m["loss"].item()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        quant.set_impl("auto")
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(ms for _, ms, _ in rows)
        by_group = {}
        for k, ms, n in rows:
            g = by_group.setdefault(group_of(k), [0.0, 0])
            g[0] += ms
            g[1] += n
        print(f"== {name}: unprofiled step {wall * 1e3:.1f} ms ({tokens.numel() / wall:.1f} tok/s); profiled step "
              f"{prof_wall * 1e3:.1f} ms, kernels {total:.1f} ms, device busy {total / (prof_wall * 1e3):.1%}")
        for g, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
            print(f"   {g}: {ms:.1f} ms ({ms / total:.1%}), {n} launches")
        for k, ms, n in sorted(rows, key=lambda r: -r[1])[:args.top]:
            print(f"     {ms:9.2f} ms {n:6d} x  {k[:110]}")
        del state, params


if __name__ == "__main__":
    main()
