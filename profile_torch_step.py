"""Where the time of the port's bench.py step, and of ViT-Giant's, goes on
one CUDA card.

bench.py's step in the PyTorch port (Llama2-1B at full width and depth,
tokens [4, 4, 2048] as 4 x 4 gradient accumulation, per-layer remat, SDPA,
``adamw_bf16_sr`` without the SR writeback, lr 1e-4, random weights and
tokens from ``--seed``), in any of these configurations: int8
``mixed_precision`` on the producer-fused layer (``fused``), int8 on the
unfused layer (``unfused``, ``quant.set_impl('off')``), bf16, and int4, fp8
tile and fp8 row ``mixed_precision`` (``int4``, ``fp8tile``, ``fp8row``: the
unfused layer, B16 / B15 / no GEMM kernel, plain-torch quantizes), and
int8 with stochastic rounding on the fused layer (``sr``: every quantize in
its SR form). For each:
three unprofiled steps (the
last one's wall time, ending in ``torch.cuda.synchronize()``), then one
step under ``torch.profiler`` with CPU and CUDA activities; the device time
of every kernel, summed by group (the port's int8, int4 and tile-scaled
GEMMs, its quantizes K1, B4 and B5 each apart, B7-B12 each apart (B9's
row and column forms apart), the folds and other producer kernels, its
RoPE and ungroup kernels, B6, cuBLAS GEMMs, attention, torch's copy
kernels, the rest: torch's elementwise and reduction kernels),
the device's busy share of the profiled step's wall time, the layout copies
(``aten::contiguous`` / ``aten::clone`` ops that ran a kernel; the copy group
also holds dtype casts), and the largest kernels by name.

``vit_int8`` and ``vit_bf16`` profile ViT-Giant's step as ``chip_smoke.py``
phase 11 runs it (``vit_train``'s step builder: batch 24 at 224 px, remat,
SDPA, the same optimizer and lr; one batch of synthetic images from seed
2024): int8 ``mixed_precision`` on the fused blocks (B18) and bf16.

``llm470m`` profiles ``llm_pretrain``'s step at its defaults as
``chip_smoke.py`` phase 15 runs it: Llama-2-470m (``mini_llamas``, through
``from_hf_json``), tokens [4, 2048], remat, ``adamw`` with weight decay
1e-2, lr 3e-4, int8 ``mixed_precision`` on the fused layer.

``serve`` profiles one decode step of the serving path as ``chip_smoke.py``
phase 4's server takes it: Llama2-1B int8 ``mixed_precision`` (random
weights from ``--seed``), eight active slots at position 256 of a 2,048-row
cache, the decode attention window of 512 rows, one token a slot
(``models/serving.py::make_decode_step``): K1 on every weight and
activation row, K2 at M 8.

Usage: python3 profile_torch_step.py [--configs fused,unfused,bf16,int4,fp8tile,fp8row,sr,vit_int8,vit_bf16,serve,
       llm470m]
       [--seed N] [--top 12]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from quantized_training_tpu_torch import optim, quant, train, vit_train
from quantized_training_tpu_torch.data import BatchLoader, SyntheticImageDataset
from quantized_training_tpu_torch.models import llama, serving, vit
from quantized_training_tpu_torch.ops import random

# quantize_params kwargs of each configuration (None: the bf16 weights)
CONFIGS = {"fused": {}, "unfused": {}, "bf16": None, "int4": {"dtype": "int4"},
           "fp8tile": {"dtype": "fp8_e4m3", "scale": "tile"}, "fp8row": {"dtype": "fp8_e4m3", "scale": "row"},
           "vit_int8": {}, "vit_bf16": None, "serve": {}, "sr": {"stochastic_rounding": True}, "llm470m": {}}
VIT_B = 24

# kernel-name fragments of each group, first match wins: sm90_gemm.cuh's
# gemm_kernel is named by its operand form and epilogue (K2 above 16 rows
# S8KMajor, B1 S8MnB, B2 S8MnMajor, B16 above 16 rows S4KMajor, B15
# TileScaledOut...), and these must match before cuBLAS's "gemm"; K2 at
# decode sizes is decode_stream; the wmma kernel is scaled_mm_s8, on packed
# int4 operands (B16's decode sizes, K % 32 != 0) with Src 1 in its template
# arguments. K1's walk is quantize_rows_walk, its first design
# quantize_rows_block / quantize_rows_warp. A key that is a tuple matches a
# name holding all of its fragments: B7's first design is row_quant over
# NormProducer, B9-row's over SiluProducer (B18's are row_quant too), B8's
# col_quant over NormProducer, mangled or not; on the walk B9-row is
# elementwise_rows over SiluMulOp, B9-col elementwise_cols over SiluMulOp
# (its first design col_quant over SiluProducer), B18's GELU
# elementwise_rows and elementwise_cols over GeluOp; B12 is silu_bwd_cols,
# its first design silu_bwd_col_quant. The folds of the CTAs'
# column maxima or dgamma sums (reduce_parts: B7, B9-row, B10, B11) stay in
# the producer group.
GROUPS = (
    ("int4 GEMM B16 on the TMA + wgmma mainloop", ("s4kmajor",)),
    ("int4 GEMM B16 on wmma (decode sizes, K % 32 != 0)", ("src)1",)),
    ("tile-scaled GEMM B15 on the TMA + wgmma mainloop", ("tilescaledout",)),
    ("tile-scaled GEMM B15 on wmma (QK % 128 != 0)", ("tile_scaled_mm",)),
    ("int8 GEMM K2 on the TMA + wgmma mainloop", ("s8kmajor",)),
    ("int8 GEMM B1 on the TMA + wgmma mainloop", ("s8mnb",)),
    ("int8 GEMM B2 on the TMA + wgmma mainloop", ("s8mnmajor",)),
    ("int8 GEMM K2 on the split-K weight stream (decode sizes)", ("decode_stream",)),
    ("int8 GEMM K2 on wmma (decode sizes off the stream)", ("scaled_mm_s8",)),
    ("B18 LayerNorm / GELU quantizes", ("layernormproducer", "geluproducer", "layernorm_rows", "layernorm_cols",
                                        "geluop")),
    ("B7 RMSNorm row quantize", ("rmsnorm_rows", ("row_quant", "::normproducer"), ("row_quant", "12normproducer"))),
    ("B11 silu-backward row quantizes", ("silu_bwd_rows", "silu_bwd_row_quant")),
    ("B9-row silu row quantize", (("elementwise_rows", "silumulop"), ("row_quant", "siluproducer"))),
    ("B8 RMSNorm column quantize", ("rmsnorm_cols", ("col_quant", "::normproducer"), ("col_quant", "12normproducer"))),
    ("B10 RMSNorm backward", ("rmsnorm_bwd_walk", "rmsnorm_bwd_rows")),
    ("B9-col silu column quantize", (("elementwise_cols", "silumulop"), ("col_quant", "siluproducer"))),
    ("B12 silu-backward column quantizes", ("silu_bwd_cols", "silu_bwd_col_quant")),
    ("producer folds and other first designs", ("row_quant", "col_quant", "producer_col_absmax", "reduce_parts")),
    ("B13 rope and head grouping", ("rope_relayout",)),
    ("B14 attention-output absmax and quantize", ("ungroup_absmax", "ungroup_quant")),
    # B5's first design, which only B5 calls off the vector path take (an
    # unaligned view, a ragged K, rows over 2048 vectors), ends in B4's
    # column cast and is counted with B4 here
    ("quantize B5 (both axes)", ("quantize_both",)),
    ("quantize K1 (rows) on the row walk", ("quantize_rows_walk",)),
    ("quantize K1 (rows), first design", ("quantize_rows",)),
    ("quantize B4 (columns)", ("quantize_cols_cluster", "col_absmax", "col_cast")),
    ("B6 AdamW", ("fused_adamw",)),
    ("attention (SDPA)", ("flash", "fmha", "sdpa", "attention", "cudnn")),
    ("copies and casts", ("copy",)),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
)


def group_of(name: str) -> str:
    low = name.lower()
    found = lambda k: k in low if isinstance(k, str) else all(f in low for f in k)
    return next((g for g, keys in GROUPS if any(map(found, keys))), "elementwise, reductions, loss, copies")


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
    key = random.key_from_generator(torch.Generator().manual_seed(args.seed))
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    models = {}

    def llama_step(qkw, model="llama"):
        """bench.py's step on Llama2-1B, or (``llm470m``) llm_pretrain's on
        Llama-2-470m: one call per step, its loss."""
        if model not in models:
            base = llama.LLAMA2_1B if model == "llama" else llama.LlamaConfig.from_hf_json("mini_llamas/Llama-2-470m")
            cfg = dataclasses.replace(base, remat=True, attention_impl="auto")
            shape = (4, 4, 2048) if model == "llama" else (4, 2048)
            tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(0, cfg.vocab_size, shape)).cuda()
            models[model] = (cfg, llama.init_params(torch.Generator(device="cuda").manual_seed(args.seed), cfg),
                             tokens, torch.roll(tokens, -1, dims=-1))
        cfg, raw, tokens, labels = models[model]
        params = raw if qkw is None else quant.quantize_params(raw, "mixed_precision", **qkw)
        o, lr = (opt, 1e-4) if model == "llama" else (optim.adamw(weight_decay=1e-2), 3e-4)
        # a CUDA graph a step (train.py's default), eager where SR in the model refuses one
        step = train.make_train_step(cfg, o, jit_compile=train.capture_refusal(params) is None)
        state = [train.init_train_state(params, o)]

        def one(i):
            state[0], m = step(state[0], tokens, labels, lr, random.fold_in(key, i))
            return m["loss"]
        return one, tokens.numel(), "tok/s"

    def vit_step(qkw):
        """ViT-Giant's step (chip_smoke.py phase 11): one call per step."""
        if "vit" not in models:
            cfg = vit_train.model_config("vit_giant", 45, 224)
            ds = SyntheticImageDataset(size=cfg.image_size, num_classes=cfg.num_classes, seed=2024)
            batch = [torch.from_numpy(a).cuda() for a in next(iter(BatchLoader(ds, VIT_B, prefetch=0)))]
            models["vit"] = (cfg, vit.init_params(torch.Generator(device="cuda").manual_seed(args.seed), cfg), batch)
        cfg, raw, (images, labels) = models["vit"]
        params = raw if qkw is None else quant.quantize_params(raw, "mixed_precision", **qkw)
        step, st = vit_train.make_train_step(cfg, opt), [params, opt.init(quant.virtual_params(params))]

        def one(i):
            st[0], st[1], loss = step(st[0], st[1], images, labels, 1e-4, random.fold_in(key, 1_000_000 + i))
            return loss
        return one, VIT_B, "images/s"

    def serve_step(qkw):
        """One decode step of 8 slots at position 256 (window 512): one call
        a step, its tokens."""
        cfg = llama.LLAMA2_1B
        params = quant.quantize_params(llama.init_params(torch.Generator(device="cuda").manual_seed(args.seed), cfg),
                                       "mixed_precision", **qkw)
        state = serving.ServeState.zeros(cfg, 8, 2048, device="cuda")
        state.active.fill_(True)
        state.pos.fill_(256)
        state.last_token.copy_(torch.arange(1, 9, device="cuda"))
        step, st = serving.make_decode_step(cfg, window=512), [state]

        def one(i):
            st[0], tok = step(params, st[0])
            return tok.sum()
        return one, 8, "tok/s"

    for name in args.configs.split(","):
        qkw = CONFIGS[name]
        quant.set_impl("off" if name == "unfused" else "auto")
        if name == "llm470m":
            one, work, unit = llama_step(qkw, "llm470m")
        else:
            make = vit_step if name.startswith("vit") else serve_step if name == "serve" else llama_step
            one, work, unit = make(qkw)
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(i).item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one(3).item()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        quant.set_impl("auto")
        events = prof.key_averages()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
                if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
        layout = {e.key: (e.device_time_total / 1e3, e.count) for e in events
                  if e.key in ("aten::contiguous", "aten::clone") and e.device_time_total > 0}
        total = sum(ms for _, ms, _ in rows)
        by_group = {}
        for k, ms, n in rows:
            g = by_group.setdefault(group_of(k), [0.0, 0])
            g[0] += ms
            g[1] += n
        print(f"== {name}: unprofiled step {wall * 1e3:.1f} ms ({work / wall:.1f} {unit}); profiled step "
              f"{prof_wall * 1e3:.1f} ms, kernels {total:.1f} ms, device busy {total / (prof_wall * 1e3):.1%}")
        for g, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
            print(f"   {g}: {ms:.1f} ms ({ms / total:.1%}), {n} launches")
        print(f"   layout copies (aten::contiguous / aten::clone running a kernel; ms, calls): {layout or 'none'}")
        for k, ms, n in sorted(rows, key=lambda r: -r[1])[:args.top]:
            print(f"     {ms:9.2f} ms {n:6d} x  {k[:110]}")
        del one


if __name__ == "__main__":
    main()
