"""Drive the PyTorch port on one CUDA card, end to end.

Phases (each prints its own lines; any failed check raises, exit code != 0):

1. the card: CUDA must be available; its name and power limit;
2. the build: every kernel of ``quantized_training_tpu_torch/ops/csrc``
   compiled with nvcc, one process per source (seconds printed);
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving path (K1, K2) and of the training step (K1 and B4 on
   every activation and weight, B5, B1, B2, and K2 at 8192 tokens, each
   GEMM beside ``torch._int_mm``, the nearest library call: the int32
   product without the scale epilogue), the stochastic-rounding forms of
   K1, B4 and B5 with the same key, B6 (the fused AdamW update, SR
   writeback off and on) at every parameter shape of Llama2-1B, all
   bit-exact; and the producer-fused kernels at the fused layer's shapes
   (norm [8192, 2048], silu [8192, 5632], and [256, 2048] / [256, 5632]):
   B7 with and without the column absmax, B8 given the forward's scales
   and in two passes, B9's row and column forms (bit-exact), B10, and the
   SR forms of B7-B9; timed with CUDA events, with GB/s and the share of
   the roofline;
4. the serving slice: Llama2-1B at full width (random weights from a seed),
   ``mixed_precision``, ``Server(n_slots=8, max_len=2048, decode_chunk=16)``
   answering 16 requests of the mixed load (prompts 32/96/224/480, budgets
   16/32/48/64); launch counts prove the kernels ran; two streams are held
   against ``generate()``;
5. kernel path against plain path: prefill logits of a 2-layer cut on the
   card against the same model on the CPU (plain versions);
6. the training slice: three int8 ``mixed_precision`` train steps of
   Llama2-1B at full width and depth (batch 4 x seq 2048, per-layer remat,
   SDPA attention, AdamW, the producer-fused layer) on one token batch from
   ``--seed``; the losses fall, every step launches each kernel the number
   of times the code implies, and the same steps in bf16 start from the
   same loss;
7. kernel path against plain path: the loss and every gradient of a
   2-layer cut at full width, fp32 and bf16, and fp32 with stochastic
   rounding from one key, on the card against the CPU: the unfused layer
   on both, then the fused layer (``set_impl('auto')`` on the card, the
   plain versions under ``set_impl('interpret')`` on the CPU);
8. ``bench.py``'s step: Llama2-1B, tokens [4, 4, 2048] (4 x 4 gradient
   accumulation), remat, ``adamw_bf16_sr`` without the SR writeback, lr
   1e-4; three steps int8 ``mixed_precision`` on the fused layer, three on
   the unfused layer (``set_impl('off')``), then three bf16: tokens/s, the
   ratios, peak memory, exact launch counts (B6 once per parameter leaf);
9. the SR configuration (``llm_pretrain.py`` with ``stochastic_rounding``
   and ``--optim adamw_bf16_sr``): three steps at batch 4 x 2048 in which
   only the SR forms of K1, B4, B5, B6 and B7-B9 launch, and B10.

Each step's key is ``fold_in(key, i)`` of one key drawn from a generator
seeded with ``--seed``. The last lines are the kernel table as JSON (each
kernel's launches on its path, its error against the plain version, its
time, the plain version's, the least time the H100 could take for the same
work, what bounds that time, and the library call's time where one
exists), the nvidia-smi line, and ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from functools import partial

import numpy as np
import torch

from quantized_training_tpu_torch import ops, optim, quant, train
from quantized_training_tpu_torch.models import llama, llama_infer
from quantized_training_tpu_torch.models.serving import Server
from quantized_training_tpu_torch.ops import _build, random
from quantized_training_tpu_torch.utils.tree import tree_leaves

SEED = 0
MIX_PROMPTS = (32, 96, 224, 480)  # benchmark_serving.py's mixed load
MIX_BUDGETS = (16, 32, 48, 64)
N_REQUESTS = 16
CFG = llama.LLAMA2_1B
DEVICE = "cuda"
D, F, KVD = CFG.hidden_size, CFG.intermediate_size, CFG.num_key_value_heads * CFG.head_dim
SERVING_KERNELS = ("quantize_int8_rowwise", "scaled_mm_rhs_t")  # K1, K2
TRAIN_B, TRAIN_S = 4, 2048  # llm_pretrain.py's defaults
TOKENS = TRAIN_B * TRAIN_S
BENCH_ACCUM = 4  # bench.py: effective batch 16 as 4 x 4 accumulation
# (name, out, in) of every quantized linear of a layer; q/o, gate/up share a shape
LINEARS = (("q/o", D, D), ("k/v", KVD, D), ("gate/up", F, D), ("down", D, F))
WEIGHTS = [(o, i) for _, o, i in LINEARS]
# every parameter shape of Llama2-1B (embedding and lm_head, the stacked
# layers' q/o, k/v, gate/up, down and norms, the final norm)
PARAM_SHAPES = [(CFG.vocab_size, D), (CFG.num_hidden_layers, D, D), (CFG.num_hidden_layers, KVD, D),
                (CFG.num_hidden_layers, F, D), (CFG.num_hidden_layers, D, F), (CFG.num_hidden_layers, D), (D,)]
# the fused layer's producer inputs: the RMSNorm sites [tokens, hidden] and
# the silu site [tokens, FFN], with one small shape each
NORM_SHAPES = [(TOKENS, D), (256, D)]
SILU_SHAPES = [(TOKENS, F), (256, F)]
# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms the H100 could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``int8_ops`` int8 operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, inputs, iters: int = 32) -> float:
    """Device time of one ``fn(*inputs[i])`` call: ``iters`` calls cycling
    over ``inputs`` are captured in one CUDA graph, so host launch overhead
    is left out; replayed after a warm-up and timed with CUDA events.
    ``inputs`` holds enough copies that large operands come from device
    memory rather than the 50 MB L2, as weights do on the serving path."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def copies(*tensors) -> list:
    """Up to 16 copies of the operands, about 64 MB in all (see time_ms)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = min(16, max(1, -(-(64 << 20) // nbytes)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    return smi


def build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(p.name for p in _build.sources())}", flush=True)
    log = _build.BUILD_DIR / "build.log"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Used" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")


def check_k1(gen: torch.Generator) -> dict:
    shapes = {
        "decode act": [(8, D), (8, F)],
        "prefill act": [(16, D), (512, D), (512, F)],
        "train act": [(TOKENS, D), (TOKENS, F)],
        "weight": [(D, D), (KVD, D), (F, D), (D, F)],
        "kv rows": [(8 * 1 * 4, CFG.head_dim), (1 * 512 * 4, CFG.head_dim)],
    }
    worst, timed = 0.0, None
    for kind, group in shapes.items():
        for shape in group:
            x = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
            x[0] = 0  # an inactive slot's all-zero row
            q, s = ops.quantize_int8_rowwise(x)
            q_ref, s_ref = ops.quantize_int8_plain(x)
            torch.cuda.synchronize()
            err = max((q.int() - q_ref.int()).abs().max().item(), (s.float() - s_ref.float()).abs().max().item())
            check(torch.equal(q, q_ref) and torch.equal(s, s_ref), f"K1 bit-exact at {kind} {shape}")
            worst = max(worst, err)
            inputs = copies(x)
            ms = time_ms(ops.quantize_int8_rowwise, inputs)
            plain_ms = time_ms(ops.quantize_int8_plain, inputs)
            print(f"[3] K1 quantize_int8_rowwise {kind} {list(shape)} bf16: bit-exact; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if shape == (F, D):  # the largest per-matmul byte mover of a decode step
                timed = (shape, ms, plain_ms)
    M, K = timed[0]
    return _entry("quantize_int8_rowwise", "quantized_training_tpu/ops/pallas_quant.py:139", worst, timed,
                  3 * M * K + 2 * M)  # x read, q and the bf16 scales written


def check_k2(gen: torch.Generator) -> float:
    """K2 at the serving shapes; returns the worst error (K2's entry is
    taken at the training step's shape, beside ``torch._int_mm``)."""
    worst = 0.0
    for M in (8, 512):
        for name, N, K in (("q/o", D, D), ("k/v", KVD, D), ("gate/up", F, D), ("down", D, F)):
            a, sa = ops.quantize_int8_plain(torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16))
            b, sb = ops.quantize_int8_plain(
                (torch.randn(N, K, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16))
            sb = sb.reshape(1, N)
            out = ops.scaled_mm_rhs_t(a, b, sa, sb)
            ref = ops.scaled_mm_rhs_t_plain(a, b, sa, sb)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(torch.equal(out, ref), f"K2 bit-exact at M={M} {name} N={N} K={K}")
            worst = max(worst, err)
            inputs = copies(a, b, sa, sb)
            ms = time_ms(ops.scaled_mm_rhs_t, inputs)
            plain_ms = time_ms(ops.scaled_mm_rhs_t_plain, inputs)
            tops = 2 * M * N * K / ms / 1e9
            gbs = (M * K + N * K + 2 * M * N) / ms / 1e6
            print(f"[3] K2 scaled_mm_rhs_t M={M} {name} N={N} K={K} -> bf16: bit-exact; kernel {ms:.4f} ms "
                  f"({tops:.1f} TOP/s, {gbs:.0f} GB/s), plain (float64 matmul) {plain_ms:.4f} ms")
    return worst


def _entry(name, replaces, worst, timed, nbytes, int8_ops=0.0, library_ms=None):
    """One kernel's line of the JSON table; ``launches`` is filled in from
    the run of its path."""
    src = ("int8_quant.cu" if name.startswith("quantize") else
           "fused_adamw.cu" if name.startswith("fused_adamw") else
           "fused_producers.cu" if name.startswith(("rmsnorm", "silu")) else "scaled_mm.cu")
    bound_ms, bound_by = bound(nbytes, int8_ops)
    return {"name": name, "route": "cuda", "source": f"quantized_training_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": worst, "shape": list(timed[0]), "ms": timed[1],
            "plain_ms": timed[2], "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _max_err(got, ref) -> float:
    return max((a.double() - b.double()).abs().max().item() for a, b in zip(got, ref))


def check_training_quantizes(gen: torch.Generator) -> list:
    """B4 at the backward's column quantizes (x2d [8192, in] and every
    weight), B5 at its output gradients g [8192, out]: bit-exact, timed
    (device time; GB/s of the bytes the algorithm needs: two reads of x and
    one int8 write for B4, two reads and two int8 writes for B5)."""
    out = []
    for name, kernel, plain, shapes, reads, writes, replaces, timed_shape in (
        ("quantize_int8_colwise", ops.quantize_int8_colwise, lambda x: ops.quantize_int8_plain(x, axis=0),
         [(TOKENS, D), (TOKENS, F), (D, D), (KVD, D), (F, D), (D, F)], 2, 1,
         "quantized_training_tpu/ops/pallas_quant.py:229", (TOKENS, F)),
        ("quantize_int8_both", ops.quantize_int8_both, ops.quantize_int8_both_plain,
         [(TOKENS, D), (TOKENS, KVD), (TOKENS, F)], 2, 2,
         "quantized_training_tpu/ops/pallas_quant.py:306", (TOKENS, F)),
    ):
        worst, timed = 0.0, None
        for shape in shapes:
            x = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
            x[0] = 0  # an all-zero row and column
            x[:, 1] = 0
            got, ref = kernel(x), plain(x)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{name} bit-exact at {list(shape)}")
            worst = max(worst, _max_err(got, ref))
            inputs = copies(x)
            ms, plain_ms = time_ms(kernel, inputs), time_ms(plain, inputs)
            gbs = x.numel() * (2 * reads + writes) / ms / 1e6
            print(f"[3] {name} {list(shape)} bf16: bit-exact; kernel {ms:.4f} ms ({gbs:.0f} GB/s), "
                  f"plain {plain_ms:.4f} ms")
            if shape == timed_shape:
                timed = (shape, ms, plain_ms)
        M, K = timed[0]
        # x read once, the int8 outputs and the bf16 scales written once
        out.append(_entry(name, replaces, worst, timed, M * K * (2 + writes) + 2 * (K if writes == 1 else M + K)))
    return out


# torch._int_mm on each form's operands as stored: the int32 product, the
# nearest library call (it has no scale epilogue)
INT_MM = {"scaled_mm_rhs_t": lambda a, b, *_: torch._int_mm(a, b.t()),
          "scaled_mm": lambda a, b, *_: torch._int_mm(a, b),
          "scaled_mm_lhs_t": lambda a, b, *_: torch._int_mm(a.t(), b)}


def int_mm_ms(name: str, inputs) -> float | None:
    """``torch._int_mm``'s time on the same operands, or None where it
    refuses them (its layout and shape conditions)."""
    try:
        return time_ms(INT_MM[name], inputs, iters=8)
    except RuntimeError as e:
        print(f"[3] torch._int_mm refuses the operands of {name}: {str(e).splitlines()[0]}")
        return None


def check_training_gemms(gen: torch.Generator, k2_worst: float) -> list:
    """The three GEMM forms at 8192 tokens for every (out, in) of the
    model: K2 (forward x . w^T), B1 (grad_input g . w, K = out) and B2
    (grad_weight g^T . x, K = 8192), each on its operands as the backward
    quantizes them; bit-exact, timed beside ``torch._int_mm``, with TOP/s
    and GB/s. Entries at gate/up; K2's error also covers the serving
    shapes (``k2_worst``)."""
    entries = []
    worst = {"scaled_mm_rhs_t": k2_worst, "scaled_mm": 0.0, "scaled_mm_lhs_t": 0.0}
    for lname, o, i in LINEARS:
        x = torch.randn(TOKENS, i, generator=gen, device=DEVICE).to(torch.bfloat16)
        w = (torch.randn(o, i, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        g = (torch.randn(TOKENS, o, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        x_row, x_row_s = ops.quantize_int8_plain(x)
        w_row, w_row_s = ops.quantize_int8_plain(w)
        x_col, x_col_s = ops.quantize_int8_plain(x, axis=0)
        w_col, w_col_s = ops.quantize_int8_plain(w, axis=0)
        g_row, g_row_s, g_col, g_col_s = ops.quantize_int8_both_plain(g)
        for name, kernel, plain, args, (M, N, K), replaces in (
            ("scaled_mm_rhs_t", ops.scaled_mm_rhs_t, ops.scaled_mm_rhs_t_plain,
             (x_row, w_row, x_row_s, w_row_s.reshape(1, o)), (TOKENS, o, i),
             "quantized_training_tpu/ops/pallas_mm.py:192"),
            ("scaled_mm", ops.scaled_mm, ops.scaled_mm_plain, (g_row, w_col, g_row_s, w_col_s), (TOKENS, i, o),
             "quantized_training_tpu/ops/pallas_mm.py:85"),
            ("scaled_mm_lhs_t", ops.scaled_mm_lhs_t, ops.scaled_mm_lhs_t_plain,
             (g_col, x_col, g_col_s, x_col_s), (o, i, TOKENS), "quantized_training_tpu/ops/pallas_mm.py:192"),
        ):
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"{name} bit-exact at {lname} M={M} N={N} K={K}")
            worst[name] = max(worst[name], _max_err([got], [ref]))
            inputs = copies(*args)
            ms, plain_ms = time_ms(kernel, inputs, iters=8), time_ms(plain, inputs, iters=8)
            lib_ms = int_mm_ms(name, inputs)
            tops = 2 * M * N * K / ms / 1e9
            nbytes = M * K + N * K + 2 * M * N + 2 * (M + N)  # int8 operands and bf16 scales in, bf16 out
            print(f"[3] {name} {lname} M={M} N={N} K={K} -> bf16: bit-exact; kernel {ms:.4f} ms "
                  f"({tops:.1f} TOP/s, {nbytes / ms / 1e6:.0f} GB/s), plain (float64 matmul) {plain_ms:.4f} ms, "
                  f"torch._int_mm (int32 out) {'refused' if lib_ms is None else f'{lib_ms:.4f} ms'}")
            if lname == "gate/up":
                entries.append(_entry(name, replaces, worst[name], ((M, N, K), ms, plain_ms), nbytes,
                                      2 * M * N * K, lib_ms))
    for e in entries:  # every shape's error, not only gate/up's
        e["max_abs_err"] = worst[e["name"]]
    return entries


def check_sr_quantizes(gen: torch.Generator, key: int) -> list:
    """The SR forms of K1, B4 and B5 at the training step's shapes (K1 and
    B4 on the activations and every weight, B5 on the output gradients)
    against their plain versions with the same key: bit-exact, since both
    draw the same Philox words and compute the same floor(x / scale + u).
    Each is timed beside its round-to-nearest form, with GB/s of the bytes
    the algorithm needs (K1: one read of x and one int8 write; B4: two
    reads and one write; B5: two reads and two writes)."""
    out = []
    for name, kernel, plain, shapes, reads, writes, replaces in (
        ("quantize_int8_rowwise_sr", ops.quantize_int8_rowwise, ops.quantize_int8_plain,
         [(TOKENS, D), (TOKENS, F), *WEIGHTS], 1, 1, "quantized_training_tpu/ops/pallas_quant.py:98"),
        ("quantize_int8_colwise_sr", ops.quantize_int8_colwise, partial(ops.quantize_int8_plain, axis=0),
         [(TOKENS, D), (TOKENS, F), *WEIGHTS], 2, 1, "quantized_training_tpu/ops/pallas_quant.py:220"),
        ("quantize_int8_both_sr", ops.quantize_int8_both, ops.quantize_int8_both_plain,
         [(TOKENS, D), (TOKENS, KVD), (TOKENS, F)], 2, 2, "quantized_training_tpu/ops/pallas_quant.py:276"),
    ):
        sr_kernel, sr_plain = partial(kernel, sr=True, key=key), partial(plain, sr=True, key=key)
        worst, timed = 0.0, None
        for shape in shapes:
            x = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
            x[0] = 0  # an all-zero row and column
            x[:, 1] = 0
            got, ref = sr_kernel(x), sr_plain(x)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{name} bit-exact at {list(shape)}")
            check(not torch.equal(got[0], kernel(x)[0]), f"{name} at {list(shape)} differs from round-to-nearest")
            worst = max(worst, _max_err(got, ref))
            inputs = copies(x)
            ms, rn_ms, plain_ms = time_ms(sr_kernel, inputs), time_ms(kernel, inputs), time_ms(sr_plain, inputs)
            mb = x.numel() * (2 * reads + writes) / 1e6
            print(f"[3] {name} {list(shape)} bf16: bit-exact; SR kernel {ms:.4f} ms ({mb / ms:.0f} GB/s), "
                  f"round-to-nearest kernel {rn_ms:.4f} ms ({mb / rn_ms:.0f} GB/s), plain SR {plain_ms:.4f} ms")
            if shape == (TOKENS, F):
                timed = (shape, ms, plain_ms)
        M, K = timed[0]
        out.append(_entry(name, replaces, worst, timed, M * K * (2 + writes) + 2 * (K if writes == 1 else M + K)))
    return out


def check_fused_adamw(gen: torch.Generator, key: int) -> list:
    """B6 at every parameter shape of Llama2-1B, bf16 parameters, SR
    writeback off and on, against its plain version (eager torch ops on
    the card) with the same key: bit-exact in the new parameter and both
    moments; timed, with GB/s of the 14 bytes per parameter it must move
    (p, g, m, v read, p, m, v written, all bf16)."""
    t = 3  # the step's bias corrections, as adamw_bf16_sr forms them
    scalars = torch.tensor([1e-4, 0.9, 0.999, 1e-2, 1e-8, 1 - 0.9**t, 1 - 0.999**t], device=DEVICE)
    worst, timed = {False: 0.0, True: 0.0}, {}
    for shape in PARAM_SHAPES:
        p = (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        g = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
        ea = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        eas = (torch.rand(shape, generator=gen, device=DEVICE) * 1e-7).to(torch.bfloat16)
        for sr in (False, True):
            kernel = partial(ops.fused_adamw_update, scalars=scalars, key=key, bf16_sr=sr)
            plain = partial(ops.fused_adamw_plain, scalars=scalars, key=key, bf16_sr=sr)
            got, ref = kernel(p, g, ea, eas), plain(p, g, ea, eas)
            torch.cuda.synchronize()
            form = "SR writeback" if sr else "round-to-nearest"
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"B6 {form} bit-exact at {list(shape)}")
            worst[sr] = max(worst[sr], _max_err(got, ref))
            inputs = copies(p, g, ea, eas)
            ms, plain_ms = time_ms(kernel, inputs, iters=8), time_ms(plain, inputs, iters=8)
            print(f"[3] fused_adamw_update {list(shape)} bf16, {form}: bit-exact; kernel {ms:.4f} ms "
                  f"({14 * p.numel() / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms")
            if shape == (CFG.num_hidden_layers, F, D):
                timed[sr] = (shape, ms, plain_ms)
    replaces = "quantized_training_tpu/ops/pallas_optim.py:79"
    n = np.prod(timed[False][0])
    return [_entry("fused_adamw_update", replaces, worst[False], timed[False], 14 * n),
            _entry("fused_adamw_update_sr", replaces, worst[True], timed[True], 14 * n)]


def _int8_off(got, ref) -> tuple[int, float]:
    """Largest int8 difference and the share of elements that differ."""
    d = (got.int() - ref.int()).abs()
    return d.max().item(), (d > 0).float().mean().item()


def _rel_err(got, ref) -> float:
    """Largest elementwise relative difference (0 where both are 0)."""
    return ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max().item()


def _bf16_ulps(a, b):
    def order(t):
        bits = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def _hold(kind: str, got, ref) -> str:
    """Hold a producer kernel's outputs to its plain version's, by the
    bars of its kind: 'exact' (B9), 'int8' (B7, B8: int8 within one step on
    at most 1e-3 of the elements, scales and column maxima within 1e-6
    relative) or 'bwd' (B10: dx within 2 bf16 ulps where |dx| is above
    2**-20 of max|dx|, dgamma within 1e-5 of max|dgamma|). Returns what
    was measured."""
    if kind == "exact":
        check(all(torch.equal(a, b) for a, b in zip(got, ref)), "bit-exact")
        return "bit-exact"
    if kind == "int8":
        off, share = _int8_off(got[0], ref[0])
        rel = max(_rel_err(a.reshape(-1), b.reshape(-1)) for a, b in zip(got[1:], ref[1:]))
        check(off <= 1 and share <= 1e-3 and rel <= 1e-6, f"int8 off by {off} on {share}, scales {rel}")
        return f"int8 off by one on a share {share:.2e} (max {off}), scales/maxima relative {rel:.2e}"
    (dx, dg), (dx_ref, dg_ref) = got, ref
    ulps = _bf16_ulps(dx, dx_ref)
    far = (ulps > 2) & ((dx - dx_ref).abs() > 2**-20 * dx_ref.abs().max())
    dg_rel = ((dg - dg_ref).abs().max() / dg_ref.abs().max()).item()
    check(not far.any() and dg_rel <= 1e-5, f"B10 dx {far.sum().item()} far, dgamma {dg_rel}")
    return f"dx max {ulps.max().item()} bf16 ulps ({(ulps > 2).sum().item()} beyond 2, all tiny), dgamma {dg_rel:.2e} of max"


def check_fused_producers(gen: torch.Generator, key: int) -> list:
    """B7-B10 and the SR forms of B7-B9 at the fused layer's shapes (x
    [8192, 2048] at the norm sites, gate and up [8192, 5632] at the silu
    site, and 256 rows of each) against their plain versions on the card;
    the forms the path runs (B7 and B9-row with the column absmax, B8 and
    B9-col given the forward's scales) are timed and make the entries, the
    other forms (without the absmax, two-pass) are held too. GB/s and the
    share of the roofline count each input read once and each output
    written once (bf16 inputs, fp32 scales and maxima)."""
    rows = {}  # entry name -> (replaces, worst error, timed, bytes)

    def run(name, form, kind, kernel, plain, args, nbytes, replaces=None, sr_of=None):
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        held = _hold(kind, got, ref)
        if sr_of is not None:
            check(not torch.equal(got[0], sr_of[0]), f"{name} differs from round-to-nearest")
        shape = tuple(args[0].shape)
        line = f"[3] {name} {list(shape)} bf16{form}: {held}"
        if replaces is not None:
            inputs = copies(*args)
            ms, plain_ms = time_ms(kernel, inputs), time_ms(plain, inputs)
            b_ms = bound(nbytes)[0]
            line += (f"; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, {b_ms / ms:.2f} of the {b_ms:.4f} ms "
                     f"bound), plain {plain_ms:.4f} ms")
            err = max(rows.get(name, (None, 0.0))[1], _max_err(got, ref))
            if shape[0] == TOKENS or name not in rows:
                rows[name] = (replaces, err, (shape, ms, plain_ms), nbytes)
            else:
                rows[name] = (*rows[name][:1], err, *rows[name][2:])
        print(line)
        return got

    pf_ = "quantized_training_tpu/ops/pallas_fused.py"
    for M, K in NORM_SHAPES:
        x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        x[0] = 0  # an all-zero row
        g = (1 + 0.1 * torch.randn(K, generator=gen, device=DEVICE)).to(torch.bfloat16)
        dy = (torch.randn(M, K, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
        row_bytes = 3 * M * K + 2 * K + 4 * M + 4 * K  # x, g in; q, scale, column absmax out
        col_bytes = 3 * M * K + 2 * K + 4 * K  # x, g, scale in; q out
        rn = {}
        for sr in (False, True):
            tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
            k_row = partial(ops.rmsnorm_quant_rowwise, with_col_amax=True, **kw)
            p_row = partial(ops.rmsnorm_quant_rowwise_plain, with_col_amax=True, **kw)
            out = run(f"rmsnorm_quant_rowwise{tag}", ", column absmax", "int8", k_row, p_row, (x, g), row_bytes,
                      f"{pf_}:154", rn.get("row"))
            scale = out[2] * (1.0 / 127.0)
            k_col = lambda x, g, scale, kw=kw: ops.rmsnorm_quant_colwise(x, g, scale=scale, **kw)
            p_col = lambda x, g, scale, kw=kw: ops.rmsnorm_quant_colwise_plain(x, g, scale=scale, **kw)
            col = run(f"rmsnorm_quant_colwise{tag}", ", given scales", "int8", k_col, p_col, (x, g, scale), col_bytes,
                      f"{pf_}:246", rn.get("col"))
            rn.update(row=out, col=col)
            if not sr:
                run("rmsnorm_quant_rowwise", "", "int8", ops.rmsnorm_quant_rowwise,
                    ops.rmsnorm_quant_rowwise_plain, (x, g), 0)
                two = run("rmsnorm_quant_colwise", ", two passes", "int8", ops.rmsnorm_quant_colwise,
                          ops.rmsnorm_quant_colwise_plain, (x, g), 0)
                check(torch.equal(two[0], col[0]), "B8 given the forward's scales equals B8 in two passes")
        run("rmsnorm_bwd", "", "bwd", ops.rmsnorm_bwd, ops.rmsnorm_bwd_plain, (x, g, dy),
            6 * M * K + 2 * K + 4 * K, f"{pf_}:491")
    for M, K in SILU_SHAPES:
        a = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        b = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        a[:, 1] = 0  # an all-zero column
        row_bytes = 5 * M * K + 4 * M + 4 * K
        col_bytes = 5 * M * K + 4 * K
        rn = {}
        for sr in (False, True):
            tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
            out = run(f"silu_mul_quant_rowwise{tag}", ", column absmax", "exact",
                      partial(ops.silu_mul_quant_rowwise, with_col_amax=True, **kw),
                      partial(ops.silu_mul_quant_rowwise_plain, with_col_amax=True, **kw), (a, b), row_bytes,
                      f"{pf_}:325", rn.get("row"))
            scale = out[2] * (1.0 / 127.0)
            col = run(f"silu_mul_quant_colwise{tag}", ", given scales", "exact",
                      lambda a, b, scale, kw=kw: ops.silu_mul_quant_colwise(a, b, scale=scale, **kw),
                      lambda a, b, scale, kw=kw: ops.silu_mul_quant_colwise_plain(a, b, scale=scale, **kw),
                      (a, b, scale), col_bytes, f"{pf_}:409", rn.get("col"))
            rn.update(row=out, col=col)
            if not sr:
                run("silu_mul_quant_rowwise", "", "exact", ops.silu_mul_quant_rowwise,
                    ops.silu_mul_quant_rowwise_plain, (a, b), 0)
                two = run("silu_mul_quant_colwise", ", two passes", "exact", ops.silu_mul_quant_colwise,
                          ops.silu_mul_quant_colwise_plain, (a, b), 0)
                check(torch.equal(two[0], col[0]), "B9-col given the forward's scales equals B9-col in two passes")
    return [_entry(name, replaces, err, timed, nbytes) for name, (replaces, err, timed, nbytes) in rows.items()]


def mixed_requests(vocab: int):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(1, vocab, size=MIX_PROMPTS[i % 4]).tolist(), MIX_BUDGETS[i % 4])
            for i in range(N_REQUESTS)]


def same_stream(params, cfg, prompt, got, ref) -> str:
    """Equal greedy streams, or a first difference at a near-tie: the
    reference's teacher-forced top-2 logit margin below 1e-2 of max|logit|
    (bf16 sums in another batch shape may decide such a tie either way)."""
    j = next((i for i, (x, y) in enumerate(zip(got, ref)) if x != y), None)
    check(len(got) == len(ref), "stream lengths")
    if j is None:
        return "equal"
    seq = torch.tensor([prompt + ref[:j]], device=DEVICE)
    cache = llama_infer.KVCache.zeros(cfg, 1, seq.shape[1], device=DEVICE)
    last = llama_infer.forward_with_cache(params, seq, cache, 0, cfg)[0, -1].float()
    top2 = last.topk(2).values
    margin = (top2[0] - top2[1]).item() / last.abs().max().item()
    check(margin < 1e-2, f"stream parts from generate() at step {j} with top-2 margin {margin:.2e}")
    return f"equal up to step {j}, then a near-tie (top-2 margin {margin:.2e} of max|logit|)"


def serve(gen: torch.Generator) -> dict:
    params = quant.quantize_params(llama.init_params(gen, CFG), "mixed_precision")
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()  # the peak below is serving's, not init's
    reqs = mixed_requests(CFG.vocab_size)
    srv = Server(params, CFG, n_slots=8, max_len=2048, decode_chunk=16)

    def drain():
        rids = [srv.add_request(p, b) for p, b in reqs]
        n = 0
        while srv.pending():
            n += len(srv.step())
        torch.cuda.synchronize()
        return rids, n

    drain()  # warm-up: library load, cuBLAS handles, allocator pools
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids, n = drain()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for (prompt, budget), rid in zip(reqs, rids):
        out = srv.result(rid)
        check(len(out) == budget and all(0 <= t < CFG.vocab_size for t in out),
              f"request {rid}: {len(out)} tokens for a budget of {budget}")
    check(n == sum(b for _, b in reqs), "every token streamed once")
    served = {k: launches[k] for k in SERVING_KERNELS}
    check(all(v > 0 for v in served.values()), f"every kernel of the serving path launched: {served}")
    print(f"[4] Llama2-1B mixed_precision Server(n_slots=8, max_len=2048, decode_chunk=16): "
          f"{len(reqs)} requests, {n} tokens in {wall:.3f} s = {n / wall:.1f} tok/s; "
          f"weights {weights_gib:.2f} GiB, peak device memory while serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    for i in (0, 1):
        prompt, budget = reqs[i]
        ref = llama_infer.generate(params, torch.tensor([prompt], device=DEVICE), CFG, budget)
        ref = ref[0, len(prompt):].tolist()
        got = srv.result(rids[i])
        print(f"[4] request {i} (prompt {len(prompt)}, budget {budget}) vs generate(): "
              f"{same_stream(params, CFG, prompt, got, ref)}; tokens {got}")
    return launches


def kernel_vs_plain_path(seed: int, dtype: torch.dtype, max_rms: float, min_agree: float) -> None:
    """Prefill logits of a 2-layer cut of Llama2-1B (full width, weights
    from ``seed``) for one 96-token prompt: kernels on the card against the
    plain versions on the CPU. Bounds: relative RMS of the difference
    <= ``max_rms`` and argmax equal at >= ``min_agree`` of positions.

    K1 and K2 are bit-exact, so the paths differ only where the torch ops
    around them (attention, norms, the lm_head GEMM) round differently on
    the card and on the CPU. The int8 path turns any such difference into
    int8 rounding flips, so the logits differ by up to the int8 noise
    itself. Measured on the CPU, the plain path against itself with the
    embedding perturbed by one ulp of noise: relative RMS 1.1e-2, argmax
    agreement 0.98 in fp32 (TF32 off); 5.9e-2 and 0.92 in bf16. The bounds
    sit above that floor (3e-2 / 0.95 fp32, 1e-1 / 0.85 bf16); a wiring
    fault (a transposed or mis-scaled operand) gives an RMS near 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CFG, num_hidden_layers=2)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, dtype=dtype)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    p_dev = quant.quantize_params(raw, "mixed_precision")
    p_cpu = quant.quantize_params(to_cpu(raw), "mixed_precision")
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, 96)))
    logits = {}
    for dev, params in ((DEVICE, p_dev), ("cpu", p_cpu)):
        cache = llama_infer.KVCache.zeros(cfg, 1, 96, device=dev)
        logits[dev] = llama_infer.forward_with_cache(params, prompt.to(dev), cache, 0, cfg)[0].float().cpu()
    delta = logits[DEVICE] - logits["cpu"]
    rms = (delta.norm() / logits["cpu"].norm()).item()
    worst = (delta.abs().max() / logits["cpu"].abs().max()).item()
    agree = (logits[DEVICE].argmax(-1) == logits["cpu"].argmax(-1)).float().mean().item()
    print(f"[5] 2-layer Llama2-1B {str(dtype)[6:]} prefill (96 tokens), kernels on the card vs plain on the CPU: "
          f"relative RMS {rms:.3e} (bound {max_rms:g}), max|dlogit| {worst:.3e} of max|logit|; "
          f"argmax agree {agree:.3f} (bound {min_agree:g})")
    check(rms <= max_rms and agree >= min_agree, f"{dtype} kernel path within tolerance of the plain path")


def per_step_launches(L: int, micro: int = 1, sr: bool = False, b6: int = 0, b6_sr: int = 0,
                      fused: bool = True) -> dict:
    """Kernel launches of one train step of L int8 layers (L = 0 for bf16),
    from the code (pinned on the CPU by tests/test_torch_train.py and
    tests/test_torch_fused.py::test_kernel_calls_per_step_fused): a layer
    has 7 quantized weights (q, k, v, o, gate, up, down) behind 4 inputs
    (q/k/v and gate/up share one), and remat runs its forward twice.

    The fused layer (``fused``): forward K1 per weight and for o's input
    (8), K2 per weight (7), B7 at the two norm sites, B9-row at down's
    input. Backward per weight B5 (its output grad), B4 (the weight), B1
    and B2; B4 also for o's input; B8 at the two norm sites, B9-col at
    down's input, B10 at the two norms. The unfused layer: forward K1 for
    the 7 weights and the 4 inputs, K2 per weight; backward per weight B5,
    B4, B1, B2 and B4 once per input. All of that once per micro-batch,
    each quantize in its SR form with ``sr`` (B10 has none); then B6 once
    per parameter leaf (``b6``, or ``b6_sr`` with the SR writeback)."""
    t = "_sr" if sr else ""
    n = L * micro
    counts = dict.fromkeys(ops.KERNELS, 0)
    if fused:
        counts.update({f"quantize_int8_rowwise{t}": 2 * 8 * n, f"quantize_int8_colwise{t}": 8 * n,
                       f"rmsnorm_quant_rowwise{t}": 2 * 2 * n, f"silu_mul_quant_rowwise{t}": 2 * n,
                       f"rmsnorm_quant_colwise{t}": 2 * n, f"silu_mul_quant_colwise{t}": n, "rmsnorm_bwd": 2 * n})
    else:
        counts.update({f"quantize_int8_rowwise{t}": 2 * 11 * n, f"quantize_int8_colwise{t}": 11 * n})
    counts.update({f"quantize_int8_both{t}": 7 * n, "scaled_mm_rhs_t": 2 * 7 * n, "scaled_mm": 7 * n,
                   "scaled_mm_lhs_t": 7 * n, "fused_adamw_update": b6, "fused_adamw_update_sr": b6_sr})
    return counts


def run_steps(params, cfg, tokens, labels, opt, lr: float, key: int, n_steps: int, expect: dict | None):
    """n_steps of make_train_step(cfg, opt) at ``lr`` on one batch, step i
    with the key ``fold_in(key, i)``: per step the loss, wall seconds (ends
    in a synchronize) and, when ``expect`` is given, the launch counts
    checked against it."""
    step = train.make_train_step(cfg, opt)
    state = train.init_train_state(params, opt)
    losses, walls, launches = [], [], dict.fromkeys(ops.KERNELS, 0)
    for i in range(n_steps):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels, lr, random.fold_in(key, i))
        loss = m["loss"].item()  # synchronizes
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        counts = ops.launch_counts()
        if expect is not None:
            check(counts == expect, f"step {i + 1} launches {counts} == {expect}")
        launches = {k: launches[k] + v for k, v in counts.items()}
        check(np.isfinite(loss) and np.isfinite(m["grad_norm"].item()), f"step {i + 1}: finite loss and norm")
    del state
    return losses, walls, launches


def int8_vs_bf16(phase: int, what: str, raw, cfg, tokens, labels, opt, lr: float, key: int,
                 expect_int8: dict, expect_bf16: dict | None, expect_unfused: dict | None = None):
    """Three steps int8 mixed_precision on the fused layer, with
    ``expect_unfused`` three more on the unfused layer (``set_impl('off')``),
    then three bf16, from the same weights, batch and keys: the losses fall,
    the first-step losses agree within 1e-2 (int8 against bf16) and 1e-3
    (fused against unfused); prints tokens/s of steps 2-3 (step 1 warms
    up), the ratios and each run's peak memory. Returns (int8 losses, int8
    launches)."""
    def measured(params, expect, impl="auto"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        quant.set_impl(impl)
        try:
            losses, walls, launches = run_steps(params, cfg, tokens, labels, opt, lr, key, 3, expect)
        finally:
            quant.set_impl("auto")
        return losses, walls, launches, torch.cuda.max_memory_allocated() / 2**30

    qparams = quant.quantize_params(raw, "mixed_precision")
    runs = {"int8": measured(qparams, expect_int8)}
    if expect_unfused is not None:
        runs["int8 unfused"] = measured(qparams, expect_unfused, "off")
    runs["bf16"] = measured(raw, expect_bf16)
    n_tok = tokens.numel()
    tps = {k: n_tok * (len(r[1]) - 1) / sum(r[1][1:]) for k, r in runs.items()}
    print(f"[{phase}] {what}: " + "; ".join(
        f"{k} losses {r[0]}, step walls {[round(w, 4) for w in r[1]]} s" for k, r in runs.items()))
    ratios = ", ".join(f"{k}/bf16 {tps[k] / tps['bf16']:.3f}" for k in runs if k != "bf16")
    if expect_unfused is not None:
        ratios += f", int8 fused/unfused {tps['int8'] / tps['int8 unfused']:.3f}"
    print(f"[{phase}] tokens/s ({n_tok} tokens per step, steps 2-3, wall with torch.cuda.synchronize()): "
          + ", ".join(f"{k} {v:.1f}" for k, v in tps.items()) + f" ({ratios}); peak device memory "
          + ", ".join(f"{k} {r[3]:.2f} GiB" for k, r in runs.items())
          + f"; launches per int8 step { {k: v for k, v in expect_int8.items() if v} }")
    q_losses, b_losses = runs["int8"][0], runs["bf16"][0]
    check(all(r[0][2] < r[0][0] for r in runs.values()), f"losses fall: { {k: r[0] for k, r in runs.items()} }")
    rel = abs(b_losses[0] - q_losses[0]) / abs(b_losses[0])
    check(rel <= 1e-2, f"int8 first loss within 1e-2 of bf16's: {rel:.3e}")
    print(f"[{phase}] first-step loss int8 vs bf16: relative {rel:.3e} (bound 1e-2)")
    if expect_unfused is not None:
        u = runs["int8 unfused"][0][0]
        rel_u = abs(q_losses[0] - u) / abs(u)
        print(f"[{phase}] first-step loss int8 fused vs unfused: relative {rel_u:.3e} (bound 1e-3)")
        check(rel_u <= 1e-3, f"fused first loss within 1e-3 of the unfused one: {rel_u:.3e}")
    return q_losses, runs["int8"][2]


def train_cfg_and_batch(seed: int, shape):
    """Llama2-1B as the training phases run it (remat, SDPA) and a token
    batch of ``shape`` from ``seed``, labels the tokens shifted by one."""
    cfg = dataclasses.replace(CFG, remat=True, attention_impl="auto")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)).to(DEVICE)
    return cfg, tokens, torch.roll(tokens, -1, dims=-1)


def train_slice(raw, seed: int, key: int):
    """Phase 6: llm_pretrain.py's defaults (batch 4 x 2048, remat, adamw
    with weight decay 1e-2, lr 3e-4), Llama2-1B at full width and depth,
    int8 mixed_precision on the fused layer, then the same steps in bf16
    from the same weights and batch. Returns the int8 losses and launches."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    what = (f"Llama2-1B train step (B={TRAIN_B} x S={TRAIN_S}, remat, SDPA, adamw lr 3e-4), seed {seed}")
    return int8_vs_bf16(6, what, raw, cfg, tokens, labels, optim.adamw(weight_decay=1e-2), 3e-4, key,
                        per_step_launches(cfg.num_hidden_layers), per_step_launches(0))


def bench_step(raw, seed: int, key: int) -> dict:
    """Phase 8: bench.py's step (``build_step("llama2-1b", 4, 2048, scheme,
    accum=4)``): tokens [4, 4, 2048], remat, adamw_bf16_sr without the SR
    writeback, lr 1e-4, int8 mixed_precision without SR on the fused layer,
    on the unfused layer, then bf16. Each int8 step launches 4 x the
    per-micro-batch counts of its layer, and each step of all three B6
    (round-to-nearest) once per parameter leaf. Returns the fused int8
    launches."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (BENCH_ACCUM, TRAIN_B, TRAIN_S))
    n_leaves = len(tree_leaves(raw))
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    what = (f"bench.py's step (Llama2-1B, tokens [{BENCH_ACCUM}, {TRAIN_B}, {TRAIN_S}], remat, SDPA, "
            f"adamw_bf16_sr without SR, lr 1e-4, {n_leaves} parameter leaves), seed {seed}")
    L = cfg.num_hidden_layers
    _, launches = int8_vs_bf16(8, what, raw, cfg, tokens, labels, opt, 1e-4, key,
                               per_step_launches(L, micro=BENCH_ACCUM, b6=n_leaves),
                               per_step_launches(0, b6=n_leaves),
                               per_step_launches(L, micro=BENCH_ACCUM, b6=n_leaves, fused=False))
    return launches


def sr_config(raw, seed: int, key: int, rn_first_loss: float) -> dict:
    """Phase 9: llm_pretrain.py with stochastic_rounding and ``--optim
    adamw_bf16_sr`` (SR writeback on, weight decay 1e-2, lr 3e-4) at batch
    4 x 2048, remat, the fused layer: only the SR forms of K1, B4, B5, B6
    and B7-B9 launch (and B10, which has none), each as often as phase 6's
    forms per step; the losses fall and the first is
    within 1e-2 of phase 6's round-to-nearest int8 first loss (same weights
    and batch). Returns the launches."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    n_leaves = len(tree_leaves(raw))
    params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
    opt = optim.get_optimizer("adamw_bf16_sr", weight_decay=1e-2)
    expect = per_step_launches(cfg.num_hidden_layers, sr=True, b6_sr=n_leaves)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, launches = run_steps(params, cfg, tokens, labels, opt, 3e-4, key, 3, expect)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = abs(losses[0] - rn_first_loss) / abs(rn_first_loss)
    print(f"[9] SR configuration (Llama2-1B, B={TRAIN_B} x S={TRAIN_S}, remat, SDPA, int8 mixed_precision with "
          f"stochastic_rounding, adamw_bf16_sr with the SR writeback, lr 3e-4), seed {seed}: losses {losses}, "
          f"step walls {[round(w, 4) for w in walls]} s, tokens/s (steps 2-3) "
          f"{TOKENS * (len(walls) - 1) / sum(walls[1:]):.1f}; peak device memory {peak:.2f} GiB; launches per "
          f"step { {k: v for k, v in expect.items() if v} }")
    print(f"[9] first-step loss SR vs round-to-nearest int8 (phase 6): relative {rel:.3e} (bound 1e-2)")
    check(losses[2] < losses[0], f"SR loss falls: {losses}")
    check(rel <= 1e-2, f"SR first loss within 1e-2 of the round-to-nearest one: {rel:.3e}")
    return launches


def grads_vs_plain(seed: int, dtype: torch.dtype, max_rms: float, max_dloss: float, sr_key: int | None = None,
                   fused: bool = False):
    """Phase 7: the loss and every gradient leaf of a 2-layer cut of
    Llama2-1B (full width, weights from ``seed``), int8 mixed_precision,
    one micro-step on 256 tokens, the kernels on the card against the plain
    versions on the CPU; with ``sr_key``, stochastic rounding from that key
    on both devices, which draws the same noise on both. ``fused``: the
    fused layer (``set_impl('auto')`` on the card, ``'interpret'`` on the
    CPU), else the unfused one on both (``'off'``). Bounds: relative RMS of
    each leaf's difference <= ``max_rms``; relative loss difference <=
    ``max_dloss``.

    Every kernel of the unfused layer is bit-exact, and B7, B8 and B10 are
    off by fp32 sum order, so the two paths differ where the torch ops
    around them round differently, and int8 rounding flips in the forward
    and both backward matmuls carry that difference. The floor, measured on
    the CPU in two draws: the plain path against itself with the embedding
    moved by one ulp gives a worst leaf of 3.7e-2 / 4.7e-2 and a loss
    6.9e-5 / 9.4e-5 apart in fp32, 7.3e-2 / 7.4e-2 and 2.0e-5 / 1.1e-4 in
    bf16. The bounds sit above it (1.5e-1 / 2e-1 per leaf,
    1e-3 on the loss); a wiring fault (a transposed operand, a scale on the
    wrong axis) gives a relative RMS near 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CFG, num_hidden_layers=2, remat=True)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, dtype=dtype)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    res = {}
    sr = sr_key is not None
    for dev, params, impl in ((DEVICE, raw, "auto" if fused else "off"),
                              ("cpu", to_cpu(raw), "interpret" if fused else "off")):
        qparams = quant.quantize_params(params, "mixed_precision", stochastic_rounding=sr)
        quant.set_impl(impl)
        ops.reset_launch_counts()
        try:
            loss, grads = train.loss_and_grads(cfg, qparams, tok.to(dev), lab.to(dev), sr_key)
        finally:
            quant.set_impl("auto")
        res[dev] = (loss.item(), [g.double().cpu() for g in tree_leaves(grads)])
        if dev == DEVICE:  # the card ran the layer asked for
            b7 = ops.launch_counts()["rmsnorm_quant_rowwise_sr" if sr else "rmsnorm_quant_rowwise"]
            check((b7 > 0) == fused, f"B7 launched {b7} times with fused={fused}")
    rms = [((a - b).norm() / b.norm()).item() for a, b in zip(res[DEVICE][1], res["cpu"][1])]
    dloss = abs(res[DEVICE][0] - res["cpu"][0]) / abs(res["cpu"][0])
    print(f"[7] 2-layer Llama2-1B {str(dtype)[6:]}{' SR' if sr else ''} {'fused' if fused else 'unfused'} "
          "layer grads (256 tokens), "
          "kernels on the card vs plain on the CPU: "
          f"loss {res[DEVICE][0]:.6f} vs {res['cpu'][0]:.6f} (relative {dloss:.2e}); worst leaf relative RMS "
          f"{max(rms):.3e}, per leaf {[f'{r:.1e}' for r in rms]} (bounds {max_rms:g}, loss {max_dloss:g})")
    check(max(rms) <= max_rms and dloss <= max_dloss, f"{dtype} gradients within tolerance of the plain path")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the training batches and of the steps' key (phases 6-9)")
    args = parser.parse_args()
    smi = card()
    build()
    key = random.key_from_generator(torch.Generator().manual_seed(args.seed))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    serving = [check_k1(gen)]
    training = [*check_training_quantizes(gen), *check_training_gemms(gen, check_k2(gen))]
    sr_forms = check_sr_quantizes(gen, key)
    adamw = check_fused_adamw(gen, key)
    producers = check_fused_producers(gen, key)
    launches = serve(torch.Generator(device=DEVICE).manual_seed(SEED))
    for e in serving:
        e["launches"] = launches[e["name"]]
    kernel_vs_plain_path(SEED, torch.float32, 3e-2, 0.95)
    kernel_vs_plain_path(SEED, torch.bfloat16, 1e-1, 0.85)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(SEED), CFG)
    q_losses, launches = train_slice(raw, args.seed, key)
    for e in training:
        e["launches"] = launches[e["name"]]
    for fused in (False, True):
        grads_vs_plain(SEED, torch.float32, 1.5e-1, 1e-3, fused=fused)
        grads_vs_plain(SEED, torch.bfloat16, 2e-1, 1e-3, fused=fused)
        grads_vs_plain(SEED, torch.float32, 1.5e-1, 1e-3, sr_key=random.fold_in(key, 7), fused=fused)
    launches = bench_step(raw, args.seed, key)
    for e in [adamw[0], *(e for e in producers if not e["name"].endswith("_sr"))]:
        e["launches"] = launches[e["name"]]
    launches = sr_config(raw, args.seed, key, q_losses[0])
    for e in [*sr_forms, adamw[1], *(e for e in producers if e["name"].endswith("_sr"))]:
        e["launches"] = launches[e["name"]]
    kernels = serving + training + sr_forms + adamw + producers
    check(all(e["launches"] > 0 for e in kernels), f"every kernel launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
