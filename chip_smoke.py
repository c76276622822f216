"""Drive the PyTorch port on one CUDA card, end to end.

Phases (each prints its own lines; any failed check raises, exit code != 0):

1. the card: CUDA must be available; its name and power limit;
2. the build: every kernel of ``quantized_training_tpu_torch/ops/csrc``
   compiled with nvcc (seconds printed);
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes: bit-exact, timed with CUDA events;
4. the slice: Llama2-1B at full width (random weights from a seed),
   ``mixed_precision``, ``Server(n_slots=8, max_len=2048, decode_chunk=16)``
   answering 16 requests of the mixed load (prompts 32/96/224/480, budgets
   16/32/48/64); launch counts prove the kernels ran; two streams are held
   against ``generate()``;
5. kernel path against plain path: prefill logits of a 2-layer cut on the
   card against the same model on the CPU (plain versions).

The last lines are the kernel table as JSON, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from quantized_training_tpu_torch import ops, quant
from quantized_training_tpu_torch.models import llama, llama_infer
from quantized_training_tpu_torch.models.serving import Server
from quantized_training_tpu_torch.ops import _build

SEED = 0
MIX_PROMPTS = (32, 96, 224, 480)  # benchmark_serving.py's mixed load
MIX_BUDGETS = (16, 32, 48, 64)
N_REQUESTS = 16
CFG = llama.LLAMA2_1B
DEVICE = "cuda"
D, F, KVD = CFG.hidden_size, CFG.intermediate_size, CFG.num_key_value_heads * CFG.head_dim


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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
    return {"name": "quantize_int8_rowwise", "route": "cuda",
            "source": "quantized_training_tpu_torch/ops/csrc/int8_quant.cu",
            "replaces": "quantized_training_tpu/ops/pallas_quant.py:139",
            "max_abs_err": worst, "shape": list(timed[0]), "ms": timed[1], "plain_ms": timed[2]}


def check_k2(gen: torch.Generator) -> dict:
    worst, timed = 0.0, None
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
            if (M, name) == (8, "gate/up"):  # decode: bound by the weight's bytes
                timed = ((M, N, K), ms, plain_ms)
    return {"name": "scaled_mm_rhs_t", "route": "cuda",
            "source": "quantized_training_tpu_torch/ops/csrc/scaled_mm.cu",
            "replaces": "quantized_training_tpu/ops/pallas_mm.py:192",
            "max_abs_err": worst, "shape": list(timed[0]), "ms": timed[1], "plain_ms": timed[2]}


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
    check(all(v > 0 for v in launches.values()), f"every kernel launched on the main path: {launches}")
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


def main() -> None:
    smi = card()
    build()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    entries = [check_k1(gen), check_k2(gen)]
    launches = serve(torch.Generator(device=DEVICE).manual_seed(SEED))
    for e in entries:
        e["launches"] = launches[e["name"]]
    kernel_vs_plain_path(SEED, torch.float32, 3e-2, 0.95)
    kernel_vs_plain_path(SEED, torch.bfloat16, 1e-1, 0.85)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
