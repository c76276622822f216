"""GEMM benchmark and correctness harness of the port.

Counterpart of the JAX repository's ``benchmark_mm.py``, with its method:
every kernel is asserted against an exact oracle before it is timed
(``benchmark_mm.py:114-160``), square sizes are swept (1k/2k/4k by default),
and each row is reported in TFLOP/s beside the card's dense peak. The gates:

- B1 (``ops.scaled_mm``, row x column scales, fp32 out) equals the exact
  int32 product times the scales in fp32, bit for bit;
- B15's int8 form (``ops.tile_scaled_mm`` on 128 x 128 scale tiles) lies
  within ``fold_bound`` (n_qk fp32 roundings of the folded magnitudes) of
  the blockwise-exact partials times the expanded scales, in float64;
- B17's bf16 form (``ops.matmul``, fp32 accumulator, bf16 out) lies between
  the bf16 roundings of the float64 product minus and plus the bound of an
  fp32 sum in any order (``ops/matmul.py::fp32_sum_bound``), and its int8
  form (int32 out) equals the exact product.

Then it times the JAX script's rows under their names (:162-200):
``xla_bf16`` (``torch.matmul``, the library yardstick), ``xla_int8``
(``torch._int_mm``), ``xla_scaled_int8`` (``torch._int_mm`` and the fp32
epilogue in plain torch), ``pallas_scaled_int8`` (B1),
``pallas_tile_scaled_int8`` (B15 int8), ``pallas_bf16`` (B17) and
``xla_dynamic_int8`` (the port's int8 quantizes and B1). ``--train-shapes``
times the forward of ``mixed_precision``'s dynamic int8 linear (dims (1, 1))
against bf16 at five Llama training shapes.

Each row is one call's device time (``utils/timing.py``: a CUDA graph of
back-to-back calls over copies of the operands that miss the 50 MB L2,
CUDA events). The script prints the card's name and power limit first and
takes the peaks for that name; a card not in ``PEAKS`` gets TFLOP/s with no
share of peak. ``--cpu`` runs the gates on the plain versions and times the
rows with the host clock: it exists to drive the entry point in tests, and
its numbers are no device metric.

  python -m quantized_training_tpu_torch.benchmark_mm [--sizes 1024 2048 4096] [--quick] [--train-shapes] [--cpu]
"""

from __future__ import annotations

import argparse
import importlib
import subprocess

import torch

from . import ops
from .quant import core
from .quant.mixed_precision import _dynamic_int8_mm
from .utils.timing import copies, host_ms, time_ms

# the modules: the ops package exports functions of their names
MATMUL = importlib.import_module(f"{__package__}.ops.matmul")
TILE_MM = importlib.import_module(f"{__package__}.ops.tile_scaled_mm")

# dense tensor-core peaks in TFLOP/s (TOP/s for int8) by device name, from
# NVIDIA's data sheets (SXM parts, at their full power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "int8": 1979.0},
    "NVIDIA H200": {"bf16": 989.0, "int8": 1979.0},
}

TRAIN_SHAPES = [  # (name, M, K, N) of x[M, K] . w[N, K]^T: Llama at batch 8 x 2048
    ("attn_qkvo 1b", 16384, 2048, 2048),
    ("mlp_up 1b", 16384, 2048, 5632),
    ("mlp_down 1b", 16384, 5632, 2048),
    ("attn 470m", 16384, 1024, 1024),
    ("mlp_up 470m", 16384, 1024, 4096),
]


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"benchmark_mm gate failed: {what}")


def within_rounding(got: torch.Tensor, exact: torch.Tensor, bound: torch.Tensor) -> bool:
    """``got`` (fp32 or bf16) is a rounding, to its own type through fp32, of
    some value within ``bound`` of ``exact`` (both float64): round to
    nearest is monotone, so it lies between the roundings of exact - bound
    and exact + bound."""
    lo = (exact - bound).float().to(got.dtype)
    hi = (exact + bound).float().to(got.dtype)
    return bool(((got >= lo) & (got <= hi)).all())


def gates(a_bf, b_bf, a_i8, sa, b_i8, sb, sa_t, sb_t) -> None:
    """Each kernel against its exact oracle (raises RuntimeError)."""
    acc_exact = (a_i8.double() @ b_i8.double()).float()  # exact, |sum| < 2**24
    oracle = acc_exact * sa * sb
    gate(torch.equal(ops.scaled_mm(a_i8, b_i8, sa, sb, out_dtype=torch.float32), oracle),
         "scaled_mm (B1) equals the exact int32 product times the scales in fp32")
    gate(torch.equal(ops.matmul(a_i8, b_i8).float(), acc_exact), "matmul (B17 int8) equals the exact int32 product")

    n, qk = a_i8.shape[1], a_i8.shape[1] // sa_t.shape[1]
    qm, qn = a_i8.shape[0] // sa_t.shape[0], b_i8.shape[1] // sb_t.shape[1]
    sa_x, sb_x = sa_t.double().repeat_interleave(qm, 0), sb_t.double().repeat_interleave(qn, 1)
    tile_oracle = torch.zeros(a_i8.shape[0], b_i8.shape[1], dtype=torch.float64, device=a_i8.device)
    for kb in range(n // qk):  # the blockwise-exact partials times the expanded scales
        k = slice(kb * qk, (kb + 1) * qk)
        tile_oracle += (a_i8[:, k].double() @ b_i8[k].double()) * sa_x[:, kb:kb + 1] * sb_x[kb:kb + 1]
    got = ops.tile_scaled_mm(a_i8, b_i8, sa_t, sb_t, out_dtype=torch.float32)
    fold = TILE_MM.fold_bound(a_i8, b_i8, sa_t, sb_t, sa_t.shape[1])
    gate(bool(((got.double() - tile_oracle).abs() <= fold).all()),
         "tile_scaled_mm (B15 int8) within n_qk fp32 roundings of the blockwise-exact oracle")

    exact = a_bf.double() @ b_bf.double()
    got = ops.matmul(a_bf, b_bf, acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    gate(within_rounding(got, exact, MATMUL.fp32_sum_bound(a_bf, b_bf)),
         "matmul (B17 bf16) is the bf16 rounding of an fp32 sum of the float64 product")


def bench_size(n: int, quick: bool, timer, device: str) -> dict[str, float]:
    """TFLOP/s of each row on square A[n, n] . B[n, n], after the gates."""
    gen = torch.Generator(device=device).manual_seed(0)
    a_bf = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    b_bf = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    a_i8, sa = core.quantize_int8(a_bf.float(), axis=1)  # [n, 1] row scales
    b_i8, sb = core.quantize_int8(b_bf.float(), axis=0)  # [1, n] column scales
    sa_t = torch.rand(n // 128, n // 128, generator=gen, device=device) * 0.01
    sb_t = torch.rand(n // 128, n // 128, generator=gen, device=device) * 0.01
    gates(a_bf, b_bf, a_i8, sa, b_i8, sb, sa_t, sb_t)

    def dynamic(a, b):
        ai, sa_ = core.quantize_int8(a, axis=1)
        bi, sb_ = core.quantize_int8(b, axis=0)
        return ops.scaled_mm(ai, bi, sa_, sb_, out_dtype=torch.bfloat16)

    rows = {
        "xla_bf16": (torch.matmul, (a_bf, b_bf)),
        "xla_int8": (torch._int_mm, (a_i8, b_i8)),
        "xla_scaled_int8": (lambda a, b, s1, s2: torch._int_mm(a, b).float() * s1 * s2, (a_i8, b_i8, sa, sb)),
        "pallas_scaled_int8": (lambda a, b, s1, s2: ops.scaled_mm(a, b, s1, s2, out_dtype=torch.float32),
                               (a_i8, b_i8, sa, sb)),
        "pallas_tile_scaled_int8": (lambda a, b, s1, s2: ops.tile_scaled_mm(a, b, s1, s2, out_dtype=torch.float32),
                                    (a_i8, b_i8, sa_t, sb_t)),
    }
    if not quick:
        rows["pallas_bf16"] = (lambda a, b: ops.matmul(a, b, acc_dtype=torch.float32, out_dtype=torch.bfloat16),
                               (a_bf, b_bf))
        rows["xla_dynamic_int8"] = (dynamic, (a_bf, b_bf))
    flops = 2.0 * n ** 3
    return {name: flops / timer(fn, copies(*args)) / 1e9 for name, (fn, args) in rows.items()}


def bench_train_shapes(timer, device: str) -> dict[str, tuple[float, float]]:
    """(bf16, dynamic int8) TFLOP/s of the forward x . w^T at TRAIN_SHAPES,
    the int8 one including both quantizes (the hot path of
    ``mixed_precision``'s linear, dims (1, 1): w stays [N, K])."""
    print("--- training shapes: x[M,K] @ w.T[K,N] (fwd) ---")
    out = {}
    for name, M, K, N in TRAIN_SHAPES:
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn(N, K, generator=gen, device=device).to(torch.bfloat16)
        flops = 2.0 * M * K * N
        bf16 = flops / timer(lambda x_, w_: x_ @ w_.T, copies(x, w)) / 1e9
        dyn = flops / timer(lambda x_, w_: _dynamic_int8_mm(x_, w_, False, None, (1, 1)), copies(x, w)) / 1e9
        print(f"  {name:16s} M={M} K={K} N={N}: bf16 {bf16:6.1f}  dyn_int8 {dyn:6.1f}  ({dyn / bf16:.2f}x)",
              flush=True)
        out[name] = (bf16, dyn)
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[1024, 2048, 4096],
                   help="square sizes, multiples of 128 (the tile scales' blocks)")
    p.add_argument("--quick", action="store_true", help="leave out the pallas_bf16 and xla_dynamic_int8 rows")
    p.add_argument("--train-shapes", action="store_true", help="time the training shapes instead")
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("benchmark_mm: no CUDA card; pass --cpu to run the plain versions on the CPU")
    if args.cpu:
        device, timer, peaks = "cpu", host_ms, None
        print("device: cpu (plain versions; host-clock times, no device metric)")
    else:
        device, timer = "cuda", time_ms
        print(card_line())
        name = torch.cuda.get_device_name(0)
        peaks = PEAKS.get(name)
        print(f"device: {name}; " + (f"dense peaks bf16 {peaks['bf16']:g} TFLOP/s, int8 {peaks['int8']:g} TOP/s"
                                     if peaks else "no peaks on record for this card: TFLOP/s only"), flush=True)
    if args.train_shapes:
        return bench_train_shapes(timer, device)
    rows = {}
    for n in args.sizes:
        print(f"--- {n}x{n}x{n} ---", flush=True)
        rows[n] = bench_size(n, args.quick, timer, device)
        for k, v in rows[n].items():
            share = f"  ({100 * v / peaks['int8' if 'int8' in k else 'bf16']:5.1f}% of peak)" if peaks else ""
            print(f"  {k:26s} {v:8.1f} TFLOP/s{share}", flush=True)
    keys = list(next(iter(rows.values())))
    print("\n| kernel | " + " | ".join(str(n) for n in rows) + " |")
    print("|---|" + "---|" * len(rows))
    for k in keys:
        print(f"| {k} | " + " | ".join(f"{rows[n][k]:.1f}" for n in rows) + " |")
    return rows


if __name__ == "__main__":
    main()
