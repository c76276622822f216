"""Conv2d benchmark of the port: int8 against bf16 at ResNet/VAE shapes.

Counterpart of the JAX repository's ``benchmark_conv2d.py``: the same six
shapes (``--quick``: the first three), the same table, ``| B,H,W,Cin->Cout
k s | bf16 ms | int8 ms | speedup |``, where bf16 is ``ops.conv2d`` on bf16
operands (plain ``F.conv2d`` in fp32) and int8 ``ops.scaled_int8_conv2d``
(im2col, then K2) with a channel scale of 0.01, both at padding k // 2.
Before a shape is timed, its ``int8_conv2d`` (B17's int8 form) and
``scaled_int8_conv2d`` outputs are held bit for bit against the GEMMs'
plain versions on the same im2col operands. A second table gives, for the
same shapes, cuDNN's bf16 conv in channels-last memory (``F.conv2d`` on
bf16, a reference: not the same function, which accumulates in fp32 and
rounds once) and the int8 conv's rate in TOP/s.

Each time is one call's device time (``utils/timing.py``: a CUDA graph of
back-to-back calls over copies of the operands, CUDA events). The first
line is the card's name and power limit from nvidia-smi. ``--cpu`` runs the
plain versions and times with the host clock, to drive the entry point in
tests; its numbers are no device metric. ``--batch`` replaces every shape's
batch.

  python -m quantized_training_tpu_torch.benchmark_conv2d [--quick] [--batch N] [--cpu]
"""

from __future__ import annotations

import argparse
import importlib

import torch
import torch.nn.functional as F

from .benchmark_mm import card_line
from .utils.timing import copies, host_ms, time_ms

CONV = importlib.import_module(f"{__package__}.ops.conv")
MATMUL = importlib.import_module(f"{__package__}.ops.matmul")
SCALED_MM = importlib.import_module(f"{__package__}.ops.scaled_mm")

# (batch, H, W, C_in, C_out, kernel, stride): ResNet/VAE-style shapes
SHAPES = [
    (32, 56, 56, 64, 64, 3, 1),
    (32, 56, 56, 64, 128, 3, 2),
    (32, 28, 28, 128, 256, 3, 2),
    (32, 14, 14, 256, 512, 3, 2),
    (8, 128, 128, 128, 128, 3, 1),  # VAE-ish
    (8, 64, 64, 256, 256, 3, 1),
]


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"benchmark_conv2d gate failed: {what}")


def inputs(shape, device: str, seed: int = 0):
    """bf16 and int8 operands of one shape, and the channel scale."""
    B, H, W, Cin, Cout, k, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x_bf = torch.randn((B, H, W, Cin), generator=g, device=device).to(torch.bfloat16)
    w_bf = torch.randn((k, k, Cin, Cout), generator=g, device=device).to(torch.bfloat16)
    x_i8 = torch.randint(-128, 128, (B, H, W, Cin), generator=g, device=device, dtype=torch.int8)
    w_i8 = torch.randint(-128, 128, (k, k, Cin, Cout), generator=g, device=device, dtype=torch.int8)
    cs = torch.full((Cout,), 0.01, device=device)
    return x_bf, w_bf, x_i8, w_i8, cs


def check_shape(x_i8, w_i8, cs, s: int, pad: int) -> None:
    """Both int8 convs against the GEMMs' plain versions on their im2col
    operands, bit for bit."""
    k = w_i8.shape[0]
    cols = CONV.im2col(x_i8, k, k, s, pad, CONV.K_ALIGN)
    w_kn = CONV.weight_kn(w_i8, cols.shape[1]).contiguous()
    acc = CONV.int8_conv2d(x_i8, w_i8, s, pad)
    gate(torch.equal(acc.reshape(cols.shape[0], -1), MATMUL.matmul_plain(cols, w_kn)), "int8_conv2d (B17 int8)")
    ones = torch.ones(cols.shape[0], device=x_i8.device)
    ref = SCALED_MM.scaled_mm_rhs_t_plain(cols, w_kn.T.contiguous(), ones, cs)
    out = CONV.scaled_int8_conv2d(x_i8, w_i8, cs, s, pad)
    gate(torch.equal(out.reshape(cols.shape[0], -1), ref), "scaled_int8_conv2d (K2)")


def bench_shape(shape, timer, device: str) -> dict:
    B, H, W, Cin, Cout, k, s = shape
    pad = k // 2
    x_bf, w_bf, x_i8, w_i8, cs = inputs(shape, device)
    check_shape(x_i8, w_i8, cs, s, pad)
    bf16_ms = timer(lambda x, w: CONV.conv2d(x, w, stride=s, padding=pad), copies(x_bf, w_bf))
    int8_ms = timer(lambda x, w: CONV.scaled_int8_conv2d(x, w, cs, stride=s, padding=pad), copies(x_i8, w_i8))
    x_cl = x_bf.permute(0, 3, 1, 2)  # NCHW sizes in channels-last memory
    w_cl = w_bf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cudnn_ms = timer(lambda x, w: F.conv2d(x, w, stride=s, padding=pad), copies(x_cl, w_cl))
    OH, OW = CONV.out_hw(H, W, k, k, s, pad)
    ops = 2 * B * OH * OW * Cout * k * k * Cin
    return {"bf16_ms": bf16_ms, "int8_ms": int8_ms, "cudnn_bf16_ms": cudnn_ms, "int8_tops": ops / int8_ms / 1e9}


def label(shape) -> str:
    B, H, W, Cin, Cout, k, s = shape
    return f"{B},{H},{W},{Cin}->{Cout} {k} {s}"


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="the first three shapes only")
    p.add_argument("--batch", type=int, default=None, help="replace every shape's batch")
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("benchmark_conv2d: no CUDA card; pass --cpu to run the plain versions on the CPU")
    device, timer = ("cpu", host_ms) if args.cpu else ("cuda", time_ms)
    print("device: cpu (plain versions; host-clock times, no device metric)" if args.cpu else card_line(),
          flush=True)
    shapes = SHAPES[:3] if args.quick else SHAPES
    if args.batch is not None:
        shapes = [(args.batch, *s[1:]) for s in shapes]
    rows = {}
    print("| B,H,W,Cin->Cout k s | bf16 ms | int8 ms | speedup |")
    print("|---|---|---|---|")
    for shape in shapes:
        r = rows[shape] = bench_shape(shape, timer, device)
        print(f"| {label(shape)} | {r['bf16_ms']:.2f} | {r['int8_ms']:.2f} | {r['bf16_ms'] / r['int8_ms']:.2f}x |",
              flush=True)
    print("\n| B,H,W,Cin->Cout k s | library bf16 ms (F.conv2d, cuDNN on the card; reference) | int8 TOP/s |")
    print("|---|---|---|")
    for shape, r in rows.items():
        print(f"| {label(shape)} | {r['cudnn_bf16_ms']:.3f} | {r['int8_tops']:.1f} |")
    return rows


if __name__ == "__main__":
    main()
