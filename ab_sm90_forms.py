"""A/B of the sm90 mainloop's rewriting forms on one CUDA card: B2 (the int8
grad_weight GEMM, ``S8MnMajor``) and B16 (the packed-int4 GEMM,
``S4KMajor``) of ``quantized_training_tpu_torch/ops/csrc/sm90_gemm.cuh``.

Each variant is this tree's ``ops/csrc`` with a few text edits
(``VARIANTS``), or with ``--parent DIR`` the sources of another checkout (an
earlier commit, for its wmma kernels), built with nvcc into a library of its
own under ``build/ab_sm90_forms/``, all builds side by side. Every variant
is held against the plain versions at a ragged shape and at gate/up's
(``diag_`` variants break the kernel on purpose, to time what a part of it
costs: they report exactness and do not fail), then all are timed in turns
(in order, then reversed; ``utils/timing.py``: a CUDA graph over L2-cold
copies, CUDA events) at the Llama2-1B step's shapes, beside
``torch._int_mm`` on the same operands (unpacked for B16) and the share of
the int8 tensor-core bound (1,979 TOP/s). ``kept/wmma`` is this tree's B16
on its wmma kernel (``sm90`` = 0); ``parent/wmma`` the other checkout's B2
and B16 on theirs; K2, which no variant changes, is timed on this tree's
and the other checkout's mainloop, so that a change to the shared mainloop
shows on it.

Usage: python3 ab_sm90_forms.py [--parent DIR] [--variants kept,b2_3+3,...]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import shutil
import subprocess
import time
from pathlib import Path

import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.ops import _build
from quantized_training_tpu_torch.utils.timing import copies, time_ms

OUT = Path(__file__).resolve().parent / "build" / "ab_sm90_forms"
INT8_OPS_PER_S = 1.979e15
_B2_DEPTH = "  static constexpr int BK = 128, kStages = 4, kRawSlots = 2, kAccShift = 0;"
_B16_DEPTH = "  static constexpr int kStages = kSub == 1 ? 4 : 3, kRawSlots = kSub == 1 ? 8 : 4;"
# widen a nibble by sign extension into the low half of its byte (kAccShift 0)
_SIGN_EXTEND = [
    ("return w & 0xF0F0F0F0u;", "return ((((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;"),
    ("return (w << 4) & 0xF0F0F0F0u;", "return (((w & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;"),
    ("  static constexpr int BK = kBK, kAccShift = 8;", "  static constexpr int BK = kBK, kAccShift = 0;"),
]
_B16_LOOP = "    for (int it = 0; it < BK / 32; ++it) {"
_BK128 = ("using S4KMajor = S4KMajorT<256>;", "using S4KMajor = S4KMajorT<128>;")
# (old text, new text) edits of sm90_gemm.cuh, each of which must match once
VARIANTS = {
    "kept": [],
    "b2_3+3": [(_B2_DEPTH, _B2_DEPTH.replace("kStages = 4, kRawSlots = 2", "kStages = 3, kRawSlots = 3"))],
    "b2_2+4": [(_B2_DEPTH, _B2_DEPTH.replace("kStages = 4, kRawSlots = 2", "kStages = 2, kRawSlots = 4"))],
    "b16_2+5": [(_B16_DEPTH, _B16_DEPTH.replace("kSub == 1 ? 4 : 3, kRawSlots = kSub == 1 ? 8 : 4",
                                                "kSub == 1 ? 4 : 2, kRawSlots = kSub == 1 ? 8 : 5"))],
    # 128 values of K a stage (twice the K steps, 64-byte TMA rows), 4 + 8 or 6 + 8 deep
    "b16_bk128": [_BK128],
    "b16_bk128_6+8": [_BK128, (_B16_DEPTH, _B16_DEPTH.replace("kSub == 1 ? 4 : 3", "kSub == 1 ? 6 : 3"))],
    "b16_sign_extend": _SIGN_EXTEND,
    # a CTA a tile instead of one CTA an SM walking its tiles (every form)
    "one_tile": [("  const int ctas = walk.tiles < sms ? walk.tiles : sms;", "  const int ctas = walk.tiles;")],
    # b's widening skipped: the mainloop's time without its rewrite
    "diag_b16_no_rewrite": [(_B16_LOOP, _B16_LOOP + "\n      if (t >= 0) continue;")],
    # no fence between the producer's stores and the consumers' wgmma reads
    "diag_no_fence": [("    fence_proxy_async();\n    mbar_arrive(full0 + 8 * s);", "    mbar_arrive(full0 + 8 * s);")],
}
# (M, N, K): B2 at every grad_weight of the Llama2-1B step (out, in, 8,192
# tokens) and of ViT-Giant's (6,400 padded tokens); B16 at the forward,
# grad_input and grad_weight shapes of gate/up and down
B2_SHAPES = [(2048, 2048, 8192), (256, 2048, 8192), (5632, 2048, 8192), (2048, 5632, 8192),
             (4608, 1536, 6400), (1536, 1536, 6400), (6144, 1536, 6400), (1536, 6144, 6400)]
B16_SHAPES = [(8192, 5632, 2048), (8192, 2048, 5632), (5632, 2048, 8192), (2048, 5632, 8192)]
# K2 at gate/up and q/o, against the parent's: the mainloop the forms share
K2_SHAPES = [(8192, 5632, 2048), (8192, 2048, 2048)]


def sources(name: str, edits, parent: Path | None) -> Path:
    """A copy of the kernel sources for one variant."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(parent / "quantized_training_tpu_torch/ops/csrc" if parent else _build.CSRC, d)
    header = d / "sm90_gemm.cuh"
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ab_sm90_forms: variant {name}: the edit {old[:60]!r} does not match once")
        text = text.replace(old, new)
    header.write_text(text)
    return d


def build(variants: dict, parent: Path | None) -> dict:
    """name -> (library, its signatures): scaled_mm.cu of each variant,
    compiled side by side."""
    procs = {}
    for name, edits in variants.items():
        d = sources(name, edits, parent if name == "parent" else None)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "scaled_mm.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ab_sm90_forms: {name} did not build:\n{log[-4000:]}")
        sigs = _build._SIGNATURES
        if name == "parent":  # that checkout's entry signatures
            spec = importlib.util.spec_from_file_location(
                "parent_build", parent / "quantized_training_tpu_torch/ops/_build.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sigs = mod._SIGNATURES
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("qt_scaled_mm_s8", "qt_scaled_int4_mm"):
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, sigs)
    return libs


def b2(lib, sigs, sm90):
    """B2 on ``lib``'s route ``sm90``: a [K, M], b [K, N] -> bf16."""
    def call(a, b, sa, sb):
        (K, M), N = a.shape, b.shape[1]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_mm_s8(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                         M, N, K, 0, 0, 1, 1, sm90, _build.stream()), "B2")
        return out
    return call


def k2(lib, sigs, sm90):
    """K2 on ``lib``'s route ``sm90``: a [M, K], b [N, K] -> bf16."""
    def call(a, b, sa, sb):
        (M, K), N = a.shape, b.shape[0]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_mm_s8(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                         M, N, K, 1, 1, 1, 1, sm90, _build.stream()), "K2")
        return out
    return call


def b16(lib, sigs, sm90):
    """B16 on ``lib``'s route ``sm90`` (an entry without the argument has
    the wmma kernel only): a [M, K / 2], b [N, K / 2] packed -> bf16."""
    route = (sm90,) if len(sigs["qt_scaled_int4_mm"]) == 12 else ()

    def call(a, b, sa, sb):
        (M, P), N = a.shape, b.shape[0]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_int4_mm(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                           out.data_ptr(), M, N, 2 * P, 1, 1, *route, _build.stream()), "B16")
        return out
    return call


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="another checkout, whose wmma B2 and B16 are timed too")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_sm90_forms: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    variants = {k: VARIANTS[k] for k in args.variants.split(",")}
    if args.parent:
        variants["parent"] = []
    t0 = time.perf_counter()
    libs = build(variants, args.parent)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    # (label, kernel, call): each variant on the sm90 route, and the wmma kernels
    entries = [(f"{n}/sm90", k, f(lib, sigs, 1)) for n, (lib, sigs) in libs.items() if n != "parent"
               for k, f in (("B2", b2), ("B16", b16), ("K2", k2))]
    if "kept" in libs:
        entries.append(("kept/wmma", "B16", b16(*libs["kept"], 0)))
    if args.parent:
        entries += [("parent/wmma", k, f(*libs["parent"], 0)) for k, f in (("B2", b2), ("B16", b16))]
        entries.append(("parent/sm90", "K2", k2(*libs["parent"], 1)))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(kernel, M, N, K):
        def i8(shape):
            return torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        a, b = {"B2": lambda: (i8((K, M)), i8((K, N))), "B16": lambda: (i8((M, K // 2)), i8((N, K // 2))),
                "K2": lambda: (i8((M, K)), i8((N, K)))}[kernel]()
        return a, b, torch.rand(M, generator=gen, device="cuda").bfloat16(), \
            torch.rand(N, generator=gen, device="cuda").bfloat16()

    plain = {"B2": ops.scaled_mm_lhs_t_plain, "B16": ops.scaled_int4_mm_plain, "K2": ops.scaled_mm_rhs_t_plain}
    for kernel, shape in (("B2", (144, 208, 288)), ("B2", (5632, 2048, 8192)), ("B16", (130, 200, 288)),
                          ("B16", (5632, 2048, 8192)), ("K2", (8192, 5632, 2048))):
        args_ = operands(kernel, *shape)
        ref = plain[kernel](*args_)
        for label, k, call in entries:
            if k == kernel:
                exact = torch.equal(call(*args_), ref)
                print(f"{label} {kernel} {shape}: bit-exact {exact}", flush=True)
                if not (exact or label.startswith("diag_")):
                    raise SystemExit(f"ab_sm90_forms: {label} {kernel} at {shape} differs from the plain version")
    rows = [("B2", s) for s in B2_SHAPES] + [("B16", s) for s in B16_SHAPES] + [("K2", s) for s in K2_SHAPES]
    times = {}
    for turn in (entries, entries[::-1]):
        for label, kernel, call in turn:
            for k, shape in rows:
                if k == kernel:
                    inputs = copies(*operands(kernel, *shape))
                    times.setdefault((label, kernel, shape), []).append(time_ms(call, inputs, iters=8) * 1e3)
    for kernel, (M, N, K) in rows:
        a, b, _, _ = operands(kernel, M, N, K)
        if kernel == "B2":
            lib_us = time_ms(lambda a, b: torch._int_mm(a.t(), b), copies(a, b), iters=8) * 1e3
        elif kernel == "K2":
            lib_us = time_ms(lambda a, b: torch._int_mm(a, b.t()), copies(a, b), iters=8) * 1e3
        else:
            lib_us = time_ms(lambda a, b: torch._int_mm(a, b.t()), copies(ops.unpack_int4(a), ops.unpack_int4(b)),
                             iters=8) * 1e3
        bound_us = 2 * M * N * K / INT8_OPS_PER_S * 1e6
        cells = [f"{label} {sum(t) / len(t):.1f} {[round(v, 1) for v in t]} ({bound_us * len(t) / sum(t):.3f})"
                 for (label, k, shape), t in times.items() if k == kernel and shape == (M, N, K)]
        print(f"{kernel} M={M} N={N} K={K}: bound {bound_us:.1f} us; " + "; ".join(cells)
              + f"; torch._int_mm {lib_us:.1f}", flush=True)


if __name__ == "__main__":
    main()
