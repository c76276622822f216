"""Build and bind the port's CUDA kernels (no JAX counterpart).

``library()`` compiles every ``csrc/*.cu`` at first use, for ``sm_90a``
(``philox.cuh``, the random stream, is included by four of them,
``row_common.cuh``, the row-walking kernels' building blocks and the
one-add int8 casts, by four,
``mm_tiles.cuh``, the wmma GEMMs' tile copies, by four, and
``sm90_gemm.cuh``, the pipelined TMA + wgmma GEMM mainloop, by four): one
``nvcc -c`` per source, all started together, then one link into a shared
library, which it loads with ``ctypes``. The link names no ``-lcuda``:
``sm90_gemm.cuh`` reaches the driver's ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint``. The library carries a plain C interface (no
PyTorch headers), so a build takes seconds: 5.5-6.3 s for ``int8_quant.cu``
and ``scaled_mm.cu``, against 9.6-10.0 s for one ``nvcc -shared`` over both
(H100 machine, 8 cores, build alone, alternating order). It lands in
``build/qt_torch_kernels/`` at the repository root, named by a hash of the
sources and headers, so an edited source rebuilds and an unchanged one is
reused. nvcc's ``-Xptxas -v`` report (registers, shared memory, spills per kernel)
is kept beside it as ``build.log``.

Every entry point returns the launch's ``cudaError_t``; the wrappers in
``ops/int8_quant.py``, ``ops/scaled_mm.py``, ``ops/int4_mm.py``,
``ops/tile_scaled_mm.py``, ``ops/fused_adamw.py``, ``ops/fused_producers.py``,
``ops/rope.py``, ``ops/matmul.py`` and ``ops/int8_attention.py`` raise when it
is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qt_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    # x, q, scale, M, K, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_quantize_int8_rowwise": (_P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _I, _I64, _P),
    # x, q, scale, amax, R, C, eps, is_bf16, sr, key, sv, cs, threads, stream
    "qt_quantize_int8_colwise": (_P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _I, _I, _P),
    # x, q_row, s_row, q_col, s_col, amax, M, K, eps, is_bf16, sr, key_row, key_col, stream
    "qt_quantize_int8_both": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _U64, _P,
    ),
    # the mesh forms: x, amax, M, K, is_bf16, tpr, ctas, stream
    "qt_quantize_int8_rowwise_maxima": (_P, _P, _I64, _I64, _I, _I, _I64, _P),
    # x, q, scale, amax, M, K, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_quantize_int8_rowwise_given": (_P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _I, _I64, _P),
    # x, amax, R, C, is_bf16, stream
    "qt_quantize_int8_colwise_maxima": (_P, _P, _I64, _I64, _I, _P),
    # x, q_row, s_row, parts, amax, M, K, eps, is_bf16, sr, key_row, stream
    "qt_quantize_int8_both_maxima": (_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _P),
    # x, q_col, s_col, amax, M, K, eps, is_bf16, sr, key_col, stream
    "qt_quantize_int8_colwise_given": (_P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _P),
    # p, g, ea, eas, scalars, new_p, new_ea, new_eas, n, p_is_bf16, sr, key, stream
    "qt_fused_adamw": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _U64, _P),
    # x, g, q, s_row, amax, parts, M, K, rpb, norm_eps, eps, is_bf16, sr, with_amax, key, tpr, ctas, stream
    "qt_rmsnorm_quant_rowwise": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _I, _I, _I, _U64, _I, _I64, _P,
    ),
    # a, b, q, s_row, amax, parts, M, K, rpb, eps, is_bf16, sr, with_amax, key, tpr, ctas, stream
    "qt_silu_mul_quant_rowwise": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _I, _U64, _I, _I64, _P,
    ),
    # x, g, scale, q, s_out, amax, parts, M, K, rpb, norm_eps, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_rmsnorm_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _I, _I, _U64, _I, _I64, _P,
    ),
    # a, b, scale, q, s_out, amax, parts, M, K, rpb, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_silu_mul_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _U64, _I, _I64, _P,
    ),
    # x, g, b, q, s_row, amax, parts, M, K, rpb, norm_eps, eps, is_bf16, sr, with_amax, key, tpr, ctas, stream
    "qt_layernorm_quant_rowwise": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _I, _I, _I, _U64, _I, _I64, _P,
    ),
    # x, g, b, scale, q, s_out, amax, parts, M, K, rpb, norm_eps, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_layernorm_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _I, _I, _U64, _I, _I64, _P,
    ),
    # a, q, s_row, amax, parts, M, K, rpb, eps, is_bf16, sr, with_amax, key, tpr, ctas, stream
    "qt_gelu_quant_rowwise": (
        _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _I, _U64, _I, _I64, _P,
    ),
    # a, scale, q, s_out, amax, parts, M, K, rpb, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_gelu_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _U64, _I, _I64, _P,
    ),
    # x, g, dy, dx, dg, dg_part, M, K, rpb, norm_eps, is_bf16, tpr, ctas, stream
    "qt_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _I64, _P),
    # a, b, dy, qa, sa, qb, sb, amax, parts, ca, cb, M, K, rpb, eps, is_bf16, sr, with_amax, with_copy, key,
    # tpr, ctas, stream
    "qt_silu_mul_bwd_quant_rowwise": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _I, _I, _U64, _I, _I64,
        _P,
    ),
    # a, b, dy, scale_a, scale_b, qa, qb, M, K, rpb, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_silu_mul_bwd_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _U64, _I, _I64, _P,
    ),
    # in, isb, iss, ish, out, osb, oss, osh, cos, sin, ldt, B, S, H, hd, mode, is_bf16, stream
    "qt_rope_relayout": (
        _P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _P,
    ),
    # y, sb, ss, sh, B, S, H, hd, rmax, cmax, parts, rpb, is_bf16, tpr, ctas, stream
    "qt_ungroup_amax": (_P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _P, _I64, _I, _I, _I64, _P),
    # y, sb, ss, sh, B, S, H, hd, scale, q, rpb, axis, eps, is_bf16, sr, key, tpr, ctas, stream
    "qt_ungroup_quant": (
        _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _I64, _I, ctypes.c_float, _I, _I, _U64, _I, _I64, _P,
    ),
    # a, b, sa, sb, out, M, N, K, a_kmajor, b_kmajor, scale_bf16, out_bf16, sm90, stream
    "qt_scaled_mm_s8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, splits, stream
    "qt_scaled_mm_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, sm90, stream
    "qt_scaled_int4_mm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # a, b, sa, sb, out, M, N, K, qm, qk, qn, is_fp8, scale_bf16, out_bf16, sm90, stream
    "qt_tile_scaled_mm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # a, b, out, M, N, K, is_bf16, out_bf16, a_vec, b_vec, sm90, stream
    "qt_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, qs, k, ks, v, vs, out, lse, n_inst, G, S, hd, bkv, causal, ctas, stream
    "qt_int8_flash_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the port's kernels are built from "
        f"{CSRC} with the CUDA toolkit"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*srcs, *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernels, built on first use. Raises RuntimeError when
    CUDA is absent, nvcc is missing, or the build fails (with nvcc's
    output)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's kernels need an NVIDIA GPU "
            "(sm_90a); CPU tensors take the plain PyTorch versions instead"
        )
    srcs = sources()
    lib_path = BUILD_DIR / f"libqt_torch_kernels_{_digest(srcs)}.so"
    if not lib_path.exists():
        _compile(srcs, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their output, or RuntimeError with
    the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(srcs: list[Path], lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in srcs]
    nvcc = _nvcc()
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(srcs, objs)])
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    (BUILD_DIR / "build.log").write_text(log)
    for o in objs:
        o.unlink()
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


_REPEATED_KEYS = [False]


@contextlib.contextmanager
def repeated_keys():
    """While entered, an SR kernel may be captured: a timing loop
    (``utils/timing.py::time_ms``) replays its launches to time them, and
    the same key at every replay is what it asks for."""
    keep, _REPEATED_KEYS[0] = _REPEATED_KEYS[0], True
    try:
        yield
    finally:
        _REPEATED_KEYS[0] = keep


def refuse_capture(what: str) -> None:
    """Raise where a kernel that takes its Philox key from the host (an SR
    form) is launched while the current stream captures a CUDA graph: the
    graph would keep this launch's key and draw the same noise at every
    replay, where each step draws its own. Without CUDA nothing captures
    (a test's launch on a stand-in device); inside :func:`repeated_keys`
    the repeat is meant."""
    if _REPEATED_KEYS[0]:
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise ValueError(f"{what}: a stochastic-rounding kernel was launched inside a CUDA graph capture; its key "
                         "is a host integer that every replay would repeat, so run this step with jit_compile=False")


def stream() -> int:
    """The current PyTorch CUDA stream, as the pointer the kernels take."""
    return torch.cuda.current_stream().cuda_stream
