"""Build and bind the port's CUDA kernels (no JAX counterpart).

``library()`` compiles every ``csrc/*.cu`` at first use, for ``sm_90a``
(``philox.cuh``, the random stream, is included by three of them): one ``nvcc
-c`` per source, all started together, then one link into a shared library,
which it loads with ``ctypes``. The library carries a plain C interface (no
PyTorch headers), so a build takes seconds: 5.5-6.3 s for ``int8_quant.cu``
and ``scaled_mm.cu``, against 9.6-10.0 s for one ``nvcc -shared`` over both
(H100 machine, 8 cores, build alone, alternating order). It lands in
``build/qt_torch_kernels/`` at the repository root, named by a hash of the
sources and headers, so an edited source rebuilds and an unchanged one is
reused. nvcc's ``-Xptxas -v`` report (registers, shared memory, spills per kernel)
is kept beside it as ``build.log``.

Every entry point returns the launch's ``cudaError_t``; the wrappers in
``ops/int8_quant.py``, ``ops/scaled_mm.py``, ``ops/fused_adamw.py`` and
``ops/fused_producers.py`` raise when it is not 0.
"""

from __future__ import annotations

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
    # x, q, scale, M, K, eps, is_bf16, sr, key, stream
    "qt_quantize_int8_rowwise": (_P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _P),
    # x, q, scale, amax, R, C, eps, is_bf16, sr, key, stream
    "qt_quantize_int8_colwise": (_P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _P),
    # x, q_row, s_row, q_col, s_col, amax, M, K, eps, is_bf16, sr, key_row, key_col, stream
    "qt_quantize_int8_both": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _I, _I, _U64, _U64, _P,
    ),
    # p, g, ea, eas, scalars, new_p, new_ea, new_eas, n, p_is_bf16, sr, key, stream
    "qt_fused_adamw": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _U64, _P),
    # x, g, q, s_row, amax, parts, M, K, rpb, norm_eps, eps, is_bf16, sr, with_amax, key, stream
    "qt_rmsnorm_quant_rowwise": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _I, _I, _I, _U64, _P,
    ),
    # a, b, q, s_row, amax, parts, M, K, rpb, eps, is_bf16, sr, with_amax, key, stream
    "qt_silu_mul_quant_rowwise": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _I, _U64, _P),
    # x, g, scale, q, s_out, amax, parts, M, K, rpb, norm_eps, eps, is_bf16, sr, key, stream
    "qt_rmsnorm_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _I, _I, _U64, _P,
    ),
    # a, b, scale, q, s_out, amax, parts, M, K, rpb, eps, is_bf16, sr, key, stream
    "qt_silu_mul_quant_colwise": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _I, _U64, _P,
    ),
    # x, g, dy, dx, dg, dg_part, M, K, rpb, norm_eps, is_bf16, stream
    "qt_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, _I, _P),
    # a, b, sa, sb, out, M, N, K, a_kmajor, b_kmajor, scale_bf16, out_bf16, stream
    "qt_scaled_mm_s8": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
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


def stream() -> int:
    """The current PyTorch CUDA stream, as the pointer the kernels take."""
    return torch.cuda.current_stream().cuda_stream
