"""The native prefetching token loader (counterpart of
``quantized_training_tpu/data/native_loader.py``, :20-104): a ctypes binding
of ``cpp/tokenloader.cpp``.

The C++ library mmaps the ``.bin`` token shards, draws a seeded schedule of
(shard, slice) windows and assembles int32 (tokens, labels) batches in
background threads; its position is two integers, (epoch, cursor).

:func:`library_path` builds the library at first use with the ``Makefile``'s
flags (``g++ -O3 -std=c++17 -fPIC -pthread -Wall -shared``; ``$CXX`` names
another compiler) into ``build/tokenloader/`` at the repository root, named
by a hash of the source, so an edited source rebuilds and an unchanged one
is reused. A failed build raises: there is no fallback to the Python
pipeline.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "cpp" / "tokenloader.cpp"
BUILD_DIR = REPO / "build" / "tokenloader"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")


@functools.lru_cache(maxsize=None)
def library_path() -> Path:
    """The built library, compiled first if this source has not been."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libtokenloader_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native loader: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native loader: build failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
    tmp.replace(out)  # atomic: a concurrent build finds a whole library or none
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    lib.tl_create.restype = ctypes.c_void_p
    lib.tl_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
                              ctypes.c_int]
    lib.tl_next.restype = ctypes.c_int
    lib.tl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tl_state.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.tl_restore.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.tl_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeTokenLoader:
    """Batched (tokens, labels) int32 stream over a directory of ``.bin``
    shards, prefetched by ``n_threads`` background threads, with (epoch,
    cursor) resume state. ``eval`` walks the windows once, in order."""

    def __init__(self, dataset_dir: str, seq_len: int, batch_size: int, seed: int = 2024, n_threads: int = 2,
                 eval: bool = False):
        self._lib = _load()
        self.seq_len = seq_len
        self.batch_size = batch_size
        self._h = self._lib.tl_create(str(dataset_dir).encode(), seq_len, batch_size, seed, n_threads, int(eval))
        if not self._h:
            raise RuntimeError(f"tl_create failed for {dataset_dir}")

    def __iter__(self):
        while True:
            tokens = np.empty((self.batch_size, self.seq_len), np.int32)
            labels = np.empty((self.batch_size, self.seq_len), np.int32)
            if not self._lib.tl_next(self._h, tokens.ctypes.data_as(ctypes.c_void_p),
                                     labels.ctypes.data_as(ctypes.c_void_p)):
                return
            yield tokens, labels

    def state_dict(self) -> dict:
        epoch, cursor = ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.tl_state(self._h, ctypes.byref(epoch), ctypes.byref(cursor))
        return {"epoch": epoch.value, "cursor": cursor.value}

    def load_state_dict(self, state: dict) -> None:
        self._lib.tl_restore(self._h, state["epoch"], state["cursor"])

    def close(self) -> None:
        if self._h:
            self._lib.tl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
