"""The route B14 (``ungroup_amax`` and ``ungroup_quant``, the attention
output's absmax and int8 quantize with its ungrouping) takes, on the CPU:
both pick between the persistent row walk of ``csrc/rope.cu``
(``ungroup_absmax_walk``, ``ungroup_quant_walk``) and the first design
(``ungroup_absmax``, ``ungroup_quant``) by the pure predicate
``ops/rope.py::ungroup_sm90_route``, which gives the threads a row (0: the
first design) and is passed to the C entry with the grid. No card is
needed: the predicate and the walk's geometry are held at every width the
wrappers take, and the wrappers' launch path runs against a recording stub
of the library, on meta tensors that pass for CUDA ones, in both memory
layouts of the grouped tensor. The kernels themselves are held to their
first design and their plain versions on the card
(``tests/test_torch_cuda.py -k b14``)."""

import importlib

import pytest
import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import _build

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

ROPE = importlib.import_module("quantized_training_tpu_torch.ops.rope")
FP = importlib.import_module("quantized_training_tpu_torch.ops.fused_producers")
SMS = 132  # the H100 SXM's SMs
_L = llama.LLAMA2_1B
# the small Llama of the port's layer tests: 4 heads of 64, K 256
_SMALL_K, _SMALL_HD = 256, 64
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("K,hd,dtype,tpr", [
    (_L.num_attention_heads * _L.head_dim, _L.head_dim, BF16, 64),  # Llama2-1B: 256 vectors, 64 x 4
    (_L.num_attention_heads * _L.head_dim, _L.head_dim, F32, 128),  # 512 vectors, 128 x 4
    (_SMALL_K, _SMALL_HD, BF16, 32),  # 32 vectors, 32 x 1
    (_SMALL_K, _SMALL_HD, F32, 32),  # 64 vectors, 32 x 2
    (1024, 64, BF16, 32), (4096, 128, BF16, 128), (8192, 128, BF16, 256), (512, 64, BF16, 32),
    (384, 64, BF16, 0),  # 48 vectors: 12 x 4, 24 x 2, 48 x 1 are no whole warps
    (16384, 128, BF16, 0),  # 2048 vectors: 512 x 4 is over the block
    (3072, 128, BF16, 0),  # 384 vectors: 96 x 4 does not divide the block
    (2048, 4, BF16, 0),  # a head of half a vector
    (2048, 4, F32, 128),  # a head of one fp32 vector
    (2048, 64, torch.float16, 0),  # a dtype the kernels do not take
])
def test_ungroup_route(K, hd, dtype, tpr):
    """B14 at the Llama2-1B step's attention width (bf16 K 2048) takes the
    row walk at 64 threads of four vectors (B7's geometry), fp32 at 128 of
    four; the small Llama's K 256 at 32 threads; widths no whole warps in
    groups that divide the block can tile, heads that split a vector, and
    other dtypes keep the first design."""
    assert ROPE.ungroup_sm90_route(K, hd, dtype) == tpr


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_ungroup_walk_leaves_no_lane_idle(dtype):
    """At every width the wrappers take (H heads of hd, hd a multiple of two
    vectors), a route other than 0 is whole warps in groups that divide the
    block of 256, each thread holding one of ``UNGROUP_VECTORS`` vectors of
    every row, tpr times that many the row's vectors, so that no lane of the
    walk idles; and the route takes the first of those that tiles."""
    n = 16 // dtype.itemsize
    taken = 0
    for hd in range(2 * n, 513, 2 * n):
        for H in range(1, 129):
            K = H * hd
            tpr = ROPE.ungroup_sm90_route(K, hd, dtype)
            tiling = [v for v in ROPE.UNGROUP_VECTORS if K // n % v == 0 and K // n // v in (32, 64, 128, 256)]
            if not tpr:
                assert not tiling, (K, hd)
                continue
            taken += 1
            assert tpr % 32 == 0 and 256 % tpr == 0
            assert K // n == tpr * tiling[0]
    assert taken >= 30


class _Library:
    """Records every C entry it is asked for, with its arguments; each
    launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def library(monkeypatch):
    """The recording stub in place of the built library, with meta tensors
    taken for CUDA ones by the wrappers' device checks and an H100's SMs;
    ``lib.parts`` records the shape of every fp32 2-D scratch the wrappers
    allocate."""
    lib = _Library()
    lib.parts = []
    empty = torch.empty

    def recording_empty(shape, *args, **kwargs):
        if kwargs.get("dtype") == torch.float32 and len(shape) == 2 and shape[0] != 1:
            lib.parts.append(tuple(shape))
        return empty(shape, *args, **kwargs)

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(ROPE, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(ROPE.torch, "empty", recording_empty)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: self.device.type == "meta"))
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


def _grouped(B, S, H, KV, hd, dtype, layout):
    """A grouped [B, KV, G, S, hd] meta tensor over [B, S, H, hd] memory (the
    layout SDPA returns in the step) or [B, H, S, hd] memory."""
    if layout == "bshd":
        x = torch.empty((B, S, H, hd), dtype=dtype, device="meta")
        return x.view(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    return torch.empty((B, H, S, hd), dtype=dtype, device="meta").view(B, KV, H // KV, S, hd)


_SHAPES = [(4, 2048, 32, 4, 64, BF16), (2, 500, 32, 4, 64, BF16), (2, 64, 32, 4, 64, F32), (2, 64, 4, 2, 64, BF16),
           (2, 64, 6, 2, 64, BF16)]


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("B,S,H,KV,hd,dtype", _SHAPES)
def test_b14_absmax_passes_its_route(library, B, S, H, KV, hd, dtype, layout):
    """``ungroup_amax`` passes ``ungroup_sm90_route(H hd, hd)`` and the
    walk's grid as the two arguments before the stream, one argument per
    ``_SIGNATURES`` entry, the grouped tensor's (b, s, h) strides in either
    memory layout, and a parts scratch of one row a CTA on the walk or
    ``_rows_per_block`` rows a block on the first design; it counts the
    launch, and on the walk again."""
    y = _grouped(B, S, H, KV, hd, dtype, layout)
    row, col = ops.ungroup_amax(y)
    (name, args), = library.calls
    M, K = B * S, H * hd
    tpr = ROPE.ungroup_sm90_route(K, hd, dtype)
    ctas = FP.row_walk_ctas(M, tpr, SMS, ROPE.UNGROUP_CTAS_PER_SM) if tpr else 0
    assert name == "qt_ungroup_amax" and len(args) == len(_build._SIGNATURES[name]) == 16
    strides = (S * H * hd, H * hd, hd) if layout == "bshd" else (H * S * hd, hd, S * hd)
    assert args[1:8] == (*strides, B, S, H, hd)
    assert args[11:] == (FP._rows_per_block(M), int(dtype == BF16), tpr, ctas, 0)
    assert library.parts == [(ctas if tpr else -(-M // FP._rows_per_block(M)), K)]
    assert row.shape == (B, S, 1) and col.shape == (1, K)
    counts = ops.launch_counts()
    assert counts["ungroup_amax"] == 1 and counts["ungroup_amax_sm90"] == int(bool(tpr))


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("B,S,H,KV,hd,dtype", _SHAPES)
def test_b14_quant_passes_its_route(library, B, S, H, KV, hd, dtype, layout, axis, sr):
    """``ungroup_quant`` along rows and columns, RN and SR, passes the route
    and the grid as the two arguments before the stream (one argument per
    ``_SIGNATURES`` entry), allocates no scratch, and counts the launch per
    form and, on the walk, again in ``ungroup_quant_sm90`` or
    ``ungroup_quant_sr_sm90``."""
    y = _grouped(B, S, H, KV, hd, dtype, layout)
    M, K = B * S, H * hd
    scale = torch.empty((B, S, 1) if axis == 1 else (1, K), dtype=torch.float32, device="meta")
    key = 2**63 + 11 if sr else None
    q = ops.ungroup_quant(y, scale, axis=axis, sr=sr, key=key, eps=1e-10)
    (name, args), = library.calls
    tpr = ROPE.ungroup_sm90_route(K, hd, dtype)
    ctas = FP.row_walk_ctas(M, tpr, SMS, ROPE.UNGROUP_CTAS_PER_SM) if tpr else 0
    assert name == "qt_ungroup_quant" and len(args) == len(_build._SIGNATURES[name]) == 19
    assert args[4:8] == (B, S, H, hd)
    assert args[10:13] == (FP._rows_per_block(M), axis, 1e-10)
    assert args[13:] == (int(dtype == BF16), int(sr), key or 0, tpr, ctas, 0)
    assert library.parts == [] and q.shape == (B, S, K) and q.dtype == torch.int8
    counts = ops.launch_counts()
    t = "_sr" if sr else ""
    assert counts[f"ungroup_quant{t}"] == 1 and counts[f"ungroup_quant{t}_sm90"] == int(bool(tpr))
    other = "" if sr else "_sr"
    assert counts[f"ungroup_quant{other}"] == counts[f"ungroup_quant{other}_sm90"] == 0


def test_b14_first_design_when_the_route_is_forced_off(library, monkeypatch):
    """With the predicate forced to 0 (as ``chip_smoke.py::first_design``
    does for its A/B) both wrappers pass route 0 and grid 0, the absmax a
    parts scratch of ``_rows_per_block`` rows a block, and count no walk
    launch."""
    monkeypatch.setattr(ROPE, "ungroup_sm90_route", lambda K, hd, dtype: 0)
    y = _grouped(4, 2048, 32, 4, 64, BF16, "bshd")
    row, col = ops.ungroup_amax(y)
    ops.ungroup_quant(y, row, axis=1)
    ops.ungroup_quant(y, col, axis=0, sr=True, key=3)
    assert [c[1][-3:] for c in library.calls] == [(0, 0, 0)] * 3
    assert library.parts == [(-(-8192 // FP._rows_per_block(8192)), 2048)]
    counts = ops.launch_counts()
    assert counts["ungroup_amax"] == counts["ungroup_quant"] == counts["ungroup_quant_sr"] == 1
    assert counts["ungroup_amax_sm90"] == counts["ungroup_quant_sm90"] == counts["ungroup_quant_sr_sm90"] == 0


def test_b14_walk_refuses_offsets_past_32_bits(library):
    """A grouped view whose heads lie 2**31 elements or more apart (a view
    into a larger buffer) keeps the first design, whose offsets are 64-bit:
    the walk keeps a head's offset in 32 bits."""
    # 32 heads of 64, 2**27 elements apart: K 2048, which the route takes
    big = torch.empty((2**33,), dtype=BF16, device="meta").as_strided((1, 4, 8, 16, 64),
                                                                      (0, 2**30, 2**27, 64, 1))
    assert ROPE.ungroup_sm90_route(2048, 64, BF16) == 64
    ops.ungroup_amax(big)
    (name, args), = library.calls
    assert args[-3:] == (0, 0, 0)


def test_b14_constants_match_the_kernels():
    """The vectors a thread the route tries, in its order, are the kernels'
    (``csrc/rope.cu::kUngroupVs``), and the CTAs an SM by which the wrappers
    size the grid are those the walks' launch bounds keep
    (``kUngroupCtasPerSm``)."""
    src = (_build.CSRC / "rope.cu").read_text()
    assert f"constexpr int kUngroupVs[] = {{{', '.join(map(str, ROPE.UNGROUP_VECTORS))}}};" in src
    assert f"constexpr int kUngroupCtasPerSm = {ROPE.UNGROUP_CTAS_PER_SM};" in src
    for kernel in ("ungroup_absmax_walk(", "ungroup_quant_walk("):
        assert "__launch_bounds__(kThreads, kUngroupCtasPerSm)\n" + kernel in src
    assert src.count("case kUngroupVs[") == len(ROPE.UNGROUP_VECTORS)
