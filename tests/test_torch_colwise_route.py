"""The route B4 (``quantize_int8_colwise``) takes, on the CPU: a pure
predicate in ``ops/int8_quant.py`` (``colwise_sm90_route``) picks the
geometry of its cluster form (``csrc/int8_quant.cu::quantize_cols_cluster``:
a cluster of CTAs a strip of columns, each CTA a run of the strip's rows in
shared memory) or 0 for the first design, and the wrapper passes it to the
C entry. No card is needed: the predicate is held at the shapes the steps
launch B4 at (the Llama2-1B step's weights and unfused inputs, ViT-Giant's
weights and proj input), and the wrapper's launch path runs against a
recording stub of the library on meta tensors that pass for CUDA ones. The
kernel itself is held to its plain version on the card
(``tests/test_torch_cuda.py``)."""

import importlib

import pytest
import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.models import llama, vit
from quantized_training_tpu_torch.ops import _build

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

IQ = importlib.import_module("quantized_training_tpu_torch.ops.int8_quant")
SMS = 132  # the H100 SXM's SMs
_L, _V = llama.LLAMA2_1B, vit.VIT_GIANT
D, F, KVD = _L.hidden_size, _L.intermediate_size, _L.num_key_value_heads * _L.head_dim
VD, VF = _V.hidden_size, _V.mlp_dim
TOKENS = 4 * 2048  # the Llama2-1B step's micro-batch
VIT_TOKENS = 24 * 257  # ViT-Giant's batch of 24 at 224 px
BF16 = torch.bfloat16

# (R, C) -> (strip vectors, cluster CTAs) in bf16: the fused Llama2-1B
# step's weights (q/o, k/v, gate/up, down), the unfused layer's inputs,
# ViT-Giant's weights (qkv, proj, fc1, fc2) and proj's input
ROUTES = {
    (D, D): (8, 8), (KVD, D): (8, 8), (F, D): (4, 8), (D, F): (16, 8),
    (TOKENS, D): (4, 8), (TOKENS, F): (4, 8),
    (3 * VD, VD): (8, 8), (VD, VD): (8, 8), (VF, VD): (8, 8), (VD, VF): (16, 8),
    (VIT_TOKENS, VD): (8, 8),
}
STEP_WEIGHTS = [(D, D), (KVD, D), (F, D), (D, F)]


def _tile(R, sv, cs):
    """Bytes of a cluster CTA's tile: ceil(R / cs) rows of sv vectors."""
    return -(-R // cs) * sv * 16


def _resident(R, sv):
    """CTAs of the cluster form resident at once on the H100 (the route's
    constants: clusters of 8 reach 120 SMs)."""
    per_sm = min(IQ._SM_SHARED // (_tile(R, sv, 8) + IQ._CTA_STATIC + 1024), IQ._CTAS_PER_SM)
    return per_sm * IQ._CLUSTER_SMS


@pytest.mark.parametrize("R,C", list(ROUTES), ids=[f"{r}x{c}" for r, c in ROUTES])
def test_b4_route(R, C):
    """Every shape the steps launch B4 at takes the cluster form, at the
    strip ``ROUTES`` names: the one ``_cluster_cost`` models fastest, which
    ab_sm90_forms.py's sweep of every strip on the H100 found the fastest
    in RN and SR at the Llama2-1B step's shapes, and the fastest of RN and
    SR together at ViT-Giant's (within 0.4 us of the fastest RN)."""
    assert IQ.colwise_sm90_route(R, C, BF16) == ROUTES[(R, C)]


@pytest.mark.parametrize("R,C", list(ROUTES), ids=[f"{r}x{c}" for r, c in ROUTES])
def test_b4_geometry(R, C):
    """The geometry at each path shape: a portable cluster (8 CTAs), whole
    strips of 4, 8 or 16 vectors, the tile and the static arrays within a
    CTA's shared memory, and the least modelled cost of every strip whose
    tile fits, the narrowest on a tie."""
    sv, cs = IQ.colwise_sm90_route(R, C, BF16)
    assert cs == IQ.CLUSTER_CTAS == 8 and sv in (4, 8, 16)
    assert _tile(R, sv, cs) + IQ._CTA_STATIC <= 227 * 1024
    costs = {v: c for v in IQ._STRIP_VECTORS if (c := IQ._cluster_cost(R, C // 8, v)) is not None}
    assert costs[sv] == min(costs.values()) and all(costs[v] > costs[sv] for v in costs if v < sv)


@pytest.mark.parametrize("R,C", STEP_WEIGHTS, ids=[f"{r}x{c}" for r, c in STEP_WEIGHTS])
def test_b4_step_weights_in_one_wave(R, C):
    """At q/o, k/v and down the grid is resident at once (one wave); at
    gate/up (23 MB of bf16, near the 27 MB of shared memory the clusters
    reach) no geometry is, and the route takes the narrowest strip, whose
    second wave is the shortest."""
    sv, cs = IQ.colwise_sm90_route(R, C, BF16)
    ctas = -(-(C // 8) // sv) * cs
    if (R, C) == (F, D):
        assert all(-(-(C // 8) // v) * 8 > _resident(R, v) for v in (16, 8, 4) if _tile(R, v, 8) <= IQ._CLUSTER_MAX_TILE)
        assert sv == 4
    else:
        assert ctas <= _resident(R, sv)


def test_b4_cost_charges_only_the_ctas_an_sm_holds():
    """A wave charges the busiest SM the tiles it holds, not as many as the
    SM could: at ViT-Giant's proj weight [1536, 1536] strips of 16 vectors
    make 96 CTAs (one an SM, 96 SMs busy), strips of 8 make 192 (one or two
    an SM): the same bytes on the busiest SM, one wave each, so the costs
    tie and the narrower strip, all 120 SMs pulling bytes, is taken (7.9
    against 8.3 us on the H100, SR 10.7 against 11.2)."""
    tile16 = _tile(VD, 16, 8)
    assert IQ._cluster_cost(VD, VD // 8, 16) == IQ._WAVE_US + tile16 / IQ._SM_BYTES_PER_US
    assert IQ._cluster_cost(VD, VD // 8, 8) == IQ._WAVE_US + 2 * _tile(VD, 8, 8) / IQ._SM_BYTES_PER_US
    assert IQ._cluster_cost(VD, VD // 8, 8) == IQ._cluster_cost(VD, VD // 8, 16)
    assert IQ.colwise_sm90_route(VD, VD, BF16) == (8, 8)


def test_b4_constants_match_the_kernel():
    """The route's limits are the kernel's (``csrc/int8_quant.cu``): a CTA
    of ``kClusterThreads`` threads, ``kClusterCtasPerSm`` CTAs an SM in its
    launch bounds, its static arrays (a row of strip maxima per warp and
    two more), the largest tile, strips of at most ``kClusterMaxStrip``
    vectors and clusters of at most 8 CTAs; a route the entry would refuse
    (cudaErrorInvalidValue) is never given."""
    src = (_build.CSRC / "int8_quant.cu").read_text()
    assert f"constexpr int kClusterThreads = {IQ._CTA_THREADS};" in src
    assert f"constexpr int kClusterCtasPerSm = {IQ._CTAS_PER_SM};" in src
    assert f"constexpr int kClusterMaxStrip = {max(IQ._STRIP_VECTORS)};" in src
    assert f"constexpr size_t kClusterMaxTile = {IQ._CLUSTER_MAX_TILE // 1024} * 1024;" in src
    assert ("constexpr size_t kClusterStatic = (kClusterThreads / 32 + 2) * kClusterMaxStrip * sizeof(uint4);"
            in src)
    assert IQ._CTA_STATIC == (IQ._CTA_THREADS // 32 + 2) * max(IQ._STRIP_VECTORS) * 16
    assert "!(sv == 4 || sv == 8 || sv == 16) || cs < 1 || cs > 8 || smem > kClusterMaxTile" in src
    assert set(IQ._STRIP_VECTORS) == {4, 8, 16} and 1 <= IQ.CLUSTER_CTAS <= 8


@pytest.mark.parametrize("R,C,dtype,route", [
    (2048, 2048, torch.float32, (16, 8)),  # fp32: 4 values a vector, 512 vectors a row
    (5632, 2048, torch.float32, (4, 8)),
    (64, 64, BF16, (4, 8)),  # 8 vectors a row: two strips of 4
    (3, 2048, BF16, (8, 8)),  # rows below the cluster's CTAs: empty CTAs take part
    (1000, 2048, BF16, (8, 8)),  # a ragged row count
    (8 * 3552, 2048, BF16, (4, 8)),  # the tallest input the form takes
    (8 * 3552 + 1, 2048, BF16, 0),  # a taller one keeps the first design
    (2048, 2047, BF16, 0),  # C off a whole number of vectors
    (2048, 2052, torch.float32, (16, 8)),  # fp32 C of 513 vectors: a ragged last strip
    (2048, 2050, BF16, 0),
])
def test_b4_route_edges(R, C, dtype, route):
    """The predicate's edges: fp32's vectors, a row of 8 vectors, rows below
    the cluster, the tallest tile, C off a whole number of vectors (the
    first design)."""
    assert IQ.colwise_sm90_route(R, C, dtype) == route


def test_b4_route_is_pure():
    """The route reads only (R, C, dtype): the same answer each call, at
    every C the 2048-row weights can have, and 0 exactly where C is off a
    whole number of bf16 vectors (below the tile bound)."""
    for C in range(1, 6000, 37):
        got = IQ.colwise_sm90_route(2048, C, BF16)
        assert got == IQ.colwise_sm90_route(2048, C, BF16)
        assert (got == 0) == (C % 8 != 0)


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
    taken for CUDA ones by the wrapper's device check."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: self.device.type == "meta"))
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("R,C,dtype", [(F, D, BF16), (KVD, D, BF16), (D, F, BF16), (TOKENS, F, BF16),
                                       (1000, 2048, torch.float32), (2048, 2047, BF16), (8 * 3552 + 8, 256, BF16)])
def test_b4_passes_its_route(library, R, C, dtype, sr):
    """B4's wrapper passes ``colwise_sm90_route(R, C)`` (0, 0 for the first
    design) as the two arguments before the stream, one argument per
    ``_SIGNATURES`` entry; it allocates the first design's fp32 [C] buffer
    only there; and counts the launch per form and, on the cluster route,
    again."""
    key = 3 if sr else None
    x = torch.empty((R, C), dtype=dtype, device="meta")
    q, s = ops.quantize_int8_colwise(x, sr=sr, key=key)
    (name, args), = library.calls
    route = IQ.colwise_sm90_route(R, C, dtype)
    assert name == "qt_quantize_int8_colwise" and len(args) == len(_build._SIGNATURES[name]) == 13
    assert args[4:10] == (R, C, IQ.EPS, int(dtype == BF16), int(sr), key or 0)
    assert args[10:] == (*(route or (0, 0)), 0)
    assert q.shape == (R, C) and q.dtype == torch.int8 and s.shape == (1, C) and s.dtype == dtype
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"quantize_int8_colwise{t}"] == 1 and counts[f"quantize_int8_colwise{t}_sm90"] == int(bool(route))
    assert sum(counts.values()) == 1 + int(bool(route))


def test_b4_amax_scratch_only_for_the_first_design(library, monkeypatch):
    """The fp32 [C] buffer of the first design's atomicMax merge is
    allocated only where the first design runs."""
    sizes = []
    real = torch.empty

    def recording(*shape, **kw):
        t = real(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            sizes.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", recording)
    ops.quantize_int8_colwise(real((F, D), dtype=BF16, device="meta"))
    ops.quantize_int8_colwise(real((F, D - 1), dtype=BF16, device="meta"))
    assert sizes == [0, D - 1]


def test_b4_unaligned_view_keeps_the_first_design(library):
    """A view that starts off a 16-byte boundary takes the first design,
    whatever its shape."""
    base = torch.empty((2049, 2048), dtype=BF16, device="meta").reshape(-1)
    x = base[1:1 + 2048 * 2048].view(2048, 2048)
    assert x.data_ptr() % 16 and IQ.colwise_sm90_route(2048, 2048, BF16)
    ops.quantize_int8_colwise(x, sr=True, key=1)
    (name, args), = library.calls
    assert args[10:] == (0, 0, 0)
    counts = ops.launch_counts()
    assert counts["quantize_int8_colwise_sr"] == 1 and counts["quantize_int8_colwise_sr_sm90"] == 0
