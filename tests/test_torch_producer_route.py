"""The route B7 (``rmsnorm_quant_rowwise``), B8 given scales
(``rmsnorm_quant_colwise``), B9's row form (``silu_mul_quant_rowwise``) and
its given-scales column form (``silu_mul_quant_colwise``), B10
(``rmsnorm_bwd``), B11 (``silu_mul_bwd_quant_rowwise``), B12 given scales
(``silu_mul_bwd_quant_colwise``) and B18's row and given-scales column forms
(``layernorm_quant_*``, ``gelu_quant_*``) take, on the CPU: each picks
between the persistent row walk of ``csrc/fused_producers.cu``
(``rmsnorm_rows``, ``rmsnorm_cols``, ``elementwise_rows``,
``rmsnorm_bwd_walk``, ``silu_bwd_rows``, ``silu_bwd_cols``,
``layernorm_rows``, ``layernorm_cols``, ``elementwise_cols``) and the first
design (``row_quant``, ``col_quant``, ``rmsnorm_bwd_rows``,
``silu_bwd_row_quant``, ``silu_bwd_col_quant``) by a pure predicate in
``ops/fused_producers.py``,
which gives the threads a row (0: the first design) and is passed to the C
entry with the grid. No card is needed: the predicates and the geometry are
held at every width the wrappers take, and the wrappers' launch path runs
against a recording stub of the library, on meta tensors that pass for CUDA
ones. The kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``)."""

import importlib

import pytest
import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.models.vit import VIT_GIANT
from quantized_training_tpu_torch.ops import _build

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

FP = importlib.import_module("quantized_training_tpu_torch.ops.fused_producers")
SMS = 132  # the H100 SXM's SMs
_L = llama.LLAMA2_1B
DTYPES = [torch.bfloat16, torch.float32]
# every K the wrappers take: multiples of 128 up to each kernel's shared-memory bound
NORM_KS = range(128, FP.MAX_K + 1, 128)
SILU_KS = range(128, FP.MAX_K_BWD + 1, 128)


def _vectors(K, dtype):
    return K * dtype.itemsize // 16


@pytest.mark.parametrize("K,dtype,tpr", [(_L.hidden_size, torch.bfloat16, 64), (1024, torch.bfloat16, 32),
                                         (4096, torch.bfloat16, 128), (8192, torch.bfloat16, 256),
                                         (2048, torch.float32, 128), (128, torch.bfloat16, 0),
                                         (640, torch.bfloat16, 0), (5632, torch.bfloat16, 0), (16384, torch.bfloat16, 0)])
def test_b7_route(K, dtype, tpr):
    """B7 at the Llama2-1B step's norm width (2048, bf16) takes the row walk
    at 64 threads a row; widths whose vectors are not 32, 64, 128 or 256
    times ``NORM_ROW_VECTORS`` keep the first design."""
    assert FP.norm_rows_sm90_route(K, dtype) == tpr


@pytest.mark.parametrize("K,dtype,tpr", [(_L.intermediate_size, torch.bfloat16, 352), (2048, torch.bfloat16, 128),
                                         (256, torch.bfloat16, 32), (6144, torch.bfloat16, 384),
                                         (8192, torch.bfloat16, 0), (2048, torch.float32, 256),
                                         (128, torch.bfloat16, 0), (640, torch.bfloat16, 0),
                                         (1536, torch.bfloat16, 0), (5632, torch.float32, 0)])
def test_b11_route(K, dtype, tpr):
    """B11 at the Llama2-1B step's FFN width (5632, bf16) takes the row walk
    at 352 threads a row (two vectors each); one vector a thread where two
    leave no whole layout (K = 256); widths the walk cannot tile with whole
    warps or hold in one block (K = 8192) keep the first design."""
    assert FP.silu_bwd_rows_sm90_route(K, dtype) == tpr


@pytest.mark.parametrize("K,dtype,tpr", [(_L.intermediate_size, torch.bfloat16, 352), (2048, torch.bfloat16, 128),
                                         (256, torch.bfloat16, 32), (6144, torch.bfloat16, 384),
                                         (8192, torch.bfloat16, 0), (2048, torch.float32, 256),
                                         (128, torch.bfloat16, 0), (640, torch.bfloat16, 0),
                                         (1536, torch.bfloat16, 0), (5632, torch.float32, 0)])
def test_b9_route(K, dtype, tpr):
    """B9's row form at the Llama2-1B step's FFN width (5632, bf16) takes
    the row walk at 352 threads a row (two vectors each), B11's layout;
    widths the walk cannot tile with whole warps or hold in one block (K =
    8192, 640, 1536) keep the first design."""
    assert FP.silu_rows_sm90_route(K, dtype) == tpr


@pytest.mark.parametrize("dtype", DTYPES)
def test_b9_geometry_leaves_no_lane_idle(dtype):
    """At every K the route takes: whole warps a row, one or two vectors a
    thread covering the row exactly, a block of max(tpr, 256) threads made of
    whole groups, within the block size the kernel's registers allow at
    ``silu_rows_ctas_per_sm`` CTAs an SM (two for the RN form at two
    vectors a thread, else one, as the launch bounds keep; 2,048 threads an
    SM at most); the path's width is among them, one group a CTA."""
    taken = []
    for K in NORM_KS:
        tpr = FP.silu_rows_sm90_route(K, dtype)
        if tpr:
            v, cta = _vectors(K, dtype) // tpr, max(tpr, 256)
            assert tpr % 32 == 0 and v * tpr == _vectors(K, dtype) and v in FP._SILU_ROWS_MAX_CTA, (K, tpr)
            assert cta % tpr == 0 and cta <= FP._SILU_ROWS_MAX_CTA[v], (K, tpr)
            for sr in (False, True):
                per_sm = FP.silu_rows_ctas_per_sm(K, dtype, sr)
                assert per_sm == (FP.SILU_ROWS_CTAS_PER_SM if v == 2 and not sr else 1), (K, tpr, sr)
                assert cta * per_sm <= 2048, (K, tpr, sr)
            taken.append(K)
    assert taken and (dtype != torch.bfloat16 or _L.intermediate_size in taken)
    assert dtype != torch.bfloat16 or FP.silu_rows_sm90_route(_L.intermediate_size, dtype) == 352


@pytest.mark.parametrize("dtype", DTYPES)
def test_b7_geometry_leaves_no_lane_idle(dtype):
    """At every K the route takes: whole warps a row, exactly
    ``NORM_ROW_VECTORS`` vectors a thread, groups that fill the block of 256
    and divide it (what keeps the sum of squares in the first design's
    order); the path's width is among them."""
    taken = []
    for K in NORM_KS:
        tpr = FP.norm_rows_sm90_route(K, dtype)
        if tpr:
            assert tpr % 32 == 0 and 256 % tpr == 0, (K, tpr)
            assert tpr * FP.NORM_ROW_VECTORS == _vectors(K, dtype), (K, tpr)
            taken.append(K)
    assert taken and (dtype != torch.bfloat16 or _L.hidden_size in taken)


@pytest.mark.parametrize("dtype", DTYPES)
def test_b11_geometry_leaves_no_lane_idle(dtype):
    """At every K the route takes: whole warps a row, one or two vectors a
    thread covering the row exactly, a block of max(tpr, 256) threads made of
    whole groups, within the block size the kernel's registers allow."""
    taken = []
    for K in SILU_KS:
        tpr = FP.silu_bwd_rows_sm90_route(K, dtype)
        if tpr:
            v, cta = _vectors(K, dtype) // tpr, max(tpr, 256)
            assert tpr % 32 == 0 and v * tpr == _vectors(K, dtype) and v in FP._SILU_ROWS_MAX_CTA, (K, tpr)
            assert cta % tpr == 0 and cta <= FP._SILU_ROWS_MAX_CTA[v], (K, tpr)
            taken.append(K)
    assert taken and (dtype != torch.bfloat16 or _L.intermediate_size in taken)


@pytest.mark.parametrize("M,tpr,per_sm,ctas", [(8192, 64, FP.NORM_CTAS_PER_SM, 2 * SMS), (8192, 352, 1, SMS),
                                               (8192, 352, FP.SILU_ROWS_CTAS_PER_SM, 2 * SMS), (256, 352, 2, 256),
                                               (8192, 128, 1, SMS), (1000, 64, 2, 250), (7, 64, 2, 2), (7, 704, 1, 7),
                                               (1, 32, 2, 1)])
def test_row_walk_grid(M, tpr, per_sm, ctas):
    """The walk's grid: a block of max(tpr, 256) threads, its groups one row
    each at a time, at most ``per_sm`` blocks an SM (B7 two, B11 one, B9's
    row form two)."""
    assert FP.row_walk_ctas(M, tpr, SMS, per_sm) == ctas


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
    taken for CUDA ones by the wrappers' device checks and an H100's SMs."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(FP, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: self.device.type == "meta"))
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("amax", [False, True])
@pytest.mark.parametrize("M,K,dtype", [(8192, 2048, torch.bfloat16), (1000, 2048, torch.bfloat16),
                                       (256, 2048, torch.float32), (96, 640, torch.bfloat16)])
def test_b7_passes_its_route(library, M, K, dtype, amax, sr):
    """B7's wrapper passes ``norm_rows_sm90_route(K)`` and the walk's grid
    as the two arguments before the stream, one argument per
    ``_SIGNATURES`` entry, its rows a block for the first design, and counts
    the launch per form and, on the row walk, again."""
    key = 99 if sr else None
    out = ops.rmsnorm_quant_rowwise(_meta((M, K), dtype), _meta((K,), dtype), sr=sr, key=key, with_col_amax=amax,
                                    norm_eps=1e-6)
    (name, args), = library.calls
    tpr = FP.norm_rows_sm90_route(K, dtype)
    assert name == "qt_rmsnorm_quant_rowwise" and len(args) == len(_build._SIGNATURES[name]) == 18
    assert args[6:11] == (M, K, FP._rows_per_block(M), 1e-6, FP.EPS)
    assert args[11:15] == (int(dtype == torch.bfloat16), int(sr), int(amax), key or 0)
    assert args[15:] == (tpr, FP.row_walk_ctas(M, tpr, SMS, FP.NORM_CTAS_PER_SM) if tpr else 0, 0)
    assert [t.shape for t in out] == [(M, K), (M, 1), (1, K)][:3 if amax else 2]
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"rmsnorm_quant_rowwise{t}"] == 1 and counts[f"rmsnorm_quant_rowwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("amax,copy", [(True, False), (False, True)])
@pytest.mark.parametrize("M,K,dtype", [(8192, 5632, torch.bfloat16), (1000, 5632, torch.bfloat16),
                                       (256, 2048, torch.float32), (96, 640, torch.bfloat16)])
def test_b11_passes_its_route(library, M, K, dtype, amax, copy, sr):
    """B11's wrapper passes ``silu_bwd_rows_sm90_route(K)`` and the walk's
    grid as the two arguments before the stream, one argument per
    ``_SIGNATURES`` entry, and counts the launch per form and, on the row
    walk, again; both of its forms (column maxima, copies) take the route."""
    key = 7 if sr else None
    out = ops.silu_mul_bwd_quant_rowwise(_meta((M, K), dtype), _meta((M, K), dtype), _meta((M, K), dtype), sr=sr,
                                         key=key, with_amax=amax, with_bf16=copy)
    (name, args), = library.calls
    tpr = FP.silu_bwd_rows_sm90_route(K, dtype)
    assert name == "qt_silu_mul_bwd_quant_rowwise" and len(args) == len(_build._SIGNATURES[name]) == 23
    assert args[11:20] == (M, K, FP._rows_per_block(M), FP.EPS, int(dtype == torch.bfloat16), int(sr), int(amax),
                           int(copy), key or 0)
    assert args[20:] == (tpr, FP.row_walk_ctas(M, tpr, SMS, FP.SILU_CTAS_PER_SM) if tpr else 0, 0)
    assert len(out) == 6 and out[0].shape == out[2].shape == (M, K)
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"silu_mul_bwd_quant_rowwise{t}"] == 1
    assert counts[f"silu_mul_bwd_quant_rowwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("amax", [False, True])
@pytest.mark.parametrize("M,K,dtype", [(8192, 5632, torch.bfloat16), (256, 5632, torch.bfloat16),
                                       (1000, 2048, torch.float32), (96, 640, torch.bfloat16),
                                       (8192, 2560, torch.bfloat16)])
def test_b9_passes_its_route(library, M, K, dtype, amax, sr):
    """B9's row wrapper passes ``silu_rows_sm90_route(K)`` and the walk's
    grid (``silu_rows_ctas_per_sm`` CTAs an SM: two for the RN form at two
    vectors a thread, else one) as the two arguments before the stream, one
    argument per ``_SIGNATURES`` entry, its rows a block for
    the first design, the column maxima' scratch one row a CTA on the walk,
    and counts the launch per form and, on the row walk, again; with and
    without the column absmax, in RN and SR."""
    key = 5 if sr else None
    out = ops.silu_mul_quant_rowwise(_meta((M, K), dtype), _meta((M, K), dtype), sr=sr, key=key,
                                     with_col_amax=amax)
    (name, args), = library.calls
    tpr = FP.silu_rows_sm90_route(K, dtype)
    per_sm = FP.SILU_ROWS_CTAS_PER_SM if _vectors(K, dtype) == 2 * tpr and not sr else 1
    ctas = FP.row_walk_ctas(M, tpr, SMS, per_sm) if tpr else 0
    assert name == "qt_silu_mul_quant_rowwise" and len(args) == len(_build._SIGNATURES[name]) == 17
    assert args[6:14] == (M, K, FP._rows_per_block(M), FP.EPS, int(dtype == torch.bfloat16), int(sr), int(amax),
                          key or 0)
    assert args[14:] == (tpr, ctas, 0)
    assert [t.shape for t in out] == [(M, K), (M, 1), (1, K)][:3 if amax else 2]
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"silu_mul_quant_rowwise{t}"] == 1 and counts[f"silu_mul_quant_rowwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)


def test_b9_ctas_per_sm_match_the_launch_bounds():
    """The CTAs an SM by which the wrapper sizes B9-row's grid are those
    its kernel's launch bounds keep (``csrc/fused_producers.cu``:
    ``kSiluCtasPerSm`` in the RN form at two vectors a thread, else one), so
    the persistent grid stays resident: one CTA an SM at one vector a
    thread (bf16 K 2560, 320 threads a row) and in the SR form."""
    src = (_build.CSRC / "fused_producers.cu").read_text()
    assert f"constexpr int kSiluCtasPerSm = {FP.SILU_ROWS_CTAS_PER_SM};" in src
    assert "constexpr int silu_rows_ctas() { return V == 1 || SR ? 1 : kSiluCtasPerSm; }" in src
    assert FP.silu_rows_sm90_route(2560, torch.bfloat16) == 320
    assert FP.silu_rows_ctas_per_sm(2560, torch.bfloat16, False) == 1
    assert FP.silu_rows_ctas_per_sm(_L.intermediate_size, torch.bfloat16, False) == 2
    assert FP.silu_rows_ctas_per_sm(_L.intermediate_size, torch.bfloat16, True) == 1


def test_b9_walk_scratch(library, monkeypatch):
    """The column maxima' scratch B9's row form allocates: [CTAs, K] on the
    walk (two CTAs an SM, the SR form one), [blocks, K] on the first design
    (the route forced to 0), nothing without the column absmax."""
    shapes = []
    real = FP._route_parts

    def recording(M, K, device, needed, tpr, per_sm):
        ctas, parts = real(M, K, device, needed, tpr, per_sm)
        shapes.append((ctas, tuple(parts.shape), per_sm))
        return ctas, parts
    monkeypatch.setattr(FP, "_route_parts", recording)
    a = _meta((8192, 5632))
    ops.silu_mul_quant_rowwise(a, a, with_col_amax=True)
    ops.silu_mul_quant_rowwise(a, a)
    ops.silu_mul_quant_rowwise(a, a, with_col_amax=True, sr=True, key=1)
    monkeypatch.setattr(FP, "silu_rows_sm90_route", lambda K, dtype: 0)
    ops.silu_mul_quant_rowwise(a, a, with_col_amax=True)
    blocks = -(-8192 // FP._rows_per_block(8192))
    assert shapes == [(2 * SMS, (2 * SMS, 5632), 2), (2 * SMS, (0,), 2), (SMS, (SMS, 5632), 1),
                      (0, (blocks, 5632), 1)]
    assert library.calls[3][1][14:16] == (0, 0)


# (LayerNorm width, GELU width, both routed): a width the walks cannot tile,
# and ViT-Giant's hidden and MLP widths
_B18_WIDTHS = [(640, 640, False), (VIT_GIANT.hidden_size, VIT_GIANT.mlp_dim, True)]


@pytest.mark.parametrize("K_ln,K_gelu,routed", _B18_WIDTHS)
def test_other_row_producers_keep_their_entries(library, K_ln, K_gelu, routed):
    """B18's GELU and LayerNorm row forms share the Python launch path of B7
    and B9, and their entries take the route arguments (16 and 19 of them):
    at a width the walk cannot tile (bf16 K 640) route 0, and nothing counts
    a row-walk launch for them; at ViT-Giant's widths (LayerNorm 1536, GELU
    6144) their routes and grids, counted on the walk. B9's row form at
    K 2048 takes its own entry's route arguments and counts there."""
    M = 6400
    a, x, g = _meta((M, K_gelu)), _meta((M, K_ln)), _meta((K_ln,))
    ops.gelu_quant_rowwise(a, with_col_amax=True)
    ops.layernorm_quant_rowwise(x, g, g, with_col_amax=True)
    for name, args in library.calls:
        assert len(args) == len(_build._SIGNATURES[name])
    assert [n for n, _ in library.calls] == ["qt_gelu_quant_rowwise", "qt_layernorm_quant_rowwise"]
    assert len(_build._SIGNATURES["qt_gelu_quant_rowwise"]) == 16
    assert len(_build._SIGNATURES["qt_layernorm_quant_rowwise"]) == 19
    t_gelu = FP.gelu_rows_sm90_route(K_gelu, torch.bfloat16)
    t_ln = FP.layernorm_rows_sm90_route(K_ln, torch.bfloat16)
    assert bool(t_gelu) == bool(t_ln) == routed
    gelu_per_sm = FP.gelu_ctas_per_sm(K_gelu, torch.bfloat16, False)
    assert library.calls[0][1][13:] == (t_gelu, FP.row_walk_ctas(M, t_gelu, SMS, gelu_per_sm) if routed else 0, 0)
    assert library.calls[1][1][16:] == (t_ln, FP.row_walk_ctas(M, t_ln, SMS, 2) if routed else 0, 0)
    counts = ops.launch_counts()
    assert counts["gelu_quant_rowwise"] == counts["layernorm_quant_rowwise"] == 1
    assert counts["gelu_quant_rowwise_sm90"] == counts["layernorm_quant_rowwise_sm90"] == int(routed)
    assert sum(v for k, v in counts.items() if k.endswith("_sm90")) == 2 * int(routed)
    a = _meta((8192, 2048))
    ops.silu_mul_quant_rowwise(a, a, with_col_amax=True)
    name, args = library.calls[-1]
    tpr = FP.silu_rows_sm90_route(2048, torch.bfloat16)
    assert name == "qt_silu_mul_quant_rowwise" and args[14:] == (tpr, FP.row_walk_ctas(8192, tpr, SMS, 2), 0)
    assert ops.launch_counts()["silu_mul_quant_rowwise_sm90"] == 1


@pytest.mark.parametrize("K,dtype,tpr", [(_L.hidden_size, torch.bfloat16, 64), (1024, torch.bfloat16, 32),
                                         (8192, torch.bfloat16, 256), (2048, torch.float32, 128),
                                         (640, torch.bfloat16, 0), (16384, torch.bfloat16, 0)])
def test_b8_route(K, dtype, tpr):
    """B8 given scales takes B7's layouts: 64 threads a row at the Llama2-1B
    step's norm width (2048, bf16), the first design where B7 keeps it."""
    assert FP.norm_cols_sm90_route(K, dtype) == tpr == FP.norm_rows_sm90_route(K, dtype)


@pytest.mark.parametrize("K,dtype,tpr", [(_L.hidden_size, torch.bfloat16, 128), (512, torch.bfloat16, 32),
                                         (1024, torch.bfloat16, 64), (4096, torch.bfloat16, 256),
                                         (2048, torch.float32, 256), (256, torch.float32, 32),
                                         (8192, torch.bfloat16, 0), (640, torch.bfloat16, 0), (128, torch.bfloat16, 0)])
def test_b10_route(K, dtype, tpr):
    """B10 at the Llama2-1B step's norm width (2048, bf16) takes the row
    walk at 128 threads a row (``NORM_BWD_VECTORS`` = 2 vectors of x and of
    dy each); widths whose vectors are not 32, 64, 128 or 256 times that
    keep the first design."""
    assert FP.rmsnorm_bwd_sm90_route(K, dtype) == tpr


def _fill_order(nv):
    """NormProducer::fill's (and rmsnorm_bwd_rows') order of a row sum:
    thread u < 256 takes vectors u, u + 256, ... in turn, a butterfly sums
    each warp of 32 threads, the warps' sums add in order. Returns, per old
    warp, its lanes' vector lists."""
    return [[list(range(32 * w + lane, nv, 256)) for lane in range(32)] for w in range(8)]


def _walk_order(tpr, v):
    """The walk's chains (``chain_totals``): lane t of a group holds vectors
    t + p tpr (p < v), chain c = p % R summing its vectors in p order; chain
    c of the group's warp h is butterflied across that warp's lanes and
    lands at old warp h + c W, which the group's total reads in order (W =
    1: the chains in c order). Returns the old warps' lanes' vector lists,
    empty where no chain lands."""
    R, W = 256 // tpr, tpr // 32
    C = min(v, R)
    order = [[[] for _ in range(32)] for _ in range(8)]
    for t in range(tpr):
        h, lane = divmod(t, 32)
        for c in range(C):
            order[h + c * W][lane] = [t + p * tpr for p in range(v) if p % R == c]
    return order


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["B8", "B10", "B18-LayerNorm"])
def test_b8_b10_chains_keep_the_fill_order(kernel, dtype):
    """For every layout (threads a row, vectors a thread) the B8, B10 and
    B18 LayerNorm routes return, the walk's chains visit thread u's vectors
    u, u + 256, ... in NormProducer::fill's (LayerNormProducer::fill's)
    order, each on the lane and warp of the first design's thread u, and
    the old warps that hold vectors are read in order (the rest hold none):
    the row sums, and so B8's q, B10's dx and B18's LayerNorm outputs, are
    the first design's bits. B18's LayerNorm takes three vectors a thread
    (bf16 K 1536: 64 threads) as well as four."""
    route = {"B8": FP.norm_cols_sm90_route, "B10": FP.rmsnorm_bwd_sm90_route,
             "B18-LayerNorm": FP.layernorm_rows_sm90_route}[kernel]
    layouts = {(route(K, dtype), _vectors(K, dtype) // route(K, dtype)) for K in NORM_KS if route(K, dtype)}
    vectors = {"B8": {FP.NORM_ROW_VECTORS}, "B10": {FP.NORM_BWD_VECTORS},
               "B18-LayerNorm": set(FP.LAYERNORM_VECTORS)}[kernel]
    assert {t for t, _ in layouts} == {32, 64, 128, 256} and {v for _, v in layouts} == vectors
    for tpr, v in sorted(layouts):
        nv = tpr * v
        assert 256 % tpr == 0 and nv == _vectors(nv * 16 // dtype.itemsize, dtype)
        walk, fill = _walk_order(tpr, v), _fill_order(nv)
        assert walk == fill, (kernel, tpr, v)
        read = min(v, 256 // tpr) * (tpr // 32)  # the old warps chain_totals reads
        assert all(not any(fill[w]) for w in range(read, 8)), (kernel, tpr, v)
    assert kernel != "B18-LayerNorm" or dtype != torch.bfloat16 or (64, 3) in layouts


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K,dtype", [(8192, 2048, torch.bfloat16), (1000, 2048, torch.bfloat16),
                                       (256, 2048, torch.float32), (96, 640, torch.bfloat16)])
def test_b8_passes_its_route(library, M, K, dtype, sr):
    """B8's given-scales wrapper passes ``norm_cols_sm90_route(K)`` and the
    walk's grid (two CTAs an SM) as the two arguments before the stream, one
    argument per ``_SIGNATURES`` entry, no scratch, and counts the launch
    per form and, on the row walk, again; its two-pass form passes route 0
    and counts no walk launch."""
    key = 41 if sr else None
    x, g = _meta((M, K), dtype), _meta((K,), dtype)
    q, s = ops.rmsnorm_quant_colwise(x, g, sr=sr, key=key, scale=_meta((1, K), torch.float32), norm_eps=1e-6)
    (name, args), = library.calls
    tpr = FP.norm_cols_sm90_route(K, dtype)
    assert name == "qt_rmsnorm_quant_colwise" and len(args) == len(_build._SIGNATURES[name]) == 18
    assert args[4:7] == (None, None, None)  # s_out, amax, parts: nothing allocated
    assert args[7:15] == (M, K, FP._rows_per_block(M), 1e-6, FP.EPS, int(dtype == torch.bfloat16), int(sr), key or 0)
    assert args[15:] == (tpr, FP.row_walk_ctas(M, tpr, SMS, FP.NORM_CTAS_PER_SM) if tpr else 0, 0)
    assert q.shape == (M, K) and s.shape == (1, K)
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"rmsnorm_quant_colwise{t}"] == 1 and counts[f"rmsnorm_quant_colwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)
    ops.reset_launch_counts()
    ops.rmsnorm_quant_colwise(x, g, sr=sr, key=key)
    name, args = library.calls[-1]
    assert name == "qt_rmsnorm_quant_colwise" and args[15:] == (0, 0, 0) and args[6] is not None
    counts = ops.launch_counts()
    assert counts[f"rmsnorm_quant_colwise{t}"] == 1 and sum(counts.values()) == 1


@pytest.mark.parametrize("M,K,dtype", [(8192, 2048, torch.bfloat16), (1000, 2048, torch.bfloat16),
                                       (256, 2048, torch.float32), (96, 640, torch.bfloat16)])
def test_b10_passes_its_route(library, monkeypatch, M, K, dtype):
    """B10's wrapper passes ``rmsnorm_bwd_sm90_route(K)`` and the walk's
    grid (two CTAs an SM) as the two arguments before the stream, one
    argument per ``_SIGNATURES`` entry, dgamma's scratch [CTAs, K] on the
    walk ([blocks, K] on the first design), and counts the launch, and on
    the row walk again."""
    shapes = []
    real = FP._route_parts

    def recording(*a):
        ctas, parts = real(*a)
        shapes.append(tuple(parts.shape))
        return ctas, parts
    monkeypatch.setattr(FP, "_route_parts", recording)
    x = _meta((M, K), dtype)
    dx, dg = ops.rmsnorm_bwd(x, _meta((K,), dtype), x, norm_eps=1e-6)
    (name, args), = library.calls
    tpr = FP.rmsnorm_bwd_sm90_route(K, dtype)
    ctas = FP.row_walk_ctas(M, tpr, SMS, FP.NORM_CTAS_PER_SM) if tpr else 0
    assert name == "qt_rmsnorm_bwd" and len(args) == len(_build._SIGNATURES[name]) == 14
    assert args[6:11] == (M, K, FP._rows_per_block(M), 1e-6, int(dtype == torch.bfloat16))
    assert args[11:] == (tpr, ctas, 0)
    assert shapes == [(ctas, K) if tpr else (-(-M // FP._rows_per_block(M)), K)]
    assert dx.shape == (M, K) and dx.dtype == dtype and dg.shape == (K,)
    counts = ops.launch_counts()
    assert counts["rmsnorm_bwd"] == 1 and counts["rmsnorm_bwd_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)


@pytest.mark.parametrize("K_ln,K_gelu,routed", _B18_WIDTHS)
def test_other_column_producers_keep_their_entries(library, K_ln, K_gelu, routed):
    """B9's column form and B18's column forms share B8's Python launch
    path, and their entries take the route arguments (17, 16 and 19 of
    them): given scales, route 0 at a width the walk cannot tile (bf16 K
    640) and their routes and grids at the wider widths (B9's columns at
    GELU's, 6144: 384 threads of two vectors, two CTAs an SM), counted on
    the walk; in two passes route 0 everywhere, counted on the first
    design."""
    M = 6400
    a, x, g = _meta((M, K_gelu)), _meta((M, K_ln)), _meta((K_ln,))
    for kw_gelu, kw_ln in ((dict(scale=_meta((1, K_gelu), torch.float32)), dict(scale=_meta((1, K_ln), torch.float32))),
                           ({}, {})):
        ops.silu_mul_quant_colwise(a, a, **kw_gelu)
        ops.gelu_quant_colwise(a, **kw_gelu)
        ops.layernorm_quant_colwise(x, g, g, **kw_ln)
    for name, args in library.calls:
        assert len(args) == len(_build._SIGNATURES[name])
    assert [n for n, _ in library.calls] == ["qt_silu_mul_quant_colwise", "qt_gelu_quant_colwise",
                                             "qt_layernorm_quant_colwise"] * 2
    assert [len(_build._SIGNATURES[n]) for n in ("qt_silu_mul_quant_colwise", "qt_gelu_quant_colwise",
                                                 "qt_layernorm_quant_colwise")] == [17, 16, 19]
    t_silu = FP.silu_cols_sm90_route(K_gelu, torch.bfloat16)
    t_gelu = FP.gelu_cols_sm90_route(K_gelu, torch.bfloat16)
    t_ln = FP.layernorm_cols_sm90_route(K_ln, torch.bfloat16)
    assert bool(t_silu) == bool(t_gelu) == bool(t_ln) == routed
    silu_per_sm = FP.silu_rows_ctas_per_sm(K_gelu, torch.bfloat16, False)
    gelu_per_sm = FP.gelu_ctas_per_sm(K_gelu, torch.bfloat16, False)
    assert silu_per_sm == gelu_per_sm == (2 if routed else 1)
    assert library.calls[0][1][14:] == (t_silu, FP.row_walk_ctas(M, t_silu, SMS, silu_per_sm) if routed else 0, 0)
    assert library.calls[1][1][13:] == (t_gelu, FP.row_walk_ctas(M, t_gelu, SMS, gelu_per_sm) if routed else 0, 0)
    assert library.calls[2][1][16:] == (t_ln, FP.row_walk_ctas(M, t_ln, SMS, 2) if routed else 0, 0)
    assert library.calls[3][1][14:] == library.calls[4][1][13:] == library.calls[5][1][16:] == (0, 0, 0)
    assert library.calls[3][1][6] is not None  # two passes: the first design, with its scratch
    counts = ops.launch_counts()
    assert counts["silu_mul_quant_colwise"] == counts["gelu_quant_colwise"] == counts["layernorm_quant_colwise"] == 2
    assert (counts["silu_mul_quant_colwise_sm90"] == counts["gelu_quant_colwise_sm90"]
            == counts["layernorm_quant_colwise_sm90"] == int(routed))
    assert sum(v for k, v in counts.items() if k.endswith("_sm90")) == 3 * int(routed)


def test_b8_b10_constants_match_the_kernels():
    """The vectors a thread by which the B8 and B10 routes size their groups
    are the kernels' (``csrc/fused_producers.cu``: ``kNormV``, ``kNormBwdV``),
    and the grid's CTAs an SM are those their launch bounds keep."""
    src = (_build.CSRC / "fused_producers.cu").read_text()
    assert f"constexpr int kNormV = {FP.NORM_ROW_VECTORS};" in src
    assert f"constexpr int kNormBwdV = {FP.NORM_BWD_VECTORS};" in src
    for kernel in ("rmsnorm_cols(", "rmsnorm_bwd_walk("):
        assert f"__launch_bounds__(kThreads, {FP.NORM_CTAS_PER_SM})\n{kernel}" in src


# ---- B18: the ViT's LayerNorm and GELU quantizes on the row walk ---------------------

BF16, F32 = torch.bfloat16, torch.float32
_G = VIT_GIANT  # hidden 1536, MLP 6144


@pytest.mark.parametrize("which", ["rows", "cols"])
@pytest.mark.parametrize("K,dtype,tpr", [(_G.hidden_size, BF16, 64), (768, BF16, 32), (1024, BF16, 32),
                                         (3072, BF16, 128), (6144, BF16, 256), (8192, BF16, 256),
                                         (_G.hidden_size, F32, 128), (768, F32, 64), (640, BF16, 0),
                                         (1280, BF16, 0), (384, BF16, 0), (16384, BF16, 0)])
def test_b18_layernorm_route(which, K, dtype, tpr):
    """B18's LayerNorm rows and given-scales columns at ViT-Giant's hidden
    width (1536, bf16) take the row walk at 64 threads a row (three vectors
    each); ViT-Base's 768 at 32 (three), ViT-Large's 1024 at 32 (four);
    widths whose vectors are not 32, 64, 128 or 256 times three or four
    (ViT-Huge's 1280, ViT-Small's 384, 640) keep the first design. Both
    forms take the same layouts."""
    route = {"rows": FP.layernorm_rows_sm90_route, "cols": FP.layernorm_cols_sm90_route}[which]
    assert route(K, dtype) == tpr


@pytest.mark.parametrize("which", ["rows", "cols"])
@pytest.mark.parametrize("K,dtype,tpr", [(_G.mlp_dim, BF16, 384), (4096, BF16, 256), (3072, BF16, 384),
                                         (5120, BF16, 320), (_G.hidden_size, F32, 384), (2048, F32, 256),
                                         (_G.mlp_dim, F32, 0), (_G.hidden_size, BF16, 0), (640, BF16, 0),
                                         (8192, BF16, 0)])
def test_b18_gelu_route(which, K, dtype, tpr):
    """B18's GELU rows and given-scales columns take B9-row's layouts: at
    ViT-Giant's MLP width (6144, bf16) 384 threads a row, two vectors each;
    ViT-Large's 4096 at 256 (two), ViT-Huge's 5120 at 320 (two), ViT-Base's
    3072 at 384 (one); widths the walk cannot tile with whole warps in one
    block (fp32 6144, bf16 1536, 640, 8192) keep the first design."""
    route = {"rows": FP.gelu_rows_sm90_route, "cols": FP.gelu_cols_sm90_route}[which]
    assert route(K, dtype) == tpr


@pytest.mark.parametrize("dtype", DTYPES)
def test_b18_layernorm_geometry_leaves_no_lane_idle(dtype):
    """At every K the LayerNorm route takes: whole warps a row, groups that
    fill the block of 256 and divide it (what keeps both row sums in the
    first design's order), the first of ``LAYERNORM_VECTORS`` vectors a
    thread that covers the row exactly; the path's width is among them."""
    taken = []
    for K in NORM_KS:
        tpr = FP.layernorm_rows_sm90_route(K, dtype)
        fits = [v for v in FP.LAYERNORM_VECTORS if _vectors(K, dtype) % v == 0
                and _vectors(K, dtype) // v in (32, 64, 128, 256)]
        assert tpr == (_vectors(K, dtype) // fits[0] if fits else 0), K
        if tpr:
            assert tpr % 32 == 0 and 256 % tpr == 0 and _vectors(K, dtype) // tpr in FP.LAYERNORM_VECTORS, (K, tpr)
            taken.append(K)
    assert taken and (dtype != torch.bfloat16 or _G.hidden_size in taken)


@pytest.mark.parametrize("dtype", DTYPES)
def test_b18_gelu_geometry_leaves_no_lane_idle(dtype):
    """At every K the GELU route takes: B9-row's layouts (whole warps a
    row, one or two vectors a thread covering the row exactly, a block of
    max(tpr, 256) threads made of whole groups within the kernel's largest),
    at ``gelu_ctas_per_sm`` CTAs an SM (two for the RN form at two vectors a
    thread, else one); the path's width is among them."""
    taken = []
    for K in NORM_KS:
        tpr = FP.gelu_rows_sm90_route(K, dtype)
        assert tpr == FP.gelu_cols_sm90_route(K, dtype) == FP.silu_rows_sm90_route(K, dtype)
        if tpr:
            v, cta = _vectors(K, dtype) // tpr, max(tpr, 256)
            assert v * tpr == _vectors(K, dtype) and cta % tpr == 0 and cta <= FP._SILU_ROWS_MAX_CTA[v], (K, tpr)
            for sr in (False, True):
                per_sm = FP.gelu_ctas_per_sm(K, dtype, sr)
                assert per_sm == (FP.SILU_ROWS_CTAS_PER_SM if v == 2 and not sr else 1) and cta * per_sm <= 2048
            taken.append(K)
    assert taken and (dtype != torch.bfloat16 or _G.mlp_dim in taken)


def _b18_inputs(form, M, K, dtype):
    if form == "layernorm":
        return (_meta((M, K), dtype), _meta((K,), dtype), _meta((K,), dtype))
    return (_meta((M, K), dtype),)


# (M, K, dtype): ViT-Giant's padded token rows, a ragged row count, an fp32
# width the walk takes, and a width it cannot tile
_B18_SHAPES = {"layernorm": [(6400, _G.hidden_size, BF16), (1000, _G.hidden_size, BF16), (256, 1536, F32),
                             (96, 640, BF16)],
               "gelu": [(6400, _G.mlp_dim, BF16), (1000, _G.mlp_dim, BF16), (256, 2048, F32), (96, 640, BF16)]}


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("amax", [False, True])
@pytest.mark.parametrize("form,M,K,dtype", [(f, *s) for f, shapes in _B18_SHAPES.items() for s in shapes])
def test_b18_rows_pass_their_route(library, monkeypatch, form, M, K, dtype, amax, sr):
    """B18's row wrappers pass their route (``layernorm_rows_sm90_route``,
    ``gelu_rows_sm90_route``) and the walk's grid (LayerNorm two CTAs an
    SM, its SR form one; GELU ``gelu_ctas_per_sm``) as the two arguments before the stream,
    one argument per ``_SIGNATURES`` entry, their rows a block for the first
    design, the column maxima' scratch one row a CTA on the walk, and count
    the launch per form and, on the row walk, again; with and without the
    column absmax, in RN and SR."""
    shapes = []
    real = FP._route_parts

    def recording(*a):
        ctas, parts = real(*a)
        shapes.append(tuple(parts.shape))
        return ctas, parts
    monkeypatch.setattr(FP, "_route_parts", recording)
    key = 23 if sr else None
    fn = {"layernorm": ops.layernorm_quant_rowwise, "gelu": ops.gelu_quant_rowwise}[form]
    out = fn(*_b18_inputs(form, M, K, dtype), sr=sr, key=key, with_col_amax=amax)
    (name, args), = library.calls
    if form == "layernorm":
        tpr, per_sm = FP.layernorm_rows_sm90_route(K, dtype), 1 if sr else FP.LAYERNORM_CTAS_PER_SM
        assert name == "qt_layernorm_quant_rowwise" and len(args) == len(_build._SIGNATURES[name]) == 19
        assert args[7:12] == (M, K, FP._rows_per_block(M), 1e-6, FP.EPS)
        assert args[12:16] == (int(dtype == BF16), int(sr), int(amax), key or 0)
    else:
        tpr, per_sm = FP.gelu_rows_sm90_route(K, dtype), FP.gelu_ctas_per_sm(K, dtype, sr)
        assert name == "qt_gelu_quant_rowwise" and len(args) == len(_build._SIGNATURES[name]) == 16
        assert args[5:13] == (M, K, FP._rows_per_block(M), FP.EPS, int(dtype == BF16), int(sr), int(amax), key or 0)
    ctas = FP.row_walk_ctas(M, tpr, SMS, per_sm) if tpr else 0
    assert args[-3:] == (tpr, ctas, 0) and bool(tpr) == (K != 640)
    assert shapes == [((ctas if tpr else -(-M // FP._rows_per_block(M))), K) if amax else (0,)]
    assert [t.shape for t in out] == [(M, K), (M, 1), (1, K)][:3 if amax else 2]
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"{form}_quant_rowwise{t}"] == 1 and counts[f"{form}_quant_rowwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("form,M,K,dtype", [(f, *s) for f, shapes in _B18_SHAPES.items() for s in shapes])
def test_b18_cols_pass_their_route(library, form, M, K, dtype, sr):
    """B18's column wrappers given scales pass their route
    (``layernorm_cols_sm90_route``, ``gelu_cols_sm90_route``) and the walk's
    grid as the two arguments before the stream, no scratch, and count the
    launch per form and, on the row walk, again; in two passes they pass
    route 0 and count no walk launch."""
    key = 31 if sr else None
    fn = {"layernorm": ops.layernorm_quant_colwise, "gelu": ops.gelu_quant_colwise}[form]
    inputs = _b18_inputs(form, M, K, dtype)
    q, s = fn(*inputs, sr=sr, key=key, scale=_meta((1, K), torch.float32))
    (name, args), = library.calls
    n_args, so = {"layernorm": (19, 5), "gelu": (16, 3)}[form]
    assert name == f"qt_{form}_quant_colwise" and len(args) == len(_build._SIGNATURES[name]) == n_args
    assert args[so:so + 3] == (None, None, None)  # s_out, amax, parts: nothing allocated
    if form == "layernorm":
        tpr, per_sm = FP.layernorm_cols_sm90_route(K, dtype), FP.LAYERNORM_CTAS_PER_SM
        assert args[8:16] == (M, K, FP._rows_per_block(M), 1e-6, FP.EPS, int(dtype == BF16), int(sr), key or 0)
    else:
        tpr, per_sm = FP.gelu_cols_sm90_route(K, dtype), FP.gelu_ctas_per_sm(K, dtype, sr)
        assert args[6:13] == (M, K, FP._rows_per_block(M), FP.EPS, int(dtype == BF16), int(sr), key or 0)
    assert args[-3:] == (tpr, FP.row_walk_ctas(M, tpr, SMS, per_sm) if tpr else 0, 0) and bool(tpr) == (K != 640)
    assert q.shape == (M, K) and s.shape == (1, K)
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"{form}_quant_colwise{t}"] == 1 and counts[f"{form}_quant_colwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)
    ops.reset_launch_counts()
    fn(*inputs, sr=sr, key=key)
    name, args = library.calls[-1]
    assert args[-3:] == (0, 0, 0) and args[so + 2] is not None  # two passes: the first design, with its scratch
    counts = ops.launch_counts()
    assert counts[f"{form}_quant_colwise{t}"] == 1 and sum(counts.values()) == 1


def test_b18_constants_match_the_kernels():
    """The vectors a thread the LayerNorm route tries, in its order, are the
    kernel's (``csrc/fused_producers.cu::kLayerNormVs``), and the CTAs an SM
    by which the wrappers size the grids are those the launch bounds keep:
    LayerNorm's ``kLayerNormCtasPerSm`` for both forms, its SR row form one
    (``layernorm_rows_ctas``); GELU's forms are
    B9-row's walk over one input (``elementwise_rows``, ``elementwise_cols``
    with ``silu_rows_ctas``: two CTAs an SM for the RN form at two vectors a
    thread, else one)."""
    src = (_build.CSRC / "fused_producers.cu").read_text()
    assert f"constexpr int kLayerNormVs[] = {{{', '.join(map(str, FP.LAYERNORM_VECTORS))}}};" in src
    assert f"constexpr int kLayerNormCtasPerSm = {FP.LAYERNORM_CTAS_PER_SM};" in src
    assert "__launch_bounds__(kThreads, kLayerNormCtasPerSm)\nlayernorm_cols(" in src
    assert "__launch_bounds__(kThreads, layernorm_rows_ctas<SR>())\nlayernorm_rows(" in src
    assert "constexpr int layernorm_rows_ctas() { return SR ? 1 : kLayerNormCtasPerSm; }" in src
    assert FP.layernorm_rows_ctas_per_sm(False) == FP.LAYERNORM_CTAS_PER_SM == 2
    assert FP.layernorm_rows_ctas_per_sm(True) == 1
    bounds = "__launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2, silu_rows_ctas<SR, V>())\n"
    for kernel in ("elementwise_rows(", "elementwise_cols("):
        assert bounds + kernel in src
    assert "launch_elementwise_rows<GeluOp, " in src and "launch_elementwise_cols<GeluOp, " in src
    assert "launch_elementwise_rows<SiluMulOp, " in src
    assert FP.gelu_ctas_per_sm(_G.mlp_dim, BF16, False) == FP.SILU_ROWS_CTAS_PER_SM == 2
    assert FP.gelu_ctas_per_sm(_G.mlp_dim, BF16, True) == 1
    assert FP.gelu_ctas_per_sm(3072, BF16, False) == 1  # one vector a thread


# ---- B9's columns given scales and B12 on the row walk -------------------------------

# (K, dtype, threads a row at two vectors a thread first, at one first):
# the Llama2-1B FFN width 5632 first; widths the walk cannot tile keep the
# first design at either
_SILU_ROUTES = [(_L.intermediate_size, BF16, 352, 704), (2048, BF16, 128, 256), (256, BF16, 32, 32),
                (6144, BF16, 384, 384), (2560, BF16, 320, 320), (2048, F32, 256, 512), (8192, BF16, 0, 0),
                (128, BF16, 0, 0), (640, BF16, 0, 0), (1536, BF16, 0, 0), (5632, F32, 0, 0)]


@pytest.mark.parametrize("K,dtype,two_first,one_first", _SILU_ROUTES)
def test_b12_route(K, dtype, two_first, one_first):
    """B12 given scales takes B11's layouts with one vector a thread tried
    first (it ran faster than B11's two: ``ab_sm90_forms.py``'s
    ``b12_v2``): at the Llama2-1B step's FFN width (5632, bf16) 704 threads
    a row, two vectors a thread only where one leaves no CTA (K = 6144);
    widths the walk cannot tile with whole warps or hold in one block (K =
    8192, 640, 1536, fp32 5632) keep the first design, as B11's do."""
    assert FP.silu_bwd_cols_sm90_route(K, dtype) == one_first
    assert FP.silu_bwd_rows_sm90_route(K, dtype) == two_first
    assert bool(one_first) == bool(two_first)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("K,dtype,two_first,one_first", _SILU_ROUTES)
def test_b9_cols_route(K, dtype, two_first, one_first, sr):
    """B9's column form given scales takes B9-row's layouts: its RN form at
    352 threads a row of two vectors at the Llama2-1B step's FFN width, as
    the row form, its SR form at 704 of one (faster than two: ``b9_v1``'s
    ``B9csr``); the first design where the row form keeps it."""
    assert FP.silu_cols_sm90_route(K, dtype, sr) == (one_first if sr else two_first)
    assert FP.silu_cols_sm90_route(K, dtype) == two_first == FP.silu_rows_sm90_route(K, dtype)


@pytest.mark.parametrize("kernel", ["B12", "B9-col", "B9-col-SR"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_b9_cols_b12_geometry_leaves_no_lane_idle(dtype, kernel):
    """At every K the wrappers take: whole warps a row, one or two vectors a
    thread covering the row exactly, a block of max(tpr, 256) threads made
    of whole groups within the kernel's largest for that vector count, its
    CTAs an SM within the SM's 2,048 threads (B12 ``SILU_CTAS_PER_SM``, B9's
    columns :func:`silu_cols_ctas_per_sm`: two only for the RN form at two
    vectors a thread); the path's width is among them."""
    sr = kernel == "B9-col-SR"
    taken = []
    for K in NORM_KS:
        tpr = FP.silu_bwd_cols_sm90_route(K, dtype) if kernel == "B12" else FP.silu_cols_sm90_route(K, dtype, sr)
        if tpr:
            v, cta = _vectors(K, dtype) // tpr, max(tpr, 256)
            assert tpr % 32 == 0 and v * tpr == _vectors(K, dtype) and v in FP._SILU_ROWS_MAX_CTA, (K, tpr)
            assert cta % tpr == 0 and cta <= FP._SILU_ROWS_MAX_CTA[v], (K, tpr)
            per_sm = FP.SILU_CTAS_PER_SM if kernel == "B12" else FP.silu_cols_ctas_per_sm(K, dtype, sr)
            assert per_sm == (2 if kernel == "B9-col" and v == 2 else 1) and cta * per_sm <= 2048, (K, tpr)
            taken.append(K)
    assert taken and (dtype != torch.bfloat16 or _L.intermediate_size in taken)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K,dtype", [(8192, 5632, BF16), (1000, 5632, BF16), (256, 5632, BF16),
                                       (256, 2048, F32), (96, 640, BF16)])
def test_b12_passes_its_route(library, M, K, dtype, sr):
    """B12's wrapper passes ``silu_bwd_cols_sm90_route(K)`` and the walk's
    grid (``SILU_CTAS_PER_SM`` CTAs an SM, by ``row_walk_ctas``) as the two
    arguments before the stream, one argument per ``_SIGNATURES`` entry, its
    rows a block for the first design (route 0 at bf16 K 640), and counts
    the launch per form and, on the row walk, again."""
    key = 13 if sr else None
    x, s = _meta((M, K), dtype), _meta((1, K), torch.float32)
    qa, qb = ops.silu_mul_bwd_quant_colwise(x, x, x, s, s, sr=sr, key=key)
    (name, args), = library.calls
    tpr = FP.silu_bwd_cols_sm90_route(K, dtype)
    assert bool(tpr) == (K != 640)
    assert name == "qt_silu_mul_bwd_quant_colwise" and len(args) == len(_build._SIGNATURES[name]) == 17
    assert args[7:14] == (M, K, FP._rows_per_block(M), FP.EPS, int(dtype == BF16), int(sr), key or 0)
    assert args[14:] == (tpr, FP.row_walk_ctas(M, tpr, SMS, FP.SILU_CTAS_PER_SM) if tpr else 0, 0)
    assert qa.shape == qb.shape == (M, K) and qa.dtype == qb.dtype == torch.int8
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"silu_mul_bwd_quant_colwise{t}"] == 1
    assert counts[f"silu_mul_bwd_quant_colwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K,dtype", [(8192, 5632, BF16), (1000, 5632, BF16), (256, 5632, BF16),
                                       (256, 2560, BF16), (256, 2048, F32), (96, 640, BF16)])
def test_b9_cols_passes_its_route(library, M, K, dtype, sr):
    """B9's given-scales column wrapper passes ``silu_cols_sm90_route(K,
    dtype, sr)`` and the walk's grid (``silu_cols_ctas_per_sm``: two CTAs an
    SM for the RN form at two vectors a thread, else one) as the two
    arguments before the stream, no scratch, and counts the launch per form
    and, on the row walk, again; in two passes it passes route 0 and counts
    no walk launch."""
    key = 17 if sr else None
    a = _meta((M, K), dtype)
    q, s = ops.silu_mul_quant_colwise(a, a, sr=sr, key=key, scale=_meta((1, K), torch.float32))
    (name, args), = library.calls
    tpr = FP.silu_cols_sm90_route(K, dtype, sr)
    per_sm = FP.SILU_ROWS_CTAS_PER_SM if _vectors(K, dtype) == 2 * tpr and not sr else 1
    assert bool(tpr) == (K != 640) and per_sm == FP.silu_cols_ctas_per_sm(K, dtype, sr)
    assert name == "qt_silu_mul_quant_colwise" and len(args) == len(_build._SIGNATURES[name]) == 17
    assert args[4:7] == (None, None, None)  # s_out, amax, parts: nothing allocated
    assert args[7:14] == (M, K, FP._rows_per_block(M), FP.EPS, int(dtype == BF16), int(sr), key or 0)
    assert args[14:] == (tpr, FP.row_walk_ctas(M, tpr, SMS, per_sm) if tpr else 0, 0)
    assert q.shape == (M, K) and s.shape == (1, K)
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"silu_mul_quant_colwise{t}"] == 1 and counts[f"silu_mul_quant_colwise{t}_sm90"] == int(tpr > 0)
    assert sum(counts.values()) == 1 + int(tpr > 0)
    ops.reset_launch_counts()
    ops.silu_mul_quant_colwise(a, a, sr=sr, key=key)
    name, args = library.calls[-1]
    assert args[14:] == (0, 0, 0) and args[6] is not None  # two passes: the first design, with its scratch
    counts = ops.launch_counts()
    assert counts[f"silu_mul_quant_colwise{t}"] == 1 and sum(counts.values()) == 1


def test_b9_cols_b12_constants_match_the_kernels():
    """The CTAs an SM by which the wrappers size the grids of B9's columns
    and B12 are those their kernels' launch bounds keep
    (``csrc/fused_producers.cu``): B9's columns run ``elementwise_cols``
    over ``SiluMulOp`` with B9-row's ``silu_rows_ctas`` (two CTAs an SM for
    the RN form at two vectors a thread, the SR form one, as at 704
    threads of one); B12's ``silu_bwd_cols`` has B11's bounds, which keep
    one CTA an SM (``SILU_CTAS_PER_SM``), its inverse scales in
    registers."""
    src = (_build.CSRC / "fused_producers.cu").read_text()
    assert "launch_elementwise_cols<SiluMulOp, " in src
    assert ("__launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2, silu_rows_ctas<SR, V>())\n"
            "elementwise_cols(") in src
    assert "__launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2)\nsilu_bwd_cols(" in src
    assert "__launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2)\nsilu_bwd_rows(" in src
    assert "constexpr int kSiluRowsMaxCta = 704, kSiluRowsMaxCta2 = 384;" in src
    assert FP._SILU_ROWS_MAX_CTA == {1: 704, 2: 384} and FP.SILU_CTAS_PER_SM == 1
    assert FP.silu_cols_ctas_per_sm(_L.intermediate_size, BF16, False) == FP.SILU_ROWS_CTAS_PER_SM == 2
    assert FP.silu_cols_ctas_per_sm(_L.intermediate_size, BF16, True) == 1
