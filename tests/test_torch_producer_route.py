"""The route B7 (``rmsnorm_quant_rowwise``), B8 given scales
(``rmsnorm_quant_colwise``), B9's row form (``silu_mul_quant_rowwise``), B10
(``rmsnorm_bwd``) and B11 (``silu_mul_bwd_quant_rowwise``) take, on the
CPU: each picks between the persistent row walk of
``csrc/fused_producers.cu`` (``rmsnorm_rows``, ``rmsnorm_cols``,
``silu_rows``, ``rmsnorm_bwd_walk``, ``silu_bwd_rows``) and the first
design (``row_quant``, ``col_quant``, ``rmsnorm_bwd_rows``,
``silu_bwd_row_quant``) by a pure predicate in ``ops/fused_producers.py``,
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


def test_other_row_producers_keep_their_entries(library):
    """B18's GELU and LayerNorm row forms share the Python launch path of B7
    and B9 but take no route: their entries take no route arguments and
    nothing counts a row-walk launch for them; B9's row form at the same
    width takes its new entry's route arguments and counts there."""
    a = _meta((8192, 2048))
    g = _meta((2048,))
    ops.gelu_quant_rowwise(a, with_col_amax=True)
    ops.layernorm_quant_rowwise(a, g, g, with_col_amax=True)
    for name, args in library.calls:
        assert len(args) == len(_build._SIGNATURES[name])
    assert [n for n, _ in library.calls] == ["qt_gelu_quant_rowwise", "qt_layernorm_quant_rowwise"]
    assert len(_build._SIGNATURES["qt_gelu_quant_rowwise"]) == 14
    assert len(_build._SIGNATURES["qt_layernorm_quant_rowwise"]) == 17
    counts = ops.launch_counts()
    assert counts["gelu_quant_rowwise"] == counts["layernorm_quant_rowwise"] == 1
    assert not any(v for k, v in counts.items() if k.endswith("_sm90"))
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
@pytest.mark.parametrize("kernel", ["B8", "B10"])
def test_b8_b10_chains_keep_the_fill_order(kernel, dtype):
    """For every threads-a-row the B8 and B10 routes return, the walk's
    chains visit thread u's vectors u, u + 256, ... in NormProducer::fill's
    order, each on the lane and warp of the first design's thread u, and
    the old warps that hold vectors are read in order (the rest hold none):
    the row sums, and so B8's q and B10's dx, are the first design's bits."""
    route, v = ((FP.norm_cols_sm90_route, FP.NORM_ROW_VECTORS) if kernel == "B8"
                else (FP.rmsnorm_bwd_sm90_route, FP.NORM_BWD_VECTORS))
    tprs = {route(K, dtype) for K in NORM_KS} - {0}
    assert tprs == {32, 64, 128, 256}
    for tpr in sorted(tprs):
        nv = tpr * v
        assert 256 % tpr == 0 and nv == _vectors(nv * 16 // dtype.itemsize, dtype)
        walk, fill = _walk_order(tpr, v), _fill_order(nv)
        assert walk == fill, (kernel, tpr)
        read = min(v, 256 // tpr) * (tpr // 32)  # the old warps chain_totals reads
        assert all(not any(fill[w]) for w in range(read, 8)), (kernel, tpr)


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


def test_other_column_producers_keep_their_entries(library):
    """B9's column form and B18's column forms share B8's Python launch
    path but take no route: their entries take no route arguments, given
    scales or in two passes, and nothing counts a row-walk launch for them."""
    a, g = _meta((8192, 2048)), _meta((2048,))
    scale = _meta((1, 2048), torch.float32)
    for kw in (dict(scale=scale), {}):
        ops.silu_mul_quant_colwise(a, a, **kw)
        ops.gelu_quant_colwise(a, **kw)
        ops.layernorm_quant_colwise(a, g, g, **kw)
    for name, args in library.calls:
        assert len(args) == len(_build._SIGNATURES[name])
    assert [n for n, _ in library.calls] == ["qt_silu_mul_quant_colwise", "qt_gelu_quant_colwise",
                                             "qt_layernorm_quant_colwise"] * 2
    assert [len(_build._SIGNATURES[n]) for n in ("qt_silu_mul_quant_colwise", "qt_gelu_quant_colwise",
                                                 "qt_layernorm_quant_colwise")] == [15, 14, 17]
    counts = ops.launch_counts()
    assert counts["silu_mul_quant_colwise"] == counts["gelu_quant_colwise"] == counts["layernorm_quant_colwise"] == 2
    assert not any(v for k, v in counts.items() if k.endswith("_sm90"))


def test_b8_b10_constants_match_the_kernels():
    """The vectors a thread by which the B8 and B10 routes size their groups
    are the kernels' (``csrc/fused_producers.cu``: ``kNormV``, ``kNormBwdV``),
    and the grid's CTAs an SM are those their launch bounds keep."""
    src = (_build.CSRC / "fused_producers.cu").read_text()
    assert f"constexpr int kNormV = {FP.NORM_ROW_VECTORS};" in src
    assert f"constexpr int kNormBwdV = {FP.NORM_BWD_VECTORS};" in src
    for kernel in ("rmsnorm_cols(", "rmsnorm_bwd_walk("):
        assert f"__launch_bounds__(kThreads, {FP.NORM_CTAS_PER_SM})\n{kernel}" in src
