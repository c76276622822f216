"""The route B7 (``rmsnorm_quant_rowwise``) and B11
(``silu_mul_bwd_quant_rowwise``) take, on the CPU: each picks between the
persistent row walk of ``csrc/fused_producers.cu`` (``rmsnorm_rows``,
``silu_bwd_rows``) and the first design (``row_quant``,
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
                                               (8192, 128, 1, SMS), (1000, 64, 2, 250), (7, 64, 2, 2), (7, 704, 1, 7),
                                               (1, 32, 2, 1)])
def test_row_walk_grid(M, tpr, per_sm, ctas):
    """The walk's grid: a block of max(tpr, 256) threads, its groups one row
    each at a time, at most ``per_sm`` blocks an SM (B7 two, B11 one)."""
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


def test_other_row_producers_keep_their_entries(library):
    """B9's and B18's row forms share B7's Python launch path but not its
    route: their entries take no route arguments, and nothing counts a
    row-walk launch for them."""
    a = _meta((8192, 5632))
    ops.silu_mul_quant_rowwise(a, a, with_col_amax=True)
    ops.gelu_quant_rowwise(a, with_col_amax=True)
    for name, args in library.calls:
        assert len(args) == len(_build._SIGNATURES[name])
    counts = ops.launch_counts()
    assert counts["silu_mul_quant_rowwise"] == counts["gelu_quant_rowwise"] == 1
    assert not any(v for k, v in counts.items() if k.endswith("_sm90"))
