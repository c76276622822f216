"""The route K1 (``quantize_int8_rowwise``) takes, on the CPU: a pure
predicate in ``ops/int8_quant.py`` (``rowwise_sm90_route``) gives the
threads a row of its persistent row walk (``csrc/int8_quant.cu::
quantize_rows_walk``: a group of whole warps a row, the row read once into
registers) or 0 for the first design, and the wrapper passes it with the
walk's grid to the C entry. No card is needed: the predicate is held at the
shapes the serving path and the training steps launch K1 at, and the
wrapper's launch path runs against a recording stub of the library on meta
tensors that pass for CUDA ones. The kernel itself is held to its plain
version and its first design on the card (``tests/test_torch_cuda.py -k
k1_walk``)."""

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
D, F, KVD, HD = _L.hidden_size, _L.intermediate_size, _L.num_key_value_heads * _L.head_dim, _L.head_dim
VD, VF = _V.hidden_size, _V.mlp_dim
TOKENS = 4 * 2048  # the Llama2-1B step's micro-batch
BF16 = torch.bfloat16

# (M, K) -> threads a row in bf16 (RN, SR), at every shape chip_smoke.py's
# check_k1 holds K1 at: a decode step's activations (8 slots) and prefill
# chunks, the train step's activations, the four weights, the KV rows of 64
ROUTES = {
    (8, D): (64, 0), (8, F): (352, 352),
    (16, D): (64, 0), (512, D): (64, 64), (512, F): (352, 352),
    (TOKENS, D): (64, 64), (TOKENS, F): (352, 0),
    (D, D): (64, 64), (KVD, D): (64, 0), (F, D): (64, 64), (D, F): (352, 352),
    (8 * 1 * 4, HD): (0, 0), (1 * 512 * 4, HD): (0, 0),
}
# ViT-Giant's widths: the rows of its weights and activations (1536 and
# 6144 wide), 24 x 257 tokens
VIT_ROUTES = {(3 * VD, VD): 64, (VD, VD): 64, (VF, VD): 64, (VD, VF): 256, (24 * 257, VD): 64, (24 * 257, VF): 256}


def _vectors(K, dtype):
    return K * dtype.itemsize // 16


@pytest.mark.parametrize("M,K", list(ROUTES), ids=[f"{m}x{k}" for m, k in ROUTES])
@pytest.mark.parametrize("sr", [False, True])
def test_k1_route(M, K, sr):
    """Every row of 1024 elements or more takes the walk in RN (bf16 K
    2048: 64 threads of four vectors; K 5632: 352 of two), a decode step's
    activation rows included; the KV rows of 64 keep the first design. The
    SR form takes it at four vectors a thread from 512 rows, at two up to
    2048."""
    assert IQ.rowwise_sm90_route(M, K, BF16, sr) == ROUTES[(M, K)][sr]


@pytest.mark.parametrize("M,K", list(VIT_ROUTES), ids=[f"{m}x{k}" for m, k in VIT_ROUTES])
def test_k1_route_at_vit_giant(M, K):
    """ViT-Giant's widths take the walk, the SR form too: 1536 at 64
    threads of three vectors, 6144 at 256 of three."""
    assert IQ.rowwise_sm90_route(M, K, BF16) == IQ.rowwise_sm90_route(M, K, BF16, True) == VIT_ROUTES[(M, K)]


@pytest.mark.parametrize("M,K,dtype", [(TOKENS, 512, BF16), (TOKENS, 1000, BF16), (TOKENS, 1001, torch.float32),
                                       (TOKENS, 64, torch.float32), (0, 2048, BF16), (TOKENS, 5632, torch.float32),
                                       (TOKENS, 6144, torch.float32)])
def test_k1_route_refuses(M, K, dtype):
    """Rows below 1024 elements, rows that are no whole number of 16-byte
    vectors, no rows, and widths no layout tiles (fp32 5632 and 6144: more
    than 384 threads at two vectors) keep the first design."""
    assert IQ.rowwise_sm90_route(M, K, dtype) == IQ.rowwise_sm90_route(M, K, dtype, True) == 0


@pytest.mark.parametrize("K", [1024, 1536, 2048, 2560, 4096, 5632, 6144, 8192])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k1_layouts(K, dtype):
    """Every layout the route gives is one the kernel has
    (``launch_rows_walk``): whole warps, ``ROWWISE_VECTORS`` vectors a
    thread tiling the row exactly, a group that divides the block of 256 or
    is the block, within the kernel's largest block for its vectors; and
    the first of the vectors a thread that does."""
    tpr = IQ.rowwise_sm90_route(TOKENS, K, dtype)
    nv = _vectors(K, dtype)
    fits = {v: nv % v == 0 and (nv // v) % 32 == 0 and (256 % (nv // v) == 0 or 256 < nv // v <= cta)
            for v, cta in IQ.ROWWISE_VECTORS.items()}
    if not any(fits.values()):
        assert tpr == 0
        return
    v = next(v for v, ok in fits.items() if ok)
    assert tpr == nv // v and max(tpr, 256) % tpr == 0 and max(tpr, 256) <= IQ.ROWWISE_VECTORS[v]


def test_k1_constants_match_the_kernel():
    """The route's CTAs an SM and largest blocks are the kernel's
    (``csrc/int8_quant.cu``: ``kRowWalkCtasPerSm``, ``row_walk_max_cta``),
    and so is the least row it walks (``kBlockRowMinK``, where the first
    design turns from a warp to a block a row)."""
    src = (_build.CSRC / "int8_quant.cu").read_text()
    assert f"constexpr int kRowWalkCtasPerSm = {IQ.ROWWISE_CTAS_PER_SM};" in src
    assert IQ.ROWWISE_SR_MIN_ROWS == 512 and IQ.ROWWISE_SR_MAX_ROWS_TWO == 2048
    assert "constexpr int row_walk_max_cta() { return V == 2 ? 384 : kThreads; }" in src
    assert IQ.ROWWISE_VECTORS == {4: 256, 3: 256, 2: 384}
    assert f"constexpr int64_t kBlockRowMinK = {IQ.ROWWISE_MIN_K};" in src


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
    taken for CUDA ones by the wrapper's device checks, on a card of
    ``SMS`` SMs."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(IQ, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: self.device.type == "meta"))
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


@pytest.mark.parametrize("M,K", list(ROUTES), ids=[f"{m}x{k}" for m, k in ROUTES])
@pytest.mark.parametrize("sr", [False, True])
def test_k1_passes_its_route(library, M, K, sr):
    """K1's wrapper passes the route's threads a row and the walk's grid
    (``row_walk_ctas`` at ``ROWWISE_CTAS_PER_SM``; 0 and 0 for the first
    design) as the two arguments before the stream, one argument per
    ``_SIGNATURES`` entry, and counts the launch per form and, on the walk,
    again in ``sm90_launches`` or ``sr_sm90_launches``."""
    key = 7 if sr else None
    q, s = ops.quantize_int8_rowwise(torch.empty((M, K), dtype=BF16, device="meta"), sr=sr, key=key)
    (name, args), = library.calls
    tpr = ROUTES[(M, K)][sr]
    ctas = IQ.row_walk_ctas(M, tpr, SMS, IQ.ROWWISE_CTAS_PER_SM) if tpr else 0
    assert name == "qt_quantize_int8_rowwise" and len(args) == len(_build._SIGNATURES[name]) == 12
    assert args[3:5] == (M, K) and args[6:9] == (1, int(sr), 7 if sr else 0) and args[9:] == (tpr, ctas, 0)
    assert q.shape == (M, K) and s.shape == (M, 1)
    counts, t = ops.launch_counts(), "_sr" if sr else ""
    assert counts[f"quantize_int8_rowwise{t}"] == 1 and counts[f"quantize_int8_rowwise{t}_sm90"] == int(bool(tpr))
    other = "" if sr else "_sr"
    assert counts[f"quantize_int8_rowwise{other}"] == counts[f"quantize_int8_rowwise{other}_sm90"] == 0


def test_k1_walk_grid():
    """The walk's grid: 256-thread CTAs of four groups at 64 threads a row,
    one group a CTA at 352; as many CTAs as the rows need, at most two an
    SM (a weight of 2,048 rows fills 264 CTAs, 256 rows 64)."""
    assert IQ.row_walk_ctas(2048, 64, SMS, 2) == 264 and IQ.row_walk_ctas(256, 64, SMS, 2) == 64
    assert IQ.row_walk_ctas(2048, 352, SMS, 2) == 264 and IQ.row_walk_ctas(17, 352, SMS, 2) == 17


def test_k1_off_16_bytes_keeps_the_first_design(library):
    """A view off a 16-byte boundary (the walk loads 16-byte vectors) takes
    the first design, route 0, and counts no walk launch."""
    x = torch.empty(TOKENS * D + 8, dtype=BF16, device="meta")[1:1 + TOKENS * D].view(TOKENS, D)
    assert x.data_ptr() % 16 and IQ.rowwise_sm90_route(TOKENS, D, BF16) == IQ.rowwise_sm90_route(TOKENS, D, BF16, True)
    ops.quantize_int8_rowwise(x)
    (name, args), = library.calls
    assert args[9:] == (0, 0, 0)
    counts = ops.launch_counts()
    assert counts["quantize_int8_rowwise"] == 1 and counts["quantize_int8_rowwise_sm90"] == 0
