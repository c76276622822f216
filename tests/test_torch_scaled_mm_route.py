"""The route each sm90-capable GEMM takes, on the CPU: K2
(``ops/scaled_mm.py::sm90_route`` above the decode sizes, ``::decode_route``
at them: the split-K weight stream of ``csrc/scaled_mm.cu::decode_stream``),
B1 (``ops/scaled_mm.py::
rhs_mn_sm90_route``), B2 (``ops/scaled_mm.py::lhs_t_sm90_route``), B15
(``ops/tile_scaled_mm.py::sm90_route``), B16 (``ops/int4_mm.py::sm90_route``)
and B17 (``ops/matmul.py::sm90_route``, both forms) choose between the TMA + wgmma
mainloop of ``csrc/sm90_gemm.cuh`` and their wmma kernels (B1 and B2 have
none left) by a pure predicate, decided in Python and passed to the C entry
as an explicit argument. No card is needed: the predicates are held at
the main path's shapes, and the wrappers' launch path runs against a
recording stub of the library, on meta tensors that pass for CUDA ones.
The kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py -k sm90``)."""

import importlib

import pytest
import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.models import llama, vit
from quantized_training_tpu_torch.ops import _build

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

# both the module and the function of its name are exported by ops
SCALED_MM = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")
MATMUL = importlib.import_module("quantized_training_tpu_torch.ops.matmul")
INT4_MM = importlib.import_module("quantized_training_tpu_torch.ops.int4_mm")
TILE_MM = importlib.import_module("quantized_training_tpu_torch.ops.tile_scaled_mm")

_L = llama.LLAMA2_1B
_KVD = _L.num_key_value_heads * _L.head_dim
LLAMA_LINEARS = {"q/o": (_L.hidden_size, _L.hidden_size), "k/v": (_KVD, _L.hidden_size),
                 "gate/up": (_L.intermediate_size, _L.hidden_size), "down": (_L.hidden_size, _L.intermediate_size)}
_V = vit.VIT_GIANT
VIT_LINEARS = {"qkv": (3 * _V.hidden_size, _V.hidden_size), "proj": (_V.hidden_size, _V.hidden_size),
               "fc1": (_V.mlp_dim, _V.hidden_size), "fc2": (_V.hidden_size, _V.mlp_dim)}
# (rows of a, linears, route): the train step's 4 x 2048 tokens and a
# serving prefill chunk of 512 on Llama2-1B, ViT-Giant's 24 x 257 tokens
# padded to 6,400, and decode steps of 8 and 16 slots
K2_CASES = [(M, name, linears, sm90)
            for M, linears, sm90 in ((8192, LLAMA_LINEARS, True), (512, LLAMA_LINEARS, True),
                                     (6400, VIT_LINEARS, True), (8, LLAMA_LINEARS, False),
                                     (16, LLAMA_LINEARS, False))
            for name in linears]


@pytest.mark.parametrize("M,name,linears,sm90", K2_CASES,
                         ids=[f"M{M}-{name}-N{lin[name][0]}-K{lin[name][1]}" for M, name, lin, _ in K2_CASES])
def test_k2_route(M, name, linears, sm90):
    """K2 above 16 rows takes the sm90 mainloop; a decode step takes the
    decode stream, whatever the linear."""
    N, K = linears[name]
    assert SCALED_MM.sm90_route(M) is sm90
    assert bool(SCALED_MM.decode_route(M, N, K)) is not sm90


# linear -> the decode stream's CTAs a cluster at Llama2-1B's four linear
# shapes, at decode steps of 1, 8 and 16 slots
DECODE_SPLITS = {"q/o": 4, "k/v": 8, "gate/up": 2, "down": 4}
DECODE_CASES = [(M, name) for M in (1, 8, 16) for name in LLAMA_LINEARS]


@pytest.mark.parametrize("M,name", DECODE_CASES, ids=[f"M{M}-{n}" for M, n in DECODE_CASES])
def test_k2_decode_route(M, name):
    """Every decode step's K2 takes the split-K weight stream at the CTAs a
    cluster ``DECODE_SPLITS`` names, whatever the slots: as many as bring
    the grid of 16-row tiles to ``DECODE_CTAS`` (about four an SM), at most
    8 (a portable cluster) and at most K's 128-byte steps."""
    N, K = LLAMA_LINEARS[name]
    splits = SCALED_MM.decode_route(M, N, K)
    assert splits == DECODE_SPLITS[name]
    steps, tiles = -(-K // SCALED_MM.DECODE_BK), -(-N // SCALED_MM.DECODE_ROWS)
    assert 1 <= splits <= min(SCALED_MM.DECODE_MAX_SPLITS, steps)
    assert tiles * splits >= SCALED_MM.DECODE_CTAS or splits == min(SCALED_MM.DECODE_MAX_SPLITS, steps)
    assert tiles * (splits - 1) < SCALED_MM.DECODE_CTAS


@pytest.mark.parametrize("M,N,K,aligned", [(17, 2048, 2048, True), (8192, 5632, 2048, True), (8, 2048, 2048, False),
                                           (8, 2048, 2056, True), (8, 2048, 0, True), (0, 2048, 2048, True),
                                           (8, 96, 256, True), (16, 256, 512, True)])
def test_k2_decode_route_refuses(M, N, K, aligned):
    """The decode stream takes no M above 16 (the sm90 mainloop's), no
    operand off a 16-byte boundary, no K that TMA cannot describe (K % 16
    != 0, K = 0) and no weight below ``DECODE_MIN_BYTES`` (where the wmma
    tile measured faster): the route gives 0 there."""
    assert SCALED_MM.decode_route(M, N, K, aligned) == 0


@pytest.mark.parametrize("N,K", [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (200, 2064), (128, 2048)])
def test_k2_decode_splits_cover_k_and_the_outputs(N, K):
    """A mirror of ``decode_stream``'s bounds: CTA rank k of a cluster of
    ``splits`` takes K steps [k steps / splits, (k + 1) steps / splits),
    none empty, together every step once; and outputs [k E / splits, (k + 1)
    E / splits) of its tile's E = 16 x 8 NT, together every output once."""
    for M in (1, 8, 9, 16):
        splits = SCALED_MM.decode_route(M, N, K)
        steps = -(-K // SCALED_MM.DECODE_BK)
        runs = [range(k * steps // splits, (k + 1) * steps // splits) for k in range(splits)]
        assert all(len(r) > 0 for r in runs) and [i for r in runs for i in r] == list(range(steps))
        E = SCALED_MM.DECODE_ROWS * 8 * (1 if M <= 8 else 2)
        shares = [range(k * E // splits, (k + 1) * E // splits) for k in range(splits)]
        assert [e for r in shares for e in r] == list(range(E))


def test_k2_decode_constants_match_the_kernel():
    """The route's step, rows a CTA and cluster limit are the kernel's
    (``csrc/scaled_mm.cu``): a route the entry would refuse
    (cudaErrorInvalidValue) is never given."""
    src = (_build.CSRC / "scaled_mm.cu").read_text()
    assert f"constexpr int kDecodeBK = {SCALED_MM.DECODE_BK};" in src
    assert f"constexpr int kDecodeMaxSplits = {SCALED_MM.DECODE_MAX_SPLITS};" in src
    assert f"constexpr int kDecodeRows = {SCALED_MM.DECODE_ROWS};" in src


def _operand(shape, dtype, offset=0):
    """A contiguous CPU tensor of ``shape`` starting ``offset`` elements into
    a 16-byte aligned allocation."""
    n = shape[0] * shape[1]
    return torch.zeros(n + 16, dtype=dtype)[offset:offset + n].view(shape)


@pytest.mark.parametrize("M,K,N,dtype,b_offset,sm90", [
    (1024, 1024, 1024, torch.bfloat16, 0, True),
    (2048, 2048, 2048, torch.bfloat16, 0, True),
    (4096, 4096, 4096, torch.bfloat16, 0, True),
    (200, 304, 136, torch.bfloat16, 0, True),
    (200, 300, 136, torch.bfloat16, 0, False),  # a's rows are 600 bytes long
    (1024, 1024, 1024, torch.bfloat16, 1, False),  # b starts 2 bytes off a 16-byte boundary
    (1024, 1024, 1024, torch.int8, 0, True),  # the producer transposes b's MN-major tiles (S8MnB)
    (200, 304, 144, torch.int8, 0, True),
    (4096, 4096, 4096, torch.int8, 0, True),
    (1024, 1024, 1024, torch.int8, 1, False),  # b starts 1 byte off a 16-byte boundary
    (200, 304, 136, torch.int8, 0, False),  # b's rows are 136 bytes long (N % 16 != 0)
    (200, 300, 144, torch.int8, 0, False),  # a's rows are 300 bytes long (K % 16 != 0)
    (200, 0, 144, torch.int8, 0, False),  # K = 0: no tensor map describes it
])
def test_b17_route(M, K, N, dtype, b_offset, sm90):
    """B17 takes the sm90 mainloop exactly where TMA can describe both
    operands, in either form; the rest keeps the wmma kernel."""
    a, b = _operand((M, K), dtype), _operand((K, N), dtype, b_offset)
    assert a.is_contiguous() and b.is_contiguous()
    assert MATMUL.sm90_route(a, b) is sm90


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
    taken for CUDA ones by the wrappers' device checks."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: self.device.type == "meta"))
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("M,sm90", [(8, False), (16, False), (17, True), (8192, True)])
def test_k2_passes_its_route(library, M, sm90):
    """K2's wrapper passes ``sm90_route(M)`` as the argument before the
    stream of ``qt_scaled_mm_s8`` above the decode sizes, and at them calls
    ``qt_scaled_mm_decode`` with ``decode_route``'s CTAs a cluster as the
    argument before the stream, one argument per ``_SIGNATURES`` entry
    either way; it counts the launch in ``launches`` and on its route in
    ``sm90_launches`` or ``decode_launches``."""
    a, b = _meta((M, 256), torch.int8), _meta((2048, 256), torch.int8)
    ops.scaled_mm_rhs_t(a, b, _meta((M, 1), torch.bfloat16), _meta((1, 2048), torch.bfloat16))
    (name, args), = library.calls
    assert name == ("qt_scaled_mm_s8" if sm90 else "qt_scaled_mm_decode")
    assert len(args) == len(_build._SIGNATURES[name])
    if sm90:
        assert args[-2] == 1
    else:
        assert args[5:8] == (M, 2048, 256) and args[-2] == SCALED_MM.decode_route(M, 2048, 256) == 2
    counts = ops.launch_counts()
    assert counts["scaled_mm_rhs_t"] == 1 and counts["scaled_mm_rhs_t_sm90"] == int(sm90)
    assert counts["scaled_mm_rhs_t_decode"] == int(not sm90)


@pytest.mark.parametrize("M,name", DECODE_CASES, ids=[f"M{M}-{n}" for M, n in DECODE_CASES])
@pytest.mark.parametrize("scale_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)])
def test_k2_passes_the_decode_route(library, M, name, scale_dtype, out_dtype):
    """At every decode step's linear K2's wrapper calls the decode stream's
    entry with the operands' shapes, the scale and output type flags and
    ``decode_route``'s CTAs a cluster, and counts it there and nowhere
    else."""
    N, K = LLAMA_LINEARS[name]
    out = ops.scaled_mm_rhs_t(_meta((M, K), torch.int8), _meta((N, K), torch.int8), _meta((M, 1), scale_dtype),
                              _meta((1, N), scale_dtype), out_dtype=out_dtype)
    (fn, args), = library.calls
    assert fn == "qt_scaled_mm_decode" and len(args) == len(_build._SIGNATURES[fn]) == 12
    assert args[5:10] == (M, N, K, int(scale_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    assert args[10] == DECODE_SPLITS[name] and args[-1] == 0
    assert out.shape == (M, N) and out.dtype == out_dtype
    counts = ops.launch_counts()
    assert counts["scaled_mm_rhs_t"] == counts["scaled_mm_rhs_t_decode"] == 1 and counts["scaled_mm_rhs_t_sm90"] == 0


def test_k2_small_weight_keeps_the_wmma_tile(library):
    """Below ``DECODE_MIN_BYTES`` of weight a decode size passes route 0 to
    ``qt_scaled_mm_s8`` (the wmma tile) and counts no stream launch."""
    ops.scaled_mm_rhs_t(_meta((8, 256), torch.int8), _meta((96, 256), torch.int8), _meta((8, 1), torch.bfloat16),
                        _meta((1, 96), torch.bfloat16))
    (fn, args), = library.calls
    assert fn == "qt_scaled_mm_s8" and args[5:8] == (8, 96, 256) and args[-2] == 0
    counts = ops.launch_counts()
    assert counts["scaled_mm_rhs_t"] == 1 and counts["scaled_mm_rhs_t_decode"] == counts["scaled_mm_rhs_t_sm90"] == 0


def test_k2_decode_off_16_bytes_launches_nothing(library):
    """An operand off a 16-byte boundary has no K2 kernel (TMA and the wmma
    tile's 16-byte loads both need it): the route gives 0 and the wrapper
    raises before any launch."""
    b = torch.empty(2048 * 256 + 16, dtype=torch.int8, device="meta")[1:1 + 2048 * 256].view(2048, 256)
    assert b.data_ptr() % 16 and SCALED_MM.decode_route(8, 2048, 256) and not SCALED_MM.decode_route(8, 2048, 256, False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.scaled_mm_rhs_t(_meta((8, 256), torch.int8), b, _meta((8, 1), torch.bfloat16),
                            _meta((1, 2048), torch.bfloat16))
    assert library.calls == [] and ops.launch_counts()["scaled_mm_rhs_t"] == 0


@pytest.mark.parametrize("tokens,out,inp", [(8192, 512, 256), (1000, 2048, 5632), (520, 256, 1024)])
def test_backward_forms_take_the_mainloop(library, tokens, out, inp):
    """Both backward GEMMs of a linear take the sm90 mainloop and count it:
    B1 (grad_input g [tokens, out] . w [out, in], b MN-major, transposed on
    chip by the producer) and B2 (grad_weight g^T . x over the tokens, both
    operands MN-major); token counts below 1024 that are no multiple of 16
    included, which the JAX package does not pad."""
    g, w = _meta((tokens, out), torch.int8), _meta((out, inp), torch.int8)
    ops.scaled_mm(g, w, _meta((tokens, 1), torch.float32), _meta((1, inp), torch.float32))
    ops.scaled_mm_lhs_t(g, _meta((tokens, inp), torch.int8), _meta((out,), torch.float32),
                        _meta((inp,), torch.float32))
    assert SCALED_MM.rhs_mn_sm90_route(inp, out) and SCALED_MM.lhs_t_sm90_route(out, inp, tokens)
    assert [(name, args[5:10], args[-2]) for name, args in library.calls] == [
        ("qt_scaled_mm_s8", (tokens, inp, out, 1, 0), 1), ("qt_scaled_mm_s8", (out, inp, tokens, 0, 0), 1)]
    counts = ops.launch_counts()
    assert counts["scaled_mm"] == counts["scaled_mm_sm90"] == 1
    assert counts["scaled_mm_lhs_t"] == counts["scaled_mm_lhs_t_sm90"] == 1
    assert counts["scaled_mm_rhs_t_sm90"] == 0


# B2's grad_weight shapes (out features M, in features N, K tokens): every
# linear of the Llama2-1B step (8,192 tokens) and of ViT-Giant's (6,168
# tokens padded to 6,400)
B2_CASES = [(o, i, K, name) for K, linears in ((8192, LLAMA_LINEARS), (6400, VIT_LINEARS))
            for name, (o, i) in linears.items()]


@pytest.mark.parametrize("M,N,K,name", B2_CASES, ids=[f"{n}-M{M}-N{N}-K{K}" for M, N, K, n in B2_CASES])
def test_b2_route(M, N, K, name):
    """Every grad_weight of the Llama2-1B and ViT-Giant steps takes B2's
    sm90 route."""
    assert SCALED_MM.lhs_t_sm90_route(M, N, K) is True


@pytest.mark.parametrize("M,N,K,sm90", [(512, 256, 8192, 1), (16, 16, 16, 1), (5632, 2048, 6400, 1)])
def test_b2_passes_its_route(library, M, N, K, sm90):
    """B2's wrapper passes ``lhs_t_sm90_route(M, N, K)`` as the argument
    before the stream, one argument per ``_SIGNATURES`` entry, with both
    operands flagged MN-major, and counts the launch on that route."""
    ops.scaled_mm_lhs_t(_meta((K, M), torch.int8), _meta((K, N), torch.int8), _meta((M,), torch.bfloat16),
                        _meta((N,), torch.bfloat16))
    (name, args), = library.calls
    assert name == "qt_scaled_mm_s8" and len(args) == len(_build._SIGNATURES[name])
    assert args[5:10] == (M, N, K, 0, 0) and args[-2] == int(SCALED_MM.lhs_t_sm90_route(M, N, K)) == sm90
    counts = ops.launch_counts()
    assert counts["scaled_mm_lhs_t"] == 1 and counts["scaled_mm_lhs_t_sm90"] == sm90


def test_b2_refuses_what_no_kernel_takes(library):
    """B2 has no kernel but the sm90 mainloop: a shape TMA cannot describe
    (K = 0 here; M or N not a multiple of 16 is refused by the operand
    checks as well) raises before any launch, not on another route."""
    assert SCALED_MM.lhs_t_sm90_route(512, 256, 0) is False
    assert SCALED_MM.lhs_t_sm90_route(8, 256, 8192) is False and SCALED_MM.lhs_t_sm90_route(512, 24, 8192) is False
    with pytest.raises(ValueError, match="sm90 mainloop"):
        ops.scaled_mm_lhs_t(_meta((0, 512), torch.int8), _meta((0, 256), torch.int8), _meta((512,), torch.bfloat16),
                            _meta((256,), torch.bfloat16))
    assert library.calls == [] and ops.launch_counts()["scaled_mm_lhs_t"] == 0


# B16's (M, N, K unpacked) in int4 mixed precision's Llama2-1B step at
# 8,192 tokens: the forward x . w^T, grad_input g . w and grad_weight
# g^T . x of every linear; then the decode sizes, a K TMA cannot describe
# packed, and the largest K the mainloop sums exactly
B16_CASES = ([(8192, o, i, f"{name}-forward", True) for name, (o, i) in LLAMA_LINEARS.items()]
             + [(8192, i, o, f"{name}-grad_input", True) for name, (o, i) in LLAMA_LINEARS.items()]
             + [(o, i, 8192, f"{name}-grad_weight", True) for name, (o, i) in LLAMA_LINEARS.items()]
             + [(8, 2048, 2048, "decode", False), (16, 5632, 2048, "decode", False),
                (17, 5632, 2048, "above-decode", True), (512, 2048, 48, "K-not-32", False),
                (512, 256, (1 << 17) - 32, "largest-K", True), (512, 256, 1 << 17, "K-past-int32-range", False),
                (512, 256, 0, "K-zero", False)])


@pytest.mark.parametrize("M,N,K,name,sm90", B16_CASES, ids=[f"{n}-M{M}-N{N}-K{K}" for M, N, K, n, _ in B16_CASES])
def test_b16_route(M, N, K, name, sm90):
    """B16 above 16 rows with K % 32 == 0 on aligned operands takes the sm90
    mainloop, which every int4 matmul of the Llama2-1B step does; decode
    sizes, K % 32 != 0, K = 0 (no tensor map describes it), K from 2^17 on
    (where the mainloop's int32 sum of 256 x each product could overflow)
    and operands off a 16-byte boundary keep the wmma kernel."""
    assert INT4_MM.sm90_route(M, K) is sm90
    assert INT4_MM.sm90_route(M, K, aligned=False) is False


@pytest.mark.parametrize("M,K,sm90", [(8, 256, 0), (17, 256, 1), (8192, 2048, 1), (64, 48, 0)])
def test_b16_passes_its_route(library, M, K, sm90):
    """B16's wrapper passes ``sm90_route(M, K)`` as the argument before the
    stream, one argument per ``_SIGNATURES`` entry (the unpacked K before
    the scale and output flags), and counts the launch in ``launches`` and,
    on the sm90 route, in ``sm90_launches``."""
    N = 96
    ops.scaled_int4_mm(_meta((M, K // 2), torch.int8), _meta((N, K // 2), torch.int8), _meta((M, 1), torch.float32),
                       _meta((1, N), torch.float32))
    (name, args), = library.calls
    assert name == "qt_scaled_int4_mm" and len(args) == len(_build._SIGNATURES[name]) == 12
    assert args[5:8] == (M, N, K) and args[-2] == sm90
    counts = ops.launch_counts()
    assert counts["scaled_int4_mm"] == 1 and counts["scaled_int4_mm_sm90"] == sm90


@pytest.mark.parametrize("dtype,out_dtype,sm90", [(torch.bfloat16, torch.float32, True),
                                                  (torch.bfloat16, torch.bfloat16, True),
                                                  (torch.int8, torch.int32, True)])
def test_b17_passes_its_route(library, dtype, out_dtype, sm90):
    """B17's wrapper passes ``sm90_route(a, b)`` as the argument before the
    stream and counts a launch on the sm90 route in ``sm90_launches`` (bf16)
    or ``s8_sm90_launches`` (int8)."""
    a, b = _meta((256, 128), dtype), _meta((128, 64), dtype)
    ops.matmul(a, b, out_dtype=out_dtype)
    (name, args), = library.calls
    assert name == "qt_matmul" and len(args) == len(_build._SIGNATURES[name])
    assert args[-2] == int(sm90)
    counts, s8 = ops.launch_counts(), dtype == torch.int8
    assert counts["matmul_s8_sm90" if s8 else "matmul_sm90"] == int(sm90)
    assert counts["matmul_sm90" if s8 else "matmul_s8_sm90"] == 0
    assert counts["matmul_s8" if s8 else "matmul"] == 1


@pytest.mark.parametrize("M,K,N,offset,sm90", [(64, 128, 96, 1, 0), (64, 128, 40, 0, 0), (64, 40, 96, 0, 0)])
def test_b17_s8_keeps_wmma_where_tma_cannot(library, M, K, N, offset, sm90):
    """B17's int8 form off a 16-byte boundary, or with rows TMA cannot
    describe, passes route 0 (the wmma kernel) with the operands' vector
    flags, and counts no sm90 launch."""
    a = _meta((M, K), torch.int8)
    b = torch.empty(K * N + 16, dtype=torch.int8, device="meta")[offset:offset + K * N].view(K, N)
    assert b.data_ptr() == offset and MATMUL.sm90_route(a, b) is bool(sm90)
    ops.matmul(a, b)
    (name, args), = library.calls
    assert name == "qt_matmul" and args[3:6] == (M, N, K)
    assert args[-4:-1] == (int(MATMUL.vec_rows(a)), int(MATMUL.vec_rows(b)), sm90)
    counts = ops.launch_counts()
    assert counts["matmul_s8"] == 1 and counts["matmul_s8_sm90"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,sr", [(8192, 2048, False), (8192, 256, True), (6400, 4608, False), (7, 1030, True)])
def test_b5_passes_its_arguments(library, M, K, sr, dtype):
    """B5's wrapper calls its C entry once with one argument per
    ``_SIGNATURES`` entry: the input, the four outputs at their shapes, the
    fp32 [K] scratch, M, K, eps, the dtype and SR flags, the two keys split
    from the call's (0 without SR) and the stream; it counts the launch per
    form."""
    key = 12345 if sr else None
    q_row, s_row, q_col, s_col = ops.quantize_int8_both(_meta((M, K), dtype), sr=sr, key=key)
    (name, args), = library.calls
    assert name == "qt_quantize_int8_both" and len(args) == len(_build._SIGNATURES[name]) == 14
    assert args[6:8] == (M, K) and args[8] == ops.int8_quant.EPS
    assert args[9:11] == (int(dtype == torch.bfloat16), int(sr))
    assert args[11:13] == (ops.random.split(key) if sr else (0, 0)) and args[-1] == 0
    assert (q_row.shape, s_row.shape, q_col.shape, s_col.shape) == ((M, K), (M, 1), (M, K), (1, K))
    assert q_row.dtype == q_col.dtype == torch.int8 and s_row.dtype == s_col.dtype == dtype
    counts = ops.launch_counts()
    assert counts["quantize_int8_both_sr" if sr else "quantize_int8_both"] == 1
    assert counts["quantize_int8_both" if sr else "quantize_int8_both_sr"] == 0


# B1's grad_input shapes (M tokens, N in features, K out features): every
# linear of the Llama2-1B step (8,192 tokens) and of ViT-Giant's (6,400
# padded tokens)
B1_CASES = [(M, i, o, name) for M, linears in ((8192, LLAMA_LINEARS), (6400, VIT_LINEARS))
            for name, (o, i) in linears.items()]


@pytest.mark.parametrize("M,N,K,name", B1_CASES, ids=[f"{n}-M{M}-N{N}-K{K}" for M, N, K, n in B1_CASES])
def test_b1_passes_its_route(library, M, N, K, name):
    """Every grad_input of the Llama2-1B and ViT-Giant steps takes B1's sm90
    route: the wrapper passes ``rhs_mn_sm90_route(N, K)`` = 1 as the argument
    before the stream, a flagged K-major and b MN-major, and counts the
    launch in ``launches`` and ``sm90_launches``."""
    assert SCALED_MM.rhs_mn_sm90_route(N, K) is True
    ops.scaled_mm(_meta((M, K), torch.int8), _meta((K, N), torch.int8), _meta((M, 1), torch.bfloat16),
                  _meta((1, N), torch.bfloat16))
    (fn, args), = library.calls
    assert fn == "qt_scaled_mm_s8" and len(args) == len(_build._SIGNATURES[fn])
    assert args[5:10] == (M, N, K, 1, 0) and args[-2] == 1
    counts = ops.launch_counts()
    assert counts["scaled_mm"] == counts["scaled_mm_sm90"] == 1


def test_b1_refuses_what_no_kernel_takes(library):
    """B1 has no kernel but the sm90 mainloop: K = 0 (no tensor map
    describes it) raises before any launch, not on another route; a row
    length off 16 bytes is refused by the operand checks."""
    assert SCALED_MM.rhs_mn_sm90_route(256, 0) is False
    assert SCALED_MM.rhs_mn_sm90_route(24, 256) is False and SCALED_MM.rhs_mn_sm90_route(256, 40) is False
    with pytest.raises(ValueError, match="sm90 mainloop"):
        ops.scaled_mm(_meta((64, 0), torch.int8), _meta((0, 256), torch.int8), _meta((64, 1), torch.bfloat16),
                      _meta((1, 256), torch.bfloat16))
    with pytest.raises(ValueError, match="row length a multiple of 16"):
        ops.scaled_mm(_meta((64, 40), torch.int8), _meta((40, 256), torch.int8), _meta((64, 1), torch.bfloat16),
                      _meta((1, 256), torch.bfloat16))
    assert library.calls == [] and ops.launch_counts()["scaled_mm"] == 0


@pytest.mark.parametrize("K", [1000, 520, 8200, 17])
def test_b2_takes_a_ragged_token_count(library, K):
    """B2 contracts over the tokens, its operands' outer axis, which TMA
    zero-fills past K: a token count that is no multiple of 16 (the JAX
    package pads none below 1024) passes to the library as it is, on the
    sm90 route."""
    ops.scaled_mm_lhs_t(_meta((K, 512), torch.int8), _meta((K, 256), torch.int8), _meta((512,), torch.bfloat16),
                        _meta((256,), torch.bfloat16))
    (fn, args), = library.calls
    assert args[5:10] == (512, 256, K, 0, 0) and args[-2] == 1
    assert ops.launch_counts()["scaled_mm_lhs_t_sm90"] == 1


@pytest.mark.parametrize("M,K,padded,sm90", [(64, 1000, 1024, 1), (1000, 24, 32, 1), (8, 1000, 1024, 0)])
def test_b16_pads_a_ragged_contraction(library, M, K, padded, sm90):
    """B16's packed K-major operands take no K that is off a multiple of 16
    (a grad_weight over 1,000 tokens, say): the wrapper pads both with zero
    bytes to a multiple of 32 values, which also gives the sm90 route above
    the decode sizes, and passes the padded K."""
    N = 96
    ops.scaled_int4_mm(_meta((M, K // 2), torch.int8), _meta((N, K // 2), torch.int8), _meta((M, 1), torch.float32),
                       _meta((1, N), torch.float32))
    (fn, args), = library.calls
    assert fn == "qt_scaled_int4_mm" and args[5:8] == (M, N, padded) and args[-2] == sm90
    assert ops.launch_counts()["scaled_int4_mm_sm90"] == sm90


# B15's (M, K, N, QM, QN, QK): fp8 tile mixed precision's forward,
# grad_input and grad_weight of gate/up and down at 8,192 tokens (QK = 128),
# then the other quant blocks the wrapper takes
B15_CASES = [(8192, 2048, 5632, 1, 128, 128, 1), (8192, 5632, 2048, 1, 128, 128, 1),
             (5632, 8192, 2048, 1, 128, 128, 1), (2048, 8192, 5632, 1, 128, 128, 1),
             (256, 1024, 256, 128, 64, 256, 1), (256, 768, 256, 1, 128, 192, 0), (256, 640, 256, 1, 128, 320, 0)]


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.int8])
@pytest.mark.parametrize("M,K,N,qm,qn,qk,sm90", B15_CASES)
def test_b15_passes_its_route(library, M, K, N, qm, qn, qk, sm90, dtype):
    """B15's wrapper passes ``sm90_route(qk)`` (QK % 128 == 0) as the
    argument before the stream, one argument per ``_SIGNATURES`` entry, and
    counts the launch per operand type, on the sm90 route also in
    ``sm90_launches`` (e4m3) or ``s8_sm90_launches`` (int8)."""
    assert TILE_MM.sm90_route(qk) is bool(sm90)
    ops.tile_scaled_mm(_meta((M, K), dtype), _meta((K, N), dtype), _meta((M // qm, K // qk), torch.float32),
                       _meta((K // qk, N // qn), torch.float32))
    (fn, args), = library.calls
    assert fn == "qt_tile_scaled_mm" and len(args) == len(_build._SIGNATURES[fn])
    assert args[5:12] == (M, N, K, qm, qk, qn, int(dtype != torch.int8)) and args[-2] == sm90
    counts, t = ops.launch_counts(), "_s8" if dtype == torch.int8 else ""
    assert counts[f"tile_scaled_mm{t}"] == 1 and counts[f"tile_scaled_mm{t}_sm90"] == sm90
