"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips (decided in a
fixture, not at import). On the card: ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py -q`` (the suite's conftest imports jax, which
this file does not need). Tolerance: none for K1/K2/B1-B6, B9, B11-B14, B16,
B15's int8 form, B17's int8 form and B18's GELU forms — each is bit-exact with its plain
version by construction, K1 and K2 at the storage schemes' forms too (a
stored or scalar column scale, eps 1e-5, a stacked weight), and the
2-layer storage steps are held to chip_smoke.py phase 14's bounds.
The row walks of B7, B8 and B10 give their first designs' bits (B10's dx; its
dgamma sums in the walk's order, run after run the same). B15's e4m3 form sums a block in the tensor core in
fp32: within (QK + n_qk) fp32 roundings of the folded magnitudes. B7, B8, B10
and B18's LayerNorm forms hold a row sum that the kernel takes in its own
fixed order: int8 within one step on at
most 1e-3 of the elements, scales and column maxima within 1e-6 relative, dx
within 2 bf16 ulps (below 2**-20 of max|dx|, where the closed form cancels,
within that), dgamma within 1e-5 of max|dgamma|. B17's bf16 form sums in fp32
in its own order: a rounding of a value within ``fp32_sum_bound`` of the
float64 product. B19 differs from its plain version in the order of p's row
sums (and in any exponential rounded otherwise):
``ops/int8_attention.py::agreement``.
"""

import importlib

import pytest
import torch

from quantized_training_tpu_torch import ops, quant, train
from quantized_training_tpu_torch.benchmark_mm import within_rounding
from quantized_training_tpu_torch.models import vit
from quantized_training_tpu_torch.quant import mixed_precision as MP
from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight
from quantized_training_tpu_torch.utils.tree import tree_leaves

# the modules: the ops package exports functions of their names
TILE_MM = importlib.import_module("quantized_training_tpu_torch.ops.tile_scaled_mm")
MATMUL = importlib.import_module("quantized_training_tpu_torch.ops.matmul")
ATTN = importlib.import_module("quantized_training_tpu_torch.ops.int8_attention")
FP = importlib.import_module("quantized_training_tpu_torch.ops.fused_producers")
IQ = importlib.import_module("quantized_training_tpu_torch.ops.int8_quant")
ROPE = importlib.import_module("quantized_training_tpu_torch.ops.rope")
SCALED_MM = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a kernels)")


def _rand(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (8, 64), (5, 100), (8, 1024), (3, 1030), (8, 2048), (40, 5632),
                                   (2, 3, 4, 64)])
def test_quantize_rowwise_bit_exact(shape, dtype):
    x = _rand(shape, dtype, 0)
    x.view(-1, shape[-1])[0] = 0  # an all-zero row
    q, s = ops.quantize_int8_rowwise(x)
    torch.cuda.synchronize()
    q_ref, s_ref = ops.quantize_int8_plain(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


def test_quantize_rowwise_unaligned_view():
    """A row view starting off a 16-byte boundary takes the scalar path."""
    for K in (64, 2048):  # the warp-per-row and the block-per-row kernel
        base = _rand((9, K), torch.bfloat16, 1).reshape(-1)
        x = base[1:1 + 8 * K].view(8, K)
        q, s = ops.quantize_int8_rowwise(x)
        q_ref, s_ref = ops.quantize_int8_plain(x)
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(1, 32, 16), (8, 256, 2048), (8, 2048, 5632), (17, 40, 48), (96, 5632, 2048),
                                   (130, 200, 272)])
def test_scaled_mm_bit_exact(M, N, K, scale_dtype, out_dtype):
    g = torch.Generator(device="cuda").manual_seed(M * N + K)
    a = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    b = torch.randint(-128, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
    sa = (torch.rand(M, 1, generator=g, device="cuda") * 0.01).to(scale_dtype)
    sb = (torch.rand(1, N, generator=g, device="cuda") * 0.01).to(scale_dtype)
    out = ops.scaled_mm_rhs_t(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = ops.scaled_mm_rhs_t_plain(a, b, sa, sb, out_dtype=out_dtype)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("K", [2048, 5632])
@pytest.mark.parametrize("N", [200, 256, 2048, 5632])
@pytest.mark.parametrize("M", [17, 64, 100, 512, 8192])
def test_scaled_mm_sm90_bit_exact(M, N, K):
    """K2 on the TMA + wgmma mainloop (M > 16) at the training, ViT and
    prefill sizes, with M not a multiple of the 128-row tile and N not of
    the 128-column one: bit-exact with the plain version in every scale and
    output type, every launch on the sm90 route."""
    g = torch.Generator(device="cuda").manual_seed(M * N + K)
    a = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    b = torch.randint(-128, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
    ops.reset_launch_counts()
    for scale_dtype in (torch.bfloat16, torch.float32):
        sa = (torch.rand(M, 1, generator=g, device="cuda") * 0.01).to(scale_dtype)
        sb = (torch.rand(1, N, generator=g, device="cuda") * 0.01).to(scale_dtype)
        for out_dtype in (torch.bfloat16, torch.float32):
            out = ops.scaled_mm_rhs_t(a, b, sa, sb, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(out, ops.scaled_mm_rhs_t_plain(a, b, sa, sb, out_dtype=out_dtype))
    counts = ops.launch_counts()
    assert counts["scaled_mm_rhs_t"] == counts["scaled_mm_rhs_t_sm90"] == 4


@pytest.mark.parametrize("M", [1, 8, 16])
def test_scaled_mm_decode_takes_the_stream(M):
    """K2 at decode sizes takes the split-K weight stream: bit-exact with
    the plain version and with the wmma tile, its first design (the route
    forced to 0), one launch counted on the decode route, none on sm90."""
    g = torch.Generator(device="cuda").manual_seed(M)
    a = torch.randint(-128, 128, (M, 2048), generator=g, device="cuda", dtype=torch.int8)
    b = torch.randint(-128, 128, (5632, 2048), generator=g, device="cuda", dtype=torch.int8)
    sa, sb = torch.rand(M, 1, device="cuda"), torch.rand(1, 5632, device="cuda")
    ops.reset_launch_counts()
    out = ops.scaled_mm_rhs_t(a, b, sa, sb)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.scaled_mm_rhs_t_plain(a, b, sa, sb))
    assert counts["scaled_mm_rhs_t"] == counts["scaled_mm_rhs_t_decode"] == 1 and counts["scaled_mm_rhs_t_sm90"] == 0
    route = SCALED_MM.decode_route
    try:
        SCALED_MM.decode_route = lambda *args: 0
        assert torch.equal(out, ops.scaled_mm_rhs_t(a, b, sa, sb))
    finally:
        SCALED_MM.decode_route = route


# K2's decode stream: Llama2-1B's four linear shapes (N, K) and an N off 16
# with a K off 32
DECODE_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (200, 2064)]


@pytest.mark.parametrize("N,K", DECODE_SHAPES)
@pytest.mark.parametrize("M", list(range(1, 17)))
def test_scaled_mm_decode_stream_bit_exact(M, N, K):
    """K2's split-K weight stream at every decode size (M 1-16, one n8 tile
    of x's rows up to 8, two above) and shape: bit-exact with the plain
    version in bf16 and fp32 scales and outputs, every launch on the decode
    route."""
    g = torch.Generator(device="cuda").manual_seed(M * N + K)
    a = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    b = torch.randint(-128, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
    assert SCALED_MM.decode_route(M, N, K)
    ops.reset_launch_counts()
    for scale_dtype, out_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)):
        sa = (torch.rand(M, 1, generator=g, device="cuda") * 0.01).to(scale_dtype)
        sb = (torch.rand(1, N, generator=g, device="cuda") * 0.01).to(scale_dtype)
        out = ops.scaled_mm_rhs_t(a, b, sa, sb, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, ops.scaled_mm_rhs_t_plain(a, b, sa, sb, out_dtype=out_dtype))
    counts = ops.launch_counts()
    assert counts["scaled_mm_rhs_t"] == counts["scaled_mm_rhs_t_decode"] == 2


# K1: every shape chip_smoke.py's check_k1 holds it at (a decode step's
# activations, prefill chunks, the train step's activations, the four
# weights, the KV rows of 64) and ragged row counts
K1_SHAPES = [(8, 2048), (8, 5632), (16, 2048), (512, 2048), (512, 5632), (8192, 2048), (8192, 5632), (2048, 2048),
             (256, 2048), (5632, 2048), (2048, 5632), (32, 64), (2048, 64), (1, 2048), (3, 2048), (263, 2048),
             (263, 5632)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", K1_SHAPES, ids=[f"{m}x{k}" for m, k in K1_SHAPES])
def test_k1_walk_bit_exact(monkeypatch, shape, dtype, sr):
    """K1 on the persistent row walk, RN and SR, wherever a walk layout
    tiles the row (the route forced to it for the SR form below its least
    rows and above its most at two vectors a thread): the plain version's
    bits and its first design's (the route forced to 0), scales included,
    the same bits on a second run; counted on the walk where its route
    takes it."""
    x = (_rand(shape, dtype, shape[0] + shape[1]) * 0.01).to(dtype)
    x[0] = 0  # an all-zero row
    kw = dict(sr=sr, key=123457 if sr else None)
    route = IQ.rowwise_sm90_route
    layout = route(*shape, dtype)
    ops.reset_launch_counts()
    got = ops.quantize_int8_rowwise(x, **kw)
    counts = ops.launch_counts()
    t = "_sr" if sr else ""
    assert counts[f"quantize_int8_rowwise{t}"] == 1
    assert counts[f"quantize_int8_rowwise{t}_sm90"] == int(bool(route(*shape, dtype, sr)))
    monkeypatch.setattr(IQ, "rowwise_sm90_route", lambda M, K, dt, sr=False: route(M, K, dt))
    walk = ops.quantize_int8_rowwise(x, **kw)
    again = ops.quantize_int8_rowwise(x, **kw)
    monkeypatch.setattr(IQ, "rowwise_sm90_route", lambda *args: 0)
    first = ops.quantize_int8_rowwise(x, **kw)
    torch.cuda.synchronize()
    ref = ops.quantize_int8_plain(x, **kw)
    for outs in (got, walk, again, first):
        assert torch.equal(outs[0], ref[0]) and torch.equal(outs[1], ref[1])
    assert bool(layout) is (shape[1] >= 1024 and not (dtype == torch.float32 and shape[1] == 5632))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (64, 128), (130, 200), (256, 2048), (8192, 256), (1000, 5632),
                                   (2048, 5632), (16, 8192), (5, 8200), (1, 2048), (3, 1024)])
def test_quantize_colwise_and_both_bit_exact(shape, dtype):
    """B4 and B5, ragged shapes (rows not a multiple of the 64-row split,
    columns not of the 16-byte vector) and an all-zero row and column; B5's
    every row-pass width (1, 2 or 4 warps a row; 8, 2 or 1 rows a warp),
    the longest rows it holds in registers (1024 vectors), and the first
    design's cases: longer rows, and too few rows to hold a CTA's column
    maxima in q_col."""
    x = _rand(shape, dtype, 3)
    x[0] = 0
    x[:, -1] = 0
    q, s = ops.quantize_int8_colwise(x)
    torch.cuda.synchronize()
    q_ref, s_ref = ops.quantize_int8_plain(x, axis=0)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    got = ops.quantize_int8_both(x)
    torch.cuda.synchronize()
    for a, b in zip(got, ops.quantize_int8_both_plain(x)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


# the output gradients B5 quantizes in the bench.py step (q/o and down
# [8192, 2048], k/v [8192, 256]) and in ViT-Giant's (qkv, fc1, proj and fc2
# at 6,400 padded tokens)
B5_STEP_SHAPES = [(8192, 2048), (8192, 256), (6400, 4608), (6400, 1536), (6400, 6144)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("shape", B5_STEP_SHAPES)
def test_quantize_both_at_the_step_shapes(shape, sr):
    """B5 and B5-SR bit-exact at every shape the steps launch them at,
    gradient-sized bf16 values with an all-zero row and column."""
    x = _rand(shape, torch.bfloat16, 11) * 1e-3
    x[0] = 0
    x[:, 1] = 0
    kw = dict(sr=True, key=2**62 + 7) if sr else {}
    ops.reset_launch_counts()
    got = ops.quantize_int8_both(x, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, ops.quantize_int8_both_plain(x, **kw)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert ops.launch_counts()["quantize_int8_both_sr" if sr else "quantize_int8_both"] == 1


# the mesh forms' shapes: ragged ones, the first designs' cases (K1's rows
# under 1024, B5's rows past 1024 vectors and too few rows for its parts),
# and a rank's step shapes (x2d at local batch 1 x 2048; the Llama2-1B
# weights' halves under fsdp 2; TP's row-parallel inputs over 2 ranks)
MESH_FORM_SHAPES = [(1, 1), (3, 7), (64, 128), (130, 200), (3, 1030), (16, 8200), (2048, 2048), (2048, 5632),
                    (1024, 2048), (128, 2048), (2816, 2048), (1024, 5632), (512, 1024), (512, 2816)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MESH_FORM_SHAPES)
def test_mesh_forms_bit_exact(shape, dtype, sr):
    """K1's, B4's and B5's mesh forms: each maxima form gives the fp32 max
    |x| exactly (B5's its row quantize too), K1's given form and the given
    column cast (given larger maxima, as another rank's would make them)
    their plain versions' int8 and scales bit for bit, RN and SR; one
    launch each, under its own counter."""
    x = _rand(shape, dtype, 17)
    x[0] = 0
    x[:, -1] = 0
    kw = dict(sr=True, key=2**62 + 9) if sr else {}
    t = "_sr" if sr else ""
    ops.reset_launch_counts()
    rows = IQ.quantize_int8_rowwise_maxima(x)
    cols = IQ.quantize_int8_colwise_maxima(x)
    q_row, s_row, both_cols = IQ.quantize_int8_both_maxima(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rows, IQ.quantize_int8_maxima_plain(x, -1))
    assert torch.equal(cols, IQ.quantize_int8_maxima_plain(x, 0)) and torch.equal(both_cols, cols)
    kr = dict(sr=True, key=ops.random.split(kw["key"])[0]) if sr else {}
    for a, b in zip((q_row, s_row), ops.quantize_int8_plain(x, axis=1, **kr)):
        assert torch.equal(a, b)
    wide_rows, wide_cols = rows * 2, cols * 2  # larger maxima, as another rank's would give
    for got, ref in ((IQ.quantize_int8_rowwise_given(x, wide_rows, **kw),
                      ops.quantize_int8_plain(x, axis=-1, amax=wide_rows, **kw)),
                     (IQ.quantize_int8_colwise_given(x, wide_cols, **kw),
                      ops.quantize_int8_plain(x, axis=0, amax=wide_cols, **kw))):
        torch.cuda.synchronize()
        assert all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref))
    n = ops.launch_counts()
    for name in ("rowwise_maxima", "colwise_maxima"):
        assert n[f"quantize_int8_{name}"] == 1
    for name in ("both_maxima", "rowwise_given", "colwise_given"):
        assert n[f"quantize_int8_{name}{t}"] == 1


def test_quantize_colwise_and_both_unaligned_view():
    """A view starting off a 16-byte boundary takes the scalar loops."""
    base = _rand((9, 512), torch.bfloat16, 4).reshape(-1)
    x = base[1:1 + 8 * 512].view(8, 512)
    q, s = ops.quantize_int8_colwise(x)
    assert torch.equal(q, ops.quantize_int8_plain(x, axis=0)[0])
    for a, b in zip(ops.quantize_int8_both(x), ops.quantize_int8_both_plain(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (8, 64), (5, 100), (3, 1030), (64, 128), (130, 200),
                                   (256, 2048), (1000, 5632)])
def test_sr_forms_bit_exact(shape, dtype):
    """The SR forms of K1, B4 and B5 against their plain versions with the
    same key: the same Philox words, the same floor(x / scale + u), so
    equal bits, on vector and ragged paths and all-zero rows/columns."""
    x = _rand(shape, dtype, 5)
    x[0] = 0
    x[:, -1] = 0
    for kernel, plain in ((ops.quantize_int8_rowwise, ops.quantize_int8_plain),
                          (ops.quantize_int8_colwise, lambda x, **kw: ops.quantize_int8_plain(x, axis=0, **kw)),
                          (ops.quantize_int8_both, ops.quantize_int8_both_plain)):
        got = kernel(x, sr=True, key=2**63 + 12345)
        torch.cuda.synchronize()
        ref = plain(x, sr=True, key=2**63 + 12345)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
    q_rn = ops.quantize_int8_rowwise(x)[0]
    assert not torch.equal(ops.quantize_int8_rowwise(x, sr=True, key=1)[0], q_rn) or x.numel() < 64


def test_sr_forms_unaligned_view():
    base = _rand((9, 2048), torch.bfloat16, 6).reshape(-1)
    x = base[1:1 + 8 * 2048].view(8, 2048)
    for kernel, plain in ((ops.quantize_int8_rowwise, ops.quantize_int8_plain),
                          (ops.quantize_int8_both, ops.quantize_int8_both_plain)):
        for a, b in zip(kernel(x, sr=True, key=9), plain(x, sr=True, key=9)):
            assert torch.equal(a, b)


def _adamw_inputs(n, p_dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = (torch.randn(n, generator=g, device="cuda") * 0.02).to(p_dtype)
    grad = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(p_dtype)
    ea = (torch.randn(n, generator=g, device="cuda") * 1e-4).to(torch.bfloat16)
    eas = (torch.rand(n, generator=g, device="cuda") * 1e-7).to(torch.bfloat16)
    t = 3
    scalars = torch.tensor([3e-4, 0.9, 0.999, 1e-2, 1e-8, 1 - 0.9**t, 1 - 0.999**t], device="cuda")
    return p, grad, ea, eas, scalars


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 7, 8, 1000, 2048 * 3 + 5, 2048 * 256])
def test_fused_adamw_bit_exact(n, p_dtype, sr):
    """B6 against its plain version (eager torch ops on the card), all three
    outputs, SR writeback on and off; n off the 8-element vector."""
    if sr and p_dtype == torch.float32:
        pytest.skip("the SR writeback is for bf16 parameters only")
    p, g, ea, eas, scalars = _adamw_inputs(n, p_dtype, n)
    got = ops.fused_adamw_update(p, g, ea, eas, scalars, 77, bf16_sr=sr)
    torch.cuda.synchronize()
    ref = ops.fused_adamw_plain(p, g, ea, eas, scalars, 77, bf16_sr=sr)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [7, 2048 * 3 + 5, 2048 * 256])
def test_fused_adamw_in_place_bit_exact(n, p_dtype, sr):
    """B6's in-place instantiation (``in_place``: a donated state) writes
    the plain version's bits into p, ea and eas themselves, vector and
    ragged tail alike, and an unaligned view in place too."""
    if sr and p_dtype == torch.float32:
        pytest.skip("the SR writeback is for bf16 parameters only")
    p, g, ea, eas, scalars = _adamw_inputs(n, p_dtype, n)
    ref = ops.fused_adamw_plain(p, g, ea, eas, scalars, 77, bf16_sr=sr)
    ptrs = [t.data_ptr() for t in (p, ea, eas)]
    got = ops.fused_adamw_update(p, g, ea, eas, scalars, 77, bf16_sr=sr, in_place=True)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in got] == ptrs
    for a, b in zip((p, ea, eas), ref):
        assert torch.equal(a, b)
    views = [t[1:] for t in _adamw_inputs(n + 1, p_dtype, 1)[:4]]
    ref = ops.fused_adamw_plain(*views, scalars, 3, bf16_sr=sr)
    ops.fused_adamw_update(*views, scalars, 3, bf16_sr=sr, in_place=True)
    for a, b in zip((views[0], views[2], views[3]), ref):
        assert torch.equal(a, b)


def test_fused_adamw_unaligned_and_refusals():
    p, g, ea, eas, scalars = _adamw_inputs(4096 + 1, torch.bfloat16, 1)
    views = [t[1:] for t in (p, g, ea, eas)]
    for a, b in zip(ops.fused_adamw_update(*views, scalars, 3, bf16_sr=True),
                    ops.fused_adamw_plain(*views, scalars, 3, bf16_sr=True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bf16 p and a key"):
        ops.fused_adamw_update(p.float(), g.float(), ea, eas, scalars, 3, bf16_sr=True)
    with pytest.raises(TypeError, match="moments must be bf16"):
        ops.fused_adamw_update(p, g, ea.float(), eas, scalars, 3, bf16_sr=False)


def _int8_close(got, ref, what):
    d = (got.int() - ref.int()).abs()
    assert got.dtype == torch.int8 and d.max() <= 1 and (d > 0).float().mean() <= 1e-3, (
        what, d.max().item(), (d > 0).float().mean().item())


def _rel_close(got, ref, tol, what):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert ((got - ref).abs() <= tol * ref.abs()).all(), (what, ((got - ref).abs() / ref.abs()).nan_to_num().max())


def _bf16_ulps(a, b):
    """Distance of bf16 values in units in the last place."""
    def order(t):
        bits = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def _producer_inputs(M, K, dtype, seed):
    x = _rand((M, K), dtype, seed)
    x[0] = 0  # an all-zero row
    g = (1 + 0.1 * _rand((K,), torch.float32, seed + 1)).to(dtype)
    a, b = _rand((M, K), dtype, seed + 2), _rand((M, K), dtype, seed + 3)
    a[:, 5] = 0  # an all-zero column of silu(a) * b
    return x, g, a, b


_PRODUCER_SHAPES = [(32, 128), (96, 640), (256, 2048), (1000, 5632)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", _PRODUCER_SHAPES)
def test_fused_producer_row_forms(M, K, dtype, sr):
    """B7 and B9's row form, with and without the column absmax, and their
    SR forms with one key, against their plain versions."""
    x, g, a, b = _producer_inputs(M, K, dtype, 10)
    kw = dict(sr=sr, key=2**63 + 5 if sr else None)
    for amax in (False, True):
        got = ops.rmsnorm_quant_rowwise(x, g, with_col_amax=amax, **kw)
        torch.cuda.synchronize()
        ref = ops.rmsnorm_quant_rowwise_plain(x, g, with_col_amax=amax, **kw)
        _int8_close(got[0], ref[0], "B7 q")
        for t, r in zip(got[1:], ref[1:]):
            _rel_close(t, r, 1e-6, "B7 scale / column absmax")
        got = ops.silu_mul_quant_rowwise(a, b, with_col_amax=amax, **kw)
        torch.cuda.synchronize()
        for t, r in zip(got, ops.silu_mul_quant_rowwise_plain(a, b, with_col_amax=amax, **kw)):
            assert t.dtype == r.dtype and torch.equal(t, r)


# B7 at the Llama2-1B step's norm sites, and at a row count that fills no
# whole step of the walk's groups
_B7_PATH_SHAPES = [(8192, 2048), (1001, 2048)]


@pytest.mark.parametrize("walk", [True, False])
@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K", _B7_PATH_SHAPES)
def test_b7_at_the_path_shape(monkeypatch, M, K, sr, walk):
    """B7 on the row walk (``norm_rows_sm90_route``, the path's route at K =
    2048 bf16) and on the first design (the route forced to 0), with and
    without the column absmax, and its SR form: within B7's bars of the
    plain version, each launch counted on the route it took."""
    if not walk:
        monkeypatch.setattr(FP, "norm_rows_sm90_route", lambda K, dtype: 0)
    x, g, _, _ = _producer_inputs(M, K, torch.bfloat16, 60)
    kw = dict(sr=sr, key=2**61 + 3 if sr else None)
    for amax in (False, True):
        ops.reset_launch_counts()
        got = ops.rmsnorm_quant_rowwise(x, g, with_col_amax=amax, **kw)
        torch.cuda.synchronize()
        t = "_sr" if sr else ""
        counts = ops.launch_counts()
        assert counts[f"rmsnorm_quant_rowwise{t}"] == 1 and counts[f"rmsnorm_quant_rowwise{t}_sm90"] == int(walk)
        ref = ops.rmsnorm_quant_rowwise_plain(x, g, with_col_amax=amax, **kw)
        _int8_close(got[0], ref[0], "B7 q")
        for t_, r in zip(got[1:], ref[1:]):
            _rel_close(t_, r, 1e-6, "B7 scale / column absmax")


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K", [*_B7_PATH_SHAPES, (256, 1024), (64, 8192)])
def test_b7_walk_gives_the_first_designs_bits(monkeypatch, M, K, sr):
    """The row walk keeps the first design's sum of squares, so B7's
    outputs (q, the row scales, the column absmax) are the first design's
    bit for bit, at 32, 64 and 256 threads a row; given that column absmax
    at [8192, 2048], B8's one-pass form equals its two-pass form bit for
    bit."""
    x, g, _, _ = _producer_inputs(M, K, torch.bfloat16, 70)
    kw = dict(sr=sr, key=123 if sr else None)
    assert FP.norm_rows_sm90_route(K, torch.bfloat16)
    walk = ops.rmsnorm_quant_rowwise(x, g, with_col_amax=True, **kw)
    with monkeypatch.context() as m:
        m.setattr(FP, "norm_rows_sm90_route", lambda K, dtype: 0)
        first = ops.rmsnorm_quant_rowwise(x, g, with_col_amax=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(walk, first))
    one = ops.rmsnorm_quant_colwise(x, g, scale=walk[2] * (1.0 / 127.0), **kw)
    two = ops.rmsnorm_quant_colwise(x, g, **kw)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1].reshape(-1), two[1].reshape(-1))


# B9's row form at the fused layer's silu site, at 256 rows, and at a
# width whose vectors the walk cannot tile (the first design)
_B9_SHAPES = [(8192, 5632), (256, 5632), (512, 640)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K", _B9_SHAPES)
def test_b9_row_walk_bit_exact(monkeypatch, M, K, sr):
    """B9's row form and its SR form on the route ``silu_rows_sm90_route``
    gives (the row walk at K = 5632 bf16), with and without the column
    absmax: bit-exact with the plain version in every output, each launch
    counted on the route it took, and the walk's outputs the first design's
    (the route forced to 0) bit for bit."""
    _, _, a, b = _producer_inputs(M, K, torch.bfloat16, 80)
    kw = dict(sr=sr, key=2**61 + 9 if sr else None)
    walk = int(FP.silu_rows_sm90_route(K, torch.bfloat16) > 0)
    assert walk == int(K == 5632)
    t = "_sr" if sr else ""
    for amax in (True, False):
        ops.reset_launch_counts()
        got = ops.silu_mul_quant_rowwise(a, b, with_col_amax=amax, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[f"silu_mul_quant_rowwise{t}"] == 1 and counts[f"silu_mul_quant_rowwise{t}_sm90"] == walk
        ref = ops.silu_mul_quant_rowwise_plain(a, b, with_col_amax=amax, **kw)
        assert len(got) == len(ref)
        for x, r in zip(got, ref):
            assert x.dtype == r.dtype and x.shape == r.shape and torch.equal(x, r)
        with monkeypatch.context() as m:
            m.setattr(FP, "silu_rows_sm90_route", lambda K, dtype: 0)
            first = ops.silu_mul_quant_rowwise(a, b, with_col_amax=amax, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, first))


# the silu column forms at the Llama2-1B step's FFN width, 256 rows of it,
# a ragged row count and a width the walk cannot tile (route 0)
_SILU_COL_SHAPES = [(8192, 5632), (256, 5632), (1000, 5632), (512, 640)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K", _SILU_COL_SHAPES)
def test_b9_col_walk_bit_exact(monkeypatch, M, K, sr):
    """B9's column form given the row form's column scales, and its SR form,
    on the route ``silu_cols_sm90_route`` gives (the row walk at K = 5632
    bf16: 352 threads of two vectors, SR 704 of one): bit-exact with the
    plain version, the same bits on a second run, each launch counted on
    the route it took, and the walk's q the first design's (the route
    forced to 0) bit for bit."""
    _, _, a, b = _producer_inputs(M, K, torch.bfloat16, 90)
    kw = dict(sr=sr, key=2**61 + 11 if sr else None)
    scale = ops.silu_mul_quant_rowwise(a, b, with_col_amax=True)[2] * (1.0 / 127.0)
    walk = int(FP.silu_cols_sm90_route(K, torch.bfloat16, sr) > 0)
    assert walk == int(K == 5632)
    t = "_sr" if sr else ""
    ops.reset_launch_counts()
    got = ops.silu_mul_quant_colwise(a, b, scale=scale, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts[f"silu_mul_quant_colwise{t}"] == 1 and counts[f"silu_mul_quant_colwise{t}_sm90"] == walk
    ref = ops.silu_mul_quant_colwise_plain(a, b, scale=scale, **kw)
    for x, r in zip(got, ref):
        assert x.dtype == r.dtype and x.shape == r.shape and torch.equal(x, r)
    assert all(torch.equal(x, y) for x, y in zip(got, ops.silu_mul_quant_colwise(a, b, scale=scale, **kw)))
    with monkeypatch.context() as m:
        m.setattr(FP, "silu_cols_sm90_route", lambda *a: 0)
        ops.reset_launch_counts()
        first = ops.silu_mul_quant_colwise(a, b, scale=scale, **kw)
        assert ops.launch_counts()[f"silu_mul_quant_colwise{t}_sm90"] == 0
    assert all(torch.equal(x, y) for x, y in zip(got, first))


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K", _SILU_COL_SHAPES)
def test_b12_walk_bit_exact(monkeypatch, M, K, sr):
    """B12 given B11's column scales, and its SR form, on the route
    ``silu_bwd_cols_sm90_route`` gives (B11's row walk at K = 5632 bf16, 704
    threads of one vector):
    qa and qb bit-exact with the plain version, the same bits on a second
    run, each launch counted on the route it took, and both the first
    design's (the route forced to 0) bit for bit."""
    _, _, a, b = _producer_inputs(M, K, torch.bfloat16, 95)
    dy = _rand((M, K), torch.bfloat16, 98) * 1e-3
    dy[:, 3] = 0  # an all-zero column of (da, db)
    kw = dict(sr=sr, key=2**63 + 29 if sr else None)
    scales = [m * (1.0 / 127.0) for m in ops.silu_mul_bwd_quant_rowwise(a, b, dy)[4:]]
    walk = int(FP.silu_bwd_cols_sm90_route(K, torch.bfloat16) > 0)
    assert walk == int(K == 5632)
    t = "_sr" if sr else ""
    ops.reset_launch_counts()
    got = ops.silu_mul_bwd_quant_colwise(a, b, dy, *scales, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts[f"silu_mul_bwd_quant_colwise{t}"] == 1 and counts[f"silu_mul_bwd_quant_colwise{t}_sm90"] == walk
    ref = ops.silu_mul_bwd_quant_colwise_plain(a, b, dy, *scales, **kw)
    for x, r in zip(got, ref):
        assert x.dtype == r.dtype and x.shape == r.shape and torch.equal(x, r)
    assert all(torch.equal(x, y) for x, y in zip(got, ops.silu_mul_bwd_quant_colwise(a, b, dy, *scales, **kw)))
    with monkeypatch.context() as m:
        m.setattr(FP, "silu_bwd_cols_sm90_route", lambda K, dtype: 0)
        ops.reset_launch_counts()
        first = ops.silu_mul_bwd_quant_colwise(a, b, dy, *scales, **kw)
        assert ops.launch_counts()[f"silu_mul_bwd_quant_colwise{t}_sm90"] == 0
    assert all(torch.equal(x, y) for x, y in zip(got, first))


# B4 at the fused step's four weight shapes, ViT-Giant's proj input and fc2
# weight (a 48 KB tile beside 2.5 KB of static shared memory: past the
# default limit), the unfused layer's down input, a ragged row count and
# rows below the cluster's 8 CTAs
_B4_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (6400, 1536), (1536, 6144), (8192, 5632),
              (1000, 2048), (3, 2048)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,C", _B4_SHAPES)
def test_b4_cluster_bit_exact(R, C, dtype, sr):
    """B4 and B4-SR on the cluster route (``colwise_sm90_route``) against
    ``quantize_int8_plain(x, axis=0)``, weight-sized values with an
    all-zero column and row: q and the scales bit-exact, the launch counted
    on the route; the same input through the first design (a view one
    element in, which keeps it) gives the same bits."""
    x = _rand((R, C), dtype, 90) * 0.02
    x[:, 3] = 0
    x[R // 2] = 0
    kw = dict(sr=sr, key=2**62 + 11 if sr else None)
    route = IQ.colwise_sm90_route(R, C, dtype)
    assert route
    ops.reset_launch_counts()
    q, s = ops.quantize_int8_colwise(x, **kw)
    torch.cuda.synchronize()
    t = "_sr" if sr else ""
    counts = ops.launch_counts()
    assert counts[f"quantize_int8_colwise{t}"] == 1 and counts[f"quantize_int8_colwise{t}_sm90"] == 1
    q_ref, s_ref = ops.quantize_int8_plain(x, axis=0, **kw)
    assert q.dtype == q_ref.dtype and s.dtype == s_ref.dtype and s.shape == s_ref.shape
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    if R * C <= 2048 * 2048:
        base = torch.empty(R * C + 1, dtype=dtype, device="cuda")
        view = base[1:].view(R, C)
        view.copy_(x)
        q1, s1 = ops.quantize_int8_colwise(view, **kw)
        assert ops.launch_counts()[f"quantize_int8_colwise{t}_sm90"] == 1
        assert torch.equal(q1, q) and torch.equal(s1, s)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", _PRODUCER_SHAPES)
def test_fused_producer_col_forms(M, K, dtype, sr):
    """B8 and B9's column form, given the forward's scales (the path's
    form) and in two passes, and their SR forms, against their plain
    versions; given the forward kernel's own column absmax, the one-pass
    form equals the two-pass one bit for bit."""
    x, g, a, b = _producer_inputs(M, K, dtype, 20)
    kw = dict(sr=sr, key=77 if sr else None)
    amax_n = ops.rmsnorm_quant_rowwise(x, g, with_col_amax=True)[2]
    amax_s = ops.silu_mul_quant_rowwise(a, b, with_col_amax=True)[2]
    for scale_n, scale_s in ((amax_n * (1.0 / 127.0), amax_s * (1.0 / 127.0)), (None, None)):
        got = ops.rmsnorm_quant_colwise(x, g, scale=scale_n, **kw)
        torch.cuda.synchronize()
        ref = ops.rmsnorm_quant_colwise_plain(x, g, scale=scale_n, **kw)
        _int8_close(got[0], ref[0], "B8 q")
        _rel_close(got[1], ref[1], 1e-6, "B8 scale")
        got = ops.silu_mul_quant_colwise(a, b, scale=scale_s, **kw)
        torch.cuda.synchronize()
        for t, r in zip(got, ops.silu_mul_quant_colwise_plain(a, b, scale=scale_s, **kw)):
            assert t.dtype == r.dtype and torch.equal(t, r)
    for fn, inputs, amax in ((ops.rmsnorm_quant_colwise, (x, g), amax_n), (ops.silu_mul_quant_colwise, (a, b), amax_s)):
        one, two = fn(*inputs, scale=amax * (1.0 / 127.0), **kw), fn(*inputs, **kw)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1].reshape(-1), two[1].reshape(-1))


# B8 and B10 at the Llama2-1B step's norm sites, and at a ragged row count
_B8_B10_SHAPES = [(8192, 2048), (1000, 2048)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("M,K", _B8_B10_SHAPES)
def test_b8_walk_gives_the_first_designs_bits(monkeypatch, M, K, sr):
    """B8 given B7's column scales, on the row walk (``norm_cols_sm90_route``,
    the path's route at K = 2048 bf16) and on the first design (the route
    forced to 0), and its SR form: q bit-identical on both routes, within
    B8's bars of the plain version, each launch counted on the route it
    took."""
    x, g, _, _ = _producer_inputs(M, K, torch.bfloat16, 110)
    kw = dict(sr=sr, key=2**61 + 13 if sr else None)
    assert FP.norm_cols_sm90_route(K, torch.bfloat16)
    scale = ops.rmsnorm_quant_rowwise(x, g, with_col_amax=True)[2] * (1.0 / 127.0)
    t = "_sr" if sr else ""
    got = {}
    for walk in (True, False):
        with monkeypatch.context() as m:
            if not walk:
                m.setattr(FP, "norm_cols_sm90_route", lambda K, dtype: 0)
            ops.reset_launch_counts()
            got[walk] = ops.rmsnorm_quant_colwise(x, g, scale=scale, **kw)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts[f"rmsnorm_quant_colwise{t}"] == 1
            assert counts[f"rmsnorm_quant_colwise{t}_sm90"] == int(walk)
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    ref = ops.rmsnorm_quant_colwise_plain(x, g, scale=scale, **kw)
    _int8_close(got[True][0], ref[0], "B8 q")


@pytest.mark.parametrize("M,K", _B8_B10_SHAPES)
def test_b10_walk_at_the_path_shape(monkeypatch, M, K):
    """B10 on the row walk (``rmsnorm_bwd_sm90_route``, the path's route at
    K = 2048 bf16): dx bit-identical with the first design's (the route
    forced to 0), dgamma within 1e-5 of max|dgamma| of the plain version
    and the same bits on a second run; each launch counted on the route it
    took."""
    x, g, dy, _ = _producer_inputs(M, K, torch.bfloat16, 120)
    assert FP.rmsnorm_bwd_sm90_route(K, torch.bfloat16)
    ops.reset_launch_counts()
    dx, dg = ops.rmsnorm_bwd(x, g, dy)
    again = ops.rmsnorm_bwd(x, g, dy)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm_bwd"] == ops.launch_counts()["rmsnorm_bwd_sm90"] == 2
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)
    with monkeypatch.context() as m:
        m.setattr(FP, "rmsnorm_bwd_sm90_route", lambda K, dtype: 0)
        first = ops.rmsnorm_bwd(x, g, dy)
    assert ops.launch_counts()["rmsnorm_bwd"] == 3 and ops.launch_counts()["rmsnorm_bwd_sm90"] == 2
    assert torch.equal(dx, first[0])
    dx_ref, dg_ref = ops.rmsnorm_bwd_plain(x, g, dy)
    assert (dg - dg_ref).abs().max() <= 1e-5 * dg_ref.abs().max()
    assert (first[1] - dg_ref).abs().max() <= 1e-5 * dg_ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", [*_PRODUCER_SHAPES, (8192, 2048)])
def test_rmsnorm_bwd_kernel(M, K, dtype):
    """B10 against its plain version: dx within 2 bf16 ulps (or 2**-20 of
    max|dx|), dgamma within 1e-5 of max|dgamma|; a second run gives the
    same bits (dgamma's partial sums meet in a fixed order)."""
    x, g, dy, _ = _producer_inputs(M, K, dtype, 30)
    dx, dg = ops.rmsnorm_bwd(x, g, dy)
    torch.cuda.synchronize()
    dx_ref, dg_ref = ops.rmsnorm_bwd_plain(x, g, dy)
    assert dx.dtype == x.dtype and dg.dtype == torch.float32 and dg.shape == (K,)
    far = (_bf16_ulps(dx, dx_ref) > 2) & ((dx - dx_ref).abs() > 2**-20 * dx_ref.abs().max())
    assert not far.any(), far.sum()
    assert (dg - dg_ref).abs().max() <= 1e-5 * dg_ref.abs().max()
    again = ops.rmsnorm_bwd(x, g, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


# B18 at one small shape and at ViT-Giant's (6,168 tokens padded to 6,400;
# hidden 1536, mlp 6144)
_B18_SHAPES = [(96, 640), (6400, 1536), (6400, 6144)]


def _b18_inputs(M, K, dtype, seed):
    x = (_rand((M, K), dtype, seed) + 0.5).to(dtype)
    x[-1] = 0  # a padded row: LayerNorm makes it b
    g = (1 + 0.1 * _rand((K,), torch.float32, seed + 1)).to(dtype)
    b = (0.1 * _rand((K,), torch.float32, seed + 2)).to(dtype)
    a = _rand((M, K), dtype, seed + 3)
    a[:, 5] = 0  # an all-zero column of gelu(a)
    return x, g, b, a


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", _B18_SHAPES)
def test_b18_forms(M, K, dtype, sr):
    """B18 against its plain versions: LayerNorm's row form (with and without
    the column absmax) and column form (given the forward's scales, and in
    two passes) within B7's bars, GELU's forms bit-exact; given the forward
    kernel's own column absmax, the one-pass column form equals the two-pass
    one bit for bit."""
    x, g, b, a = _b18_inputs(M, K, dtype, 50)
    kw = dict(sr=sr, key=2**62 + 9 if sr else None)
    for amax in (False, True):
        got = ops.layernorm_quant(x, g, b, with_col_amax=amax, **kw)
        torch.cuda.synchronize()
        ref = ops.layernorm_quant_plain(x, g, b, with_col_amax=amax, **kw)
        _int8_close(got[0], ref[0], "B18 LayerNorm row q")
        for t, r in zip(got[1:], ref[1:]):
            _rel_close(t, r, 1e-6, "B18 LayerNorm row scale / column absmax")
        got = ops.gelu_quant(a, with_col_amax=amax, **kw)
        torch.cuda.synchronize()
        for t, r in zip(got, ops.gelu_quant_plain(a, with_col_amax=amax, **kw)):
            assert t.dtype == r.dtype and torch.equal(t, r)
    amax_n = ops.layernorm_quant(x, g, b, with_col_amax=True)[2]
    amax_g = ops.gelu_quant(a, with_col_amax=True)[2]
    for scale_n, scale_g in ((amax_n * (1.0 / 127.0), amax_g * (1.0 / 127.0)), (None, None)):
        got = ops.layernorm_quant(x, g, b, axis=0, scale=scale_n, **kw)
        torch.cuda.synchronize()
        ref = ops.layernorm_quant_plain(x, g, b, axis=0, scale=scale_n, **kw)
        _int8_close(got[0], ref[0], "B18 LayerNorm column q")
        _rel_close(got[1], ref[1], 1e-6, "B18 LayerNorm column scale")
        got = ops.gelu_quant(a, axis=0, scale=scale_g, **kw)
        torch.cuda.synchronize()
        for t, r in zip(got, ops.gelu_quant_plain(a, axis=0, scale=scale_g, **kw)):
            assert t.dtype == r.dtype and torch.equal(t, r)
    for fn, inputs, amax in ((ops.layernorm_quant, (x, g, b), amax_n), (ops.gelu_quant, (a,), amax_g)):
        one, two = fn(*inputs, axis=0, scale=amax * (1.0 / 127.0), **kw), fn(*inputs, axis=0, **kw)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1].reshape(-1), two[1].reshape(-1))


# B18's walks: ViT-Giant's shapes and a ragged row count, and LayerNorm at
# each of its layouts (threads a row x vectors a thread): 32 x 3 (bf16 768),
# 32 x 4 (1024), 128 x 3 (3072), 128 x 3 (fp32 1536); GELU at one vector a
# thread (bf16 3072: 384 threads) and at 256 x 2 (4096)
_B18_WALK = [("layernorm", 6400, 1536, torch.bfloat16), ("layernorm", 1000, 1536, torch.bfloat16),
             ("layernorm", 512, 768, torch.bfloat16), ("layernorm", 512, 1024, torch.bfloat16),
             ("layernorm", 512, 3072, torch.bfloat16), ("layernorm", 512, 1536, torch.float32),
             ("gelu", 6400, 6144, torch.bfloat16), ("gelu", 1000, 6144, torch.bfloat16),
             ("gelu", 512, 3072, torch.bfloat16), ("gelu", 512, 4096, torch.bfloat16)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("form,M,K,dtype", _B18_WALK)
def test_b18_walk_gives_the_first_designs_bits(monkeypatch, form, M, K, dtype, sr):
    """B18's row form (with and without the column absmax) and its column
    form given the forward's scales, on the row walk (``layernorm_rows`` /
    ``layernorm_cols``, ``elementwise_rows`` / ``elementwise_cols`` over
    GELU) and on the first design (each route forced to 0), and their SR
    forms: every output bit-identical on both routes (LayerNorm's too: the
    walk keeps both row sums in the first design's order), within the plain
    versions' bars (GELU bit-exact), each launch counted on the route it
    took; given the walk's column absmax the one-pass column form equals
    the two-pass one (the first design) bit for bit."""
    x, g, b, a = _b18_inputs(M, K, dtype, 130)
    kw = dict(sr=sr, key=2**61 + 17 if sr else None)
    t = "_sr" if sr else ""
    if form == "layernorm":
        args, kernel, plain = (x, g, b), ops.layernorm_quant, ops.layernorm_quant_plain
        routes = ("layernorm_rows_sm90_route", "layernorm_cols_sm90_route")
    else:
        args, kernel, plain = (a,), ops.gelu_quant, ops.gelu_quant_plain
        routes = ("gelu_rows_sm90_route", "gelu_cols_sm90_route")
    assert all(getattr(FP, r)(K, dtype) for r in routes)
    got = {}
    for walk in (True, False):
        with monkeypatch.context() as m:
            if not walk:
                for r in routes:
                    m.setattr(FP, r, lambda K, dtype: 0)
            for amax in (True, False):
                ops.reset_launch_counts()
                got[walk, amax] = kernel(*args, with_col_amax=amax, **kw)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                assert counts[f"{form}_quant_rowwise{t}"] == 1
                assert counts[f"{form}_quant_rowwise{t}_sm90"] == int(walk)
            scale = got[True, True][2] * (1.0 / 127.0)
            ops.reset_launch_counts()
            got[walk, "col"] = kernel(*args, axis=0, scale=scale, **kw)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts[f"{form}_quant_colwise{t}"] == 1 and counts[f"{form}_quant_colwise{t}_sm90"] == int(walk)
    for k in (True, False, "col"):
        assert all(torch.equal(u, v) for u, v in zip(got[True, k], got[False, k])), k
    again = kernel(*args, with_col_amax=True, **kw)
    assert all(torch.equal(u, v) for u, v in zip(again, got[True, True]))
    ref = plain(*args, with_col_amax=True, **kw)
    ref_col = plain(*args, axis=0, scale=scale, **kw)
    if form == "layernorm":
        _int8_close(got[True, True][0], ref[0], "B18 LayerNorm row q")
        for u, r in zip(got[True, True][1:], ref[1:]):
            _rel_close(u, r, 1e-6, "B18 LayerNorm row scale / column absmax")
        _int8_close(got[True, "col"][0], ref_col[0], "B18 LayerNorm column q")
    else:
        assert all(torch.equal(u, r) for u, r in zip(got[True, True], ref))
        assert all(torch.equal(u, r) for u, r in zip(got[True, "col"], ref_col))
    two = kernel(*args, axis=0, **kw)
    assert torch.equal(two[0], got[True, "col"][0])


def test_fused_producers_refuse_what_they_cannot_take():
    x, g, a, b = _producer_inputs(64, 256, torch.bfloat16, 40)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.rmsnorm_quant_rowwise(x[:, :200].contiguous(), g[:200])
    with pytest.raises(ValueError, match="16-byte"):
        ops.silu_mul_quant_rowwise(a.reshape(-1)[1:1 + 63 * 256].view(63, 256), b[:63])
    with pytest.raises(ValueError, match="differ"):
        ops.silu_mul_quant_colwise(a, b.float())
    with pytest.raises(ValueError, match="scale must be fp32"):
        ops.rmsnorm_quant_colwise(x, g, scale=torch.ones(1, 256, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="requires a key"):
        ops.rmsnorm_quant_rowwise(x, g, sr=True)
    with pytest.raises(ValueError, match="beta of 200"):
        ops.layernorm_quant(x, g, g[:200])
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.gelu_quant(a[:, :200].contiguous(), axis=0)


_SILU_BWD_SHAPES = [(32, 128), (96, 640), (1000, 5632), (8192, 5632), (1001, 2048)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", _SILU_BWD_SHAPES)
def test_silu_bwd_forms_bit_exact(M, K, dtype, sr):
    """B11 (with the column absmax, and with the (da, db) copies instead)
    and B12 given B11's column scales, and their SR forms with one key,
    against their plain versions: every output bit-exact; B11 on the route
    ``silu_bwd_rows_sm90_route`` gives (the row walk at bf16 K = 5632, the
    path's shape, and at K = 2048; the first design at bf16 K = 128 and
    640)."""
    _, _, a, b = _producer_inputs(M, K, dtype, 50)
    dy = _rand((M, K), dtype, 53)
    dy[1] = 0  # an all-zero row of (da, db)
    kw = dict(sr=sr, key=2**63 + 7 if sr else None)
    walk = int(FP.silu_bwd_rows_sm90_route(K, dtype) > 0)
    assert walk or not (dtype == torch.bfloat16 and K == 5632)
    for amax, copy in ((True, False), (False, True)):
        ops.reset_launch_counts()
        got = ops.silu_mul_bwd_quant_rowwise(a, b, dy, with_amax=amax, with_bf16=copy, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts()["silu_mul_bwd_quant_rowwise" + ("_sr" if sr else "") + "_sm90"] == walk
        ref = ops.silu_mul_bwd_quant_rowwise_plain(a, b, dy, with_amax=amax, with_bf16=copy, **kw)
        assert len(got) == len(ref) == 6
        for t, r in zip(got, ref):
            assert t.dtype == r.dtype and t.shape == r.shape and torch.equal(t, r)
    scales = [m * (1.0 / 127.0) for m in ops.silu_mul_bwd_quant_rowwise(a, b, dy)[4:]]
    got = ops.silu_mul_bwd_quant_colwise(a, b, dy, *scales, **kw)
    torch.cuda.synchronize()
    for t, r in zip(got, ops.silu_mul_bwd_quant_colwise_plain(a, b, dy, *scales, **kw)):
        assert torch.equal(t, r)


def _rope_tables(S, hd, scale):
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device="cuda", dtype=torch.float32) / hd))
    emb = torch.outer(torch.arange(S, device="cuda", dtype=torch.float32), inv)
    emb = torch.cat([emb, emb], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def _layouts(x, kv):
    """x [B, S, H, hd] as grouped [B, KV, G, S, hd] in [B, S, H, hd] memory
    and in [B, H, S, hd] memory (the layouts SDPA may take or return)."""
    B, S, H, hd = x.shape
    bhsd = x.permute(0, 2, 1, 3).contiguous().view(B, kv, H // kv, S, hd)
    return {"bshd": ops.rope_group_kernel(x, kv=kv), "bhsd": bhsd}


_ROPE_SHAPES = [(4, 2048, 32, 4), (4, 2048, 4, 4), (3, 40, 6, 2), (2, 24, 4, 1)]  # B, S, H, KV


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,KV", _ROPE_SHAPES)
@pytest.mark.parametrize("hd", [64, 128])
def test_rope_relayout_bit_exact(B, S, H, KV, hd, dtype):
    """B13: the grouping with rope (q's pre-scale folded in, [S, hd] and
    pair-tiled tables alike) and without, and the ungrouping with rot^T,
    rot and none, from grouped inputs in both memory layouts, against the
    plain versions."""
    x = _rand((B, S, H, hd), dtype, 60)
    cos, sin = _rope_tables(S, hd, hd**-0.5)
    c2 = torch.cat([cos, cos], dim=-1)
    s2 = torch.cat([sin, sin], dim=-1)
    for c, s in ((cos, sin), (c2, s2), (None, None)):
        got = ops.rope_group_kernel(x, c, s, kv=KV)
        torch.cuda.synchronize()
        assert got.shape == (B, KV, H // KV, S, hd) and torch.equal(got, ops.rope_group_ref(x, c, s, KV))
    for name, y in _layouts(x, KV).items():
        for c, s, inverse in ((cos, sin, True), (cos, sin, False), (None, None, True)):
            got = ops.rope_ungroup_kernel(y, c, s, inverse=inverse)
            torch.cuda.synchronize()
            assert got.is_contiguous() and torch.equal(got, ops.rope_ungroup_ref(y, c, s, inverse=inverse)), name


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,KV", _ROPE_SHAPES)
def test_ungroup_amax_and_quant_bit_exact(B, S, H, KV, dtype, sr):
    """B14: the row and column absmax and the int8 along rows and columns
    (and their SR forms) of the ungrouped view, from grouped inputs in both
    memory layouts, against the plain versions; an all-zero row quantizes
    to 0."""
    x = _rand((B, S, H, 64), dtype, 61)
    x[0, 1] = 0
    kw = dict(sr=sr, key=2**63 + 9 if sr else None)
    for name, y in _layouts(x, KV).items():
        row, col = ops.ungroup_amax(y)
        torch.cuda.synchronize()
        ref = ops.ungroup_amax_plain(y)
        assert torch.equal(row, ref[0]) and torch.equal(col, ref[1]), name
        for axis, m in ((1, row), (0, col)):
            q = ops.ungroup_quant(y, m * (1.0 / 127.0), axis=axis, **kw)
            torch.cuda.synchronize()
            assert torch.equal(q, ops.ungroup_quant_plain(y, m * (1.0 / 127.0), axis=axis, **kw)), (name, axis)
        assert not q[0, 1].any()


def test_rope_kernels_refuse_what_they_cannot_take():
    x = _rand((2, 16, 4, 64), torch.bfloat16, 62)
    with pytest.raises(ValueError, match="hd %"):
        ops.rope_group_kernel(x[..., :24].contiguous(), kv=2)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rope_group_kernel(x.reshape(-1)[4:4 + 2 * 15 * 4 * 64].view(2, 15, 4, 64), kv=2)
    with pytest.raises(TypeError, match="dtype"):
        ops.ungroup_amax(ops.rope_group_kernel(x, kv=2).half())
    with pytest.raises(ValueError, match="fp32"):
        ops.rope_group_kernel(x, torch.ones(16, 64, device="cuda", dtype=torch.bfloat16),
                              torch.zeros(16, 64, device="cuda"), kv=2)
    with pytest.raises(ValueError, match="requires a key"):
        ops.ungroup_quant(ops.rope_group_kernel(x, kv=2), torch.ones(32, device="cuda"), axis=1, sr=True)


# B14 on the row walk: Llama2-1B's attention output [4, 2048, 32, 64] (64
# threads of four vectors), a ragged row count (2 x 500), fp32 (128 of
# four), and the small Llama's 4 heads (32 threads of one vector); B, S, H,
# KV, dtype
_B14_WALK = [(4, 2048, 32, 4, torch.bfloat16), (2, 500, 32, 4, torch.bfloat16), (2, 256, 32, 4, torch.float32),
             (2, 64, 4, 2, torch.bfloat16)]


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("B,S,H,KV,dtype", _B14_WALK)
def test_b14_walk_gives_the_first_designs_bits(monkeypatch, B, S, H, KV, dtype, sr):
    """B14's absmax and its quantize along rows and columns (RN or SR), from
    grouped inputs in [B, S, H, hd] and [B, H, S, hd] memory with an
    all-zero row, on the row walk (``ungroup_absmax_walk``,
    ``ungroup_quant_walk``) and on the first design (the route forced to
    0): the row and column maxima and both int8 outputs bit-identical on
    both routes and with the plain versions, the same bits on a second run
    of the walk, the all-zero row quantized to 0, each launch counted on the
    route it took."""
    x = _rand((B, S, H, 64), dtype, 63)
    x[0, 1] = 0
    kw = dict(sr=sr, key=2**61 + 29 if sr else None)
    t = "_sr" if sr else ""
    assert ROPE.ungroup_sm90_route(H * 64, 64, dtype)

    def b14(y):
        row, col = ops.ungroup_amax(y)
        return (row, col, *(ops.ungroup_quant(y, m * (1.0 / 127.0), axis=axis, **kw) for axis, m in ((1, row), (0, col))))

    for name, y in _layouts(x, KV).items():
        got = {}
        for walk in (True, False):
            with monkeypatch.context() as m:
                if not walk:
                    m.setattr(ROPE, "ungroup_sm90_route", lambda K, hd, dtype: 0)
                ops.reset_launch_counts()
                got[walk] = b14(y)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                assert counts["ungroup_amax"] == 1 and counts["ungroup_amax_sm90"] == int(walk), name
                assert counts[f"ungroup_quant{t}"] == 2 and counts[f"ungroup_quant{t}_sm90"] == 2 * int(walk), name
        assert all(torch.equal(a, b) for a, b in zip(got[True], got[False])), name
        assert all(torch.equal(a, b) for a, b in zip(got[True], b14(y))), name
        row, col, q_row, q_col = got[True]
        ref_row, ref_col = ops.ungroup_amax_plain(y)
        assert torch.equal(row, ref_row) and torch.equal(col, ref_col), name
        for q, axis, m in ((q_row, 1, row), (q_col, 0, col)):
            assert torch.equal(q, ops.ungroup_quant_plain(y, m * (1.0 / 127.0), axis=axis, **kw)), (name, axis)
            assert not q[0, 1].any(), (name, axis)


def _int8(shape, g):
    return torch.randint(-128, 128, shape, generator=g, device="cuda", dtype=torch.int8)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(16, 32, 16), (130, 208, 256), (8192, 256, 256), (96, 2048, 8192),
                                   (200, 5632, 2048)])
def test_scaled_mm_backward_forms_bit_exact(M, N, K, scale_dtype, out_dtype):
    """B1 (a [M, K] . b [K, N]) and B2 (a [K, M]^T . b [K, N]); ragged M and
    N against the 64x64 tile, K = 256 and 8192 (the token contraction of
    grad_weight)."""
    g = torch.Generator(device="cuda").manual_seed(M + N + K)
    sa = (torch.rand(M, 1, generator=g, device="cuda") * 0.01).to(scale_dtype)
    sb = (torch.rand(1, N, generator=g, device="cuda") * 0.01).to(scale_dtype)
    a, b = _int8((M, K), g), _int8((K, N), g)
    out = ops.scaled_mm(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.scaled_mm_plain(a, b, sa, sb, out_dtype=out_dtype))
    if M % 16 == 0:
        at = _int8((K, M), g)
        out = ops.scaled_mm_lhs_t(at, b, sa, sb, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, ops.scaled_mm_lhs_t_plain(at, b, sa, sb, out_dtype=out_dtype))


def test_scaled_mm_rejects_what_it_cannot_take():
    a = torch.zeros(8, 24, dtype=torch.int8, device="cuda")
    s = torch.ones(8, 1, device="cuda")
    with pytest.raises(ValueError, match="K % 16"):
        ops.scaled_mm_rhs_t(a, a, s, s.T)
    b = torch.zeros(32, 24, dtype=torch.int8, device="cuda")  # N = 24 is no multiple of 16
    with pytest.raises(ValueError, match="row length a multiple of 16"):
        ops.scaled_mm_general(b[:8, :16].contiguous(), b[:16], s, torch.ones(1, 24, device="cuda"), dims=(1, 0))
    # tile scales go to B15, whose K quant block is at least 128 wide
    with pytest.raises(ValueError, match="K quant block"):
        ops.scaled_mm(a[:, :16].contiguous(), a[:, :16].T.contiguous(), torch.ones(2, 1, device="cuda"), s.T)
    # B1 has no kernel but the sm90 mainloop, which no tensor map of K = 0 reaches
    with pytest.raises(ValueError, match="sm90 mainloop"):
        ops.scaled_mm(a[:, :0].contiguous(), b[:0, :16].contiguous(), s, torch.ones(1, 16, device="cuda"))
    # B16 pads a K off 16 values with zeros (24 values: test_qlinear_at_a_ragged_token_count),
    # but takes no operand off an 8-byte boundary
    p4 = torch.zeros(8 * 16 + 4, dtype=torch.int8, device="cuda")[4:].view(8, 16)
    with pytest.raises(ValueError, match="8-byte aligned"):
        ops.scaled_int4_mm(p4, a[:, :16].contiguous(), s, s.T)
    # B15's K steps of 64 inside a quant block: QK = 160 is refused
    t = torch.zeros(64, 320, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="QK % 64"):
        ops.tile_scaled_mm(t, t.T.contiguous(), torch.ones(64, 2, device="cuda"), torch.ones(2, 1, device="cuda"))
    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        ops.tile_scaled_mm(t.half(), t.T.contiguous().half(), torch.ones(64, 2, device="cuda"),
                           torch.ones(2, 1, device="cuda"))


def _packed_int4(shape, g):
    """Random packed int4 operands: every byte value, so every nibble pair."""
    return torch.randint(-128, 128, shape, generator=g, device="cuda", dtype=torch.int8)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(1, 32, 16), (8, 2048, 5632), (17, 40, 48), (96, 5632, 2048), (130, 200, 272),
                                   (256, 2048, 8192)])
def test_scaled_int4_mm_bit_exact(M, N, K, scale_dtype, out_dtype):
    """B16 on packed operands [M, K / 2] and [N, K / 2]: decode and training
    tiles, ragged M and N, K = 8192 (grad_weight's token contraction)."""
    g = torch.Generator(device="cuda").manual_seed(M * N + K)
    a, b = _packed_int4((M, K // 2), g), _packed_int4((N, K // 2), g)
    sa = (torch.rand(M, 1, generator=g, device="cuda") * 0.01).to(scale_dtype)
    sb = (torch.rand(1, N, generator=g, device="cuda") * 0.01).to(scale_dtype)
    out = ops.scaled_int4_mm(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.scaled_int4_mm_plain(a, b, sa, sb, out_dtype=out_dtype))


def _each_scale_and_out(kernel, plain, args, M, N, g):
    """``kernel`` on ``args`` and random row and column scales in bf16 and
    fp32, to bf16 and fp32 out, each bit-exact with ``plain``."""
    for scale_dtype in (torch.bfloat16, torch.float32):
        sa = (torch.rand(M, 1, generator=g, device="cuda") * 0.01).to(scale_dtype)
        sb = (torch.rand(1, N, generator=g, device="cuda") * 0.01).to(scale_dtype)
        for out_dtype in (torch.bfloat16, torch.float32):
            out = kernel(*args, sa, sb, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(out, plain(*args, sa, sb, out_dtype=out_dtype))


# B2's grad_weight shapes (out features M, in features N, K tokens): every
# linear of the Llama2-1B step (8,192 tokens) and of ViT-Giant's (6,400
# padded tokens), then ragged M, N and K against the 128 x 128 x 128 tile
B2_SM90_SHAPES = [(2048, 2048, 8192), (256, 2048, 8192), (5632, 2048, 8192), (2048, 5632, 8192),
                  (4608, 1536, 6400), (1536, 1536, 6400), (6144, 1536, 6400), (1536, 6144, 6400),
                  (16, 16, 16), (48, 208, 272), (144, 400, 6400), (272, 96, 8208)]


@pytest.mark.parametrize("M,N,K", B2_SM90_SHAPES)
def test_scaled_mm_lhs_t_sm90_bit_exact(M, N, K):
    """B2 (a [K, M]^T . b [K, N]) on the TMA + wgmma mainloop, whose producer
    transposes each landed tile: bit-exact with the plain version in every
    scale and output type, every launch on the sm90 route."""
    g = torch.Generator(device="cuda").manual_seed(M + N + K)
    a, b = _int8((K, M), g), _int8((K, N), g)
    ops.reset_launch_counts()
    _each_scale_and_out(ops.scaled_mm_lhs_t, ops.scaled_mm_lhs_t_plain, (a, b), M, N, g)
    counts = ops.launch_counts()
    assert counts["scaled_mm_lhs_t"] == counts["scaled_mm_lhs_t_sm90"] == 4


def test_scaled_mm_lhs_t_sm90_views():
    """B2 on operands that are views into larger allocations, 16 bytes past
    their start: exact on the sm90 route; a view off a 16-byte boundary is
    refused (no other route takes it)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    K, M, N = 384, 272, 144
    a = _int8((K * M + 32,), g)[16:16 + K * M].view(K, M)
    b = _int8((K * N + 32,), g)[16:16 + K * N].view(K, N)
    ops.reset_launch_counts()
    _each_scale_and_out(ops.scaled_mm_lhs_t, ops.scaled_mm_lhs_t_plain, (a, b), M, N, g)
    assert ops.launch_counts()["scaled_mm_lhs_t_sm90"] == 4
    off = _int8((K * M + 32,), g)[8:8 + K * M].view(K, M)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.scaled_mm_lhs_t(off, b, torch.ones(M, device="cuda"), torch.ones(N, device="cuda"))


# B1's grad_input shapes (M tokens, N in features, K out features): every
# linear of the Llama2-1B step (8,192 tokens) and of ViT-Giant's (6,400
# padded tokens), then ragged M, N and K against the 128 x 128 x 128 tile
B1_SM90_SHAPES = [(8192, 2048, 2048), (8192, 2048, 256), (8192, 2048, 5632), (8192, 5632, 2048),
                  (6400, 1536, 4608), (6400, 1536, 1536), (6400, 1536, 6144), (6400, 6144, 1536),
                  (130, 208, 272), (17, 16, 16), (1000, 2048, 2048), (8200, 400, 144)]


@pytest.mark.parametrize("M,N,K", B1_SM90_SHAPES)
def test_scaled_mm_b1_sm90_bit_exact(M, N, K):
    """B1 (a [M, K] . b [K, N]) on the TMA + wgmma mainloop, a landed by TMA
    and b transposed by the producer: bit-exact with the plain version in
    every scale and output type, every launch on the sm90 route."""
    g = torch.Generator(device="cuda").manual_seed(M + 3 * N + K)
    a, b = _int8((M, K), g), _int8((K, N), g)
    ops.reset_launch_counts()
    _each_scale_and_out(ops.scaled_mm, ops.scaled_mm_plain, (a, b), M, N, g)
    counts = ops.launch_counts()
    assert counts["scaled_mm"] == counts["scaled_mm_sm90"] == 4


def test_qlinear_at_a_ragged_token_count():
    """A linear over 1,000 tokens, which the JAX package does not pad (it
    pads from 1024 on): int8 and int4 mixed precision, forward and both
    gradients on the card equal the plain versions on the CPU bit for bit.
    B2 contracts over the 1,000 tokens as they are (TMA zero-fills past
    them); B16's grad_weight packs them into 500 bytes a row, which its
    wrapper pads with zeros to 512."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(1000, 256, generator=g)
    w = torch.randn(384, 256, generator=g) * 0.05
    for dtype, gemms in (("int8", ("scaled_mm", "scaled_mm_lhs_t")), ("int4", ("scaled_int4_mm",))):
        res = {}
        for dev in ("cuda", "cpu"):
            xd, wd = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
            ops.reset_launch_counts()
            out = quant.qlinear(xd, MixedPrecisionWeight(wd, quant.MixedPrecisionConfig(dtype=dtype)), key=3)
            res[dev] = [out, *torch.autograd.grad((out ** 2).sum(), (xd, wd))]
            if dev == "cuda":
                counts = ops.launch_counts()
                assert all(counts[k] > 0 and counts[k] == counts[f"{k}_sm90"] for k in gemms), counts
        assert all(torch.equal(c.cpu(), p) for c, p in zip(res["cuda"], res["cpu"])), dtype


def test_vit_step_at_520_tokens():
    """A 2-block ViT at 8 images of 65 tokens (520: below the JAX package's
    1024 from which the linears pad, and no multiple of 16), int8 mixed
    precision: the loss and every gradient on the card (the fused blocks'
    fallback to the unfused linears, B2 over 520 tokens on the sm90 route)
    within phase 7's bounds of the plain versions on the CPU (chip_smoke.py::
    vit_grads_vs_plain: 1e-1 relative RMS a leaf, 1e-3 on the loss)."""
    cfg = vit.ViTConfig(image_size=64, patch_size=8, hidden_size=256, num_layers=2, num_heads=4, num_classes=45,
                        remat=True)
    raw = vit.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    imgs, labels = torch.randn(8, 64, 64, 3, generator=g), torch.randint(0, 45, (8,), generator=g)
    res = {}
    for dev in ("cuda", "cpu"):
        to_dev = lambda t: {k: to_dev(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)
        params = to_dev(raw)
        ops.reset_launch_counts()
        loss, grads = train.value_and_grad(
            lambda p: vit.loss_fn(p, imgs.to(dev), labels.to(dev), cfg), quant.quantize_params(params, "mixed_precision"))
        res[dev] = (loss.item(), [t.double().cpu() for t in tree_leaves(grads)])
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["scaled_mm_lhs_t"] == counts["scaled_mm_lhs_t_sm90"] > 0, counts
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-3 * abs(res["cpu"][0])
    assert all(((a - b).norm() / b.norm()).item() <= 1e-1 for a, b in zip(res["cuda"][1], res["cpu"][1]))


# B16's shapes in chip_smoke.py::gemm_forms (M, N, K unpacked) for gate/up
# and down at 8,192 tokens: forward, grad_input, grad_weight; then ragged M,
# N and K (K % 32 == 0) against the 128 x 128 x 128 tile
B16_SM90_SHAPES = [(8192, 5632, 2048), (8192, 2048, 5632), (8192, 2048, 5632), (8192, 5632, 2048),
                   (5632, 2048, 8192), (2048, 5632, 8192), (17, 40, 96), (130, 200, 288), (300, 136, 32)]


@pytest.mark.parametrize("M,N,K", sorted(set(B16_SM90_SHAPES)))
def test_scaled_int4_mm_sm90_bit_exact(M, N, K):
    """B16 on the TMA + wgmma mainloop, whose producer unpacks each landed
    packed tile: bit-exact with the plain version in every scale and output
    type, every launch on the sm90 route."""
    g = torch.Generator(device="cuda").manual_seed(M * N + K)
    a, b = _packed_int4((M, K // 2), g), _packed_int4((N, K // 2), g)
    ops.reset_launch_counts()
    _each_scale_and_out(ops.scaled_int4_mm, ops.scaled_int4_mm_plain, (a, b), M, N, g)
    counts = ops.launch_counts()
    assert counts["scaled_int4_mm"] == counts["scaled_int4_mm_sm90"] == 4


def test_scaled_int4_mm_sm90_routes_and_views():
    """B16's route: K % 32 != 0 (packed rows TMA cannot describe), a view 8
    bytes off a 16-byte boundary and decode M stay on the wmma kernel, a view
    16 bytes in takes sm90; all bit-exact, each launch counted on its
    route."""
    g = torch.Generator(device="cuda").manual_seed(4)
    M, N, K = 160, 96, 256
    a, b = _packed_int4((M, K // 2), g), _packed_int4((N, K // 2), g)
    view8 = _packed_int4((M * K // 2 + 32,), g)[8:8 + M * K // 2].view(M, K // 2)
    view16 = _packed_int4((M * K // 2 + 32,), g)[16:16 + M * K // 2].view(M, K // 2)
    for args, rows, sm90 in (((a[:, :24].contiguous(), b[:, :24].contiguous()), M, 0), ((view8, b), M, 0),
                             ((a[:16].contiguous(), b), 16, 0), ((view16, b), M, 4)):
        ops.reset_launch_counts()
        _each_scale_and_out(ops.scaled_int4_mm, ops.scaled_int4_mm_plain, args, rows, N, g)
        counts = ops.launch_counts()
        assert counts["scaled_int4_mm"] == 4 and counts["scaled_int4_mm_sm90"] == sm90


def _tile_operands(M, K, N, qm, qn, fp8, g, scale_dtype=torch.float32):
    """int8 operands over the whole range, or e4m3 ones from N(0, 50)
    (saturating at +-448), and random tile scales."""
    if fp8:
        a = (torch.randn(M, K, generator=g, device="cuda") * 50).to(torch.float8_e4m3fn)
        b = (torch.randn(K, N, generator=g, device="cuda") * 50).to(torch.float8_e4m3fn)
    else:
        a, b = _int8((M, K), g), _int8((K, N), g)
    sa = (torch.rand(M // qm, K // 128, generator=g, device="cuda") * 0.01).to(scale_dtype)
    sb = (torch.rand(K // 128, N // qn, generator=g, device="cuda") * 0.01).to(scale_dtype)
    return a, b, sa, sb


TILE_SHAPES = [(64, 256, 128, 1, 128), (130, 512, 256, 2, 128), (256, 1024, 256, 128, 64), (64, 8192, 128, 1, 128),
               (8192, 2048, 5632, 1, 128)]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,qm,qn", TILE_SHAPES)
def test_tile_scaled_mm_int8_bit_exact(M, K, N, qm, qn, scale_dtype, out_dtype):
    """B15's int8 form: exact int32 block partials, each folded as the plain
    version folds it, so equal bits; ragged M, QM 1 / 2 / 128, QN 64 / 128,
    n_qk from 2 to 64 (both regimes of the JAX kernel)."""
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    a, b, sa, sb = _tile_operands(M, K, N, qm, qn, False, g, scale_dtype)
    out = ops.tile_scaled_mm(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.tile_scaled_mm_plain(a, b, sa, sb, out_dtype=out_dtype))


@pytest.mark.parametrize("M,K,N,qm,qn", TILE_SHAPES)
def test_tile_scaled_mm_e4m3_within_fold_bound(M, K, N, qm, qn):
    """B15's e4m3 form: fp32 tensor-core partials of exact fp16 products,
    so within (QK + n_qk) fp32 roundings of the folded magnitudes
    (fold_bound) of the plain version's exact ones, in fp32; its bf16
    output within one bf16 ulp (2**-7 relative) more."""
    g = torch.Generator(device="cuda").manual_seed(M * 3 + K + N)
    a, b, sa, sb = _tile_operands(M, K, N, qm, qn, True, g)
    qk = K // sa.shape[1]
    bound = TILE_MM.fold_bound(a, b, sa, sb, qk + sa.shape[1])
    out = ops.tile_scaled_mm(a, b, sa, sb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    ref = ops.tile_scaled_mm_plain(a, b, sa, sb, out_dtype=torch.float32)
    assert ((out.double() - ref.double()).abs() <= bound).all()
    out16 = ops.tile_scaled_mm(a, b, sa, sb, out_dtype=torch.bfloat16)
    ref16 = ops.tile_scaled_mm_plain(a, b, sa, sb, out_dtype=torch.bfloat16)
    assert ((out16.double() - ref16.double()).abs() <= bound + 2.0**-7 * (ref.double().abs() + bound)).all()


@pytest.mark.parametrize("qk,sm90", [(128, 1), (256, 1), (192, 0)])
def test_tile_scaled_mm_sm90_routes(qk, sm90):
    """B15 takes the sm90 mainloop exactly where QK % 128 == 0 (every call
    of the model: QK = 128), the wmma kernel at QK = 192: both operand types
    match their plain versions (int8 bit-exact, e4m3 within the fold bound)
    and every launch is counted on its route."""
    g = torch.Generator(device="cuda").manual_seed(qk)
    M, K, N = 200, 6 * qk, 256
    for fp8 in (False, True):
        a, b, _, _ = _tile_operands(M, K, N, 1, 128, fp8, g)
        sa = torch.rand(M, K // qk, generator=g, device="cuda") * 0.01
        sb = torch.rand(K // qk, N // 128, generator=g, device="cuda") * 0.01
        ops.reset_launch_counts()
        out = ops.tile_scaled_mm(a, b, sa, sb, out_dtype=torch.float32)
        torch.cuda.synchronize()
        ref = ops.tile_scaled_mm_plain(a, b, sa, sb, out_dtype=torch.float32)
        bound = TILE_MM.fold_bound(a, b, sa, sb, qk + K // qk)
        assert torch.equal(out, ref) if not fp8 else ((out.double() - ref.double()).abs() <= bound).all()
        counts, t = ops.launch_counts(), "_s8" if not fp8 else ""
        assert counts[f"tile_scaled_mm{t}"] == 1 and counts[f"tile_scaled_mm{t}_sm90"] == sm90


def test_launch_counters_count_kernel_launches_only():
    ops.reset_launch_counts()
    x = _rand((64, 64), torch.bfloat16, 2)
    q, s = ops.quantize_int8_plain(x)
    # K1 on the row walk (RN at any row count, SR from 512 rows): counted there too
    ops.quantize_int8_rowwise(_rand((64, 1024), torch.bfloat16, 6))
    qc, sc = ops.quantize_int8_colwise(x)
    qr, sr, qc2, sc2 = ops.quantize_int8_both(x)
    ops.quantize_int8_rowwise(_rand((512, 1024), torch.bfloat16, 7), sr=True, key=1)
    ops.quantize_int8_colwise(x, sr=True, key=1)
    ops.quantize_int8_both(x, sr=True, key=1)
    ops.scaled_mm_rhs_t(q, q, s, s.T)  # M 64: on the sm90 route
    # M 8 on a 256 KB weight: on the decode stream
    (xd, sxd), (wd, swd) = (ops.quantize_int8_plain(_rand(shape, torch.bfloat16, 8)) for shape in ((8, 1024), (256, 1024)))
    ops.scaled_mm_rhs_t(xd, wd, sxd, swd.T)
    ops.scaled_mm(qr, qc, sr, sc)  # B1 and B2 on the sm90 route: counted in both of their counters
    ops.scaled_mm_lhs_t(qc2, qc, sc2, sc)
    adamw_in = _adamw_inputs(64, torch.bfloat16, 0)
    ops.fused_adamw_update(*adamw_in, 1, bf16_sr=False)
    ops.fused_adamw_update(*adamw_in, 1, bf16_sr=True)
    y, gamma = _rand((64, 128), torch.bfloat16, 3), torch.ones(128, device="cuda", dtype=torch.bfloat16)
    # B7, B8, B9 (rows, and columns given scales), B10, B11 and B12 at a
    # width they take on the row walk: counted there too; B4 above on its
    # cluster route ([64, 64]: 2 strips of 4 vectors)
    wide, wide_gamma = _rand((64, 2048), torch.bfloat16, 5), torch.ones(2048, device="cuda", dtype=torch.bfloat16)
    for use_sr in (False, True):
        kw = dict(sr=use_sr, key=1 if use_sr else None)
        amax = ops.rmsnorm_quant_rowwise(wide, wide_gamma, with_col_amax=True, **kw)[2]
        ops.rmsnorm_quant_colwise(wide, wide_gamma, scale=amax * (1.0 / 127.0), **kw)
        amax = ops.silu_mul_quant_rowwise(wide, wide, with_col_amax=True, **kw)[2]
        ops.silu_mul_quant_colwise(wide, wide, scale=amax * (1.0 / 127.0), **kw)
        ops.rmsnorm_quant_rowwise_plain(y, gamma, **kw)
        ops.silu_mul_quant_colwise_plain(y, y, **kw)
    ops.rmsnorm_bwd(wide, wide_gamma, wide)  # on the row walk: counted there too
    ops.rmsnorm_bwd_plain(y, gamma, y)
    ones = torch.ones(1, 2048, device="cuda")
    for use_sr in (False, True):
        kw = dict(sr=use_sr, key=1 if use_sr else None)
        ops.silu_mul_bwd_quant_rowwise(wide, wide, wide, **kw)
        ops.silu_mul_bwd_quant_colwise(wide, wide, wide, ones, ones, **kw)
        ops.silu_mul_bwd_quant_rowwise_plain(wide, wide, wide, **kw)
        ops.silu_mul_bwd_quant_colwise_plain(wide, wide, wide, ones, ones, **kw)
        # B18's row and given-scales column forms on the row walk: counted there too
        amax = ops.layernorm_quant(wide, wide_gamma, wide_gamma, with_col_amax=True, **kw)[2]
        ops.layernorm_quant(wide, wide_gamma, wide_gamma, axis=0, scale=amax * (1.0 / 127.0), **kw)
        amax = ops.gelu_quant(wide, with_col_amax=True, **kw)[2]
        ops.gelu_quant(wide, axis=0, scale=amax * (1.0 / 127.0), **kw)
        ops.layernorm_quant_plain(y, gamma, gamma, **kw)
        ops.gelu_quant_plain(y, axis=0, **kw)
    h = y.view(1, 64, 2, 64)
    grouped = ops.rope_group_kernel(h, kv=1)
    ops.rope_ungroup_kernel(grouped)
    ops.rope_group_ref(h, None, None, 1)
    ops.rope_ungroup_ref(grouped, None, None)
    wide_heads = ops.rope_group_ref(_rand((1, 64, 4, 64), torch.bfloat16, 3), None, None, 2)  # K 256: B14 on the walk
    row, _ = ops.ungroup_amax(wide_heads)
    ops.ungroup_amax_plain(wide_heads)
    ops.ungroup_quant(wide_heads, row, axis=1)
    ops.ungroup_quant(wide_heads, row, axis=1, sr=True, key=1)
    ops.ungroup_quant_plain(wide_heads, row, axis=1, sr=True, key=1)
    ops.quantize_int8_plain(x, sr=True, key=1)
    ops.quantize_int8_both_plain(x)
    ops.scaled_mm_plain(qr, qc, sr, sc)
    ops.scaled_mm_lhs_t_plain(qc2, qc, sc2, sc)
    ops.fused_adamw_plain(*adamw_in, 1, bf16_sr=True)
    ops.scaled_int4_mm(q, q, s, s.T)  # q as packed int4: K = 128, M = 64, on the sm90 route
    ops.scaled_int4_mm_plain(q, q, s, s.T)
    a8 = torch.cat([q, q], dim=1)  # [64, 128]: one K quant block
    e4m3 = a8.to(torch.float8_e4m3fn)
    ones_m, one = torch.ones(64, 1, device="cuda"), torch.ones(1, 1, device="cuda")
    ops.tile_scaled_mm(a8, a8.T.contiguous(), ones_m, one)  # QK = 128: both forms on the sm90 route
    ops.tile_scaled_mm(e4m3, e4m3.T.contiguous(), ones_m, one)
    ops.tile_scaled_mm_plain(e4m3, e4m3.T.contiguous(), ones_m, one)
    ops.scaled_mm(e4m3, e4m3.T.contiguous(), ones_m, ones_m.T)  # fp8 row scales: plain torch
    ops.matmul(y, y.T.contiguous())
    ops.matmul(q, q.T.contiguous())
    ops.matmul_plain(y, y.T.contiguous())
    # B19 at S 128 (block_kv 128): on its sm90 design, counted there too
    qkv = ops.quantize_qkv(*(_rand(shape, torch.bfloat16, 4 + i) for i, shape in enumerate(((2, 128, 64), (128, 64),
                                                                                            (128, 64)))))
    ops.int8_flash_fwd(*qkv)
    ops.int8_flash_fwd_plain(*qkv)
    # K2 once on each of its two routes, every other counter once
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 1), "scaled_mm_rhs_t": 2}
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    ops.gelu_quant(y, axis=0)  # two passes: one launch of the column form, on the first design
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "gelu_quant_colwise": 1}


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (7, 1000, 33), (200, 300, 136), (64, 64, 64), (130, 2048, 200),
                                   (1024, 1024, 1024), (4096, 4096, 4096)])
def test_matmul_forms(M, K, N):
    """B17 at aligned and ragged shapes (masked value by value at the
    edges): int8 -> int32 bit-exact; bf16 -> fp32 / bf16 a rounding of a
    value within the fp32 sum bound of the float64 product."""
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    a8 = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    b8 = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    out = ops.matmul(a8, b8)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and torch.equal(out, ops.matmul_plain(a8, b8))
    a = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(K, N, generator=g, device="cuda").to(torch.bfloat16)
    exact, bound = a.double() @ b.double(), MATMUL.fp32_sum_bound(a, b)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ops.matmul(a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and within_rounding(got, exact, bound)


@pytest.mark.parametrize("M,K,N", [(128, 64, 128), (64, 8, 64), (200, 136, 304), (200, 304, 136),
                                   (1024, 1024, 1024)])
def test_matmul_sm90_within_bound(M, K, N):
    """B17 bf16 on the TMA + wgmma mainloop (b read MN-major through the
    transpose bit): one tile with one K step (128 x 64 x 128, where a wrong
    descriptor offset shows as a permuted output), K below one step, ragged
    M, N and K; fp32 and bf16 out a rounding of a value within the fp32 sum
    bound, every launch on the sm90 route."""
    g = torch.Generator(device="cuda").manual_seed(M * N + K)
    a = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(K, N, generator=g, device="cuda").to(torch.bfloat16)
    exact, bound = a.double() @ b.double(), MATMUL.fp32_sum_bound(a, b)
    ops.reset_launch_counts()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ops.matmul(a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and within_rounding(got, exact, bound)
    counts = ops.launch_counts()
    assert counts["matmul"] == counts["matmul_sm90"] == 2


@pytest.mark.parametrize("M,K,N", [(1024, 1024, 1024), (200, 304, 144), (4096, 4096, 4096), (128, 16, 16),
                                   (130, 2048, 208)])
def test_matmul_s8_sm90_bit_exact(M, K, N):
    """B17's int8 form on the TMA + wgmma mainloop (``S8MnB``: b's MN-major
    tiles transposed by the producer, the int32 sums stored as they are):
    bit-exact at one K step, ragged M, N and K, and at 4096^3, here with
    operands of 100-127 so that the sums (about 5.2e7) lie past the integers
    fp32 holds exactly; every launch on the sm90 route."""
    g = torch.Generator(device="cuda").manual_seed(M + 2 * K + 3 * N)
    lo = 100 if M == 4096 else -128
    a8 = torch.randint(lo, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    b8 = torch.randint(lo, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    ops.reset_launch_counts()
    out = ops.matmul(a8, b8)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and torch.equal(out, ops.matmul_plain(a8, b8))
    counts = ops.launch_counts()
    assert counts["matmul_s8"] == counts["matmul_s8_sm90"] == 1


def test_matmul_s8_wmma_at_an_offset():
    """B17's int8 form on a b that starts off a 16-byte boundary (which TMA
    cannot describe) keeps the wmma kernel, bit-exact."""
    g = torch.Generator(device="cuda").manual_seed(5)
    a8 = torch.randint(-128, 128, (200, 304), generator=g, device="cuda", dtype=torch.int8)
    b8 = torch.randint(-128, 128, (304 * 144 + 1,), generator=g, device="cuda", dtype=torch.int8)[1:].view(304, 144)
    ops.reset_launch_counts()
    out = ops.matmul(a8, b8)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.matmul_plain(a8, b8))
    counts = ops.launch_counts()
    assert counts["matmul_s8"] == 1 and counts["matmul_s8_sm90"] == 0


def test_matmul_unaligned_views_and_refusals():
    """Operands off a 16-byte boundary take the value-by-value loads; other
    forms raise TypeError."""
    g = torch.Generator(device="cuda").manual_seed(1)
    base = torch.randn(64 * 96 + 1, generator=g, device="cuda").to(torch.bfloat16)
    a = base[1:].view(64, 96)
    b = torch.randn(96, 40, generator=g, device="cuda").to(torch.bfloat16)
    ops.reset_launch_counts()
    assert within_rounding(ops.matmul(a, b), a.double() @ b.double(), MATMUL.fp32_sum_bound(a, b))
    assert ops.launch_counts()["matmul_sm90"] == 0  # a base TMA cannot describe takes the wmma kernel
    with pytest.raises(TypeError):
        ops.matmul(a.float(), b.float())
    with pytest.raises(TypeError):
        ops.matmul(a, b, out_dtype=torch.float16)


@pytest.mark.parametrize("lead,G,S,hd,bkv,causal", [
    ((), 4, 256, 64, 128, True),
    ((), 2, 256, 64, 256, True),
    ((), 1, 128, 128, 128, True),
    ((2, 2), 8, 1024, 64, 512, True),
    ((3,), 2, 512, 128, 64, True),
    ((), 2, 256, 64, 128, False),
    ((2,), 4, 2048, 64, 512, True),
    ((2,), 2, 2048, 128, 512, True),
    ((2,), 2, 1024, 64, 128, False),
    ((3,), 2, 768, 64, 384, True),
])
def test_int8_flash_fwd_against_plain(monkeypatch, lead, G, S, hd, bkv, causal):
    """B19 within ``agreement`` of its plain version; where the sm90 route
    takes the shape, the launch is on it (``int8_flash_fwd_sm90``), within
    ``agreement`` of the first design too (the route forced to 0), and the
    same bits on a second run."""
    g = torch.Generator(device="cuda").manual_seed(S + hd + bkv)
    q = (torch.randn(*lead, G, S, hd, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    k = (torch.randn(*lead, S, hd, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    v = torch.randn(*lead, S, hd, generator=g, device="cuda").to(torch.bfloat16)
    qkv = ops.quantize_qkv(q, k, v)
    ops.reset_launch_counts()
    out, lse = ops.int8_flash_fwd(*qkv, causal=causal, block_q=bkv, block_kv=bkv)
    torch.cuda.synchronize()
    route = ATTN.int8_flash_sm90_route(S, hd, bkv, causal)
    counts = ops.launch_counts()
    assert counts["int8_flash_fwd"] == 1 and counts["int8_flash_fwd_sm90"] == int(bool(route))
    ref_out, ref_lse = ops.int8_flash_fwd_plain(*qkv, causal=causal, block_q=bkv, block_kv=bkv)
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    ok, err, share = ATTN.agreement(out, lse, ref_out, ref_lse, qkv[5])
    assert ok, (err, share)
    if causal:
        rel = (out.float() - ops.attention_ref(q, k, v).float()).abs().mean() / v.float().abs().mean()
        assert rel < 0.05, rel
    if route:
        again = ops.int8_flash_fwd(*qkv, causal=causal, block_q=bkv, block_kv=bkv)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        monkeypatch.setattr(ATTN, "int8_flash_sm90_route", lambda *a: 0)
        first = ops.int8_flash_fwd(*qkv, causal=causal, block_q=bkv, block_kv=bkv)
        ok, err, share = ATTN.agreement(out, lse, *first, qkv[5])
        assert ok, (err, share)
        assert ops.launch_counts()["int8_flash_fwd_sm90"] == 2


def test_int8_flash_fwd_causality_and_refusals():
    g = torch.Generator(device="cuda").manual_seed(2)
    G, S, hd = 2, 512, 64
    q, k, v = (torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16) for s in ((G, S, hd), (S, hd), (S, hd)))
    base = ops.int8_flash_fwd(*ops.quantize_qkv(q, k, v), block_kv=256)
    k2, v2 = k.clone(), v.clone()
    k2[300:] = -k2[300:]
    v2[300:] = 2 * v2[300:]
    pert = ops.int8_flash_fwd(*ops.quantize_qkv(q, k2, v2), block_kv=256)
    assert torch.equal(base[0][:, :300], pert[0][:, :300]) and torch.equal(base[1][:, :300], pert[1][:, :300])
    # the same at block_kv 512 on the sm90 route, S 1024 cut at 700
    q, k, v = (torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16) for s in ((G, 1024, hd), (1024, hd),
                                                                                       (1024, hd)))
    ops.reset_launch_counts()
    base = ops.int8_flash_fwd(*ops.quantize_qkv(q, k, v), block_kv=512)
    k2, v2 = k.clone(), v.clone()
    k2[700:] = -k2[700:]
    v2[700:] = 2 * v2[700:]
    pert = ops.int8_flash_fwd(*ops.quantize_qkv(q, k2, v2), block_kv=512)
    assert ops.launch_counts()["int8_flash_fwd_sm90"] == 2
    assert torch.equal(base[0][:, :700], pert[0][:, :700]) and torch.equal(base[1][:, :700], pert[1][:, :700])
    assert not torch.equal(base[0][:, 700:], pert[0][:, 700:])
    q, k, v = q[:, :S], k[:S], v[:S]
    qkv = ops.quantize_qkv(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous())
    with pytest.raises(ValueError, match="hd 64 or 128"):
        ops.int8_flash_fwd(*qkv)
    with pytest.raises(ValueError, match="up to 512"):
        ops.int8_flash_fwd(*ops.quantize_qkv(q.repeat(1, 2, 1), k.repeat(2, 1), v.repeat(2, 1)), block_kv=1024)


@pytest.mark.parametrize("M", [8, 512])
@pytest.mark.parametrize("N,K", [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)])
def test_k2_storage_and_scalar_column_scales(M, N, K):
    """K2 with the column scales the storage schemes give it, bit-exact with
    its plain version on its route (decode stream at M 8, sm90 at 512): an
    Int8Weight's bf16 row scale [O, 1] (passed as [1, O]) and a BitNet
    weight's bf16 scalar; K1 before it at eps 1e-12 and BitNet's 1e-5, an
    all-zero row included."""
    x = _rand((M, K), torch.bfloat16, 20)
    x[0] = 0
    w = _rand((N, K), torch.bfloat16, 21) * 0.01
    stored = quant.Int8Weight.from_float(w)
    ternary_scale = quant.get_bitnet_scale(w)
    forms = ((stored.int_data, stored.scale.reshape(1, -1), IQ.EPS),
             (quant.quantize_bitnet_weight(w, ternary_scale), ternary_scale.to(torch.bfloat16), 1e-5))
    for b, sb, eps in forms:
        a, sa = ops.quantize_int8_rowwise(x, eps=eps)
        a_ref, sa_ref = ops.quantize_int8_plain(x, eps=eps)
        assert torch.equal(a, a_ref) and torch.equal(sa, sa_ref)
        ops.reset_launch_counts()
        out = ops.scaled_mm_rhs_t(a, b, sa, sb)
        counts = ops.launch_counts()
        assert counts["scaled_mm_rhs_t_sm90" if M > SCALED_MM.DECODE_M else "scaled_mm_rhs_t_decode"] == 1
        assert torch.equal(out, ops.scaled_mm_rhs_t_plain(a, b, sa, sb))


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("shape", [(22, 256, 2048), (3, 2048, 2048), (3, 2048, 5632)])
def test_k1_on_stacked_weights(shape, sr):
    """K1 and K1-SR on a stacked [L, O, I] weight, as from_float and the
    commit of an int8-stored weight call them: one launch over L * O rows,
    on the route rowwise_sm90_route gives, bit-exact."""
    w = _rand(shape, torch.bfloat16, 22) * 0.01
    ops.reset_launch_counts()
    q, s = ops.quantize_int8_rowwise(w, sr=sr, key=9)
    tag = "_sr" if sr else ""
    counts = ops.launch_counts()
    M = shape[0] * shape[1]
    assert counts[f"quantize_int8_rowwise{tag}"] == 1
    assert counts[f"quantize_int8_rowwise{tag}_sm90"] == int(bool(IQ.rowwise_sm90_route(M, shape[2], w.dtype, sr)))
    q_ref, s_ref = ops.quantize_int8_plain(w, sr=sr, key=9)
    assert q.shape == shape and s.shape == shape[:-1] + (1,)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("scheme,kw", [("int8_quantized_training", {"activation": "int8"}), ("bitnet", {})])
def test_storage_step_card_vs_cpu(monkeypatch, scheme, kw):
    """A 2-layer storage-scheme Llama (hidden 256, fp32, remat, the grouped
    pipeline): the loss and every master gradient on the card against the
    CPU's plain versions, within chip_smoke.py phase 14's bounds (loss
    1e-3, each leaf's relative RMS 1.5e-1); the card launches K1 and K2 and
    no int8 backward kernel; one train step commits int8 storage."""
    from quantized_training_tpu_torch import optim
    from quantized_training_tpu_torch.models import llama

    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, remat=True, bitnet=scheme == "bitnet")
    raw = llama.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    tok, lab = (torch.randint(0, 512, (1, 256), generator=g) for _ in range(2))
    res = {}
    for dev in ("cuda", "cpu"):
        params = quant.quantize_params(_to(raw, dev), scheme, **kw)
        ops.reset_launch_counts()
        loss, grads = train.loss_and_grads(cfg, params, tok.to(dev), lab.to(dev), 3)
        res[dev] = (loss.item(), [x.double().cpu() for x in tree_leaves(grads)])
        if dev == "cuda":
            n = ops.launch_counts()
            assert n["quantize_int8_rowwise"] > 0 and n["scaled_mm_rhs_t"] > 0
            assert n["scaled_mm"] == n["scaled_mm_lhs_t"] == n["quantize_int8_colwise"] == 0
            opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
            state, _ = train.make_train_step(cfg, opt)(train.init_train_state(params, opt), tok.cuda(), lab.cuda(),
                                                       1e-4, 5)
            assert type(state.params["layers"]["q"]["w"]) is type(params["layers"]["q"]["w"])
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-3 * abs(res["cpu"][0])
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - b).norm() <= 1.5e-1 * b.norm()


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---- per-step weight pre-quantization, the int8 conv, MX -----------------------------


@pytest.mark.parametrize("sr", [False, True], ids=["rn", "sr"])
@pytest.mark.parametrize("shape", [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)])
def test_b5_at_the_weight_shapes(shape, sr):
    """B5 at the Llama2-1B weights (QT_PREQUANT=both quantizes them), RN
    and SR: bit-exact with its plain version, one launch."""
    w = _rand(shape, torch.bfloat16, 40) * 0.01
    w[0], w[:, 1] = 0, 0
    kw = {"sr": True, "key": 9} if sr else {}
    ops.reset_launch_counts()
    got = ops.quantize_int8_both(w, **kw)
    assert ops.launch_counts()["quantize_int8_both_sr" if sr else "quantize_int8_both"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, ops.quantize_int8_both_plain(w, **kw)))


@pytest.mark.parametrize("mode", ["both", "row", "col"])
def test_prequantized_views_on_the_card(mode):
    """prequantize_weight on a stacked [3, 256, 2048] bf16 weight: one
    launch a layer (B5, K1 or B4), the views the CPU's bit for bit."""
    w = _rand((3, 256, 2048), torch.bfloat16, 41) * 0.01
    cfg = quant.MixedPrecisionConfig()
    ops.reset_launch_counts()
    got = MP.prequantize_weight(MixedPrecisionWeight(w, cfg), mode=mode)
    name = {"both": "quantize_int8_both", "row": "quantize_int8_rowwise", "col": "quantize_int8_colwise"}[mode]
    counts = ops.launch_counts()
    assert counts[name] == 3 and sum(counts[k] for k in ("quantize_int8_both", "quantize_int8_rowwise",
                                                          "quantize_int8_colwise")) == 3
    want = MP.prequantize_weight(MixedPrecisionWeight(w.cpu(), cfg), mode=mode)
    for f in MP.PreQuantMPWeight.data_fields[1:]:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("case", [(2, 17, 19, 3, 64, 3, 2, 1), (2, 16, 16, 64, 128, 3, 1, 1),
                                  (1, 14, 14, 256, 512, 3, 2, 0), (4, 9, 9, 8, 24, 1, 1, 0)])
def test_int8_convs_on_the_card(case):
    """int8_conv2d (B17's int8 form) and scaled_int8_conv2d (K2) on the card
    equal the CPU's (the GEMMs' plain versions) bit for bit, one launch
    each: a C = 3 stem, a 3 x 3 conv, a stride-2 conv at padding 0, a 1 x 1
    conv with a ragged width."""
    B, H, W, C, O, k, s, p = case
    g = torch.Generator(device="cuda").manual_seed(42)
    x = torch.randint(-128, 128, (B, H, W, C), generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-128, 128, (k, k, C, O), generator=g, device="cuda", dtype=torch.int8)
    cs = torch.rand(O, generator=g, device="cuda") * 0.01
    ops.reset_launch_counts()
    got, got_s = ops.int8_conv2d(x, w, s, p), ops.scaled_int8_conv2d(x, w, cs, s, p)
    counts = ops.launch_counts()
    assert counts["matmul_s8"] == 1 and counts["scaled_mm_rhs_t"] == 1
    assert torch.equal(got.cpu(), ops.int8_conv2d(x.cpu(), w.cpu(), s, p))
    assert torch.equal(got_s.cpu(), ops.scaled_int8_conv2d(x.cpu(), w.cpu(), cs.cpu(), s, p))


def test_mx_on_the_card_equals_the_cpu():
    """quantize_mx (fp4, e4m3, e5m2; OCP and NV), quantize_nvfp4 and the
    dequantizes on the card: the CPU's bytes; the fp4 products within the
    fp32-sum bound of the float64 product of the dequantized operands."""
    mx = importlib.import_module("quantized_training_tpu_torch.ops.mx")
    x = _rand((256, 512), torch.float32, 43) * 10.0 ** torch.arange(-3, 5, device="cuda").repeat(32)[:, None]
    x[0, :6] = torch.tensor([6.0, 7.0, 448.0, 500.0, 57344.0, 1e5], device="cuda")
    raw = lambda t: t.cpu().view(torch.uint8) if t.element_size() == 1 else t.cpu().view(torch.int32)
    for dt in ("fp4", torch.float8_e4m3fn, torch.float8_e5m2):
        for method in ("ocp", "nv"):
            for a, b in zip(mx.quantize_mx(x, dt, method), mx.quantize_mx(x.cpu(), dt, method)):
                assert torch.equal(raw(a), raw(b)), (dt, method)
    got, want = mx.quantize_nvfp4(x), mx.quantize_nvfp4(x.cpu())
    assert all(torch.equal(raw(a), raw(b)) for a, b in zip(got, want))
    assert torch.equal(raw(mx.dequantize_nvfp4(*got)), raw(mx.dequantize_nvfp4(*want)))
    a, b = _rand((128, 512), torch.float32, 44), _rand((96, 512), torch.float32, 45)
    (aq, sa), (bq, sb) = mx.quantize_mx(a, "fp4"), mx.quantize_mx(b, "fp4")
    ops.reset_launch_counts()
    out = mx.mxfp4_mm(aq, bq, sa, sb, out_dtype=torch.float32)
    assert ops.launch_counts()["matmul"] == 1
    af, bf = mx.dequantize_mxfp4(aq, sa), mx.dequantize_mxfp4(bq, sb)
    assert ((out.double() - af.double() @ bf.double().T).abs() <= MATMUL.fp32_sum_bound(af, bf.T)).all()


# ---- the task evaluation's forward and the finetune step -------------------------------

TASK_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2)


@pytest.mark.parametrize("n_seq,S", [(8, 29), (32, 55)])
def test_eval_forward_at_short_sequences(n_seq, S):
    """The no-grad forward of the multiple-choice predictors at their short,
    ragged lengths (accuracy_parity's 29 and the Markov set's 55; M 232,
    unfused, and 1,760, the norms and the MLP fused with the o-projection
    unfused), int8 ``mixed_precision`` on the grouped pipeline, fp32: the
    logits within chip_smoke.py phase 5's fp32 bounds of the CPU's plain
    path (relative RMS 3e-2, argmax agreement 0.95; the CPU's own floor
    with the embedding moved by one ulp: 4e-3 and 0.998), and the launches
    exactly ``chip_smoke.py::eval_forward_launches``, sm90 counters too."""
    import chip_smoke
    from quantized_training_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig(**TASK_CFG)
    raw = llama.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    tokens = torch.randint(0, 512, (n_seq, S), generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cuda", "cpu"):
        params = quant.quantize_params(_to(raw, dev), "mixed_precision")
        ops.reset_launch_counts()
        with torch.no_grad():
            logits[dev] = llama.forward(params, tokens.to(dev), cfg).float().cpu()
        if dev == "cuda":
            assert ops.launch_counts() == chip_smoke.eval_forward_launches(cfg, n_seq, S)
    a, b = logits["cuda"], logits["cpu"]
    assert ((a - b).norm() / b.norm()).item() <= 3e-2
    assert (a.argmax(-1) == b.argmax(-1)).double().mean().item() >= 0.95


@pytest.mark.parametrize("S", [256, 768])
def test_finetune_step_at_padded_lengths(monkeypatch, S):
    """One finetune batch (2 rows padded to S with -100 labels, the inputs
    as their own labels, as ``llm_finetune.data_iter`` writes them), remat,
    int8 fused: the loss and every gradient on the card within phase 7's
    fp32 bounds of the CPU's plain versions (the fused ops in interpret
    mode, the grouped pipeline forced; 1e-3 on the loss, 1.5e-1 relative RMS
    a leaf); then one bf16 ``adamw_bf16_sr`` step on the card launching
    exactly ``chip_smoke.py::finetune_per_step_launches`` with a finite
    loss."""
    import chip_smoke
    from quantized_training_tpu_torch import llm_finetune, optim
    from quantized_training_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig(**TASK_CFG, remat=True)
    g = torch.Generator().manual_seed(2)
    samples = [torch.randint(0, 512, (n,), generator=g).tolist() for n in (S - 100, S - 3)]
    tok, lab = (torch.from_numpy(a) for a in next(llm_finetune.data_iter(samples, 2, 256, 0)))
    assert tok.shape == (2, S) and (lab == -100).any()
    raw = llama.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        params = quant.quantize_params(_to(raw, dev), "mixed_precision", filter_fn=llm_finetune.not_lm_head)
        quant.set_impl("auto" if dev == "cuda" else "interpret")
        monkeypatch.setenv("QT_FUSED_ROPE", "force")
        try:
            loss, grads = train.loss_and_grads(cfg, params, tok.to(dev), lab.to(dev), 3)
        finally:
            quant.set_impl("auto")
        res[dev] = (loss.item(), [x.double().cpu() for x in tree_leaves(grads)])
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-3 * abs(res["cpu"][0])
    assert all(((a - b).norm() / b.norm()).item() <= 1.5e-1 for a, b in zip(res["cuda"][1], res["cpu"][1]))
    params = quant.quantize_params(_to(llama.init_params(torch.Generator().manual_seed(0), cfg), "cuda"),
                                   "mixed_precision", filter_fn=llm_finetune.not_lm_head)
    opt = optim.adamw_bf16_sr()
    state = train.init_train_state(params, opt)
    ops.reset_launch_counts()
    _, metrics = train.make_train_step(cfg, opt)(state, tok.cuda(), lab.cuda(), 1e-4, 5)
    assert ops.launch_counts() == chip_smoke.finetune_per_step_launches(cfg, 2, S, len(tree_leaves(params)))
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.parametrize("B,H,KV,S,hd", [(2, 32, 4, 2048, 64), (1, 8, 8, 512, 128)])
def test_sdpa_function_gives_f_sdpa_bits(B, H, KV, S, hd):
    """``ops/sdpa.py`` on the card, causal, with and without GQA, under
    deterministic algorithms: the backend ``F.scaled_dot_product_attention``
    picks, its forward and its grads bit for bit with F.sdpa's, the forward
    counted once (``ops.sdpa_forwards()``)."""
    SDPA = importlib.import_module("quantized_training_tpu_torch.ops.sdpa")
    q, k, v = (_rand((B, n, S, hd), torch.bfloat16, s).requires_grad_(True) for s, n in ((1, H), (2, KV), (3, KV)))
    g = _rand((B, H, S, hd), torch.bfloat16, 4)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ref = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, scale=1.0,
                                                               enable_gqa=KV != H)
        ref_g = torch.autograd.grad(ref, (q, k, v), g)
        ops.reset_launch_counts()
        out = SDPA.sdpa(q, k, v, is_causal=True, scale=1.0, enable_gqa=True)
        assert ops.sdpa_forwards() == 1
        got_g = torch.autograd.grad(out, (q, k, v), g)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert torch.equal(out, ref)
    assert all(torch.equal(a, b) for a, b in zip(got_g, ref_g))


# ---- CUDA graphs (utils/graphs.py): a captured call replays its eager bits ----


def _replays_eager_bits(fn, refill) -> None:
    """``fn()`` eagerly, then captured and replayed: the replay's outputs
    equal the eager call's bit for bit, and again after ``refill`` writes
    new inputs into the same buffers; each replay adds the eager call's
    launch counts."""
    from quantized_training_tpu_torch.utils import graphs

    ops.reset_launch_counts()
    eager = [t.clone() for t in fn()]
    counts = ops.launch_counts()
    captured = graphs.Captured(fn)
    for i in range(2):
        if i:
            refill()
            eager = [t.clone() for t in fn()]
        ops.reset_launch_counts()
        out = captured.replay()
        torch.cuda.synchronize()
        assert ops.launch_counts() == counts
        assert all(torch.equal(a, b) for a, b in zip(eager, out))
    assert captured.replays == 2


@pytest.mark.parametrize("form", ["b5", "b4_cluster", "k2_decode", "k2_sm90"])
def test_graph_capture_replays_eager_bits(form):
    """B5's cooperative column pass, B4's cluster form, and K2 on its
    split-K decode stream (a cluster launch) and on sm90 (TMA tensor maps
    encoded on the host at capture), each captured alone and replayed
    against its eager bits."""
    M, K, N = (8, 2048, 2048) if form == "k2_decode" else (8192, 2048, 2048)
    x = _rand((M, K), torch.bfloat16, 0)
    if form == "b5":
        fn, counter = (lambda: ops.quantize_int8_both(x)), "quantize_int8_both"
        refill = lambda: x.copy_(_rand((M, K), torch.bfloat16, 1))  # noqa: E731
    elif form == "b4_cluster":
        assert IQ.colwise_sm90_route(M, K, x.dtype)
        fn, counter = (lambda: ops.quantize_int8_colwise(x)), "quantize_int8_colwise_sm90"
        refill = lambda: x.copy_(_rand((M, K), torch.bfloat16, 1))  # noqa: E731
    else:
        g = torch.Generator(device="cuda").manual_seed(2)
        a = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        b = torch.randint(-128, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
        sa, sb = torch.rand(M, 1, generator=g, device="cuda"), torch.rand(1, N, generator=g, device="cuda")
        fn = lambda: (ops.scaled_mm_rhs_t(a, b, sa, sb),)  # noqa: E731
        counter = "scaled_mm_rhs_t_decode" if form == "k2_decode" else "scaled_mm_rhs_t_sm90"
        refill = lambda: a.copy_(torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8))  # noqa: E731
    ops.reset_launch_counts()
    fn()
    assert ops.launch_counts()[counter] == 1
    _replays_eager_bits(fn, refill)


def test_graph_capture_refuses_sr_kernels():
    """An SR kernel launched inside a capture raises (its key is a host
    integer that every replay would repeat)."""
    x = _rand((256, 2048), torch.bfloat16, 0)
    ops.quantize_int8_rowwise(x, sr=True, key=3)  # built and warm
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(ValueError, match="jit_compile=False"):
        with torch.cuda.graph(graph):
            ops.quantize_int8_rowwise(x, sr=True, key=3)


def _small_llama():
    from quantized_training_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=2048, hidden_size=512, intermediate_size=1536, num_hidden_layers=2,
                            num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=512, remat=True)
    raw = llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    return cfg, raw


def test_graphed_train_step_gives_eager_bits(monkeypatch):
    """A 2-layer Llama (hidden 512), int8 mixed_precision on the fused
    layer, remat, tokens [2, 2, 256] (accumulation): the graphed step
    (``jit_compile=True``, donating) and the eager one from the same weights,
    3 steps in turns under deterministic algorithms: losses, grad norms and
    the parameters after each step bit for bit; the same launches a step;
    the graph captured once and replayed 3 times; the state first passed in
    left intact."""
    from quantized_training_tpu_torch import optim

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg, raw = _small_llama()
    qparams = quant.quantize_params(raw, "mixed_precision")
    before = [t.clone() for t in tree_leaves(qparams)]
    g = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 256), generator=g, device="cuda")
    lab = torch.roll(tok, -1, dims=-1)
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    steps = {jit: train.make_train_step(cfg, opt, jit_compile=jit) for jit in (True, False)}
    states = {jit: train.init_train_state(qparams, opt) for jit in steps}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(3):
            got = {}
            for jit, step in steps.items():
                ops.reset_launch_counts()
                states[jit], m = step(states[jit], tok, lab, 1e-3, 7 + i)
                got[jit] = (m["loss"].item(), m["grad_norm"].item(), ops.launch_totals(),
                            [t.clone() for t in tree_leaves(states[jit].params)])
            assert got[True][:3] == got[False][:3]
            assert all(torch.equal(a, b) for a, b in zip(got[True][3], got[False][3]))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (captured,) = steps[True].graphs.values()
    assert captured.graph.replays == 3
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(qparams)))


def test_graphed_step_refuses_sr_on_the_card():
    """``jit_compile=True`` on a CUDA state with an SR weight raises a
    ValueError naming the reason; ``jit_compile=False`` runs it."""
    from quantized_training_tpu_torch import optim

    cfg, raw = _small_llama()
    qparams = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
    opt = optim.adamw_bf16_sr()
    tok = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda")
    with pytest.raises(ValueError, match="stochastic rounding"):
        train.make_train_step(cfg, opt)(train.init_train_state(qparams, opt), tok, tok, 1e-3, 1)
    _, m = train.make_train_step(cfg, opt, jit_compile=False)(train.init_train_state(qparams, opt), tok, tok, 1e-3, 1)
    assert torch.isfinite(m["loss"]).item()


def test_graphed_decode_gives_eager_streams():
    """The serving decode step captured as a graph per (window, chunk): a
    server over a 2-layer Llama streams the eager server's tokens exactly,
    and its decode graphs replayed."""
    from quantized_training_tpu_torch.models.serving import Server

    cfg, raw = _small_llama()
    params = quant.quantize_params(raw, "mixed_precision")
    g = torch.Generator().manual_seed(3)
    reqs = [(torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist(), b)
            for n, b in ((5, 9), (40, 17), (130, 4), (17, 33), (3, 20))]
    results = {}
    for jit in (True, False):
        srv = Server(params, cfg, n_slots=2, max_len=512, decode_chunk=8, jit_compile=jit)
        rids = [srv.add_request(p, b) for p, b in reqs]
        while srv.pending():
            srv.step()
        results[jit] = [srv.result(r) for r in rids]
        replays = sum(fn.captured.replays for fn in srv._decode_fns.values() if fn.captured is not None)
        assert (replays > 0) == jit
    assert results[True] == results[False]
