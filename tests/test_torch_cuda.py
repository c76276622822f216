"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips (decided in a
fixture, not at import). On the card: ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py -q`` (the suite's conftest imports jax, which
this file does not need). Tolerance: none for K1/K2/B1-B6 and B9 — each is
bit-exact with its plain version by construction. B7, B8 and B10 hold a row
sum that the kernel takes in its own fixed order: int8 within one step on at
most 1e-3 of the elements, scales and column maxima within 1e-6 relative, dx
within 2 bf16 ulps (below 2**-20 of max|dx|, where the closed form cancels,
within that), dgamma within 1e-5 of max|dgamma|.
"""

import pytest
import torch

from quantized_training_tpu_torch import ops

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (64, 128), (130, 200), (256, 2048), (8192, 256), (1000, 5632),
                                   (2048, 5632)])
def test_quantize_colwise_and_both_bit_exact(shape, dtype):
    """B4 and B5, ragged shapes (rows not a multiple of the 64-row split,
    columns not of the 16-byte vector) and an all-zero row and column."""
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
    with pytest.raises(NotImplementedError, match="B15"):
        ops.scaled_mm(a[:, :16].contiguous(), a[:, :16].T.contiguous(), torch.ones(2, 1, device="cuda"), s.T)


def test_launch_counters_count_kernel_launches_only():
    ops.reset_launch_counts()
    x = _rand((64, 64), torch.bfloat16, 2)
    q, s = ops.quantize_int8_rowwise(x)
    qc, sc = ops.quantize_int8_colwise(x)
    qr, sr, qc2, sc2 = ops.quantize_int8_both(x)
    ops.quantize_int8_rowwise(x, sr=True, key=1)
    ops.quantize_int8_colwise(x, sr=True, key=1)
    ops.quantize_int8_both(x, sr=True, key=1)
    ops.scaled_mm_rhs_t(q, q, s, s.T)
    ops.scaled_mm(qr, qc, sr, sc)
    ops.scaled_mm_lhs_t(qc2, qc, sc2, sc)
    adamw_in = _adamw_inputs(64, torch.bfloat16, 0)
    ops.fused_adamw_update(*adamw_in, 1, bf16_sr=False)
    ops.fused_adamw_update(*adamw_in, 1, bf16_sr=True)
    y, gamma = _rand((64, 128), torch.bfloat16, 3), torch.ones(128, device="cuda", dtype=torch.bfloat16)
    for use_sr in (False, True):
        kw = dict(sr=use_sr, key=1 if use_sr else None)
        amax = ops.rmsnorm_quant_rowwise(y, gamma, with_col_amax=True, **kw)[2]
        ops.rmsnorm_quant_colwise(y, gamma, scale=amax * (1.0 / 127.0), **kw)
        ops.silu_mul_quant_rowwise(y, y, **kw)
        ops.silu_mul_quant_colwise(y, y, **kw)
        ops.rmsnorm_quant_rowwise_plain(y, gamma, **kw)
        ops.silu_mul_quant_colwise_plain(y, y, **kw)
    ops.rmsnorm_bwd(y, gamma, y)
    ops.rmsnorm_bwd_plain(y, gamma, y)
    ops.quantize_int8_plain(x)
    ops.quantize_int8_plain(x, sr=True, key=1)
    ops.quantize_int8_both_plain(x)
    ops.scaled_mm_plain(qr, qc, sr, sc)
    ops.scaled_mm_lhs_t_plain(qc2, qc, sc2, sc)
    ops.fused_adamw_plain(*adamw_in, 1, bf16_sr=True)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 1)
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
