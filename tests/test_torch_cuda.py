"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips (decided in a
fixture, not at import). On the card: ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py -q`` (the suite's conftest imports jax, which
this file does not need). Tolerance everywhere: none — every kernel is
bit-exact with its plain version by construction.
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
    ops.quantize_int8_plain(x)
    ops.quantize_int8_plain(x, sr=True, key=1)
    ops.quantize_int8_both_plain(x)
    ops.scaled_mm_plain(qr, qc, sr, sc)
    ops.scaled_mm_lhs_t_plain(qc2, qc, sc2, sc)
    ops.fused_adamw_plain(*adamw_in, 1, bf16_sr=True)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 1)
