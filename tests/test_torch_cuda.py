"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips (decided in a
fixture, not at import). On the card: ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py -q`` (the suite's conftest imports jax, which
this file does not need). Tolerance everywhere: none — K1 and K2 are
bit-exact with their plain versions by construction.
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


def test_scaled_mm_rejects_what_it_cannot_take():
    a = torch.zeros(8, 24, dtype=torch.int8, device="cuda")
    s = torch.ones(8, 1, device="cuda")
    with pytest.raises(ValueError, match="K % 16"):
        ops.scaled_mm_rhs_t(a, a, s, s.T)
    with pytest.raises(NotImplementedError):
        ops.scaled_mm_general(a, a, s, s.T, dims=(1, 0))


def test_launch_counters_count_kernel_launches_only():
    ops.reset_launch_counts()
    x = _rand((8, 64), torch.bfloat16, 2)
    q, s = ops.quantize_int8_rowwise(x)
    ops.scaled_mm_rhs_t(q, q, s, s.T)
    ops.quantize_int8_plain(x)
    assert ops.launch_counts() == {"quantize_int8_rowwise": 1, "scaled_mm_rhs_t": 1}
