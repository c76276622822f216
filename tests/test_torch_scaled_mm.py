"""The port's scaled int8 matmul (K2's plain version) against the JAX
package's scaled_mm_general, its Pallas kernel (interpret mode) and the fp32
oracle scaled_mm_ref."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import pallas_mm
from quantized_training_tpu.quant import core as jcore

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

# both ops packages export a function of the module's name
jmm = importlib.import_module("quantized_training_tpu.ops.scaled_mm")
scaled_mm = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")

K = 192
_OUT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(M, N, scale_dtype, seed=0):
    """int8 operands and their row scales from the JAX quantize of random
    activations/weights; scales in bf16 or fp32 as the model dtype gives."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    a = jnp.asarray(rng.standard_normal((M, K)), jdt)
    b = jnp.asarray(rng.standard_normal((N, K)) * 0.02, jdt)
    qa, sa = jcore.quantize_int8(a, axis=1)
    qb, sb = jcore.quantize_int8(b, axis=1)
    to_t = lambda s: torch.from_numpy(np.array(s.astype(jnp.float32))).to(
        torch.bfloat16 if scale_dtype == "bf16" else torch.float32)
    jx = (qa, qb, sa, sb.reshape(1, N))
    tx = (torch.from_numpy(np.array(qa)), torch.from_numpy(np.array(qb)), to_t(sa), to_t(sb).reshape(1, N))
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("N", [64, 256])
def test_plain_bit_exact_vs_jax_and_pallas(M, N, scale_dtype, out):
    """Tolerance: none. The int32 (float64 here) accumulation is exact and
    the epilogue (acc * sa) * sb runs in fp32 in the same order everywhere,
    with one rounding to the output dtype."""
    (qa, qb, sa, sb), (ta, tb, tsa, tsb) = _operands(M, N, scale_dtype)
    jdt, tdt = _OUT[out]
    got = scaled_mm.scaled_mm_rhs_t_plain(ta, tb, tsa, tsb, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    ref = jmm.scaled_mm_general(qa, qb, sa, sb, dims=(1, 1), out_dtype=jdt)
    pal = pallas_mm.scaled_mm_dims(qa, qb, sa, sb, dims=(1, 1), out_dtype=jdt, interpret=True,
                                   block_m=128, block_n=128, block_k=128)
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    np.testing.assert_array_equal(_f32(got), _f32(pal))
    # the public dispatcher takes the same route on the CPU
    via_general = scaled_mm.scaled_mm_general(ta, tb, tsa, tsb, dims=(1, 1), out_dtype=tdt)
    assert torch.equal(via_general, got)


@pytest.mark.parametrize("M,N", [(8, 64), (40, 256)])
def test_plain_within_fp32_rounding_of_ref(M, N):
    """scaled_mm_ref scales the operands before an fp32 matmul, so it
    differs from the exact-accumulate form by fp32 rounding: bound 1e-5 of
    the largest output."""
    _, (ta, tb, tsa, tsb) = _operands(M, N, "f32", seed=1)
    got = scaled_mm.scaled_mm_rhs_t_plain(ta, tb, tsa, tsb, out_dtype=torch.float32)
    ref = scaled_mm.scaled_mm_ref(ta, tb.T, tsa, tsb)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    (qa, qb, sa, sb), _ = _operands(M, N, "f32", seed=1)
    jref = jmm.scaled_mm_ref(qa, qb.T, sa, sb)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dims", [(1, 0), (0, 0)])
def test_other_dims_cpu_vs_jax(dims):
    """The training forms run on the CPU (plain) and match JAX bit for bit."""
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.integers(-128, 128, (48, 32)), jnp.int8)
    b = jnp.asarray(rng.integers(-128, 128, (48, 32) if dims == (0, 0) else (32, 16)), jnp.int8)
    M, N = a.shape[1 - dims[0]], b.shape[1 - dims[1]]
    sa = jnp.asarray(rng.random((M, 1)), jnp.float32)
    sb = jnp.asarray(rng.random((1, N)), jnp.float32)
    ref = jmm.scaled_mm_general(a, b, sa, sb, dims=dims, out_dtype=jnp.float32)
    t = lambda x: torch.from_numpy(np.array(x))
    got = scaled_mm.scaled_mm_general(t(a), t(b), t(sa), t(sb), dims=dims, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scalar_scales_broadcast():
    """Tensor-wide scalar scales broadcast like per-row ones."""
    _, (ta, tb, _, _) = _operands(8, 64, "f32", seed=3)
    s = torch.tensor(0.5)
    got = scaled_mm.scaled_mm_rhs_t_plain(ta, tb, s, s, out_dtype=torch.float32)
    full = scaled_mm.scaled_mm_rhs_t_plain(ta, tb, torch.full((8, 1), 0.5), torch.full((1, 64), 0.5),
                                           out_dtype=torch.float32)
    assert torch.equal(got, full)


def test_device_path_raises_off_the_kernel(monkeypatch):
    """A meta tensor takes the device path without a card: every dims form
    goes to its kernel's wrapper (K2, B1, B2), which refuses a non-CUDA
    device, and never to the plain version."""
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a device tensor")

    monkeypatch.setattr(scaled_mm, "_plain", no_plain)
    a = torch.empty(32, 32, dtype=torch.int8, device="meta")
    s = torch.empty(32, 1, device="meta")
    for dims in ((1, 1), (1, 0), (0, 0)):
        with pytest.raises(ValueError, match="one CUDA device"):
            scaled_mm.scaled_mm_general(a, a, s, s.T, dims=dims)
