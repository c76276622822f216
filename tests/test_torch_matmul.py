"""B17, the plain tiled matmul, on the CPU: the port's plain version
(ops/matmul.py) against the JAX package's Pallas kernel
(ops/pallas_mm.py::matmul) in interpret mode, on the same numpy inputs.

Tolerances: none for int8 (int32 sums are exact in any order). bf16 with an
fp32 accumulator: the JAX kernel sums each K block in fp32 and adds the
blocks, the plain version rounds the float64 product once; both are fp32
sums of exact products, so they differ by at most ``fp32_sum_bound`` =
K * 2**-24 * (|a| . |b|) elementwise, and with a bf16 output each side may
round one bf16 step further (2**-8 of the value, relative).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import pallas_mm
from quantized_training_tpu_torch import ops

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

# both ops packages export a function of the module's name
MATMUL = importlib.import_module("quantized_training_tpu_torch.ops.matmul")
KW = dict(interpret=True, block_m=128, block_n=128)


def _int8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _bf16(rng, shape):
    """bf16 values (as a JAX array and a torch tensor) of a normal sample."""
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def test_int8_exact_against_pallas():
    """256 x 512 x 256 with block_k 256 (two K steps), as
    tests/test_pallas.py::TestPallasMatmul::test_int8_exact runs the kernel:
    int32 out, equal to the JAX kernel's and to the int64 product."""
    rng = np.random.default_rng(4)
    a, b = _int8(rng, (256, 512)), _int8(rng, (512, 256))
    ref = np.asarray(pallas_mm.matmul(jnp.asarray(a), jnp.asarray(b), block_k=256, **KW))
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(200, 300, 136), (128, 256, 128), (7, 1000, 33)])
def test_bf16_against_pallas(M, K, N, out):
    """bf16 operands, fp32 accumulator, fp32 or bf16 out, at ragged shapes
    (the JAX kernel pads to its blocks, B17 masks its edges), within the
    fp32 reassociation bound."""
    rng = np.random.default_rng(M + K + N)
    ja, ta = _bf16(rng, (M, K))
    jb, tb = _bf16(rng, (K, N))
    jout, tout = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    ref = pallas_mm.matmul(ja, jb, acc_dtype=jnp.float32, out_dtype=jout, block_k=256, **KW)
    got = ops.matmul(ta, tb, acc_dtype=torch.float32, out_dtype=tout)
    assert got.dtype == tout and got.shape == (M, N)
    ref64 = np.asarray(ref.astype(jnp.float32), np.float64)
    bound = MATMUL.fp32_sum_bound(ta, tb).numpy()
    if out == "bf16":
        bound = bound + 2.0**-8 * (np.abs(ref64) + bound) * 2
    np.testing.assert_array_less(np.abs(got.double().numpy() - ref64), bound + 1e-300)
    # and the plain version is the product rounded once (f32) or twice (bf16, through f32)
    exact = ta.double() @ tb.double()
    assert torch.equal(got, exact.float().to(tout))


def test_default_dtypes_follow_the_accumulator():
    a = torch.ones(4, 32, dtype=torch.bfloat16)
    assert ops.matmul(a, a.T.contiguous()).dtype == torch.float32
    i = torch.ones(4, 32, dtype=torch.int8)
    assert ops.matmul(i, i.T.contiguous()).dtype == torch.int32


@pytest.mark.parametrize("a_dtype,kw", [
    (torch.float32, {}),
    (torch.float16, {}),
    (torch.int8, {"out_dtype": torch.float32}),
    (torch.bfloat16, {"acc_dtype": torch.bfloat16}),
    (torch.bfloat16, {"out_dtype": torch.float16}),
    (torch.int8, {"acc_dtype": torch.float32}),
])
def test_other_forms_raise_and_name_the_forms(a_dtype, kw):
    a = torch.zeros(8, 16, dtype=a_dtype)
    b = torch.zeros(16, 8, dtype=a_dtype)
    with pytest.raises(TypeError, match="bf16 x bf16 -> fp32 accumulator -> fp32 or bf16 out, and int8"):
        ops.matmul(a, b, **kw)
    with pytest.raises(TypeError):
        ops.matmul_plain(a, b, **kw)


def test_mixed_operand_types_raise():
    with pytest.raises(TypeError):
        ops.matmul(torch.zeros(8, 16, dtype=torch.bfloat16), torch.zeros(16, 8, dtype=torch.int8))


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    ops.matmul(torch.ones(8, 16, dtype=torch.bfloat16), torch.ones(16, 8, dtype=torch.bfloat16))
    ops.matmul(torch.ones(8, 16, dtype=torch.int8), torch.ones(16, 8, dtype=torch.int8))
    counts = ops.launch_counts()
    assert counts["matmul"] == 0 and counts["matmul_s8"] == 0


def test_non_cpu_tensor_takes_the_kernel_path():
    """A tensor off the CPU never falls back to the plain version: a meta
    tensor reaches the kernel path, which needs a CUDA device."""
    a = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(a, a.T)
