"""The port's int8 quantize (K1's plain version and quant.core) against the
JAX package's quant.core and its Pallas kernel (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import pallas_quant
from quantized_training_tpu.quant import core as jcore
from quantized_training_tpu_torch.ops import int8_quant
from quantized_training_tpu_torch.ops import random as ops_random
from quantized_training_tpu_torch.quant import core

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

_DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
           "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype_name, seed=0):
    """Random rows with a zero row and a row built from exact ties: its
    absmax is 127, so the scale is 1 and x.5 values round half to even."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    if rows.shape[0] > 1:
        ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127.0], np.float32)
        rows[1] = np.resize(ties, shape[-1])
    _, jdt, tdt = _DTYPES[dtype_name]
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    return xj, xt


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", [
    ((8, 64), -1), ((8, 2048), -1), ((40, 96), -1), ((2, 5, 2, 64), -1),
    ((64, 128), 0), ((40, 96), 0),
])
def test_quantize_bit_exact_vs_jax_core(shape, axis, dtype_name):
    """Tolerance: none. Both compute absmax/127 in fp32, an IEEE division
    and round-half-even, so q and the scale (cast to x's dtype) agree bit
    for bit, ties and zero rows included."""
    xj, xt = _inputs(shape, dtype_name)
    qj, sj = jcore.quantize_int8(xj, axis=axis)
    qt, st = core.quantize_int8(xt, axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == xt.dtype
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj.astype(jnp.float32)))
    if axis == -1:
        assert (qt.reshape(-1, shape[-1])[0] == 0).all()  # the zero row


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(32, 64), (64, 128), (96, 256)])
def test_rowwise_within_one_lsb_of_pallas(shape, dtype_name):
    """The Pallas kernel multiplies by a reciprocal where the port divides,
    so q may differ by 1 LSB; bound as tests/test_pallas_quant.py bounds
    Pallas against the jnp reference: |dq| <= 1 on < 2% of elements, scales
    within 1e-2 relative (Pallas keeps them fp32)."""
    xj, xt = _inputs(shape, dtype_name, seed=1)
    qp, sp = pallas_quant.quantize_int8_rowwise(xj, interpret=True)
    qt, st = int8_quant.quantize_int8_rowwise(xt)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qp, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02
    np.testing.assert_allclose(_np(st).ravel(), np.asarray(sp).ravel(), rtol=1e-2)


def test_dequantize_roundtrip():
    """|x - q*s| <= s/2 per element, up to fp32 rounding of the division."""
    _, xt = _inputs((16, 64), "f32", seed=2)
    q, s = core.quantize_int8(xt)
    err = (core.dequantize_int8(q, s) - xt).abs()
    assert (err <= s / 2 * (1 + 1e-5) + 1e-12).all()


def test_stochastic_rounding_cpu_unbiased_and_deterministic():
    """SR on the CPU draws from the given key: the same key repeats the
    result, and the mean over keys approaches x/scale (0.3 * 127 = 38.1
    here; tolerance 0.05 from 400 draws of a Bernoulli(0.1) step)."""
    x = torch.full((4, 64), 0.3)
    x[:, 0] = 1.0
    q1, _ = core.quantize_int8(x, stochastic_rounding=True, key=3)
    q2, _ = core.quantize_int8(x, stochastic_rounding=True, key=3)
    assert torch.equal(q1, q2)
    acc = sum(core.quantize_int8(x, stochastic_rounding=True, key=1000 + i)[0].double() for i in range(400))
    mean = acc[:, 1:].mean() / 400
    assert abs(mean.item() - 0.3 * 127) < 0.05
    with pytest.raises(ValueError, match="key"):
        core.quantize_int8(x, stochastic_rounding=True)


def test_device_path_raises_off_the_kernel(monkeypatch):
    """Every non-CPU tensor takes the device path; a meta tensor reaches it
    without a card. The row and the column quantize go to their kernels'
    wrappers (K1, B4), which refuse a non-CUDA device, and never to the
    plain version; so does SR, which reaches K1's wrapper with ``sr`` and
    its key and draws no plain noise."""
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a device tensor")

    monkeypatch.setattr(int8_quant, "quantize_int8_plain", no_plain)
    monkeypatch.setattr(core, "quantize_int8_plain", no_plain)
    monkeypatch.setattr(ops_random, "uniform", no_plain)
    seen = []
    kernel = core.quantize_int8_rowwise

    def recorded(x, **kw):
        seen.append(kw)
        return kernel(x, **kw)

    monkeypatch.setattr(core, "quantize_int8_rowwise", recorded)
    x = torch.empty(8, 64, device="meta")
    with pytest.raises(ValueError, match="quantize_int8_colwise: needs a CPU or CUDA tensor"):
        core.quantize_int8(x, axis=0)
    with pytest.raises(ValueError, match="quantize_int8_rowwise: needs a CPU or CUDA tensor"):
        core.quantize_int8(x)
    with pytest.raises(ValueError, match="quantize_int8_rowwise: needs a CPU or CUDA tensor"):
        core.quantize_int8(x, stochastic_rounding=True, key=7)
    assert seen[-1]["sr"] is True and seen[-1]["key"] == 7
    with pytest.raises(NotImplementedError, match="axis=1 of a 3-D"):
        core.quantize_int8(torch.empty(2, 8, 64, device="meta"), axis=1)
