"""The mesh forms of K1, B4 and B5 (``ops/int8_quant.py``: each one's
maxima form, K1's given form and the given column cast of B4 and B5) on the CPU,
where each wrapper takes its plain version: given the maxima of the tensor
itself, the given-maxima forms are the whole quantize (``quant/core.py``)
bit for bit, in bf16 and fp32, at round-to-nearest and under stochastic
rounding; given a larger tensor's maxima, a block of rows (or columns) gets
that tensor's int8 and scales. ``over`` outside a span changes nothing.
The forms on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from quantized_training_tpu_torch.ops import int8_quant as iq
from quantized_training_tpu_torch.ops import random
from quantized_training_tpu_torch.parallel import collectives
from quantized_training_tpu_torch.quant import core

torch.set_num_threads(1)

DTYPES = [torch.bfloat16, torch.float32]


def _x(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3).to(dtype)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sr", [False, True])
def test_rowwise_forms_are_k1(dtype, sr):
    x, kw = _x((3, 40, 96), dtype), dict(stochastic_rounding=sr, key=11 if sr else None)
    amax = iq.quantize_int8_rowwise_maxima(x)
    assert amax.dtype == torch.float32 and amax.shape == (3, 40, 1)
    _same(iq.quantize_int8_rowwise_given(x, amax, sr=sr, key=kw["key"]), core.quantize_int8(x, axis=-1, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sr", [False, True])
def test_colwise_forms_are_b4(dtype, sr):
    x, key = _x((72, 48), dtype), 12 if sr else None
    amax = iq.quantize_int8_colwise_maxima(x)
    assert amax.dtype == torch.float32 and amax.shape == (1, 48)
    _same(iq.quantize_int8_colwise_given(x, amax, sr=sr, key=key),
          core.quantize_int8(x, axis=0, stochastic_rounding=sr, key=key))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sr", [False, True])
def test_both_forms_are_b5(dtype, sr):
    """B5's maxima form gives its row half and the column maxima, the given
    column cast its column half, each drawing from its half of the key."""
    x, key = _x((64, 80), dtype), 13 if sr else None
    q_row, s_row, amax = iq.quantize_int8_both_maxima(x, sr=sr, key=key)
    key_col = random.split(key)[1] if sr else None
    _same((q_row, s_row, *iq.quantize_int8_colwise_given(x, amax, sr=sr, key=key_col)),
          core.quantize_int8_both(x, stochastic_rounding=sr, key=key))


@pytest.mark.parametrize("dtype", DTYPES)
def test_given_global_maxima_give_the_global_rows(dtype):
    """With the maxima of the whole tensor, a block of its rows (the column
    cast of B4 and B5) or of its columns (K1) quantizes as in the whole
    tensor."""
    x = _x((64, 96), dtype, seed=3)
    q, s = core.quantize_int8(x, axis=0)
    rows = x[16:32]
    _same(iq.quantize_int8_colwise_given(rows, iq.quantize_int8_colwise_maxima(x)), (q[16:32], s))
    _same(iq.quantize_int8_colwise_given(rows, iq.quantize_int8_both_maxima(x)[2]), (q[16:32], s))
    q, s = core.quantize_int8(x, axis=-1)
    cols = x[:, 32:64].contiguous()
    _same(iq.quantize_int8_rowwise_given(cols, iq.quantize_int8_rowwise_maxima(x)), (q[:, 32:64], s))
    own = core.quantize_int8(rows, axis=0)[1]
    assert not torch.equal(own, core.quantize_int8(x, axis=0)[1])  # the rows' own maxima differ


def test_over_outside_a_span_changes_nothing():
    """No span entered (no mesh, or a mesh axis of size 1): ``over`` and
    ``cols_over`` leave the quantizes as they are, and no maxima are
    all-reduced."""
    from quantized_training_tpu_torch.parallel import make_mesh

    x = _x((32, 64), torch.bfloat16, seed=4)
    collectives.reset_maxima_all_reduces()
    with collectives.spanning(make_mesh({"fsdp": 1}), tokens="dp", features="model"):
        assert collectives.span("tokens") is None and collectives.span("features") is None
        _same(core.quantize_int8(x, axis=0, over="tokens"), core.quantize_int8(x, axis=0))
        _same(core.quantize_int8_both(x, cols_over="tokens"), core.quantize_int8_both(x))
        _same(core.quantize_int8(x, axis=-1, over="features"), core.quantize_int8(x, axis=-1))
    assert collectives.maxima_all_reduces() == 0


def test_given_maxima_are_checked():
    """The device path of a given-maxima form takes only fp32 maxima, one a
    row or column, on x's device."""
    x = torch.empty((16, 32), dtype=torch.bfloat16)
    iq._given_amax(x, torch.zeros(1, 32), 32, "f")
    for bad in (torch.zeros(1, 31), torch.zeros(1, 32, dtype=torch.bfloat16), torch.zeros(32, device="meta")):
        with pytest.raises(ValueError, match="amax must be 32 fp32 values"):
            iq._given_amax(x, bad, 32, "f")
