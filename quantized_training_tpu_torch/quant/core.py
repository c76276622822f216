"""Core int8 and int4 quantization numerics.

Counterpart of ``quantized_training_tpu/quant/core.py::
stochastic_round_to_int`` (:33), ``quantize_int8``, ``dequantize_int8``,
``quantize_int8_both`` (:47-174), ``quantize_int4_rowwise_absmax`` and
``unpack_int4_rowwise`` (:237-265), ``quantize_int4_groupwise`` and
``dequantize_int4_groupwise`` (:182-230), ``get_bitnet_scale``,
``quantize_bitnet_weight``, ``pack_i2_in_i8`` and ``unpack_i2_in_i8``
(:273-315), and ``bf16_stochastic_round`` (:318). The int4, ternary and
2-bit functions are plain torch on every device, as XLA lowered them. On a
CUDA tensor a row quantize (``axis=-1``, any ndim) runs kernel K1, a column
quantize of a 2-D tensor (``axis=0``) B4, and the both-axes quantize B5
(``ops/int8_quant.py``), each in its SR form under stochastic rounding; a
CPU tensor runs the plain versions, along any axis. Stochastic rounding
draws from a key, an int (``ops/random.py``), never from a generator.

Under a mesh (``over``): a quantize names the axis it reduces (``"tokens"``
or ``"features"``, ``parallel/collectives.py::spanning``), and where a mesh
splits that axis it runs as its two mesh forms with the maxima all-reduced
over the mesh axis between them (``ops/int8_quant.py``), so that each rank
holds its rows of the quantize of the global tensor, as in JAX's one global
program. Elsewhere ``over`` changes nothing. A product whose contraction
axis a mesh splits (``"features"``, a row-parallel linear under tensor
parallelism) sums its partial products over that axis inside the linear
(:func:`scaled_mm_over`: the int32 sums, then the scales once;
:func:`matmul_over`: fp32 partials, then one rounding), and BitNet's
abs-mean of a weight that tensor parallelism splits sums |w| over the mesh
axis (``"weights"``, :func:`get_bitnet_scale`), as JAX's partitioned program
reduces each over the whole axis.
"""

from __future__ import annotations

import torch

from ..ops import random
from ..ops.int4_mm import unpack_int4
from ..ops.random import bf16_stochastic_round  # noqa: F401  (core.py:318's counterpart)
from ..ops.scaled_mm import scaled_mm_general
from ..ops.int8_quant import (
    EPS,
    quantize_int8_both as _quantize_both_kernel,
    quantize_int8_both_maxima,
    quantize_int8_colwise,
    quantize_int8_colwise_given,
    quantize_int8_colwise_maxima,
    quantize_int8_plain,
    quantize_int8_rowwise,
    quantize_int8_rowwise_given,
    quantize_int8_rowwise_maxima,
)


def _span(over):
    """The (mesh, axis) that a maximum over ``over`` spans, or None
    (``parallel/collectives.py::span``; imported here, since ``parallel``
    imports this module)."""
    if over is None:
        return None
    from ..parallel.collectives import span

    return span(over)


def max_over(amax: torch.Tensor, over) -> torch.Tensor:
    """``amax`` all-reduced with max where ``over`` spans a split axis
    (``parallel/collectives.py::max_over``)."""
    from ..parallel.collectives import max_over as reduce

    return reduce(amax, over)


def max_over_each(amaxes, over) -> list:
    """Each tensor of ``amaxes`` all-reduced with max where ``over`` spans a
    split axis, all in one all-reduce; the tensors themselves elsewhere."""
    span = _span(over)
    if span is None:
        return list(amaxes)
    flat = max_over(torch.cat([a.reshape(-1) for a in amaxes]), span)
    return [p.view_as(a) for p, a in zip(flat.split([a.numel() for a in amaxes]), amaxes)]


def sum_over(x: torch.Tensor, over) -> torch.Tensor:
    """``x`` (a product's partial sums) all-reduced with a sum over the mesh
    axis that ``over`` spans, ``x`` itself where it spans nothing."""
    span = _span(over)
    if span is None:
        return x
    from ..parallel.collectives import all_reduce

    return all_reduce(x, *span)


def matmul_over(x: torch.Tensor, w: torch.Tensor, over=None) -> torch.Tensor:
    """``x @ w.T`` in x's dtype. Where ``over`` spans a mesh axis that
    splits the contraction (a row-parallel linear under tensor
    parallelism), each rank's partial product is taken in fp32, summed over
    the axis and rounded once, as JAX's partitioned program sums its
    partial dots in fp32 (``torch.mm``'s fp32 output on a card, the fp32
    product of the widened operands on the CPU, whose ``mm`` has no
    ``out_dtype``)."""
    if _span(over) is None:
        return x @ w.T
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.is_cuda:
        acc = torch.mm(x2d, w.T, out_dtype=torch.float32)
    else:
        acc = x2d.float() @ w.float().T
    return sum_over(acc, over).to(x.dtype).reshape(*x.shape[:-1], w.shape[0])


# a contraction of at most this many int8 products of |q| <= 128 sums to at
# most 2**24 in magnitude, which fp32 holds exactly
EXACT_K = 1024


def scaled_mm_over(a, b, scale_a, scale_b, *, dims, out_dtype, over=None) -> torch.Tensor:
    """The int8 product of ``scaled_mm_general`` (K2, B1 or B2). Where
    ``over`` spans a mesh axis that splits the contraction, the rank's int32
    sums are all-reduced over it before the scales are applied once, as in
    JAX's partitioned program (an s32 all-reduce after the dot, then
    ``acc * scale_a * scale_b`` in fp32): the kernel runs with unit scales
    into fp32 on each ``EXACT_K`` slice of the rank's contraction, whose
    sums fp32 holds exactly, the slices' sums are added as int32 and
    all-reduced as int32."""
    if _span(over) is None:
        return scaled_mm_general(a, b, scale_a, scale_b, dims=dims, out_dtype=out_dtype)
    M, N, K = a.shape[1 - dims[0]], b.shape[1 - dims[1]], a.shape[dims[0]]
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=a.device)  # noqa: E731
    acc = None
    for k0 in range(0, K, EXACT_K):
        n = min(EXACT_K, K - k0)
        part = scaled_mm_general(a.narrow(dims[0], k0, n).contiguous(), b.narrow(dims[1], k0, n).contiguous(),
                                 ones(M), ones(N), dims=dims, out_dtype=torch.float32).to(torch.int32)
        acc = part if acc is None else acc + part
    acc = sum_over(acc, over).float()
    return ((acc * scale_a.float().reshape(-1, 1)) * scale_b.float().reshape(1, -1)).to(out_dtype)


def stochastic_round_to_int(x: torch.Tensor, key: int) -> torch.Tensor:
    """floor(x + U[0, 1)) with U from the stream of ``key``: unbiased
    rounding to the integer grid, as float values."""
    return torch.floor(x + random.uniform(key, x.shape, x.device).to(x.dtype))


def quantize_int8(
    x: torch.Tensor,
    *,
    axis: int = -1,
    stochastic_rounding: bool = False,
    key: int | None = None,
    eps: float = EPS,
    over=None,
):
    """Absmax symmetric INT8 quantization along ``axis``.

    Returns ``(int_data int8, scale x.dtype)`` with ``scale`` keeping the
    reduced axis as size 1, so that ``dequant = int_data * scale``. The scale
    is computed in fp32 and cast back to x's dtype. With
    ``stochastic_rounding`` q = floor(x / scale + u), u the uniform at x's
    row-major index in the stream of ``key``.

    The row quantize goes to K1's wrapper and the column quantize of a 2-D
    tensor to B4's, which launch their kernels (or SR forms) on a CUDA
    tensor (a strided input is made contiguous first) and take the plain
    version on a CPU tensor. The CPU also takes any other axis; on a CUDA
    tensor that raises NotImplementedError.

    ``over``: the name of the reduced axis (the module's docstring); where
    a mesh splits it, a row or 2-D column quantize runs as its maxima form,
    the all-reduce of the maxima and its given-maxima form.
    """
    if stochastic_rounding and key is None:
        raise ValueError("stochastic_rounding=True requires a key")
    kw = dict(eps=eps, sr=stochastic_rounding, key=key)
    span = _span(over)
    if span is not None:
        x = x.contiguous()
        if axis in (-1, x.ndim - 1):
            return quantize_int8_rowwise_given(x, max_over(quantize_int8_rowwise_maxima(x), span), **kw)
        if x.ndim == 2 and axis in (0, -2):
            return quantize_int8_colwise_given(x, max_over(quantize_int8_colwise_maxima(x), span), **kw)
        raise NotImplementedError(f"quantize_int8: over a mesh along axis={axis} of a {x.ndim}-D tensor")
    if axis in (-1, x.ndim - 1):
        return quantize_int8_rowwise(x.contiguous(), **kw)
    if x.ndim == 2 and axis in (0, -2):
        return quantize_int8_colwise(x.contiguous(), **kw)
    if x.device.type == "cpu":
        return quantize_int8_plain(x, axis=axis, **kw)
    raise NotImplementedError(
        f"quantize_int8: axis={axis} of a {x.ndim}-D tensor has no CUDA kernel "
        "(K1 reduces the last axis, B4 the first of a 2-D tensor)"
    )


def dequantize_int8(int_data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return int_data.to(scale.dtype) * scale


def quantize_int8_both(
    x: torch.Tensor,
    *,
    stochastic_rounding: bool = False,
    key: int | None = None,
    eps: float = EPS,
    cols_over=None,
):
    """Quantize a 2-D ``x`` along both axes: -> (q_row, s_row, q_col, s_col).

    The mixed-precision backward consumes the same output gradient row-wise
    (grad_input) and column-wise (grad_weight). This is B5's wrapper: two
    reads of x on a CUDA tensor, the plain version on a CPU tensor; the
    numbers are those of two separate :func:`quantize_int8` calls, bit for
    bit, under SR with the keys ``random.split(key)`` (row, then column),
    as ``core.py:167`` splits one.

    ``cols_over``: the name of the column maxima's axis (the first); where
    a mesh splits it, B5 runs as its maxima form, the all-reduce of the
    column maxima and its given-maxima form.
    """
    if x.ndim != 2:
        raise ValueError(f"quantize_int8_both: needs a 2-D tensor, got shape {tuple(x.shape)}")
    if stochastic_rounding and key is None:
        raise ValueError("stochastic_rounding=True requires a key")
    kw = dict(eps=eps, sr=stochastic_rounding, key=key)
    span = _span(cols_over)
    if span is not None:
        x = x.contiguous()
        q_row, s_row, amax = quantize_int8_both_maxima(x, **kw)
        key_col = random.split(key)[1] if stochastic_rounding else None  # B5's column cast's key
        return (q_row, s_row, *quantize_int8_colwise_given(x, max_over(amax, span), eps=eps, sr=stochastic_rounding,
                                                           key=key_col))
    return _quantize_both_kernel(x.contiguous(), **kw)


def quantize_int4_rowwise_absmax(x: torch.Tensor, over=None):
    """Signed row-wise int4 of a 2-D ``x`` over the full [-8, 7] range ->
    (packed int8 [M, N // 2], scale [M] in x's dtype).

    In the JAX order: ``pos = max(relu(x)) / 7`` and ``neg = max(relu(-x)) /
    8`` in x's dtype, ``scale = max(pos, neg)``, then q = round(x * (1 /
    clip(scale, 1e-12))) in fp32, cast to int8 with no clip. Two values per
    byte, the even element in the high nibble. Every division is by a
    tensor (CUDA divides by a Python scalar as a reciprocal multiply).
    ``over``: the name of the axis a row's maxima reduce (dim 1); where a
    mesh splits it, both maxima are all-reduced before the scale is formed."""
    pos_max, neg_max = torch.relu(x).amax(dim=1), torch.relu(-x).amax(dim=1)
    span = _span(over)
    if span is not None:
        pos_max, neg_max = max_over(torch.stack([pos_max, neg_max]), span)
    # x.new_full: a fill on x's device, where torch.tensor would copy from
    # the host and wait for the device
    pos = pos_max / x.new_full((), 7.0)
    neg = neg_max / x.new_full((), 8.0)
    scale = torch.maximum(pos, neg)
    inv = x.new_ones((), dtype=torch.float32) / scale.float().clamp(min=1e-12)
    q = torch.round(x.float() * inv[:, None]).to(torch.int8)
    packed = (q[:, ::2] << 4) | (q[:, 1::2] & 0xF)
    return packed, scale


def unpack_int4_rowwise(packed: torch.Tensor) -> torch.Tensor:
    """[M, P] int8 nibble pairs -> [M, 2P] int8 values in [-8, 7], high
    nibble first (``ops/int4_mm.py::unpack_int4`` on a 2-D tensor)."""
    return unpack_int4(packed)


def quantize_int4_groupwise(x: torch.Tensor, group_size: int = 32, *, stochastic_rounding: bool = False,
                            key: int | None = None):
    """Asymmetric group-wise uint4 of ``x`` (any shape, numel a multiple of
    ``group_size``), two values a byte, the even element in the high
    nibble: ``x = zero_point + u4 * scale``, u4 in [0, 15]. Returns (packed
    uint8 [n_groups, group_size // 2], scale [n_groups], zero_point
    [n_groups]), both in x's dtype.

    In fp32: zero_point = the group's min, scale = (max - min) / 15, q =
    (x - min) / max(scale, 1e-12), rounded half to even, or with
    ``stochastic_rounding`` floor(q + u), u from the stream of ``key`` at
    q's row-major index (``ops/random.py``; JAX draws ``jax.random.uniform``),
    then clipped to [0, 15]. Every division is by a tensor (CUDA divides by
    a Python scalar as a reciprocal multiply)."""
    if stochastic_rounding and key is None:
        raise ValueError("stochastic_rounding=True requires a key")
    xf = x.float().reshape(-1, group_size)
    zero_point = xf.amin(dim=-1)
    shifted = xf - zero_point[:, None]
    scale = shifted.amax(dim=-1) / xf.new_full((), 15.0)
    q = shifted / scale.clamp(min=1e-12)[:, None]
    if stochastic_rounding:
        q = torch.floor(q + random.uniform(key, q.shape, q.device))
    else:
        q = torch.round(q)
    q = q.clamp(0, 15).to(torch.uint8)
    packed = (q[:, ::2] << 4) | q[:, 1::2]
    return packed, scale.to(x.dtype), zero_point.to(x.dtype)


def dequantize_int4_groupwise(packed: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
                              shape) -> torch.Tensor:
    """Inverse of :func:`quantize_int4_groupwise`: ``zero_point + u4 *
    scale`` in the scale's dtype, each operation rounded to it, reshaped to
    ``shape``."""
    u4 = torch.stack([packed >> 4, packed & 0xF], dim=-1).reshape(packed.shape[0], -1)
    return (zero_point[:, None] + u4.to(scale.dtype) * scale[:, None]).reshape(shape)


def get_bitnet_scale(x: torch.Tensor, over=None) -> torch.Tensor:
    """Tensor-wise mean of |x|, in fp32 (``core.py:273``). Its sum runs in
    torch's order, not XLA's: the two may differ in the last bits.
    ``over``: the name of the span of a weight's elements (``"weights"``);
    where a mesh splits it, x is a rank's equal share of the matrix (or the
    whole of it, replicated), and the sum of |x| is all-reduced over the
    mesh axis and divided by the element count of every rank's x, as JAX's
    partitioned program takes the mean over the whole matrix."""
    span = _span(over)
    if span is None:
        return x.float().abs().mean()
    from ..parallel.collectives import all_reduce, axis_size

    return all_reduce(x.float().abs().sum(), *span) / (x.numel() * axis_size(*span))


def quantize_bitnet_weight(w: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Ternarize to {-1, 0, 1} int8: round(w / max(scale, eps)) clipped, in
    fp32; ``scale`` is a tensor (a scalar, or one a matrix, broadcast)."""
    wf = w.float() / scale.float().clamp(min=eps)
    return torch.round(wf).clamp(-1, 1).to(torch.int8)


def pack_i2_in_i8(x: torch.Tensor) -> torch.Tensor:
    """Four ternary int8 values (2 bits each) into one int8 along the last
    axis, the first in the top bits: [..., N] -> [..., N // 4]."""
    x0 = x[..., 0::4] << 6
    x1 = (x[..., 1::4] & 0b11) << 4
    x2 = (x[..., 2::4] & 0b11) << 2
    x3 = x[..., 3::4] & 0b11
    return (x0 | x1 | x2 | x3).to(torch.int8)


def unpack_i2_in_i8(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_i2_in_i8`, sign-extended by a left shift and
    an arithmetic right shift: [..., N] int8 -> [..., 4 N] int8."""
    parts = [x >> 6, (x << 2) >> 6, (x << 4) >> 6, (x << 6) >> 6]
    return torch.stack(parts, dim=-1).reshape(*x.shape[:-1], x.shape[-1] * 4)
