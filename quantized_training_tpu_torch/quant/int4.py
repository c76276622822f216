"""Int4 weight-only quantized training.

Counterpart of ``quantized_training_tpu/quant/int4.py``: :class:`Int4Weight`
(asymmetric group-wise uint4, two values a byte, a scale and a zero point a
group, ``quant/core.py::quantize_int4_groupwise``), :func:`requantize` with
stochastic rounding for the commit, and the weight-only linear as a
``torch.autograd.Function``: the weight dequantized, a matmul in x's dtype
forward and backward, and ``g^T @ x2d`` routed to the master (:89-142). The
backward dequantizes again rather than keep the widened weight. Where
tensor parallelism splits x's features (a row-parallel linear) the partial
products are summed over the mesh axis in fp32 and rounded once
(``quant/core.py::matmul_over``). This is not
the signed row-wise int4 of mixed precision (B16): no kernel runs here, as
none did in JAX, where XLA lowered the dequantize and the matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import remat
from .core import dequantize_int4_groupwise, matmul_over, quantize_int4_groupwise
from .node import WeightNode


@dataclass
class Int4Weight(WeightNode):
    """Group-wise uint4 storage of a weight of shape ``lead + (O, I)``
    (lead: stacked layers): ``packed`` lead + (O * I / group_size,
    group_size / 2) uint8, ``scale`` and ``zero_point`` lead + (O * I /
    group_size,) in the weight's dtype."""

    packed: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    master: torch.Tensor | None = None
    mat_shape: tuple = ()  # (O, I)
    group_size: int = 32
    data_fields = ("packed", "scale", "zero_point", "master")

    @classmethod
    def from_float(cls, w: torch.Tensor, group_size: int = 32) -> "Int4Weight":
        packed, scale, zp = _quantize(w, group_size, sr=False, key=None)
        return cls(packed, scale, zp, None, tuple(w.shape[-2:]), group_size)

    def dequantize(self) -> torch.Tensor:
        return _deq(self.packed, self.scale, self.zero_point, self.mat_shape)

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def shape(self):
        return self.packed.shape[:-2] + self.mat_shape


def _quantize(w: torch.Tensor, group_size: int, sr: bool, key: int | None):
    lead = w.shape[:-2]
    n_groups = w.shape[-2] * w.shape[-1] // group_size
    packed, scale, zp = quantize_int4_groupwise(w, group_size, stochastic_rounding=sr, key=key)
    return (packed.reshape(*lead, n_groups, group_size // 2), scale.reshape(*lead, n_groups),
            zp.reshape(*lead, n_groups))


def _deq(packed, scale, zero_point, mat_shape):
    lead = packed.shape[:-2]
    return dequantize_int4_groupwise(packed.reshape(-1, packed.shape[-1]), scale.reshape(-1),
                                     zero_point.reshape(-1), lead + tuple(mat_shape))


def requantize(w_new: torch.Tensor, old: Int4Weight, key: int) -> Int4Weight:
    """An updated master back to storage, rounded stochastically from ``key``."""
    packed, scale, zp = _quantize(w_new, old.group_size, sr=True, key=key)
    return Int4Weight(packed, scale, zp, None, old.mat_shape, old.group_size)


class _Int4Linear(torch.autograd.Function):
    """x2d [M, in] . w^T with w int4-stored; ``master`` carries the
    weight's gradient and is not read."""

    @staticmethod
    def forward(ctx, mat_shape, x2d, master, packed, scale, zero_point):
        del master
        ctx.mat_shape = mat_shape
        ctx.save_for_backward(x2d, packed, scale, zero_point)
        if remat.skips():  # the replay of an unread output (remat): the node only
            return remat.unread_like(x2d, (x2d.shape[0], mat_shape[0]))
        return matmul_over(x2d, _deq(packed, scale, zero_point, mat_shape), "features")

    @staticmethod
    def backward(ctx, g):
        x2d, packed, scale, zero_point = ctx.saved_tensors
        g = g.to(scale.dtype)
        grad_input = grad_master = None
        if ctx.needs_input_grad[1]:
            grad_input = g @ _deq(packed, scale, zero_point, ctx.mat_shape)
        if ctx.needs_input_grad[2]:
            grad_master = g.T @ x2d
        return None, grad_input, grad_master, None, None, None


def linear(x: torch.Tensor, w: Int4Weight, bias: torch.Tensor | None = None, *, key: int | None = None):
    """y = x @ w^T + bias (``key`` is unused: the forward rounds nothing)."""
    x2d = x.reshape(-1, x.shape[-1])
    out = _Int4Linear.apply(w.mat_shape, x2d, w.master, w.packed, w.scale, w.zero_point)
    out = out.reshape(*x.shape[:-1], w.mat_shape[0])
    return out + bias if bias is not None else out
