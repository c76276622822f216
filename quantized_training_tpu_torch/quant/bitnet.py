"""BitNet 1.58-bit quantized training.

Counterpart of ``quantized_training_tpu/quant/bitnet.py``:

- :class:`BitNetWeight`: the weight kept in its dtype, ternarized to {-1,
  0, 1} with a tensor-wise abs-mean fp32 scale at every forward; its one
  leaf is ``data``, which the optimizer updates as it is;
- :class:`BitNetPackedWeight`: the ternary weight packed four to an int8,
  with a scale a matrix (one a layer when stacked), for inference;
- the linear (``_bitnet_linear``, :121-144): K1 on the activations at
  ``eps=1e-5``, then K2 with the scale, a scalar in the weight's dtype, as
  its column scale; backward grad_input ``(g @ w_i8) * scale`` and the
  weight's gradient from the quantized activation ``g^T @ (x_i8 *
  row_scale)``; the packed linear (:181-205) the same on the unpacked
  weight.

The ternarization, the pack and unpack and the backward's matmuls are plain
torch, as XLA lowered them. A ``BitNetWeight`` whose ``mesh`` has an fsdp
axis larger than 1 (set by ``parallel.bitnet_fsdp_params``) takes the 2-bit
all-gather of ``parallel/fsdp.py`` (JAX :165-172). Under tensor
parallelism (``parallel/collectives.py::spanning``'s ``weights`` and
``features``) a ``BitNetWeight``'s abs-mean is that of the whole matrix,
summed over the mesh axis, and a row-parallel linear sums its int32 partial
products over it before the scales.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import remat
from .core import (get_bitnet_scale, pack_i2_in_i8, quantize_bitnet_weight, quantize_int8, scaled_mm_over,
                   unpack_i2_in_i8)
from .int8 import _scales
from .node import WeightNode

ACT_EPS = 1e-5  # the activations' quantize eps (bitnet.py:134)


@dataclass
class BitNetWeight(WeightNode):
    """A weight ternarized at every matmul. ``mesh``: a
    ``parallel.Mesh`` whose fsdp axis routes the linear through the 2-bit
    all-gather, ``data`` then holding this rank's rows; None on one
    device. A saved checkpoint keeps no mesh."""

    data: torch.Tensor  # [.., out, in]
    mesh: object = None
    data_fields = ("data",)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape


@dataclass
class BitNetPackedWeight(WeightNode):
    """2-bit packed ternary weight with a scale a matrix: ``dequant =
    unpack(packed) * scale``."""

    packed: torch.Tensor  # [.., out, in / 4] int8
    scale: torch.Tensor  # [..] (a scalar a matrix)
    data_fields = ("packed", "scale")

    @classmethod
    def from_weight(cls, w: torch.Tensor, scale: torch.Tensor | None = None) -> "BitNetPackedWeight":
        """Ternarize and pack ``w`` [out, in] or stacked [L, out, in], with
        the abs-mean of each matrix (fp32) unless ``scale`` is given; the
        scale is kept in w's dtype."""
        if scale is None:
            scale = w.float().abs().mean(dim=(-2, -1))
        w_i8 = quantize_bitnet_weight(w, scale[..., None, None] if w.ndim == 3 else scale)
        return cls(pack_i2_in_i8(w_i8), scale.to(w.dtype))

    def dequantize(self, dtype=None) -> torch.Tensor:
        out = unpack_i2_in_i8(self.packed).to(self.scale.dtype) * self.scale[..., None, None]
        return out.to(dtype) if dtype is not None else out

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def shape(self):
        return self.packed.shape[:-1] + (self.packed.shape[-1] * 4,)


def _ternary_mm(x2d, w_i8, scale):
    """K1 on x2d at ``ACT_EPS`` (its mesh forms where tensor parallelism
    splits x's features), then K2 against the ternary weight with ``scale``
    as the column scale, its int32 sums summed over the mesh axis there
    first: -> (out, x_i8, row_scale). In the replay of an unread output
    (remat) the quantize its node saves, no product."""
    x_i8, row_scale = quantize_int8(x2d, axis=-1, eps=ACT_EPS, over="features")
    if remat.skips():
        return remat.unread_like(x2d, (x2d.shape[0], w_i8.shape[0])), x_i8, row_scale
    sa, sb = _scales(row_scale, scale)
    out = scaled_mm_over(x_i8, w_i8, sa, sb, dims=(1, 1), out_dtype=x2d.dtype, over="features")
    return out, x_i8, row_scale


class _BitNetLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w):
        tensor_scale = get_bitnet_scale(w, over="weights")  # fp32, over the whole matrix under TP
        w_i8 = quantize_bitnet_weight(w, tensor_scale)
        tensor_scale = tensor_scale.to(w.dtype)
        out, x_i8, row_scale = _ternary_mm(x2d, w_i8, tensor_scale)
        ctx.save_for_backward(x_i8, row_scale, w_i8, tensor_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        x_i8, row_scale, w_i8, tensor_scale = ctx.saved_tensors
        g = g.to(tensor_scale.dtype)
        grad_input = grad_weight = None
        if ctx.needs_input_grad[0]:
            grad_input = (g @ w_i8.to(g.dtype)) * tensor_scale
        if ctx.needs_input_grad[1]:
            grad_weight = g.T @ (x_i8.to(g.dtype) * row_scale)
        return grad_input, grad_weight


class _BitNetPackedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, packed, scale):
        ctx.save_for_backward(packed, scale)
        if remat.skips():  # the replay of an unread output (remat): the node only
            return remat.unread_like(x2d, (x2d.shape[0], packed.shape[-2]))
        out, _, _ = _ternary_mm(x2d, unpack_i2_in_i8(packed), scale)
        return out

    @staticmethod
    def backward(ctx, g):
        packed, scale = ctx.saved_tensors
        g = g.to(scale.dtype)
        return (g @ unpack_i2_in_i8(packed).to(g.dtype)) * scale, None, None


def linear(x: torch.Tensor, w: BitNetWeight | BitNetPackedWeight, bias: torch.Tensor | None = None, *,
           key: int | None = None) -> torch.Tensor:
    """y = x @ w^T + bias with the ternary weight (``key`` is unused: no
    quantize here rounds stochastically)."""
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(w, BitNetPackedWeight):
        out = _BitNetPackedLinear.apply(x2d, w.packed, w.scale)
    elif w.mesh is not None and w.mesh.shape["fsdp"] > 1:
        from ..parallel.fsdp import bitnet_fsdp_linear

        out = bitnet_fsdp_linear(x2d, w.data, w.mesh)  # w.data: this rank's rows
    else:
        out = _BitNetLinear.apply(x2d, w.data)
    out = out.reshape(*x.shape[:-1], out.shape[-1])
    return out + bias if bias is not None else out
