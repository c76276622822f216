"""Int8 quantized training: int8 weight storage, optionally int8 activations.

Counterpart of ``quantized_training_tpu/quant/int8.py``: :class:`Int8Weight`
(int8 ``int_data`` [.., O, I] with a row scale [.., O, 1] in the weight's
dtype, and a ``master`` slot) and its linear, a ``torch.autograd.Function``
in place of the ``jax.custom_vjp`` (:73-102):

- forward, ``activation='none'``: ``(x2d @ int_data^T) * scale^T``, a bf16
  matmul of the int8 weight widened to x's dtype;
- forward, ``'int8'`` / ``'int8_sr'``: K1 on x2d (its SR form from the
  linear's key under ``'int8_sr'``; its mesh forms where tensor parallelism
  splits x's features, ``over="features"``), then K2 with the stored row
  scale as its column scale (``ops/scaled_mm.py``);
- where tensor parallelism splits x's features (a row-parallel linear),
  the linear sums its partial products over the mesh axis: the bf16
  matmul's in fp32, K2's as int32 before its scales
  (``quant/core.py::matmul_over``, ``::scaled_mm_over``);
- backward, always in x's dtype: grad_input ``(g * scale^T) @ int_data``,
  and ``g^T @ x2d`` routed to ``master``. The scale lies along
  grad_input's reduction, so there is no int8 backward GEMM.

The train step (``quant/api.py``) dequantizes the storage into a master,
attaches it for the forward, updates it, and re-quantizes it with
stochastic rounding. The linear never reads the master and never
dequantizes: where none is attached (serving, a forward under
``torch.no_grad()``) it only has no gradient to route. (JAX dequantizes a
missing master, work that XLA drops under ``jit``; run eagerly it would
dequantize every weight on every call.)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import remat
from .configs import Int8QTConfig
from .core import dequantize_int8, matmul_over, quantize_int8, scaled_mm_over
from .node import WeightNode


@dataclass
class Int8Weight(WeightNode):
    """Int8-stored linear weight: ``dequant = int_data * scale``. ``master``
    is None in storage form; during a train step it holds the
    differentiable dequantized weight."""

    int_data: torch.Tensor  # [.., out, in] int8
    scale: torch.Tensor  # [.., out, 1], the weight's dtype
    master: torch.Tensor | None = None
    config: Int8QTConfig = Int8QTConfig()
    data_fields = ("int_data", "scale", "master")

    @classmethod
    def from_float(cls, w: torch.Tensor, config: Int8QTConfig = Int8QTConfig()) -> "Int8Weight":
        """Row-wise absmax int8 of ``w`` (K1 on a CUDA tensor, any number
        of leading dims)."""
        int_data, scale = quantize_int8(w, axis=-1)
        return cls(int_data, scale, None, config)

    def dequantize(self) -> torch.Tensor:
        return dequantize_int8(self.int_data, self.scale)

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def shape(self):
        return self.int_data.shape


def _scales(x_scale, w_scale):
    """K2 takes two scales of one dtype: both in fp32 where they differ
    (exact for bf16, and the epilogue runs in fp32)."""
    if x_scale.dtype != w_scale.dtype:
        return x_scale.float(), w_scale.float()
    return x_scale, w_scale


class _Int8Linear(torch.autograd.Function):
    """x2d [M, in] . w^T with w int8-stored; ``master`` carries the weight's
    gradient and is not read."""

    @staticmethod
    def forward(ctx, config, key, x2d, master, int_data, scale):
        del master
        if remat.skips():  # the replay of an unread output (remat): the node only
            out = remat.unread_like(x2d, (x2d.shape[0], int_data.shape[0]))
        elif config.activation == "none":
            out = matmul_over(x2d, int_data.to(x2d.dtype), "features") * scale.reshape(1, -1)
        else:
            sr = config.activation == "int8_sr"
            x_i8, x_scale = quantize_int8(x2d, axis=-1, stochastic_rounding=sr, key=key if sr else None,
                                          over="features")
            sa, sb = _scales(x_scale, scale.reshape(1, -1))
            out = scaled_mm_over(x_i8, int_data, sa, sb, dims=(1, 1), out_dtype=x2d.dtype, over="features")
        ctx.save_for_backward(x2d, int_data, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, int_data, scale = ctx.saved_tensors
        g = g.to(scale.dtype)
        grad_input = grad_master = None
        if ctx.needs_input_grad[2]:
            grad_input = (g * scale.reshape(1, -1)) @ int_data.to(g.dtype)
        if ctx.needs_input_grad[3]:
            grad_master = g.T @ x2d
        return None, None, grad_input, grad_master, None, None


def linear(x: torch.Tensor, w: Int8Weight, bias: torch.Tensor | None = None, *,
           key: int | None = None) -> torch.Tensor:
    """y = x @ w^T + bias; ``key`` seeds the SR form of x's quantize under
    ``activation='int8_sr'``, which needs one."""
    if key is None:
        if w.config.activation == "int8_sr":
            raise ValueError("activation='int8_sr' requires a key")
        key = 0
    x2d = x.reshape(-1, x.shape[-1])
    out = _Int8Linear.apply(w.config, key, x2d, w.master, w.int_data, w.scale)
    out = out.reshape(*x.shape[:-1], w.int_data.shape[-2])
    return out + bias if bias is not None else out
