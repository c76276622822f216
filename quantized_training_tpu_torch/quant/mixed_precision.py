"""Mixed-precision int8 linear, forward and backward.

Counterpart of ``quantized_training_tpu/quant/mixed_precision.py`` (:30-322):
``MixedPrecisionWeight``, ``_dynamic_int8_mm``, ``_mp_linear`` and
``_mp_linear_shared`` with their backwards (``torch.autograd.Function`` in
place of ``jax.custom_vjp``), ``linear`` and ``linear_shared``. The forward,
grad_input and grad_weight matmuls are each int8 or plain, per
``MixedPrecisionConfig``; each int8 matmul quantizes both operands along its
contraction axis, so the scales stay off the reduction dim:

- forward x . w^T, dims (1, 1): K1 twice, K2;
- grad_input g . w, dims (1, 0): g row-wise, w column-wise (B4), B1;
- grad_weight g^T . x over the tokens, dims (0, 0): g and x column-wise,
  B2. With both backward matmuls int8, g is quantized along both axes by
  B5 (two reads of g).

Stochastic rounding draws from a key (an int, ``ops/random.py``), derived
where the JAX package derives its keys: ``fold_in(key, 0/1/2/3)`` per use
(``_subkey``), a ``split`` per pair of operands. The autograd Functions
keep the key in ``ctx``, so a checkpointed layer replayed with the same key
rounds the same way, and no two quantizes of one call share a stream.

No operand is transposed in memory. Only ``dtype='int8'`` is ported: int4
and fp8 raise. ``PreQuantMPWeight`` (per-step pre-quantized weights) is not
ported. The JAX package pads the token dim to a multiple of 256 above 1024
tokens (``_pad_tokens``); the padded rows are zero and change no number, so
the port does not pad.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.random import fold_in, split
from ..ops.scaled_mm import scaled_mm_general
from .configs import MixedPrecisionConfig
from .core import quantize_int8, quantize_int8_both


@dataclass
class MixedPrecisionWeight:
    """bf16 master weight + static per-matmul quantization config.

    ``data`` is [out, in], or [L, out, in] when stacked over layers;
    indexing a stacked weight gives the wrapped per-layer slice."""

    data: torch.Tensor
    config: MixedPrecisionConfig

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, idx) -> "MixedPrecisionWeight":
        return MixedPrecisionWeight(self.data[idx], self.config)


def _require_int8(config: MixedPrecisionConfig) -> None:
    if config.dtype != "int8":
        raise NotImplementedError(
            f"mixed_precision dtype={config.dtype!r} is not ported yet "
            "(ROADMAP A7: int4 needs ROADMAP B16, fp8 its own GEMM)"
        )


def _all_int8(config: MixedPrecisionConfig) -> bool:
    return config.dtype == "int8" and config.output and config.grad_input and config.grad_weight


def _subkey(key: int, i: int) -> int:
    return fold_in(key, i)


def _dynamic_int8_mm(a, b, sr: bool, key: int | None, dims=(1, 0)):
    """Contract a over dims[0] and b over dims[1], both dynamically
    quantized to INT8 along their contraction axis, each operand from its
    own half of ``split(key)`` under SR (JAX :72-75)."""
    ka, kb = split(key) if sr else (None, None)
    a_i8, sa = quantize_int8(a, axis=dims[0], stochastic_rounding=sr, key=ka)
    b_i8, sb = quantize_int8(b, axis=dims[1], stochastic_rounding=sr, key=kb)
    return scaled_mm_general(a_i8, b_i8, sa, sb, dims=dims, out_dtype=a.dtype)


def _mp_forward(config: MixedPrecisionConfig, x2d, w, key: int):
    """x2d [B, in] @ w.T [in, out]; w is [out, in]."""
    _require_int8(config)
    sr = config.stochastic_rounding
    if config.output:
        return _dynamic_int8_mm(x2d, w, sr, _subkey(key, 0), dims=(1, 1))
    return x2d @ w.T


def _grads_both_int8(g, w, x_col, x_col_s, sr, kg, kw):
    """(grad_input, grad_weight) of one weight with both backward matmuls
    int8, given the column quantize of its input: g along both axes (B5,
    key ``kg``), w column-wise (B4, key ``kw``), then B1 and B2 (JAX
    :184-198)."""
    g_row, g_row_s, g_col, g_col_s = quantize_int8_both(g, stochastic_rounding=sr, key=kg)
    w_col, w_col_s = quantize_int8(w, axis=0, stochastic_rounding=sr, key=kw)
    grad_input = scaled_mm_general(g_row, w_col, g_row_s, w_col_s, dims=(1, 0), out_dtype=w.dtype)
    # g^T . x contracted over the tokens as stored: the result is [out, in]
    grad_weight = scaled_mm_general(g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype)
    return grad_input, grad_weight


class _MPLinear(torch.autograd.Function):
    """``_mp_linear`` with its custom backward (JAX :137-218). Saves x2d
    and w only: the backward re-quantizes them, so the forward does no
    backward-only work (JAX :160-166)."""

    @staticmethod
    def forward(ctx, x2d, w, config, key):
        out = _mp_forward(config, x2d, w, key)
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(x2d, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        config, key = ctx.config, ctx.key
        sr = config.stochastic_rounding
        g = g.to(w.dtype)
        if config.grad_input and config.grad_weight:
            kg, kw, kx = split(_subkey(key, 1), 3) if sr else (None,) * 3
            x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
            grad_input, grad_weight = _grads_both_int8(g, w, x_col, x_col_s, sr, kg, kw)
            return grad_input, grad_weight, None, None
        if config.grad_input:
            grad_input = _dynamic_int8_mm(g, w, sr, _subkey(key, 1), dims=(1, 0))
        else:
            grad_input = g @ w
        if config.grad_weight:
            grad_weight = _dynamic_int8_mm(g, x2d, sr, _subkey(key, 2), dims=(0, 0))
        else:
            grad_weight = g.T @ x2d
        return grad_input, grad_weight, None, None


class _MPLinearShared(torch.autograd.Function):
    """``_mp_linear_shared`` (JAX :221-276): y_i = x2d @ ws[i].T with ONE
    row quantize of x2d for all heads in the forward and ONE column quantize
    of it in the backward. All-int8 configs only (the caller checks).
    grad_input is summed head by head in w.dtype, in the JAX order. Under
    SR: x2d's row quantize from ``_subkey(key, 0)``, weight i's from
    ``fold_in(_subkey(key, 1), i)``; in the backward x2d's column quantize
    from ``fold_in(_subkey(key, 2), 0)`` and head i's (g, w) from
    ``split(fold_in(_subkey(key, 3), i))``."""

    @staticmethod
    def forward(ctx, config, key, x2d, *ws):
        sr = config.stochastic_rounding
        kx = _subkey(key, 0) if sr else None
        x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=kx)
        outs = []
        for i, w in enumerate(ws):
            kw = fold_in(_subkey(key, 1), i) if sr else None
            w_row, w_row_s = quantize_int8(w, axis=1, stochastic_rounding=sr, key=kw)
            outs.append(scaled_mm_general(x_row, w_row, x_row_s, w_row_s, dims=(1, 1),
                                          out_dtype=x2d.dtype))
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(x2d, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        x2d, *ws = ctx.saved_tensors
        sr, key = ctx.config.stochastic_rounding, ctx.key
        kx = fold_in(_subkey(key, 2), 0) if sr else None
        x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
        grad_input, grad_ws = None, []
        for i, (w, g) in enumerate(zip(ws, gs)):
            kg, kw = split(fold_in(_subkey(key, 3), i)) if sr else (None, None)
            gi, gw = _grads_both_int8(g.to(w.dtype), w, x_col, x_col_s, sr, kg, kw)
            grad_input = gi if grad_input is None else grad_input + gi
            grad_ws.append(gw)
        return None, None, grad_input, *grad_ws


def _resolve_key(config: MixedPrecisionConfig, key: int | None) -> int:
    """JAX :353-356: a missing key is 0, unless SR needs one."""
    if key is None:
        if config.stochastic_rounding:
            raise ValueError("stochastic_rounding requires a key")
        return 0
    return key


def linear(x, w: MixedPrecisionWeight, bias=None, *, key: int | None = None):
    """Mixed-precision linear: y = x @ w.T + bias with per-matmul quant."""
    key = _resolve_key(w.config, key)
    x2d = x.reshape(-1, x.shape[-1])
    out = _MPLinear.apply(x2d, w.data, w.config, key)
    out = out.reshape(*x.shape[:-1], w.data.shape[0])
    return out + bias if bias is not None else out


def linear_shared(x, weights, *, key: int | None = None):
    """[y_i = x @ w_i.T] with the shared input quantized once (JAX
    :279-322). ``weights``: MixedPrecisionWeight with one all-int8 config;
    any other mix takes one :func:`linear` per weight, weight i with
    ``fold_in(key, i)`` so that no two of them share a stream."""
    configs = {w.config for w in weights}
    cfg = next(iter(configs))
    if len(configs) != 1 or not _all_int8(cfg):
        return [linear(x, w, key=None if key is None else fold_in(key, i)) for i, w in enumerate(weights)]
    key = _resolve_key(cfg, key)
    x2d = x.reshape(-1, x.shape[-1])
    outs = _MPLinearShared.apply(cfg, key, x2d, *(w.data for w in weights))
    return [o.reshape(*x.shape[:-1], w.data.shape[0]) for o, w in zip(outs, weights)]
