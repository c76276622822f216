"""Producer-fused quantized linears.

Counterpart of ``quantized_training_tpu/quant/fused.py`` (:82-714):
:func:`norm_linear_multi` runs RMSNorm inside the input quantize of the
shared-input multi-linear (the q/k/v and gate/up sites), and
:func:`silu_mul_linear` runs silu(gate) * up inside the down projection's
input quantize (``ops/fused_producers.py``: B7 and the row form of B9). The
producer's bf16 output never reaches memory: not in the forward, not in the
remat replay, and not in the backward, whose column quantize re-derives the
producer from its inputs (B8 and the column form of B9), with the column
scales the forward's kernel gathered, and whose RMSNorm backward is one pass
(B10). The quantization is that of the unfused composite (``rms_norm`` ->
``linear_shared``, ``silu * mul`` -> ``linear``): absmax/127 scales of the
same producer values, each matmul re-quantizing its operands; the fused
quantize sees the producer's unrounded fp32 values, so its int8 may differ
from the composite's by one step.

The fused path serves int8 configs whose forward and grad_input matmuls are
int8 (:func:`_fusable_cfg`), at shapes the kernels take
(``fused_producers.supported``); everything else takes the unfused
composite. ``set_impl``: 'auto' fuses on CUDA tensors and takes the
composite on the CPU, as the JAX package does off the TPU; 'interpret' also
fuses on the CPU, where every kernel wrapper takes its plain version (the
counterpart of Pallas interpret mode); 'off', or ``QT_FUSED=0`` in the
environment, never fuses. On a CUDA tensor the fused path launches the
kernels or raises.

Keys (ints, ``ops/random.py``) are derived as the JAX package derives them:
``_sub(key, i) = fold_in(key, i)``, weight i's row quantize from
``fold_in(_sub(key, 1), i)``, the backward's (g, w) pair of weight i from
``split(fold_in(_sub(key, 3), i))``. The JAX package turns ``_sub(key, 0)``
and ``_sub(key, 2)`` into int32 seeds for the TPU's generator (``_kseed``);
here they are the Philox keys of the producer kernels themselves.
``PreQuantMPWeight`` and the one-op MLP ``_mlp_mm`` are not ported.
"""

from __future__ import annotations

import os

import torch

from ..ops import fused_producers as fp
from ..ops.random import fold_in, split
from ..ops.scaled_mm import scaled_mm_general
from .api import qlinear, qlinear_multi
from .core import quantize_int8, quantize_int8_both
from .mixed_precision import MixedPrecisionWeight, _resolve_key

_IMPL = "auto"  # auto | off | interpret


def set_impl(mode: str) -> None:
    """'auto' (fused on CUDA tensors), 'off' (always unfused), 'interpret'
    (fused on the CPU too, through the kernels' plain versions)."""
    if mode not in ("auto", "off", "interpret"):
        raise ValueError(f"set_impl: one of 'auto', 'off', 'interpret', got {mode!r}")
    global _IMPL
    _IMPL = mode


def _fusable_cfg(config) -> bool:
    """Configs the fused ops cover (JAX :82-102): the forward and
    grad_input matmuls int8. On the TPU an all-bf16 backward fused better
    into XLA's own producer backward, so forward-only configs stay
    unfused there, and here alike."""
    return config.dtype == "int8" and config.output and config.grad_input


def _padded_rows(M: int) -> int:
    """The JAX package pads the tokens to a multiple of 256 from 1024 on
    (``_pad_tokens``) and gates on the padded count; the port does not pad
    (zero rows change no number) but gates on the same count."""
    return M if M < 1024 else -(-M // 256) * 256


def _fused_ok(x2d: torch.Tensor, n_inputs: int = 1) -> bool:
    if _IMPL == "off" or os.environ.get("QT_FUSED", "1") == "0":
        return False
    M, K = x2d.shape
    if not fp.supported(_padded_rows(M), K, x2d.dtype, n_inputs):
        return False
    return _IMPL == "interpret" or x2d.is_cuda


def _sub(key: int, i: int) -> int:
    return fold_in(key, i)


def _rmsnorm_bwd(x2d, gamma, dy, eps: float):
    """(dx, dgamma in gamma's dtype) of RMSNorm (JAX :174-196): B10 on the
    card, its plain version (the closed form of ``_rmsnorm_bwd_math``) on
    the CPU."""
    dx, dg = fp.rmsnorm_bwd(x2d, gamma, dy, norm_eps=eps)
    return dx, dg.to(gamma.dtype)


def _bf16_wgrad(g, h):
    """grad_w = g^T . h over the tokens, fp32 accumulation, in h's dtype
    (JAX :256-261)."""
    return (g.float().T @ h.float()).to(h.dtype)


def _grad_pair(g, w, sr: bool, gw8: bool, kg, kw):
    """The backward's int8 operands of one weight: g row-wise (and
    column-wise with ``gw8``, one B5) and w column-wise, and grad_input."""
    if gw8:
        g_row, g_row_s, g_col, g_col_s = quantize_int8_both(g, stochastic_rounding=sr, key=kg)
    else:
        g_row, g_row_s = quantize_int8(g, axis=1, stochastic_rounding=sr, key=kg)
        g_col = g_col_s = None
    w_col, w_col_s = quantize_int8(w, axis=0, stochastic_rounding=sr, key=kw)
    gi = scaled_mm_general(g_row, w_col, g_row_s, w_col_s, dims=(1, 0), out_dtype=w.dtype)
    return gi, g_col, g_col_s


class _NormMM(torch.autograd.Function):
    """rms_norm(x2d, gamma) @ w_i^T for every weight, the norm inside the
    shared input's row quantize (JAX ``_norm_mm``, :204-318). With an int8
    grad_weight the forward's B7 also gathers the column absmax of the norm
    values, so the backward's column quantize (B8) reads x once."""

    @staticmethod
    def forward(ctx, config, eps, key, x2d, gamma, *ws):
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        y_row, y_row_s, *col_amax = fp.rmsnorm_quant_rowwise(
            x2d, gamma, norm_eps=eps, sr=sr, key=_sub(key, 0) if sr else None, with_col_amax=gw8)
        y_row_s = y_row_s.to(x2d.dtype)
        outs = []
        for i, w in enumerate(ws):
            kw = fold_in(_sub(key, 1), i) if sr else None
            w_row, w_row_s = quantize_int8(w, axis=1, stochastic_rounding=sr, key=kw)
            outs.append(scaled_mm_general(y_row, w_row, y_row_s, w_row_s, dims=(1, 1), out_dtype=x2d.dtype))
        ctx.config, ctx.eps, ctx.key = config, eps, key
        ctx.save_for_backward(x2d, gamma, *col_amax, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        config, eps, key = ctx.config, ctx.eps, ctx.key
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        x2d, gamma, *ws = ctx.saved_tensors
        if gw8:
            col_amax = ws.pop(0)
            y_col, y_col_s = fp.rmsnorm_quant_colwise(
                x2d, gamma, norm_eps=eps, sr=sr, key=_sub(key, 2) if sr else None, scale=col_amax * (1.0 / 127.0))
            y_col_s = y_col_s.to(x2d.dtype)
        else:
            h = fp.rms_norm_ref(x2d, gamma, eps)  # once, for every bf16 wgrad
        dy, grad_ws = None, []
        for i, (w, g) in enumerate(zip(ws, gs)):
            g = g.to(x2d.dtype)
            kg, kw = split(fold_in(_sub(key, 3), i)) if sr else (None, None)
            gi, g_col, g_col_s = _grad_pair(g, w, sr, gw8, kg, kw)
            dy = gi if dy is None else dy + gi
            if gw8:
                grad_ws.append(scaled_mm_general(g_col, y_col, g_col_s, y_col_s, dims=(0, 0), out_dtype=w.dtype))
            else:
                grad_ws.append(_bf16_wgrad(g, h))
        dx, dgamma = _rmsnorm_bwd(x2d, gamma, dy, eps)
        return None, None, None, dx, dgamma, *grad_ws


def norm_linear_multi(x, gamma, weights, eps: float, *, key: int | None = None):
    """[rms_norm(x, gamma) @ w_i^T] with the norm fused into the shared
    input quantize when every weight is a MixedPrecisionWeight of one
    fusable config and the shape fits the kernels (JAX :321-362); else
    exactly ``rms_norm`` followed by ``qlinear_multi``."""
    configs = {w.config for w in weights if isinstance(w, MixedPrecisionWeight)}
    fused = (len(configs) == 1 and all(isinstance(w, MixedPrecisionWeight) for w in weights)
             and _fusable_cfg(next(iter(configs))))
    if fused:
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        fused = _fused_ok(x2d)
    if not fused:
        return qlinear_multi(fp.rms_norm_ref(x, gamma, eps), weights, key=key)
    cfg = next(iter(configs))
    outs = _NormMM.apply(cfg, float(eps), _resolve_key(cfg, key), x2d, gamma, *(w.data for w in weights))
    return [o.reshape(*x.shape[:-1], w.shape[-2]) for o, w in zip(outs, weights)]


class _SiluMM(torch.autograd.Function):
    """(silu(a2d) * b2d) @ w^T with the activation inside the input's row
    quantize (JAX ``_silu_mm``, :370-450); the backward's column quantize
    of the activation is B9's column form with the forward's scales."""

    @staticmethod
    def forward(ctx, config, key, a2d, b2d, w):
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        y_row, y_row_s, *col_amax = fp.silu_mul_quant_rowwise(
            a2d, b2d, sr=sr, key=_sub(key, 0) if sr else None, with_col_amax=gw8)
        w_row, w_row_s = quantize_int8(w, axis=1, stochastic_rounding=sr, key=_sub(key, 1) if sr else None)
        out = scaled_mm_general(y_row, w_row, y_row_s.to(a2d.dtype), w_row_s, dims=(1, 1), out_dtype=a2d.dtype)
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(a2d, b2d, w, *col_amax)
        return out

    @staticmethod
    def backward(ctx, g):
        config, key = ctx.config, ctx.key
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        a2d, b2d, w, *col_amax = ctx.saved_tensors
        g = g.to(a2d.dtype)
        kg, kw = split(_sub(key, 3)) if sr else (None, None)
        dy, g_col, g_col_s = _grad_pair(g, w, sr, gw8, kg, kw)
        if gw8:
            y_col, y_col_s = fp.silu_mul_quant_colwise(
                a2d, b2d, sr=sr, key=_sub(key, 2) if sr else None, scale=col_amax[0] * (1.0 / 127.0))
            grad_w = scaled_mm_general(g_col, y_col, g_col_s, y_col_s.to(a2d.dtype), dims=(0, 0), out_dtype=w.dtype)
        else:
            grad_w = _bf16_wgrad(g, fp.silu_mul_ref(a2d, b2d))
        # the producer's backward, of y = silu(a) rounded to a's dtype, times b
        af = a2d.float()
        s = torch.sigmoid(af)
        dyf = dy.float()
        db = (dyf * (af * s).to(a2d.dtype).float()).to(b2d.dtype)
        da = (dyf * b2d.float() * (s * (1.0 + af * (1.0 - s)))).to(a2d.dtype)
        return None, None, da, db, grad_w


def silu_mul_linear(gate, up, w, *, key: int | None = None):
    """(silu(gate) * up) @ w^T with the activation fused into the input
    quantize for a MixedPrecisionWeight of a fusable config at shapes the
    kernels take (JAX :453-480); else exactly ``silu * mul`` followed by
    ``qlinear``."""
    fused = isinstance(w, MixedPrecisionWeight) and _fusable_cfg(w.config)
    if fused:
        a2d = gate.reshape(-1, gate.shape[-1]).contiguous()
        b2d = up.reshape(-1, up.shape[-1]).contiguous()
        fused = _fused_ok(a2d, n_inputs=2)
    if not fused:
        return qlinear(fp.silu_mul_ref(gate, up), w, key=key)
    out = _SiluMM.apply(w.config, _resolve_key(w.config, key), a2d, b2d, w.data)
    return out.reshape(*gate.shape[:-1], w.shape[-2])


def mlp_linear(x, gamma, wg, wu, wd, eps: float, *, key: int | None = None):
    """The Llama MLP, (silu(norm(x) @ wg^T) * (norm(x) @ wu^T)) @ wd^T, as
    :func:`norm_linear_multi` for gate/up with ``fold_in(key, 0)`` and
    :func:`silu_mul_linear` for down with ``fold_in(key, 1)``: the JAX
    package's two-op branch (:695-701). Its one-op ``_mlp_mm``, which also
    fuses the silu backward into the quantizes of (dgate, dup), waits for
    B11 and B12 (``silu_mul_bwd_quant_rowwise`` / ``_colwise``)."""
    key = 0 if key is None else key
    gate, up = norm_linear_multi(x, gamma, [wg, wu], eps, key=fold_in(key, 0))
    return silu_mul_linear(gate, up, wd, key=fold_in(key, 1))
