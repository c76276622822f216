"""Causal attention through PyTorch's fused SDPA kernels, with its residuals
in hand.

The JAX package's Llama attention on the TPU is splash attention, whose
(out, logsumexp) residuals its remat policy saves
(``quantized_training_tpu/models/llama.py:47-50, :281-288``), so that its
backward never runs the attention forward again. Its counterpart here is
``F.scaled_dot_product_attention``, whose autograd node keeps those
residuals out of reach. :func:`sdpa` runs the same kernels through the ops
that ``F.scaled_dot_product_attention`` dispatches to, forward and
backward, in an ``autograd.Function`` of its own: the backend is the one
``torch.ops.aten._fused_sdp_choice`` picks for these inputs (cuDNN, flash,
memory-efficient on a card; flash on the CPU), so the forward gives
``F.scaled_dot_product_attention``'s values and the backward calls the op
its autograd would call. In a remat replay (``ops/remat.py``) the forward
is not run: out, the log-sum-exp and the backend's other outputs are the
forward's own, saved when it ran. Where the choice is the math backend, or
the inputs take no fused kernel, ``F.scaled_dot_product_attention`` runs
as it is, with nothing saved: its replay runs it again, as JAX's non-splash
path does.

This is not a kernel of the port: it is PyTorch's, and not in
``ops.KERNELS``. It counts its forward launches on a card all the same
(``sdpa.launches``, read by ``ops.sdpa_forwards()``), so that a step's
count shows how often the attention forward ran.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import remat

_MATH, _FLASH, _EFFICIENT, _CUDNN = 0, 1, 2, 3  # torch.nn.attention.SDPBackend's values
_ATEN = torch.ops.aten
_SAVED = object()  # in ctx.extra: a residual kept with save_for_backward


def _choice(q, k, v, causal: bool, scale: float, gqa: bool) -> int:
    """The backend ``F.scaled_dot_product_attention`` takes for these inputs
    under grad (its choice sees whether an input needs a gradient)."""
    with torch.enable_grad():
        return int(_ATEN._fused_sdp_choice(q, k, v, None, 0.0, causal, scale=scale, enable_gqa=gqa))


def _forward(backend: int, q, k, v, causal: bool, scale: float):
    """(out, lse, the other residuals the backward takes) of one backend."""
    if backend == _CUDNN:
        r = _ATEN._scaled_dot_product_cudnn_attention(q, k, v, None, True, 0.0, causal, False, scale=scale)
        return r[0], r[1], (r[6], r[7], r[4], r[5])  # philox seed, offset, max_q, max_k
    if backend == _FLASH and q.is_cuda:
        r = _ATEN._scaled_dot_product_flash_attention(q, k, v, 0.0, causal, False, scale=scale)
        return r[0], r[1], (r[2], r[3], r[4], r[5], r[6], r[7])  # cum_seq_q/k, max_q/k, rng state, unused
    if backend == _FLASH:
        out, lse = _ATEN._scaled_dot_product_flash_attention_for_cpu(q, k, v, 0.0, causal, scale=scale)
        return out, lse, ()
    r = _ATEN._scaled_dot_product_efficient_attention(q, k, v, None, True, 0.0, causal, scale=scale)
    return r[0], r[1], (r[2], r[3])  # philox seed, offset


def _backward(backend: int, g, q, k, v, out, lse, extra, causal: bool, scale: float):
    """(dq, dk, dv): the backward op that autograd calls for ``backend``."""
    if backend == _CUDNN:
        seed, offset, max_q, max_k = extra
        return _ATEN._scaled_dot_product_cudnn_attention_backward(
            g, q, k, v, out, lse, seed, offset, None, None, None, max_q, max_k, 0.0, causal, scale=scale)
    if backend == _FLASH and q.is_cuda:
        cum_q, cum_k, max_q, max_k, rng, unused = extra
        return _ATEN._scaled_dot_product_flash_attention_backward(
            g, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, rng, unused, scale=scale)
    if backend == _FLASH:
        return _ATEN._scaled_dot_product_flash_attention_for_cpu_backward(g, q, k, v, out, lse, 0.0, causal,
                                                                          scale=scale)
    seed, offset = extra
    return _ATEN._scaled_dot_product_efficient_attention_backward(
        g, q, k, v, None, out, lse, seed, offset, 0.0, [True, True, True, False], causal, scale=scale)[:3]


class _SDPA(torch.autograd.Function):
    """One backend's fused attention: the forward's out and log-sum-exp kept
    for the backward, given back to a remat replay instead of recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, backend):
        if remat.replaying():
            out, lse, extra = remat.load("attention")
        else:
            out, lse, extra = _forward(backend, q, k, v, causal, scale)
            if q.is_cuda:
                sdpa.launches += 1
            remat.save("attention", out, lse, extra)
        tensors = [t for t in extra if isinstance(t, torch.Tensor)]
        ctx.save_for_backward(q, k, v, out, lse, *tensors)
        ctx.extra = [_SAVED if isinstance(t, torch.Tensor) else t for t in extra]
        ctx.causal, ctx.scale, ctx.backend = causal, scale, backend
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, *tensors = ctx.saved_tensors
        it = iter(tensors)
        extra = [next(it) if t is _SAVED else t for t in ctx.extra]
        dq, dk, dv = _backward(ctx.backend, g, q, k, v, out, lse, extra, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, is_causal: bool = True, scale: float | None = None,
         enable_gqa: bool = False) -> torch.Tensor:
    """``F.scaled_dot_product_attention(q, k, v, is_causal=..., scale=...,
    enable_gqa=...)`` on [B, H, S, hd] operands (k and v with H or fewer
    heads), through :class:`_SDPA` where a fused backend takes them."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    gqa = enable_gqa and k.shape[1] != q.shape[1]
    backend = _choice(q, k, v, is_causal, scale, gqa)
    if backend not in (_FLASH, _EFFICIENT, _CUDNN):
        if q.is_cuda:
            sdpa.launches += 1
        return F.scaled_dot_product_attention(q, k, v, is_causal=is_causal, scale=scale, enable_gqa=gqa)
    return _SDPA.apply(q, k, v, is_causal, scale, backend)


sdpa.launches = 0
