"""Producer-fused quantized linears.

Counterpart of ``quantized_training_tpu/quant/fused.py`` (:82-1099):
:func:`norm_linear_multi` runs RMSNorm inside the input quantize of the
shared-input multi-linear (the q/k/v site), :func:`mlp_linear` runs the
whole Llama MLP as one op (RMSNorm inside the gate/up input quantize,
silu(gate) * up inside the down projection's, ``ops/fused_producers.py``: B7
and the row form of B9), and :func:`attn_out_linear` ungroups the grouped
attention output inside the o-projection's input quantize
(``ops/rope.py``: B14). For the ViT, :func:`layernorm_linear` runs affine
LayerNorm inside the qkv and fc1 input quantizes and :func:`gelu_linear`
tanh-GELU inside fc2's (B18); both pad the tokens as the JAX package does,
since LayerNorm makes a zero row b. The producer's bf16 output never
reaches memory: not in the forward, not in the remat replay, and not in the
backward, whose column quantize re-derives the producer from its inputs
(B8, the column form of B9, B14 along columns, B18), with the column scales
the forward's kernel gathered, and whose RMSNorm backward is one pass
(B10). In the MLP's
backward (dgate, dup) are computed in fp32 and quantized along both axes
inside B11 and B12, never written in bf16. The quantization is that of the
unfused composite (``rms_norm`` -> ``linear_shared``, ``silu * mul`` ->
``linear``, ``ungroup_heads`` -> ``linear``): absmax/127 scales of the same
producer values, each matmul re-quantizing its operands; the fused quantize
sees the producer's unrounded fp32 values, so its int8 may differ from the
composite's by one step.

The fused path serves int8 configs whose forward and grad_input matmuls are
int8 (:func:`_fusable_cfg`), at shapes the kernels take
(``fused_producers.supported``); everything else takes the unfused
composite. ``set_impl``: 'auto' fuses on CUDA tensors and takes the
composite on the CPU, as the JAX package does off the TPU; 'interpret' also
fuses on the CPU, where every kernel wrapper takes its plain version (the
counterpart of Pallas interpret mode); 'off', or ``QT_FUSED=0`` in the
environment, never fuses. On a CUDA tensor the fused path launches the
kernels or raises.

Keys (ints, ``ops/random.py``) are derived as the JAX package derives them,
``_sub(key, i) = fold_in(key, i)``: in ``_norm_mm`` and ``_silu_mm`` weight
i's row quantize from ``fold_in(_sub(key, 1), i)``, the backward's (g, w)
pair of weight i from ``split(fold_in(_sub(key, 3), i))``; in ``_mlp_mm``
``_sub(key, 0..9)`` for its ten draws (:493-648); in ``_attn_out_mm``,
``_ln_mm`` and ``_gelu_mm`` ``_sub(key, 0..3)``. Where the JAX package
turns a subkey into an int32 seed for the TPU's generator (``_kseed``), the
same subkey is here the Philox key of the kernel.

The Llama ops take a ``PreQuantMPWeight`` (``QT_PREQUANT``) as they take a
``MixedPrecisionWeight`` (JAX :47-80): its row view replaces the weight's
row quantize in the forward and its column view the weight's column
quantize in the backward (``_row_view`` / ``_col_view``); the activations'
and cotangents' quantizes stay in the op. The views are arguments of the
autograd Functions, so a remat replay takes them as they are; a missing
view (a ``MixedPrecisionWeight``, or a mode that made one view only) is
quantized in the op with the key the dynamic path uses. The ViT's ops take
no views, as in the JAX package.

Under a mesh the column maxima that a forward kernel gathers over its rank's
tokens (B7's, B9-row's, B14's) and B11's are all-reduced over the token
axis's span before any column scale is formed from them (``max_over_each``,
in the backward, one all-reduce for those an op uses together), and B5 on
the cotangents takes its mesh forms (``cols_over``), so that every column
quantize is that of the global batch, as in JAX's partitioned program.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..ops import fused_producers as fp
from ..ops import remat, rope
from ..ops.random import fold_in, split
from ..ops.scaled_mm import scaled_mm_general
from .api import qlinear, qlinear_multi
from .core import max_over_each, quantize_int8, quantize_int8_both
from .mixed_precision import MixedPrecisionWeight, PreQuantMPWeight, _col_view, _pad_tokens, _resolve_key, _row_view

_IMPL = "auto"  # auto | off | interpret
# the weights the Llama ops fuse over (JAX :47-54)
_FUSED_WEIGHT_TYPES = (MixedPrecisionWeight, PreQuantMPWeight)


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
    (``_pad_tokens``) and gates on the padded count. The Llama ops here do
    not pad but gate on the same count: a zero row is zero after RMSNorm,
    silu(0) * up and the ungrouping, so it changes no scale. It is not zero
    after LayerNorm (it is b), so the ViT ops pad as the JAX package does."""
    return M if M < 1024 else -(-M // 256) * 256


def _fused_ok(M: int, K: int, like: torch.Tensor, n_inputs: int = 1) -> bool:
    """Whether the fused kernels take [M, K] inputs of ``like``'s dtype,
    on ``like``'s device under the current ``set_impl`` (JAX :143-155)."""
    if _IMPL == "off" or os.environ.get("QT_FUSED", "1") == "0":
        return False
    if not fp.supported(_padded_rows(M), K, like.dtype, n_inputs):
        return False
    return _IMPL == "interpret" or like.is_cuda


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


def _w_views(w):
    """A weight of the fused ops as (master, row_q, row_s, col_q, col_s):
    a PreQuantMPWeight's views, None for a MixedPrecisionWeight's (JAX
    :57-63)."""
    if isinstance(w, PreQuantMPWeight):
        return w.orig, w.row_q, w.row_s, w.col_q, w.col_s
    return w.data, None, None, None, None


def _grad_pair(g, w, sr: bool, gw8: bool, kg, kw, cq=None, cs=None):
    """The backward's int8 operands of one weight: g row-wise (and
    column-wise with ``gw8``, one B5) and w column-wise (its view ``cq``,
    ``cs`` where one was made); returns (grad_input, g_col, g_col_s)."""
    if gw8:
        g_row, g_row_s, g_col, g_col_s = quantize_int8_both(g, stochastic_rounding=sr, key=kg, cols_over="tokens")
    else:
        g_row, g_row_s = quantize_int8(g, axis=1, stochastic_rounding=sr, key=kg)
        g_col = g_col_s = None
    w_col, w_col_s = _col_view(w, cq, cs, sr, kw)
    gi = scaled_mm_general(g_row, w_col, g_row_s, w_col_s, dims=(1, 0), out_dtype=w.dtype)
    return gi, g_col, g_col_s


def _named_amax(name: str, col_amax: list) -> list:
    """A fused producer's column maxima (none, or one), named for the remat
    policy (JAX's ``QUANT_AMAX_RESIDUAL``, :106-125): a recording forward
    saves them, a replay takes the forward's."""
    if not col_amax:
        return col_amax
    if remat.replaying():
        return [remat.load(name)]
    return [remat.save(name, col_amax[0])]


class _NormMM(torch.autograd.Function):
    """rms_norm(x2d, gamma) @ w_i^T for every weight, the norm inside the
    shared input's row quantize (JAX ``_norm_mm``, :204-318). With an int8
    grad_weight the forward's B7 also gathers the column absmax of the norm
    values, so the backward's column quantize (B8) reads x once. ``flat``
    is the n weights, then their row views, row scales, column views and
    column scales (``_w_views``; None where a weight has none)."""

    @staticmethod
    def forward(ctx, config, eps, key, x2d, gamma, *flat):
        n = len(flat) // 5
        ws, row_qs, row_ss = flat[:n], flat[n:2 * n], flat[2 * n:3 * n]
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        if remat.skips():  # the replay of q/k/v given: only the node
            col_amax = [remat.load("norm_amax")] if gw8 else []
            outs = [remat.unread_like(x2d, (x2d.shape[0], w.shape[-2])) for w in ws]
        else:
            y_row, y_row_s, *col_amax = fp.rmsnorm_quant_rowwise(
                x2d, gamma, norm_eps=eps, sr=sr, key=_sub(key, 0) if sr else None, with_col_amax=gw8)
            col_amax = _named_amax("norm_amax", col_amax)
            y_row_s = y_row_s.to(x2d.dtype)
            outs = []
            for i, (w, rq, rs) in enumerate(zip(ws, row_qs, row_ss)):
                w_row, w_row_s = _row_view(w, rq, rs, sr, fold_in(_sub(key, 1), i) if sr else None)
                outs.append(scaled_mm_general(y_row, w_row, y_row_s, w_row_s, dims=(1, 1), out_dtype=x2d.dtype))
        ctx.config, ctx.eps, ctx.key, ctx.n = config, eps, key, n
        ctx.save_for_backward(x2d, gamma, *col_amax, *ws, *flat[3 * n:])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        config, eps, key = ctx.config, ctx.eps, ctx.key
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        n = ctx.n
        x2d, gamma, *rest = ctx.saved_tensors
        col_amax = rest.pop(0) if gw8 else None
        ws, col_qs, col_ss = rest[:n], rest[n:2 * n], rest[2 * n:]
        if gw8:
            col_amax, = max_over_each([col_amax], "tokens")
            y_col, y_col_s = fp.rmsnorm_quant_colwise(
                x2d, gamma, norm_eps=eps, sr=sr, key=_sub(key, 2) if sr else None, scale=col_amax * (1.0 / 127.0))
            y_col_s = y_col_s.to(x2d.dtype)
        else:
            h = fp.rms_norm_ref(x2d, gamma, eps)  # once, for every bf16 wgrad
        dy, grad_ws = None, []
        for i, (w, g) in enumerate(zip(ws, gs)):
            g = g.to(x2d.dtype)
            kg, kw = split(fold_in(_sub(key, 3), i)) if sr else (None, None)
            gi, g_col, g_col_s = _grad_pair(g, w, sr, gw8, kg, kw, col_qs[i], col_ss[i])
            dy = gi if dy is None else dy + gi
            if gw8:
                grad_ws.append(scaled_mm_general(g_col, y_col, g_col_s, y_col_s, dims=(0, 0), out_dtype=w.dtype))
            else:
                grad_ws.append(_bf16_wgrad(g, h))
        dx, dgamma = _rmsnorm_bwd(x2d, gamma, dy, eps)
        return None, None, None, dx, dgamma, *grad_ws, *(None,) * (4 * n)


def _one_fusable_config(ws):
    """The config of weights that the Llama ops fuse over, or None: all
    MixedPrecisionWeights or PreQuantMPWeights of one fusable config."""
    if not all(isinstance(w, _FUSED_WEIGHT_TYPES) for w in ws):
        return None
    configs = {w.config for w in ws}
    cfg = next(iter(configs))
    return cfg if len(configs) == 1 and _fusable_cfg(cfg) else None


def _flat_views(ws) -> list:
    """The weights' ``_w_views``, field by field: masters, row views, row
    scales, column views, column scales."""
    return [v for field in zip(*map(_w_views, ws)) for v in field]


def norm_linear_multi(x, gamma, weights, eps: float, *, key: int | None = None):
    """[rms_norm(x, gamma) @ w_i^T] with the norm fused into the shared
    input quantize when every weight is a MixedPrecisionWeight of one
    fusable config and the shape fits the kernels (JAX :321-362); else
    exactly ``rms_norm`` followed by ``qlinear_multi``. PreQuantMPWeights
    fuse as MixedPrecisionWeights do, on their views."""
    cfg = _one_fusable_config(weights)
    fused = cfg is not None
    if fused:
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        fused = _fused_ok(*x2d.shape, x2d)
    if not fused:
        return qlinear_multi(fp.rms_norm_ref(x, gamma, eps), weights, key=key)
    outs = _NormMM.apply(cfg, float(eps), _resolve_key(cfg, key), x2d, gamma, *_flat_views(weights))
    return [o.reshape(*x.shape[:-1], w.shape[-2]) for o, w in zip(outs, weights)]


class _SiluMM(torch.autograd.Function):
    """(silu(a2d) * b2d) @ w^T with the activation inside the input's row
    quantize (JAX ``_silu_mm``, :370-450); the backward's column quantize
    of the activation is B9's column form with the forward's scales."""

    @staticmethod
    def forward(ctx, config, key, a2d, b2d, w, rq, rs, cq, cs):
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        if remat.skips():  # the replay of the layer's last linear: only the node
            col_amax = [remat.load("silu_amax")] if gw8 else []
            out = remat.unread_like(a2d, (a2d.shape[0], w.shape[-2]))
        else:
            y_row, y_row_s, *col_amax = fp.silu_mul_quant_rowwise(
                a2d, b2d, sr=sr, key=_sub(key, 0) if sr else None, with_col_amax=gw8)
            col_amax = _named_amax("silu_amax", col_amax)
            w_row, w_row_s = _row_view(w, rq, rs, sr, _sub(key, 1) if sr else None)
            out = scaled_mm_general(y_row, w_row, y_row_s.to(a2d.dtype), w_row_s, dims=(1, 1),
                                    out_dtype=a2d.dtype)
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(a2d, b2d, w, cq, cs, *col_amax)
        return out

    @staticmethod
    def backward(ctx, g):
        config, key = ctx.config, ctx.key
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        a2d, b2d, w, cq, cs, *col_amax = ctx.saved_tensors
        g = g.to(a2d.dtype)
        kg, kw = split(_sub(key, 3)) if sr else (None, None)
        dy, g_col, g_col_s = _grad_pair(g, w, sr, gw8, kg, kw, cq, cs)
        if gw8:
            y_col, y_col_s = fp.silu_mul_quant_colwise(
                a2d, b2d, sr=sr, key=_sub(key, 2) if sr else None,
                scale=max_over_each(col_amax, "tokens")[0] * (1.0 / 127.0))
            grad_w = scaled_mm_general(g_col, y_col, g_col_s, y_col_s.to(a2d.dtype), dims=(0, 0), out_dtype=w.dtype)
        else:
            grad_w = _bf16_wgrad(g, fp.silu_mul_ref(a2d, b2d))
        # the producer's backward, of y = silu(a) rounded to a's dtype, times b
        af = a2d.float()
        s = torch.sigmoid(af)
        dyf = dy.float()
        db = (dyf * (af * s).to(a2d.dtype).float()).to(b2d.dtype)
        da = (dyf * b2d.float() * (s * (1.0 + af * (1.0 - s)))).to(a2d.dtype)
        return None, None, da, db, grad_w, None, None, None, None


def silu_mul_linear(gate, up, w, *, key: int | None = None):
    """(silu(gate) * up) @ w^T with the activation fused into the input
    quantize for a MixedPrecisionWeight of a fusable config at shapes the
    kernels take (JAX :453-480), or a PreQuantMPWeight on its views; else
    exactly ``silu * mul`` followed by ``qlinear``."""
    fused = _one_fusable_config([w]) is not None
    if fused:
        a2d = gate.reshape(-1, gate.shape[-1]).contiguous()
        b2d = up.reshape(-1, up.shape[-1]).contiguous()
        fused = _fused_ok(*a2d.shape, a2d, n_inputs=2)
    if not fused:
        return qlinear(fp.silu_mul_ref(gate, up), w, key=key)
    out = _SiluMM.apply(w.config, _resolve_key(w.config, key), a2d, b2d, *_w_views(w))
    return out.reshape(*gate.shape[:-1], w.shape[-2])


class _MLPMM(torch.autograd.Function):
    """The Llama MLP as one quantized op (JAX ``_mlp_mm``, :488-672):
    rms_norm(x2d, gamma) inside the gate/up input's row quantize (B7),
    silu(gate) * up inside the down input's (B9-row). One op lets the
    backward fuse across the two: (dgate, dup) are computed in fp32 from
    (gate, up, dact) and quantized along rows (B11) and, with an int8
    grad_weight, along columns (B12) with the column scales B11 gathered;
    with a bf16 grad_weight B11 also writes them in x's dtype. The column
    quantizes of the norm (B8) and of the activation (B9-col) take the
    forward's column maxima as scales. ``views`` is the three weights' row
    views, row scales, column views and column scales (``_flat_views``
    without the masters)."""

    @staticmethod
    def forward(ctx, config, eps, key, x2d, gamma, wg, wu, wd, *views):
        row_qs, row_ss = views[:3], views[3:6]
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        h_q, h_s, *h_camax = fp.rmsnorm_quant_rowwise(
            x2d, gamma, norm_eps=eps, sr=sr, key=_sub(key, 0) if sr else None, with_col_amax=gw8)
        h_camax = _named_amax("mlp_norm_amax", h_camax)
        h_s = h_s.to(x2d.dtype)
        outs = []
        for i, w in enumerate((wg, wu)):
            w_row, w_row_s = _row_view(w, row_qs[i], row_ss[i], sr, fold_in(_sub(key, 1), i) if sr else None)
            outs.append(scaled_mm_general(h_q, w_row, h_s, w_row_s, dims=(1, 1), out_dtype=x2d.dtype))
        gate, up = outs
        if remat.skips():  # the replay of the layer's last op: gate and up for the node, no down
            act_camax = [remat.load("mlp_silu_amax")] if gw8 else []
            out = remat.unread_like(x2d, (x2d.shape[0], wd.shape[-2]))
        else:
            act_q, act_s, *act_camax = fp.silu_mul_quant_rowwise(
                gate, up, sr=sr, key=_sub(key, 2) if sr else None, with_col_amax=gw8)
            act_camax = _named_amax("mlp_silu_amax", act_camax)
            wd_row, wd_row_s = _row_view(wd, row_qs[2], row_ss[2], sr, _sub(key, 3) if sr else None)
            out = scaled_mm_general(act_q, wd_row, act_s.to(x2d.dtype), wd_row_s, dims=(1, 1),
                                    out_dtype=x2d.dtype)
        ctx.config, ctx.eps, ctx.key = config, eps, key
        ctx.save_for_backward(x2d, gamma, wg, wu, wd, gate, up, *views[6:], *h_camax, *act_camax)
        return out

    @staticmethod
    def backward(ctx, g):
        config, eps, key = ctx.config, ctx.eps, ctx.key
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        x2d, gamma, wg, wu, wd, gate, up, *rest = ctx.saved_tensors
        col_qs, col_ss, camax = rest[:3], rest[3:6], rest[6:]
        g = g.to(x2d.dtype)
        sub = (lambda i: _sub(key, i)) if sr else (lambda i: None)
        # the down projection
        kg, kw = split(_sub(key, 4)) if sr else (None, None)
        dact, g_col, g_col_s = _grad_pair(g, wd, sr, gw8, kg, kw, col_qs[2], col_ss[2])
        if gw8:
            h_camax, act_camax = max_over_each(camax, "tokens")
            act_col, act_col_s = fp.silu_mul_quant_colwise(gate, up, sr=sr, key=sub(5),
                                                           scale=act_camax * (1.0 / 127.0))
            wd_grad = scaled_mm_general(g_col, act_col, g_col_s, act_col_s.to(wd.dtype), dims=(0, 0),
                                        out_dtype=wd.dtype)
            # (dgate, dup) in fp32, quantized along both axes in-kernel
            da_q, da_s, db_q, db_s, da_camax, db_camax = fp.silu_mul_bwd_quant_rowwise(
                gate, up, dact, sr=sr, key=sub(6))
            da_camax, db_camax = max_over_each([da_camax, db_camax], "tokens")
            cols = fp.silu_mul_bwd_quant_colwise(gate, up, dact, da_camax * (1.0 / 127.0),
                                                 db_camax * (1.0 / 127.0), sr=sr, key=sub(7))
            col_s = [(m * (1.0 / 127.0)).to(wg.dtype) for m in (da_camax, db_camax)]
            h_col, h_col_s = fp.rmsnorm_quant_colwise(x2d, gamma, norm_eps=eps, sr=sr, key=sub(8),
                                                      scale=h_camax * (1.0 / 127.0))
            h_col_s = h_col_s.to(x2d.dtype)
        else:
            wd_grad = _bf16_wgrad(g, fp.silu_mul_ref(gate, up))
            # the row int8 of (dgate, dup) and their copies for the bf16 wgrads
            da_q, da_s, db_q, db_s, da_c, db_c = fp.silu_mul_bwd_quant_rowwise(
                gate, up, dact, sr=sr, key=sub(6), with_amax=False, with_bf16=True)
            h = fp.rms_norm_ref(x2d, gamma, eps)
        dh, grads_w = None, []
        for i, (w, (v_row, v_row_s)) in enumerate(zip((wg, wu), ((da_q, da_s), (db_q, db_s)))):
            w_col, w_col_s = _col_view(w, col_qs[i], col_ss[i], sr, fold_in(_sub(key, 9), i) if sr else None)
            di = scaled_mm_general(v_row, w_col, v_row_s.to(w.dtype), w_col_s, dims=(1, 0), out_dtype=w.dtype)
            dh = di if dh is None else dh + di
            if gw8:
                grads_w.append(scaled_mm_general(cols[i], h_col, col_s[i], h_col_s, dims=(0, 0), out_dtype=w.dtype))
            else:
                grads_w.append(_bf16_wgrad((da_c, db_c)[i], h))
        dx, dgamma = _rmsnorm_bwd(x2d, gamma, dh, eps)
        return None, None, None, dx, dgamma, grads_w[0], grads_w[1], wd_grad, *(None,) * 12


def mlp_linear(x, gamma, wg, wu, wd, eps: float, *, key: int | None = None):
    """The Llama MLP, (silu(norm(x) @ wg^T) * (norm(x) @ wu^T)) @ wd^T (JAX
    :675-714): one op (:class:`_MLPMM`) when the three weights are
    MixedPrecisionWeights of one fusable config and the kernels take the
    shapes (``_fused_ok`` at [M, D] and at [M, F] with three inputs); else
    :func:`norm_linear_multi` for gate/up with ``fold_in(key, 0)`` and
    :func:`silu_mul_linear` for down with ``fold_in(key, 1)``, the JAX
    package's two-op branch. PreQuantMPWeights fuse on their views."""
    ws = (wg, wu, wd)
    cfg = _one_fusable_config(ws)
    fused = cfg is not None
    if fused:
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        M, D = x2d.shape
        fused = _fused_ok(M, D, x2d) and _fused_ok(M, wg.shape[-2], x2d, n_inputs=3)
    if not fused:
        key = 0 if key is None else key
        with remat.read():  # gate and up: the down node's (or silu's) saved inputs
            gate, up = norm_linear_multi(x, gamma, [wg, wu], eps, key=fold_in(key, 0))
        return silu_mul_linear(gate, up, wd, key=fold_in(key, 1))
    out = _MLPMM.apply(cfg, float(eps), _resolve_key(cfg, key), x2d, gamma, *_flat_views(ws))
    return out.reshape(*x.shape[:-1], wd.shape[-2])


def _group_cotangent(dctx2d, B: int, S: int, kv: int, hd: int):
    """[B * S, H * hd] cotangent -> grouped [B, KV, G, S, hd], no rotation
    (JAX :727-737)."""
    return rope.rope_group_kernel(dctx2d.view(B, S, -1, hd), kv=kv)


def _ungroup_bf16(out_g):
    """[B, KV, G, S, hd] -> [B * S, H * hd] in out_g's dtype, no rotation:
    the bf16 grad_weight's operand (JAX :783-799)."""
    B, KV, G, S, hd = out_g.shape
    return rope.rope_ungroup_kernel(out_g).view(B * S, KV * G * hd)


class _AttnOutMM(torch.autograd.Function):
    """Grouped attention output [B, KV, G, S, hd] @ w^T -> [B * S, out] (JAX
    ``_attn_out_mm``, :740-841): the ungrouping runs inside the int8
    quantizes (B14), so the o-projection's [B * S, H * hd] input never exists
    in bf16, and the backward's column quantize takes the forward's column
    absmax as its scales (one read of the grouped output)."""

    @staticmethod
    def forward(ctx, config, key, out_g, w, rq, rs, cq, cs):
        B, KV, G, S, hd = out_g.shape
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        if remat.skips():  # the replay of the post-attention residual given: only the node
            col_amax = [remat.load("attn_out_amax")] if gw8 else []
            out = remat.unread_like(out_g, (B * S, w.shape[-2]), w.dtype)
        else:
            row_amax, col_amax = rope.ungroup_amax(out_g)
            # the column absmax is the backward's column scale: an int8 grad_weight only
            col_amax = _named_amax("attn_out_amax", [col_amax] if gw8 else [])
            row_s = row_amax * (1.0 / 127.0)
            x_row = rope.ungroup_quant(out_g, row_s, axis=1, sr=sr, key=_sub(key, 0) if sr else None)
            w_row, w_row_s = _row_view(w, rq, rs, sr, _sub(key, 1) if sr else None)
            out = scaled_mm_general(x_row.view(B * S, -1), w_row, row_s.view(B * S, 1).to(w.dtype), w_row_s,
                                    dims=(1, 1), out_dtype=w.dtype)
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(out_g, w, cq, cs, *col_amax)
        return out

    @staticmethod
    def backward(ctx, g):
        config, key = ctx.config, ctx.key
        sr, gw8 = config.stochastic_rounding, config.grad_weight
        out_g, w, cq, cs, *col_amax = ctx.saved_tensors
        B, KV, G, S, hd = out_g.shape
        g = g.to(w.dtype)
        kg, kw = split(_sub(key, 3)) if sr else (None, None)
        dctx, g_col, g_col_s = _grad_pair(g, w, sr, gw8, kg, kw, cq, cs)
        d_out_g = _group_cotangent(dctx, B, S, KV, hd)
        if gw8:
            col_s = max_over_each(col_amax, "tokens")[0] * (1.0 / 127.0)
            x_col = rope.ungroup_quant(out_g, col_s, axis=0, sr=sr, key=_sub(key, 2) if sr else None)
            grad_w = scaled_mm_general(g_col, x_col.view(B * S, -1), g_col_s, col_s.to(w.dtype), dims=(0, 0),
                                       out_dtype=w.dtype)
        else:
            grad_w = _bf16_wgrad(g, _ungroup_bf16(out_g))
        return None, None, d_out_g, grad_w, None, None, None, None


def attn_out_linear(out_g, w, kv: int, *, key: int | None = None):
    """Grouped attention output [B, KV, G, S, hd] -> o-projection output
    [B, S, out_features] (JAX :844-874): :class:`_AttnOutMM` for a
    MixedPrecisionWeight of a fusable config (or a PreQuantMPWeight, on its
    views) where the kernels take the shapes ((H * hd) % 128, (B * S) %
    256, ``_supported_heads``, ``_fused_ok``); else exactly
    ``ungroup_heads`` followed by ``qlinear``."""
    B, KV, G, S, hd = out_g.shape
    H = KV * G
    fused = (_one_fusable_config([w]) is not None and (H * hd) % 128 == 0
             and (B * S) % 256 == 0 and rope._supported_heads(H, G, hd, S) and _fused_ok(B * S, H * hd, out_g))
    if not fused:
        with remat.read():  # the linear's saved input
            ctx = rope.ungroup_heads(out_g, kv).reshape(B, S, H * hd)
        return qlinear(ctx, w, key=key)
    out = _AttnOutMM.apply(w.config, _resolve_key(w.config, key), out_g, *_w_views(w))
    return out.view(B, S, w.shape[-2])


# ---- the ViT producers: LayerNorm -> linear, GELU -> linear (JAX :877-1099) ----------


def _layernorm_bwd_math(x2d, g, b, dy, eps: float):
    """(dx, dg, db) of LayerNorm in fp32, each in its input's dtype (JAX
    :882-898, which XLA runs: there is no Pallas LayerNorm backward)."""
    xf, dyf, gf = x2d.float(), dy.float(), g.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = dyf * gf
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True) - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x2d.dtype), (dyf * xhat).sum(dim=0).to(g.dtype), dyf.sum(dim=0).to(b.dtype)


def _producer_mm(config, key, quant_rows, x2d, w):
    """The forward of ``_ln_mm`` / ``_gelu_mm`` (JAX :901-921, :1001-1021):
    the producer's row int8 from ``quant_rows`` (with its column absmax for
    an int8 grad_weight, else None), times w's row int8; the row scales in
    x2d's dtype."""
    sr, gw8 = config.stochastic_rounding, config.grad_weight
    unread = remat.unread_like(x2d, (x2d.shape[0], w.shape[-2])) if remat.skips() else None
    if unread is not None and not gw8:
        return unread, None
    y_row, y_row_s, *col_amax = quant_rows(sr=sr, key=_sub(key, 0) if sr else None, with_col_amax=gw8)
    if unread is not None:  # the replay of fc2 (no policy): the kernel for its column maxima, no product
        return unread, col_amax[0]
    w_row, w_row_s = quantize_int8(w, axis=1, stochastic_rounding=sr, key=_sub(key, 1) if sr else None)
    out = scaled_mm_general(y_row, w_row, y_row_s.to(x2d.dtype), w_row_s, dims=(1, 1), out_dtype=x2d.dtype)
    return out, (col_amax[0] if col_amax else None)


def _producer_mm_bwd(config, key, g, w, x2d, quant_cols, col_amax, bf16_operand):
    """(dy, grad_w) of ``_ln_mm`` / ``_gelu_mm`` (JAX :934-970,
    :1034-1066): the (g, w) pair from ``split(_sub(key, 3))``; with an int8
    grad_weight the producer's column int8 from ``quant_cols`` with the
    forward's column absmax as its scales (``_sub(key, 2)``), else the bf16
    grad_weight against ``bf16_operand()``, the composite's producer."""
    sr, gw8 = config.stochastic_rounding, config.grad_weight
    g = g.to(x2d.dtype)
    kg, kw = split(_sub(key, 3)) if sr else (None, None)
    dy, g_col, g_col_s = _grad_pair(g, w, sr, gw8, kg, kw)
    if gw8:
        y_col, y_col_s = quant_cols(sr=sr, key=_sub(key, 2) if sr else None, scale=col_amax * (1.0 / 127.0))
        grad_w = scaled_mm_general(g_col, y_col, g_col_s, y_col_s.to(x2d.dtype), dims=(0, 0), out_dtype=w.dtype)
    else:
        grad_w = _bf16_wgrad(g, bf16_operand())
    return dy, grad_w


class _LNMM(torch.autograd.Function):
    """layer_norm(x2d, g, b) @ w^T with the norm inside the input's row
    quantize (JAX ``_ln_mm``, :901-973): B18's LayerNorm row form, with its
    column absmax for an int8 grad_weight, which the backward's column form
    takes as its scales (one read of x); the LayerNorm backward is
    :func:`_layernorm_bwd_math`."""

    @staticmethod
    def forward(ctx, config, eps, key, x2d, g, b, w):
        rows = lambda **kw: fp.layernorm_quant_rowwise(x2d, g, b, norm_eps=eps, **kw)
        out, col_amax = _producer_mm(config, key, rows, x2d, w)
        ctx.config, ctx.eps, ctx.key = config, eps, key
        ctx.save_for_backward(x2d, g, b, w, *(() if col_amax is None else (col_amax,)))
        return out

    @staticmethod
    def backward(ctx, gout):
        config, eps, key = ctx.config, ctx.eps, ctx.key
        x2d, g, b, w, *col_amax = ctx.saved_tensors
        cols = lambda **kw: fp.layernorm_quant_colwise(x2d, g, b, norm_eps=eps, **kw)
        dy, grad_w = _producer_mm_bwd(config, key, gout, w, x2d, cols, col_amax[0] if col_amax else None,
                                      lambda: fp.layer_norm_ref(x2d, g, b, eps))
        return (None, None, None, *_layernorm_bwd_math(x2d, g, b, dy, eps), grad_w)


class _GeluMM(torch.autograd.Function):
    """gelu(a2d) @ w^T (tanh form) with the activation inside the input's
    row quantize (JAX ``_gelu_mm``, :1001-1075); the backward's column
    quantize is B18's GELU column form with the forward's scales, and da is
    the fp32 derivative of the tanh form (:1068-1071)."""

    @staticmethod
    def forward(ctx, config, key, a2d, w):
        rows = lambda **kw: fp.gelu_quant_rowwise(a2d, **kw)
        out, col_amax = _producer_mm(config, key, rows, a2d, w)
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(a2d, w, *(() if col_amax is None else (col_amax,)))
        return out

    @staticmethod
    def backward(ctx, gout):
        config, key = ctx.config, ctx.key
        a2d, w, *col_amax = ctx.saved_tensors
        cols = lambda **kw: fp.gelu_quant_colwise(a2d, **kw)
        dy, grad_w = _producer_mm_bwd(config, key, gout, w, a2d, cols, col_amax[0] if col_amax else None,
                                      lambda: F.gelu(a2d, approximate="tanh"))
        return None, None, fp.gelu_bwd_f32(a2d, dy).to(a2d.dtype), grad_w


def _padded_2d(x):
    """x [..., K] as [M, K] rows padded as the JAX package pads them
    (``_pad_tokens``: zeros up to a multiple of 256 from 1024 rows on), and
    M."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    return _pad_tokens(x2d), x2d.shape[0]


def layernorm_linear(x, g, b, w, eps: float, *, bias=None, key: int | None = None):
    """layer_norm(x, g, b) @ w^T + bias (JAX :976-998): :class:`_LNMM` on
    the padded rows for a MixedPrecisionWeight of a fusable config where the
    kernels take the padded shape, the output cut back to the tokens, then
    the bias in the activation dtype; else exactly ``layer_norm_ref``
    followed by ``qlinear``."""
    fused = isinstance(w, MixedPrecisionWeight) and _fusable_cfg(w.config)
    if fused:
        x2d, M = _padded_2d(x)
        fused = _fused_ok(*x2d.shape, x2d)
    if not fused:
        return qlinear(fp.layer_norm_ref(x, g, b, eps), w, bias, key=key)
    out = _LNMM.apply(w.config, float(eps), _resolve_key(w.config, key), x2d, g, b, w.data)
    out = out[:M].reshape(*x.shape[:-1], w.shape[-2])
    return out if bias is None else out + bias


def gelu_linear(a, w, *, bias=None, key: int | None = None):
    """gelu(a) @ w^T + bias, GELU's tanh form (JAX :1078-1099), as
    :func:`layernorm_linear`: :class:`_GeluMM` on the padded rows, else
    exactly ``F.gelu(a, approximate="tanh")`` followed by ``qlinear`` (the
    JAX fallback's ``jax.nn.gelu`` defaults to the tanh form)."""
    fused = isinstance(w, MixedPrecisionWeight) and _fusable_cfg(w.config)
    if fused:
        a2d, M = _padded_2d(a)
        fused = _fused_ok(*a2d.shape, a2d)
    if not fused:
        return qlinear(F.gelu(a, approximate="tanh"), w, bias, key=key)
    out = _GeluMM.apply(w.config, _resolve_key(w.config, key), a2d, w.data)
    out = out[:M].reshape(*a.shape[:-1], w.shape[-2])
    return out if bias is None else out + bias
