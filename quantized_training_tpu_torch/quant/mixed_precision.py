"""Mixed-precision linear (int8, int4 or fp8), forward and backward.

Counterpart of ``quantized_training_tpu/quant/mixed_precision.py`` (:30-322):
``MixedPrecisionWeight``, ``_dynamic_int8_mm``, ``_dynamic_int4_mm``,
``_dynamic_fp8_mm``, ``_dynamic_mm``, ``_mp_linear`` and
``_mp_linear_shared`` with their backwards (``torch.autograd.Function`` in
place of ``jax.custom_vjp``), ``linear`` and ``linear_shared``. The forward,
grad_input and grad_weight matmuls are each quantized or plain, per
``MixedPrecisionConfig``; each quantized matmul quantizes both operands
along its contraction axis, so the scales stay off the reduction dim.

int8 (no operand is transposed in memory):

- forward x . w^T, dims (1, 1): K1 twice, K2;
- grad_input g . w, dims (1, 0): g row-wise, w column-wise (B4), B1;
- grad_weight g^T . x over the tokens, dims (0, 0): g and x column-wise,
  B2. With both backward matmuls int8, g is quantized along both axes by
  B5 (two reads of g).

int4 and fp8 (``config.scale`` 'row' or 'tile') follow the JAX package's
``_dynamic_mm`` (:119-134), transposes included: they ignore
``stochastic_rounding``, as the JAX package does.

- int4: both operands in the standard [M, K] . [K, N] form, so ``w^T`` for
  grad_input and ``g^T`` and ``x^T`` for grad_weight are materialized in
  bf16 (JAX :129-130, :82; the forward's b^T is w itself); each row-wise
  int4 quantize is plain torch, the GEMM is B16 (``ops/int4_mm.py``).
- fp8 'row': absmax e4m3 along each contraction axis, no transpose, and the
  fp32 product of plain torch (``ops/fp8.py``), as the JAX package's XLA
  dot.
- fp8 'tile': DeepSeek-V3's 1 x 128 groups of the A operand and 128 x 128
  blocks of the B operand, in the standard form (the bf16 inputs
  transposed first, JAX :108-109), the GEMM B15
  (``ops/tile_scaled_mm.py``); a matmul whose K or N is not a multiple of
  128 falls back to 'row' (JAX :107).

Stochastic rounding draws from a key (an int, ``ops/random.py``), derived
where the JAX package derives its keys: ``fold_in(key, 0/1/2/3)`` per use
(``_subkey``), a ``split`` per pair of operands. The autograd Functions
keep the key in ``ctx``, so a checkpointed layer replayed with the same key
rounds the same way, and no two quantizes of one call share a stream.

Under a mesh every quantize names the axis it reduces (``over``,
``quant/core.py``): the grad_weight operands' token axis ``"tokens"`` (B5's
columns of g, B4 of x2d, the int4 and fp8 'row' quantizes of the
grad_weight matmul), the forward's contraction axis ``"features"`` (K1 of
x2d and of w, which tensor parallelism splits in a row-parallel linear).
grad_input's operands reduce the output features, which no mesh splits
here; a row-parallel linear sums its partial products over the features'
mesh axis (``_mp_forward``: int8's int32 sums before the scales, the
others' fp32 partials, then one rounding, as JAX's partitioned program).
fp8 'tile' takes the tile path only where the rank's token count is a
multiple of 128, so each 1 x 128 group of tokens, and each 128 x 128 block,
lies inside one rank's rows, whose offset is a multiple of that count: its
maxima need no all-reduce.

``PreQuantMPWeight`` (JAX :385-663) holds a weight's int8 views computed
once a step (:func:`prequantize_weight`, ``quant/api.py::prequantize_step``):
the row view (the forward's operand) and the column view (grad_input's), by
one B5 a layer's weight in mode 'both', K1 in 'row', B4 in 'col'; an unused
view is a 0-sized placeholder, and the linear quantizes the weight in the
op for it. ``_MPLinearPQ`` and ``_MPLinearSharedPQ`` are ``_mp_linear_pq``
and ``_mp_linear_shared_pq`` with their backwards. The views are made from
the detached master and take no grad: the weight's grad reaches the master
through ``orig`` alone (JAX :484-488). As
the JAX package does, :func:`linear` and :func:`linear_shared` pad the
token dim with zero rows to a multiple of 256 from 1024 tokens on
(``_pad_tokens``) and cut the output back: a zero row changes no scale and
no sum, and the grad_weight GEMM, which contracts over the tokens, needs a
multiple of 16 on the card (ViT-Giant's 24 x 257 = 6,168 tokens are not),
as the fp8 'tile' configs need a multiple of 128.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.fp8 import quantize_fp8, quantize_fp8_block, quantize_fp8_tile
from ..ops.int4_mm import scaled_int4_mm
from ..ops import remat
from ..ops.random import fold_in, split
from ..ops.scaled_mm import scaled_mm, scaled_mm_general
from .configs import MixedPrecisionConfig
from .core import (_span, matmul_over, max_over, quantize_int4_rowwise_absmax, quantize_int8, quantize_int8_both,
                   scaled_mm_over, sum_over)
from .node import WeightNode


@dataclass
class MixedPrecisionWeight(WeightNode):
    """bf16 master weight + static per-matmul quantization config.

    ``data`` is [out, in], or [L, out, in] when stacked over layers;
    indexing a stacked weight gives the wrapped per-layer slice."""

    data: torch.Tensor
    config: MixedPrecisionConfig
    data_fields = ("data",)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape


def _all_int8(config: MixedPrecisionConfig) -> bool:
    return config.dtype == "int8" and config.output and config.grad_input and config.grad_weight


def _subkey(key: int, i: int) -> int:
    return fold_in(key, i)


# the axis a matmul of these dims contracts, as ``over`` names it: the
# forward's features (x . w^T) and grad_weight's tokens (g^T . x)
_CONTRACTED = {(1, 1): "features", (0, 0): "tokens"}


def _summed(dims):
    """The axis over which a product of these dims sums its partials where a
    mesh splits it: the forward's features (a row-parallel linear under
    tensor parallelism). grad_weight's tokens are summed by the step's
    gradient reduction, not here."""
    return "features" if tuple(dims) == (1, 1) else None


def _dynamic_int8_mm(a, b, sr: bool, key: int | None, dims=(1, 0)):
    """Contract a over dims[0] and b over dims[1], both dynamically
    quantized to INT8 along their contraction axis, each operand from its
    own half of ``split(key)`` under SR (JAX :72-75)."""
    ka, kb = split(key) if sr else (None, None)
    over = _CONTRACTED.get(tuple(dims))
    a_i8, sa = quantize_int8(a, axis=dims[0], stochastic_rounding=sr, key=ka, over=over)
    b_i8, sb = quantize_int8(b, axis=dims[1], stochastic_rounding=sr, key=kb, over=over)
    return scaled_mm_over(a_i8, b_i8, sa, sb, dims=dims, out_dtype=a.dtype, over=_summed(dims))


def _dynamic_int4_mm(a, b, over=None, out_dtype=None):
    """a [M, K] . b [K, N], both quantized row-wise to packed int4 along K
    (b as b^T, made contiguous), then B16 (JAX :79-83). No SR."""
    a_i4, row_scale = quantize_int4_rowwise_absmax(a.contiguous(), over)
    b_t_i4, col_scale = quantize_int4_rowwise_absmax(b.T.contiguous(), over)
    return scaled_int4_mm(a_i4, b_t_i4, row_scale, col_scale, out_dtype=out_dtype or a.dtype)


def _fp8_rows(x, axis: int, over):
    """``quantize_fp8`` along ``axis`` with its maxima all-reduced where a
    mesh splits ``over``."""
    amax = x.abs().amax(dim=axis, keepdim=True).float()
    return quantize_fp8(x, axis=axis, amax=max_over(amax, over))


def _dynamic_fp8_mm(a, b, scale_mode: str, dims, out_dtype=None):
    """Dynamic e4m3 matmul, row- or tile-scaled (JAX :86-116): 'tile' with
    K and N multiples of 128 takes the standard operands (transposed first
    where dims ask), a's 1 x 128 groups and b's 128 x 128 blocks, and B15;
    otherwise both operands row-scaled along their contraction axes, as
    stored."""
    K, N = a.shape[dims[0]], b.shape[1 - dims[1]]
    out_dtype = out_dtype or a.dtype
    if scale_mode == "tile" and K % 128 == 0 and N % 128 == 0:
        a_std = a if dims[0] == 1 else a.T
        b_std = b if dims[1] == 0 else b.T
        a_q, a_s = quantize_fp8_tile(a_std.contiguous())
        b_q, b_s = quantize_fp8_block(b_std.contiguous())
        return scaled_mm(a_q, b_q, a_s, b_s, out_dtype=out_dtype)
    over = _CONTRACTED.get(tuple(dims))
    a_q, a_s = _fp8_rows(a, dims[0], over)
    b_q, b_s = _fp8_rows(b, dims[1], over)
    return scaled_mm_general(a_q, b_q, a_s, b_s, dims=dims, out_dtype=out_dtype)


def _dynamic_mm(a, b, config: MixedPrecisionConfig, key: int | None, dims=(1, 0), out_dtype=None):
    """One quantized matmul of the config's dtype (JAX :119-134), its output
    in a's dtype unless ``out_dtype`` (int4 and fp8) says otherwise."""
    if config.dtype == "int8":
        return _dynamic_int8_mm(a, b, config.stochastic_rounding, key, dims)
    if config.dtype == "int4":
        a = a if dims[0] == 1 else a.T
        b = b if dims[1] == 0 else b.T
        return _dynamic_int4_mm(a, b, _CONTRACTED.get(tuple(dims)), out_dtype)
    if config.dtype == "fp8_e4m3":
        return _dynamic_fp8_mm(a, b, config.scale, dims, out_dtype)
    raise ValueError(f"unsupported mixed-precision dtype {config.dtype!r}")


def _mp_forward(config: MixedPrecisionConfig, x2d, w, key: int):
    """x2d [B, in] @ w.T [in, out]; w is [out, in]. Where tensor
    parallelism splits the features, the partial products are summed over
    the mesh axis: int8's int32 sums before the scales, bf16's, int4's and
    fp8's in fp32, each rounded once."""
    if not config.output:
        return matmul_over(x2d, w, "features")
    if config.dtype == "int8" or _span("features") is None:
        return _dynamic_mm(x2d, w, config, _subkey(key, 0), dims=(1, 1))
    out = _dynamic_mm(x2d, w, config, _subkey(key, 0), dims=(1, 1), out_dtype=torch.float32)
    return sum_over(out, "features").to(x2d.dtype)


def _grads_both_int8(g, w, x_col, x_col_s, sr, kg, kw):
    """(grad_input, grad_weight) of one weight with both backward matmuls
    int8, given the column quantize of its input: g along both axes (B5,
    key ``kg``), w column-wise (B4, key ``kw``), then B1 and B2 (JAX
    :184-198)."""
    g_row, g_row_s, g_col, g_col_s = quantize_int8_both(g, stochastic_rounding=sr, key=kg, cols_over="tokens")
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
        # the replay of an unread output (remat): the node only
        out = remat.unread_like(x2d, (x2d.shape[0], w.shape[0])) if remat.skips() else _mp_forward(config, x2d, w, key)
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(x2d, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        config, key = ctx.config, ctx.key
        sr = config.stochastic_rounding
        g = g.to(w.dtype)
        if config.grad_input and config.grad_weight and config.dtype == "int8":
            kg, kw, kx = split(_subkey(key, 1), 3) if sr else (None,) * 3
            x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx, over="tokens")
            grad_input, grad_weight = _grads_both_int8(g, w, x_col, x_col_s, sr, kg, kw)
            return grad_input, grad_weight, None, None
        if config.grad_input:
            grad_input = _dynamic_mm(g, w, config, _subkey(key, 1), dims=(1, 0))
        else:
            grad_input = g @ w
        if config.grad_weight:
            grad_weight = _dynamic_mm(g, x2d, config, _subkey(key, 2), dims=(0, 0))
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
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(x2d, *ws)
        if remat.skips():  # the replay of unread outputs (remat): the node only
            return tuple(remat.unread_like(x2d, (x2d.shape[0], w.shape[0])) for w in ws)
        sr = config.stochastic_rounding
        kx = _subkey(key, 0) if sr else None
        x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=kx, over="features")
        outs = []
        for i, w in enumerate(ws):
            kw = fold_in(_subkey(key, 1), i) if sr else None
            w_row, w_row_s = quantize_int8(w, axis=1, stochastic_rounding=sr, key=kw, over="features")
            outs.append(scaled_mm_general(x_row, w_row, x_row_s, w_row_s, dims=(1, 1),
                                          out_dtype=x2d.dtype))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        x2d, *ws = ctx.saved_tensors
        sr, key = ctx.config.stochastic_rounding, ctx.key
        kx = fold_in(_subkey(key, 2), 0) if sr else None
        x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx, over="tokens")
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


def _pad_tokens(x2d):
    """The JAX package's ``_pad_tokens`` (:325-338): zero rows up to a
    multiple of 256 from 1024 tokens on."""
    M = x2d.shape[0]
    Mp = -(-M // 256) * 256
    if Mp == M or M < 1024:
        return x2d
    return torch.nn.functional.pad(x2d, (0, 0, 0, Mp - M))


def linear(x, w, bias=None, *, key: int | None = None):
    """Mixed-precision linear: y = x @ w.T + bias with per-matmul quant, for
    a :class:`MixedPrecisionWeight` or a :class:`PreQuantMPWeight` (JAX
    :341-376)."""
    key = _resolve_key(w.config, key)
    x2d = x.reshape(-1, x.shape[-1])
    M = x2d.shape[0]
    if isinstance(w, PreQuantMPWeight):
        out = _MPLinearPQ.apply(_pad_tokens(x2d), w.orig, w.row_q, w.row_s, w.col_q, w.col_s, w.config, key)
    else:
        out = _MPLinear.apply(_pad_tokens(x2d), w.data, w.config, key)
    out = out[:M].reshape(*x.shape[:-1], w.shape[-2])
    return out + bias if bias is not None else out


def linear_shared(x, weights, *, key: int | None = None):
    """[y_i = x @ w_i.T] with the shared input quantized once (JAX
    :279-322). ``weights``: MixedPrecisionWeights, or PreQuantMPWeights,
    with one all-int8 config; any other mix takes one :func:`linear` per
    weight, each with ``key`` itself (JAX :293-296)."""
    configs = {w.config for w in weights}
    cfg = next(iter(configs))
    preq = all(isinstance(w, PreQuantMPWeight) for w in weights)
    if len(configs) != 1 or not _all_int8(cfg) or not (
            preq or all(isinstance(w, MixedPrecisionWeight) for w in weights)):
        return [linear(x, w, key=key) for w in weights]
    key = _resolve_key(cfg, key)
    x2d = _pad_tokens(x.reshape(-1, x.shape[-1]))
    M = x.numel() // x.shape[-1]
    if preq:
        views = [getattr(w, f) for f in PreQuantMPWeight.data_fields for w in weights]
        outs = _MPLinearSharedPQ.apply(cfg, key, len(weights), x2d, *views)
    else:
        outs = _MPLinearShared.apply(cfg, key, x2d, *(w.data for w in weights))
    return [o[:M].reshape(*x.shape[:-1], w.shape[-2]) for o, w in zip(outs, weights)]


# ---- per-step weight pre-quantization (JAX :379-663) ------------------------
#
# A weight is constant within a step, yet the dynamic linears quantize it per
# matmul: along rows in the forward (again in the remat replay) and along
# columns in the backward. Its views made once a step take those quantizes
# out of the layers; the int8 they hold is the dynamic path's, bit for bit,
# under round-to-nearest. Under SR the draw is once a step, not once a
# matmul: still unbiased, but another stream.


@dataclass
class PreQuantMPWeight(WeightNode):
    """Step-scoped int8 views of a mixed-precision weight (JAX :398-421).

    ``orig``: the master [*, out, in], the gradient target; ``row_q`` /
    ``row_s``: int8 along ``in`` (the forward's operand) with its scales
    [*, out, 1]; ``col_q`` / ``col_s``: int8 along ``out`` (grad_input's)
    with its scales [*, 1, in]. An unused view and its scales are [*, 0, 0]
    placeholders."""

    orig: torch.Tensor
    row_q: torch.Tensor
    row_s: torch.Tensor
    col_q: torch.Tensor
    col_s: torch.Tensor
    config: MixedPrecisionConfig
    data_fields = ("orig", "row_q", "row_s", "col_q", "col_s")

    @property
    def dtype(self):
        return self.orig.dtype

    @property
    def shape(self):
        return self.orig.shape


def _placeholder(w):
    """A 0-sized view and its scales (JAX ``_placeholder``, :424-427)."""
    lead = tuple(w.shape[:-2]) + (0, 0)
    return w.new_zeros(lead, dtype=torch.int8), w.new_zeros(lead)


def _has(view) -> bool:
    return view is not None and view.numel() > 0


def _quantize_views(w, need_row: bool, need_col: bool, sr: bool, key: int | None, shard=None):
    """(row_q, row_s, col_q, col_s) of one 2-D weight: B5 for both views,
    else K1 or B4, a placeholder for the other (JAX :430-478). ``shard``:
    (axis, span) where this is a rank's shard of the weight, split on
    ``axis`` (0: its rows, 1: its columns) over the span's mesh axis; the
    quantize that reduces the split axis then takes the global maxima (its
    mesh forms), the other stays local, and under SR the two draw from the
    halves of ``split(key)``, as B5's do."""
    axis, span = shard if shard is not None else (None, None)
    if need_row and need_col and axis != 1:
        return quantize_int8_both(w, stochastic_rounding=sr, key=key, cols_over=span)
    if need_row and need_col:
        kr, kc = split(key) if sr else (None, None)
        return (*quantize_int8(w, axis=-1, stochastic_rounding=sr, key=kr, over=span),
                *quantize_int8(w, axis=0, stochastic_rounding=sr, key=kc))
    if need_row:
        return (*quantize_int8(w, axis=-1, stochastic_rounding=sr, key=key, over=span if axis == 1 else None),
                *_placeholder(w))
    return (*_placeholder(w), *quantize_int8(w, axis=0, stochastic_rounding=sr, key=key,
                                             over=span if axis == 0 else None))


@torch.no_grad()
def _prequant(w, need_row: bool, need_col: bool, sr: bool, key: int, shard=None):
    """The views of w [out, in], or of a stacked [L, out, in] layer by
    layer, layer l with ``fold_in(key, l)`` under SR, as JAX's ``vmap``
    (:455-468): B5's column scales are per layer, so the layers never share
    a launch. ``shard``: (the split dim of w, span) for a rank's shard
    (:func:`_quantize_views`)."""
    w = w.detach()
    if shard is not None:
        shard = (shard[0] - (w.ndim - 2), shard[1])  # the split dim of each layer's matrix
    if w.ndim == 2:
        return _quantize_views(w, need_row, need_col, sr, key if sr else None, shard)
    per_layer = [_quantize_views(wl, need_row, need_col, sr, fold_in(key, l) if sr else None, shard)
                 for l, wl in enumerate(w.unbind(0))]
    return tuple(torch.stack(parts) for parts in zip(*per_layer))


def prequantize_weight(w: MixedPrecisionWeight, key: int | None = None, mode: str = "both", shard=None):
    """MixedPrecisionWeight -> PreQuantMPWeight (JAX :490-515). ``mode``
    'both' | 'row' | 'col' picks the views made; the linear quantizes in the
    op for a missing one. A config the pre-quantized linear does not cover
    (not int8, or neither the forward nor grad_input quantized) returns
    ``w`` unchanged. ``orig`` is ``w.data`` itself, so the grads of the
    linears reach the master. ``shard``: (the dim of ``w.data`` split over
    a mesh axis, (mesh, axis)) where ``w`` is a rank's shard, whose views
    are then its shards of the global weight's views, bit for bit at
    round-to-nearest (under SR each rank folds its index on that axis into
    the key, so that its shard draws its own noise)."""
    cfg = w.config
    if cfg.dtype != "int8":
        return w
    need_row = cfg.output and mode in ("both", "row")
    need_col = cfg.grad_input and mode in ("both", "col")
    if not (need_row or need_col):
        return w
    key = _resolve_key(cfg, key)
    if shard is not None and cfg.stochastic_rounding:
        mesh, axis = shard[1]
        key = fold_in(key, mesh.coords[axis])
    return PreQuantMPWeight(w.data, *_prequant(w.data, need_row, need_col, cfg.stochastic_rounding, key, shard),
                            cfg)


def _row_view(w, rq, rs, sr: bool, key: int | None):
    """The forward's row int8 of w: the precomputed view, or K1 in the op."""
    if _has(rq):
        return rq, rs
    return quantize_int8(w, axis=1, stochastic_rounding=sr, key=key, over="features")


def _col_view(w, cq, cs, sr: bool, key: int | None):
    """grad_input's column int8 of w: the precomputed view, or B4 in the op."""
    if _has(cq):
        return cq, cs
    return quantize_int8(w, axis=0, stochastic_rounding=sr, key=key)


class _MPLinearPQ(torch.autograd.Function):
    """``_mp_linear_pq`` with its backward (JAX :518-595): x2d [B, in] @
    w^T on the precomputed views; a 0-sized view is quantized in the op,
    the row one from ``_subkey(key, 4)``, the column one from
    ``_subkey(key, 5)``. Under SR x2d's row quantize draws from
    ``_subkey(key, 0)``; the backward's (g, x) pairs from
    ``split(_subkey(key, 1))`` (both backward matmuls int8), else g's row
    quantize from ``_subkey(key, 1)`` and the grad_weight pair from
    ``split(_subkey(key, 2))``."""

    @staticmethod
    def forward(ctx, x2d, w, row_q, row_s, col_q, col_s, config, key):
        sr = config.stochastic_rounding
        if remat.skips():  # the replay of an unread output (remat): the node only
            out = remat.unread_like(x2d, (x2d.shape[0], w.shape[0]))
        elif config.output:
            x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=_subkey(key, 0) if sr else None,
                                           over="features")
            rq, rs = _row_view(w, row_q, row_s, sr, _subkey(key, 4) if sr else None)
            out = scaled_mm_over(x_row, rq, x_row_s, rs, dims=(1, 1), out_dtype=x2d.dtype, over="features")
        else:
            out = matmul_over(x2d, w, "features")
        ctx.config, ctx.key = config, key
        ctx.save_for_backward(x2d, w, col_q, col_s)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, w, col_q, col_s = ctx.saved_tensors
        config, key = ctx.config, ctx.key
        sr = config.stochastic_rounding
        g = g.to(x2d.dtype)
        if config.grad_input:
            col_q, col_s = _col_view(w, col_q, col_s, sr, _subkey(key, 5) if sr else None)
        none = (None,) * 6
        if config.grad_input and config.grad_weight:
            kg, kx = split(_subkey(key, 1)) if sr else (None, None)
            g_row, g_row_s, g_col, g_col_s = quantize_int8_both(g, stochastic_rounding=sr, key=kg, cols_over="tokens")
            x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx, over="tokens")
            grad_input = scaled_mm_general(g_row, col_q, g_row_s, col_s, dims=(1, 0), out_dtype=w.dtype)
            grad_weight = scaled_mm_general(g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype)
            return grad_input, grad_weight, *none
        if config.grad_input:
            g_row, g_row_s = quantize_int8(g, axis=1, stochastic_rounding=sr, key=_subkey(key, 1) if sr else None)
            grad_input = scaled_mm_general(g_row, col_q, g_row_s, col_s, dims=(1, 0), out_dtype=w.dtype)
        else:
            grad_input = g @ w
        if config.grad_weight:
            kg, kx = split(_subkey(key, 2)) if sr else (None, None)
            g_col, g_col_s = quantize_int8(g, axis=0, stochastic_rounding=sr, key=kg, over="tokens")
            x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx, over="tokens")
            grad_weight = scaled_mm_general(g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype)
        else:
            grad_weight = g.T @ x2d
        return grad_input, grad_weight, *none


class _MPLinearSharedPQ(torch.autograd.Function):
    """``_mp_linear_shared_pq`` with its backward (JAX :598-663): one row
    quantize of x2d for every head, each head on its precomputed views (a
    0-sized one quantized in the op, head i's row view from
    ``fold_in(_subkey(key, 4), i)``, its column view from
    ``fold_in(_subkey(key, 5), i)``), and one column quantize of x2d in the
    backward. All-int8 configs only (the caller checks). ``flat`` is the
    n masters, then the n row views, their scales, the n column views and
    their scales. Under SR: x2d's row quantize from ``_subkey(key, 0)``, its
    column quantize from ``fold_in(_subkey(key, 2), 0)``, head i's g from
    ``_subkey(fold_in(_subkey(key, 3), i), 0)``."""

    @staticmethod
    def forward(ctx, config, key, n, x2d, *flat):
        ws, row_qs, row_ss = flat[:n], flat[n:2 * n], flat[2 * n:3 * n]
        ctx.config, ctx.key, ctx.n = config, key, n
        ctx.save_for_backward(x2d, *ws, *flat[3 * n:])
        if remat.skips():  # the replay of unread outputs (remat): the node only
            return tuple(remat.unread_like(x2d, (x2d.shape[0], w.shape[0])) for w in ws)
        sr = config.stochastic_rounding
        x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=_subkey(key, 0) if sr else None,
                                       over="features")
        outs = []
        for i, (w, rq, rs) in enumerate(zip(ws, row_qs, row_ss)):
            rq, rs = _row_view(w, rq, rs, sr, fold_in(_subkey(key, 4), i) if sr else None)
            outs.append(scaled_mm_general(x_row, rq, x_row_s, rs, dims=(1, 1), out_dtype=x2d.dtype))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n, key = ctx.n, ctx.key
        x2d, *rest = ctx.saved_tensors
        ws, col_qs, col_ss = rest[:n], rest[n:2 * n], rest[2 * n:]
        sr = ctx.config.stochastic_rounding
        x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr,
                                       key=fold_in(_subkey(key, 2), 0) if sr else None, over="tokens")
        grad_input, grad_ws = None, []
        for i, (w, cq, cs, g) in enumerate(zip(ws, col_qs, col_ss, gs)):
            cq, cs = _col_view(w, cq, cs, sr, fold_in(_subkey(key, 5), i) if sr else None)
            kg = _subkey(fold_in(_subkey(key, 3), i), 0) if sr else None
            g_row, g_row_s, g_col, g_col_s = quantize_int8_both(g.to(x2d.dtype), stochastic_rounding=sr, key=kg,
                                                                cols_over="tokens")
            gi = scaled_mm_general(g_row, cq, g_row_s, cs, dims=(1, 0), out_dtype=w.dtype)
            grad_input = gi if grad_input is None else grad_input + gi
            grad_ws.append(scaled_mm_general(g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype))
        return None, None, None, grad_input, *grad_ws, *(None,) * (4 * n)
