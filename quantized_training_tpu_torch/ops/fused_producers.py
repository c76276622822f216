"""Producer-fused int8 quantize kernels, the RMSNorm backward and the silu
backward fused into the quantizes of its outputs.

Counterpart of ``quantized_training_tpu/ops/pallas_fused.py`` (:63-760):

- B7 :func:`rmsnorm_quant_rowwise` for ``rmsnorm_quant_rowwise`` (:154);
- B8 :func:`rmsnorm_quant_colwise` for ``rmsnorm_quant_colwise`` (:246);
- B9 :func:`silu_mul_quant_rowwise` and :func:`silu_mul_quant_colwise` for
  ``silu_mul_quant_rowwise`` (:325) and ``silu_mul_quant_colwise`` (:409);
- B10 :func:`rmsnorm_bwd` for ``rmsnorm_bwd`` (:491);
- B11 :func:`silu_mul_bwd_quant_rowwise` for ``silu_mul_bwd_quant_rowwise``
  (:631) and B12 :func:`silu_mul_bwd_quant_colwise` for
  ``silu_mul_bwd_quant_colwise`` (:704): (da, db) of y = silu(a) * b at dy,
  computed in fp32 from one read of (a, b, dy) and quantized along rows
  (with their column absmax, or their copies in a's dtype) or along columns
  given those maxima' scales, never written in bf16;
- B18, the ViT producers of ``_producer_quant_call`` (:803):
  :func:`layernorm_quant` (:918) and :func:`gelu_quant` (:952), affine
  LayerNorm or tanh-GELU inside the int8 quantize, along rows (with the
  column absmax) or along columns (given scales, or two passes), each form
  its own wrapper and counter (:func:`layernorm_quant_rowwise`,
  :func:`layernorm_quant_colwise`, :func:`gelu_quant_rowwise`,
  :func:`gelu_quant_colwise`);

with the producers' plain semantics (``rms_norm_f32``, ``silu_mul_f32``,
``silu_mul_bwd_f32``, ``layer_norm_f32``, ``gelu_f32`` and the unfused
composites ``rms_norm_ref``, ``silu_mul_ref``, ``layer_norm_ref``), one
plain version per kernel and :func:`supported`. The producer runs inside the quantize: its output is
fp32 and never rounded to bf16. The quantize has the Pallas bodies'
numerics (``pallas_fused.py:111-132``, ``pallas_quant.py:75-87``), which
differ from ``quant/core.py``'s: scale = absmax * (1/127) in fp32 and
q = round-half-even(y * (1 / max(scale, eps))), a reciprocal multiply; with
``sr`` floor(y * inv + u), u of element (r, c) the uniform at r * K + c of
the key's Philox stream (``ops/random.py``); B11 and B12, which round two
outputs per element, draw da's u at r * K + c and db's at M * K + r * K + c.
Scales and column maxima are fp32, as the Pallas kernels return them.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel of
``csrc/fused_producers.cu`` (whose header says what bounds it on the H100
and how its design answers that) or raises. Each wrapper counts its
launches, an SR form apart (``sr_launches``). B7, B8 given scales, B9's
row form and its given-scales column form, B10, B11 and B12 take the
persistent row walk, redesigned for the H100's memory system, wherever its
layout leaves no lane idle (:func:`norm_rows_sm90_route`,
:func:`norm_cols_sm90_route`, :func:`silu_rows_sm90_route`,
:func:`silu_cols_sm90_route`, :func:`rmsnorm_bwd_sm90_route`,
:func:`silu_bwd_rows_sm90_route`, :func:`silu_bwd_cols_sm90_route`, decided
here and passed to the C entry), and so do B18's row forms and its
given-scales column forms (:func:`layernorm_rows_sm90_route`,
:func:`layernorm_cols_sm90_route`, :func:`gelu_rows_sm90_route`,
:func:`gelu_cols_sm90_route`), and count those launches again
(``sm90_launches``, ``sr_sm90_launches``); other widths, and the two-pass
column forms of B8, B9 and B18, keep the first design. B9, B11, B12 and
B18's GELU forms are bit-exact with their plain versions on the card. B7,
B8, B10 and B18's LayerNorm forms hold a row sum, which the kernel takes in
its own order: their int8 outputs may differ by one step on rare elements,
their scales, maxima, dx and dgamma by fp32 rounding; on the walk they keep
the first design's order, and its bits (B10's dgamma apart).
"""

from __future__ import annotations

import math

import torch

from . import _build, random
from .int8_quant import _check_device_input, _count_route, _device_key, _key, _sm_count, row_walk_ctas

EPS = 1e-12
_DTYPES = (torch.bfloat16, torch.float32)
# every kernel keeps two fp32 rows of K (the producer's row and the column
# maxima or reciprocal scales) in one block's shared memory, at most 227 KB;
# B11 four (the da and db rows and their column maxima)
MAX_K = 227 * 1024 // 8
MAX_K_BWD = 227 * 1024 // 16


# ---- the producers (plain semantics) --------------------------------------------


def rms_norm_ref(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """The unfused composite's RMSNorm: fp32 math, rounded to x's dtype
    before the weight is applied (``models.llama.rms_norm``)."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * g


def rms_norm_f32(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """The fused kernels' RMSNorm: fp32 throughout, no intermediate rounding."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return xf * rstd * g.float()


def silu_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) * b with fp32 silu math, the product in the input dtype."""
    af = a.float()
    return (af * torch.sigmoid(af)).to(a.dtype) * b


def silu_mul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fused kernels' silu(a) * b, fp32 throughout, with the sigmoid
    as the kernel computes it: 1 / (1 + exp(-a)) with an IEEE division (by
    a tensor: PyTorch's CUDA division by a Python scalar is a reciprocal
    multiply), then (a * s) * b."""
    af = a.float()
    d = 1 + torch.exp(-af)
    return af * (torch.ones_like(d) / d) * b.float()


def silu_mul_bwd_f32(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor):
    """(da, db) of y = silu(a) * b at dy, fp32 and unrounded (JAX
    ``silu_mul_bwd_f32``, :541-552), the sigmoid as in
    :func:`silu_mul_f32`: da = dy * b * s * (1 + a * (1 - s)), db = dy * a
    * s, left to right."""
    af, dyf = a.float(), dy.float()
    d = 1 + torch.exp(-af)
    s = torch.ones_like(d) / d
    return dyf * b.float() * s * (1 + af * (1 - s)), dyf * af * s


def layer_norm_ref(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The unfused composite's LayerNorm (JAX ``layer_norm_ref``, :768, and
    ``models.vit.layer_norm``): fp32 math, xhat rounded to x's dtype before
    the affine, which runs in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def layer_norm_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The fused kernels' LayerNorm (JAX :777): fp32 throughout, xhat = (x -
    mean) * rsqrt(mean((x - mean)^2) + eps), then xhat * g + b."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * rstd * g.float() + b.float()


SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)  # rounded to fp32 where it multiplies


def gelu_f32(a: torch.Tensor) -> torch.Tensor:
    """The fused kernels' GELU, the tanh form of ``jax.nn.gelu`` (its
    default; JAX :786) in fp32, in the kernel's order: inner = (a + ((a * a)
    * a) * 0.044715) * sqrt(2/pi), then a * ((tanh(inner) + 1) * 0.5). Each
    step is one torch op with an fp32 scalar, so the kernel's
    ``__fmul_rn``/``__fadd_rn`` chain and ``tanhf`` give the same bits."""
    af = a.float()
    inner = (af + af * af * af * 0.044715) * SQRT_2_OVER_PI
    return af * ((torch.tanh(inner) + 1) * 0.5)


def gelu_bwd_f32(a: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """da of y = gelu(a) (tanh form) at dy, fp32 (JAX ``jax.vjp`` of
    ``jax.nn.gelu(approximate=True)``, quant/fused.py:1068-1071): dy *
    (cdf + a * 0.5 * (1 - t^2) * sqrt(2/pi) * (1 + 3 * 0.044715 * a^2)),
    t = tanh(inner), cdf = 0.5 * (1 + t)."""
    af = a.float()
    t = torch.tanh((af + af * af * af * 0.044715) * SQRT_2_OVER_PI)
    dinner = (1 + af * af * (3 * 0.044715)) * SQRT_2_OVER_PI
    return dy.float() * ((t + 1) * 0.5 + af * 0.5 * (1 - t * t) * dinner)


# ---- the quantize of the Pallas bodies ------------------------------------------


def _inv127(t: torch.Tensor) -> torch.Tensor:
    return t.new_full((), 1.0 / 127.0, dtype=torch.float32)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """amax * (1/127) in fp32 (``pallas_fused.py:118``)."""
    return amax * _inv127(amax)


def _cast(y: torch.Tensor, scale: torch.Tensor, eps: float, sr: bool, key: int | None,
          part: int = 0) -> torch.Tensor:
    """int8 of fp32 y [M, K] with a broadcast fp32 scale: y times the IEEE
    reciprocal of max(scale, eps), rounded half to even, or with ``sr``
    floor(. + u) from the stream of ``key``, element (r, c) drawing word
    part * M * K + r * K + c, clamped."""
    s = scale.clamp(min=eps)
    q = y * (torch.ones_like(s) / s)
    if sr:
        q = torch.floor(q + random.uniform(key, (part + 1, *y.shape), y.device)[part])
    else:
        q = torch.round(q)
    return q.clamp(-128, 127).to(torch.int8)


def _quant_rows(y, eps, sr, key, with_col_amax):
    ya = y.abs()
    scale = _scale_of(ya.amax(dim=1, keepdim=True))
    out = (_cast(y, scale, eps, sr, key), scale)
    return (*out, ya.amax(dim=0, keepdim=True)) if with_col_amax else out


def _quant_cols(y, scale, eps, sr, key):
    if scale is None:
        scale = _scale_of(y.abs().amax(dim=0, keepdim=True))
    return _cast(y, scale, eps, sr, key), scale


# ---- plain versions -------------------------------------------------------------


def rmsnorm_quant_rowwise_plain(x, g, *, norm_eps: float = 1e-5, eps: float = EPS, sr: bool = False,
                                key: int | None = None, with_col_amax: bool = False):
    """Plain version of B7: the row int8 of ``rms_norm_f32(x, g)``,
    ``(q [M, K], scale fp32 [M, 1])``, with ``with_col_amax`` also the
    column absmax fp32 [1, K] of the same values."""
    return _quant_rows(rms_norm_f32(x, g, norm_eps), eps, sr, _key(sr, key), with_col_amax)


def rmsnorm_quant_colwise_plain(x, g, *, norm_eps: float = 1e-5, eps: float = EPS, sr: bool = False,
                                key: int | None = None, scale: torch.Tensor | None = None):
    """Plain version of B8: the column int8 of ``rms_norm_f32(x, g)``
    with the given fp32 column scales [1, K], or without them from its
    column absmax (two passes): ``(q [M, K], scale fp32 [1, K])``."""
    return _quant_cols(rms_norm_f32(x, g, norm_eps), scale, eps, sr, _key(sr, key))


def silu_mul_quant_rowwise_plain(a, b, *, eps: float = EPS, sr: bool = False, key: int | None = None,
                                 with_col_amax: bool = False):
    """Plain version of the row form of B9 (``silu_mul_f32``)."""
    return _quant_rows(silu_mul_f32(a, b), eps, sr, _key(sr, key), with_col_amax)


def silu_mul_quant_colwise_plain(a, b, *, eps: float = EPS, sr: bool = False, key: int | None = None,
                                 scale: torch.Tensor | None = None):
    """Plain version of the column form of B9."""
    return _quant_cols(silu_mul_f32(a, b), scale, eps, sr, _key(sr, key))


def silu_mul_bwd_quant_rowwise_plain(a, b, dy, *, eps: float = EPS, sr: bool = False, key: int | None = None,
                                     with_amax: bool = True, with_bf16: bool = False):
    """Plain version of B11: ``(da_q, da_s [M, 1], db_q, db_s [M, 1])`` the
    row int8 of ``silu_mul_bwd_f32(a, b, dy)``, with ``with_amax`` then the
    column absmax fp32 [1, K] of da and of db, with ``with_bf16`` then da
    and db in a's dtype."""
    key = _key(sr, key)
    quants, amaxes, copies = [], [], []
    for part, v in enumerate(silu_mul_bwd_f32(a, b, dy)):
        va = v.abs()
        scale = _scale_of(va.amax(dim=1, keepdim=True))
        quants += [_cast(v, scale, eps, sr, key, part), scale]
        amaxes.append(va.amax(dim=0, keepdim=True))
        copies.append(v.to(a.dtype))
    return (*quants, *(amaxes if with_amax else ()), *(copies if with_bf16 else ()))


def silu_mul_bwd_quant_colwise_plain(a, b, dy, da_scale, db_scale, *, eps: float = EPS, sr: bool = False,
                                     key: int | None = None):
    """Plain version of B12: ``(da_q, db_q)``, the column int8 of
    ``silu_mul_bwd_f32(a, b, dy)`` with the fp32 column scales [1, K] of
    each."""
    key = _key(sr, key)
    return tuple(_cast(v, s.reshape(1, -1), eps, sr, key, part)
                 for part, (v, s) in enumerate(zip(silu_mul_bwd_f32(a, b, dy), (da_scale, db_scale))))


def rmsnorm_bwd_plain(x, g, dy, *, norm_eps: float = 1e-5):
    """Plain version of B10, the closed form of ``quant/fused.py::
    _rmsnorm_bwd_math``: ``(dx in x's dtype, dgamma fp32 [K])``."""
    xf, dyf = x.float(), dy.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + norm_eps)
    xn = xf * rstd
    dxn = dyf * g.float()
    dx = (dxn - xn * (dxn * xn).mean(dim=-1, keepdim=True)) * rstd
    return dx.to(x.dtype), (dyf * xn).sum(dim=0)


def layernorm_quant_plain(x, g, b, *, axis: int = 1, norm_eps: float = 1e-6, eps: float = EPS, sr: bool = False,
                          key: int | None = None, with_col_amax: bool = False, scale: torch.Tensor | None = None):
    """Plain version of B18's LayerNorm forms (JAX ``layernorm_quant``,
    :918): the int8 of ``layer_norm_f32(x, g, b)`` along ``axis``, as
    :func:`layernorm_quant` returns it."""
    y = layer_norm_f32(x, g, b, norm_eps)
    if _axis(axis) == 1:
        return _quant_rows(y, eps, sr, _key(sr, key), with_col_amax)
    return _quant_cols(y, scale, eps, sr, _key(sr, key))


def gelu_quant_plain(a, *, axis: int = 1, eps: float = EPS, sr: bool = False, key: int | None = None,
                     with_col_amax: bool = False, scale: torch.Tensor | None = None):
    """Plain version of B18's GELU forms (JAX ``gelu_quant``, :952): the
    int8 of ``gelu_f32(a)`` along ``axis``."""
    y = gelu_f32(a)
    if _axis(axis) == 1:
        return _quant_rows(y, eps, sr, _key(sr, key), with_col_amax)
    return _quant_cols(y, scale, eps, sr, _key(sr, key))


def _axis(axis: int) -> int:
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (columns) or 1 (rows), got {axis!r}")
    return axis


# ---- the shape gate -------------------------------------------------------------


def supported(M: int, K: int, dtype, n_inputs: int = 1) -> bool:
    """Whether the fused kernels take [M, K] inputs of ``dtype``: the
    reference's conditions (``pallas_fused.py:750-760``): bf16 or fp32,
    M >= 32 and a multiple of 32 (its row blocks), K >= 128 and a multiple
    of 128; its VMEM budget, which reads ``n_inputs``, becomes the kernels'
    shared-memory bound: K <= ``MAX_K``, and for the three inputs of B11
    and B12 K <= ``MAX_K_BWD``."""
    max_k = MAX_K_BWD if n_inputs >= 3 else MAX_K
    return dtype in _DTYPES and M >= 32 and M % 32 == 0 and 128 <= K <= max_k and K % 128 == 0


# ---- the routes of B7-B12 and B18 ----------------------------------------------

# B7's and B8's vectors a thread a row on the row walk
# (csrc/fused_producers.cu::kNormV), B10's of each of x and dy (::kNormBwdV)
NORM_ROW_VECTORS = 4
NORM_BWD_VECTORS = 2
_CTA = 256  # the row kernels' block (csrc/row_common.cuh::kThreads)
# The silu walks (B9, B11, B12): vectors a thread -> the largest CTA. B11
# and B9's RN forms try two vectors a thread first, B12 and B9-col's SR form
# one: at [8192, 5632] on the H100 two ran B11 at 157.4 us, one 177.6; one
# ran B12 at 127.2 us, two 132.1 (SR 189.4, 200.6), and B9-col-SR at 111.6,
# two 131.6 (ab_sm90_forms.py, PERF.md)
_SILU_ROWS_MAX_CTA = {2: 384, 1: 704}
_TWO_FIRST, _ONE_FIRST = (2, 1), (1, 2)
# CTAs an SM the walks' launch bounds keep resident: B7, B8 and B10 two of
# 256, B11 and B12 one, B9's forms and B18's GELU forms two in their RN
# forms at two vectors a thread, else one
# (csrc/fused_producers.cu::silu_rows_ctas, kSiluCtasPerSm), B18's
# LayerNorm forms two of 256 (kLayerNormCtasPerSm), its SR row form one
# (layernorm_rows_ctas)
NORM_CTAS_PER_SM, SILU_CTAS_PER_SM, SILU_ROWS_CTAS_PER_SM = 2, 1, 2
LAYERNORM_CTAS_PER_SM = 2
# B18's LayerNorm walks: the vectors a thread a row the route tries, in
# order (csrc/fused_producers.cu::kLayerNormVs): bf16 K 1536 takes three
LAYERNORM_VECTORS = (4, 3)


def _norm_walk_tpr(K: int, dtype, vectors: int) -> int:
    """``vectors`` 16-byte vectors a thread, whole warps, groups that divide
    the block of 256 (what keeps the RMSNorm row sums in the first design's
    order); 0 where no such layout is."""
    nv = K * dtype.itemsize // 16
    tpr = nv // vectors
    return tpr if tpr * vectors == nv and tpr in (32, 64, 128, 256) else 0


def norm_rows_sm90_route(K: int, dtype) -> int:
    """The threads a row of B7 on the persistent row walk
    (``csrc/fused_producers.cu::rmsnorm_rows``), 0 for the first design
    (``row_quant``): ``NORM_ROW_VECTORS`` 16-byte vectors a thread, so K
    holds 32, 64, 128 or 256 times that many (bf16 K 1024-8192, fp32
    512-4096; the Llama2-1B step's 2048 with 64), groups that divide the
    block, so that B7's sum of squares keeps the first design's order."""
    return _norm_walk_tpr(K, dtype, NORM_ROW_VECTORS)


def norm_cols_sm90_route(K: int, dtype) -> int:
    """The threads a row of B8 given scales on the persistent row walk
    (``csrc/fused_producers.cu::rmsnorm_cols``), 0 for the first design
    (``col_quant``): B7's layouts (bf16 K 2048: 64 threads, four vectors
    each), so that B8's sum of squares is B7's to the bit. The two-pass form
    keeps the first design."""
    return _norm_walk_tpr(K, dtype, NORM_ROW_VECTORS)


def rmsnorm_bwd_sm90_route(K: int, dtype) -> int:
    """The threads a row of B10 on the persistent row walk
    (``csrc/fused_producers.cu::rmsnorm_bwd_walk``), 0 for the first design
    (``rmsnorm_bwd_rows``): ``NORM_BWD_VECTORS`` 16-byte vectors of x and of
    dy a thread, groups that divide the block (bf16 K 512-4096, fp32
    256-2048; the Llama2-1B step's 2048 with 128), so that both row sums
    keep the first design's order."""
    return _norm_walk_tpr(K, dtype, NORM_BWD_VECTORS)


def _silu_walk_tpr(K: int, dtype, vectors=_TWO_FIRST) -> int:
    """The first of ``vectors`` 16-byte vectors a thread (two, then one) that
    takes whole warps, a group that fills its block or divides it, within
    the block the kernel's registers allow; 0 where none is."""
    nv = K * dtype.itemsize // 16
    for v in vectors:
        tpr = nv // v
        cta = max(tpr, _CTA)
        if tpr * v == nv and tpr % 32 == 0 and tpr > 0 and cta % tpr == 0 and cta <= _SILU_ROWS_MAX_CTA[v]:
            return tpr
    return 0


def silu_bwd_rows_sm90_route(K: int, dtype) -> int:
    """The threads a row of B11 on the persistent row walk
    (``csrc/fused_producers.cu::silu_bwd_rows``), 0 for the first design
    (``silu_bwd_row_quant``): two 16-byte vectors a thread, else one, whole
    warps, a group that fills its block or divides it, within the block the
    kernel's registers allow (bf16 K = 5632: 352 threads, two vectors
    each)."""
    return _silu_walk_tpr(K, dtype)


def silu_bwd_cols_sm90_route(K: int, dtype) -> int:
    """The threads a row of B12 given scales on the persistent row walk
    (``csrc/fused_producers.cu::silu_bwd_cols``), 0 for the first design
    (``silu_bwd_col_quant``): B11's layouts, one vector a thread tried
    first (bf16 K = 5632: 704 threads; 6144: 384 of two), with
    ``SILU_CTAS_PER_SM`` CTAs an SM, as B11."""
    return _silu_walk_tpr(K, dtype, _ONE_FIRST)


def silu_rows_sm90_route(K: int, dtype) -> int:
    """The threads a row of B9's row form on the persistent row walk
    (``csrc/fused_producers.cu::elementwise_rows<SiluMulOp>``), 0 for the first design
    (``row_quant<SiluProducer>``): B11's layouts (bf16 K = 5632: 352
    threads, two vectors each), with :func:`silu_rows_ctas_per_sm` CTAs an
    SM."""
    return _silu_walk_tpr(K, dtype)


def silu_rows_ctas_per_sm(K: int, dtype, sr: bool) -> int:
    """CTAs an SM B9's row walk keeps resident at width K, as its launch
    bounds do (``csrc/fused_producers.cu::silu_rows_ctas``):
    ``SILU_ROWS_CTAS_PER_SM`` for the RN form at two vectors a thread, else
    one."""
    return _elementwise_ctas_per_sm(silu_rows_sm90_route(K, dtype), K, dtype, sr)


def silu_cols_sm90_route(K: int, dtype, sr: bool = False) -> int:
    """The threads a row of B9's column form given scales on the
    persistent row walk (``csrc/fused_producers.cu::elementwise_cols<SiluMulOp>``),
    0 for the first design (``col_quant<SiluProducer>``): the row form's
    layouts, the SR form's one vector a thread tried first (bf16 K = 5632:
    352 threads of two, SR 704 of one), with :func:`silu_cols_ctas_per_sm`
    CTAs an SM. The two-pass form keeps the first design."""
    return _silu_walk_tpr(K, dtype, _ONE_FIRST if sr else _TWO_FIRST)


def silu_cols_ctas_per_sm(K: int, dtype, sr: bool) -> int:
    """CTAs an SM B9's column walk keeps resident, as its launch bounds do
    (``silu_rows_ctas``): two for the RN form at two vectors a thread, else
    one."""
    return _elementwise_ctas_per_sm(silu_cols_sm90_route(K, dtype, sr), K, dtype, sr)


def _elementwise_ctas_per_sm(tpr: int, K: int, dtype, sr: bool) -> int:
    two = tpr and K * dtype.itemsize // 16 == 2 * tpr
    return SILU_ROWS_CTAS_PER_SM if two and not sr else 1


def layernorm_rows_sm90_route(K: int, dtype) -> int:
    """The threads a row of B18's LayerNorm rows on the persistent row walk
    (``csrc/fused_producers.cu::layernorm_rows``), 0 for the first design
    (``row_quant<LayerNormProducer>``): the first of ``LAYERNORM_VECTORS``
    16-byte vectors a thread that tiles the row with 32, 64, 128 or 256
    threads (groups that divide the block, so that both row sums keep the
    first design's order): ViT-Giant's bf16 K 1536 (192 vectors) takes 64
    threads of three vectors; bf16 K 768-6144 at three, 1024-8192 at four."""
    for v in LAYERNORM_VECTORS:
        tpr = _norm_walk_tpr(K, dtype, v)
        if tpr:
            return tpr
    return 0


def layernorm_rows_ctas_per_sm(sr: bool) -> int:
    """CTAs an SM B18's LayerNorm row walk keeps resident, as its launch
    bounds do (``csrc/fused_producers.cu::layernorm_rows_ctas``):
    ``LAYERNORM_CTAS_PER_SM``, the SR form one."""
    return 1 if sr else LAYERNORM_CTAS_PER_SM


def layernorm_cols_sm90_route(K: int, dtype) -> int:
    """The threads a row of B18's LayerNorm columns given scales on the
    persistent row walk (``csrc/fused_producers.cu::layernorm_cols``), 0 for
    the first design (``col_quant<LayerNormProducer>``): the row form's
    layouts, so that y is the row form's to the bit. The two-pass form keeps
    the first design."""
    return layernorm_rows_sm90_route(K, dtype)


def gelu_rows_sm90_route(K: int, dtype) -> int:
    """The threads a row of B18's GELU rows on the persistent row walk
    (``csrc/fused_producers.cu::elementwise_rows<GeluOp>``, B9-row's walk
    over one input), 0 for the first design (``row_quant<GeluProducer>``):
    B9-row's layouts (ViT-Giant's bf16 K 6144, 768 vectors: 384 threads of
    two vectors), with :func:`gelu_ctas_per_sm` CTAs an SM."""
    return _silu_walk_tpr(K, dtype)


def gelu_cols_sm90_route(K: int, dtype) -> int:
    """The threads a row of B18's GELU columns given scales on the
    persistent row walk (``csrc/fused_producers.cu::elementwise_cols<GeluOp>``),
    0 for the first design (``col_quant<GeluProducer>``): the row form's
    layouts. The two-pass form keeps the first design."""
    return _silu_walk_tpr(K, dtype)


def gelu_ctas_per_sm(K: int, dtype, sr: bool) -> int:
    """CTAs an SM B18's GELU walks keep resident at width K, as B9-row's
    (their launch bounds are its ``silu_rows_ctas``): two for the RN form at
    two vectors a thread, else one."""
    return _elementwise_ctas_per_sm(gelu_rows_sm90_route(K, dtype), K, dtype, sr)


# ---- wrappers -------------------------------------------------------------------


def _rows_per_block(M: int) -> int:
    """Rows per block: about four blocks per SM of the H100's 132, at most
    16 rows, so that a run of rows shares one row of the per-block column
    maxima or dgamma sums."""
    return max(1, min(16, M // 528))


def _parts(M: int, K: int, device, needed: bool = True) -> torch.Tensor:
    """fp32 scratch for the per-block column maxima or sums, [blocks, K]."""
    return torch.empty((-(-M // _rows_per_block(M)), K) if needed else (0,), dtype=torch.float32, device=device)


def _route_parts(M: int, K: int, device, needed: bool, tpr: int, per_sm: int) -> tuple[int, torch.Tensor]:
    """The grid of B7's, B9-row's, B10's, B11's or B18's row route (0 for
    the first design) and the fp32 scratch of its column partials: [CTAs, K] on
    the row walk (one row a CTA), [blocks, K] for the first design."""
    if not tpr:
        return 0, _parts(M, K, device, needed)
    ctas = row_walk_ctas(M, tpr, _sm_count(device), per_sm)
    return ctas, torch.empty((ctas, K) if needed else (0,), dtype=torch.float32, device=device)


def _check(what: str, *tensors: torch.Tensor) -> tuple[int, int]:
    """Device, dtype, shape and layout of the kernels' [M, K] inputs."""
    x = tensors[0]
    for t in tensors:
        _check_device_input(t, what, ndim=2)
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: inputs differ in shape, dtype or device")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must start on a 16-byte boundary")
    M, K = x.shape
    if K % 128 or not 128 <= K <= MAX_K:
        raise ValueError(f"{what}: K = {K} must be a multiple of 128 in [128, {MAX_K}]")
    return M, K


def _gamma(g: torch.Tensor, x: torch.Tensor, what: str, name: str = "gamma") -> torch.Tensor:
    if g.numel() != x.shape[1] or g.device != x.device:
        raise ValueError(f"{what}: {name} of {g.numel()} elements on {g.device} for rows of {x.shape[1]}")
    return g.reshape(-1).float().contiguous()


def _col_scale(scale: torch.Tensor, K: int, x: torch.Tensor, what: str) -> torch.Tensor:
    if scale.numel() != K or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"{what}: scale must be fp32 [1, {K}] on {x.device}")
    return scale.reshape(1, K).contiguous()


def rmsnorm_quant_rowwise(x: torch.Tensor, g: torch.Tensor, *, norm_eps: float = 1e-5, eps: float = EPS,
                          sr: bool = False, key: int | None = None, with_col_amax: bool = False):
    """B7: ``quantize(rms_norm_f32(x, g), axis=1)`` in one read of x [M,
    K]: ``(q int8 [M, K], scale fp32 [M, 1])``, with ``with_col_amax`` also
    the column absmax fp32 [1, K] of the same values, which lets the
    backward's column quantize skip its absmax pass."""
    if x.device.type == "cpu":
        return rmsnorm_quant_rowwise_plain(x, g, norm_eps=norm_eps, eps=eps, sr=sr, key=key,
                                           with_col_amax=with_col_amax)
    gf = _gamma(g, x, "rmsnorm_quant_rowwise")
    dt = int(x.dtype == torch.bfloat16)
    launch = lambda q, s, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_rmsnorm_quant_rowwise(
        x.data_ptr(), gf.data_ptr(), q, s, am, pt, M, K, rpb, norm_eps, eps, dt, int(sr), int(with_col_amax), k, tpr,
        ctas, _build.stream())
    return _rowwise("rmsnorm_quant_rowwise", rmsnorm_quant_rowwise, launch, (x,), sr, key, with_col_amax,
                    norm_rows_sm90_route(x.shape[-1], x.dtype))


def silu_mul_quant_rowwise(a: torch.Tensor, b: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                           key: int | None = None, with_col_amax: bool = False):
    """B9, row form: ``quantize(silu_mul_f32(a, b), axis=1)`` reading a and
    b [M, K] once; outputs as :func:`rmsnorm_quant_rowwise`."""
    if a.device.type == "cpu":
        return silu_mul_quant_rowwise_plain(a, b, eps=eps, sr=sr, key=key, with_col_amax=with_col_amax)
    dt = int(a.dtype == torch.bfloat16)
    launch = lambda q, s, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_silu_mul_quant_rowwise(
        a.data_ptr(), b.data_ptr(), q, s, am, pt, M, K, rpb, eps, dt, int(sr), int(with_col_amax), k, tpr, ctas,
        _build.stream())
    return _rowwise("silu_mul_quant_rowwise", silu_mul_quant_rowwise, launch, (a, b), sr, key, with_col_amax,
                    silu_rows_sm90_route(a.shape[-1], a.dtype), silu_rows_ctas_per_sm(a.shape[-1], a.dtype, sr))


def _rowwise(what, fn, launch, inputs, sr, key, with_col_amax, tpr, per_sm=NORM_CTAS_PER_SM):
    """Launch the row form of B7, B9 or B18: ``(q int8 [M, K], scale fp32
    [M, 1])``, with ``with_col_amax`` also the column absmax fp32 [1, K].
    ``tpr``: the threads a row on the row walk of ``per_sm`` CTAs an SM, 0
    for the first design."""
    key = _device_key(sr, key, what)
    M, K = _check(what, *inputs)
    dev = inputs[0].device
    q = torch.empty((M, K), dtype=torch.int8, device=dev)
    scale = torch.empty((M, 1), dtype=torch.float32, device=dev)
    amax = torch.empty((1, K) if with_col_amax else (0,), dtype=torch.float32, device=dev)
    ctas, parts = _route_parts(M, K, dev, with_col_amax, tpr, per_sm)
    err = launch(q.data_ptr(), scale.data_ptr(), amax.data_ptr(), parts.data_ptr(), M, K, _rows_per_block(M), key,
                 tpr, ctas)
    _build.check(err, what)
    _count_route(fn, sr, bool(tpr))
    return (q, scale, amax) if with_col_amax else (q, scale)


def _colwise(what, fn, launch, inputs, scale, eps, sr, key, tpr, per_sm=NORM_CTAS_PER_SM):
    """Launch the column form of B8, B9 or B18: given scales, or two
    passes. ``tpr``: the threads a row on the row walk of ``per_sm`` CTAs
    an SM (given scales only; no scratch), 0 for the first design."""
    key = _device_key(sr, key, what)
    M, K = _check(what, *inputs)
    x = inputs[0]
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    if scale is not None:
        scale = _col_scale(scale, K, x, what)
        amax = s_out = parts = None
    else:
        amax = torch.empty(K, dtype=torch.float32, device=x.device)
        s_out = torch.empty((1, K), dtype=torch.float32, device=x.device)
        parts = _parts(M, K, x.device)
    ctas = row_walk_ctas(M, tpr, _sm_count(x.device), per_sm) if tpr else 0
    ptr = lambda t: None if t is None else t.data_ptr()
    err = launch(ptr(scale), q.data_ptr(), ptr(s_out), ptr(amax), ptr(parts), M, K, _rows_per_block(M), key, tpr, ctas)
    _build.check(err, what)
    _count_route(fn, sr, bool(tpr))
    return q, (scale if s_out is None else s_out)


def rmsnorm_quant_colwise(x: torch.Tensor, g: torch.Tensor, *, norm_eps: float = 1e-5, eps: float = EPS,
                          sr: bool = False, key: int | None = None, scale: torch.Tensor | None = None):
    """B8: ``quantize(rms_norm_f32(x, g), axis=0)``: with the given fp32
    column scales [1, K] (the forward's column absmax * (1/127)) in one read
    of x, else in two (absmax, then cast): ``(q int8 [M, K], scale fp32
    [1, K])``."""
    if x.device.type == "cpu":
        return rmsnorm_quant_colwise_plain(x, g, norm_eps=norm_eps, eps=eps, sr=sr, key=key, scale=scale)
    gf = _gamma(g, x, "rmsnorm_quant_colwise")
    dt = int(x.dtype == torch.bfloat16)
    launch = lambda sc, q, so, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_rmsnorm_quant_colwise(
        x.data_ptr(), gf.data_ptr(), sc, q, so, am, pt, M, K, rpb, norm_eps, eps, dt, int(sr), k, tpr, ctas,
        _build.stream())
    tpr = norm_cols_sm90_route(x.shape[-1], x.dtype) if scale is not None else 0  # two passes: the first design
    return _colwise("rmsnorm_quant_colwise", rmsnorm_quant_colwise, launch, (x,), scale, eps, sr, key, tpr)


def silu_mul_quant_colwise(a: torch.Tensor, b: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                           key: int | None = None, scale: torch.Tensor | None = None):
    """B9, column form: ``quantize(silu_mul_f32(a, b), axis=0)``, given
    scales or two passes, as :func:`rmsnorm_quant_colwise`."""
    if a.device.type == "cpu":
        return silu_mul_quant_colwise_plain(a, b, eps=eps, sr=sr, key=key, scale=scale)
    dt = int(a.dtype == torch.bfloat16)
    launch = lambda sc, q, so, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_silu_mul_quant_colwise(
        a.data_ptr(), b.data_ptr(), sc, q, so, am, pt, M, K, rpb, eps, dt, int(sr), k, tpr, ctas, _build.stream())
    K = a.shape[-1]
    tpr = silu_cols_sm90_route(K, a.dtype, sr) if scale is not None else 0  # two passes: the first design
    return _colwise("silu_mul_quant_colwise", silu_mul_quant_colwise, launch, (a, b), scale, eps, sr, key, tpr,
                    silu_cols_ctas_per_sm(K, a.dtype, sr))


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, *, norm_eps: float = 1e-5):
    """B10: the RMSNorm backward in one read of x and dy [M, K]: ``(dx in
    x's dtype [M, K], dgamma fp32 [K])``. dgamma is summed per block (on the
    row walk, :func:`rmsnorm_bwd_sm90_route`, per CTA), then over the blocks
    in order: a function of the inputs and the grid, run after run."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, g, dy, norm_eps=norm_eps)
    M, K = _check("rmsnorm_bwd", x, dy)
    gf = _gamma(g, x, "rmsnorm_bwd")
    dx = torch.empty_like(x)
    dg = torch.empty(K, dtype=torch.float32, device=x.device)
    tpr = rmsnorm_bwd_sm90_route(K, x.dtype)
    ctas, dg_part = _route_parts(M, K, x.device, True, tpr, NORM_CTAS_PER_SM)
    err = _build.library().qt_rmsnorm_bwd(
        x.data_ptr(), gf.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg.data_ptr(), dg_part.data_ptr(), M, K,
        _rows_per_block(M), norm_eps, int(x.dtype == torch.bfloat16), tpr, ctas, _build.stream(),
    )
    _build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.sm90_launches += int(tpr > 0)
    return dx, dg


def silu_mul_bwd_quant_rowwise(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor, *, eps: float = EPS,
                               sr: bool = False, key: int | None = None, with_amax: bool = True,
                               with_bf16: bool = False):
    """B11: (da, db) of y = silu(a) * b at dy, row-quantized from one read of
    (a, b, dy) [M, K]: ``(da_q int8 [M, K], da_s fp32 [M, 1], db_q, db_s)``,
    with ``with_amax`` then the column absmax fp32 [1, K] of da and of db
    (the scales of :func:`silu_mul_bwd_quant_colwise`), with ``with_bf16``
    then da and db in a's dtype (the operands of a bf16 grad_weight)."""
    if a.device.type == "cpu":
        return silu_mul_bwd_quant_rowwise_plain(a, b, dy, eps=eps, sr=sr, key=key, with_amax=with_amax,
                                                with_bf16=with_bf16)
    key = _device_key(sr, key, "silu_mul_bwd_quant_rowwise")
    M, K = _check("silu_mul_bwd_quant_rowwise", a, b, dy)
    if K > MAX_K_BWD:
        raise ValueError(f"silu_mul_bwd_quant_rowwise: K = {K} exceeds {MAX_K_BWD} (shared memory)")
    dev = a.device
    qa, qb = (torch.empty((M, K), dtype=torch.int8, device=dev) for _ in range(2))
    sa, sb = (torch.empty((M, 1), dtype=torch.float32, device=dev) for _ in range(2))
    amax = torch.empty(2 * K if with_amax else 0, dtype=torch.float32, device=dev)
    tpr = silu_bwd_rows_sm90_route(K, a.dtype)
    ctas, parts = _route_parts(M, 2 * K, dev, with_amax, tpr, SILU_CTAS_PER_SM)
    ca, cb = (torch.empty((M, K) if with_bf16 else (0,), dtype=a.dtype, device=dev) for _ in range(2))
    err = _build.library().qt_silu_mul_bwd_quant_rowwise(
        a.data_ptr(), b.data_ptr(), dy.data_ptr(), qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(),
        amax.data_ptr(), parts.data_ptr(), ca.data_ptr(), cb.data_ptr(), M, K, _rows_per_block(M), eps,
        int(a.dtype == torch.bfloat16), int(sr), int(with_amax), int(with_bf16), key, tpr, ctas, _build.stream(),
    )
    _build.check(err, "silu_mul_bwd_quant_rowwise")
    _count_route(silu_mul_bwd_quant_rowwise, sr, bool(tpr))
    out = (qa, sa, qb, sb)
    if with_amax:
        out += (amax[:K].view(1, K), amax[K:].view(1, K))
    return out + (ca, cb) if with_bf16 else out


def silu_mul_bwd_quant_colwise(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor, da_scale: torch.Tensor,
                               db_scale: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                               key: int | None = None):
    """B12: (da, db) of y = silu(a) * b at dy, column-quantized with the
    given fp32 column scales [1, K] (B11's column absmax * (1/127)) in one
    read of (a, b, dy): ``(da_q, db_q)`` int8 [M, K]; on the row walk where
    :func:`silu_bwd_cols_sm90_route` gives threads a row."""
    if a.device.type == "cpu":
        return silu_mul_bwd_quant_colwise_plain(a, b, dy, da_scale, db_scale, eps=eps, sr=sr, key=key)
    what = "silu_mul_bwd_quant_colwise"
    key = _device_key(sr, key, what)
    M, K = _check(what, a, b, dy)
    da_scale, db_scale = (_col_scale(s, K, a, what) for s in (da_scale, db_scale))
    qa, qb = (torch.empty((M, K), dtype=torch.int8, device=a.device) for _ in range(2))
    tpr = silu_bwd_cols_sm90_route(K, a.dtype)
    ctas = row_walk_ctas(M, tpr, _sm_count(a.device), SILU_CTAS_PER_SM) if tpr else 0
    err = _build.library().qt_silu_mul_bwd_quant_colwise(
        a.data_ptr(), b.data_ptr(), dy.data_ptr(), da_scale.data_ptr(), db_scale.data_ptr(), qa.data_ptr(),
        qb.data_ptr(), M, K, _rows_per_block(M), eps, int(a.dtype == torch.bfloat16), int(sr), key, tpr, ctas,
        _build.stream(),
    )
    _build.check(err, what)
    _count_route(silu_mul_bwd_quant_colwise, sr, bool(tpr))
    return qa, qb


def layernorm_quant_rowwise(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, norm_eps: float = 1e-6,
                            eps: float = EPS, sr: bool = False, key: int | None = None, with_col_amax: bool = False):
    """B18, LayerNorm along rows: ``quantize(layer_norm_f32(x, g, b),
    axis=1)`` in one read of x [M, K]; outputs as
    :func:`rmsnorm_quant_rowwise`."""
    if x.device.type == "cpu":
        return layernorm_quant_plain(x, g, b, norm_eps=norm_eps, eps=eps, sr=sr, key=key, with_col_amax=with_col_amax)
    what = "layernorm_quant_rowwise"
    gf, bf = _gamma(g, x, what), _gamma(b, x, what, "beta")
    dt = int(x.dtype == torch.bfloat16)
    launch = lambda q, s, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_layernorm_quant_rowwise(
        x.data_ptr(), gf.data_ptr(), bf.data_ptr(), q, s, am, pt, M, K, rpb, norm_eps, eps, dt, int(sr),
        int(with_col_amax), k, tpr, ctas, _build.stream())
    return _rowwise(what, layernorm_quant_rowwise, launch, (x,), sr, key, with_col_amax,
                    layernorm_rows_sm90_route(x.shape[-1], x.dtype), layernorm_rows_ctas_per_sm(sr))


def layernorm_quant_colwise(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, norm_eps: float = 1e-6,
                            eps: float = EPS, sr: bool = False, key: int | None = None,
                            scale: torch.Tensor | None = None):
    """B18, LayerNorm along columns: ``quantize(layer_norm_f32(x, g, b),
    axis=0)`` given fp32 column scales [1, K] in one read of x, else in two;
    outputs as :func:`rmsnorm_quant_colwise`."""
    if x.device.type == "cpu":
        return layernorm_quant_plain(x, g, b, axis=0, norm_eps=norm_eps, eps=eps, sr=sr, key=key, scale=scale)
    what = "layernorm_quant_colwise"
    gf, bf = _gamma(g, x, what), _gamma(b, x, what, "beta")
    dt = int(x.dtype == torch.bfloat16)
    launch = lambda sc, q, so, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_layernorm_quant_colwise(
        x.data_ptr(), gf.data_ptr(), bf.data_ptr(), sc, q, so, am, pt, M, K, rpb, norm_eps, eps, dt, int(sr), k,
        tpr, ctas, _build.stream())
    tpr = layernorm_cols_sm90_route(x.shape[-1], x.dtype) if scale is not None else 0  # two passes: the first design
    return _colwise(what, layernorm_quant_colwise, launch, (x,), scale, eps, sr, key, tpr, LAYERNORM_CTAS_PER_SM)


def gelu_quant_rowwise(a: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None,
                       with_col_amax: bool = False):
    """B18, GELU along rows: ``quantize(gelu_f32(a), axis=1)`` in one read
    of a [M, K]; outputs as :func:`rmsnorm_quant_rowwise`."""
    if a.device.type == "cpu":
        return gelu_quant_plain(a, eps=eps, sr=sr, key=key, with_col_amax=with_col_amax)
    dt = int(a.dtype == torch.bfloat16)
    launch = lambda q, s, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_gelu_quant_rowwise(
        a.data_ptr(), q, s, am, pt, M, K, rpb, eps, dt, int(sr), int(with_col_amax), k, tpr, ctas, _build.stream())
    return _rowwise("gelu_quant_rowwise", gelu_quant_rowwise, launch, (a,), sr, key, with_col_amax,
                    gelu_rows_sm90_route(a.shape[-1], a.dtype), gelu_ctas_per_sm(a.shape[-1], a.dtype, sr))


def gelu_quant_colwise(a: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None,
                       scale: torch.Tensor | None = None):
    """B18, GELU along columns: ``quantize(gelu_f32(a), axis=0)``, given
    scales or two passes, as :func:`layernorm_quant_colwise`."""
    if a.device.type == "cpu":
        return gelu_quant_plain(a, axis=0, eps=eps, sr=sr, key=key, scale=scale)
    dt = int(a.dtype == torch.bfloat16)
    launch = lambda sc, q, so, am, pt, M, K, rpb, k, tpr, ctas: _build.library().qt_gelu_quant_colwise(
        a.data_ptr(), sc, q, so, am, pt, M, K, rpb, eps, dt, int(sr), k, tpr, ctas, _build.stream())
    tpr = gelu_cols_sm90_route(a.shape[-1], a.dtype) if scale is not None else 0  # two passes: the first design
    return _colwise("gelu_quant_colwise", gelu_quant_colwise, launch, (a,), scale, eps, sr, key, tpr,
                    gelu_ctas_per_sm(a.shape[-1], a.dtype, sr))


def layernorm_quant(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, axis: int = 1, norm_eps: float = 1e-6,
                    eps: float = EPS, sr: bool = False, key: int | None = None, with_col_amax: bool = False,
                    scale: torch.Tensor | None = None):
    """B18's LayerNorm entry, the JAX package's ``layernorm_quant`` (:918):
    x [M, K], g and b [K] or [1, K]. axis=1: ``(q, scale [M, 1])`` in one
    read, with ``with_col_amax`` also the column absmax [1, K]; axis=0:
    ``(q, scale [1, K])``, in one read given ``scale``, else in two."""
    if _axis(axis) == 1:
        return layernorm_quant_rowwise(x, g, b, norm_eps=norm_eps, eps=eps, sr=sr, key=key,
                                       with_col_amax=with_col_amax)
    return layernorm_quant_colwise(x, g, b, norm_eps=norm_eps, eps=eps, sr=sr, key=key, scale=scale)


def gelu_quant(a: torch.Tensor, *, axis: int = 1, eps: float = EPS, sr: bool = False, key: int | None = None,
               with_col_amax: bool = False, scale: torch.Tensor | None = None):
    """B18's GELU entry, the JAX package's ``gelu_quant`` (:952): the forms
    and returns of :func:`layernorm_quant`."""
    if _axis(axis) == 1:
        return gelu_quant_rowwise(a, eps=eps, sr=sr, key=key, with_col_amax=with_col_amax)
    return gelu_quant_colwise(a, eps=eps, sr=sr, key=key, scale=scale)


for _fn in (rmsnorm_quant_rowwise, rmsnorm_quant_colwise, silu_mul_quant_rowwise, silu_mul_quant_colwise,
            silu_mul_bwd_quant_rowwise, silu_mul_bwd_quant_colwise, layernorm_quant_rowwise,
            layernorm_quant_colwise, gelu_quant_rowwise, gelu_quant_colwise):
    _fn.launches = _fn.sr_launches = 0
    _fn.sm90_launches = _fn.sr_sm90_launches = 0  # the launches on the row walk
rmsnorm_bwd.launches = rmsnorm_bwd.sm90_launches = 0
