"""Producer-fused int8 quantize kernels and the RMSNorm backward.

Counterpart of ``quantized_training_tpu/ops/pallas_fused.py`` (:63-760):

- B7 :func:`rmsnorm_quant_rowwise` for ``rmsnorm_quant_rowwise`` (:154);
- B8 :func:`rmsnorm_quant_colwise` for ``rmsnorm_quant_colwise`` (:246);
- B9 :func:`silu_mul_quant_rowwise` and :func:`silu_mul_quant_colwise` for
  ``silu_mul_quant_rowwise`` (:325) and ``silu_mul_quant_colwise`` (:409);
- B10 :func:`rmsnorm_bwd` for ``rmsnorm_bwd`` (:491);

with the producers' plain semantics (``rms_norm_f32``, ``silu_mul_f32``,
``rms_norm_ref``, ``silu_mul_ref``), one plain version per kernel and
:func:`supported`. The producer runs inside the quantize: its output is
fp32 and never rounded to bf16. The quantize has the Pallas bodies'
numerics (``pallas_fused.py:111-132``, ``pallas_quant.py:75-87``), which
differ from ``quant/core.py``'s: scale = absmax * (1/127) in fp32 and
q = round-half-even(y * (1 / max(scale, eps))), a reciprocal multiply; with
``sr`` floor(y * inv + u), u of element (r, c) the uniform at r * K + c of
the key's Philox stream (``ops/random.py``). Scales and column maxima are
fp32, as the Pallas kernels return them.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel of
``csrc/fused_producers.cu`` (whose header says what bounds it on the H100
and how its design answers that) or raises. Each wrapper counts its
launches, an SR form apart (``sr_launches``). B9 is bit-exact with its plain
version on the card. B7, B8 and B10 hold a row sum, which the kernel takes
in its own order: their int8 outputs may differ by one step on rare
elements, their scales, maxima, dx and dgamma by fp32 rounding.
"""

from __future__ import annotations

import torch

from . import _build, random
from .int8_quant import _check_device_input, _count, _key

EPS = 1e-12
_DTYPES = (torch.bfloat16, torch.float32)
# every kernel keeps two fp32 rows of K (the producer's row and the column
# maxima or reciprocal scales) in one block's shared memory, at most 227 KB
MAX_K = 227 * 1024 // 8


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


# ---- the quantize of the Pallas bodies ------------------------------------------


def _inv127(t: torch.Tensor) -> torch.Tensor:
    return t.new_full((), 1.0 / 127.0, dtype=torch.float32)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """amax * (1/127) in fp32 (``pallas_fused.py:118``)."""
    return amax * _inv127(amax)


def _cast(y: torch.Tensor, scale: torch.Tensor, eps: float, sr: bool, key: int | None) -> torch.Tensor:
    """int8 of fp32 y [M, K] with a broadcast fp32 scale: y times the IEEE
    reciprocal of max(scale, eps), rounded half to even, or with ``sr``
    floor(. + u) from the stream of ``key``, clamped."""
    s = scale.clamp(min=eps)
    q = y * (torch.ones_like(s) / s)
    q = torch.floor(q + random.uniform(key, y.shape, y.device)) if sr else torch.round(q)
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


def rmsnorm_bwd_plain(x, g, dy, *, norm_eps: float = 1e-5):
    """Plain version of B10, the closed form of ``quant/fused.py::
    _rmsnorm_bwd_math``: ``(dx in x's dtype, dgamma fp32 [K])``."""
    xf, dyf = x.float(), dy.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + norm_eps)
    xn = xf * rstd
    dxn = dyf * g.float()
    dx = (dxn - xn * (dxn * xn).mean(dim=-1, keepdim=True)) * rstd
    return dx.to(x.dtype), (dyf * xn).sum(dim=0)


# ---- the shape gate -------------------------------------------------------------


def supported(M: int, K: int, dtype, n_inputs: int = 1) -> bool:
    """Whether the fused kernels take [M, K] inputs of ``dtype``: the
    reference's conditions (``pallas_fused.py:750-760``): bf16 or fp32,
    M >= 32 and a multiple of 32 (its row blocks), K >= 128 and a multiple
    of 128; its VMEM budget becomes this kernel's shared-memory bound, K <=
    ``MAX_K``. ``n_inputs`` is the reference's argument, which only its
    VMEM budget reads."""
    del n_inputs
    return dtype in _DTYPES and M >= 32 and M % 32 == 0 and 128 <= K <= MAX_K and K % 128 == 0


# ---- wrappers -------------------------------------------------------------------


def _rows_per_block(M: int) -> int:
    """Rows per block: about four blocks per SM of the H100's 132, at most
    16 rows, so that a run of rows shares one row of the per-block column
    maxima or dgamma sums."""
    return max(1, min(16, M // 528))


def _parts(M: int, K: int, device, needed: bool = True) -> torch.Tensor:
    """fp32 scratch for the per-block column maxima or sums, [blocks, K]."""
    return torch.empty((-(-M // _rows_per_block(M)), K) if needed else (0,), dtype=torch.float32, device=device)


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


def _gamma(g: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    if g.numel() != x.shape[1] or g.device != x.device:
        raise ValueError(f"{what}: gamma of {g.numel()} elements on {g.device} for rows of {x.shape[1]}")
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
    key = _key(sr, key)
    M, K = _check("rmsnorm_quant_rowwise", x)
    gf = _gamma(g, x, "rmsnorm_quant_rowwise")
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    amax = torch.empty((1, K) if with_col_amax else (0,), dtype=torch.float32, device=x.device)
    parts = _parts(M, K, x.device, with_col_amax)
    err = _build.library().qt_rmsnorm_quant_rowwise(
        x.data_ptr(), gf.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(), parts.data_ptr(), M, K,
        _rows_per_block(M),
        norm_eps, eps, int(x.dtype == torch.bfloat16), int(sr), int(with_col_amax), key, _build.stream(),
    )
    _build.check(err, "rmsnorm_quant_rowwise")
    _count(rmsnorm_quant_rowwise, sr)
    return (q, scale, amax) if with_col_amax else (q, scale)


def silu_mul_quant_rowwise(a: torch.Tensor, b: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                           key: int | None = None, with_col_amax: bool = False):
    """B9, row form: ``quantize(silu_mul_f32(a, b), axis=1)`` reading a and
    b [M, K] once; outputs as :func:`rmsnorm_quant_rowwise`."""
    if a.device.type == "cpu":
        return silu_mul_quant_rowwise_plain(a, b, eps=eps, sr=sr, key=key, with_col_amax=with_col_amax)
    key = _key(sr, key)
    M, K = _check("silu_mul_quant_rowwise", a, b)
    q = torch.empty((M, K), dtype=torch.int8, device=a.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=a.device)
    amax = torch.empty((1, K) if with_col_amax else (0,), dtype=torch.float32, device=a.device)
    parts = _parts(M, K, a.device, with_col_amax)
    err = _build.library().qt_silu_mul_quant_rowwise(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(), parts.data_ptr(), M, K,
        _rows_per_block(M),
        eps, int(a.dtype == torch.bfloat16), int(sr), int(with_col_amax), key, _build.stream(),
    )
    _build.check(err, "silu_mul_quant_rowwise")
    _count(silu_mul_quant_rowwise, sr)
    return (q, scale, amax) if with_col_amax else (q, scale)


def _colwise(what, fn, launch, inputs, scale, eps, sr, key):
    """Launch the column form of B8 or B9: given scales, or two passes."""
    key = _key(sr, key)
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
    ptr = lambda t: None if t is None else t.data_ptr()
    err = launch(ptr(scale), q.data_ptr(), ptr(s_out), ptr(amax), ptr(parts), M, K, _rows_per_block(M), key)
    _build.check(err, what)
    _count(fn, sr)
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
    launch = lambda sc, q, so, am, pt, M, K, rpb, k: _build.library().qt_rmsnorm_quant_colwise(
        x.data_ptr(), gf.data_ptr(), sc, q, so, am, pt, M, K, rpb, norm_eps, eps, dt, int(sr), k, _build.stream())
    return _colwise("rmsnorm_quant_colwise", rmsnorm_quant_colwise, launch, (x,), scale, eps, sr, key)


def silu_mul_quant_colwise(a: torch.Tensor, b: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                           key: int | None = None, scale: torch.Tensor | None = None):
    """B9, column form: ``quantize(silu_mul_f32(a, b), axis=0)``, given
    scales or two passes, as :func:`rmsnorm_quant_colwise`."""
    if a.device.type == "cpu":
        return silu_mul_quant_colwise_plain(a, b, eps=eps, sr=sr, key=key, scale=scale)
    dt = int(a.dtype == torch.bfloat16)
    launch = lambda sc, q, so, am, pt, M, K, rpb, k: _build.library().qt_silu_mul_quant_colwise(
        a.data_ptr(), b.data_ptr(), sc, q, so, am, pt, M, K, rpb, eps, dt, int(sr), k, _build.stream())
    return _colwise("silu_mul_quant_colwise", silu_mul_quant_colwise, launch, (a, b), scale, eps, sr, key)


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, *, norm_eps: float = 1e-5):
    """B10: the RMSNorm backward in one read of x and dy [M, K]: ``(dx in
    x's dtype [M, K], dgamma fp32 [K])``. dgamma is summed per block, then
    over the blocks in order: a function of the inputs, run after run."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, g, dy, norm_eps=norm_eps)
    M, K = _check("rmsnorm_bwd", x, dy)
    gf = _gamma(g, x, "rmsnorm_bwd")
    dx = torch.empty_like(x)
    dg = torch.empty(K, dtype=torch.float32, device=x.device)
    dg_part = _parts(M, K, x.device)
    err = _build.library().qt_rmsnorm_bwd(
        x.data_ptr(), gf.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg.data_ptr(), dg_part.data_ptr(), M, K,
        _rows_per_block(M),
        norm_eps, int(x.dtype == torch.bfloat16), _build.stream(),
    )
    _build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dg


for _fn in (rmsnorm_quant_rowwise, rmsnorm_quant_colwise, silu_mul_quant_rowwise, silu_mul_quant_colwise):
    _fn.launches = _fn.sr_launches = 0
rmsnorm_bwd.launches = 0
