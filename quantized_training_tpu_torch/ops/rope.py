"""RoPE with the head grouping of grouped-query attention, and the int8
quantize of the attention output with its ungrouping.

Counterpart of ``quantized_training_tpu/ops/pallas_rope.py``:

- B13 :func:`rope_group_kernel` and :func:`rope_ungroup_kernel` for
  ``rope_group_kernel`` (:140) and ``rope_ungroup_kernel`` (:203): rotate-half
  RoPE (or, with ``inverse``, its transpose rot^T), or no rotation without
  tables, while the heads move between the projections' [B, S, H, hd] and
  attention's [B, KV, G, S, hd] (head h = kv * G + g);
- B14 :func:`ungroup_amax` and :func:`ungroup_quant` for ``ungroup_amax``
  (:334) and ``ungroup_quant`` (:365): the row and column absmax of the
  attention output's ungrouped [B * S, H * hd] view in one read, and that
  view's int8 given row or column scales, so the bf16 o-projection input
  never exists;

with the plain versions ``rope_group_ref``, ``rope_ungroup_ref``,
:func:`ungroup_amax_plain` and :func:`ungroup_quant_plain`,
:func:`pair_tables`, :func:`_supported_heads`, and the differentiable
:func:`rope_group`, :func:`group_heads` and :func:`ungroup_heads`
(``torch.autograd.Function``s whose backwards are the inverse kernel).

The rotation is y = x * c + rot(x) * s in fp32, every operation rounded once,
then rounded to x's dtype; the quantize is the Pallas bodies' (scale * (1/127)
of the absmax, a reciprocal multiply, round half to even; with ``sr``
floor(y * inv + u), u of element (r, c) the uniform at r * K + c of the key's
Philox stream, K = H * hd). The TPU kernels move lanes with selector matmuls
and need the grouped layout in memory; here a grouped tensor is any
[B, KV, G, S, hd] view with a unit hd stride and one stride per head, which
the kernels address through strides. :func:`rope_group_kernel` writes
[B, S, H, hd] memory and returns its grouped view: the layout PyTorch's
attention works in, so neither SDPA nor these kernels copy around it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel of
``csrc/rope.cu`` (whose header says what bounds it on the H100 and how its
design answers that) or raises. Each kernel is bit-exact with its plain
version, and counts its launches (``ungroup_quant``'s SR form apart, in
``sr_launches``). B14's kernels take the persistent row walk, redesigned
for the H100's memory system, wherever its layout leaves no lane idle
(:func:`ungroup_sm90_route`, decided here and passed to the C entry with the
grid), and count those launches again (``sm90_launches``,
``sr_sm90_launches``); other widths keep the first design.
"""

from __future__ import annotations

import torch

from . import _build, remat
from .fused_producers import EPS, _cast, _rows_per_block, _sm_count, row_walk_ctas
from .int8_quant import _count_route, _device_key, _key

_DTYPES = (torch.bfloat16, torch.float32)

# B14's row walks: the vectors a thread a row the route tries, in order
# (csrc/rope.cu::kUngroupVs: bf16 K 2048 takes 64 threads of four, B7's
# geometry), and the CTAs an SM their launch bounds keep resident
# (::kUngroupCtasPerSm)
UNGROUP_VECTORS = (4, 2, 1)
UNGROUP_CTAS_PER_SM = 2


# ---- tables, gates and layouts ---------------------------------------------------


def pair_tables(cos: torch.Tensor, sin: torch.Tensor, scale: float = 1.0):
    """[S, hd] rope tables -> pair-tiled fp32 [S, 2 * hd] with the scalar
    pre-scale folded in: the JAX kernels' input format (``:91-96``). The
    kernels here read the first hd columns of a table, so they take these or
    the [S, hd] tables themselves."""
    c = torch.cat([cos, cos], dim=-1).float() * scale
    s = torch.cat([sin, sin], dim=-1).float() * scale
    return c, s


def _supported_heads(H: int, G: int, hd: int, S: int = 0) -> bool:
    """The JAX kernels' admissibility (``:455-465``): head pairs (H even, G 1
    or even), hd % 64 and S % 8 for their tiles. ``attn_out_linear`` gates on
    it as the JAX package does; the CUDA kernels take any H, G and S."""
    return H % 2 == 0 and (G == 1 or G % 2 == 0) and hd % 64 == 0 and S % 8 == 0


def _grouped(x: torch.Tensor, kv: int) -> torch.Tensor:
    """[B, S, H, hd] -> the [B, KV, G, S, hd] view of the same memory."""
    B, S, H, hd = x.shape
    return x.view(B, S, kv, H // kv, hd).permute(0, 2, 3, 1, 4)


def _ungrouped(y: torch.Tensor) -> torch.Tensor:
    """[B, KV, G, S, hd] -> [B, S, H, hd] (a view where the strides allow)."""
    B, KV, G, S, hd = y.shape
    return y.permute(0, 3, 1, 2, 4).reshape(B, S, KV * G, hd)


def _grouped_strides(y: torch.Tensor, what: str) -> tuple[int, int, int]:
    """The (b, s, h) strides of a grouped [B, KV, G, S, hd] tensor: h = kv * G
    + g needs one stride per head."""
    B, KV, G, S, hd = y.shape
    sb, skv, sg, ss, _ = y.stride()
    if G == 1:
        sh = skv
    elif KV == 1 or skv == G * sg:
        sh = sg
    else:
        raise ValueError(f"{what}: heads of strides {y.stride()} are not one stride apart")
    return sb, ss, sh


def _check(what: str, t: torch.Tensor, shape_bshd, strides) -> None:
    """What the kernels take: a CUDA bf16/fp32 tensor addressed as [B, S, H,
    hd] through ``strides`` (b, s, h) with a unit hd stride, each stride a
    whole number of 16-byte vectors, hd two vectors at least, 16-byte
    aligned, fewer than 2**31 elements."""
    if not t.is_cuda:
        raise ValueError(f"{what}: needs a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not in {_DTYPES}")
    n = 16 // t.element_size()
    B, S, H, hd = shape_bshd
    if hd % (2 * n) or t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError(f"{what}: needs hd % {2 * n} == 0, a unit hd stride and 16-byte alignment, "
                         f"got shape {tuple(t.shape)}, strides {t.stride()}")
    if any(size > 1 and st % n for size, st in zip((B, S, H), strides)):
        raise ValueError(f"{what}: strides {t.stride()} are not whole 16-byte vectors")
    if B * S * H * hd >= 2**31:
        raise ValueError(f"{what}: {B * S * H * hd} elements exceed the kernels' 32-bit indexing")


def _tables(cos, sin, hd: int, like: torch.Tensor):
    """(cos ptr, sin ptr, row stride) of fp32 tables whose first hd columns
    are each position's values, or (None, None, 0) for no rotation."""
    if cos is None:
        return None, None, 0
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.device != like.device or t.shape[-1] < hd or t.stride(-1) != 1:
            raise ValueError(f"rope tables must be fp32 [S, >= {hd}] on {like.device} with unit column stride")
        if t.stride(0) % 4 or t.data_ptr() % 16:
            raise ValueError("rope tables must have 16-byte aligned rows")
    if cos.stride(0) != sin.stride(0):
        raise ValueError("rope tables must share one row stride")
    return cos.data_ptr(), sin.data_ptr(), cos.stride(0)


def _relayout(what, src, src_strides, dst, dst_strides, shape_bshd, cos, sin, inverse):
    B, S, H, hd = shape_bshd
    _check(what, src, shape_bshd, src_strides)
    _check(what, dst, shape_bshd, dst_strides)
    if cos is not None and cos.shape[0] < S:
        raise ValueError(f"{what}: rope tables of {cos.shape[0]} positions for S = {S}")
    c, s, ldt = _tables(cos, sin, hd, src)
    mode = 0 if cos is None else 2 if inverse else 1  # no rotation, rot, rot^T
    err = _build.library().qt_rope_relayout(
        src.data_ptr(), *src_strides, dst.data_ptr(), *dst_strides, c, s, ldt, B, S, H, hd, mode,
        int(src.dtype == torch.bfloat16), _build.stream())
    _build.check(err, what)


# ---- plain versions ------------------------------------------------------------------


def _rotate(x: torch.Tensor, cos, sin, inverse: bool) -> torch.Tensor:
    """x [B, S, H, hd] -> x * c + rot(x) * s in fp32 (rot^T with
    ``inverse``), rounded to x's dtype; no tables: a contiguous copy."""
    if cos is None:
        return x.clone(memory_format=torch.contiguous_format)
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    xf = x.float()
    if inverse:
        rot = torch.cat([xf[..., half:], -xf[..., :half]], dim=-1)
    else:
        rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    c = cos[:S, :hd].float()[None, :, None, :]
    s = sin[:S, :hd].float()[None, :, None, :]
    return (xf * c + rot * s).to(x.dtype)


def rope_group_ref(x: torch.Tensor, cos, sin, kv: int) -> torch.Tensor:
    """Plain version of B13's grouping (JAX :416-427): rotate-half rope of x
    [B, S, H, hd] from tables [S, hd] (pre-scaled; None: no rotation), then
    the grouped [B, KV, G, S, hd] view."""
    return _grouped(_rotate(x, cos, sin, inverse=False), kv)


def rope_ungroup_ref(y: torch.Tensor, cos, sin, *, inverse: bool = True) -> torch.Tensor:
    """Plain version of B13's ungrouping (JAX :430-442, whose ``kv`` y's
    shape holds): y [B, KV, G, S, hd] to [B, S, H, hd], then the (inverse)
    rotation; no tables: none."""
    return _rotate(_ungrouped(y), cos, sin, inverse)


def ungroup_amax_plain(y: torch.Tensor):
    """Plain version of B14's absmax: (row absmax fp32 [B, S, 1], column
    absmax fp32 [1, H * hd]) of the ungrouped [B * S, H * hd] view."""
    B, KV, G, S, hd = y.shape
    a = _ungrouped(y).reshape(B * S, KV * G * hd).float().abs()
    return a.amax(dim=1).reshape(B, S, 1), a.amax(dim=0).reshape(1, -1)


def ungroup_quant_plain(y: torch.Tensor, scale: torch.Tensor, *, axis: int, sr: bool = False,
                        key: int | None = None, eps: float = EPS) -> torch.Tensor:
    """Plain version of B14's quantize: the int8 [B, S, H * hd] of the
    ungrouped view with the fp32 row scales [B, S, 1] (axis 1) or column
    scales [1, H * hd] (axis 0)."""
    B, KV, G, S, hd = y.shape
    x2d = _ungrouped(y).reshape(B * S, KV * G * hd).float()
    s = scale.reshape(B * S, 1) if axis == 1 else scale.reshape(1, -1)
    return _cast(x2d, s.float(), eps, sr, _key(sr, key)).reshape(B, S, -1)


# ---- the kernels -----------------------------------------------------------------


def ungroup_sm90_route(K: int, hd: int, dtype) -> int:
    """The threads a row of B14's absmax and quantize on the persistent row
    walk (``csrc/rope.cu::ungroup_absmax_walk``, ``::ungroup_quant_walk``) at
    the ungrouped width K = H * hd, 0 for the first design: the first of
    ``UNGROUP_VECTORS`` 16-byte vectors a thread that tiles the row with 32,
    64, 128 or 256 threads (whole warps in groups that divide the block of
    256), each vector within one head (hd a whole number of vectors).
    Llama2-1B's bf16 K 2048 takes 64 threads of four vectors, fp32 128 of
    four."""
    n = 16 // dtype.itemsize
    if dtype not in _DTYPES or K % n or hd % n:
        return 0
    for v in UNGROUP_VECTORS:
        tpr = K // n // v
        if tpr * v * n == K and tpr in (32, 64, 128, 256):
            return tpr
    return 0


def _ungroup_route(y: torch.Tensor, strides) -> tuple[int, int]:
    """(threads a row, CTAs) of B14's walk on the grouped y, (0, 0) for the
    first design; also where a head's offset in a row, which the walk keeps
    in 32 bits, reaches 2**31 elements (views into a larger buffer)."""
    B, KV, G, S, hd = y.shape
    tpr = ungroup_sm90_route(KV * G * hd, hd, y.dtype)
    if not tpr or (KV * G - 1) * strides[2] + hd >= 2**31:
        return 0, 0
    return tpr, row_walk_ctas(B * S, tpr, _sm_count(y.device), UNGROUP_CTAS_PER_SM)


def rope_group_kernel(x: torch.Tensor, cos: torch.Tensor | None = None, sin: torch.Tensor | None = None, *,
                      kv: int) -> torch.Tensor:
    """B13, grouping: x [B, S, H, hd] with rotate-half rope from fp32
    tables (their first hd columns per position, pre-scale folded in; None:
    no rotation) -> [B, KV, G, S, hd], the grouped view of a new [B, S, H,
    hd] tensor. x may be any view with a unit hd stride."""
    if x.device.type == "cpu":
        return rope_group_ref(x, cos, sin, kv)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _relayout("rope_group", x, x.stride()[:3], out, out.stride()[:3], x.shape, cos, sin, inverse=False)
    rope_group_kernel.launches += 1
    return _grouped(out, kv)


def rope_ungroup_kernel(y: torch.Tensor, cos: torch.Tensor | None = None, sin: torch.Tensor | None = None, *,
                        inverse: bool = True) -> torch.Tensor:
    """B13, ungrouping: y [B, KV, G, S, hd], any view with a unit hd stride
    and one stride per head -> [B, S, H, hd] contiguous, with the rotation
    rot^T (``inverse``, the backward of :func:`rope_group_kernel`) or rot
    from the tables; None: no rotation."""
    if y.device.type == "cpu":
        return rope_ungroup_ref(y, cos, sin, inverse=inverse)
    B, KV, G, S, hd = y.shape
    out = torch.empty((B, S, KV * G, hd), dtype=y.dtype, device=y.device)
    _relayout("rope_ungroup", y, _grouped_strides(y, "rope_ungroup"), out, out.stride()[:3], out.shape, cos, sin,
              inverse=inverse)
    rope_ungroup_kernel.launches += 1
    return out


def ungroup_amax(y: torch.Tensor):
    """B14, absmax: grouped attention output y [B, KV, G, S, hd] -> (row
    absmax fp32 [B, S, 1], column absmax fp32 [1, H * hd]) of its ungrouped
    [B * S, H * hd] view, one read of y; the column maxima are folded over
    the blocks (on the row walk, one row of partials a CTA) in a fixed
    order."""
    if y.device.type == "cpu":
        return ungroup_amax_plain(y)
    B, KV, G, S, hd = y.shape
    H = KV * G
    strides = _grouped_strides(y, "ungroup_amax")
    _check("ungroup_amax", y, (B, S, H, hd), strides)
    M, K = B * S, H * hd
    row = torch.empty((B, S, 1), dtype=torch.float32, device=y.device)
    col = torch.empty((1, K), dtype=torch.float32, device=y.device)
    tpr, ctas = _ungroup_route(y, strides)
    parts = torch.empty((ctas or -(-M // _rows_per_block(M)), K), dtype=torch.float32, device=y.device)
    err = _build.library().qt_ungroup_amax(y.data_ptr(), *strides, B, S, H, hd, row.data_ptr(), col.data_ptr(),
                                           parts.data_ptr(), _rows_per_block(M), int(y.dtype == torch.bfloat16), tpr,
                                           ctas, _build.stream())
    _build.check(err, "ungroup_amax")
    _count_route(ungroup_amax, False, bool(tpr))
    return row, col


def ungroup_quant(y: torch.Tensor, scale: torch.Tensor, *, axis: int, sr: bool = False, key: int | None = None,
                  eps: float = EPS) -> torch.Tensor:
    """B14, quantize: grouped attention output y [B, KV, G, S, hd] -> int8
    [B, S, H * hd] of its ungrouped view, given the fp32 row scales [B, S, 1]
    (axis 1) or column scales [1, H * hd] (axis 0), one read of y; with
    ``sr`` rounding stochastically from ``key``."""
    if y.device.type == "cpu":
        return ungroup_quant_plain(y, scale, axis=axis, sr=sr, key=key, eps=eps)
    key = _device_key(sr, key, "ungroup_quant")
    B, KV, G, S, hd = y.shape
    H = KV * G
    if axis not in (0, 1):
        raise ValueError(f"ungroup_quant: axis {axis}")
    n = B * S if axis == 1 else H * hd
    if scale.numel() != n or scale.dtype != torch.float32 or scale.device != y.device:
        raise ValueError(f"ungroup_quant: scale must be fp32 with {n} elements on {y.device}")
    scale = scale.contiguous()
    strides = _grouped_strides(y, "ungroup_quant")
    _check("ungroup_quant", y, (B, S, H, hd), strides)
    q = torch.empty((B, S, H * hd), dtype=torch.int8, device=y.device)
    tpr, ctas = _ungroup_route(y, strides)
    err = _build.library().qt_ungroup_quant(y.data_ptr(), *strides, B, S, H, hd, scale.data_ptr(), q.data_ptr(),
                                            _rows_per_block(B * S), axis, eps, int(y.dtype == torch.bfloat16),
                                            int(sr), key, tpr, ctas, _build.stream())
    _build.check(err, "ungroup_quant")
    _count_route(ungroup_quant, sr, bool(tpr))
    return q


rope_group_kernel.launches = rope_ungroup_kernel.launches = ungroup_amax.launches = 0
ungroup_amax.sm90_launches = 0  # the launches on the row walk
ungroup_quant.launches = ungroup_quant.sr_launches = ungroup_quant.sm90_launches = ungroup_quant.sr_sm90_launches = 0


# ---- differentiable wrappers (tables [S, hd]) -------------------------------------


class _RopeGroup(torch.autograd.Function):
    """[B, S, H, hd] -> rope -> [B, KV, G, S, hd] (JAX ``rope_group``,
    :473-501); the backward is the inverse kernel, rot^T and ungrouping. The
    tables carry any scalar pre-scale and get no gradient."""

    @staticmethod
    def forward(ctx, x, cos, sin, kv):
        ctx.save_for_backward(cos, sin)
        if remat.skips():  # the replay of a given q or k: its backward reads no value
            return _grouped(remat.unread_like(x), kv)
        return rope_group_kernel(x, cos, sin, kv=kv)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        return rope_ungroup_kernel(dy, cos, sin, inverse=True), None, None, None


class _GroupHeads(torch.autograd.Function):
    """[B, S, H, hd] -> [B, KV, G, S, hd] without rotation (JAX
    ``group_heads``, :508-534: v, and the o-projection's cotangent)."""

    @staticmethod
    def forward(ctx, x, kv):
        if remat.skips():  # the replay of a given v
            return _grouped(remat.unread_like(x), kv)
        return rope_group_kernel(x, kv=kv)

    @staticmethod
    def backward(ctx, dy):
        return rope_ungroup_kernel(dy), None


class _UngroupHeads(torch.autograd.Function):
    """[B, KV, G, S, hd] -> [B, S, H, hd] without rotation (JAX
    ``ungroup_heads``, :537-562: the attention output into an unfused
    o-projection)."""

    @staticmethod
    def forward(ctx, y, kv):
        ctx.kv = kv
        return rope_ungroup_kernel(y)

    @staticmethod
    def backward(ctx, dx):
        return rope_group_kernel(dx, kv=ctx.kv), None


def rope_group(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, kv: int) -> torch.Tensor:
    """Differentiable rope + grouping: x [B, S, H, hd], fp32 tables [S, hd]
    (pre-scaled) -> [B, KV, G, S, hd]."""
    return _RopeGroup.apply(x, cos.float(), sin.float(), kv)


def group_heads(x: torch.Tensor, kv: int) -> torch.Tensor:
    """Differentiable grouping: [B, S, H, hd] -> [B, KV, G, S, hd]."""
    return _GroupHeads.apply(x, kv)


def ungroup_heads(y: torch.Tensor, kv: int) -> torch.Tensor:
    """Differentiable ungrouping: [B, KV, G, S, hd] -> [B, S, H, hd]."""
    return _UngroupHeads.apply(y, kv)
