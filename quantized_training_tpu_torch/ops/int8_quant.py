"""Int8 quantize kernels and their plain versions.

Counterparts of ``quantized_training_tpu/ops/pallas_quant.py``:

- K1 :func:`quantize_int8_rowwise` for ``quantize_int8_rowwise`` (:139),
  on the persistent row walk where :func:`rowwise_sm90_route` gives its
  threads a row (every weight and training or prefill activation of the
  Llama2-1B and ViT-Giant paths);
- B4 :func:`quantize_int8_colwise` for ``quantize_int8_colwise`` (:229),
  in one launch on thread-block clusters where :func:`colwise_sm90_route`
  gives a geometry (every weight of the Llama2-1B and ViT-Giant steps);
- B5 :func:`quantize_int8_both` for ``quantize_int8_both`` (:306).

Under a mesh each splits into its two mesh forms (no Pallas counterpart:
JAX's sharded step is one program, whose maxima XLA takes over the whole
axis): a maxima form, which returns each row's or column's max |x| in fp32
and casts nothing, and a given-maxima form, which casts from maxima the
caller all-reduced (``quant/core.py``, ``parallel/collectives.py``):
:func:`quantize_int8_rowwise_maxima` / :func:`quantize_int8_rowwise_given`
(K1's kernels, on its routes), :func:`quantize_int8_colwise_maxima` (B4's
first design's maxima kernel) and :func:`quantize_int8_both_maxima` (B5's
row pass with its column maxima), each column route's given form one,
:func:`quantize_int8_colwise_given` (B5's column cast). Given the global tensor's
maxima, a rank's output is its rows (or columns) of the whole quantize of
the global tensor, bit for bit; the plain versions are
:func:`quantize_int8_maxima_plain` and :func:`quantize_int8_plain` with
``amax``. Each form counts its launches apart.

All three have the numerics of ``quantized_training_tpu/quant/core.py::
quantize_int8`` (:99-115), which each kernel matches bit for bit. Each takes
``sr`` and ``key``: with ``sr`` it rounds stochastically, floor(x / scale +
u), where u of element (r, c) is the uniform at the row-major index r * C +
c of the key's Philox stream (``ops/random.py``), the SR forms of the
Pallas kernels (``pallas_quant.py:98-106, :220-225, :276-302``). The SR
forms are bit-exact with their plain versions too, and count their
launches apart (``sr_launches``). The CUDA source is
``csrc/int8_quant.cu``; its header says what bounds the kernels on the H100
and how their design answers that.
"""

from __future__ import annotations

import functools

import torch

from . import _build, random

EPS = 1e-12
_DTYPES = (torch.bfloat16, torch.float32)


def _key(sr: bool, key: int | None) -> int:
    """The key an SR call draws from (0, unused, without SR)."""
    if not sr:
        return 0
    if key is None:
        raise ValueError("stochastic rounding requires a key")
    return key


def _device_key(sr: bool, key: int | None, what: str) -> int:
    """:func:`_key` on a kernel's path: an SR launch refuses a CUDA graph
    capture (``_build.refuse_capture``)."""
    key = _key(sr, key)
    if sr:
        _build.refuse_capture(what)
    return key


def quantize_int8_maxima_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The fp32 max |x| along ``axis``, keepdims (taken in x's dtype, exact):
    the plain version of the maxima forms."""
    return x.abs().amax(dim=axis, keepdim=True).float()


def quantize_int8_plain(x: torch.Tensor, *, axis: int = -1, eps: float = EPS, sr: bool = False,
                        key: int | None = None, amax: torch.Tensor | None = None):
    """``quant/core.py:99-115`` in torch: absmax along ``axis`` (taken in x's
    dtype, exact), scale = absmax / 127 in fp32, q = round-half-even(x /
    max(scale, eps)), or with ``sr`` floor(x / max(scale, eps) + u) with u
    from the stream of ``key``, clipped to int8; the scale is returned in
    x's dtype, keepdims. ``amax``: given fp32 maxima (broadcastable, keepdims)
    in place of x's own, the plain version of the given-maxima forms."""
    key = _key(sr, key)
    absmax = quantize_int8_maxima_plain(x, axis) if amax is None else amax.float().reshape(
        [1 if d == axis % x.ndim else n for d, n in enumerate(x.shape)])
    # divide by a tensor: PyTorch's CUDA kernels turn division by a Python
    # scalar into a multiply by its reciprocal, which is not IEEE division
    scale = absmax / absmax.new_full((), 127.0)
    q = x.float() / scale.clamp(min=eps)
    q = torch.floor(q + random.uniform(key, x.shape, x.device)) if sr else torch.round(q)
    return q.clamp(-128, 127).to(torch.int8), scale.to(x.dtype)


def quantize_int8_both_plain(x: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None):
    """Plain version of B5: the row and the column quantize of x [M, K],
    ``(q_row, s_row [M, 1], q_col, s_col [1, K])``; with ``sr`` the row
    quantize draws from ``split(key)[0]`` and the column one from
    ``split(key)[1]`` (``quant/core.py:167``)."""
    kr, kc = random.split(_key(sr, key)) if sr else (None, None)
    return (*quantize_int8_plain(x, axis=1, eps=eps, sr=sr, key=kr),
            *quantize_int8_plain(x, axis=0, eps=eps, sr=sr, key=kc))


def _count(fn, sr: bool) -> None:
    if sr:
        fn.sr_launches += 1
    else:
        fn.launches += 1


def _count_route(fn, sr: bool, sm90: bool) -> None:
    """Count a launch per form, and on its redesigned route again."""
    _count(fn, sr)
    if sm90 and sr:
        fn.sr_sm90_launches += 1
    elif sm90:
        fn.sm90_launches += 1


def _check_device_input(x: torch.Tensor, what: str, ndim: int | None = None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: needs a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not in {_DTYPES}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if ndim is not None and (x.ndim != ndim or x.numel() == 0):
        raise ValueError(f"{what}: needs a non-empty {ndim}-D tensor, got shape {tuple(x.shape)}")


# ---- the persistent row walk (K1 here; B7-B11, B14 and B18 in
# fused_producers.py and rope.py) ------------------------------------------

_CTA = 256  # the row kernels' block (csrc/row_common.cuh::kThreads)


def row_walk_ctas(M: int, tpr: int, sms: int, per_sm: int) -> int:
    """CTAs of a row walk of M rows at ``tpr`` threads a row: a block of
    max(tpr, 256) threads, its groups one row each at a time, at most
    ``per_sm`` blocks on each of ``sms`` SMs."""
    return min(-(-M // (max(tpr, _CTA) // tpr)), per_sm * sms)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# K1's row walk (csrc/int8_quant.cu::quantize_rows_walk): the vectors a
# thread a row it tries, in order, with the largest CTA each has (its launch
# bounds, row_walk_max_cta), and the CTAs an SM it keeps (kRowWalkCtasPerSm).
# Rows below ROWWISE_MIN_K elements (the KV rows of 64) keep the first
# design. So does the SR form, whose Philox words make it bound by integer
# work, at three or four vectors a thread below ROWWISE_SR_MIN_ROWS rows
# (there the walk's grid is under two CTAs an SM, and a thread draws the
# words of four vectors in turn where the first design's draws one's) and
# at two vectors a thread above ROWWISE_SR_MAX_ROWS_TWO (704 threads an SM,
# where the first design keeps more warps in flight): the first design
# measured faster there
ROWWISE_VECTORS = {4: 256, 3: 256, 2: 384}
ROWWISE_CTAS_PER_SM = 2
ROWWISE_MIN_K = 1024
ROWWISE_SR_MIN_ROWS = 512
ROWWISE_SR_MAX_ROWS_TWO = 2048


def rowwise_sm90_route(M: int, K: int, dtype, sr: bool = False) -> int:
    """The threads a row of K1 (its SR form with ``sr``) on the persistent
    row walk (``csrc/int8_quant.cu::quantize_rows_walk``), 0 for the first
    design (``quantize_rows_block`` / ``quantize_rows_warp``): rows of at
    least ``ROWWISE_MIN_K`` elements that are a whole number of 16-byte
    vectors (for the SR form at three or four vectors a thread from
    ``ROWWISE_SR_MIN_ROWS`` rows, at two up to ``ROWWISE_SR_MAX_ROWS_TWO``), at the
    first of ``ROWWISE_VECTORS`` vectors a thread that tiles the row with
    whole warps in a group that divides the block of 256 or is the block (up
    to the kernel's largest): bf16 K 2048 (the Llama2-1B weights' q/o, k/v,
    gate/up) takes 64 threads of four vectors, K 5632 (down) 352 of two,
    ViT-Giant's 1536 64 of three and 6144 256 of three; fp32 K 2048 128 of
    four. On the H100 the walk measured faster than the first design at
    every shape it takes, a decode step's 8 activation rows included
    (``chip_smoke.py``, PERF.md)."""
    n = 16 // dtype.itemsize
    if M < 1 or K < ROWWISE_MIN_K or K % n:
        return 0
    nv = K // n
    for v, max_cta in ROWWISE_VECTORS.items():
        tpr = nv // v
        if tpr * v == nv and tpr % 32 == 0 and (_CTA % tpr == 0 or _CTA < tpr <= max_cta):
            off = M > ROWWISE_SR_MAX_ROWS_TWO if v == 2 else M < ROWWISE_SR_MIN_ROWS
            return 0 if sr and off else tpr
    return 0


def quantize_int8_rowwise(x: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None):
    """x [..., K] -> (q int8 [..., K], scale x.dtype [..., 1]), reducing the
    last axis, rounding stochastically from ``key`` with ``sr``. A CPU tensor
    takes :func:`quantize_int8_plain`; a CUDA tensor (bf16 or fp32,
    contiguous) launches K1, or its SR form, on the current stream: on the
    persistent row walk where :func:`rowwise_sm90_route` gives its threads a
    row and x starts on a 16-byte boundary (counted again in
    ``sm90_launches``, ``sr_sm90_launches``), else the first design."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, eps=eps, sr=sr, key=key)
    key = _device_key(sr, key, "quantize_int8_rowwise")
    _check_device_input(x, "quantize_int8_rowwise")
    if x.ndim == 0:
        raise ValueError("quantize_int8_rowwise: x must have a last axis")
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    tpr = rowwise_sm90_route(M, K, x.dtype, sr) if x.data_ptr() % 16 == 0 else 0
    ctas = row_walk_ctas(M, tpr, _sm_count(x.device), ROWWISE_CTAS_PER_SM) if tpr else 0
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    err = _build.library().qt_quantize_int8_rowwise(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K, eps,
        int(x.dtype == torch.bfloat16), int(sr), key, tpr, ctas, _build.stream(),
    )
    _build.check(err, "quantize_int8_rowwise")
    _count_route(quantize_int8_rowwise, sr, bool(tpr))
    return q, scale


quantize_int8_rowwise.launches = quantize_int8_rowwise.sr_launches = 0
quantize_int8_rowwise.sm90_launches = quantize_int8_rowwise.sr_sm90_launches = 0


# B4's cluster form (csrc/int8_quant.cu::quantize_cols_cluster), on the
# H100. Its kernel's constants, which tests/test_torch_colwise_route.py
# holds to the source: CTAs a cluster (the portable size; kernel, at most
# 8); a CTA's threads (kClusterThreads), the CTAs an SM its launch bounds
# keep (kClusterCtasPerSm), its static shared memory (kClusterStatic: 10
# rows of kClusterMaxStrip vectors) and the largest tile it takes
# (kClusterMaxTile, bytes of dynamic shared memory). The card's: strip
# widths in vectors, narrowest first; an SM's shared memory, with the 1 KB
# the runtime reserves a CTA; the SMs that clusters of 8 reach (120 of the
# 132: cudaOccupancyMaxActiveClusters gives 15 clusters at one CTA an SM);
# and the cost model's fixed time of a wave and an SM's share of HBM's rate
CLUSTER_CTAS = 8
_CTA_THREADS = 256
_CTAS_PER_SM = 3
_CTA_STATIC = (_CTA_THREADS // 32 + 2) * 16 * 16
_CLUSTER_MAX_TILE = 222 * 1024
_STRIP_VECTORS = (4, 8, 16)
_SM_SHARED = 228 * 1024
_CLUSTER_SMS = 120
_WAVE_US = 5.0
_SM_BYTES_PER_US = 3.35e12 / 132 / 1e6


def _cluster_cost(R: int, nv: int, sv: int) -> float | None:
    """The modelled time of the cluster form at strips of ``sv`` vectors, in
    us: a fixed cost a wave of resident CTAs, and the bytes of the busiest
    SM (the CTAs spread evenly over the SMs, a tile each) at its share of
    HBM's rate; None where the tile does not fit."""
    tile = -(-R // CLUSTER_CTAS) * sv * 16
    if tile > _CLUSTER_MAX_TILE:
        return None
    per_sm = min(_SM_SHARED // (tile + _CTA_STATIC + 1024), _CTAS_PER_SM)
    ctas = -(-nv // sv) * CLUSTER_CTAS
    waves = -(-ctas // (per_sm * _CLUSTER_SMS))
    return waves * _WAVE_US + -(-ctas // _CLUSTER_SMS) * tile / _SM_BYTES_PER_US


def colwise_sm90_route(R: int, C: int, dtype) -> tuple[int, int] | int:
    """The geometry of B4's cluster form for x [R, C] of ``dtype``
    (``csrc/int8_quant.cu::quantize_cols_cluster``): ``(strip vectors,
    cluster CTAs)``, or 0 for the first design. C must be a whole number of
    16-byte vectors; a cluster of ``CLUSTER_CTAS`` takes a strip of ``strip
    vectors`` vectors of every row, each CTA ceil(R / 8) rows of it in
    shared memory. Of the strips of 4, 8 and 16 vectors whose tile fits,
    the one ``_cluster_cost`` models fastest, the narrowest on a tie (more
    SMs pulling bytes); taller inputs keep the first design. On the H100
    it picks the fastest strip, or the fastest of RN and SR together, at
    every shape the Llama2-1B and ViT-Giant steps launch B4 at
    (ab_sm90_forms.py's sweep, PERF.md)."""
    n = 16 // dtype.itemsize
    if R < 1 or C < 1 or C % n:
        return 0
    best, route = None, 0
    for sv in _STRIP_VECTORS:
        cost = _cluster_cost(R, C // n, sv)
        if cost is not None and (best is None or cost < best):
            best, route = cost, (sv, CLUSTER_CTAS)
    return route


def quantize_int8_colwise(x: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None):
    """x [R, C] -> (q int8 [R, C], scale x.dtype [1, C]), reducing the first
    axis, rounding stochastically from ``key`` with ``sr``. A CPU tensor
    takes ``quantize_int8_plain(x, axis=0)``; a CUDA tensor (bf16 or fp32,
    contiguous, non-empty) launches B4, or its SR form, on the current
    stream: in one launch on thread-block clusters where
    :func:`colwise_sm90_route` gives a geometry and x starts on a 16-byte
    boundary (counted again in ``sm90_launches``, ``sr_sm90_launches``),
    else the first design (a memset and two kernels)."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, axis=0, eps=eps, sr=sr, key=key)
    key = _device_key(sr, key, "quantize_int8_colwise")
    _check_device_input(x, "quantize_int8_colwise", ndim=2)
    R, C = x.shape
    route = colwise_sm90_route(R, C, x.dtype) if x.data_ptr() % 16 == 0 else 0
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty((1, C), dtype=x.dtype, device=x.device)
    amax = torch.empty(0 if route else C, dtype=torch.float32, device=x.device)
    err = _build.library().qt_quantize_int8_colwise(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(), R, C, eps,
        int(x.dtype == torch.bfloat16), int(sr), key, *(route or (0, 0)), _build.stream(),
    )
    _build.check(err, "quantize_int8_colwise")
    _count_route(quantize_int8_colwise, sr, bool(route))
    return q, scale


quantize_int8_colwise.launches = quantize_int8_colwise.sr_launches = 0
quantize_int8_colwise.sm90_launches = quantize_int8_colwise.sr_sm90_launches = 0

# B5 keeps a row of column maxima in one block's shared memory: K fp32 values
# within the 227 KB a block may use
_BOTH_MAX_K = 227 * 1024 // 4


def quantize_int8_both(x: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None):
    """x [M, K] -> ``(q_row, s_row [M, 1], q_col, s_col [1, K])``: the row
    and the column quantize of one tensor in two reads, with ``sr`` each
    from its own key of ``split(key)``. A CPU tensor takes
    :func:`quantize_int8_both_plain`; a CUDA tensor (bf16 or fp32,
    contiguous, non-empty, K <= 58112) launches B5, or its SR form, on the
    current stream."""
    if x.device.type == "cpu":
        return quantize_int8_both_plain(x, eps=eps, sr=sr, key=key)
    key_row, key_col = random.split(_device_key(sr, key, "quantize_int8_both")) if sr else (0, 0)
    _check_device_input(x, "quantize_int8_both", ndim=2)
    M, K = x.shape
    if K > _BOTH_MAX_K:
        raise ValueError(f"quantize_int8_both: K = {K} exceeds {_BOTH_MAX_K} (shared memory)")
    q_row = torch.empty((M, K), dtype=torch.int8, device=x.device)
    q_col = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s_row = torch.empty((M, 1), dtype=x.dtype, device=x.device)
    s_col = torch.empty((1, K), dtype=x.dtype, device=x.device)
    amax = torch.empty(K, dtype=torch.float32, device=x.device)
    err = _build.library().qt_quantize_int8_both(
        x.data_ptr(), q_row.data_ptr(), s_row.data_ptr(), q_col.data_ptr(), s_col.data_ptr(),
        amax.data_ptr(), M, K, eps, int(x.dtype == torch.bfloat16), int(sr), key_row, key_col,
        _build.stream(),
    )
    _build.check(err, "quantize_int8_both")
    _count(quantize_int8_both, sr)
    return q_row, s_row, q_col, s_col


quantize_int8_both.launches = quantize_int8_both.sr_launches = 0


# ---- the mesh forms ----------------------------------------------------------


def _given_amax(x: torch.Tensor, amax: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if amax.dtype != torch.float32 or amax.numel() != n or amax.device != x.device:
        raise ValueError(f"{what}: amax must be {n} fp32 values on {x.device}, got {tuple(amax.shape)} "
                         f"{amax.dtype} on {amax.device}")
    return amax.contiguous()


def quantize_int8_rowwise_maxima(x: torch.Tensor) -> torch.Tensor:
    """K1's maxima form: x [..., K] -> fp32 [..., 1], each row's max |x|.
    A CPU tensor takes :func:`quantize_int8_maxima_plain`; a CUDA tensor
    launches K1's kernel without its cast, on the route K1 takes."""
    if x.device.type == "cpu":
        return quantize_int8_maxima_plain(x, -1)
    _check_device_input(x, "quantize_int8_rowwise_maxima")
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    tpr = rowwise_sm90_route(M, K, x.dtype) if x.data_ptr() % 16 == 0 else 0
    ctas = row_walk_ctas(M, tpr, _sm_count(x.device), ROWWISE_CTAS_PER_SM) if tpr else 0
    amax = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    err = _build.library().qt_quantize_int8_rowwise_maxima(
        x.data_ptr(), amax.data_ptr(), M, K, int(x.dtype == torch.bfloat16), tpr, ctas, _build.stream())
    _build.check(err, "quantize_int8_rowwise_maxima")
    _count_route(quantize_int8_rowwise_maxima, False, bool(tpr))
    return amax


def quantize_int8_rowwise_given(x: torch.Tensor, amax: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                                key: int | None = None):
    """K1's given-maxima form: x [..., K] and the rows' fp32 maxima ->
    (q int8 [..., K], scale x.dtype [..., 1]), q and scale those of K1 on a
    tensor whose rows have these maxima. A CPU tensor takes
    ``quantize_int8_plain(x, amax=amax)``; a CUDA tensor launches K1's
    kernel with the maxima given, on the route K1 takes."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, eps=eps, sr=sr, key=key, amax=amax)
    key = _device_key(sr, key, "quantize_int8_rowwise_given")
    _check_device_input(x, "quantize_int8_rowwise_given")
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    amax = _given_amax(x, amax, M, "quantize_int8_rowwise_given")
    tpr = rowwise_sm90_route(M, K, x.dtype, sr) if x.data_ptr() % 16 == 0 else 0
    ctas = row_walk_ctas(M, tpr, _sm_count(x.device), ROWWISE_CTAS_PER_SM) if tpr else 0
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    err = _build.library().qt_quantize_int8_rowwise_given(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(), M, K, eps,
        int(x.dtype == torch.bfloat16), int(sr), key, tpr, ctas, _build.stream(),
    )
    _build.check(err, "quantize_int8_rowwise_given")
    _count_route(quantize_int8_rowwise_given, sr, bool(tpr))
    return q, scale


def quantize_int8_colwise_maxima(x: torch.Tensor) -> torch.Tensor:
    """B4's maxima form: x [R, C] -> fp32 [1, C], each column's max |x|. A
    CPU tensor takes :func:`quantize_int8_maxima_plain`; a CUDA tensor (bf16
    or fp32, contiguous, non-empty) launches B4's first design's maxima
    kernel (``col_absmax``, after a memset)."""
    if x.device.type == "cpu":
        return quantize_int8_maxima_plain(x, 0)
    _check_device_input(x, "quantize_int8_colwise_maxima", ndim=2)
    R, C = x.shape
    amax = torch.empty((1, C), dtype=torch.float32, device=x.device)
    err = _build.library().qt_quantize_int8_colwise_maxima(
        x.data_ptr(), amax.data_ptr(), R, C, int(x.dtype == torch.bfloat16), _build.stream())
    _build.check(err, "quantize_int8_colwise_maxima")
    _count(quantize_int8_colwise_maxima, False)
    return amax


def quantize_int8_both_maxima(x: torch.Tensor, *, eps: float = EPS, sr: bool = False, key: int | None = None):
    """B5's maxima form: x [M, K] -> ``(q_row, s_row [M, 1], amax [1, K])``,
    the row quantize (with ``sr`` from ``split(key)[0]``, as B5's) and the
    columns' fp32 maxima. A CPU tensor takes the plain versions; a CUDA
    tensor (bf16 or fp32, contiguous, non-empty) launches B5's row pass and
    its column pass's reduction of the CTAs' maxima (or, off B5's vector
    path, its first design's row kernel)."""
    key_row = random.split(_key(sr, key))[0] if sr else 0
    if x.device.type == "cpu":
        return (*quantize_int8_plain(x, axis=1, eps=eps, sr=sr, key=key_row), quantize_int8_maxima_plain(x, 0))
    if sr:
        _build.refuse_capture("quantize_int8_both_maxima")
    _check_device_input(x, "quantize_int8_both_maxima", ndim=2)
    M, K = x.shape
    if K > _BOTH_MAX_K:
        raise ValueError(f"quantize_int8_both_maxima: K = {K} exceeds {_BOTH_MAX_K} (shared memory)")
    q_row = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s_row = torch.empty((M, 1), dtype=x.dtype, device=x.device)
    parts = torch.empty((M, K), dtype=torch.int8, device=x.device)
    amax = torch.empty((1, K), dtype=torch.float32, device=x.device)
    err = _build.library().qt_quantize_int8_both_maxima(
        x.data_ptr(), q_row.data_ptr(), s_row.data_ptr(), parts.data_ptr(), amax.data_ptr(), M, K, eps,
        int(x.dtype == torch.bfloat16), int(sr), key_row, _build.stream())
    _build.check(err, "quantize_int8_both_maxima")
    _count(quantize_int8_both_maxima, sr)
    return q_row, s_row, amax


def quantize_int8_colwise_given(x: torch.Tensor, amax: torch.Tensor, *, eps: float = EPS, sr: bool = False,
                                key: int | None = None):
    """The given-maxima form of a column quantize, B4's and B5's: x [M, K]
    and the columns' fp32 maxima -> ``(q_col, s_col [1, K])``, with ``sr``
    from ``key`` itself (B5's mesh route passes ``split(key)[1]``, as B5's
    column cast draws). A CPU tensor takes ``quantize_int8_plain(x, axis=0,
    amax=amax)``; a CUDA tensor (bf16 or fp32, contiguous, non-empty)
    launches B5's column pass without its reduction (off B5's vector path,
    B4's first design's cast)."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, axis=0, eps=eps, sr=sr, key=key, amax=amax)
    key = _device_key(sr, key, "quantize_int8_colwise_given")
    _check_device_input(x, "quantize_int8_colwise_given", ndim=2)
    M, K = x.shape
    amax = _given_amax(x, amax, K, "quantize_int8_colwise_given")
    q_col = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s_col = torch.empty((1, K), dtype=x.dtype, device=x.device)
    err = _build.library().qt_quantize_int8_colwise_given(
        x.data_ptr(), q_col.data_ptr(), s_col.data_ptr(), amax.data_ptr(), M, K, eps,
        int(x.dtype == torch.bfloat16), int(sr), key, _build.stream())
    _build.check(err, "quantize_int8_colwise_given")
    _count(quantize_int8_colwise_given, sr)
    return q_col, s_col


for _form in (quantize_int8_rowwise_maxima, quantize_int8_rowwise_given, quantize_int8_colwise_maxima,
              quantize_int8_colwise_given, quantize_int8_both_maxima):
    _form.launches = _form.sr_launches = _form.sm90_launches = _form.sr_sm90_launches = 0
