"""The collectives of the port, and their micro-benchmark.

No JAX counterpart for the first part: XLA places the JAX package's
collectives. This module is the only place in the port that calls
``torch.distributed``. It offers an all-gather and a reduce-scatter (sum)
along a dim, and an all-reduce (sum or max), over one named axis of a
:class:`parallel.mesh.Mesh` or over ``"dp"``, data x fsdp.

A group whose backend is NCCL runs the collective on the device tensors.
Gloo carries few collectives on CUDA tensors (the torch documentation's
backend table lists broadcast and all-reduce), so where the group's backend
is gloo and the tensor lies on a CUDA card, the tensor is copied to the
host, the collective runs there and the result is copied back: what gloo
does inside its own CUDA all-reduce. The rule follows the backend the
caller chose; each such call adds one to :func:`staged_collectives`. That
is how two ranks share one card, where NCCL refuses a second rank on a
device it already drives. A mesh without process groups (one process) has
every axis of size 1, and there each collective is the identity.

:func:`benchmark_collectives` is ``parallel/collectives.py:30-88``: GiB/s of
all-reduce, all-gather and reduce-scatter over one axis, with the same byte
counts, ``ValueError`` below 2 ranks; each clock stops after
``torch.cuda.synchronize()`` on a card and after a read-back.

The span of a quantization maximum (no JAX counterpart: JAX's sharded step
is one global program, so each ``jnp.max`` over a sharded axis sees the
whole axis there). :func:`spanning` names, for the code it wraps, the mesh
axis that splits an axis a quantize reduces: ``tokens``, the token axis of
the activations and cotangents (data x fsdp, ``"dp"``, in a train step),
``features``, the contraction axis of a row-parallel linear (``model``,
under tensor parallelism), ``blocks``, an 8-bit optimizer state's
blocks that cross fsdp ranks (``optim/state8bit.py``), and ``weights``, the
elements of a weight that tensor parallelism splits (BitNet's abs-mean). A
quantize that names its reduced axis
(``quant/core.py``'s ``over``) then takes its maxima first, all-reduces them
with :func:`max_over` and casts with the global maxima; a product over
``features`` sums its partials over the axis (``quant/core.py::
scaled_mm_over``, ``::matmul_over``), and BitNet's abs-mean over
``weights`` its sum of |w|. The names are
module state, not thread state, since autograd runs a CUDA backward on a
thread of its own. An axis of size 1 (no mesh, a world of one) is not
entered, so the quantizes there keep their one-launch kernels.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

_STAGED = [0]
_MAXIMA = [0]
_SPANS: dict = {}  # a reduced axis's name -> (mesh, the mesh axis that splits it)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# torch renamed the tensor forms; take whichever this build has
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def staged_collectives() -> int:
    """The collectives run through the host since the last reset."""
    return _STAGED[0]


def reset_staged_collectives() -> None:
    _STAGED[0] = 0


def maxima_all_reduces() -> int:
    """The all-reduces of quantization maxima (:func:`max_over`) since the
    last reset."""
    return _MAXIMA[0]


def reset_maxima_all_reduces() -> None:
    _MAXIMA[0] = 0


def axis_size(mesh, axis: str) -> int:
    return mesh.dp_size if axis == "dp" else mesh.shape[axis]


def _split(mesh, axis: str) -> bool:
    return mesh is not None and axis_size(mesh, axis) > 1 and mesh.groups[axis] is not None


@contextlib.contextmanager
def spanning(mesh, **axes):
    """Within it, a maximum (or a sum) over each reduced axis named in
    ``axes`` (``tokens="dp"``, ``features="model"``, ``blocks="fsdp"``,
    ``weights="model"``) spans that axis of ``mesh``;
    an axis of size 1 adds nothing. The names it set are restored on exit."""
    saved = dict(_SPANS)
    _SPANS.update({name: (mesh, axis) for name, axis in axes.items() if _split(mesh, axis)})
    try:
        yield
    finally:
        _SPANS.clear()
        _SPANS.update(saved)


def span(over):
    """The (mesh, axis) that a maximum over ``over`` spans, or None:
    ``over`` a name that :func:`spanning` entered, or a (mesh, axis) pair
    (None where that axis has size 1)."""
    if over is None:
        return None
    if isinstance(over, str):
        return _SPANS.get(over)
    return over if _split(*over) else None


def max_over(x: torch.Tensor, over) -> torch.Tensor:
    """``x`` (maxima, of any float dtype) all-reduced with ``max`` over the
    axis that ``over`` spans (:func:`span`), in fp32 and cast back (exact);
    ``x`` itself where it spans nothing."""
    s = span(over)
    if s is None:
        return x
    _MAXIMA[0] += 1
    return all_reduce(x.float(), *s, op="max").to(x.dtype)


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _run(collective, x: torch.Tensor, out_shape, group, **kw) -> torch.Tensor:
    """``collective(out, x, group=group, **kw)`` into a new tensor of
    ``out_shape``, through the host where :func:`_staged`."""
    staged = _staged(x, group)
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=src.device)
    collective(out, src, group=group, **kw)
    if staged:
        _STAGED[0] += 1
        return out.to(x.device)
    return out


def all_gather(x: torch.Tensor, dim: int, mesh, axis: str = "fsdp") -> torch.Tensor:
    """The ranks' ``x`` of one axis concatenated along ``dim``, in rank
    order."""
    group, n = mesh.groups[axis], axis_size(mesh, axis)
    if group is None:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    out = _run(_ALL_GATHER, x0, (n * x0.shape[0], *x0.shape[1:]), group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axis: str = "fsdp") -> torch.Tensor:
    """The sum of the ranks' ``x`` over one axis, of which each rank keeps
    its block along ``dim`` (the adjoint of :func:`all_gather`)."""
    group, n = mesh.groups[axis], axis_size(mesh, axis)
    if group is None:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    out = _run(_REDUCE_SCATTER, x0, (x0.shape[0] // n, *x0.shape[1:]), group, op=dist.ReduceOp.SUM)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, axis: str = "dp", op: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` over one axis (or ``"dp"``) reduced by ``op``
    ('sum' or 'max'), as a new tensor."""
    group = mesh.groups[axis]
    if group is None:
        return x
    staged = _staged(x, group)
    out = x.cpu() if staged else x.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    if staged:
        _STAGED[0] += 1
        return out.to(x.device)
    return out


def _timed(fn, x: torch.Tensor) -> float:
    out = fn(x)  # warm-up: the groups' first call connects them
    if out.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(x)
    if out.is_cuda:
        torch.cuda.synchronize()
    float(out.reshape(-1)[0])  # a read-back before the clock stops
    return time.perf_counter() - t0


def benchmark_collectives(mesh, axis: str = "data", size_mb: float = 64.0, n_iters: int = 20,
                          device=None) -> dict[str, float]:
    """GiB/s of all-reduce (``psum_GiBps``), all-gather and reduce-scatter
    over ``axis`` (JAX :30-88): each rank holds its 1/n of an fp32 buffer
    of ``size_mb`` MB, and each iteration feeds the next, as in JAX's
    device-side loop; the bytes moved are JAX's ring counts (all-reduce 2
    (n - 1) / n of the buffer, the others (n - 1) / n)."""
    n = axis_size(mesh, axis)
    if n < 2:
        raise ValueError(f"axis {axis!r} has size {n}; need >= 2")
    n_elems = int(size_mb * 1e6 / 4)
    n_elems -= n_elems % (n * 128)
    index = mesh.dp_index if axis == "dp" else mesh.coords[axis]
    m = n_elems // n
    x = (torch.arange(index * m, (index + 1) * m, dtype=torch.float32, device=device) * 1e-9).reshape(1, m)

    def loop(local_fn):
        def run(acc):
            for _ in range(n_iters):
                acc = local_fn(acc) * 0.5 + acc * 0.5
            return acc
        return run

    full_bytes = n_elems * 4
    runs = {
        "psum_GiBps": (lambda v: all_reduce(v, mesh, axis) / n, full_bytes * 2 * (n - 1) / n),
        "all_gather_GiBps": (lambda v: all_gather(v, 0, mesh, axis).reshape(n, -1).mean(0, keepdim=True),
                             full_bytes * (n - 1) / n),
        "psum_scatter_GiBps": (lambda v: (reduce_scatter(v, 1, mesh, axis) / n).repeat(1, n),
                               full_bytes * (n - 1) / n),
    }
    return {name: moved * n_iters / _timed(loop(fn), x) / 2**30 for name, (fn, moved) in runs.items()}
