"""The process mesh and the FSDP sharding rule.

Counterpart of ``quantized_training_tpu/parallel/mesh.py`` (:33-107). The
JAX package lays one program over a ``Mesh`` of devices with the axes
``data`` (data parallelism: the batch split, parameters replicated),
``fsdp`` (ZeRO-3: parameters and optimizer state split on a weight dim,
the batch split) and ``model`` (tensor parallelism for serving), and XLA
places the collectives. Here one process drives one device, as under
``torchrun``, and :class:`Mesh` is this process's view of the ranks: a
``torch.distributed`` ``DeviceMesh`` with those three dim names, this rank's
coordinate on each axis and the process group of each axis and of data x
fsdp. The collectives are written out by ``parallel/collectives.py``.

Sharding rule of a parameter leaf (JAX :78-95), by its global shape, with n
the fsdp size: a stacked ``[L, out, ...]`` leaf splits dim 1, else dim 2; a
2-D leaf (embedding, lm_head, a stacked norm ``[L, D]``) dim 0; a 1-D leaf
dim 0; a leaf whose dim does not divide by n, a scalar, or any leaf at n =
1 is replicated. :func:`param_spec` gives the dim (or None) and
:func:`shard_state` keeps this rank's slice of every leaf by it: the
tensors of the weight wrappers and of the optimizer state one by one, as
JAX's tree map reaches them. The global layout is a tree of :class:`Shard`
beside the local state (``state_specs``): ``shard_state`` returns both, and
the caller hands the layout to whatever needs it (the train step, the
model, the checkpoint), since a local shape cannot tell which dim was
split.

An 8-bit optimizer state (``optim/state8bit.py``) keeps a flat ``codes``
and one scale a block of 256 of the global leaf, and JAX's
``state_shardings`` splits those flat arrays by the parameter's spec (JAX
:98-107), XLA keeping each block's global meaning. Here a rank holds the
state of its slice of the parameter: the parameter viewed as [pre, split
dim, post] gives each rank, in every one of the ``pre`` runs, a run of
(split / n) post consecutive elements; where that run is a whole number of
blocks (every Llama2-1B leaf with an 8-bit state), the rank keeps those
blocks' codes and scales (:class:`FlatShard`), so its optimizer step needs
no collective; where a run ends inside a block, it keeps its elements'
codes and every block's scale, whose maxima its optimizer step all-reduces
over fsdp (``optim/state8bit.py``).

Multi-process input (JAX :54-75): every rank reads the same global batch
and :func:`shard_batch` keeps its rows, the batch axis split over data x
fsdp with data the outer axis.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..quant.node import WeightNode
from ..utils.tree import map_tensors

AXES = ("data", "fsdp", "model")


@dataclass
class Mesh:
    """This rank's place on a data x fsdp x model mesh of processes.

    ``shape``: the size of each axis; ``coords``: this rank's index on
    each; ``groups``: the process group of each axis and of ``"dp"`` (data
    x fsdp, the batch axis), None where ``torch.distributed`` is not
    initialized (a one-process mesh, every axis of size 1);
    ``device_mesh``: the ``DeviceMesh`` (None then too)."""

    shape: dict
    coords: dict
    groups: dict
    device_mesh: object = None

    @property
    def dp_size(self) -> int:
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def dp_index(self) -> int:
        """This rank's place on the batch axis: data major, then fsdp."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]


def make_mesh(axes: dict | None = None, device_type: str | None = None) -> Mesh:
    """axes e.g. ``{"data": 2, "fsdp": 4}``; missing axes get size 1
    (JAX :33-42). Under ``torch.distributed`` every rank of the world calls
    it, and the mesh takes the first ``prod(sizes)`` ranks, row-major over
    (data, fsdp, model); ``ValueError`` where the axes need more ranks than
    the world has. Without ``torch.distributed`` the world is this one
    process. ``device_type``: the ``DeviceMesh``'s ('cuda' where CUDA is
    available, else 'cpu', by default)."""
    axes = dict(axes or {})
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the axes are {AXES}")
    sizes = [int(axes.get(a, 1)) for a in AXES]
    n = sizes[0] * sizes[1] * sizes[2]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"mesh {axes} needs {n} ranks, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh {axes} of {n} ranks")
    d, f, m = sizes
    coords = dict(data=rank // (f * m), fsdp=rank // m % f, model=rank % m)
    shape = dict(zip(AXES, sizes))
    if not dist.is_initialized():
        return Mesh(shape, coords, dict.fromkeys((*AXES, "dp")))
    from torch.distributed.device_mesh import DeviceMesh

    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    mesh = torch.arange(n).reshape(d, f, m)
    device_mesh = DeviceMesh(device_type, mesh, mesh_dim_names=AXES)
    groups = {a: device_mesh.get_group(a) for a in AXES}
    # data x fsdp: one group per model index, made by every rank in one order
    for j in range(m):
        g = dist.new_group(mesh[:, :, j].flatten().tolist())
        if j == coords["model"]:
            groups["dp"] = g
    return Mesh(shape, coords, groups, device_mesh)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tuple of [B, S] or [accum, B,
    S] arrays or tensors): block ``dp_index`` of ``dp_size`` along the batch
    axis, as a torch tensor. B must divide by data x fsdp."""
    out = []
    for x in batch:
        x = torch.as_tensor(x)
        dim = 1 if x.ndim == 3 else 0  # [B, S] or [accum, B, S] (JAX :45-51)
        if x.shape[dim] % mesh.dp_size:
            raise ValueError(f"batch of {x.shape[dim]} rows does not split over data x fsdp = {mesh.dp_size}")
        out.append(x.chunk(mesh.dp_size, dim)[mesh.dp_index])
    return tuple(out)


def param_spec(shape, mesh: Mesh) -> int | None:
    """The dim of a leaf of global ``shape`` (or of a tensor) split over
    fsdp, or None for a replicated leaf (JAX :78-95, case for case)."""
    n = mesh.shape["fsdp"]
    shape = tuple(getattr(shape, "shape", shape))
    if n == 1 or len(shape) == 0:
        return None
    if len(shape) >= 3:  # stacked [L, out, ...]
        if shape[1] % n == 0:
            return 1
        if shape[2] % n == 0:
            return 2
        return None
    if shape[0] % n == 0:  # [V, D] (or a stacked norm [L, D]), and 1-D
        return 0
    return None


@dataclass(frozen=True)
class Shard:
    """Where this rank's piece of a leaf sits in the global leaf: ``dim``
    split into ``count`` equal blocks, of which this rank holds ``index``;
    ``dim`` None for a replicated leaf (then the piece is the leaf)."""

    dim: int | None
    index: int = 0
    count: int = 1

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``t`` (a copy)."""
        if self.dim is None:
            return t
        return t.chunk(self.count, self.dim)[self.index].clone()

    def piece(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a leaf as a checkpoint holds it."""
        return t

    def unpiece(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`piece`."""
        return t

    def global_shape(self, local_shape) -> tuple:
        shape = list(local_shape)
        if self.dim is not None:
            shape[self.dim] *= self.count
        return tuple(shape)

    def region(self, local_shape) -> tuple:
        """This piece's (start, stop) along every dim of the global leaf."""
        out = []
        for d, size in enumerate(local_shape):
            start = size * self.index if d == self.dim else 0
            out.append((start, start + size))
        return tuple(out)


@dataclass(frozen=True)
class FlatShard(Shard):
    """This rank's piece of an array whose values, in memory order, lie as
    ``view`` = (pre, count, per): the ``per`` consecutive values at
    ``index`` of each of the ``pre`` runs, in that order, shaped ``shape``
    (flat where it is empty): an 8-bit state's codes or block scales for a
    parameter slice, an int4 weight's groups for a matrix slice
    (``parallel/tp.py``). A checkpoint holds the piece as (pre, 1, per)
    (:meth:`piece`), so that its region in the view is a box."""

    view: tuple = ()
    shape: tuple = ()

    def take(self, t: torch.Tensor) -> torch.Tensor:
        piece = t.reshape(self.view).chunk(self.count, 1)[self.index]
        return piece.reshape(self.shape or (-1,)).clone()

    def piece(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(self.view[0], 1, self.view[2])

    def unpiece(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(self.shape or (-1,))


def _is8(t) -> bool:
    from ..optim.state8bit import OptimState8bit

    return isinstance(t, OptimState8bit)


def _state8_specs(t, mesh: Mesh):
    """An 8-bit state's layout: its fields :class:`FlatShard` by its
    parameter's split (the module's docstring; the scales whole where a
    rank's runs end inside blocks), or whole; its ``shard`` the parameter's
    :class:`Shard` (None where whole)."""
    from ..optim.state8bit import BLOCK

    index, n = mesh.coords["fsdp"], mesh.shape["fsdp"]
    dim = param_spec(t.shape, mesh)
    if dim is None:
        return dataclasses.replace(t, codes=Shard(None, index, n), scale=Shard(None, index, n))
    pre, post = math.prod(t.shape[:dim]), math.prod(t.shape[dim + 1:])
    run = t.shape[dim] // n * post
    scale = FlatShard(1, index, n, (pre, n, run // BLOCK)) if run % BLOCK == 0 else Shard(None, index, n)
    return dataclasses.replace(t, codes=FlatShard(1, index, n, (pre, n, run)), scale=scale, shard=Shard(dim, index, n))


def state_specs(state, mesh: Mesh):
    """The :class:`Shard` of every tensor of a global state by
    :func:`param_spec` (JAX's ``state_shardings``, :98-103); an 8-bit
    optimizer state's fields by its parameter's split (:class:`FlatShard`)."""
    def spec(t):
        if _is8(t):
            return _state8_specs(t, mesh)
        return Shard(param_spec(t.shape, mesh), mesh.coords["fsdp"], mesh.shape["fsdp"])

    return map_tensors(spec, state, is_leaf=lambda t: isinstance(t, torch.Tensor) or _is8(t))


def shard_state(state, mesh: Mesh):
    """(this rank's slice of every leaf of a global state (a ``TrainState``
    or a parameter tree) by the FSDP rule (JAX :106-107), its
    :class:`Shard` layout); an 8-bit state's piece records its parameter's
    :class:`Shard`."""
    specs = state_specs(state, mesh)

    def take(t, s):
        if not _is8(t):
            return s.take(t)
        return dataclasses.replace(t, codes=s.codes.take(t.codes), scale=s.scale.take(t.scale), shard=s.shard)

    return map_tensors(take, state, specs, is_leaf=lambda t: isinstance(t, torch.Tensor) or _is8(t)), specs


def param_specs(specs):
    """The parameters' part of a layout: the params of a ``TrainState``'s
    :class:`Shard` tree, or a parameter tree's itself."""
    return specs.params if hasattr(specs, "params") else specs


def leaf_shard(spec) -> Shard:
    """The :class:`Shard` of a leaf that takes the place of ``spec`` in a
    tree: a wrapper of shards stands for its first field (a storage
    wrapper's master, in the masters' tree, is split as its stored
    weight)."""
    if isinstance(spec, WeightNode):
        return next(iter(spec.tensors().values()))
    return spec
