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

Multi-process input (JAX :54-75): every rank reads the same global batch
and :func:`shard_batch` keeps its rows, the batch axis split over data x
fsdp with data the outer axis.
"""

from __future__ import annotations

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


def state_specs(state, mesh: Mesh):
    """The :class:`Shard` of every tensor of a global state by
    :func:`param_spec` (JAX's ``state_shardings``, :98-103). An 8-bit
    optimizer state keeps the global shape as static metadata, so it is
    refused at fsdp > 1."""
    from ..optim.state8bit import OptimState8bit

    def refuse(t):
        if mesh.shape["fsdp"] > 1 and isinstance(t, OptimState8bit):
            raise ValueError("an 8-bit optimizer state cannot be split over fsdp: its blocks span the global leaf")
        return t

    map_tensors(refuse, state, is_leaf=lambda t: isinstance(t, OptimState8bit))
    return map_tensors(lambda t: Shard(param_spec(t.shape, mesh), mesh.coords["fsdp"], mesh.shape["fsdp"]), state)


def shard_state(state, mesh: Mesh):
    """(this rank's slice of every leaf of a global state (a ``TrainState``
    or a parameter tree) by the FSDP rule (JAX :106-107), its
    :class:`Shard` layout)."""
    specs = state_specs(state, mesh)
    return map_tensors(lambda t, s: s.take(t), state, specs), specs


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
