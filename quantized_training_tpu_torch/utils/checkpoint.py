"""Checkpoint save and restore (counterpart of
``quantized_training_tpu/utils/checkpoint.py``).

A checkpoint is a pickled dict: the train state (parameters with their
weight wrappers, the optimizer state), the data loader's state, and
``meta`` (the step and the run's arguments), which ``--resume`` restores
together. It is pickled as the JAX package pickles it, not through
``torch.save``: ``torch.load``'s default ``weights_only=True`` refuses the
wrapper dataclasses, the ``NamedTuple`` states and numpy's RNG state.

Every tensor is moved to the CPU before it is pickled (a CPU tensor is
copied, so a view does not carry its whole storage), and the file is
written atomically: a ``.tmp`` file, then ``replace``. :func:`load_checkpoint`
places the tensors on the caller's device. Unpickling runs code, so load
only checkpoints that this program wrote.

Multi-process (JAX :35-200): each rank writes its own file,
``last_{rank}.pkl`` (:func:`checkpoint_name`), holding only its shards: with
``shard_arrays`` (the ``parallel.Shard`` layout of the state, which
``shard_state`` returns) every tensor of the state is saved as a
:class:`ShardedLeaf`, its global shape and this rank's ``(region, data)``
piece, and :func:`restore_sharded` places each rank's piece back by the
restoring run's layout, assembling a region from overlapping pieces where
the layouts differ. Each rank's file suffices for its own shards; resume
assumes the same ranks, the file-per-rank contract. A BitNet weight is
saved without its mesh (``parallel.bitnet_fsdp_params`` puts the live one
back). An 8-bit optimizer state's piece (its codes and block scales for the
rank's slice of a parameter, ``parallel.FlatShard``) is saved as a box of
its flat arrays laid out as (runs, ranks, run), and :func:`materialize`
assembles JAX's flat global ``codes`` and ``scale`` from every rank's.
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist

from ..quant.node import WeightNode
from .tree import map_tensors


@dataclass
class ShardedLeaf:
    """This rank's piece of a sharded tensor (JAX :35-59): the global
    shape and dtype, and ``shards``, a list of ``(region, data)`` with
    ``region`` the (start, stop) of the piece along every dim."""

    global_shape: tuple
    dtype: str
    shards: list = field(default_factory=list)

    def to_tensor(self) -> torch.Tensor:
        """The full tensor; only where the pieces cover it (a replicated
        leaf, or every rank's file merged)."""
        full = ((0, n) for n in self.global_shape)
        out = _assemble_region(self.shards, tuple(full), getattr(torch, self.dtype))
        if out is None:
            raise ValueError("saved shards do not cover the global array — restore with "
                             "restore_sharded() under the original process topology")
        return out


def _is_piece(t) -> bool:
    return isinstance(t, (ShardedLeaf, torch.Tensor))


def _assemble_region(shards, region: tuple, dtype):
    """The tensor of ``region`` built from the pieces that overlap it;
    None if they do not cover it."""
    out = torch.zeros([b - a for a, b in region], dtype=dtype)
    covered = torch.zeros(out.shape, dtype=torch.bool)
    for src_region, data in shards:
        dst, src = [], []
        for (s0, s1), (t0, t1) in zip(src_region, region):
            lo, hi = max(s0, t0), min(s1, t1)
            if lo >= hi:
                break
            dst.append(slice(lo - t0, hi - t0))
            src.append(slice(lo - s0, hi - s0))
        else:
            out[tuple(dst)] = data[tuple(src)]
            covered[tuple(dst)] = True
    return out if bool(covered.all()) else None


def _to_cpu(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.cpu()


def _without_mesh(obj):
    return map_tensors(lambda w: dataclasses.replace(w, mesh=None) if getattr(w, "mesh", None) is not None else w,
                       obj, is_leaf=lambda t: isinstance(t, WeightNode))


def _sharded_leaf(t: torch.Tensor, spec) -> ShardedLeaf:
    t = spec.piece(_to_cpu(t))
    return ShardedLeaf(spec.global_shape(t.shape), str(t.dtype).removeprefix("torch."),
                       [(spec.region(t.shape), t)])


def save_checkpoint(path: str | Path, payload: dict, *, shard_arrays=None) -> None:
    """Atomically write ``payload`` (a dict; its ``meta`` entry is kept as
    it is) with every tensor on the CPU. ``shard_arrays``: the
    ``parallel.Shard`` layout of ``payload["state"]``, whose tensors are
    then saved as :class:`ShardedLeaf` pieces (the file-per-rank form)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {}
    for k, v in payload.items():
        if k == "meta":
            continue
        v = _without_mesh(v)
        if shard_arrays is not None and k == "state":
            out[k] = map_tensors(_sharded_leaf, v, shard_arrays)
        else:
            out[k] = map_tensors(_to_cpu, v)
    out["meta"] = payload.get("meta", {})
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def materialize(tree, device="cpu"):
    """A loaded tree with every tensor on ``device``, each
    :class:`ShardedLeaf` assembled into its full tensor (JAX :195-202;
    ``ValueError`` where its pieces do not cover it); an 8-bit state's
    pieces into its global flat arrays."""
    from ..optim.state8bit import OptimState8bit

    def one(t):
        if isinstance(t, OptimState8bit):
            flat = t.map_tensors(lambda x: one(x).reshape(-1))
            return dataclasses.replace(flat, shard=None)
        return (t.to_tensor() if isinstance(t, ShardedLeaf) else t).to(device)

    return map_tensors(one, tree, is_leaf=lambda t: _is_piece(t) or isinstance(t, OptimState8bit))


def load_checkpoint(path: str | Path, device="cpu") -> dict:
    """The checkpoint at ``path``, its tensors on ``device``;
    :class:`ShardedLeaf` pieces stay as they are (for
    :func:`restore_sharded`, or :func:`materialize`)."""
    with open(path, "rb") as f:
        return map_tensors(lambda t: t.to(device), pickle.load(f))


def restore_sharded(tree, specs, device="cpu"):
    """This rank's tensors of a loaded tree by ``specs`` (the
    ``parallel.Shard`` tree of the restoring run's state, JAX :122-160):
    a :class:`ShardedLeaf` gives the piece of this rank's region, or the
    region assembled from the overlapping pieces where the saving layout
    differed (``ValueError`` where they do not cover it); a whole tensor is
    cut by its shard. On ``device``."""
    def conv(leaf, spec):
        if isinstance(leaf, ShardedLeaf):
            local = list(leaf.global_shape)
            if spec.dim is not None:
                local[spec.dim] //= spec.count
            region = spec.region(local)
            data = next((d for r, d in leaf.shards if tuple(map(tuple, r)) == region), None)
            if data is None:
                data = _assemble_region(leaf.shards, region, getattr(torch, leaf.dtype))
            if data is None:
                raise ValueError(f"missing shard {region} for restore — was the checkpoint saved under a "
                                 "different topology?")
            return spec.unpiece(data).to(device)
        return spec.take(leaf).to(device)

    return map_tensors(conv, tree, specs, is_leaf=_is_piece)


def checkpoint_name(save_dir: str | Path, step: int | None = None, rank: int | None = None) -> Path:
    """The rank's checkpoint path, ``last_{rank}.pkl`` or
    ``step{N}_{rank}.pkl`` (JAX :205-208): a file per process, the rank
    ``torch.distributed``'s (0 without it). The one-process
    ``llm_pretrain`` writes ``last.pkl``, as the JAX package's driver
    does; under ``--mesh`` every rank writes its own name."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return Path(save_dir) / (f"last_{rank}.pkl" if step is None else f"step{step}_{rank}.pkl")
