"""Checkpoint save and restore for one process (counterpart of
``quantized_training_tpu/utils/checkpoint.py``, :91-116 and :195-209).

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

The multi-process form (``ShardedLeaf``, ``restore_sharded``, a file per
rank) waits for ROADMAP A13.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import torch

from ..quant.node import WeightNode


def _map_tensors(fn, obj):
    """``fn`` on every tensor of ``obj``: through dicts, lists, tuples and
    ``NamedTuple`` states, and the tensor fields of weight wrappers and
    8-bit states; anything else is kept as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    if isinstance(obj, WeightNode):
        return dataclasses.replace(obj, **{f: _map_tensors(fn, t) for f, t in obj.tensors().items()})
    return obj


def _to_cpu(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.cpu()


def save_checkpoint(path: str | Path, payload: dict) -> None:
    """Atomically write ``payload`` (a dict; its ``meta`` entry is kept as
    it is) with every tensor on the CPU."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {k: _map_tensors(_to_cpu, v) for k, v in payload.items() if k != "meta"}
    out["meta"] = payload.get("meta", {})
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def materialize(tree, device="cpu"):
    """A loaded tree with every tensor on ``device``."""
    return _map_tensors(lambda t: t.to(device), tree)


def load_checkpoint(path: str | Path, device="cpu") -> dict:
    """The checkpoint at ``path``, its tensors on ``device``."""
    with open(path, "rb") as f:
        return materialize(pickle.load(f), device)


def checkpoint_name(save_dir: str | Path, step: int | None = None) -> Path:
    """The process's checkpoint path: ``last_0.pkl``, or ``step{N}_0.pkl``:
    the multi-process form's names (a file per process, as the JAX package
    names them; process 0 here). The one-process ``llm_pretrain`` writes
    ``last.pkl``, as the JAX package's driver does; the sharded restore
    (ROADMAP A13) is what will read these names."""
    return Path(save_dir) / ("last_0.pkl" if step is None else f"step{step}_0.pkl")
