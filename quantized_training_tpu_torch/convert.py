"""Parameters and optimizer state from the JAX package into the port (no
JAX counterpart).

:func:`params_from_jax` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's parameters: the same nested dict, names and layout,
as torch tensors. bf16 leaves pass through float32, which holds every bf16
value exactly. :func:`adamw_state_from_jax` does the same for an
``AdamWState``, so that both packages can start from one optimizer state. No
JAX import is needed: numpy's bf16 arrays (ml_dtypes) are recognised by their
dtype name, and the JAX package's weight wrappers (``MixedPrecisionWeight``,
``Int8Weight``, ``Int4Weight``, ``BitNetWeight``, ``BitNetPackedWeight``,
``PreQuantMPWeight`` with its four views) and
8-bit optimizer states (``OptimState8bit``) by their fields.
:func:`schedule_free_state_from_jax` carries a ``ScheduleFreeState``, its
8-bit second moments included. A JAX storage state, after its own stochastic-rounding commit,
so carries into the port, and both continue from the same storage.
:func:`rank_slice` keeps the part of a converted tree that one rank of a
``parallel.Mesh`` holds, so that a JAX state sharded over devices and the
port's ranks start from the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .optim.adamw import AdamWState
from .optim.schedule_free import ScheduleFreeState
from .optim.state8bit import OptimState8bit
from .quant.bitnet import BitNetPackedWeight, BitNetWeight
from .quant.configs import Int8QTConfig, MixedPrecisionConfig
from .quant.int4 import Int4Weight
from .quant.int8 import Int8Weight
from .quant.mixed_precision import MixedPrecisionWeight, PreQuantMPWeight


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy: JAX's buffers are read-only


def _optional(a):
    return None if a is None else _tensor(a)


def _wrapper(w):
    """The port's counterpart of a JAX weight wrapper, told by its fields,
    or None for a leaf."""
    config = getattr(w, "config", None)
    if hasattr(w, "codes"):
        return OptimState8bit(_tensor(w.codes), _tensor(w.scale), tuple(w.shape), bool(w.signed))
    if hasattr(w, "int_data"):
        return Int8Weight(_tensor(w.int_data), _tensor(w.scale), _optional(w.master),
                          Int8QTConfig(**dataclasses.asdict(config)))
    if hasattr(w, "zero_point"):
        return Int4Weight(_tensor(w.packed), _tensor(w.scale), _tensor(w.zero_point), _optional(w.master),
                          tuple(w.mat_shape), w.group_size)
    if hasattr(w, "row_q"):
        return PreQuantMPWeight(*(_tensor(getattr(w, f)) for f in PreQuantMPWeight.data_fields),
                                MixedPrecisionConfig(**dataclasses.asdict(config)))
    if hasattr(w, "packed"):
        return BitNetPackedWeight(_tensor(w.packed), _tensor(w.scale))
    if hasattr(w, "mesh"):  # a JAX mesh does not carry over: parallel.bitnet_fsdp_params sets the port's
        return BitNetWeight(_tensor(w.data))
    if dataclasses.is_dataclass(config):
        # the data of an optimizer state's wrapper may be an 8-bit state
        return MixedPrecisionWeight(params_from_jax(w.data), MixedPrecisionConfig(**dataclasses.asdict(config)))
    return None


def params_from_jax(tree):
    """Nested dict of numpy arrays (the JAX param pytree) -> nested dict of
    torch tensors on the CPU, same keys, shapes and dtypes. Each JAX weight
    wrapper becomes the port's, field for field, with the same config."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        w = _wrapper(tree)
        if w is None:
            raise TypeError(f"params_from_jax: unknown wrapper {type(tree).__name__}")
        return w
    return _tensor(tree)


def adamw_state_from_jax(state) -> AdamWState:
    """The JAX package's ``AdamWState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's, on the CPU."""
    return AdamWState(int(np.asarray(state.count)), params_from_jax(state.exp_avg),
                      params_from_jax(state.exp_avg_sq))


def schedule_free_state_from_jax(state) -> ScheduleFreeState:
    """The JAX package's ``ScheduleFreeState`` with numpy leaves -> the
    port's, on the CPU: the scalars as 0-d tensors, ``z`` and
    ``exp_avg_sq`` through :func:`params_from_jax` (an ``OptimState8bit``
    leaf keeps its codes and scales)."""
    return ScheduleFreeState(_tensor(state.count).to(torch.int32), _tensor(state.lr_max),
                             _tensor(state.weight_sum), params_from_jax(state.z),
                             params_from_jax(state.exp_avg_sq))


def rank_slice(tree, mesh, tp: bool = False):
    """(the part of a converted tree (:func:`params_from_jax`, or a state
    holding such trees) that this rank of ``mesh`` holds, its layout): its
    FSDP shards (``parallel.shard_state``), or with ``tp`` its
    tensor-parallel slice (``parallel.shard_params_tp``)."""
    from .parallel import shard_params_tp, shard_state

    return shard_params_tp(tree, mesh) if tp else shard_state(tree, mesh)
