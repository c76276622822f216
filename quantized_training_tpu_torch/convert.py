"""Parameters and optimizer state from the JAX package into the port (no
JAX counterpart).

:func:`params_from_jax` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's parameters: the same nested dict, names and layout,
as torch tensors. bf16 leaves pass through float32, which holds every bf16
value exactly. :func:`adamw_state_from_jax` does the same for an
``AdamWState``, so that both packages can start from one optimizer state. No
JAX import is needed: numpy's bf16 arrays (ml_dtypes) are recognised by their
dtype name, and the JAX package's ``MixedPrecisionWeight`` by its fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .optim.adamw import AdamWState
from .quant.configs import MixedPrecisionConfig
from .quant.mixed_precision import MixedPrecisionWeight


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy: JAX's buffers are read-only


def params_from_jax(tree):
    """Nested dict of numpy arrays (the JAX param pytree) -> nested dict of
    torch tensors on the CPU, same keys, shapes and dtypes. A wrapper with
    ``data`` and ``config`` fields (the JAX package's MixedPrecisionWeight)
    becomes the port's, with the same config."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(getattr(tree, "config", None)):
        config = MixedPrecisionConfig(**dataclasses.asdict(tree.config))
        return MixedPrecisionWeight(_tensor(tree.data), config)
    return _tensor(tree)


def adamw_state_from_jax(state) -> AdamWState:
    """The JAX package's ``AdamWState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's, on the CPU."""
    return AdamWState(int(np.asarray(state.count)), params_from_jax(state.exp_avg),
                      params_from_jax(state.exp_avg_sq))
