"""Parameters from the JAX package into the port (no JAX counterpart).

:func:`params_from_jax` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's parameters: the same nested dict, names and layout,
as torch tensors. bf16 leaves pass through float32, which holds every bf16
value exactly. No JAX import is needed: numpy's bf16 arrays (ml_dtypes) are
recognised by their dtype name.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy: JAX's buffers are read-only


def params_from_jax(tree):
    """Nested dict of numpy arrays (the JAX param pytree) -> nested dict of
    torch tensors on the CPU, same keys, shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return _tensor(tree)
