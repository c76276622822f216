"""Plain fp32-state AdamW as a functional optimizer.

Counterpart of ``quantized_training_tpu/optim/adamw.py::adamw`` (:149-190),
with ``Optimizer`` and ``AdamWState`` (:32-43): ``step(grads, state, params,
lr) -> (new_params, new_state)`` over the parameter tree, the state in fp32,
bias correction and decoupled weight decay in the JAX package's order of
operations. It runs as plain torch ops: the JAX package has no Pallas kernel
for it. Functional like its counterpart, so a step holds the old and the new
state at once (8 extra bytes per parameter at the peak).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    """Functional optimizer: params in, params out."""

    init: Callable[[Any], Any]
    step: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr)


class AdamWState(NamedTuple):
    count: int
    exp_avg: Any  # fp32 tree
    exp_avg_sq: Any  # fp32 tree


def adamw(betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-2) -> Optimizer:
    """Plain fp32-state AdamW (the torch.optim.AdamW baseline path)."""
    b1, b2 = betas

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    def step(grads, state: AdamWState, params, lr):
        count = state.count + 1
        g_leaves, treedef = tree_flatten(grads)
        p_leaves = tree_leaves(params)
        ea_leaves, eas_leaves = tree_leaves(state.exp_avg), tree_leaves(state.exp_avg_sq)
        if not len(g_leaves) == len(p_leaves) == len(ea_leaves) == len(eas_leaves):
            raise ValueError("adamw: grads, params and state differ in structure")
        new_p, new_ea, new_eas = [], [], []
        scalars = {}
        for g, p, ea, eas in zip(g_leaves, p_leaves, ea_leaves, eas_leaves):
            if p.device not in scalars:  # the step's fp32 scalars, as JAX forms them
                f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=p.device)
                t = f32(count)
                bc1, bc2 = 1.0 - f32(b1) ** t, 1.0 - f32(b2) ** t
                scalars[p.device] = (f32(lr), bc1, torch.sqrt(bc2))
            lr_t, bc1, sqrt_bc2 = scalars[p.device]
            g32 = g.float()
            ea = ea + (1 - b1) * (g32 - ea)
            eas = eas + (1 - b2) * (torch.square(g32) - eas)
            denom = torch.sqrt(eas) / sqrt_bc2 + eps
            p32 = p.float()
            upd = p32 - lr_t * weight_decay * p32 - lr_t * (ea / bc1) / denom
            new_p.append(upd.to(p.dtype))
            new_ea.append(ea)
            new_eas.append(eas)
        unflat = lambda leaves: tree_unflatten(treedef, leaves)
        return unflat(new_p), AdamWState(count, unflat(new_ea), unflat(new_eas))

    return Optimizer(init, step)
