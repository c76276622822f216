"""Functional AdamW optimizers: fp32 state, and bf16 state with a fused
update kernel.

Counterpart of ``quantized_training_tpu/optim/adamw.py`` (:32-190):
``Optimizer`` and ``AdamWState``; :func:`adamw_bf16_sr` (:46-146), bf16
moments updated by kernel B6 (``ops/fused_adamw.py``) with an optional
stochastic-rounding bf16 writeback of the parameters; and the plain
fp32-state :func:`adamw` (:149-190), which the JAX package runs without a
Pallas kernel and the port runs as plain torch ops. Both step as
``step(grads, state, params, lr, key=None, donate=False) -> (new_params,
new_state)`` over the parameter tree, with bias correction and decoupled
weight decay in the JAX package's order of operations. Functional like their
counterparts, so a step holds the old and the new state at once; with
``donate`` (JAX's donated state, ``train.make_train_step``'s graphed step)
they write the new parameters and moments into the old ones' buffers, with
the same bits.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops.fused_adamw import fused_adamw_update
from ..ops.random import fold_in
from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    """Functional optimizer: params in, params out."""

    init: Callable[[Any], Any]
    step: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr, key=None, donate=False)


class AdamWState(NamedTuple):
    count: int
    exp_avg: Any  # fp32 tree (adamw) or bf16 tree (adamw_bf16_sr)
    exp_avg_sq: Any


def _leaves(grads, state: AdamWState, params, name: str):
    g_leaves, treedef = tree_flatten(grads)
    p_leaves = tree_leaves(params)
    ea_leaves, eas_leaves = tree_leaves(state.exp_avg), tree_leaves(state.exp_avg_sq)
    if not len(g_leaves) == len(p_leaves) == len(ea_leaves) == len(eas_leaves):
        raise ValueError(f"{name}: grads, params and state differ in structure")
    return treedef, list(zip(g_leaves, p_leaves, ea_leaves, eas_leaves))


def _into(old: torch.Tensor, new: torch.Tensor, donate: bool) -> torch.Tensor:
    """``new``, or with ``donate`` ``old`` overwritten with it."""
    return old.copy_(new) if donate else new


def adamw_bf16_sr(betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                  weight_decay: float = 1e-2, bf16_stochastic_rounding: bool = True) -> Optimizer:
    """AdamW with bf16 moments, all math in fp32, and bf16 parameters
    written back with stochastic rounding (JAX :46-146). Each leaf is one
    B6 launch on the card (its plain version for a CPU leaf), given the
    step's fp32 scalars (lr, b1, b2, wd, eps, bc1, bc2) as the JAX package
    stacks them (:87-97). A bf16 leaf i rounds from ``fold_in(fold_in(key,
    i), count)`` (:108-113); fp32 leaves round to nearest. The JAX
    package's ``backend`` switch has no counterpart: the leaf's device
    picks the kernel or the plain version."""
    b1, b2 = betas

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    def step(grads, state: AdamWState, params, lr, key=None, donate: bool = False):
        count = state.count + 1
        treedef, leaves = _leaves(grads, state, params, "adamw_bf16_sr")
        new_p, new_ea, new_eas = [], [], []
        scalars = {}
        for i, (g, p, ea, eas) in enumerate(leaves):
            if p.device not in scalars:
                # filled on the device (no host copy, no sync), in fp32 as JAX forms them
                f32 = lambda v: torch.full((), v, dtype=torch.float32, device=p.device)
                t = f32(count)
                bc1, bc2 = 1.0 - f32(b1) ** t, 1.0 - f32(b2) ** t
                scalars[p.device] = torch.stack([f32(lr), f32(b1), f32(b2), f32(weight_decay), f32(eps), bc1, bc2])
            sr = p.dtype == torch.bfloat16 and bf16_stochastic_rounding
            if sr and key is None:
                raise ValueError("bf16 SR writeback requires a key")
            k = fold_in(fold_in(key, i), count) if sr else None
            outs = fused_adamw_update(p, g, ea, eas, scalars[p.device], k, bf16_sr=sr, in_place=donate)
            for acc, out in zip((new_p, new_ea, new_eas), outs):
                acc.append(out)
        unflat = lambda ls: tree_unflatten(treedef, ls)
        return unflat(new_p), AdamWState(count, unflat(new_ea), unflat(new_eas))

    return Optimizer(init, step)


def adamw(betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-2) -> Optimizer:
    """Plain fp32-state AdamW (the torch.optim.AdamW baseline path)."""
    b1, b2 = betas

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    def step(grads, state: AdamWState, params, lr, key=None, donate: bool = False):
        del key  # deterministic (JAX :164-165)
        count = state.count + 1
        treedef, leaves = _leaves(grads, state, params, "adamw")
        new_p, new_ea, new_eas = [], [], []
        scalars = {}
        for g, p, ea, eas in leaves:
            if p.device not in scalars:  # the step's fp32 scalars, as JAX forms them
                f32 = lambda v: torch.full((), v, dtype=torch.float32, device=p.device)
                t = f32(count)
                bc1, bc2 = 1.0 - f32(b1) ** t, 1.0 - f32(b2) ** t
                scalars[p.device] = (f32(lr), bc1, torch.sqrt(bc2))
            lr_t, bc1, sqrt_bc2 = scalars[p.device]
            old_ea, old_eas = ea, eas
            g32 = g.float()
            ea = ea + (1 - b1) * (g32 - ea)
            eas = eas + (1 - b2) * (torch.square(g32) - eas)
            denom = torch.sqrt(eas) / sqrt_bc2 + eps
            p32 = p.float()
            upd = p32 - lr_t * weight_decay * p32 - lr_t * (ea / bc1) / denom
            new_p.append(_into(p, upd.to(p.dtype), donate))
            new_ea.append(_into(old_ea, ea, donate))
            new_eas.append(_into(old_eas, eas, donate))
        unflat = lambda leaves: tree_unflatten(treedef, leaves)
        return unflat(new_p), AdamWState(count, unflat(new_ea), unflat(new_eas))

    return Optimizer(init, step)
