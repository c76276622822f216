"""Schedule-free AdamW (counterpart of
``quantized_training_tpu/optim/schedule_free.py``, :29-133).

The state holds, for each parameter, ``z`` (in place of the momentum, fp32) and
``exp_avg_sq``, and three scalars: the step ``count`` (int32), ``lr_max``
and ``weight_sum`` (fp32). The scalars are 0-d tensors on the parameters'
device, so a step reads nothing back to the host. The stored parameters are
the train-mode ones (the interpolation y of x and z); :func:`eval_params`
gives the evaluation weights x and :func:`train_params` takes them back.

A step follows the JAX package's order of fp32 operations: warmup folded
into the effective lr, ``lr * sched * sqrt(1 - b2**t)``, the weight
``t**r * lr_max**weight_lr_power`` and ``ckp1 = weight / weight_sum``, 0
while ``weight_sum`` is 0 (an lr-0 first step). The parameters' device runs
the step: there is no kernel, as the JAX package had none.

``state_8bit`` keeps ``exp_avg_sq`` as an :class:`OptimState8bit` for every
parameter of at least 4096 elements whose size is a multiple of 256 (the
threshold of the JAX package, :50-53), fp32 for the rest.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .adamw import Optimizer, _into
from .state8bit import OptimState8bit


class ScheduleFreeState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    lr_max: torch.Tensor  # fp32 scalar
    weight_sum: torch.Tensor  # fp32 scalar
    z: Any
    exp_avg_sq: Any


def _is8(x) -> bool:
    return isinstance(x, OptimState8bit)


def schedule_free_adamw(betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                        warmup_steps: int = 0, r: float = 0.0, weight_lr_power: float = 2.0,
                        state_8bit: bool = False) -> Optimizer:
    b1, b2 = betas

    def zeros_eas(p):
        if state_8bit and p.numel() >= 4096 and p.numel() % 256 == 0:
            return OptimState8bit.zeros(p.shape, signed=False, device=p.device)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params):
        device = tree_leaves(params)[0].device
        return ScheduleFreeState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            lr_max=torch.full((), -1.0, dtype=torch.float32, device=device),
            weight_sum=torch.zeros((), dtype=torch.float32, device=device),
            z=tree_map(lambda p: p.to(torch.float32, copy=True), params),
            exp_avg_sq=tree_map(zeros_eas, params),
        )

    def step(grads, state: ScheduleFreeState, params, lr, key=None, donate: bool = False):
        del key  # deterministic
        count = state.count + 1
        t = count.float()
        f32 = lambda v: torch.full((), v, dtype=torch.float32, device=t.device)
        sched = torch.clamp(t / f32(warmup_steps), max=1.0) if warmup_steps > 0 else 1.0
        bc2 = 1.0 - f32(b2) ** t
        eff_lr = f32(lr) * sched * torch.sqrt(bc2)
        lr_max = torch.maximum(state.lr_max, eff_lr)
        weight = t ** r * lr_max ** weight_lr_power
        weight_sum = state.weight_sum + weight
        # weight_sum 0 (lr 0 so far): ckp1 0, not 0/0
        ckp1 = torch.where(weight_sum > 0.0, weight / weight_sum, 0.0)
        pull = b1 * (1.0 - ckp1) - 1.0

        flat_g, treedef = tree_flatten(grads)
        flat_p, flat_z = tree_leaves(params), tree_leaves(state.z)
        flat_eas = tree_leaves(state.exp_avg_sq, is_leaf=_is8)
        if not len(flat_g) == len(flat_p) == len(flat_z) == len(flat_eas):
            raise ValueError("schedule_free_adamw: grads, params and state differ in structure")
        new_p, new_z, new_eas = [], [], []
        for g, p, z, eas in zip(flat_g, flat_p, flat_z, flat_eas):
            g32 = g.float()
            eas32 = eas.dequantize() if _is8(eas) else eas
            eas32 = eas32 + (1 - b2) * (torch.square(g32) - eas32)
            denom = torch.sqrt(eas32) + eps
            p32 = p.float()
            grad_normalized = weight_decay * p32 + g32 / denom
            # p.lerp(z, ckp1) + gn * lr * (b1 * (1 - ckp1) - 1)
            new_p.append(_into(p, (p32 + ckp1 * (z - p32) + grad_normalized * eff_lr * pull).to(p.dtype), donate))
            new_z.append(_into(z, z - eff_lr * grad_normalized, donate))
            if _is8(eas):
                q = eas.requantize(eas32)
                if donate:
                    eas.codes.copy_(q.codes)
                    eas.scale.copy_(q.scale)
                new_eas.append(eas if donate else q)
            else:
                new_eas.append(_into(eas, eas32, donate))
        unflat = lambda leaves: tree_unflatten(treedef, leaves)
        return unflat(new_p), ScheduleFreeState(count, lr_max, weight_sum, unflat(new_z), unflat(new_eas))

    return Optimizer(init, step)


def _flip(params, z, c: float):
    def flip(p, zz):
        p32 = p.float()
        return (p32 + c * (zz - p32)).to(p.dtype)

    return tree_map(flip, params, z)


def eval_params(params, state: ScheduleFreeState, beta1: float = 0.9):
    """Train-mode parameters -> eval-mode ones (the ``.eval()`` flip, JAX
    :113-122): ``lerp(p, z, 1 - 1/beta1)``."""
    return _flip(params, state.z, 1.0 - 1.0 / beta1)


def train_params(params_eval, state: ScheduleFreeState, beta1: float = 0.9):
    """Eval-mode parameters -> train-mode ones (JAX :125-133):
    ``lerp(p, z, 1 - beta1)``."""
    return _flip(params_eval, state.z, 1.0 - beta1)
