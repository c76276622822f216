"""Training utilities: LR schedule, the global grad norm, model stats.

Counterpart of ``quantized_training_tpu/utils/train.py`` (:17-69).
"""

from __future__ import annotations

import math

import torch

from .tree import tree_leaves, tree_map


class LRSchedule:
    """warmup -> hold -> {linear|cosine} decay, fractions of n_steps."""

    def __init__(self, lr: float, n_steps: int, warmup: float = 0.0, decay: float = 0.0,
                 decay_type: str = "linear") -> None:
        self.lr = lr
        self.t1 = int(n_steps * warmup)
        self.t2 = int(n_steps * (1 - decay))
        self.t3 = n_steps
        self.decay_type = decay_type
        if not self.t1 <= self.t2:
            raise ValueError(f"warmup {warmup} overlaps decay {decay}")
        if decay_type not in ("linear", "cosine"):
            raise ValueError(f"decay_type {decay_type!r}")

    def get_lr(self, step: int) -> float:
        if step < self.t1:
            return self.lr * step / self.t1
        if step < self.t2:
            return self.lr
        if step < self.t3:
            progress = (step - self.t2) / (self.t3 - self.t2)
            if self.decay_type == "linear":
                return self.lr * (1 - progress)
            return 0.5 * self.lr * (1 + math.cos(progress * math.pi))
        return 0.0


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squared leaves, in fp32, summed leaf by leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm: torch.Tensor | None = None):
    """Returns (clipped tree, pre-clip norm): torch.nn.utils.clip_grad_norm_
    semantics. The factor multiplies in fp32 (JAX promotes a bf16 leaf
    times an fp32 scalar), then each leaf goes back to its dtype. ``norm``:
    the tree's global norm where the caller has it (a sharded tree's, over
    every rank), else :func:`global_norm`."""
    norm = global_norm(tree) if norm is None else norm
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * factor).to(g.dtype), tree), norm


def print_model_stats(params) -> None:
    """Print the parameter count of the tree (a wrapped weight counts its
    master)."""
    print(f"No. of params: {sum(l.numel() for l in tree_leaves(params)):,}")
