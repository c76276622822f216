"""Optimizers of the port (counterpart of ``quantized_training_tpu/optim``).

Only the plain fp32-state :func:`adamw` is ported; ``adamw_bf16_sr`` and its
fused kernel wait for the SR slice (ROADMAP B6)."""

from .adamw import AdamWState, Optimizer, adamw

__all__ = ["AdamWState", "Optimizer", "adamw"]
