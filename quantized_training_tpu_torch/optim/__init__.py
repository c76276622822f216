"""Optimizers of the port (counterpart of ``quantized_training_tpu/optim``).

:func:`adamw` (fp32 state) and :func:`adamw_bf16_sr` (bf16 state, kernel B6)
are ported, with the string registry :func:`get_optimizer` (JAX
``optim/__init__.py:13-28``). The schedule-free optimizers wait for ROADMAP
A8."""

from .adamw import AdamWState, Optimizer, adamw, adamw_bf16_sr

_REGISTRY = {"adamw": adamw, "adamw_bf16_sr": adamw_bf16_sr}
_UNPORTED = ("schedule_free_adamw", "schedule_free_adamw_8bit")


def get_optimizer(name: str, **kwargs) -> Optimizer:
    """String-keyed optimizer constructor."""
    if name in _UNPORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP A8)")
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


__all__ = ["AdamWState", "Optimizer", "adamw", "adamw_bf16_sr", "get_optimizer"]
