"""Optimizers of the port (counterpart of ``quantized_training_tpu/optim``).

:func:`adamw` (fp32 state), :func:`adamw_bf16_sr` (bf16 state, kernel B6)
and :func:`schedule_free_adamw` (fp32 state, or 8-bit second moments in
``OptimState8bit``), with the string registry :func:`get_optimizer` (JAX
``optim/__init__.py:13-28``)."""

from .adamw import AdamWState, Optimizer, adamw, adamw_bf16_sr
from .schedule_free import ScheduleFreeState, eval_params, schedule_free_adamw, train_params
from .state8bit import OptimState8bit

_REGISTRY = {
    "adamw": adamw,
    "adamw_bf16_sr": adamw_bf16_sr,
    "schedule_free_adamw": schedule_free_adamw,
    "schedule_free_adamw_8bit": lambda **kw: schedule_free_adamw(state_8bit=True, **kw),
}


def get_optimizer(name: str, **kwargs) -> Optimizer:
    """String-keyed optimizer constructor."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


__all__ = ["Optimizer", "AdamWState", "ScheduleFreeState", "OptimState8bit", "adamw", "adamw_bf16_sr",
           "schedule_free_adamw", "eval_params", "train_params", "get_optimizer"]
