"""Data parallelism, FSDP and tensor-parallel serving over processes
(counterpart of ``quantized_training_tpu/parallel``): one process drives
one device, as under ``torchrun``, and the collectives are written out in
``collectives.py``."""

from .collectives import benchmark_collectives, reset_staged_collectives, staged_collectives
from .fsdp import bitnet_fsdp_linear, bitnet_fsdp_params
from .mesh import (
    AXES,
    Mesh,
    Shard,
    make_mesh,
    param_spec,
    shard_batch,
    shard_state,
    state_specs,
)
from .tp import kv_cache_spec, shard_kv_cache, shard_params_tp, tp_param_spec

__all__ = [
    "AXES",
    "Mesh",
    "Shard",
    "make_mesh",
    "shard_batch",
    "shard_state",
    "state_specs",
    "param_spec",
    "bitnet_fsdp_linear",
    "bitnet_fsdp_params",
    "benchmark_collectives",
    "staged_collectives",
    "reset_staged_collectives",
    "tp_param_spec",
    "shard_params_tp",
    "kv_cache_spec",
    "shard_kv_cache",
]
