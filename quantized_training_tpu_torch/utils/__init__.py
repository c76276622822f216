"""Utilities of the port (counterpart of ``quantized_training_tpu/utils``)."""

from . import checkpoint, logging, train, tree
from .checkpoint import ShardedLeaf, checkpoint_name, load_checkpoint, materialize, restore_sharded, save_checkpoint
from .logging import MetricLogger
from .train import LRSchedule, clip_by_global_norm, global_norm, print_model_stats

__all__ = ["checkpoint", "logging", "train", "tree", "MetricLogger", "LRSchedule", "global_norm",
           "clip_by_global_norm", "print_model_stats", "save_checkpoint", "load_checkpoint", "checkpoint_name",
           "materialize", "restore_sharded", "ShardedLeaf"]
