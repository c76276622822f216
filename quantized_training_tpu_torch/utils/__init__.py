"""Utilities of the port (counterpart of ``quantized_training_tpu/utils``)."""

from . import logging, train, tree
from .logging import MetricLogger
from .train import print_model_stats

__all__ = ["logging", "train", "tree", "MetricLogger", "print_model_stats"]
