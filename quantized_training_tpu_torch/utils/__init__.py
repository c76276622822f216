"""Utilities of the port (counterpart of ``quantized_training_tpu/utils``)."""

from . import train, tree

__all__ = ["train", "tree"]
