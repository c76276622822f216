"""Data of the port (counterpart of ``quantized_training_tpu/data``): the
synthetic image stream and the prefetching batcher, which the ViT trainer
uses, and the string-keyed :func:`get_dataset`. The JAX package's ``data``
cannot be imported from here (its package imports jax), so these are the
port's own copies. The HF, WebDataset and token datasets wait for ROADMAP
A11."""

from .image import SyntheticImageDataset
from .shuffle import BatchLoader

_UNPORTED = ("token", "hf_text", "synthetic", "markov", "hf_image", "wds")


def get_dataset(type: str, eval: bool = False, **kwargs):
    """A dataset by name (JAX ``data/__init__.py:17-27``); only
    'synthetic_image' is ported."""
    if type == "synthetic_image":
        return SyntheticImageDataset(eval=eval, **kwargs)
    if type in _UNPORTED:
        raise NotImplementedError(f"dataset type {type!r} is not ported yet (ROADMAP A11)")
    raise ValueError(f"unknown dataset type {type!r}")


__all__ = ["get_dataset", "BatchLoader", "SyntheticImageDataset"]
