"""Data of the port (counterpart of ``quantized_training_tpu/data``): the
text datasets, the image sets (``hf_image``, ``wds``, ``synthetic_image``)
and their transforms, the shuffle, the prefetching batcher, the tokenizers
and the string-keyed :func:`get_dataset`. The JAX package's ``data`` cannot
be imported from here (its package imports jax), so these are the port's
own copies. The native token loader is ``data/native_loader.py``."""

from .image import HFImageDataset, SyntheticImageDataset, WebDataset, decode_image, eval_transform, train_transform
from .shuffle import BatchLoader, ShuffleDataset
from .text import HFTextDataset, MarkovTokenDataset, SyntheticTokenDataset, TokenDataset
from .tokenizers import get_tokenizer

_DATASETS = dict(token=TokenDataset, hf_text=HFTextDataset, synthetic=SyntheticTokenDataset,
                 markov=MarkovTokenDataset, hf_image=HFImageDataset, wds=WebDataset,
                 synthetic_image=SyntheticImageDataset)


def get_dataset(type: str, eval: bool = False, **kwargs):
    """A dataset by name (JAX ``data/__init__.py:17-27``)."""
    if type not in _DATASETS:
        raise ValueError(f"unknown dataset type {type!r}")
    return _DATASETS[type](eval=eval, **kwargs)


__all__ = ["get_dataset", "get_tokenizer", "TokenDataset", "HFTextDataset", "SyntheticTokenDataset",
           "MarkovTokenDataset", "ShuffleDataset", "BatchLoader", "HFImageDataset", "WebDataset",
           "SyntheticImageDataset", "decode_image", "train_transform", "eval_transform"]
