"""Data of the port (counterpart of ``quantized_training_tpu/data``): the
text datasets, the synthetic image stream, the shuffle, the prefetching
batcher, the tokenizers and the string-keyed :func:`get_dataset`. The JAX
package's ``data`` cannot be imported from here (its package imports jax),
so these are the port's own copies. The native token loader is
``data/native_loader.py``. The HF image and WebDataset sets wait for ROADMAP
A11."""

from .image import SyntheticImageDataset
from .shuffle import BatchLoader, ShuffleDataset
from .text import HFTextDataset, MarkovTokenDataset, SyntheticTokenDataset, TokenDataset
from .tokenizers import get_tokenizer

_DATASETS = dict(token=TokenDataset, hf_text=HFTextDataset, synthetic=SyntheticTokenDataset,
                 markov=MarkovTokenDataset, synthetic_image=SyntheticImageDataset)
_UNPORTED = ("hf_image", "wds")


def get_dataset(type: str, eval: bool = False, **kwargs):
    """A dataset by name (JAX ``data/__init__.py:17-27``)."""
    if type in _UNPORTED:
        raise NotImplementedError(f"dataset type {type!r} is not ported yet (ROADMAP A11)")
    if type not in _DATASETS:
        raise ValueError(f"unknown dataset type {type!r}")
    return _DATASETS[type](eval=eval, **kwargs)


__all__ = ["get_dataset", "get_tokenizer", "TokenDataset", "HFTextDataset", "SyntheticTokenDataset",
           "MarkovTokenDataset", "ShuffleDataset", "BatchLoader", "SyntheticImageDataset"]
