"""Image datasets and transforms (counterpart of
``quantized_training_tpu/data/image.py``, :16-217).

- :func:`decode_image`: bytes -> PIL RGB image with its EXIF orientation
  applied;
- :func:`train_transform` (RandomResizedCrop(size) + horizontal flip) and
  :func:`eval_transform` (Resize(256) + CenterCrop(size)), numpy/PIL forms
  of the reference's torchvision pipelines, each ending in :func:`normalize`
  with ImageNet's mean and std: NHWC fp32 numpy, which the ViT step takes;
- :class:`SyntheticImageDataset`: sample i drawn from
  ``np.random.Generator(np.random.PCG64([seed, i]))``, an image of standard
  normals [size, size, 3], then its label in [0, num_classes);
- :class:`HFImageDataset`: a streaming ``datasets`` set with ``jpg`` and
  ``cls`` columns (a hub name or a local folder of WebDataset tars);
- :class:`WebDataset`: tar shards, local paths or http(s) URLs (fetched by
  ``requests``), one shard in every ``process_count`` for this
  ``process_index`` (round-robin), a shard that fails to read logged and
  skipped, samples as dicts of the members' bytes by extension.

``PIL``, ``datasets`` and ``requests`` are imported inside the functions
that use them. Everything draws from the same numpy generators as the JAX
package, so the two give the same arrays for the same seeds.

The JAX package's image-set driver path does not run (ROADMAP C):
``BatchLoader`` calls ``ds.state_dict()``, which neither
:class:`HFImageDataset` nor :class:`WebDataset` has, and without a
transform they yield PIL images and dicts of bytes. The classes are ported
as they are; a caller batches them itself, with a ``transform``.
"""

from __future__ import annotations

import io
import logging
import tarfile

import numpy as np

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode_image(data: bytes):
    """bytes -> PIL RGB image with EXIF orientation applied."""
    from PIL import Image, ImageOps

    img = Image.open(io.BytesIO(data))
    img = ImageOps.exif_transpose(img)
    return img.convert("RGB")


def _to_array(img) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def normalize(x: np.ndarray) -> np.ndarray:
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(img, size: int = 224, rng: np.random.Generator | None = None):
    """RandomResizedCrop(size) + RandomHorizontalFlip + normalize -> NHWC:
    up to 10 draws of an area in [0.08, 1] and a log-uniform aspect ratio in
    [3/4, 4/3], else the centre square."""
    from PIL import Image

    rng = rng or np.random.default_rng()
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if cw <= w and ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch))
            break
    else:  # fallback: center crop
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    img = img.resize((size, size), Image.BILINEAR)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return normalize(_to_array(img))


def eval_transform(img, size: int = 224, resize: int = 256):
    """Resize(resize) + CenterCrop(size) + normalize -> NHWC."""
    from PIL import Image

    w, h = img.size
    scale = resize / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    x0, y0 = (w - size) // 2, (h - size) // 2
    img = img.crop((x0, y0, x0 + size, y0 + size))
    return normalize(_to_array(img))


class SyntheticImageDataset:
    def __init__(self, size: int = 224, num_classes: int = 1000, eval: bool = False, n_samples: int | None = None,
                 seed: int = 2024):
        self.size = size
        self.num_classes = num_classes
        self.n_samples = n_samples if n_samples is not None else (256 if eval else None)
        self.seed = seed
        self._i = 0

    def __iter__(self):
        while self.n_samples is None or self._i < self.n_samples:
            rng = np.random.Generator(np.random.PCG64([self.seed, self._i]))
            img = rng.normal(size=(self.size, self.size, 3)).astype(np.float32)
            label = int(rng.integers(0, self.num_classes))
            self._i += 1
            yield img, label

    def state_dict(self) -> dict:
        return dict(_i=self._i)

    def load_state_dict(self, state: dict) -> None:
        self._i = state["_i"]


class HFImageDataset:
    """A streaming ``datasets`` image set with 'jpg'/'cls' columns (JAX
    :119-141): shuffled with the epoch as its seed unless ``eval`` (one
    pass), each image converted to RGB and through ``transform``."""

    def __init__(self, dataset: str, split: str, eval: bool = False, transform=None):
        from datasets import load_dataset

        self.ds = load_dataset(dataset, split=split, streaming=True)
        self.eval = eval
        self.transform = transform

    def __iter__(self):
        epoch = 0
        while True:
            ds = self.ds if self.eval else self.ds.shuffle(seed=epoch)
            for sample in ds.select_columns(["jpg", "cls"]):
                img = sample["jpg"].convert("RGB")
                if self.transform is not None:
                    img = self.transform(img)
                yield img, sample["cls"]
            epoch += 1
            if self.eval:
                break


class WebDataset:
    """Tar-shard streaming (JAX :144-217).

    ``urls``: http(s) URLs or local tar paths, visited in order under
    ``eval`` (one pass), else in a fresh permutation of a seeded generator
    each pass, without end. This process takes one shard in every
    ``process_count`` (round-robin by position in the visiting order); a
    shard that fails is logged and skipped. A sample is the dict of its
    members (``__key__`` and each extension's bytes, or those in
    ``columns``), each passed through ``transform[ext]`` where given.
    """

    def __init__(self, urls: list[str], columns: list[str] | None = None, transform: dict | None = None,
                 eval: bool = True, seed: int = 2024, process_index: int = 0, process_count: int = 1):
        self.urls = list(urls)
        self.columns = tuple(columns) if columns is not None else None
        self.transform = dict(transform) if transform is not None else None
        self.eval = eval
        self.process_index = process_index
        self.process_count = process_count
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def _url_iter(self):
        while True:
            order = range(len(self.urls)) if self.eval else self._rng.permutation(len(self.urls))
            for idx in order:
                yield self.urls[idx]
            if self.eval:
                break

    def _open(self, url: str):
        if url.startswith(("http://", "https://")):
            import requests

            resp = requests.get(url, timeout=30, stream=True)
            resp.raise_for_status()
            return tarfile.open(fileobj=resp.raw, mode="r|")
        return tarfile.open(url, mode="r|")

    def _emit(self, sample: dict):
        if self.transform is not None:
            for k, fn in self.transform.items():
                if k in sample:
                    sample[k] = fn(sample[k])
        return sample

    def __iter__(self):
        for shard_idx, url in enumerate(self._url_iter()):
            if shard_idx % self.process_count != self.process_index:
                continue
            try:
                tar = self._open(url)
                sample: dict = {}
                for tarinfo in tar:
                    key, ext = tarinfo.name.rsplit(".", 1)
                    if "__key__" in sample and sample["__key__"] != key:
                        yield self._emit(sample)
                        sample = {"__key__": key}
                    elif "__key__" not in sample:
                        sample["__key__"] = key
                    if self.columns is None or ext in self.columns:
                        sample[ext] = tar.extractfile(tarinfo).read()
                if "__key__" in sample:
                    yield self._emit(sample)
            except Exception as e:
                logger.exception(f"Exception while reading {url=}. {e}")
