"""The port's image sets and transforms (``data/image.py``) against the JAX
package's on the CPU: images made with PIL from numpy seeds, tar shards
and a local ``datasets`` folder written to ``tmp_path``; nothing is
downloaded (``HF_DATASETS_OFFLINE``/``HF_HUB_OFFLINE`` are set, and no
http shard is read).

- ``decode_image``, ``train_transform`` (same ``np.random`` generator) and
  ``eval_transform`` give JAX's arrays exactly (``np.array_equal``), on RGB
  images of 320 x 240 and 500 x 375, a grey one and an EXIF-rotated JPEG;
- ``WebDataset`` yields JAX's samples in JAX's order: in order and
  shuffled, split round-robin over 2 processes, a corrupt shard skipped,
  the ``columns`` filter and a ``transform`` dict;
- ``HFImageDataset`` on a local folder of WebDataset tars (``jpg``/``cls``
  columns) gives JAX's images and labels;
- the JAX package's image-set driver path fails as the JAX package's does
  (``BatchLoader`` calls ``state_dict()``, which neither set has): pinned in
  both packages (ROADMAP C).
"""

import io
import itertools
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from quantized_training_tpu.data import image as jimage
from quantized_training_tpu.data.shuffle import BatchLoader as JBatchLoader
from quantized_training_tpu_torch import data
from quantized_training_tpu_torch.data import image
from quantized_training_tpu_torch.data.shuffle import BatchLoader

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def _jpeg(seed: int, size=(320, 240), mode="RGB", exif_orientation=None) -> bytes:
    rng = np.random.default_rng(seed)
    w, h = size
    pixels = rng.integers(0, 256, (h, w, 3) if mode == "RGB" else (h, w), dtype=np.uint8)
    img = Image.fromarray(pixels, mode)
    buf = io.BytesIO()
    if exif_orientation is None:
        img.save(buf, format="JPEG", quality=90)
    else:
        exif = Image.Exif()
        exif[0x0112] = exif_orientation
        img.save(buf, format="JPEG", quality=90, exif=exif)
    return buf.getvalue()


IMAGES = {"rgb_320x240": dict(size=(320, 240)), "rgb_500x375": dict(size=(500, 375)),
          "grey": dict(size=(300, 260), mode="L"), "exif_rotated": dict(size=(320, 240), exif_orientation=6)}


@pytest.mark.parametrize("kind", list(IMAGES))
def test_transforms_equal_jax(kind):
    raw = _jpeg(7, **IMAGES[kind])
    ours, theirs = image.decode_image(raw), jimage.decode_image(raw)
    assert ours.mode == "RGB" and np.array_equal(np.asarray(ours), np.asarray(theirs))
    if kind == "exif_rotated":
        assert ours.size == (240, 320)  # the orientation tag turned it
    for seed in range(4):
        a = image.train_transform(ours, 224, np.random.default_rng(seed))
        b = jimage.train_transform(theirs, 224, np.random.default_rng(seed))
        assert a.dtype == np.float32 and a.shape == (224, 224, 3) and np.array_equal(a, b)
    a, b = image.eval_transform(ours), jimage.eval_transform(theirs)
    assert a.shape == (224, 224, 3) and np.array_equal(a, b)
    assert np.array_equal(image.normalize(np.ones(3, np.float32)), jimage.normalize(np.ones(3, np.float32)))


def _write_shards(tmp_path, n_shards=3, per_shard=4, corrupt=1):
    """Tar shards of (jpg, cls, txt) samples; shard ``corrupt`` is garbage."""
    urls = []
    for s in range(n_shards):
        path = tmp_path / f"shard-{s:03d}.tar"
        if s == corrupt:
            path.write_bytes(b"not a tar file" * 10)
        else:
            with tarfile.open(path, "w") as tar:
                for i in range(per_shard):
                    key = f"s{s}_{i:04d}"
                    members = (("jpg", _jpeg(100 * s + i, size=(64 + 8 * i, 48))),
                               ("cls", str((s + i) % 5).encode()), ("txt", f"caption {key}".encode()))
                    for ext, payload in members:
                        info = tarfile.TarInfo(f"{key}.{ext}")
                        info.size = len(payload)
                        tar.addfile(info, io.BytesIO(payload))
        urls.append(str(path))
    return urls


def _same_samples(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and x["__key__"] == y["__key__"]
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert np.array_equal(x[k], y[k])
            else:
                assert x[k] == y[k]


def test_webdataset_matches_jax(tmp_path):
    urls = _write_shards(tmp_path)
    # in order, the corrupt shard logged and skipped
    ours = list(data.get_dataset("wds", eval=True, urls=urls))
    _same_samples(ours, list(jimage.WebDataset(urls)))
    assert [s["__key__"] for s in ours] == [f"s{s}_{i:04d}" for s in (0, 2) for i in range(4)]
    # shuffled shards, without end: the first 12 samples
    kw = dict(eval=False, seed=3)
    _same_samples(list(itertools.islice(image.WebDataset(urls, **kw), 12)),
                  list(itertools.islice(jimage.WebDataset(urls, **kw), 12)))
    # round-robin over two processes: disjoint, together every shard
    parts = [list(image.WebDataset(urls, process_index=p, process_count=2)) for p in (0, 1)]
    _same_samples(parts[0], list(jimage.WebDataset(urls, process_index=0, process_count=2)))
    assert {s["__key__"] for s in parts[0]} == {f"s0_{i:04d}" for i in range(4)} | {f"s2_{i:04d}" for i in range(4)}
    # process 1's one shard is the corrupt one
    assert parts[1] == list(jimage.WebDataset(urls, process_index=1, process_count=2)) == []
    # the columns filter and a transform dict
    kw = dict(columns=["jpg", "cls"], transform={"jpg": lambda b: image.eval_transform(image.decode_image(b), 32, 40),
                                                 "cls": int})
    jkw = dict(columns=["jpg", "cls"], transform={"jpg": lambda b: jimage.eval_transform(jimage.decode_image(b), 32,
                                                                                          40), "cls": int})
    ours = list(image.WebDataset(urls, **kw))
    _same_samples(ours, list(jimage.WebDataset(urls, **jkw)))
    assert set(ours[0]) == {"__key__", "jpg", "cls"} and ours[0]["jpg"].shape == (32, 32, 3)


def test_hf_image_dataset_matches_jax(tmp_path):
    pytest.importorskip("datasets")
    folder = tmp_path / "images"
    folder.mkdir()
    _write_shards(folder, n_shards=2, per_shard=6, corrupt=-1)
    ds = data.get_dataset("hf_image", dataset=str(folder), split="train", eval=True,
                          transform=lambda im: image.eval_transform(im, 32, 40))
    assert isinstance(ds, image.HFImageDataset)
    ours = list(ds)
    theirs = list(jimage.HFImageDataset(str(folder), "train", eval=True,
                                        transform=lambda im: jimage.eval_transform(im, 32, 40)))
    assert len(ours) == len(theirs) == 12
    for (a, la), (b, lb) in zip(ours, theirs):
        assert a.shape == (32, 32, 3) and np.array_equal(a, b) and la == lb
    shuffled = image.HFImageDataset(str(folder), "train", transform=lambda im: image.eval_transform(im, 32, 40))
    jshuffled = jimage.HFImageDataset(str(folder), "train", transform=lambda im: jimage.eval_transform(im, 32, 40))
    for (a, la), (b, lb) in zip(itertools.islice(shuffled, 14), itertools.islice(jshuffled, 14)):
        assert np.array_equal(a, b) and la == lb


def test_image_sets_fail_the_jax_drivers_batcher_alike(tmp_path):
    """ROADMAP C: the JAX package's drivers batch an image set through
    ``BatchLoader``, which asks the set for ``state_dict()``; neither image
    set has one, in either package, so a driver run on them fails at its
    first batch. Pinned in both, so that a fix shows in both."""
    urls = _write_shards(tmp_path, n_shards=1, corrupt=-1)
    for loader in (BatchLoader(image.WebDataset(urls), 2), JBatchLoader(jimage.WebDataset(urls), 2)):
        with pytest.raises(AttributeError, match="state_dict"):
            next(iter(loader))
    assert not hasattr(image.HFImageDataset, "state_dict") and not hasattr(jimage.HFImageDataset, "state_dict")
