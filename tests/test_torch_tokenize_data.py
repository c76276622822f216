"""The port's tokenizer to shards (``quantized_training_tpu_torch.tokenize_data``)
against the JAX package's ``tokenize_data.py``, on the CPU, offline:

- ``process_textfiles`` writes JAX's shards byte for byte (the byte
  tokenizer, two globs, a shard size that cuts documents);
- ``main`` writes ``dtype.txt`` (uint16 for the byte tokenizer's 259 ids,
  uint32 above 65,535) and the ``COMPLETE`` marker, and leaves a complete
  directory as it is;
- the shards feed the port's ``TokenDataset`` and its native loader
  unchanged;
- the options are those of ``python tokenize_data.py --help``.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_training_tpu.data import get_tokenizer as jget_tokenizer
from quantized_training_tpu_torch import tokenize_data
from quantized_training_tpu_torch.data import TokenDataset, get_tokenizer
from quantized_training_tpu_torch.data.native_loader import NativeTokenLoader

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import tokenize_data as jtd  # noqa: E402  (the JAX package's root script)


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    d = tmp_path_factory.mktemp("texts")
    rng = np.random.default_rng(0)
    words = ("once", "upon", "a", "time", "there", "was", "café", "naïve", "dragon", "\t", "and")
    for name in ("b.txt", "a.txt", "c.md"):
        lines = [" ".join(rng.choice(words, int(rng.integers(0, 40)))) for _ in range(30)]
        (d / name).write_text("\n".join(lines) + "\n\n   \n")
    return d


@pytest.mark.parametrize("shard_size", [97, 5000, 10**6])
def test_shards_equal_jax(texts, tmp_path, shard_size):
    inputs = [str(texts / "*.txt"), str(texts / "*.md")]
    for name, fn, tok in (("ours", tokenize_data.process_textfiles, get_tokenizer("byte")),
                          ("theirs", jtd.process_textfiles, jget_tokenizer("byte"))):
        (tmp_path / name).mkdir()
        fn(inputs, tmp_path / name, tok, np.uint16, shard_size)
    ours = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert all((tmp_path / "ours" / n).read_bytes() == (tmp_path / "theirs" / n).read_bytes() for n in ours)
    assert ours[0] == "shard_0000.bin" and (len(ours) > 2) == (shard_size < 1000)


def test_main_marks_dtype_and_complete(texts, tmp_path):
    save = tmp_path / "tok"
    argv = ["--dataset", "textfile", "--input", str(texts / "*.txt"), "--save_dir", str(save), "--tokenizer", "byte",
            "--shard_size", "500"]
    assert tokenize_data.main(argv) == save
    assert (save / "dtype.txt").read_text() == "uint16" and (save / "COMPLETE").exists()
    shards = sorted(save.glob("*.bin"))
    before = {p.name: p.read_bytes() for p in shards}
    shards[0].write_bytes(b"")  # a second run must not touch a complete directory
    tokenize_data.main(argv)
    assert shards[0].read_bytes() == b"" and all(p.read_bytes() == before[p.name] for p in shards[1:])
    with pytest.raises(ValueError, match="--input"):
        tokenize_data.main(["--save_dir", str(tmp_path / "none"), "--tokenizer", "byte"])


def test_wide_vocabulary_takes_uint32(texts, tmp_path, monkeypatch):
    class Wide:
        vocab_size = 128_256

        def __call__(self, text, add_bos=False, add_eos=False):
            return [70_000 + b for b in text.encode()] + [128_001] * add_eos

    monkeypatch.setattr(tokenize_data, "get_tokenizer", lambda name, path=None: Wide())
    save = tmp_path / "wide"
    tokenize_data.main(["--input", str(texts / "a.txt"), "--save_dir", str(save), "--tokenizer", "llama3"])
    assert (save / "dtype.txt").read_text() == "uint32"
    toks = np.fromfile(save / "shard_0000.bin", dtype=np.uint32)
    assert toks.max() == 128_001 and toks.min() >= 70_000


def test_shards_feed_the_token_dataset_and_the_native_loader(texts, tmp_path):
    save = tmp_path / "feed"
    tokenize_data.main(["--input", str(texts / "*.txt"), "--save_dir", str(save), "--tokenizer", "byte",
                        "--shard_size", "400"])
    shards = [np.fromfile(p, dtype=np.uint16).astype(np.int32) for p in sorted(save.glob("*.bin"))]
    windows = {tuple(s[i : i + 17]) for s in shards for i in range(0, len(s) - 16, 17)}
    it = iter(TokenDataset(str(save), seq_len=16))
    for _ in range(10):
        x, y = next(it)
        assert tuple(np.append(x, y[-1])) in windows
    loader = NativeTokenLoader(str(save), seq_len=16, batch_size=2, seed=3)
    try:
        x, y = next(iter(loader))
        rows = {tuple(s[i : i + 16]) for s in shards for i in range(len(s) - 15)}
        assert x.shape == (2, 16) and all(tuple(r) in rows for r in x) and np.array_equal(x[:, 1:], y[:, :-1])
    finally:
        loader.close()


def test_options_match_the_jax_driver():
    proc = subprocess.run([sys.executable, str(REPO / "tokenize_data.py"), "--help"], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    theirs = set(re.findall(r"(--[a-z_]+)", proc.stdout)) - {"--help"}
    ours = {s for a in tokenize_data._parser()._actions for s in a.option_strings} - {"-h", "--help"}
    assert ours == theirs
