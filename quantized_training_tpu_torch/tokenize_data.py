"""Offline tokenization into ``.bin`` token shards (counterpart of the JAX
package's ``tokenize_data.py``), the files that ``data.TokenDataset`` and
the native loader read.

- ``--dataset textfile --input <glob> [<glob> ...]``: local text files, one
  document per non-empty line (stripped), in sorted order within a glob;
  runs offline. Shards of ``--shard_size`` tokens, ``shard_0000.bin``,
  ``shard_0001.bin``, ..., the rest in a last shard.
- ``tinystories``: ``roneneldan/TinyStories``'s ``--split`` in one shard
  ``<split>.bin``; ``c4_realnewslike``: ``allenai/c4`` realnewslike,
  streamed, in whole shards ``<split>_NNNN.bin`` (a rest under
  ``--shard_size`` is not written, as in the JAX package). Both read the
  hub through ``datasets``, imported only then.

Every document is tokenized by ``--tokenizer`` (``--tokenizer_path`` for its
model file) with bos and eos. The shards are uint16 where the tokenizer's
vocabulary has at most 65,535 ids, else uint32, named in ``dtype.txt``. A
``COMPLETE`` marker ends a run; a directory that holds one is left as it
is. No device is used.

  python -m quantized_training_tpu_torch.tokenize_data --dataset textfile --input 'docs/*.txt' \\
      --save_dir data/docs --tokenizer byte --shard_size 1000000
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np

from .data.tokenizers import get_tokenizer

MARKER = "COMPLETE"


def _write_shard(tokens: list[int], path: Path, dtype) -> None:
    arr = np.asarray(tokens, dtype=dtype)
    arr.tofile(path)
    print(f"wrote {path} ({len(arr):,} tokens)")


def process_textfiles(inputs: list[str], save_dir: Path, tokenizer, dtype, shard_size: int) -> None:
    tokens: list[int] = []
    shard_idx = 0
    for pattern in inputs:
        for fname in sorted(glob.glob(pattern)):
            with open(fname) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    tokens.extend(tokenizer(line, add_bos=True, add_eos=True))
                    while len(tokens) >= shard_size:
                        _write_shard(tokens[:shard_size], save_dir / f"shard_{shard_idx:04d}.bin", dtype)
                        tokens = tokens[shard_size:]
                        shard_idx += 1
    if tokens:
        _write_shard(tokens, save_dir / f"shard_{shard_idx:04d}.bin", dtype)


def process_tinystories(save_dir: Path, tokenizer, dtype, split: str) -> None:
    from datasets import load_dataset

    ds = load_dataset("roneneldan/TinyStories", split=split)
    tokens: list[int] = []
    for row in ds:
        tokens.extend(tokenizer(row["text"], add_bos=True, add_eos=True))
    _write_shard(tokens, save_dir / f"{split}.bin", dtype)


def process_c4_realnewslike(save_dir: Path, tokenizer, dtype, split: str, shard_size: int) -> None:
    from datasets import load_dataset

    ds = load_dataset("allenai/c4", "realnewslike", split=split, streaming=True)
    tokens: list[int] = []
    shard_idx = 0
    for row in ds:
        tokens.extend(tokenizer(row["text"], add_bos=True, add_eos=True))
        while len(tokens) >= shard_size:
            _write_shard(tokens[:shard_size], save_dir / f"{split}_{shard_idx:04d}.bin", dtype)
            tokens = tokens[shard_size:]
            shard_idx += 1


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Tokenize text into .bin token shards.")
    parser.add_argument("--dataset", default="textfile", choices=["textfile", "tinystories", "c4_realnewslike"])
    parser.add_argument("--input", nargs="+", help="glob(s) for --dataset textfile")
    parser.add_argument("--split", default="train")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--tokenizer", default="llama3")
    parser.add_argument("--tokenizer_path")
    parser.add_argument("--shard_size", type=int, default=200_000_000)
    return parser


def main(argv: list[str] | None = None) -> Path:
    """Runs the tokenization; returns the shards' directory."""
    args = _parser().parse_args(argv)
    save_dir = Path(args.save_dir)
    marker = save_dir / MARKER
    if marker.exists():
        print(f"{save_dir} already COMPLETE; nothing to do")
        return save_dir
    save_dir.mkdir(parents=True, exist_ok=True)

    tokenizer = get_tokenizer(args.tokenizer, args.tokenizer_path)
    dtype = np.uint16 if tokenizer.vocab_size <= 65535 else np.uint32
    (save_dir / "dtype.txt").write_text(np.dtype(dtype).name)

    if args.dataset == "textfile":
        if not args.input:
            raise ValueError("--input is required for --dataset textfile")
        process_textfiles(args.input, save_dir, tokenizer, dtype, args.shard_size)
    elif args.dataset == "tinystories":
        process_tinystories(save_dir, tokenizer, dtype, args.split)
    else:
        process_c4_realnewslike(save_dir, tokenizer, dtype, args.split, args.shard_size)

    marker.touch()
    print(f"done -> {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
