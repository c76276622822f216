"""Text datasets (counterpart of ``quantized_training_tpu/data/text.py``,
a copy: that package imports jax, so its pure-numpy modules cannot be
imported from here).

- :class:`TokenDataset` (:26): an endless stream over uint16 (or the dtype of
  ``dtype.txt``) ``.bin`` memmap shards, shard and slice order drawn per
  epoch from ``PCG64([seed, epoch, salt])``, yielding (input, label)
  windows of ``seq_len`` shifted by one; resumable by (epoch, shard,
  slice) cursors.
- :class:`SyntheticTokenDataset` (:93): uniform random tokens, sample i from
  ``PCG64([seed, i])``.
- :class:`MarkovTokenDataset` (:126): a fixed random first-order Markov
  chain, learnable, so a training run shows a falling loss; the eval split
  draws from a disjoint stream.
- :class:`HFTextDataset` (:196): a streaming HF dataset, tokenized on the
  fly and packed into fixed windows; ``datasets`` is imported when one is
  made.

All pure numpy, so each yields the JAX package's samples element for
element, with the same ``state_dict``; the loader turns batches into
tensors.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


class TokenDataset:
    def __init__(
        self, dataset_dir: str, seq_len: int, eval: bool = False, seed: int = 2024
    ) -> None:
        self.shards = sorted(Path(dataset_dir).glob("*.bin"))
        if not self.shards:
            raise FileNotFoundError(f"no .bin shards under {dataset_dir}")
        # tokenize_data.py writes a dtype sidecar (uint32 for llama3's
        # >64k vocab); default matches the reference's uint16
        dtype_file = Path(dataset_dir) / "dtype.txt"
        self.dtype = (
            np.dtype(dtype_file.read_text().strip())
            if dtype_file.exists()
            else np.uint16
        )
        self.seq_len = seq_len
        self.eval = eval
        self.seed = seed
        # resumable cursors
        self._epoch = 0
        self._shard_i = 0
        self._slice_i = 0

    def _perm(self, n: int, salt: int) -> np.ndarray:
        if self.eval:
            return np.arange(n)
        rng = np.random.Generator(
            np.random.PCG64([self.seed, self._epoch, salt])
        )
        return rng.permutation(n)

    def __iter__(self):
        while True:
            shard_order = self._perm(len(self.shards), 0)
            while self._shard_i < len(shard_order):
                shard_idx = shard_order[self._shard_i]
                shard = np.memmap(
                    self.shards[shard_idx], dtype=self.dtype, mode="r"
                )
                window = self.seq_len + 1
                n_slices = math.floor(shard.shape[0] / window)
                slice_order = self._perm(n_slices, 1 + int(shard_idx))
                while self._slice_i < n_slices:
                    s = slice_order[self._slice_i]
                    batch = np.asarray(
                        shard[s * window : (s + 1) * window], dtype=np.int32
                    )
                    self._slice_i += 1
                    yield batch[:-1], batch[1:]
                self._slice_i = 0
                self._shard_i += 1
            self._shard_i = 0
            self._epoch += 1
            if self.eval:
                break

    def state_dict(self) -> dict:
        return dict(
            _epoch=self._epoch, _shard_i=self._shard_i, _slice_i=self._slice_i
        )

    def load_state_dict(self, state: dict) -> None:
        self._epoch = state["_epoch"]
        self._shard_i = state["_shard_i"]
        self._slice_i = state["_slice_i"]


class SyntheticTokenDataset:
    """Deterministic random token stream (benchmark / zero-egress runs)."""

    def __init__(
        self,
        seq_len: int,
        vocab_size: int = 32000,
        eval: bool = False,
        seed: int = 2024,
        n_samples: int | None = None,
    ) -> None:
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed
        self.n_samples = n_samples if n_samples is not None else (512 if eval else None)
        self._i = 0

    def __iter__(self):
        while self.n_samples is None or self._i < self.n_samples:
            rng = np.random.Generator(np.random.PCG64([self.seed, self._i]))
            toks = rng.integers(
                0, self.vocab_size, self.seq_len + 1, dtype=np.int32
            )
            self._i += 1
            yield toks[:-1], toks[1:]

    def state_dict(self) -> dict:
        return dict(_i=self._i)

    def load_state_dict(self, state: dict) -> None:
        self._i = state["_i"]


class MarkovTokenDataset:
    """LEARNABLE synthetic stream: a fixed random first-order Markov chain.

    Unlike :class:`SyntheticTokenDataset` (uniform noise, irreducible loss
    = ln(vocab)), this has real structure — each state transitions to
    ``branching`` successors with Zipf-ish probabilities — so a model
    training on it shows a falling loss curve. Used for end-to-end
    convergence-parity checks (bf16 vs quantized schemes) in zero-egress
    environments, standing in for the reference's TinyStories loss-curve
    validation (SURVEY §4.4).

    The chain itself is keyed only by ``seed``; the sampled trajectory is
    keyed by (seed, sample index) — deterministic and resumable.
    """

    def __init__(
        self,
        seq_len: int,
        vocab_size: int = 32000,
        n_states: int = 2048,
        branching: int = 8,
        eval: bool = False,
        seed: int = 2024,
        n_samples: int | None = None,
    ) -> None:
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.n_states = min(n_states, vocab_size)
        self.branching = branching
        self.seed = seed
        self.n_samples = n_samples if n_samples is not None else (128 if eval else None)
        # eval draws from a DISJOINT PCG64 stream (not an index offset the
        # train iterator could walk into after enough steps)
        self._split = 1 if eval else 0
        self._i = 0

        rng = np.random.Generator(np.random.PCG64([seed, 0xC0FFEE]))
        self._succ = rng.integers(
            0, self.n_states, (self.n_states, branching), dtype=np.int32
        )
        p = 1.0 / np.arange(1, branching + 1)
        self._probs = p / p.sum()
        # spread states over the full vocab so the embedding table is used
        self._state_to_tok = rng.permutation(vocab_size)[: self.n_states].astype(
            np.int32
        )

    def __iter__(self):
        while self.n_samples is None or self._i < self.n_samples:
            rng = np.random.Generator(
                np.random.PCG64([self.seed, self._split, self._i])
            )
            n = self.seq_len + 1
            choices = rng.choice(self.branching, size=n, p=self._probs)
            states = np.empty(n, dtype=np.int32)
            s = int(rng.integers(0, self.n_states))
            for t in range(n):
                states[t] = s
                s = int(self._succ[s, choices[t]])
            toks = self._state_to_tok[states]
            self._i += 1
            yield toks[:-1], toks[1:]

    def state_dict(self) -> dict:
        return dict(_i=self._i)

    def load_state_dict(self, state: dict) -> None:
        self._i = state["_i"]


class HFTextDataset:
    """Streaming HF dataset with on-the-fly tokenization and fixed-window
    packing (data/text.py:61-121).

    ``process_index``/``process_count`` shard the stream across hosts
    (replaces torch's split_dataset_by_node, data/text.py:80-82).
    """

    def __init__(
        self,
        dataset: str,
        subset: str | None,
        split: str,
        tokenizer: str,
        seq_len: int,
        eval: bool = False,
        seed: int = 2024,
        process_index: int = 0,
        process_count: int = 1,
        data_files=None,
    ) -> None:
        from datasets import load_dataset
        from datasets.distributed import split_dataset_by_node

        from .tokenizers import get_tokenizer

        self.ds = load_dataset(
            dataset, name=subset, split=split, streaming=True, data_files=data_files
        )
        self.tokenizer = get_tokenizer(tokenizer)
        self.seq_len = seq_len
        self.eval = eval

        self.ds = self.ds.select_columns("text")
        if not eval:  # only shuffle shard order (data/text.py:77-79)
            self.ds = self.ds.shuffle(seed=seed, buffer_size=1)
        if process_count > 1:
            self.ds = split_dataset_by_node(self.ds, process_index, process_count)
        self._epoch = 0
        self._buffer: list[int] = []

    def __iter__(self):
        window = self.seq_len + 1
        while True:
            if hasattr(self.ds, "set_epoch"):
                self.ds.set_epoch(self._epoch)
            for sample in self.ds:
                self._buffer.extend(
                    self.tokenizer(sample["text"], add_bos=True, add_eos=True)
                )
                while len(self._buffer) >= window:
                    chunk = np.asarray(self._buffer[:window], dtype=np.int32)
                    self._buffer = self._buffer[window:]
                    yield chunk[:-1], chunk[1:]
            self._epoch += 1
            if self.eval:
                break

    def state_dict(self) -> dict:
        ds_state = self.ds.state_dict()
        return dict(ds=ds_state, _epoch=self._epoch, _buffer=list(self._buffer))

    def load_state_dict(self, state: dict) -> None:
        self.ds.load_state_dict(state["ds"])
        self._epoch = state["_epoch"]
        self._buffer = list(state["_buffer"])
