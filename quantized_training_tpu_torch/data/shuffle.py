"""The shuffle and the stateful batcher (counterpart of
``quantized_training_tpu/data/shuffle.py``).

:class:`ShuffleDataset` (JAX :9-51) is the two-buffer shuffle: samples fill
a second buffer; when it holds ``buffer_size`` it is shuffled by the numpy
``PCG64`` stream of ``seed`` and swapped in as the first, which yields one
sample per sample read. Its state holds the inner dataset's state, the
``PCG64`` state and both buffers, so it resumes exactly where it stood.

:class:`BatchLoader` (JAX :55-168) stacks samples into numpy batches; a
ragged tail is dropped. By default a daemon thread prefetches ``prefetch``
batches through a bounded queue, so host-side batch assembly overlaps the
device step; ``prefetch=0`` is the synchronous path. Each prefetched batch
carries the dataset's state taken right after it was made, and
:meth:`BatchLoader.state_dict` returns that of the last batch yielded, so a
resume neither skips nor replays the batches still in the queue.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class ShuffleDataset:
    """Two-buffer shuffle: the second buffer fills; when full it is shuffled
    and swapped into the first, which drains one sample per sample read,
    so that the two hold ``buffer_size - 1`` samples between them."""

    def __init__(self, ds, buffer_size: int = 1000, seed: int = 2024) -> None:
        self.ds = ds
        self.buffer_size = buffer_size
        self._rng = np.random.Generator(np.random.PCG64(seed))
        self._buffer1: list = []
        self._buffer2: list = []

    def __iter__(self):
        for sample in self.ds:
            self._buffer2.append(sample)
            if len(self._buffer2) == self.buffer_size:
                self._buffer2 = self._shuffle(self._buffer2)
                self._buffer1, self._buffer2 = self._buffer2, self._buffer1
            if self._buffer1:
                yield self._buffer1.pop()

        while self._buffer1:
            yield self._buffer1.pop()
        self._buffer2 = self._shuffle(self._buffer2)
        while self._buffer2:
            yield self._buffer2.pop()

    def _shuffle(self, buffer: list) -> list:
        idx = self._rng.permutation(len(buffer))
        return [buffer[i] for i in idx]

    def state_dict(self) -> dict:
        return dict(ds=self.ds.state_dict(), rng=self._rng.bit_generator.state, _buffer1=list(self._buffer1),
                    _buffer2=list(self._buffer2))

    def load_state_dict(self, state: dict) -> None:
        self.ds.load_state_dict(state["ds"])
        self._rng.bit_generator.state = state["rng"]
        self._buffer1 = list(state["_buffer1"])
        self._buffer2 = list(state["_buffer2"])


class BatchLoader:
    def __init__(self, ds, batch_size: int, prefetch: int = 2) -> None:
        self.ds = ds
        self.batch_size = batch_size
        self.prefetch = prefetch
        self._last_state = None

    def _batches(self):
        it = iter(self.ds)
        while True:
            samples = []
            try:
                for _ in range(self.batch_size):
                    samples.append(next(it))
            except StopIteration:
                return  # the ragged tail is dropped
            yield tuple(np.stack([s[j] for s in samples]) for j in range(len(samples[0])))

    def __iter__(self):
        if self.prefetch <= 0:
            for batch in self._batches():
                self._last_state = self.ds.state_dict()
                yield batch
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()
        # the position before the worker moves the dataset on
        self._last_state = self.ds.state_dict()

        def put(item) -> bool:
            """A put that gives up once the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches():
                    if not put((batch, self.ds.state_dict(), None)):
                        return
                put((end, None, None))
            except BaseException as e:  # handed to the consumer
                put((end, None, e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch, state, err = q.get()
                if batch is end:
                    if err is not None:
                        raise err
                    return
                self._last_state = state
                yield batch
        finally:
            stop.set()
            t.join(timeout=5)

    def state_dict(self) -> dict:
        if self._last_state is not None:
            return dict(ds=self._last_state)
        return dict(ds=self.ds.state_dict())

    def load_state_dict(self, state: dict) -> None:
        self._last_state = None
        self.ds.load_state_dict(state["ds"])
