"""The synthetic image stream (counterpart of
``quantized_training_tpu/data/image.py::SyntheticImageDataset``, :89-116).

Sample i is drawn from ``np.random.Generator(np.random.PCG64([seed, i]))``:
an NHWC fp32 image of standard normals [size, size, 3], then its label in
[0, num_classes), so the port and the JAX package see the same images and
labels for one seed.
"""

from __future__ import annotations

import numpy as np


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
