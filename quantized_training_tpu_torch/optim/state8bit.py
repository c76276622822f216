"""Block-wise 8-bit optimizer state (counterpart of
``quantized_training_tpu/optim/state8bit.py``, :29-83).

A state tensor is stored as one byte an element, an index into a 256-entry
cubic codebook (x -> x**3 spacing: dense near zero, where second moments
cluster), with one fp32 absmax scale a block of 256 elements. The codebook
is built in float64 and cast to fp32, as the JAX package builds it.
:meth:`OptimState8bit.requantize` picks the nearest entry as the JAX package
does: ``searchsorted`` on the left side, then the upper neighbour only where
it is strictly nearer, dividing by the block's clipped scale as a tensor, so
that the codes match the JAX package's bit for bit, ties included.

:class:`OptimState8bit` is a node of a parameter tree (``quant/node.py``):
its leaves are ``codes`` and ``scale``, in that order, JAX's
``data_fields``; ``shape`` and ``signed`` are static.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..quant.node import WeightNode

BLOCK = 256


def _make_codebook(signed: bool) -> np.ndarray:
    grid = np.linspace(-1.0 if signed else 0.0, 1.0, 256, dtype=np.float64)
    return (np.sign(grid) * np.abs(grid) ** 3).astype(np.float32)


def codebook(signed: bool, device) -> torch.Tensor:
    """The fp32 codebook on ``device`` (one copy a device)."""
    return _codebook(signed, torch.device(device))


@functools.cache
def _codebook(signed: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_make_codebook(signed)).to(device)


@dataclass
class OptimState8bit(WeightNode):
    codes: torch.Tensor  # [n] uint8
    scale: torch.Tensor  # [n // BLOCK] fp32 block absmax
    shape: tuple = ()
    signed: bool = False
    data_fields = ("codes", "scale")

    @classmethod
    def zeros(cls, shape, signed: bool = False, device=None) -> "OptimState8bit":
        n = int(np.prod(shape))
        if n % BLOCK:
            raise ValueError(f"size {n} is not a multiple of {BLOCK}")
        return cls(torch.zeros((n,), dtype=torch.uint8, device=device),
                   torch.zeros((n // BLOCK,), dtype=torch.float32, device=device), tuple(shape), signed)

    def dequantize(self) -> torch.Tensor:
        vals = codebook(self.signed, self.codes.device)[self.codes.long()]
        return (vals.reshape(-1, BLOCK) * self.scale[:, None]).reshape(self.shape)

    def requantize(self, x: torch.Tensor) -> "OptimState8bit":
        xf = x.float().reshape(-1, BLOCK)
        scale = xf.abs().amax(dim=-1)
        normed = (xf / scale.clamp(min=1e-30)[:, None]).reshape(-1)
        cb = codebook(self.signed, x.device)
        idx = torch.searchsorted(cb, normed).clamp(1, 255)
        lo, hi = cb[idx - 1], cb[idx]
        codes = torch.where((normed - lo) > (hi - normed), idx, idx - 1).to(torch.uint8)
        return OptimState8bit(codes, scale, self.shape, self.signed)
