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

Under fsdp (``parallel.shard_state``) a rank holds the state of its slice of
the parameter: ``shard`` is the parameter's ``parallel.Shard`` (its split
dim, this rank's index, the count), ``shape`` stays the global parameter's,
and ``codes`` and ``scale`` are the codes and block scales of the rank's
elements in its slice's order. Where each rank's run of consecutive global
elements is a whole number of blocks (every Llama2-1B leaf with an 8-bit
state), those are whole global blocks, so a requantize of the rank's slice
gives the global state's blocks bit for bit with no collective. Where a
run ends inside a block, the rank keeps every block's scale (the global
``scale``, the same on every rank): a requantize takes each block's
maximum over the rank's elements of it, all-reduces them with max over the
span ``"blocks"`` (``parallel/collectives.py::spanning``; the train step
enters it around the optimizer over fsdp) and casts its own elements, so
the codes are again the global state's bit for bit.
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
    shard: object = None  # the parameter's parallel.Shard where this is a rank's piece
    data_fields = ("codes", "scale")

    @property
    def local_shape(self) -> tuple:
        """The shape of the parameter's piece this state holds."""
        if self.shard is None or self.shard.dim is None:
            return tuple(self.shape)
        shape = list(self.shape)
        shape[self.shard.dim] //= self.shard.count
        return tuple(shape)

    @property
    def straddles(self) -> bool:
        """A rank's piece whose runs end inside blocks: it holds every
        block's scale."""
        return self.scale.numel() * BLOCK != self.codes.numel()

    def _blocks(self) -> torch.Tensor:
        """The global block of each element of a straddling piece: local
        element e is element e % run of run e // run, which starts at global
        element (e // run * count + index) * run."""
        s = self.shard
        run = self.shape[s.dim] // s.count * int(np.prod(self.shape[s.dim + 1:]))
        e = torch.arange(self.codes.numel(), device=self.codes.device)
        return ((e // run * s.count + s.index) * run + e % run) // BLOCK

    @classmethod
    def zeros(cls, shape, signed: bool = False, device=None) -> "OptimState8bit":
        n = int(np.prod(shape))
        if n % BLOCK:
            raise ValueError(f"size {n} is not a multiple of {BLOCK}")
        return cls(torch.zeros((n,), dtype=torch.uint8, device=device),
                   torch.zeros((n // BLOCK,), dtype=torch.float32, device=device), tuple(shape), signed)

    def dequantize(self) -> torch.Tensor:
        vals = codebook(self.signed, self.codes.device)[self.codes.long()]
        if self.straddles:
            return (vals * self.scale[self._blocks()]).reshape(self.local_shape)
        return (vals.reshape(-1, BLOCK) * self.scale[:, None]).reshape(self.local_shape)

    def requantize(self, x: torch.Tensor) -> "OptimState8bit":
        if self.straddles:
            from ..parallel import collectives

            if collectives.span("blocks") is None:
                raise RuntimeError("a straddling 8-bit state's requantize needs the span 'blocks' over fsdp")
            xf, blocks = x.float().reshape(-1), self._blocks()
            partial = torch.zeros_like(self.scale).scatter_reduce(0, blocks, xf.abs(), "amax")
            scale = collectives.max_over(partial, "blocks")
            normed = xf / scale.clamp(min=1e-30)[blocks]
        else:
            xf = x.float().reshape(-1, BLOCK)
            scale = xf.abs().amax(dim=-1)
            normed = (xf / scale.clamp(min=1e-30)[:, None]).reshape(-1)
        cb = codebook(self.signed, x.device)
        idx = torch.searchsorted(cb, normed).clamp(1, 255)
        lo, hi = cb[idx - 1], cb[idx]
        codes = torch.where((normed - lo) > (hi - normed), idx, idx - 1).to(torch.uint8)
        return OptimState8bit(codes, scale, self.shape, self.signed, self.shard)
