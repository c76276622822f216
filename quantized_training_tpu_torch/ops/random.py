"""Counter-based random stream for stochastic rounding (plain version).

Counterpart of the JAX package's keys (``jax.random.fold_in`` / ``split``)
and of the in-kernel TPU generator (``pltpu.prng_seed`` /
``prng_random_bits``, ``ops/pallas_quant.py:63-72``,
``ops/pallas_optim.py:68-73``). ``csrc/philox.cuh`` is the same generator
in CUDA; the kernels that round stochastically draw from it, and this
module's torch version computes the same 32-bit words, so each SR kernel is
bit-exact with its plain version.

- A key is a value, not a state: a Python int in [0, 2**64), the two 32-bit
  Philox key words (low word first). :func:`fold_in` and :func:`split`
  derive keys from keys on the host, as pure functions: no device sync,
  and a checkpointed layer replayed with the same key draws the same noise
  (``torch.utils.checkpoint`` restores only the default RNG states, never
  an explicit ``torch.Generator``).
- The stream of a key is Philox4x32-10 (Salmon et al., SC'11, Random123):
  element ``i`` is word ``i % 4`` of the block at counter ``(i // 4 low
  word, i // 4 high word, 0, 0)``, so one Philox call feeds four
  elements. :func:`fold_in` and :func:`split` take their key from counters
  whose third word is 1 and 2, apart from every stream.
- U[0, 1) = ``(word >> 8) * 2**-24``, as ``_uniform_noise`` draws it; the
  bf16 writeback of the optimizer adds ``word & 0xFFFF``.

The torch version runs on int64 tensors masked to 32 bits: the product of
two 32-bit words wraps in int64, but its bit pattern still holds the right
high word, which ``(p >> 32) & MASK32`` recovers.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
KEY_MAX = 1 << 64
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_FOLD, _SPLIT = 1, 2  # counter word 2 of fold_in / split (0 in every stream)


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1).

    Each counter word is a Python int or an int64 tensor holding a 32-bit
    value (tensors broadcast); returns the four output words the same way."""
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def _check_key(key: int) -> None:
    if not isinstance(key, int) or not 0 <= key < KEY_MAX:
        raise ValueError(f"a key is an int in [0, 2**64), got {key!r}")


def _derive(key: int, data: int, tag: int) -> int:
    _check_key(key)
    if not isinstance(data, int) or not 0 <= data < KEY_MAX:
        raise ValueError(f"fold_in data must be an int in [0, 2**64), got {data!r}")
    w = philox4x32(data & MASK32, data >> 32, tag, 0, key & MASK32, key >> 32)
    return w[0] | (w[1] << 32)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data`` (``jax.random.fold_in``)."""
    return _derive(key, data, _FOLD)


def split(key: int, n: int = 2) -> tuple[int, ...]:
    """``n`` new keys from ``key`` (``jax.random.split``)."""
    return tuple(_derive(key, i, _SPLIT) for i in range(n))


def key_from_generator(generator: torch.Generator) -> int:
    """A step's key drawn from an explicit, seeded generator. Nothing below
    the step draws from a generator: it derives keys from this one."""
    return torch.randint(2**63 - 1, (), generator=generator, device=generator.device).item()


def random_bits(key: int, shape, device=None) -> torch.Tensor:
    """The first ``prod(shape)`` words of the stream of ``key``, as int64
    in [0, 2**32), shaped ``shape`` in row-major order."""
    _check_key(key)
    n = math.prod(shape)
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32(blocks & MASK32, blocks >> 32, 0, 0, key & MASK32, key >> 32)
    return torch.stack(words, dim=-1).reshape(-1)[:n].reshape(shape)


def uniform(key: int, shape, device=None) -> torch.Tensor:
    """fp32 U[0, 1) of the stream of ``key``: ``(word >> 8) * 2**-24``
    (exact in fp32)."""
    return (random_bits(key, shape, device) >> 8).to(torch.float32) * 2.0**-24


def bf16_stochastic_round(x_f32: torch.Tensor, key: int) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding (``quant/core.py:318``): add
    the 16 low bits of the stream of ``key`` to the fp32 bit pattern, cut
    the low 16 bits, cast (exact). B6's writeback does the same."""
    if x_f32.dtype != torch.float32:
        raise TypeError(f"bf16_stochastic_round: needs fp32, got {x_f32.dtype}")
    noise = (random_bits(key, x_f32.shape, x_f32.device) & 0xFFFF).to(torch.int32)
    bits = (x_f32.contiguous().view(torch.int32) + noise) & -65536
    return bits.view(torch.float32).to(torch.bfloat16)
