"""The design B19 (``ops/int8_attention.py::int8_flash_fwd``, the causal int8
flash-attention forward) takes, on the CPU: the pure predicate
``int8_flash_sm90_route`` picks the sm90 design of ``csrc/int8_attention.cu``
(``flash_sm90``: TMA, a producer warpgroup, wgmma for both products) or the
first design, and the wrapper passes the sm90 design's grid as the argument
before the stream (0: the first design). No card is needed: the predicate,
a mirror of the kernel's walk over its work items, and the constants it
shares with the kernel are held here, and the wrapper's launch path runs
against a recording stub of the library, on meta tensors that pass for CUDA
ones. The kernels themselves are held to their plain version and to each
other on the card (``tests/test_torch_cuda.py -k int8_flash``)."""

import importlib

import pytest
import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.ops import _build

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

ATTN = importlib.import_module("quantized_training_tpu_torch.ops.int8_attention")
SMS = 132  # the H100 SXM's SMs


@pytest.mark.parametrize("S,hd,bkv,causal,route", [
    (2048, 64, 512, True, 1),  # Llama2-1B's attention, block_kv 512 (chip_smoke.py phases 3 and 13)
    (2048, 128, 512, True, 1),
    (2048, 64, 128, True, 1),
    (2048, 64, 256, True, 1),
    (2048, 64, 512, False, 1),
    (256, 64, 128, False, 1),
    (768, 64, 384, True, 1),  # three chunks a block
    (2048, 64, 64, True, 0),  # a 64-column block: the first design
    (2048, 32, 512, True, 0),  # a head dim the kernels do not take
    (2048, 96, 512, True, 0),
    (640, 64, 256, True, 0),  # S off a whole number of blocks
    (2048, 64, 1024, True, 0),  # past four chunks a block
    (2048, 64, 192, True, 0),  # off whole chunks
])
def test_int8_flash_sm90_route(S, hd, bkv, causal, route):
    """The sm90 design takes hd 64 and 128 with a block_kv that is a multiple
    of 128 up to 512 and divides S, causal or not, at one CTA an SM; bkv 64,
    other head dims and blocks it cannot tile keep the first design."""
    assert ATTN.int8_flash_sm90_route(S, hd, bkv, causal) == route


# ---- a mirror of the kernel's walk (csrc/int8_attention.cu::flash::Walk) -----


def _chunks(r0, j, S, bkv, causal):
    """``Walk::chunks``: the 128-column chunks of block j that hold a column
    at or before the tile's last row."""
    n = bkv // ATTN.FLASH_CHUNK
    return min(n, (r0 + ATTN.FLASH_ROWS - 1 - j * bkv) // ATTN.FLASH_CHUNK + 1) if causal else n


def _blocks(r0, S, bkv, causal):
    return (r0 + ATTN.FLASH_ROWS - 1) // bkv + 1 if causal else S // bkv


def _weight(r0, S, bkv, causal):
    """The chunks a work item loads and multiplies."""
    return sum(_chunks(r0, j, S, bkv, causal) for j in range(_blocks(r0, S, bkv, causal)))


def _walk(n_ig, S, ctas):
    """Each CTA's work items in its order, as (instance-group, first row):
    round i takes items i ctas .. i ctas + ctas - 1, forward in even rounds
    and backward in odd ones; item idx is (idx % n_ig, the tile tiles - 1 -
    idx // n_ig)."""
    tiles = S // ATTN.FLASH_ROWS
    items = n_ig * tiles
    order = []
    for b in range(ctas):
        mine = []
        for i in range(items):
            idx = i * ctas + (ctas - 1 - b if i % 2 else b)
            if idx >= items:
                break
            mine.append((idx % n_ig, (tiles - 1 - idx // n_ig) * ATTN.FLASH_ROWS))
        order.append(mine)
    return order


_WALKS = [(16, 8, 2048, 512, True), (16, 8, 2048, 128, False), (1, 4, 256, 128, True), (2, 2, 256, 256, True),
          (1, 2, 512, 512, True), (4, 8, 1024, 512, True), (3, 2, 768, 384, True), (2, 2, 1024, 128, False),
          (2, 3, 512, 256, False), (1, 1, 128, 128, True)]


@pytest.mark.parametrize("n_inst,G,S,bkv,causal", _WALKS)
def test_sm90_walk_covers_every_item_once_heaviest_first(n_inst, G, S, bkv, causal):
    """At the card tests' shapes the kernel's walk, on ``min(items, SMs)``
    CTAs as the wrapper launches it, takes every (instance, group, q tile)
    exactly once; items come heaviest first (the global order's weights
    never rise, so the causal tiles at the end of S lead); and the CTAs'
    shares differ by at most the heaviest item."""
    n_ig, tiles = n_inst * G, S // ATTN.FLASH_ROWS
    ctas = min(n_ig * tiles, SMS)
    walk = _walk(n_ig, S, ctas)
    taken = [item for mine in walk for item in mine]
    assert sorted(taken) == sorted((ig, t * ATTN.FLASH_ROWS) for ig in range(n_ig) for t in range(tiles))
    weights = [_weight((tiles - 1 - idx // n_ig) * ATTN.FLASH_ROWS, S, bkv, causal) for idx in range(n_ig * tiles)]
    assert all(a >= b for a, b in zip(weights, weights[1:]))
    loads = [sum(_weight(r0, S, bkv, causal) for _, r0 in mine) for mine in walk]
    assert max(loads) - min(loads) <= max(weights)


@pytest.mark.parametrize("S,bkv,causal", [(2048, 512, True), (2048, 128, True), (768, 384, True),
                                          (1024, 256, False), (2048, 512, False)])
def test_sm90_walk_skips_only_future_chunks(S, bkv, causal):
    """``Walk::blocks`` and ``Walk::chunks`` keep exactly the chunks that hold
    a column at or before some row of the tile (every chunk where not
    causal), and the first chunk of every kept block holds one at or before
    the tile's first row, so no row of a block is all masked."""
    for r0 in range(0, S, ATTN.FLASH_ROWS):
        kept = {(j, c) for j in range(_blocks(r0, S, bkv, causal)) for c in range(_chunks(r0, j, S, bkv, causal))}
        want = {(j, c) for j in range(S // bkv) for c in range(bkv // ATTN.FLASH_CHUNK)
                if not causal or j * bkv + c * ATTN.FLASH_CHUNK <= r0 + ATTN.FLASH_ROWS - 1}
        assert kept == want
        assert all(j * bkv <= r0 for j, c in kept if c == 0) or not causal


def test_b19_constants_match_the_kernel():
    """The geometry the wrapper and the walk's mirror use is the kernel's
    (``csrc/int8_attention.cu``: ``kFlashRows``, ``kFlashChunk``,
    ``kFlashMaxBkv``), and one CTA an SM is what its launch bounds keep."""
    src = (_build.CSRC / "int8_attention.cu").read_text()
    assert f"constexpr int kFlashRows = {ATTN.FLASH_ROWS};" in src
    assert f"constexpr int kFlashChunk = {ATTN.FLASH_CHUNK};" in src
    assert f"constexpr int kFlashMaxBkv = {ATTN.FLASH_MAX_BKV};" in src
    assert f"__launch_bounds__(kFlashThreads, {ATTN.FLASH_CTAS_PER_SM})\nflash_sm90(" in src
    # the walk's order, as the mirror above takes it
    assert "const int pos = (i & 1) ? static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)" in src
    assert "return (tiles - 1 - idx / n_ig) * kFlashRows;" in src


# ---- the wrapper's launch path, on a recording stub ------------------------------


class _Library:
    """Records every C entry it is asked for, with its arguments; each
    launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def library(monkeypatch):
    """The recording stub in place of the built library, with meta tensors
    taken for CUDA ones by the wrapper's device checks and an H100's SMs."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(ATTN, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: self.device.type == "meta"))
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


def _inputs(lead, G, S, hd):
    """q_i8, q_s, k_i8, k_s, v_i8, v_s on the meta device."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (meta((*lead, G, S, hd), torch.int8), meta((*lead, G, S, 1), torch.float32),
            meta((*lead, S, hd), torch.int8), meta((*lead, S), torch.float32),
            meta((*lead, S, hd), torch.int8), meta((*lead, S), torch.float32))


@pytest.mark.parametrize("lead,G,S,hd,bkv,causal", [
    ((4, 4), 8, 2048, 64, 512, True),  # phase 3's shape: 4,096 items on 132 CTAs
    ((4, 4), 8, 2048, 128, 512, True),
    ((), 4, 256, 64, 128, True),  # 16 items: a CTA each
    ((2,), 2, 1024, 64, 128, False),
    ((3,), 2, 768, 64, 384, True),
    ((), 2, 256, 64, 64, True),  # the first design
    ((3,), 2, 512, 128, 64, True),
])
def test_int8_flash_fwd_passes_its_route(library, lead, G, S, hd, bkv, causal):
    """``int8_flash_fwd`` passes one argument per ``_SIGNATURES`` entry: the
    shape, block_kv, causal, and as the argument before the stream the sm90
    design's grid, ``min(items, SMs)`` (0 where the route refuses the
    shape); it counts the launch, and on the sm90 design again
    (``int8_flash_fwd_sm90``)."""
    out, lse = ops.int8_flash_fwd(*_inputs(lead, G, S, hd), causal=causal, block_q=bkv, block_kv=bkv)
    (name, args), = library.calls
    n_inst = 1
    for d in lead:
        n_inst *= d
    route = ATTN.int8_flash_sm90_route(S, hd, bkv, causal)
    ctas = min(n_inst * G * S // 64, SMS) if route else 0
    assert name == "qt_int8_flash_fwd" and len(args) == len(_build._SIGNATURES[name]) == 16
    assert args[8:] == (n_inst, G, S, hd, bkv, int(causal), ctas, 0)
    assert out.shape == (*lead, G, S, hd) and out.dtype == torch.bfloat16
    assert lse.shape == (*lead, G, S, 1) and lse.dtype == torch.float32
    counts = ops.launch_counts()
    assert counts["int8_flash_fwd"] == 1 and counts["int8_flash_fwd_sm90"] == int(bool(route))


def test_int8_flash_fwd_first_design_when_the_route_is_forced_off(library, monkeypatch):
    """With the predicate forced to 0 (as ``chip_smoke.py::check_b19`` does
    to time the first design beside the sm90 one) the wrapper passes grid 0
    and counts no sm90 launch; the counters add up over launches."""
    inputs = _inputs((4, 4), 8, 2048, 64)
    ops.int8_flash_fwd(*inputs)
    monkeypatch.setattr(ATTN, "int8_flash_sm90_route", lambda S, hd, bkv, causal: 0)
    ops.int8_flash_fwd(*inputs)
    ops.int8_flash_fwd(*inputs, causal=False)
    assert [c[1][-2] for c in library.calls] == [SMS, 0, 0]
    counts = ops.launch_counts()
    assert counts["int8_flash_fwd"] == 3 and counts["int8_flash_fwd_sm90"] == 1


def test_int8_flash_fwd_refusals(library):
    """Shapes neither design takes raise before any launch."""
    with pytest.raises(ValueError, match="hd 64 or 128"):
        ops.int8_flash_fwd(*_inputs((), 2, 256, 32))
    with pytest.raises(ValueError, match="up to 512"):
        ops.int8_flash_fwd(*_inputs((), 2, 2048, 64), block_q=1024, block_kv=1024)
    assert library.calls == []
    assert ops.launch_counts()["int8_flash_fwd"] == 0


def test_scales_off_16_bytes_are_copied():
    """The sm90 design copies a chunk's k and v scales with bulk copies,
    which need 16-byte aligned sources: the wrapper hands a scale tensor off
    that boundary over as an aligned copy, and an aligned one as it is."""
    base = torch.arange(17, dtype=torch.float32)
    off = base[1:]
    assert off.data_ptr() % 16 == 4
    copied = ATTN._aligned16(off)
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, off)
    aligned = torch.arange(16, dtype=torch.float32)
    assert ATTN._aligned16(aligned) is aligned
