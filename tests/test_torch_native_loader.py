"""The port's native token loader against the JAX package's binding on the
CPU: the port builds ``cpp/tokenloader.cpp`` itself, and the JAX binding is
pointed at that same library (its ``_LIB_PATH`` monkeypatched), so both
bindings drive one library: the same batches, the same (epoch, cursor)
state, and each restores the other's state. A failed build raises. Mirrors
``tests/test_native_loader.py``."""

import ctypes

import numpy as np
import pytest
import torch

from quantized_training_tpu.data import native_loader as jnative
from quantized_training_tpu_torch.data import native_loader

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    for i in range(3):
        rng.integers(0, 1000, 650, dtype=np.uint16).tofile(d / f"s{i}.bin")
    return d


@pytest.fixture
def jax_loader(monkeypatch):
    """The JAX binding's loader class, loading the port's build."""
    monkeypatch.setattr(jnative, "_LIB_PATH", native_loader.library_path())
    monkeypatch.setattr(jnative, "_lib", None)
    return jnative.NativeTokenLoader


def _take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def test_library_builds_once_into_build_dir():
    path = native_loader.library_path()
    assert path.exists() and path.parent == native_loader.BUILD_DIR
    assert path.name.startswith("libtokenloader_") and native_loader.library_path() == path
    assert native_loader.BUILD_DIR.parts[-2:] == ("build", "tokenloader")
    assert isinstance(native_loader._load(), ctypes.CDLL)


@pytest.mark.parametrize("seed", [1, 7])
def test_batches_and_state_match_jax(shard_dir, jax_loader, seed):
    ours = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=seed)
    theirs = jax_loader(shard_dir, seq_len=32, batch_size=4, seed=seed)
    it_o, it_t = iter(ours), iter(theirs)
    for _ in range(20):  # 14 batches an epoch: crosses into the second
        (a, la), (b, lb) = next(it_o), next(it_t)
        assert a.dtype == np.int32 and a.shape == (4, 32)
        assert np.array_equal(a, b) and np.array_equal(la, lb) and np.array_equal(a[:, 1:], la[:, :-1])
        assert ours.state_dict() == theirs.state_dict()
    assert ours.state_dict()["epoch"] >= 1
    ours.close(), theirs.close()


@pytest.mark.parametrize("direction", ["ours_to_theirs", "theirs_to_ours"])
def test_restore_across_bindings(shard_dir, jax_loader, direction):
    make = {"ours": native_loader.NativeTokenLoader, "theirs": jax_loader}
    src, dst = direction.split("_to_")
    a = make[src](shard_dir, seq_len=32, batch_size=4, seed=3)
    _take(a, 4)
    state = a.state_dict()
    want = _take(a, 3)
    b = make[dst](shard_dir, seq_len=32, batch_size=4, seed=3)
    b.load_state_dict(state)
    for (x, lx), (y, ly) in zip(want, _take(b, 3)):
        assert np.array_equal(x, y) and np.array_equal(lx, ly)
    a.close(), b.close()


def test_eval_walk_matches_jax(shard_dir, jax_loader):
    """The eval walk ends after one pass: 3 shards x floor(650 / 33) = 57
    windows -> 14 batches of 4, in the JAX binding's order."""
    ours = list(native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=0, eval=True))
    theirs = list(jax_loader(shard_dir, seq_len=32, batch_size=4, seed=0, eval=True))
    assert len(ours) == len(theirs) == 14
    for (a, la), (b, lb) in zip(ours, theirs):
        assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails makes ``library_path`` raise."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    native_loader.library_path.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            native_loader.library_path()
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="cannot run"):
            native_loader.library_path()
    finally:
        native_loader.library_path.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_dir_raises(tmp_path):
    with pytest.raises(RuntimeError, match="tl_create failed"):
        native_loader.NativeTokenLoader(tmp_path / "none", seq_len=8, batch_size=2)
