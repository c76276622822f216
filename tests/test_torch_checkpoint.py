"""The port's checkpoint (``utils/checkpoint.py``) on the CPU: a
``TrainState`` holding every weight wrapper kind and every optimizer state
round-trips bit for bit, with the loader's state and ``meta``; every tensor
is pickled on the CPU without the storage of a view, the write is atomic,
and loading places the tensors on the caller's device. Mirrors
``tests/test_model_train.py::TestCheckpoint``."""

import pickle

import numpy as np
import pytest
import torch

from quantized_training_tpu_torch import optim, quant, train
from quantized_training_tpu_torch.data import BatchLoader, ShuffleDataset, get_dataset
from quantized_training_tpu_torch.quant.node import WeightNode
from quantized_training_tpu_torch.utils import checkpoint_name, load_checkpoint, materialize, save_checkpoint
from quantized_training_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

OPTIMIZERS = {"adamw": {}, "adamw_bf16_sr": {}, "schedule_free_adamw": {}, "schedule_free_adamw_8bit": {}}


def _params():
    """One leaf of every wrapper kind, and plain leaves."""
    g = torch.Generator().manual_seed(0)
    w = lambda *s: (torch.randn(*s, generator=g) * 0.02).to(torch.bfloat16)
    wrap = lambda scheme, **kw: quant.quantize_params({"w": w(128, 64)}, scheme, filter_fn=lambda p, l: True, **kw)
    return {
        "mp": wrap("mixed_precision"),
        "mp_sr": wrap("mixed_precision", stochastic_rounding=True),
        "mp_int4": wrap("mixed_precision", dtype="int4"),
        "mp_fp8": wrap("mixed_precision", dtype="fp8_e4m3", scale="tile"),
        "int8": wrap("int8_quantized_training", activation="int8"),
        "int4": wrap("int4_weight_only"),
        "bitnet": wrap("bitnet"),
        "bitnet_packed": {"w": quant.BitNetPackedWeight.from_weight(w(128, 64))},
        "norm": {"g": torch.ones(64, dtype=torch.bfloat16)},
        "embed": {"embedding": w(256, 64)},
    }


def _structure(obj):
    """Types, dtypes, shapes and the wrappers' static fields of a tree."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.dtype, tuple(obj.shape), obj.device.type)
    if isinstance(obj, dict):
        return {k: _structure(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return (type(obj).__name__, tuple(_structure(v) for v in obj))
    if isinstance(obj, WeightNode):
        static = {k: v for k, v in vars(obj).items() if k not in obj.data_fields}
        return (type(obj).__name__, repr(static), _structure(obj.tensors()))
    return obj


def _tensors(obj, out=None):
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, tuple):
        for v in obj:
            _tensors(v, out)
    elif isinstance(obj, WeightNode):
        _tensors(obj.tensors(), out)
    return out


def _state_after_steps(name, n_steps=2):
    """The train state after ``n_steps`` optimizer steps on random grads
    and an SR commit, so that every state is past its zeros."""
    params = _params()
    opt = optim.get_optimizer(name, **OPTIMIZERS[name])
    opt_state = train.init_train_state(params, opt).opt_state
    v = quant.virtual_params(params)
    g = torch.Generator().manual_seed(1)
    for i in range(n_steps):
        grads = tree_map(lambda p: (torch.randn(p.shape, generator=g) * 1e-2).to(p.dtype), v)
        v, opt_state = opt.step(grads, opt_state, v, 1e-3, 7 + i)
    return train.TrainState(quant.commit_params(v, params, 11), opt_state, n_steps)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_state_round_trips_bit_for_bit(tmp_path, name):
    state = _state_after_steps(name)
    loader = BatchLoader(ShuffleDataset(get_dataset("markov", seq_len=16, vocab_size=64, n_states=8), 8, seed=1), 2)
    it = iter(loader)
    next(it), next(it)
    payload = {"state": state, "dloader": loader.state_dict(), "meta": {"step": 2, "args": {"lr": 1e-3}}}
    it.close()
    path = tmp_path / "ckpt" / "last.pkl"
    save_checkpoint(path, payload)
    assert path.exists() and not path.with_suffix(".tmp").exists()
    loaded = load_checkpoint(path)
    assert loaded["meta"] == {"step": 2, "args": {"lr": 1e-3}}
    assert isinstance(loaded["state"], train.TrainState) and type(loaded["state"].opt_state) is type(state.opt_state)
    assert _structure(loaded["state"]) == _structure(state)
    a, b = _tensors(state), _tensors(loaded["state"])
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if name == "schedule_free_adamw_8bit":
        assert isinstance(loaded["state"].opt_state.exp_avg_sq["mp"]["w"].data, optim.OptimState8bit)
    # the loader resumes where it stood
    again = BatchLoader(ShuffleDataset(get_dataset("markov", seq_len=16, vocab_size=64, n_states=8), 8, seed=1), 2)
    again.load_state_dict(loaded["dloader"])
    want = BatchLoader(ShuffleDataset(get_dataset("markov", seq_len=16, vocab_size=64, n_states=8), 8, seed=1), 2,
                       prefetch=0)
    it_w, it_a = iter(want), iter(again)
    next(it_w), next(it_w)
    x, y = next(it_w), next(it_a)
    assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    it_a.close()


def test_views_are_pickled_without_their_storage(tmp_path):
    big = torch.zeros(1 << 20)
    save_checkpoint(tmp_path / "v.pkl", {"state": {"w": big[:8]}})
    assert (tmp_path / "v.pkl").stat().st_size < 4096
    assert torch.equal(load_checkpoint(tmp_path / "v.pkl")["state"]["w"], torch.zeros(8))


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails while writing leaves the earlier checkpoint."""
    path = tmp_path / "last.pkl"
    save_checkpoint(path, {"state": {"w": torch.ones(4)}, "meta": {"step": 1}})

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(pickle, "dump", broken)
    with pytest.raises(OSError):
        save_checkpoint(path, {"state": {"w": torch.zeros(4)}, "meta": {"step": 2}})
    monkeypatch.undo()
    assert load_checkpoint(path)["meta"]["step"] == 1


def test_load_places_tensors_on_the_device(tmp_path):
    """Loading onto another device moves every tensor there (the meta
    device stands in for a card); numpy state and plain values stay."""
    state = _state_after_steps("schedule_free_adamw_8bit", 1)
    save_checkpoint(tmp_path / "c.pkl", {"state": state, "dloader": {"rng": np.arange(3)}, "meta": {"step": 1}})
    loaded = load_checkpoint(tmp_path / "c.pkl", device="meta")
    assert all(t.device.type == "meta" for t in _tensors(loaded["state"]))
    assert np.array_equal(loaded["dloader"]["rng"], np.arange(3)) and loaded["state"].step == 1
    assert all(t.device.type == "cpu" for t in _tensors(materialize(load_checkpoint(tmp_path / "c.pkl"))["state"]))


def test_checkpoint_name():
    assert checkpoint_name("runs/x").as_posix() == "runs/x/last_0.pkl"
    assert checkpoint_name("runs/x", 12).as_posix() == "runs/x/step12_0.pkl"
