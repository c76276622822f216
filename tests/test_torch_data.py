"""The port's text data against the JAX package's on the CPU: the four text
datasets, the two-buffer shuffle, the batcher over them and ``get_dataset``
give the same samples element for element and the same ``state_dict``, and
each resumes mid-stream from the other package's state; ``ByteTokenizer``
gives the same tokens; ``HFTextDataset`` over a local JSON file (skipped
where ``datasets`` does not import). Mirrors ``tests/test_data.py`` and
``tests/test_model_train.py::TestData``."""

import collections
import json

import numpy as np
import pytest
import torch

from quantized_training_tpu import data as jdata
from quantized_training_tpu.data import tokenizers as jtokenizers
from quantized_training_tpu_torch import data
from quantized_training_tpu_torch.data import tokenizers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("token_shards")
    rng = np.random.default_rng(0)
    for i in range(3):
        rng.integers(0, 1000, 650 + 33 * i, dtype=np.uint16).tofile(d / f"shard{i}.bin")
    return d


def _kwargs(kind, shard_dir):
    return {
        "token": dict(dataset_dir=str(shard_dir), seq_len=32, seed=3),
        "synthetic": dict(seq_len=32, vocab_size=300, seed=3),
        "markov": dict(seq_len=32, vocab_size=256, n_states=32, seed=3),
    }[kind]


def _same(a, b):
    assert len(a) == len(b)
    for (x1, y1), (x2, y2) in zip(a, b):
        assert x1.dtype == x2.dtype and np.array_equal(x1, x2) and np.array_equal(y1, y2)


@pytest.mark.parametrize("eval_", [False, True])
@pytest.mark.parametrize("kind", ["token", "synthetic", "markov"])
def test_text_datasets_match_jax(kind, eval_, shard_dir):
    """Sample for sample and state for state, then each package resumed
    from the other's mid-stream state gives the same continuation."""
    kw = _kwargs(kind, shard_dir)
    ours, theirs = data.get_dataset(kind, eval=eval_, **kw), jdata.get_dataset(kind, eval=eval_, **kw)
    it_o, it_t = iter(ours), iter(theirs)
    for _ in range(40):
        _same([next(it_o)], [next(it_t)])
        assert ours.state_dict() == theirs.state_dict()
    state = ours.state_dict()
    want = [next(it_o) for _ in range(10)]
    for make in (data.get_dataset, jdata.get_dataset):
        resumed = make(kind, eval=eval_, **kw)
        resumed.load_state_dict(state)
        it = iter(resumed)
        _same([next(it) for _ in range(10)], want)
    if eval_ and kind != "synthetic":  # the whole eval split, in order
        _same(list(data.get_dataset(kind, eval=True, **kw)), list(jdata.get_dataset(kind, eval=True, **kw)))


def test_token_dataset_windows_and_dtype_sidecar(tmp_path):
    """The eval walk of one shard is its windows in order, shifted by one;
    a ``dtype.txt`` of uint32 reads 32-bit shards."""
    np.arange(70_000, 70_066, dtype=np.uint32).tofile(tmp_path / "s.bin")
    (tmp_path / "dtype.txt").write_text("uint32\n")
    ours = list(data.TokenDataset(str(tmp_path), seq_len=32, eval=True))
    _same(ours, list(jdata.TokenDataset(str(tmp_path), seq_len=32, eval=True)))
    assert len(ours) == 2
    assert np.array_equal(ours[0][0], np.arange(70_000, 70_032)) and np.array_equal(ours[0][1][:-1], ours[0][0][1:])
    with pytest.raises(FileNotFoundError):
        data.TokenDataset(str(tmp_path / "none"), seq_len=8)


def test_markov_is_learnable_and_eval_disjoint():
    """The bigram entropy sits far below ln(V), and the eval split (128
    samples) shares no sequence with the train stream's start."""
    it = iter(data.get_dataset("markov", seq_len=128, vocab_size=512, n_states=64, seed=3))
    toks = np.concatenate([next(it)[0] for _ in range(100)])
    pair, uni = collections.Counter(zip(toks[:-1], toks[1:])), collections.Counter(toks[:-1])
    h = -sum(n * np.log(n / uni[a]) for (a, _), n in pair.items()) / sum(pair.values())
    assert h < 0.5 * np.log(512)
    ev = list(data.get_dataset("markov", seq_len=32, vocab_size=256, n_states=32, seed=5, eval=True))
    first = next(iter(data.get_dataset("markov", seq_len=32, vocab_size=256, n_states=32, seed=5)))[0]
    assert len(ev) == 128 and not any(np.array_equal(first, e[0]) for e in ev)


@pytest.mark.parametrize("buffer_size", [1, 8, 16])
def test_shuffle_matches_jax_and_resumes(buffer_size):
    """``ShuffleDataset`` yields the JAX package's samples in its order, to
    the drain at the end of a finite stream; its state (the inner state,
    the PCG64 state, both buffers) equals JAX's mid-stream, and either
    package resumes from it."""
    make = lambda pkg, n=None: pkg.ShuffleDataset(
        pkg.get_dataset("synthetic", seq_len=8, vocab_size=100, seed=4, n_samples=n), buffer_size=buffer_size, seed=7)
    _same(list(make(data, 50)), list(make(jdata, 50)))
    ours, theirs = make(data), make(jdata)
    it_o, it_t = iter(ours), iter(theirs)
    _same([next(it_o) for _ in range(21)], [next(it_t) for _ in range(21)])
    state, jstate = ours.state_dict(), theirs.state_dict()
    assert state["ds"] == jstate["ds"] and state["rng"] == jstate["rng"]
    for k in ("_buffer1", "_buffer2"):
        _same(state[k], jstate[k])
    want = [next(it_o) for _ in range(12)]
    for pkg in (data, jdata):
        resumed = make(pkg)
        resumed.load_state_dict(state)
        it = iter(resumed)
        _same([next(it) for _ in range(12)], want)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_loader_over_shuffle_resumes(prefetch):
    """The batcher over the shuffle gives the JAX pipeline's batches, and a
    state taken after 5 batches resumes at the sixth."""
    def make(pkg):
        ds = pkg.get_dataset("markov", seq_len=16, vocab_size=128, n_states=16, seed=1)
        return pkg.BatchLoader(pkg.ShuffleDataset(ds, buffer_size=8, seed=0), batch_size=4,
                               **({"prefetch": prefetch} if pkg is data else {}))

    ours, theirs = make(data), make(jdata)
    it, jit = iter(ours), iter(theirs)
    for _ in range(5):
        _same([next(it)], [next(jit)])
    state = ours.state_dict()
    want = next(it)
    it.close()
    jit.close()
    again = make(data)
    again.load_state_dict(state)
    got_it = iter(again)
    _same([next(got_it)], [want])
    got_it.close()


@pytest.mark.parametrize("kind,cls", [("token", data.TokenDataset), ("synthetic", data.SyntheticTokenDataset),
                                      ("markov", data.MarkovTokenDataset),
                                      ("synthetic_image", data.SyntheticImageDataset)])
def test_get_dataset_builds_each_type(kind, cls, shard_dir):
    kw = _kwargs(kind, shard_dir) if kind != "synthetic_image" else dict(size=8)
    assert type(data.get_dataset(kind, **kw)) is cls


def test_get_dataset_refuses_the_rest(monkeypatch):
    """The image sets are registered (``hf_image`` with ``load_dataset``
    stubbed, so that nothing is fetched); an unknown type raises."""
    monkeypatch.setattr("datasets.load_dataset", lambda name, split, streaming: ("set", name, split, streaming))
    assert type(data.get_dataset("hf_image", dataset="x", split="train")) is data.HFImageDataset
    assert type(data.get_dataset("wds", urls=[])) is data.WebDataset
    with pytest.raises(ValueError, match="unknown"):
        data.get_dataset("nope")


@pytest.mark.parametrize("text", ["", "hello world", "héllo, 世界 🙂", "line\nbreak\ttab"])
def test_byte_tokenizer_matches_jax(text):
    ours, theirs = tokenizers.get_tokenizer("byte"), jtokenizers.get_tokenizer("byte")
    for bos in (False, True):
        for eos in (False, True):
            assert ours(text, add_bos=bos, add_eos=eos) == theirs(text, add_bos=bos, add_eos=eos)
    toks = ours(text, add_bos=True, add_eos=True)
    assert ours.decode(toks) == theirs.decode(toks) == text
    assert (ours.vocab_size, ours.bos_id, ours.eos_id, ours.pad_id) == (259, 256, 257, 258)


def test_tokenizer_model_files_resolve_locally(tmp_path, monkeypatch):
    """A missing model file raises (nothing is downloaded), in both
    packages alike; ``$TOKENIZER_DIR`` is where a model file is looked for."""
    monkeypatch.setenv("TOKENIZER_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="TOKENIZER_DIR"):
        tokenizers._resolve(None, "llama3.model")
    (tmp_path / "llama3.model").write_text("")
    assert tokenizers._resolve(None, "llama3.model") == str(tmp_path / "llama3.model")
    assert tokenizers._resolve(str(tmp_path / "llama3.model"), "x") == jtokenizers._resolve(
        str(tmp_path / "llama3.model"), "x")
    with pytest.raises(KeyError):
        tokenizers.get_tokenizer("gpt2")


def test_hf_text_dataset_over_local_json(tmp_path):
    """``HFTextDataset`` streams a local JSON file through the byte
    tokenizer into the JAX package's windows, train and eval. The eval
    stream resumes exactly from a mid-stream state; the train stream, whose
    HF shuffle refills its buffer on a resume, resumes as the JAX
    package's does from the same state."""
    pytest.importorskip("datasets")
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "épsilon", "zeta"]
    path = tmp_path / "text.jsonl"
    path.write_text("".join(json.dumps({"text": " ".join(rng.choice(words, rng.integers(3, 30)))}) + "\n"
                            for _ in range(40)))
    kw = dict(dataset="json", subset=None, split="train", tokenizer="byte", seq_len=24, data_files=str(path))
    for eval_ in (True, False):
        ours, theirs = data.HFTextDataset(eval=eval_, **kw), jdata.HFTextDataset(eval=eval_, **kw)
        it_o, it_t = iter(ours), iter(theirs)
        _same([next(it_o) for _ in range(12)], [next(it_t) for _ in range(12)])
        state = ours.state_dict()
        want = [next(it_o) for _ in range(6)]
        resumed = [data.get_dataset("hf_text", eval=eval_, **kw), jdata.get_dataset("hf_text", eval=eval_, **kw)]
        got = []
        for ds in resumed:
            ds.load_state_dict(state)
            it = iter(ds)
            got.append([next(it) for _ in range(6)])
        _same(got[0], got[1])
        if eval_:
            _same(got[0], want)
