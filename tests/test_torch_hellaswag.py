"""The port's HellaSwag scoring (``quantized_training_tpu_torch.hellaswag``)
against the JAX package's ``hellaswag.py``, on the CPU, at the small Llama
(2 layers, hidden 256, vocab 512) with the byte tokenizer:

- ``preprocess`` on strings with `` [title]``, brackets and double spaces;
- ``_load_rows`` from a JSON and a JSONL file;
- ``tokenize_rows``' [N, 4, 193] tokens (pad -100) and labels, and its
  assert on an ending past 193 tokens;
- the per-ending summed losses within 1e-2 relative of JAX's (the same
  body on JAX's forward; each logit rounds to bf16 in both) and the same
  argmin on every row, bf16 and ``mixed_precision``. The rows are made from
  a seed with numpy, their endings of 1 to 12 words: the whole sequence is
  scored, so the endings' lengths set the losses apart, and the smallest
  gap between a row's two best endings is asserted to exceed twice the
  largest difference between the packages;
- ``evaluate_hellaswag`` equal to JAX's, its ragged tail dropped (10 rows
  at batch 4 score 8), ``max_rows`` too.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.data import get_tokenizer as jget_tokenizer
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import hellaswag, quant
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.data import get_tokenizer
from quantized_training_tpu_torch.models import llama

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import hellaswag as jhs  # noqa: E402  (the JAX package's root script)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=4, max_position_embeddings=256)
WORDS = ("the", "a", "man", "woman", "dog", "ball", "runs", "throws", "into", "water", "slowly", "then", "[header]",
         "kitchen", "knife", "cuts", "onion", "smiles")
LOSS_BOUND = 1e-2


def make_rows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = lambda k: " ".join(rng.choice(WORDS, k))
    return [{"activity_label": words(2).capitalize(), "ctx_a": words(int(rng.integers(4, 10))) + " [title]",
             "ctx_b": words(int(rng.integers(1, 5))), "endings": [words(int(rng.integers(1, 13))) for _ in range(4)],
             "label": int(rng.integers(0, 4))} for _ in range(n)]


@pytest.mark.parametrize("text", [" A man [title] sits down.  He [step] smiles [substeps] ", "plain text",
                                  "[header] How to cook [title] Boil water.  Add [x] salt"])
def test_preprocess_equals_jax(text):
    assert hellaswag.preprocess(text) == jhs.preprocess(text)
    assert "[" not in hellaswag.preprocess(text)


def test_load_rows_json_and_jsonl(tmp_path):
    rows = make_rows(3, 0)
    (tmp_path / "r.json").write_text(json.dumps(rows))
    (tmp_path / "r.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    for name in ("r.json", "r.jsonl"):
        assert hellaswag._load_rows("validation", str(tmp_path / name)) == rows
        assert jhs._load_rows("validation", str(tmp_path / name)) == rows


def test_tokenize_rows_equals_jax():
    rows = make_rows(6, 1)
    ours = hellaswag.tokenize_rows(rows, get_tokenizer("byte"))
    theirs = jhs.tokenize_rows(rows, jget_tokenizer("byte"))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert ours[0].shape == (6, 4, 193) and (ours[0] == -100).any()
    long = dict(rows[0], endings=["x" * 200] * 4)
    with pytest.raises(AssertionError):
        hellaswag.tokenize_rows([long], get_tokenizer("byte"))


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**KW)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, llama.LlamaConfig(**KW), params_from_jax(jax.tree.map(np.asarray, jparams))


def _jax_losses(jparams, jcfg, data):
    """The body of JAX's ``make_predict`` before its argmin."""
    N, C, L = data.shape
    data = jnp.asarray(data)
    inputs = data[..., :-1].reshape(N * C, L - 1)
    logits = jllama.forward(jparams, jnp.maximum(inputs, 0).astype(jnp.int32), jcfg).astype(jnp.float32)
    labels = data[..., 1:].reshape(N * C, L - 1)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], axis=-1)[..., 0]
    return np.asarray(jnp.where(labels != -100, nll, 0.0).reshape(N, C, L - 1).sum(-1))


@pytest.mark.parametrize("scheme", [None, "mixed_precision"], ids=["bf16", "mixed_precision"])
def test_predictions_equal_jax(models, scheme):
    jcfg, jparams, cfg, params = models
    tokens, labels = jhs.tokenize_rows(make_rows(8, 2), jget_tokenizer("byte"))
    jl = _jax_losses(jquant.quantize_params(jparams, scheme), jcfg, tokens)
    tp = quant.quantize_params(params, scheme)
    tl = hellaswag.choice_losses(tp, cfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tl.shape == (8, 4)
    diff = np.abs(tl.numpy() - jl)
    assert (diff <= LOSS_BOUND * np.abs(jl)).all(), (diff / np.abs(jl)).max()
    best_two = np.sort(jl, -1)[:, :2]
    assert (best_two[:, 1] - best_two[:, 0]).min() > 2 * diff.max()
    preds = hellaswag.make_predict(cfg)(tp, torch.from_numpy(tokens))
    assert np.array_equal(preds.numpy(), jl.argmin(-1))


def test_evaluate_drops_the_ragged_tail(models, tmp_path):
    jcfg, jparams, cfg, params = models
    rows = make_rows(10, 3)
    path = tmp_path / "hs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    ours = hellaswag.evaluate_hellaswag(params, cfg, "byte", data_path=str(path), batch_size=4)
    theirs = jhs.evaluate_hellaswag(jparams, jcfg, "byte", data_path=str(path), batch_size=4)
    assert ours == theirs
    tokens, labels = hellaswag.tokenize_rows(rows, get_tokenizer("byte"))
    preds = hellaswag.make_predict(cfg)(params, torch.from_numpy(tokens[:8])).numpy()
    assert ours == (preds == labels[:8]).sum() / 8  # 8 rows scored, not 10
    assert (hellaswag.evaluate_hellaswag(params, cfg, "byte", data_path=str(path), batch_size=4, max_rows=6)
            == jhs.evaluate_hellaswag(jparams, jcfg, "byte", data_path=str(path), batch_size=4, max_rows=6))
