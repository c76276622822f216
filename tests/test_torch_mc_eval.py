"""The port's multiple-choice tasks (``quantized_training_tpu_torch.mc_eval``)
against the JAX package's ``mc_eval.py``, on the CPU.

The five tests of ``tests/test_mc_eval.py`` run again on the port (its tiny
Llama, hidden 64). Beside them, at the small Llama (2 layers, hidden 256,
vocab 512) on inputs made from seeds:

- ``generate_markov_mc`` writes JAX's file byte for byte;
- ``tokenize_mc`` gives JAX's four arrays on ``arc``, ``piqa`` and ``mc``
  rows;
- ``make_predict``'s per-choice summed losses are within 1e-2 relative of
  JAX's (the same body on JAX's forward), bf16 and ``mixed_precision``,
  with the same argmin on every row. The parameters are the port's after 40
  steps on the task's Markov chain, carried to JAX: at random init the
  choices' losses lie within rounding of each other (their smallest gap
  was 1e-4 of 50), which no argmin can resolve; trained, the smallest gap
  between a row's two best choices is asserted to exceed twice the largest
  difference between the packages. Each logit is rounded to bf16 (2^-9
  relative) by both models, in summation orders of their own;
- ``evaluate_mc`` gives JAX's accuracy at a ragged batch (24 rows, batch 7).
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
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import mc_eval, optim, quant, train
from quantized_training_tpu_torch.data import BatchLoader, MarkovTokenDataset
from quantized_training_tpu_torch.models import llama

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import mc_eval as jmc  # noqa: E402  (the JAX package's root script)

TINY = llama.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64)
KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=4, max_position_embeddings=128)
CHAIN = dict(vocab_size=512, n_states=64, branching=4)
LOSS_BOUND = 1e-2


def byte_tok(s: str):
    return [b % 256 for b in s.encode()]


def _tiny_params():
    return llama.init_params(torch.Generator().manual_seed(0), TINY)


# ---- the five tests of tests/test_mc_eval.py, on the port ---------------------------


def test_formats_parse():
    ctx, choices, gold = mc_eval.FORMATS["arc"]({"question": "What is 2+2?",
                                                 "choices": {"text": ["3", "4"], "label": ["A", "B"]},
                                                 "answerKey": "B"})
    assert gold == 1 and len(choices) == 2 and "2+2" in ctx
    ctx, choices, gold = mc_eval.FORMATS["piqa"]({"goal": "open a jar", "sol1": "twist the lid", "sol2": "eat it",
                                                  "label": 0})
    assert gold == 0 and len(choices) == 2
    ctx, choices, gold = mc_eval.FORMATS["mc"]({"ctx": "Q", "choices": ["a", "b", "c"], "gold": 2})
    assert gold == 2 and len(choices) == 3


def test_continuation_only_scoring():
    """Context tokens are excluded from the choice loss (score_mask)."""
    rows = [{"ctx": "same context", "choices": [" aa", " bb"], "gold": 0}]
    tokens, score_mask, gold, valid = mc_eval.tokenize_mc(rows, mc_eval.FORMATS["mc"], byte_tok)
    ctx_len = len(byte_tok("same context"))
    assert not score_mask[0, :, :ctx_len].any()
    assert score_mask[0, 0].sum() == len(byte_tok(" aa"))
    assert valid.all()


def test_padded_choice_never_selected():
    """Rows with fewer choices than the task's most cannot predict a pad slot."""
    rows = [{"ctx": "q1", "choices": [" a", " b", " c", " d"], "gold": 0},
            {"ctx": "q2", "choices": [" a", " b"], "gold": 1}]
    tokens, score_mask, gold, valid = mc_eval.tokenize_mc(rows, mc_eval.FORMATS["mc"], byte_tok)
    assert valid[1].tolist() == [True, True, False, False]
    preds = mc_eval.make_predict(TINY)(_tiny_params(), *(torch.from_numpy(a) for a in (tokens, score_mask, valid)))
    assert preds[1] < 2


def test_evaluate_mc_end_to_end(tmp_path):
    rows = [{"ctx": f"question {i}", "choices": [" yes", " no", " maybe"], "gold": i % 3} for i in range(7)]
    path = tmp_path / "mc.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    params = _tiny_params()
    acc = mc_eval.evaluate_mc(params, TINY, "mc", str(path), tokenizer=byte_tok, batch_size=4)
    assert 0.0 <= acc <= 1.0
    # every row is scored: the ragged tail of 7 % 4 rows too
    assert acc == mc_eval.evaluate_mc(params, TINY, "mc", str(path), tokenizer=byte_tok, batch_size=7)


def _train(cfg, chain, steps: int, seq_len: int, batch: int, scheme=None):
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), scheme)
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state, step = train.init_train_state(params, opt), train.make_train_step(cfg, opt)
    it = iter(BatchLoader(MarkovTokenDataset(seq_len=seq_len, **chain), batch_size=batch, prefetch=0))
    for i in range(steps):
        tok, lab = next(it)
        state, _ = step(state, torch.from_numpy(tok), torch.from_numpy(lab), 3e-3, i)
    return params, quant.merge_masters(quant.virtual_params(state.params), state.params)


def test_markov_mc_generation_and_learnability(tmp_path):
    """The generated Markov set is solved by a model trained on its chain
    and sits near the 1/4 floor untrained."""
    path = str(tmp_path / "markov_mc.jsonl")
    mc_eval.generate_markov_mc(path, n_rows=24, prompt_len=12, cont_len=4, n_choices=4,
                               vocab_size=TINY.vocab_size, n_states=64, branching=4)
    rows = [json.loads(l) for l in open(path)]
    assert len(rows) == 24 and all(len(r["choices"]) == 4 and 0 <= r["gold"] < 4 for r in rows)
    params, trained = _train(TINY, dict(vocab_size=TINY.vocab_size, n_states=64, branching=4), 300, 32, 16,
                             "mixed_precision")
    acc_untrained = mc_eval.evaluate_mc(params, TINY, "mc", path, tokenizer="ints", batch_size=8)
    acc_trained = mc_eval.evaluate_mc(trained, TINY, "mc", path, tokenizer="ints", batch_size=8)
    assert acc_untrained < 0.6
    assert acc_trained >= 0.75, (acc_untrained, acc_trained)


# ---- against the JAX package ------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_rows=24, prompt_len=12, cont_len=4, vocab_size=512, n_states=64, branching=4),
                                dict(n_rows=40, prompt_len=48, cont_len=8, n_choices=5, seed=7)])
def test_generate_markov_mc_writes_jaxs_bytes(tmp_path, kw):
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    assert mc_eval.generate_markov_mc(str(ours), **kw) == str(ours)
    jmc.generate_markov_mc(str(theirs), **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(mc_eval.load_rows(str(ours))) == kw["n_rows"]


ROWS = {
    "arc": [{"question": "Which gas do plants take in?", "choices": {"text": ["oxygen", "carbon dioxide", "argon"],
                                                                    "label": ["A", "B", "C"]}, "answerKey": "B"},
            {"question": "2+2?", "choices": {"text": ["3", "4", "5", "22"], "label": ["1", "2", "3", "4"]},
             "answerKey": "2"}],
    "piqa": [{"goal": "open a jar", "sol1": "twist the lid", "sol2": "eat it", "label": 0},
             {"goal": "dry wet socks", "sol1": "freeze them", "sol2": "hang them in the sun", "label": 1}],
    "mc": [{"ctx": "The cat", "choices": [" sat", " flew away quickly", " ran"], "gold": 0},
           {"ctx": "Once upon a", "choices": [" time", " tree"], "gold": 0}],
}


@pytest.mark.parametrize("task", ["arc", "piqa", "mc"])
@pytest.mark.parametrize("max_len", [None, 12])
def test_tokenize_mc_equals_jax(task, max_len):
    from quantized_training_tpu.data import get_tokenizer as jget_tokenizer
    from quantized_training_tpu_torch.data import get_tokenizer

    ours = mc_eval.tokenize_mc(ROWS[task], mc_eval.FORMATS[task], get_tokenizer("byte"), max_len)
    theirs = jmc.tokenize_mc(ROWS[task], jmc.FORMATS[task], jget_tokenizer("byte"), max_len)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert mc_eval.int_tokenizer(" 3 14 15") == jmc.int_tokenizer(" 3 14 15") == [3, 14, 15]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The small Llama after 40 bf16 steps on the task's chain (the port's
    step), its parameters carried to JAX as bf16 arrays, and a Markov set of
    24 rows of 24 + 6 tokens."""
    cfg = llama.LlamaConfig(**KW)
    _, params = _train(cfg, CHAIN, 40, 32, 8)
    path = str(tmp_path_factory.mktemp("mc") / "mc.jsonl")
    jmc.generate_markov_mc(path, n_rows=24, prompt_len=24, cont_len=6, **CHAIN)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), params)
    return cfg, params, jparams, path


def _jax_losses(jparams, jcfg, tokens, mask):
    """The body of JAX's ``make_predict`` before its argmin."""
    N, C, L = tokens.shape
    logits = jllama.forward(jparams, jnp.asarray(tokens[..., :-1].reshape(N * C, L - 1), jnp.int32),
                            jcfg).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, jnp.asarray(tokens[..., 1:].reshape(N * C, L - 1))[..., None], axis=-1)[..., 0]
    return np.asarray(jnp.where(jnp.asarray(mask[..., 1:].reshape(N * C, L - 1)), nll, 0.0).reshape(N, C, L - 1)
                      .sum(-1))


@pytest.mark.parametrize("scheme", [None, "mixed_precision"], ids=["bf16", "mixed_precision"])
def test_choice_losses_match_jax(trained, scheme):
    cfg, params, jparams, path = trained
    tokens, mask, gold, valid = jmc.tokenize_mc(jmc.load_rows(path), jmc.FORMATS["mc"], jmc.int_tokenizer)
    jl = _jax_losses(jquant.quantize_params(jparams, scheme), jllama.LlamaConfig(**KW), tokens, mask)
    tp = quant.quantize_params(params, scheme)
    tl = mc_eval.choice_losses(tp, cfg, *(torch.from_numpy(a) for a in (tokens, mask, valid)))
    assert tl.dtype == torch.float32 and tl.shape == (24, 4)
    tl = tl.numpy()
    diff = np.abs(tl - jl)
    assert (diff <= LOSS_BOUND * np.abs(jl)).all(), (diff / np.abs(jl)).max()
    best_two = np.sort(jl, -1)[:, :2]
    assert (best_two[:, 1] - best_two[:, 0]).min() > 2 * diff.max()
    preds = mc_eval.make_predict(cfg)(tp, *(torch.from_numpy(a) for a in (tokens, mask, valid)))
    assert np.array_equal(preds.numpy(), jl.argmin(-1))
    assert (preds.numpy() == gold).mean() > 0.4  # trained: above the 1/4 floor


@pytest.mark.parametrize("scheme", [None, "mixed_precision"], ids=["bf16", "mixed_precision"])
def test_evaluate_mc_equals_jax_at_a_ragged_batch(trained, scheme):
    cfg, params, jparams, path = trained
    ours = mc_eval.evaluate_mc(quant.quantize_params(params, scheme), cfg, "mc", path, tokenizer="ints",
                               batch_size=7)
    theirs = jmc.evaluate_mc(jquant.quantize_params(jparams, scheme), jllama.LlamaConfig(**KW), "mc", path,
                             tokenizer="ints", batch_size=7)
    assert ours == theirs and ours > 0.4
    assert mc_eval.evaluate_mc(quant.quantize_params(params, scheme), cfg, "mc", path, tokenizer="ints",
                               batch_size=7, max_rows=10) == jmc.evaluate_mc(
        jquant.quantize_params(jparams, scheme), jllama.LlamaConfig(**KW), "mc", path, tokenizer="ints",
        batch_size=7, max_rows=10)


def test_generator_command_line(tmp_path):
    out = tmp_path / "cli.jsonl"
    assert mc_eval.main([str(out), "--n_rows", "12", "--prompt_len", "8", "--cont_len", "3", "--vocab_size", "300",
                         "--n_states", "40", "--branching", "3", "--seed", "5"]) == str(out)
    ref = tmp_path / "ref.jsonl"
    jmc.generate_markov_mc(str(ref), n_rows=12, prompt_len=8, cont_len=3, vocab_size=300, n_states=40,
                           branching=3, seed=5)
    assert out.read_bytes() == ref.read_bytes()
