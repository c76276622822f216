"""The port's task evaluation through its drivers, on the CPU, at the small
Llama (2 layers, hidden 256, vocab 512):

- ``llm_evaluate --tasks hellaswag arc piqa``, then ``--tasks mc``, on local
  files (rows made from a seed with numpy, in each task's schema; byte
  tokenizer) give the accuracies of JAX's ``evaluate_hellaswag`` /
  ``evaluate_mc`` on the same parameters: the port's after 40 steps on a
  Markov chain, saved with the port's ``save_checkpoint`` and carried to
  JAX. The Markov ``mc`` set with ``--hellaswag_tokenizer ints`` and
  ``--max_rows`` too;
- ``llm_pretrain --hellaswag --hellaswag_interval 1``, the rows of
  ``hellaswag._load_rows`` replaced by local ones: ``hellaswag_acc`` logged
  and printed at every step, the last equal to ``evaluate_hellaswag`` on the
  run's final merged masters;
- ``accuracy_parity --steps 2 --eval_rows 8`` (at seq 32, batch 4): the
  eval file JAX's generator writes, the JSON summary of the four
  configurations, the markdown table;
- the options of ``accuracy_parity`` and ``mc_eval`` are those of the JAX
  scripts' ``--help``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import (accuracy_parity, hellaswag, llm_evaluate, llm_pretrain, mc_eval, optim, quant,
                                          train)
from quantized_training_tpu_torch.data import BatchLoader, MarkovTokenDataset
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.utils import save_checkpoint
from quantized_training_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import hellaswag as jhs  # noqa: E402  (the JAX package's root scripts)
import mc_eval as jmc  # noqa: E402

SMALL = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=4, vocab_size=512)
CHAIN = dict(vocab_size=512, n_states=64, branching=4)
WORDS = ("the", "a", "man", "dog", "ball", "runs", "into", "water", "then", "kitchen", "knife", "cuts", "jar", "lid")


def _words(rng, lo, hi):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def write_task_files(d: Path, seed: int = 0) -> dict:
    """Local files in each task's schema: HellaSwag JSONL, ARC and PIQA in
    their HF schemas, the generic ``mc`` format."""
    rng = np.random.default_rng(seed)
    rows = {
        "hellaswag": [{"activity_label": _words(rng, 1, 3), "ctx_a": _words(rng, 3, 8), "ctx_b": _words(rng, 1, 4),
                       "endings": [_words(rng, 1, 10) for _ in range(4)], "label": int(rng.integers(0, 4))}
                      for _ in range(9)],
        "arc": [{"question": _words(rng, 3, 8) + "?", "choices": {"text": [_words(rng, 1, 6) for _ in range(k)],
                                                                   "label": list("ABCDE"[:k])},
                 "answerKey": "ABCDE"[int(rng.integers(0, k))]} for k in (3, 4, 4, 5, 4, 3, 4)],
        "piqa": [{"goal": _words(rng, 2, 6), "sol1": _words(rng, 1, 8), "sol2": _words(rng, 1, 8),
                  "label": int(rng.integers(0, 2))} for _ in range(7)],
        "mc": [{"ctx": _words(rng, 2, 6), "choices": [" " + _words(rng, 1, 6) for _ in range(3)],
                "gold": int(rng.integers(0, 3))} for _ in range(6)],
    }
    paths = {}
    for task, rs in rows.items():
        paths[task] = d / f"{task}.jsonl"
        paths[task].write_text("".join(json.dumps(r) + "\n" for r in rs))
    return paths


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The small Llama after 40 bf16 steps on a Markov chain (the port's
    step), quantized ``mixed_precision``, saved as a port checkpoint; the
    same parameters in JAX."""
    d = tmp_path_factory.mktemp("tasks")
    cfg = llama.LlamaConfig(**SMALL)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state, step = train.init_train_state(params, opt), train.make_train_step(cfg, opt)
    it = iter(BatchLoader(MarkovTokenDataset(seq_len=32, **CHAIN), batch_size=8, prefetch=0))
    for i in range(40):
        tok, lab = next(it)
        state, _ = step(state, torch.from_numpy(tok), torch.from_numpy(lab), 3e-3, i)
    qparams = quant.quantize_params(state.params, "mixed_precision")
    save_checkpoint(d / "model.pkl", {"state": {"params": qparams}, "meta": {"step": 40}})
    jparams = jquant.quantize_params(
        jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), state.params), "mixed_precision")
    return d, qparams, jparams


def _evaluate(ckpt, *extra):
    return llm_evaluate.main(["--model", "llama2-470m", "--model_kwargs", json.dumps(SMALL), "--seq_len", "256",
                              "--quantize", "mixed_precision", "--ckpt", str(ckpt), "--batch_size", "4", "--cpu",
                              *extra])


def test_llm_evaluate_tasks_equal_jax(checkpoint):
    """One call runs hellaswag, arc and piqa: ``--task_data`` is one file for
    every task of a call, each reading its own schema's keys, so its rows
    hold an ARC row and a PIQA row at once (``mc``'s ``choices``, a list,
    cannot share a row with ARC's, a dict: it takes a call of its own)."""
    d, qparams, jparams = checkpoint
    paths = write_task_files(d)
    arc, piqa = (mc_eval.load_rows(str(paths[t])) for t in ("arc", "piqa"))
    both = d / "arc_piqa.jsonl"
    both.write_text("".join(json.dumps({**a, **p}) + "\n" for a, p in zip(arc, piqa)))
    jcfg = jllama.LlamaConfig(**SMALL, max_position_embeddings=256)
    out = _evaluate(d / "model.pkl", "--tasks", "hellaswag", "arc", "piqa", "--hellaswag_data",
                    str(paths["hellaswag"]), "--task_data", str(both), "--hellaswag_tokenizer", "byte")
    a, b = tree_leaves(out["params"]), tree_leaves(qparams)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    res = out["results"]
    assert set(res) == {"hellaswag_acc", "arc_acc", "piqa_acc"}
    assert res["hellaswag_acc"] == jhs.evaluate_hellaswag(jparams, jcfg, "byte", data_path=str(paths["hellaswag"]),
                                                          batch_size=4)
    for task in ("arc", "piqa"):
        assert res[f"{task}_acc"] == jmc.evaluate_mc(jparams, jcfg, task, str(paths[task]), tokenizer="byte",
                                                     batch_size=4)
    res = _evaluate(d / "model.pkl", "--tasks", "mc", "--task_data", str(paths["mc"]), "--hellaswag_tokenizer",
                    "byte")["results"]
    assert res == {"mc_acc": jmc.evaluate_mc(jparams, jcfg, "mc", str(paths["mc"]), tokenizer="byte", batch_size=4)}
    with pytest.raises(TypeError):  # arc's schema is not mc's
        _evaluate(d / "model.pkl", "--tasks", "arc", "--task_data", str(paths["mc"]), "--hellaswag_tokenizer", "byte")


def test_llm_evaluate_markov_mc_with_ints(checkpoint):
    d, _, jparams = checkpoint
    path = jmc.generate_markov_mc(str(d / "markov.jsonl"), n_rows=20, prompt_len=24, cont_len=6, **CHAIN)
    jcfg = jllama.LlamaConfig(**SMALL, max_position_embeddings=256)
    res = _evaluate(d / "model.pkl", "--tasks", "mc", "--task_data", path, "--hellaswag_tokenizer", "ints",
                    "--max_rows", "18")["results"]
    assert res["mc_acc"] == jmc.evaluate_mc(jparams, jcfg, "mc", path, tokenizer="ints", batch_size=4, max_rows=18)
    assert res["mc_acc"] > 0.4  # trained on the chain: above the 1/4 floor


def test_task_errors(checkpoint):
    d, _, _ = checkpoint
    with pytest.raises(ValueError, match="--task_data"):
        _evaluate(d / "model.pkl", "--tasks", "piqa")
    with pytest.raises(ValueError, match="unknown task"):
        _evaluate(d / "model.pkl", "--tasks", "winogrande")


def test_pretrain_hellaswag_hook(monkeypatch, tmp_path, capsys):
    paths = write_task_files(tmp_path, seed=1)
    rows = hellaswag._load_rows("validation", str(paths["hellaswag"]))
    seen = []

    def local_rows(split, data_path):
        seen.append((split, data_path))
        return rows

    monkeypatch.setattr(hellaswag, "_load_rows", local_rows)
    markov = json.dumps(dict(type="markov", **CHAIN))
    out = llm_pretrain.main(["--model_kwargs", json.dumps(SMALL), "--train_ds", markov, "--quantize", "mixed_precision",
                             "--batch_size", "2", "--seq_len", "32", "--n_steps", "2", "--log_interval", "1",
                             "--hellaswag", "--hellaswag_interval", "1",
                             "--hellaswag_tokenizer", "byte", "--cpu", "--save_dir", str(tmp_path / "runs")])
    assert seen == [("validation", None)] * 2  # the hub's split, as in the JAX package
    recs = [json.loads(l) for l in open(out["save_dir"] / "metrics.jsonl")]
    accs = [(r["step"], r["hellaswag_acc"]) for r in recs if "hellaswag_acc" in r]
    assert [s for s, _ in accs] == [1, 2] and all(0.0 <= a <= 1.0 for _, a in accs)
    state = out["state"]
    cfg = llama.LlamaConfig(**SMALL, max_position_embeddings=32)
    want = hellaswag.evaluate_hellaswag(quant.merge_masters(quant.virtual_params(state.params), state.params), cfg,
                                        "byte")
    assert accs[-1][1] == want
    assert f"step 2: hellaswag_acc={want:.4f}" in capsys.readouterr().out


def test_accuracy_parity_smoke(tmp_path, capsys):
    out = tmp_path / "p" / "parity.json"
    summary = accuracy_parity.main(["--steps", "2", "--eval_rows", "8", "--seq_len", "32", "--batch_size", "4",
                                    "--cpu", "--out", str(out)])
    ref = tmp_path / "ref.jsonl"
    jmc.generate_markov_mc(str(ref), n_rows=8, prompt_len=24, cont_len=6, n_choices=4, vocab_size=2048, n_states=512,
                           branching=4)
    assert (out.parent / "parity_mc.jsonl").read_bytes() == ref.read_bytes()
    assert json.loads(out.read_text()) == summary
    assert (summary["steps"], summary["eval_rows"], summary["seq_len"], summary["batch_size"]) == (2, 8, 32, 4)
    assert [r["config"] for r in summary["results"]] == [c[0] for c in accuracy_parity.CONFIGS]
    assert all(r["accuracy"] in {k / 8 for k in range(9)} and np.isfinite(r["final_loss"]) for r in summary["results"])
    # same init, same stream: two steps leave the four losses near ln(2048)
    losses = [r["final_loss"] for r in summary["results"]]
    assert max(losses) - min(losses) < 0.05 and abs(losses[0] - np.log(2048)) < 0.5
    table = capsys.readouterr().out
    assert "| Training config | MC accuracy | final loss |" in table and table.count("\n| ") == 5
    again = accuracy_parity.main(["--steps", "1", "--eval_rows", "8", "--seq_len", "32", "--batch_size", "4", "--cpu",
                                  "--out", str(out), "--configs", '["bf16"]'])
    assert [r["config"] for r in again["results"]] == ["bf16"]


@pytest.mark.parametrize("name", ["accuracy_parity", "mc_eval"])
def test_options_match_the_jax_scripts(name):
    proc = subprocess.run([sys.executable, str(REPO / f"{name}.py"), "--help"], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    module = {"accuracy_parity": accuracy_parity, "mc_eval": mc_eval}[name]
    theirs = set(re.findall(r"^\s+(--[a-z_]+)", proc.stdout, re.MULTILINE)) - {"--help"}  # the options' lines
    ours = {s for a in module._parser()._actions for s in a.option_strings} - {"-h", "--help"}
    assert ours == theirs


@pytest.mark.parametrize("n_seq,S", [(8, 29), (32, 55), (8, 32)], ids=["unfused", "fused_norm_mlp", "fused"])
def test_eval_forward_launches(monkeypatch, n_seq, S):
    """``chip_smoke.py::eval_forward_launches`` (the launches of a predict
    batch) against the wrappers' calls of one no-grad forward on the fused
    layer and the grouped pipeline, as the card runs it: at [8, 29] (232
    rows) nothing fuses, at [32, 55] (1,760 rows, gated as 1,792) the norms
    and the MLP fuse but the o-projection does not (S % 8), at [8, 32] (256
    rows) everything fuses. The sm90 counters are the card's."""
    import chip_smoke
    from test_torch_train import _counting

    from quantized_training_tpu_torch.quant import fused

    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    fused.set_impl("interpret")
    try:
        counts = _counting(monkeypatch)
        cfg = llama.LlamaConfig(**dict(SMALL, num_key_value_heads=2))
        params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (n_seq, S)))
        with torch.no_grad():
            llama.forward(params, tokens, cfg)
    finally:
        fused.set_impl("auto")
    want = chip_smoke.eval_forward_launches(cfg, n_seq, S)
    assert counts == {k: 0 if k.endswith("_sm90") else v for k, v in want.items()}
    L = cfg.num_hidden_layers
    assert want["scaled_mm_rhs_t"] == 7 * L and want["rope_group"] == 3 * L
    fused_ops = [want[k] for k in ("rmsnorm_quant_rowwise", "silu_mul_quant_rowwise", "ungroup_amax")]
    assert fused_ops == {"unfused": [0, 0, 0], "fused_norm_mlp": [2 * L, L, 0], "fused": [2 * L, L, L]}[
        {(8, 29): "unfused", (32, 55): "fused_norm_mlp", (8, 32): "fused"}[(n_seq, S)]]
