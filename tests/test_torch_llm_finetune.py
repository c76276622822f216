"""The port's finetune driver (``quantized_training_tpu_torch.llm_finetune``)
against the JAX package's ``llm_finetune.py``, on the CPU, at the small
Llama (2 layers, hidden 256, vocab 512, at most 128 tokens):

- ``data_iter``'s batches equal JAX's over three permutations of the
  samples, padded to multiples of ``seq_len_multiple`` with inputs 0 and
  labels -100;
- ``load_samples`` equals JAX's on ``synthetic`` and on a local JSONL
  file (the template, bos and eos, the cut at ``--max_seq_len``);
- the quantize filter wraps every linear weight, narrow ones too, but the
  lm_head's;
- a 3-step ``--cpu`` run from JAX's initialization (carried through
  ``--init_ckpt``) takes JAX's first step's loss on the same batch within
  ``tests/test_torch_train.py``'s bound (bf16 ``mixed_precision``: 1e-3
  relative), logs every step and writes the model-only checkpoint;
- ``--init_ckpt`` loads a checkpoint's parameters bit for bit, from a
  train state (``llm_pretrain``'s) and from ``{"params"}``;
- the labels are the inputs, unshifted, as JAX writes them, and the loss
  scores position t against ``labels[t]`` in both packages: a fault of the
  JAX package kept for parity (ROADMAP C);
- ``llm_evaluate --ckpt`` loads the model-only checkpoint bit for bit;
- the options are those of ``python llm_finetune.py --help`` but
  ``--cache_dir``, and a run without a card or ``--cpu`` raises.
"""

import json
import re
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.data import get_tokenizer as jget_tokenizer
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.quant.api import _is_linear_weight_path as j_is_linear
from quantized_training_tpu_torch import llm_evaluate, llm_finetune, llm_pretrain, mc_eval, quant
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.data import get_tokenizer
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.quant.node import WeightNode
from quantized_training_tpu_torch.utils import load_checkpoint, save_checkpoint
from quantized_training_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import llm_finetune as jft  # noqa: E402  (the JAX package's root script)

SMALL = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=512)
LOSS_BOUND = 1e-3  # tests/test_torch_train.py, bf16 mixed_precision


def _samples(n: int, seed: int, lo: int = 5, hi: int = 120):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, rng.integers(lo, hi)).tolist() for _ in range(n)]


@pytest.mark.parametrize("batch,multiple", [(2, 32), (3, 16)])
def test_data_iter_equals_jax(batch, multiple):
    samples = _samples(7, 0)
    n_batches = 3 * (len(samples) // batch)  # three permutations
    ours, theirs = llm_finetune.data_iter(samples, batch, multiple, 11), jft.data_iter(samples, batch, multiple, 11)
    lengths = set()
    for _ in range(n_batches):
        (a, al), (b, bl) = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.int32 and al.dtype == bl.dtype == np.int64
        assert np.array_equal(a, b) and np.array_equal(al, bl)
        assert a.shape[1] % multiple == 0 and a.shape[0] == batch
        lengths.add(a.shape[1])
    assert len(lengths) > 1


def test_labels_are_the_inputs_unshifted():
    """JAX's data_iter writes each sample into inputs and labels alike, and
    both packages' loss scores position t against labels[t]: the step
    learns to copy the token it is given, not to predict the next one."""
    samples = _samples(4, 1)
    tok, lab = next(llm_finetune.data_iter(samples, 2, 32, 0))
    valid = lab != -100
    assert np.array_equal(tok[valid], lab[valid]) and (tok[~valid] == 0).all()
    cfg = llama.LlamaConfig(**SMALL, attention_impl="xla")
    jcfg = jllama.LlamaConfig(**SMALL, attention_impl="xla")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    t, l = torch.from_numpy(tok), torch.from_numpy(lab)
    logp = torch.log_softmax(llama.forward(params, t, cfg).float(), -1)
    unshifted = -logp.gather(-1, l.clamp(min=0)[..., None])[..., 0][torch.from_numpy(valid)].mean()
    shifted = -logp[:, :-1].gather(-1, l[:, 1:].clamp(min=0)[..., None])[..., 0][torch.from_numpy(valid[:, 1:])].mean()
    ours = llama.loss_fn(params, t, l, cfg)
    theirs = float(jllama.loss_fn(jparams, jnp.asarray(tok), jnp.asarray(lab), jcfg))
    assert abs(ours.item() - unshifted.item()) <= 1e-5 * unshifted.item()
    assert abs(ours.item() - shifted.item()) > 1e-4 * shifted.item()  # 10x the bound above, at least
    assert abs(ours.item() - theirs) <= 1e-5 * theirs


def test_load_samples_equals_jax(tmp_path):
    args = Namespace(dataset="synthetic", model_kwargs={"vocab_size": 300}, max_seq_len=64)
    ours = llm_finetune.load_samples(args, None)
    assert ours == jft.load_samples(args, None) and len(ours) == 256
    assert max(map(max, ours)) < 300 and max(map(len, ours)) < 64
    rows = [{"query": "What is 2+3?", "response": "It is 5."}, {"query": "Name a colour " * 30, "response": "red"}]
    (tmp_path / "d.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    args = Namespace(dataset=str(tmp_path / "d.jsonl"), model_kwargs={}, max_seq_len=400)
    ours = llm_finetune.load_samples(args, get_tokenizer("byte"))
    assert ours == jft.load_samples(args, jget_tokenizer("byte"))
    assert ours[0][0] == 256 and ours[0][-1] == 257 and len(ours[1]) == 400  # bos, eos; the cut
    assert llm_finetune.TEMPLATE == jft.TEMPLATE


def test_filter_keeps_the_lm_head_unquantized():
    cfg = llama.LlamaConfig(**dict(SMALL, hidden_size=64, intermediate_size=96, num_attention_heads=2))
    q = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision",
                              filter_fn=llm_finetune.not_lm_head)
    assert isinstance(q["lm_head"]["w"], torch.Tensor)
    # every body linear is wrapped, below the default filter's 128 too
    assert all(isinstance(q["layers"][k]["w"], WeightNode) for k in ("q", "k", "v", "o", "gate", "up", "down"))
    assert isinstance(q["embed"]["embedding"], torch.Tensor)


def _argv(tmp_path, *extra):
    return ["--model", "llama2-470m", "--model_kwargs", json.dumps(SMALL), "--dataset", "synthetic",
            "--max_seq_len", "128", "--seq_len_multiple", "32", "--batch_size", "2", "--quantize", "mixed_precision",
            "--log_interval", "1", "--cpu", *extra]


@pytest.fixture(scope="module")
def from_jax(tmp_path_factory):
    """JAX's initialization quantized with JAX's finetune filter, saved as a
    port checkpoint; the port's 3-step run from it; JAX's first step on the
    run's first batch."""
    tmp_path = tmp_path_factory.mktemp("finetune")
    jcfg = jllama.LlamaConfig(**SMALL, max_position_embeddings=128, remat=True, attention_impl="xla")
    jp = jquant.quantize_params(
        jllama.init_params(jax.random.PRNGKey(0), jcfg), "mixed_precision",
        filter_fn=lambda path, leaf: j_is_linear(path) and "lm_head" not in [getattr(p, "key", None) for p in path])
    ckpt = tmp_path / "init.pkl"
    save_checkpoint(ckpt, {"state": {"params": params_from_jax(jax.tree.map(np.asarray, jp))}})
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp_path)
    try:
        out = llm_finetune.main(_argv(tmp_path, "--init_ckpt", str(ckpt), "--n_steps", "3", "--ckpt_interval", "3",
                                      "--run_name", "ft"))
    finally:
        mp.undo()
    args = Namespace(dataset="synthetic", model_kwargs=SMALL, max_seq_len=128)
    tok, lab = next(jft.data_iter(jft.load_samples(args, None), 2, 32, 2024))
    jopt = joptim.get_optimizer("adamw", weight_decay=0.0)
    _, jm = jtrain.make_train_step(jcfg, jopt, donate=False)(jtrain.init_train_state(jp, jopt), jnp.asarray(tok),
                                                            jnp.asarray(lab), 1e-4, jax.random.PRNGKey(0))
    return dict(out=out, ckpt=ckpt, jloss=float(jm["loss"]), seq_len=tok.shape[1], save_dir=tmp_path / out["save_dir"])


def test_first_loss_matches_jax(from_jax):
    rows = [json.loads(l) for l in open(from_jax["save_dir"] / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert set(rows[0]) == {"step", "ts", "loss", "grad_norm", "lr", "seq_len", "steps_per_second"}
    assert rows[0]["seq_len"] == from_jax["seq_len"] and all(r["seq_len"] % 32 == 0 for r in rows)
    assert abs(rows[0]["loss"] - from_jax["jloss"]) <= LOSS_BOUND * abs(from_jax["jloss"]), (rows[0], from_jax)
    assert all(np.isfinite(r["loss"]) and r["lr"] == 1e-4 for r in rows)
    assert from_jax["out"]["state"].step == 3


def test_model_only_checkpoint(from_jax):
    ckpt = load_checkpoint(from_jax["save_dir"] / "last.pkl")
    assert set(ckpt) == {"state", "meta"} and set(ckpt["state"]) == {"params"} and ckpt["meta"] == {"step": 3}
    a, b = tree_leaves(ckpt["state"]["params"]), tree_leaves(from_jax["out"]["state"].params)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_init_ckpt_loads_bit_for_bit(from_jax, tmp_path, monkeypatch):
    """Zero steps from ``{"params"}`` and from a train state (``state[0]``):
    the state entered is the checkpoint's parameters bit for bit."""
    monkeypatch.chdir(tmp_path)
    want = tree_leaves(load_checkpoint(from_jax["ckpt"])["state"]["params"])
    out = llm_finetune.main(_argv(tmp_path, "--init_ckpt", str(from_jax["ckpt"]), "--n_steps", "0"))
    got = tree_leaves(out["state"].params)
    assert len(got) == len(want) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
    pre = llm_pretrain.main(["--model_kwargs", json.dumps(SMALL), "--train_ds", '{"type": "markov", "vocab_size": 512}',
                             "--quantize", "mixed_precision", "--batch_size", "2", "--seq_len", "32", "--n_steps", "1",
                             "--ckpt_interval", "1", "--cpu", "--save_dir", str(tmp_path / "pre")])
    out = llm_finetune.main(_argv(tmp_path, "--init_ckpt", str(pre["save_dir"] / "last.pkl"), "--n_steps", "0"))
    got, want = tree_leaves(out["state"].params), tree_leaves(pre["state"].params)
    assert len(got) == len(want) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))


def test_llm_evaluate_reads_the_finetune_checkpoint(from_jax, tmp_path):
    path = mc_eval.generate_markov_mc(str(tmp_path / "mc.jsonl"), n_rows=6, prompt_len=8, cont_len=3,
                                      vocab_size=512, n_states=32, branching=4)
    out = llm_evaluate.main(["--model", "llama2-470m", "--model_kwargs", json.dumps(SMALL), "--seq_len", "128",
                             "--quantize", "mixed_precision", "--ckpt", str(from_jax["save_dir"] / "last.pkl"),
                             "--tasks", "mc", "--task_data", path, "--hellaswag_tokenizer", "ints", "--cpu"])
    a, b = tree_leaves(out["params"]), tree_leaves(from_jax["out"]["state"].params)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert 0.0 <= out["results"]["mc_acc"] <= 1.0


def test_options_match_the_jax_driver():
    proc = subprocess.run([sys.executable, str(REPO / "llm_finetune.py"), "--help"], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    theirs = set(re.findall(r"(--[a-z_]+)", proc.stdout)) - {"--help"}
    ours = {s for a in llm_finetune._parser()._actions for s in a.option_strings} - {"-h", "--help"}
    assert ours == theirs - {"--cache_dir"} and "--cache_dir" in theirs


def test_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        llm_finetune.main(["--n_steps", "1"])
    assert not list(tmp_path.iterdir())


def test_finetune_per_step_launches(monkeypatch, tmp_path):
    """``chip_smoke.py::finetune_per_step_launches`` against the wrappers'
    calls of a 3-step ``--optim adamw_bf16_sr`` run on the fused layer and
    the grouped pipeline, as the card runs it, batches padded to 256 or 512
    (``--seq_len_multiple 256``): the sum of the formula at each logged
    length. The sm90 counters are the card's."""
    import chip_smoke
    from test_torch_train import _counting

    from quantized_training_tpu_torch.quant import fused

    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    monkeypatch.chdir(tmp_path)
    fused.set_impl("interpret")
    try:
        counts = _counting(monkeypatch)
        argv = _argv(tmp_path, "--n_steps", "3", "--optim", "adamw_bf16_sr")
        argv[argv.index("--max_seq_len") + 1], argv[argv.index("--seq_len_multiple") + 1] = "512", "256"
        out = llm_finetune.main(argv)
    finally:
        fused.set_impl("auto")
    lengths = [json.loads(l)["seq_len"] for l in open(out["save_dir"] / "metrics.jsonl")]
    assert sorted(set(lengths)) == [256, 512]
    cfg = llama.LlamaConfig(**SMALL, remat=True)
    n_leaves = len(tree_leaves(out["state"].params))
    want = dict.fromkeys(counts, 0)
    for S in lengths:
        for k, v in chip_smoke.finetune_per_step_launches(cfg, 2, S, n_leaves).items():
            want[k] += 0 if k.endswith("_sm90") else v
    assert counts == want and want["fused_adamw_update_sr"] == 3 * 12
