"""The port's ``bench`` driver against the JAX repository's ``bench.py``: the
step ``build_step`` builds, on JAX's parameters carried over by
``convert.py``, against JAX's ``build_step`` step; the JSON line against
JAX's ``main``'s; ``measure``'s steps and its choice of the faster loop on a
fake clock; the rungs (only an out-of-memory error takes the next) and the
``--cpu`` entry point, at the small Llama of tests/test_torch_train.py."""

import json

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import bench, llm_pretrain, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops.random import fold_in

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)
# tests/test_torch_sr.py's bounds for bench.py's step (loss, grad norm), relative
STEP_BOUNDS = {"mixed_precision": (1e-3, 5e-3), None: (1e-3, 5e-3)}


@pytest.fixture
def small(monkeypatch):
    """Both drivers' ``llama2-1b`` is the small Llama (JAX's bench reads
    ``llama.LLAMA2_1B`` when it builds)."""
    monkeypatch.setattr(jllama, "LLAMA2_1B", jllama.LlamaConfig(**KW, attention_impl="xla"))
    monkeypatch.setitem(llm_pretrain.MODELS, "llama2-1b", llama.LlamaConfig(**KW, attention_impl="xla"))


@pytest.mark.parametrize("scheme", ["mixed_precision", None])
def test_build_step_first_step_vs_jax(small, scheme):
    """The first step of the step ``build_step`` builds (remat, 2 x [2, 128]
    accumulation, adamw_bf16_sr without SR, lr 1e-4, key fold_in(2, 0)),
    from JAX's ``build_step`` state carried over, against JAX's step on
    JAX's tokens: loss and grad norm within STEP_BOUNDS."""
    jstate, jstep, jtok, jlab = jbench.build_step("llama2-1b", 2, 128, scheme, accum=2)
    state, step, tok, lab = bench.build_step("llama2-1b", 2, 128, scheme, accum=2, device="cpu")
    assert tok.shape == jtok.shape == (2, 2, 128) and torch.equal(lab, torch.roll(tok, -1, dims=-1))
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    t_tok, t_lab = (torch.from_numpy(np.array(a)).long() for a in (jtok, jlab))
    _, jm = jstep(jstate, jtok, jlab, 1e-4, jax.random.fold_in(jax.random.PRNGKey(2), 0))
    _, tm = step(tstate, t_tok, t_lab, bench.LR, fold_in(bench.KEY, 0))
    b_loss, b_gn = STEP_BOUNDS[scheme]
    jl, tl, jg, tg = float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(tl - jl) <= b_loss * abs(jl), (tl, jl)
    assert abs(tg - jg) <= b_gn * jg, (tg, jg)


def test_result_line_has_jax_keys(monkeypatch, capsys):
    """JAX's ``main`` with its measurements faked prints the line the port's
    ``result_line`` gives for the same rates, key for key and number for
    number (the device's name aside)."""
    monkeypatch.setenv("QT_COMPILE_CACHE", "")  # no persistent XLA cache from JAX's main
    rates = {"mixed_precision": 12345.678, None: 9876.54}
    monkeypatch.setattr(jbench, "try_measure", lambda configs, scheme: (rates[scheme], configs[0]))
    jbench.main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = bench.result_line(rates["mixed_precision"], rates[None], bench.RUNGS[0], "cpu")
    assert list(line) == list(jline) and list(line["detail"]) == list(jline["detail"])
    assert {k: v for k, v in line.items() if k != "detail"} == {k: v for k, v in jline.items() if k != "detail"}
    assert {k: v for k, v in line["detail"].items() if k != "device"} == \
        {k: v for k, v in jline["detail"].items() if k != "device"}
    assert line["vs_baseline"] == round(rates["mixed_precision"] / rates[None] / 1.68, 4)


class _Clock:
    """A fake ``time`` module whose clock each step moves on."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_measure_counts_steps_and_takes_the_faster_loop(monkeypatch):
    """2 warm steps, N_STEPS synced and N_STEPS chained (JAX :77-118); the
    rate is the tokens over the faster loop's step time."""
    clock = _Clock()
    keys = []
    for synced, chained in ((3.0, 2.0), (1.0, 2.0)):
        keys.clear()

        def step(state, tokens, labels, lr, key):
            keys.append(key)
            clock.now += 10.0 if len(keys) <= 2 else synced if len(keys) <= 2 + bench.N_STEPS else chained
            return state, {"loss": torch.tensor(1.0)}

        monkeypatch.setattr(bench, "time", clock)
        monkeypatch.setattr(bench, "build_step", lambda *a: (None, step, torch.zeros(4, 4, 2048), None))
        got = bench.measure("llama2-1b", 4, 2048, "mixed_precision", 4, "cpu")
        assert len(keys) == 2 + 2 * bench.N_STEPS == 2 + 2 * jbench.N_STEPS
        assert keys[:3] == [fold_in(2, 0), fold_in(2, 1), fold_in(2, 100)] and keys[-1] == fold_in(2, 207)
        assert (got.synced_s, got.chained_s) == (synced, chained)
        assert got.tokens_per_sec == 4 * 4 * 2048 / min(synced, chained)


def test_non_finite_loss_raises(monkeypatch):
    step = lambda state, *a: (state, {"loss": torch.tensor(float("nan"))})
    monkeypatch.setattr(bench, "build_step", lambda *a: (None, step, torch.zeros(2, 8), None))
    with pytest.raises(FloatingPointError):
        bench.measure("llama2-1b", 2, 8, None, 1, "cpu", n_steps=1)


def test_out_of_memory_takes_the_next_rung_and_other_errors_propagate(monkeypatch, capsys):
    calls = []

    def measure(cfg_name, bs, seq, scheme, accum, device):
        calls.append((cfg_name, bs, seq, accum, scheme))
        if len(calls) == 1:
            raise torch.OutOfMemoryError("out of memory")
        return bench.Measured(1000.0 if scheme else 800.0, 1.0, 1.0)

    monkeypatch.setattr(bench, "measure", measure)
    line = bench.main(["--cpu"])
    assert calls == [(*bench.RUNGS[0], "mixed_precision"), (*bench.RUNGS[1], "mixed_precision"),
                     (*bench.RUNGS[1], None)]
    assert (line["detail"]["batch_size"], line["detail"]["grad_accum"]) == (8, 1)
    assert json.loads(capsys.readouterr().out) == line

    def broken(*a):
        raise ValueError("a kernel failed")

    monkeypatch.setattr(bench, "measure", broken)
    with pytest.raises(ValueError, match="a kernel failed"):
        bench.main(["--cpu"])


def test_every_rung_out_of_memory_exits(monkeypatch):
    def oom(*a):
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(bench, "measure", oom)
    with pytest.raises(SystemExit):
        bench.main(["--cpu"])


def test_entry_point_on_the_cpu(small, monkeypatch, capsys):
    """``main(["--cpu"])`` at the small Llama and one short rung: one JSON
    line on stdout, the int8 and bf16 rates in it."""
    monkeypatch.setattr(bench, "RUNGS", [("llama2-1b", 2, 64, 2)])
    monkeypatch.setattr(bench, "N_STEPS", 1)
    line = bench.main(["--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["value"] > 0 and line["detail"]["bf16_tokens_per_sec"] > 0 and line["detail"]["device"] == "cpu"


def test_the_card_is_required_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main([])
