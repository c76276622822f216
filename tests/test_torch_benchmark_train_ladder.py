"""The port's ``benchmark_train_ladder`` against the JAX repository's: each of
the six rungs' first step (loss and pre-clip grad norm) against JAX's step
under the same ``MixedPrecisionConfig``, from JAX's weights carried over and
on the tokens the port's rung drew; each rung's kernel launches a step
against ``chip_smoke.ladder_per_step_launches`` (the counts phase 20 holds
the card to); the table, the filter and the rungs' failures. The small Llama
of tests/test_torch_train.py (2 layers, hidden 256) at batch 2 x 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import benchmark_train_ladder as ladder
from quantized_training_tpu_torch import llm_pretrain, quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from test_torch_train import _counting

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
B, S = 2, 128
RUNGS = ladder.RUNGS + ladder.SR_RUNGS
# (loss, grad norm), relative: tests/test_torch_train.py's BOUNDS for bf16
# mixed precision, every rung. Measured on the CPU: at most 1.2e-5 and
# 8.1e-4 round-to-nearest; the SR rungs, whose noise comes from other
# generators (Philox here, threefry in JAX), 1.2e-4 and 2.6e-3
BOUNDS = (1e-3, 5e-3)


class _Recorder:
    """Each step that ``train.make_train_step`` builds, recorded: its
    arguments and metrics, and the kernel calls it made (``counts``, from
    ``_counting``)."""

    def __init__(self, monkeypatch, counts=None):
        self.steps, self.counts, make = [], counts, train.make_train_step

        def made(*a, **kw):
            step = make(*a, **kw)

            def recorded(*args):
                before = dict(self.counts) if self.counts is not None else None
                state, m = step(*args)
                calls = None if before is None else {k: v - before[k] for k, v in self.counts.items()}
                self.steps.append((args, m, calls))
                return state, m

            return recorded

        monkeypatch.setattr(train, "make_train_step", made)


def test_rungs_are_jax_rungs():
    assert ladder.RUNGS + ladder.SR_RUNGS == [
        ("BF16 baseline", None), ("INT8 forward", dict(output=True, grad_input=False, grad_weight=False)),
        ("+ INT8 grad_input", dict(output=True, grad_input=True, grad_weight=False)),
        ("+ INT8 grad_weight", dict(output=True, grad_input=True, grad_weight=True)),
        ("INT8 fwd + SR", dict(output=True, grad_input=False, grad_weight=False, stochastic_rounding=True)),
        ("all INT8 + SR", dict(output=True, grad_input=True, grad_weight=True, stochastic_rounding=True))]
    assert ladder.N_STEPS == 6  # JAX's measure(n_steps=6)


@pytest.mark.parametrize("name,kw", RUNGS, ids=[n for n, _ in RUNGS])
def test_rung_first_step_vs_jax(monkeypatch, name, kw):
    """The rung's first step (``measure``, one synced and one chained step
    after it) from JAX's init carried over, against JAX's step from the same
    init under the same config, on the tokens the port's rung drew, with
    ``adamw_bf16_sr`` without SR at lr 1e-4: loss and pre-clip grad norm
    within BOUNDS."""
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rec = _Recorder(monkeypatch)
    ladder.measure(cfg, params_from_jax(jax.tree.map(np.asarray, jp)), kw, B, S, device="cpu", n_steps=1)
    assert len(rec.steps) == 3
    (_, tokens, labels, lr, _), tm, _ = rec.steps[0]
    jopt = joptim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    scheme = None if kw is None else "mixed_precision"
    jstate = jtrain.init_train_state(jquant.quantize_params(jp, scheme, **(kw or {})), jopt)
    _, jm = jtrain.make_train_step(jcfg, jopt, donate=False)(
        jstate, jnp.asarray(tokens.numpy(), jnp.int32), jnp.asarray(labels.numpy(), jnp.int32), lr,
        jax.random.PRNGKey(ladder.KEY))
    b_loss, b_gn = BOUNDS
    jl, tl, jg, tg = float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(tl - jl) <= b_loss * abs(jl), (tl, jl)
    assert abs(tg - jg) <= b_gn * jg, (tg, jg)


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("name,kw", RUNGS, ids=[n for n, _ in RUNGS])
def test_rung_launches_per_step(monkeypatch, name, kw, L):
    """Every step of a rung calls each kernel as often as
    ``chip_smoke.ladder_per_step_launches`` says (the card's launches: the
    fused layer where the config is fusable, the grouped pipeline, B6 once a
    leaf), counted on the CPU with the fused ops' plain versions."""
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    counts = _counting(monkeypatch)
    rec = _Recorder(monkeypatch, counts)
    quant.set_impl("interpret")
    try:
        cfg = llama.LlamaConfig(**{**KW, "num_hidden_layers": L}, remat=True, attention_impl="xla")
        params = llama.init_params(torch.Generator().manual_seed(0), cfg)
        ladder.measure(cfg, params, kw, B, S, device="cpu", n_steps=1)
    finally:
        quant.set_impl("auto")
    want = chip_smoke.ladder_per_step_launches(L, kw, len(chip_smoke.tree_leaves(params)))
    assert [chip_smoke.base_counts(calls) for _, _, calls in rec.steps] == [want] * 3


def test_table_filter_and_reference_column(monkeypatch, capsys):
    monkeypatch.setitem(llm_pretrain.MODELS, "llama2-1b", llama.LlamaConfig(**KW, attention_impl="xla"))
    monkeypatch.setattr(ladder, "N_STEPS", 1)
    rows = ladder.main(["--cpu", "--bs", "1", "--seq", "64", "--rungs", "BF16,grad_weight"])
    assert [r[0] for r in rows] == ["BF16 baseline", "+ INT8 grad_weight"] and rows[0][2] == 1.0
    table = [line for line in capsys.readouterr().out.splitlines() if line.startswith("|")]
    assert table[0] == "| Configuration | tok/s | speedup | reference (4070Ti) |"
    assert table[2].endswith("| 9,223 (1.00x) |") and table[3].endswith("| 15,517 (1.68x) |")


def test_failures(monkeypatch):
    """A rung out of device memory is skipped (the bf16 one aborts the
    ladder); any other error propagates."""
    monkeypatch.setitem(llm_pretrain.MODELS, "llama2-1b", llama.LlamaConfig(**KW, attention_impl="xla"))

    def measure_raising(fail_at, error):
        def measure(cfg, params, kw, *a, **k):
            if kw == fail_at:
                raise error
            return 100.0
        return measure

    monkeypatch.setattr(ladder, "measure", measure_raising(RUNGS[1][1], torch.OutOfMemoryError("oom")))
    assert [r[0] for r in ladder.main(["--cpu", "--seq", "64"])] == ["BF16 baseline", "+ INT8 grad_input",
                                                                      "+ INT8 grad_weight"]
    monkeypatch.setattr(ladder, "measure", measure_raising(None, torch.OutOfMemoryError("oom")))
    with pytest.raises(SystemExit, match="BF16 baseline failed"):
        ladder.main(["--cpu", "--seq", "64"])
    monkeypatch.setattr(ladder, "measure", measure_raising(RUNGS[2][1], ValueError("a kernel failed")))
    with pytest.raises(ValueError, match="a kernel failed"):
        ladder.main(["--cpu", "--seq", "64"])
