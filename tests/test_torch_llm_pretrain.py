"""The port's LLM drivers on the CPU, in process, at a small Llama (2
layers, hidden 128, vocab 256, seq 32), as ``tests/test_resume.py`` drives
the JAX package's ``llm_pretrain.py``:

- ``LlamaConfig.from_hf_json`` on ``mini_llamas/Llama-2-470m`` equals the
  JAX package's, and ``make_eval_step`` gives the JAX eval step's loss on
  parameters carried across, within ``tests/test_torch_train.py``'s loss
  bounds;
- 3 steps, a checkpoint and a resume to 6 give the losses of 6 uninterrupted
  steps bit for bit, at ``int8_quantized_training`` with ``adamw`` and at
  ``mixed_precision`` with ``schedule_free_adamw_8bit`` (each with gradient
  accumulation once);
- ``llm_evaluate`` on that checkpoint gives the perplexity that
  ``make_eval_step`` gives on the loaded parameters;
- the native loader with the 8-bit optimizer trains, ``--profile`` writes a
  trace, and the CLI entry point runs in a subprocess;
- the drivers' options are those that ``python llm_pretrain.py --help`` and
  ``python llm_evaluate.py --help`` print, less ``--cache_dir`` (XLA's
  compilation cache); ``--mesh`` runs on two gloo ranks and resumes from
  a file a rank; a run without a card or ``--cpu`` raises.
"""

import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.data import get_dataset as jget_dataset
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import llm_evaluate, llm_pretrain, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.utils import load_checkpoint
from quantized_training_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=128, num_attention_heads=2,
             num_key_value_heads=2, vocab_size=256)
MARKOV = dict(type="markov", vocab_size=256, n_states=32)
# the JAX drivers' options the port's leave out, with the reason in the
# drivers' docstrings: --cache_dir is XLA's compilation cache
NOT_CARRIED = {"llm_pretrain": {"--cache_dir"}, "llm_evaluate": set()}


def _common(tmp_path, quantize, optim_name, accum=1):
    return ["--model_kwargs", json.dumps(SMALL), "--train_ds", json.dumps(MARKOV), "--quantize", quantize,
            "--optim", optim_name, "--batch_size", "2", "--seq_len", "32", "--gradient_accumulation", str(accum),
            "--lr", "1e-3", "--log_interval", "1", "--cpu", "--save_dir", str(tmp_path / "runs")]


def _losses(run_dir: Path) -> dict:
    return {r["step"]: r["loss"] for r in map(json.loads, open(run_dir / "metrics.jsonl"))}


@pytest.fixture(scope="module", params=[("int8_quantized_training", "adamw", 1),
                                        ("mixed_precision", "schedule_free_adamw_8bit", 2)],
                ids=["int8_storage_adamw", "mp_schedule_free_8bit"])
def resumed(request, tmp_path_factory):
    """6 steps uninterrupted; 3 steps with a checkpoint, then a resume to 6."""
    quantize, optim_name, accum = request.param
    tmp_path = tmp_path_factory.mktemp(optim_name)
    common = _common(tmp_path, quantize, optim_name, accum)
    full = llm_pretrain.main([*common, "--n_steps", "6", "--ckpt_interval", "100", "--run_name", "full"])
    part1 = llm_pretrain.main([*common, "--n_steps", "3", "--ckpt_interval", "3", "--run_name", "part1"])
    ckpt = part1["save_dir"] / "last.pkl"
    part2 = llm_pretrain.main([*common, "--n_steps", "6", "--ckpt_interval", "3", "--resume", str(ckpt),
                               "--run_name", "part2"])
    return dict(quantize=quantize, common=common, full=full, part1=part1, part2=part2, ckpt=ckpt)


def test_resume_matches_uninterrupted_bit_for_bit(resumed):
    full, part1, part2 = (_losses(resumed[k]["save_dir"]) for k in ("full", "part1", "part2"))
    assert sorted(full) == [1, 2, 3, 4, 5, 6] and sorted(part1) == [1, 2, 3] and sorted(part2) == [4, 5, 6]
    assert all(part1[s] == full[s] for s in (1, 2, 3))
    assert all(part2[s] == full[s] for s in (4, 5, 6))
    assert full[6] < full[1]
    a, b = tree_leaves(resumed["full"]["state"].params), tree_leaves(resumed["part2"]["state"].params)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert resumed["part2"]["state"].step == 6
    args = json.loads((resumed["part2"]["save_dir"] / "args.json").read_text())
    assert args["resume"] == str(resumed["ckpt"]) and args["n_steps"] == 6


def test_checkpoint_holds_state_loader_and_step(resumed):
    ckpt = load_checkpoint(resumed["ckpt"])
    assert ckpt["meta"]["step"] == 3 and ckpt["meta"]["args"]["run_name"] == "part1"
    assert isinstance(ckpt["state"], train.TrainState) and set(ckpt["dloader"]["ds"]) == {
        "ds", "rng", "_buffer1", "_buffer2"}
    a, b = tree_leaves(ckpt["state"].params), tree_leaves(resumed["part1"]["state"].params)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_evaluate_gives_the_eval_steps_perplexity(resumed):
    """``llm_evaluate`` loads the resumed run's last checkpoint bit for bit
    and reports exp of the mean of ``make_eval_step``'s losses."""
    ckpt = resumed["part2"]["save_dir"] / "last.pkl"
    out = llm_evaluate.main(["--model_kwargs", json.dumps(SMALL), "--seq_len", "32", "--quantize",
                             resumed["quantize"], "--ckpt", str(ckpt), "--eval_ds", json.dumps(MARKOV),
                             "--max_batches", "3", "--batch_size", "4", "--generate", "5", "--cpu"])
    params = out["params"]
    a, b = tree_leaves(params), tree_leaves(resumed["part2"]["state"].params)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    cfg = dataclasses.replace(llama.LlamaConfig(**SMALL), max_position_embeddings=32)
    step = train.make_eval_step(cfg)
    ds = iter(jget_dataset(seq_len=32, eval=True, **MARKOV))
    losses = []
    for _ in range(3):
        batch = [next(ds) for _ in range(4)]
        toks, labs = (torch.from_numpy(np.stack([s[j] for s in batch])) for j in (0, 1))
        losses.append(step(params, toks, labs).item())
    loss = sum(losses) / 3
    assert out["results"]["eval_loss"] == loss and out["results"]["perplexity"] == float(np.exp(loss))
    assert len(out["results"]["sample_tokens"]) == 4 + 5
    assert all(0 <= t < SMALL["vocab_size"] for t in out["results"]["sample_tokens"])


def test_from_hf_json_matches_jax():
    path = REPO / "mini_llamas" / "Llama-2-470m"
    ours, theirs = llama.LlamaConfig.from_hf_json(path), jllama.LlamaConfig.from_hf_json(path)
    shared = {f.name for f in dataclasses.fields(ours)} & {f.name for f in dataclasses.fields(theirs)}
    assert all(getattr(ours, k) == getattr(theirs, k) for k in shared)
    assert ours == llama.LLAMA2_470M and ours.head_dim == 64
    assert llama.LlamaConfig.from_hf_json(path / "config.json") == ours
    d = json.loads((path / "config.json").read_text())
    assert llama.LlamaConfig.from_hf_json(d, num_hidden_layers=2) == dataclasses.replace(ours, num_hidden_layers=2)
    assert llm_pretrain.model_config(str(path), remat=True) == dataclasses.replace(ours, remat=True)


def test_num_params_matches_jax():
    cfg = llama.LlamaConfig(**SMALL)
    ours = llama.init_params(torch.Generator().manual_seed(0), cfg)
    theirs = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**SMALL))
    assert llama.num_params(ours) == jllama.num_params(theirs) > 0
    assert llama.num_params(ours) == sum(t.numel() for t in tree_leaves(ours))


@pytest.mark.parametrize("scheme,bound", [(None, 1e-6), ("mixed_precision", 1e-3)])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_make_eval_step_matches_jax(scheme, bound, dtn):
    """The same parameters (the JAX init carried across) and batch: the
    loss within ``tests/test_torch_train.py``'s loss bound (fp32 unquantized
    1e-6, else 1e-3, relative); bf16 unquantized is held at 1e-3 there."""
    if dtn == "bf16" and scheme is None:
        bound = 1e-3
    dtype = {"f32": jax.numpy.float32, "bf16": jax.numpy.bfloat16}[dtn]
    kw = dict(SMALL, hidden_size=256, intermediate_size=512, num_attention_heads=4, max_position_embeddings=64)
    jcfg, cfg = jllama.LlamaConfig(**kw, attention_impl="xla"), llama.LlamaConfig(**kw, attention_impl="xla")
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=dtype), scheme)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    tok, lab = rng.integers(0, 256, (2, 64)), rng.integers(0, 256, (2, 64))
    lab[0, :5] = -100
    jl = float(jtrain.make_eval_step(jcfg)(jp, tok, lab))
    tl = train.make_eval_step(cfg)(tp, torch.from_numpy(tok), torch.from_numpy(lab))
    assert not tl.requires_grad and tl.dtype == torch.float32
    assert abs(tl.item() - jl) <= bound * abs(jl), (tl.item(), jl)


def test_native_loader_with_8bit_schedule_free(tmp_path):
    """``--native_loader`` over uint16 Markov shards with
    ``schedule_free_adamw_8bit``: finite losses that fall; a checkpoint
    holds the loader's (epoch, cursor)."""
    shards = tmp_path / "shards"
    shards.mkdir()
    it = iter(jget_dataset(seq_len=255, seed=1, **MARKOV))
    for i in range(2):
        np.concatenate([next(it)[0] for _ in range(40)]).astype(np.uint16).tofile(shards / f"s{i}.bin")
    args = _common(tmp_path, "mixed_precision", "schedule_free_adamw_8bit")
    args[args.index("--train_ds") + 1] = json.dumps({"type": "token", "dataset_dir": str(shards)})
    out = llm_pretrain.main([*args, "--native_loader", "--n_steps", "8", "--ckpt_interval", "8", "--lr", "3e-3"])
    losses = _losses(out["save_dir"])
    assert all(math.isfinite(v) for v in losses.values()) and losses[8] < losses[1]
    assert set(load_checkpoint(out["save_dir"] / "last.pkl")["dloader"]) == {"epoch", "cursor"}
    with pytest.raises(ValueError, match="token dataset"):
        llm_pretrain.main([*_common(tmp_path, "mixed_precision", "adamw"), "--native_loader", "--n_steps", "1"])


def test_profile_writes_a_trace(tmp_path):
    out = llm_pretrain.main([*_common(tmp_path, "mixed_precision", "adamw"), "--n_steps", "50", "--profile"])
    assert sorted(_losses(out["save_dir"])) == [1, 2, 3, 4, 5]  # at most 5 steps under the profiler
    trace = out["save_dir"] / "trace" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0


def _options(text: str) -> set:
    return set(re.findall(r"(--[a-z_]+)", text)) - {"--help"}


@pytest.mark.parametrize("name", ["llm_pretrain", "llm_evaluate"])
def test_options_match_the_jax_drivers(name):
    proc = subprocess.run([sys.executable, str(REPO / f"{name}.py"), "--help"], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    module = {"llm_pretrain": llm_pretrain, "llm_evaluate": llm_evaluate}[name]
    ours = {s for a in module._parser()._actions for s in a.option_strings} - {"-h", "--help"}
    assert ours == _options(proc.stdout) - NOT_CARRIED[name]
    assert NOT_CARRIED[name] <= _options(proc.stdout)


def _ranks(argv: list, world: int = 2) -> list:
    """``python -m ...llm_pretrain argv`` as ``world`` gloo ranks with
    torchrun's variables; each rank's output."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world)}
    procs = [subprocess.Popen([sys.executable, "-m", "quantized_training_tpu_torch.llm_pretrain", *argv],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    try:
        logs = [p.communicate(timeout=110)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("llm_pretrain --mesh ranks hung")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_unported_options_raise(tmp_path):
    """``--mesh '{"fsdp": 2}'`` runs on two gloo ranks (torchrun's
    variables, ``--cpu``): a file a rank at the checkpoint, losses within
    JAX's sharded bound (0.05) of the one-process run, and ``--resume`` from
    step 2 gives step 3's loss again. An unknown task, or a multiple-choice
    task without ``--task_data``, raises before the model is built (the
    tasks themselves: tests/test_torch_eval_tasks.py)."""
    common = _common(tmp_path, "mixed_precision", "adamw")
    plain = _losses(llm_pretrain.main([*common, "--n_steps", "3", "--run_name", "plain"])["save_dir"])
    _ranks([*common, "--mesh", '{"fsdp": 2}', "--n_steps", "3", "--ckpt_interval", "2", "--run_name", "mesh"])
    run = next((tmp_path / "runs").glob("*_mesh"))
    meshed = _losses(run)
    assert sorted(meshed) == [1, 2, 3] and max(abs(meshed[s] - plain[s]) for s in meshed) < 0.05
    assert sorted(p.name for p in run.glob("last_*.pkl")) == ["last_0.pkl", "last_1.pkl"]
    _ranks([*common, "--mesh", '{"fsdp": 2}', "--n_steps", "3", "--resume", str(run / "last_0.pkl"),
            "--run_name", "resumed"])
    assert _losses(next((tmp_path / "runs").glob("*_resumed"))) == {3: meshed[3]}
    assert llm_evaluate.TASKS == ("perplexity", "hellaswag", "arc", "piqa", "mc")
    for task in ("arc", "piqa", "mc"):
        with pytest.raises(ValueError, match="--task_data"):
            llm_evaluate.main(["--tasks", task, "--cpu"])
    with pytest.raises(ValueError, match="unknown task"):
        llm_evaluate.main(["--tasks", "nope", "--cpu"])


def test_mesh_takes_the_8bit_state_and_prequant(tmp_path, monkeypatch):
    """``llm_pretrain --mesh '{"fsdp": 2}'`` with ``schedule_free_adamw_8bit``
    (each rank's 8-bit state the blocks of its parameter slice) under
    ``QT_PREQUANT=both`` (each rank's views of its weight shards), which the
    port refused under fsdp, on two gloo ranks: a file a rank, and losses
    within JAX's sharded bound (0.05) of the one-process run with the same
    optimizer and mode."""
    monkeypatch.setenv("QT_PREQUANT", "both")
    common = _common(tmp_path, "mixed_precision", "schedule_free_adamw_8bit")
    plain = _losses(llm_pretrain.main([*common, "--n_steps", "3", "--run_name", "plain"])["save_dir"])
    _ranks([*common, "--mesh", '{"fsdp": 2}', "--n_steps", "3", "--ckpt_interval", "3", "--run_name", "mesh"])
    run = next((tmp_path / "runs").glob("*_mesh"))
    meshed = _losses(run)
    assert sorted(meshed) == [1, 2, 3] and max(abs(meshed[s] - plain[s]) for s in meshed) < 0.05, (meshed, plain)
    assert sorted(p.name for p in run.glob("last_*.pkl")) == ["last_0.pkl", "last_1.pkl"]


def test_drivers_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        llm_pretrain.main(["--train_ds", json.dumps(MARKOV), "--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        llm_evaluate.main([])
    assert not list(tmp_path.iterdir())


def test_cli_entry_point_runs_on_the_cpu(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "quantized_training_tpu_torch.llm_pretrain",
                           *_common(tmp_path, "mixed_precision", "adamw"), "--n_steps", "2"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 2: loss=" in proc.stdout and "done; artifacts in" in proc.stdout
