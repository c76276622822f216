"""The port's ``benchmark_collectives`` command line: ``--cpu N`` spawns N gloo
ranks and prints the devices line and JAX's three keys; a world below 2 exits
with JAX's message; without ``--cpu`` it needs a card."""

import json
from pathlib import Path

import pytest
import torch

from quantized_training_tpu_torch import benchmark_collectives

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

JAX_SCRIPT = Path(__file__).resolve().parents[1] / "benchmark_collectives.py"


def test_two_cpu_ranks_print_the_three_keys(capsys):
    got = benchmark_collectives.main(["--cpu", "2", "--size_mb", "1", "--n_iters", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "devices: 2 x cpu, axis='data'"
    assert json.loads(out[1]) == got
    assert set(got) == {"psum_GiBps", "all_gather_GiBps", "psum_scatter_GiBps"} and all(v > 0 for v in got.values())
    assert all(v == round(v, 2) for v in got.values())


def test_a_world_of_one_exits_with_jax_message():
    with pytest.raises(SystemExit) as e:
        benchmark_collectives.main(["--cpu", "1"])
    message = str(e.value)
    assert message == ("only 1 device(s); collective benchmarks need >= 2 "
                       "(use --cpu 8 to validate the harness on a virtual mesh)")
    source = JAX_SCRIPT.read_text()  # JAX's message, as its source spells it
    assert '"only {n_dev} device(s); collective benchmarks need >= 2 "' in source
    assert '"(use --cpu 8 to validate the harness on a virtual mesh)"' in source


def test_the_card_is_required_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        benchmark_collectives.main([])


def test_a_failing_rank_raises(monkeypatch):
    """A rank that fails is reported, not waited on."""
    with pytest.raises(RuntimeError, match="a rank failed"):
        benchmark_collectives.main(["--cpu", "2", "--axis", "model_parallel", "--size_mb", "1"])
