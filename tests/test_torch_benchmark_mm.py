"""The port's ``benchmark_mm`` entry point on the CPU: it runs its gates on
the plain versions and prints every row of the JAX script's table; and no
gate is vacuous: B17's or B1's plain version moved by one ulp fails its
gate."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quantized_training_tpu_torch import benchmark_mm

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ROWS = ("xla_bf16", "xla_int8", "xla_scaled_int8", "pallas_scaled_int8", "pallas_tile_scaled_int8", "pallas_bf16",
        "xla_dynamic_int8")
MATMUL = importlib.import_module("quantized_training_tpu_torch.ops.matmul")
SCALED_MM = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")


def test_entry_point_passes_its_gates_and_prints_every_row():
    proc = subprocess.run([sys.executable, "-m", "quantized_training_tpu_torch.benchmark_mm", "--cpu", "--sizes",
                           "256"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    table = [line for line in proc.stdout.splitlines() if line.startswith("| ")]
    assert table[0] == "| kernel | 256 |"
    assert [line.split(" | ")[0][2:] for line in table[1:]] == list(ROWS)
    assert "device: cpu" in proc.stdout


def test_quick_leaves_out_the_bf16_and_dynamic_rows():
    rows = benchmark_mm.main(["--cpu", "--sizes", "128", "--quick"])
    assert list(rows[128]) == list(ROWS[:5])


def _one_ulp_up(t: torch.Tensor) -> torch.Tensor:
    """Each value moved one unit in the last place away from zero."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]
    return (t.view(bits) + 1).view(t.dtype)


@pytest.mark.parametrize("module,plain,gate", [
    (MATMUL, "matmul_plain", "matmul \\(B17 bf16\\)"),
    (SCALED_MM, "scaled_mm_plain", "scaled_mm \\(B1\\)"),
])
def test_a_plain_version_one_ulp_off_fails_its_gate(monkeypatch, module, plain, gate):
    true_plain = getattr(module, plain)

    def off(*args, **kwargs):
        out = true_plain(*args, **kwargs)
        return _one_ulp_up(out) if out.is_floating_point() else out

    monkeypatch.setattr(module, plain, off)
    with pytest.raises(RuntimeError, match=f"gate failed: {gate}"):
        benchmark_mm.main(["--cpu", "--sizes", "256", "--quick"])
