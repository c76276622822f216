"""Package hygiene of the port: it imports no JAX, carries no `import jax`
anywhere, and its kernel build fails clearly without CUDA."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import quantized_training_tpu_torch
from quantized_training_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
PKG = Path(quantized_training_tpu_torch.__file__).resolve().parent


def test_import_leaves_jax_out():
    """A fresh interpreter imports the whole package without loading jax
    (or the JAX package) and without building a kernel."""
    code = (
        "import sys\n"
        "import quantized_training_tpu_torch as p\n"
        "from quantized_training_tpu_torch.models import serving\n"
        "from quantized_training_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'quantized_training_tpu.')))\n"
        "assert not bad, bad\n"
        "assert _build.library.cache_info().currsize == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax\b|import quantized_training_tpu\b|from quantized_training_tpu\b)",
                         re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "profile_torch_step.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_kernel_sources_present():
    names = {p.name for p in _build.sources()}
    assert names == {"int8_quant.cu", "scaled_mm.cu", "fused_adamw.cu", "fused_producers.cu"}
    assert (_build.CSRC / "philox.cuh").exists()


def test_build_raises_clearly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the build runs instead")
    _build.library.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.library()
