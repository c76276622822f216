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
    """A fresh interpreter imports the whole package, the ViT slice's
    modules (the model, data, logging and the ``vit_train`` entry point)
    and the LLM drivers and tasks included, without loading jax (or the JAX package) and without building
    a kernel."""
    code = (
        "import sys\n"
        "import quantized_training_tpu_torch as p\n"
        "from quantized_training_tpu_torch.models import serving, vit\n"
        "from quantized_training_tpu_torch import benchmark_conv2d, data, llm_evaluate, llm_pretrain, vit_train\n"
        "from quantized_training_tpu_torch import accuracy_parity, hellaswag, llm_finetune, mc_eval, tokenize_data\n"
        "from quantized_training_tpu_torch.ops import conv, mx\n"
        "from quantized_training_tpu_torch import parallel\n"
        "from quantized_training_tpu_torch.data import native_loader\n"
        "from quantized_training_tpu_torch.utils import logging\n"
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
    names = {f.relative_to(PKG).as_posix() for f in files if PKG in f.parents}
    assert {"vit_train.py", "models/vit.py", "data/image.py", "data/shuffle.py", "utils/logging.py", "llm_pretrain.py",
            "llm_evaluate.py", "data/text.py", "data/tokenizers.py", "data/native_loader.py",
            "optim/schedule_free.py", "optim/state8bit.py", "utils/checkpoint.py", "ops/mx.py", "ops/conv.py",
            "benchmark_conv2d.py", "mc_eval.py", "hellaswag.py", "llm_finetune.py", "accuracy_parity.py",
            "tokenize_data.py", "parallel/mesh.py", "parallel/collectives.py", "parallel/fsdp.py",
            "parallel/tp.py"} <= names


def test_kernel_sources_present():
    names = {p.name for p in _build.sources()}
    assert names == {"int8_quant.cu", "scaled_mm.cu", "fused_adamw.cu", "fused_producers.cu", "rope.cu",
                     "tile_scaled_mm.cu", "matmul.cu", "int8_attention.cu"}
    assert all((_build.CSRC / h).exists() for h in ("philox.cuh", "row_common.cuh", "mm_tiles.cuh"))


def test_build_raises_clearly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the build runs instead")
    _build.library.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.library()
