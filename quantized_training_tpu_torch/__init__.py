"""quantized_training_tpu_torch — the PyTorch + CUDA port of quantized_training_tpu.

The JAX package ``quantized_training_tpu`` is the reference; this package is
held against it module by module (same module names, same parameter layout).
Its slices so far: the int8 continuous-batching server (the
``mixed_precision`` forward, the Llama model with an int8 KV cache,
``generate`` and ``Server``), the int8 training step (the
``mixed_precision`` backward, the Llama loss with per-layer remat, AdamW and
``train.make_train_step``), its producer-fused layer, SR, int4 and fp8, and
ViT training (``models/vit.py`` and the ``vit_train`` entry point), the
storage schemes, the LLM drivers, and data parallelism, FSDP and
tensor-parallel serving over processes (``parallel``), on hand-written CUDA
kernels for Hopper (``ops/csrc``). CPU tensors take each kernel's plain
PyTorch version.

Importing the package imports no JAX and builds no kernel.
"""

from . import convert, data, models, ops, optim, parallel, quant, train, utils

__version__ = "0.2.0"

__all__ = ["convert", "data", "models", "ops", "optim", "parallel", "quant", "train", "utils", "__version__"]
