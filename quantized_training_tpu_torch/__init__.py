"""quantized_training_tpu_torch — the PyTorch + CUDA port of quantized_training_tpu.

The JAX package ``quantized_training_tpu`` is the reference; this package is
held against it module by module (same module names, same parameter layout).
Its first slice is the int8 continuous-batching server: the
``mixed_precision`` scheme's forward, the Llama model with an int8 KV cache,
``generate`` and ``Server``, on two hand-written CUDA kernels for Hopper
(``ops/csrc``). CPU tensors take each kernel's plain PyTorch version.

Importing the package imports no JAX and builds no kernel.
"""

from . import convert, models, ops, quant

__version__ = "0.1.0"

__all__ = ["convert", "models", "ops", "quant", "__version__"]
