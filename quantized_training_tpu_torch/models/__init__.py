"""Models of the port (counterpart of ``quantized_training_tpu/models``)."""

from . import llama, llama_infer, serving
from .llama import LLAMA2_1B, LLAMA2_470M, LlamaConfig

__all__ = ["llama", "llama_infer", "serving", "LlamaConfig", "LLAMA2_470M", "LLAMA2_1B"]
