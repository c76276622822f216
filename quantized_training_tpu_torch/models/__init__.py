"""Models of the port (counterpart of ``quantized_training_tpu/models``)."""

from . import llama, llama_infer, serving, vit
from .llama import LLAMA2_1B, LLAMA2_470M, LlamaConfig
from .vit import VIT_BASE, VIT_GIANT, VIT_HUGE, VIT_LARGE, VIT_SMALL, VIT_TINY, ViTConfig

__all__ = ["llama", "llama_infer", "serving", "vit", "LlamaConfig", "LLAMA2_470M", "LLAMA2_1B", "ViTConfig",
           "VIT_TINY", "VIT_SMALL", "VIT_BASE", "VIT_LARGE", "VIT_HUGE", "VIT_GIANT"]
