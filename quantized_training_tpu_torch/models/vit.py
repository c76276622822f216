"""Vision Transformer for quantized training.

Counterpart of ``quantized_training_tpu/models/vit.py`` (the whole file):
``ViTConfig`` and its presets, ``init_params`` (same tree, names and stacked
``[L, ...]`` layout, drawn from an explicit ``torch.Generator``),
``layer_norm``, ``patchify``, the pre-LN block, ``forward`` and
``loss_fn``. Every linear weight lives under a key ``"w"`` [out, in], so
``quant.quantize_params`` wraps them; its default filter leaves the patch
embedding (3 * P * P = 588 inputs at patch 14, not a multiple of 32) and the
[num_classes, D] head in bf16, as in the JAX package.

The block (JAX :113-143): ``layernorm_linear`` for norm1 -> qkv and norm2
-> fc1, ``gelu_linear`` for fc1 -> fc2 (for all-int8 ``mixed_precision``
weights on the card: LayerNorm and GELU inside the int8 quantizes, B18,
``quant/fused.py``; elsewhere the unfused composite), non-causal attention
and ``qlinear`` for proj. Attention (:130-134) was XLA einsum code in the JAX
package; here it is ``F.scaled_dot_product_attention`` on the card and the
JAX form elsewhere (``attention``).

Keys are ints (``ops/random.py``), folded as the JAX package folds them:
block l takes ``fold_in(key, l)`` and inside it ``fold_in(., 0..3)`` for
qkv, proj, fc1, fc2; the patch embedding ``fold_in(key, 101)`` and the head
``fold_in(key, 102)``; ``key=None`` is 0. With ``cfg.remat`` each block is
one non-reentrant ``torch.utils.checkpoint`` with its key as an argument:
the JAX package's plain ``jax.checkpoint`` (no policy), which keeps only
the block's input. Its replay draws the same noise and, as XLA's does,
recomputes only what a backward reads (``ops/remat.py``): not fc2's
product or its weight's quantize, since no backward reads the block's
output; on the fused path fc2's GELU row kernel still runs, for the column
maxima its node keeps (JAX's replay keeps that kernel too).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import remat
from ..ops.fused_producers import layer_norm_ref as layer_norm
from ..ops.random import fold_in
from ..quant import gelu_linear, layernorm_linear, qlinear
from .llama import _unstack_layers


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 192
    num_layers: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    layer_norm_eps: float = 1e-6
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


VIT_TINY = ViTConfig(hidden_size=192, num_layers=12, num_heads=3)
VIT_SMALL = ViTConfig(hidden_size=384, num_layers=12, num_heads=6)
VIT_BASE = ViTConfig(hidden_size=768, num_layers=12, num_heads=12)
VIT_LARGE = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16)
VIT_HUGE = ViTConfig(hidden_size=1280, num_layers=32, num_heads=16)
# timm's vit_giant_patch14_dinov2: embed 1536, depth 40, heads 24, patch 14
# (224 / 14 = 16 x 16 patches, 257 tokens with the cls token); 1.13B
# parameters (28.3M per block)
VIT_GIANT = ViTConfig(patch_size=14, hidden_size=1536, num_layers=40, num_heads=24)


def init_params(generator: torch.Generator, cfg: ViTConfig, dtype=torch.bfloat16):
    """normal(0.02) for weights and the position embedding, ones and zeros
    for norms, biases and the cls token, on the generator's device. The
    numbers differ from the JAX package's (another RNG); the tree is the
    same."""
    D, L, P, mlp = cfg.hidden_size, cfg.num_layers, cfg.patch_size, cfg.mlp_dim
    device = generator.device

    def w(*shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * 0.02).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, device=device, dtype=dtype)

    layers = {
        "norm1": {"g": full(1.0, L, D), "b": full(0.0, L, D)},
        "qkv": {"w": w(L, 3 * D, D), "b": full(0.0, L, 3 * D)},
        "proj": {"w": w(L, D, D), "b": full(0.0, L, D)},
        "norm2": {"g": full(1.0, L, D), "b": full(0.0, L, D)},
        "fc1": {"w": w(L, mlp, D), "b": full(0.0, L, mlp)},
        "fc2": {"w": w(L, D, mlp), "b": full(0.0, L, D)},
    }
    return {
        "patch_embed": {"w": w(D, 3 * P * P), "b": full(0.0, D)},
        "cls_token": full(0.0, 1, 1, D),
        "pos_embed": w(1, cfg.num_patches + 1, D),
        "layers": layers,
        "final_norm": {"g": full(1.0, D), "b": full(0.0, D)},
        "head": {"w": w(cfg.num_classes, D), "b": full(0.0, cfg.num_classes)},
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images [B, H, W, 3] -> patches [B, N, P * P * 3], each patch's
    pixels in (row, column, channel) order."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B, h, w, p, p, C
    return x.reshape(B, (H // patch) * (W // patch), patch * patch * C)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q, k, v [B, S, H, hd] -> [B, S, H, hd]: on the
    card ``F.scaled_dot_product_attention`` on the [B, H, S, hd] views,
    elsewhere the JAX package's einsums (:130-134), fp32 scores times
    hd^-0.5, softmax, the probabilities in q's dtype."""
    if q.is_cuda:
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return out.transpose(1, 2)
    hd = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (hd**-0.5)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _block(cfg: ViTConfig, x, lp, key: int):
    B, S, D = x.shape
    H = cfg.num_heads
    qkv = layernorm_linear(x, lp["norm1"]["g"], lp["norm1"]["b"], lp["qkv"]["w"], cfg.layer_norm_eps,
                           bias=lp["qkv"]["b"], key=fold_in(key, 0))
    q, k, v = qkv.reshape(B, S, 3, H, D // H).unbind(2)
    ctx = attention(q, k, v).reshape(B, S, D)
    x = x + qlinear(ctx, lp["proj"]["w"], lp["proj"]["b"], key=fold_in(key, 1))
    h = layernorm_linear(x, lp["norm2"]["g"], lp["norm2"]["b"], lp["fc1"]["w"], cfg.layer_norm_eps,
                         bias=lp["fc1"]["b"], key=fold_in(key, 2))
    with remat.unread():  # the block's output: no backward reads it
        return x + gelu_linear(h, lp["fc2"]["w"], bias=lp["fc2"]["b"], key=fold_in(key, 3))


def forward(params, images: torch.Tensor, cfg: ViTConfig, key: int | None = None) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC, normalized) -> logits [B, num_classes]."""
    key = 0 if key is None else key
    B = images.shape[0]
    pe = params["patch_embed"]
    patches = patchify(images.to(pe["w"].dtype), cfg.patch_size)
    x = qlinear(patches, pe["w"], pe["b"], key=fold_in(key, 101))
    cls = params["cls_token"].to(x.dtype).expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)
    block = partial(_block, cfg)
    for l, lp in enumerate(_unstack_layers(params["layers"], cfg.num_layers)):
        lkey = fold_in(key, l)
        if cfg.remat:
            x = checkpoint(remat.checkpointed(block), x, lp, lkey, use_reentrant=False)
        else:
            x = block(x, lp, lkey)
    x = layer_norm(x, params["final_norm"]["g"], params["final_norm"]["b"], cfg.layer_norm_eps)
    return qlinear(x[:, 0], params["head"]["w"], params["head"]["b"], key=fold_in(key, 102))


def loss_fn(params, images: torch.Tensor, labels: torch.Tensor, cfg: ViTConfig,
            key: int | None = None) -> torch.Tensor:
    """Mean fp32 cross entropy of the logits against ``labels`` [B]."""
    logp = torch.log_softmax(forward(params, images, cfg, key).float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()
