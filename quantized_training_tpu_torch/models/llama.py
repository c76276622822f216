"""Llama model pieces for the serving slice.

Counterpart of ``quantized_training_tpu/models/llama.py`` (:63-207,
:291-353): ``LlamaConfig`` and its presets, ``init_params`` (same names,
shapes and stacked ``[L, out, in]`` layout, drawn from an explicit
``torch.Generator``), ``rms_norm``, ``rope_tables``, ``apply_rope`` and the
causal GQA einsum branch of ``attention``. The training-side fields of the
JAX config (remat, attention_impl, save_qkv_residuals) and the HF-json loader
belong to the training slice and are not carried yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    bitnet: bool = False  # RMSNorm-into-linear surgery: not ported yet

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# Llama-2-470m (mini_llamas/Llama-2-470m/config.json)
LLAMA2_470M = LlamaConfig()
# Llama2-1B: the 1.1B TinyLlama geometry
LLAMA2_1B = LlamaConfig(
    hidden_size=2048,
    intermediate_size=5632,
    num_hidden_layers=22,
    num_attention_heads=32,
    num_key_value_heads=4,
)


def _require_no_bitnet(cfg: LlamaConfig) -> None:
    if cfg.bitnet:
        raise NotImplementedError("bitnet=True (extra o/down norms) is not ported yet (ROADMAP A7)")


def init_params(generator: torch.Generator, cfg: LlamaConfig, dtype=torch.bfloat16):
    """HF-style init: normal(0.02) for weights, ones for norms, on the
    generator's device. The numbers differ from the JAX package's (another
    RNG); the names, shapes and layout are the same."""
    _require_no_bitnet(cfg)
    H, D = cfg.num_attention_heads * cfg.head_dim, cfg.hidden_size
    KV = cfg.num_key_value_heads * cfg.head_dim
    F, L, V = cfg.intermediate_size, cfg.num_hidden_layers, cfg.vocab_size
    device = generator.device

    def w(*shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    layers = {
        "attn_norm": {"g": ones(L, D)},
        "q": {"w": w(L, H, D)},
        "k": {"w": w(L, KV, D)},
        "v": {"w": w(L, KV, D)},
        "o": {"w": w(L, D, H)},
        "mlp_norm": {"g": ones(L, D)},
        "gate": {"w": w(L, F, D)},
        "up": {"w": w(L, F, D)},
        "down": {"w": w(L, D, F)},
    }
    params = {
        "embed": {"embedding": w(V, D)},
        "layers": layers,
        "final_norm": {"g": ones(D)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": w(V, D)}
    return params


def layer_params(layers: dict, l: int) -> dict:
    """Layer ``l`` of the stacked ``[L, ...]`` parameter tree (views)."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l] for k, v in layers.items()}


def lm_head_weight(params, cfg: LlamaConfig):
    return params["embed"]["embedding"] if cfg.tie_word_embeddings else params["lm_head"]["w"]


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 math, cast to x's dtype before the weight is applied (HF
    LlamaRMSNorm)."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * g


def rope_tables(cfg: LlamaConfig, seq_len: int, device=None):
    """fp32 cos/sin tables [S, head_dim]."""
    hd = cfg.head_dim
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [S, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; rotate-half convention, rotation in x's dtype.

    cos/sin are [S, hd] (shared positions) or [B, S, hd] (a position per
    sequence, as the server's decode step uses)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos.unsqueeze(-2).to(x.dtype)
    s = sin.unsqueeze(-2).to(x.dtype)
    return x * c + rotated * s


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, fp32 scores and softmax (the JAX package's
    einsum branch). q [B, S, H, hd], k/v [B, S, KV, hd] -> [B, S, H, hd]."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (hd**-0.5)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)
