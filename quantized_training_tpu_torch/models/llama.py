"""Llama model for training, and its pieces for serving.

Counterpart of ``quantized_training_tpu/models/llama.py`` (:63-618):
``LlamaConfig`` and its presets, ``init_params`` (same names, shapes and
stacked ``[L, out, in]`` layout, drawn from an explicit ``torch.Generator``),
``rms_norm``, ``rope_tables``, ``apply_rope``, causal GQA ``attention``, and
the decoder layer with ``backbone``, ``forward`` and ``loss_fn``.

The decoder layer is the JAX package's (:402-502) without the grouped
RoPE path: ``norm_linear_multi`` for the norm and q/k/v, rope on [B, S, H,
hd], attention, ``qlinear`` for the o-projection (the JAX path when
``_use_grouped_rope`` is false; ``attn_out_linear`` and its kernels B13/B14
are not ported), and ``mlp_linear`` for the MLP. For all-int8
``mixed_precision`` weights on the card those run RMSNorm and silu(gate) *
up inside the int8 quantizes (``quant/fused.py``); on the CPU, for other
weights, or under ``quant.set_impl('off')`` / ``QT_FUSED=0`` they take the
unfused composite, ``rms_norm`` -> ``qlinear_multi`` and ``silu(gate) *
up`` -> ``qlinear``. On the TPU the JAX package ran JAX's splash attention;
its counterpart here is ``F.scaled_dot_product_attention``.
``save_qkv_residuals``, the HF-json loader and ``bitnet`` are not carried.

Stochastic rounding draws from an int key (``ops/random.py``) folded as the
JAX package folds it: ``fold_in(key, l)`` for layer l, then ``fold_in(.,
0)`` for the q/k/v projections and ``fold_in(., 3)`` / ``fold_in(., 4)``
for the o-projection and the MLP (gate/up ``fold_in(., 0)``, down
``fold_in(., 1)``), and ``fold_in(key, 0x7FFFFFFF)`` for the lm_head. The
JAX package's ``fold_in(key, 0x5EED)`` seeds ``prequantize_step``, which is
not ported. The key enters each checkpointed layer as an argument, so the
replay in the backward rounds exactly as the forward did.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cross_entropy import IGNORE_INDEX, fused_linear_cross_entropy
from ..ops.fused_producers import rms_norm_ref as rms_norm
from ..ops.random import fold_in
from ..quant import mlp_linear, norm_linear_multi, qlinear
from ..quant.mixed_precision import MixedPrecisionWeight


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
    remat: bool = False  # activation checkpointing per decoder layer
    # 'auto' = F.scaled_dot_product_attention on the card, the fp32-softmax
    # einsum elsewhere; 'sdpa' and 'xla' (the einsum) force one
    attention_impl: str = "auto"

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


def _resolve_attn_impl(impl: str, q: torch.Tensor) -> str:
    if impl == "auto":
        return "sdpa" if q.is_cuda else "xla"
    if impl not in ("sdpa", "xla"):
        raise ValueError(f"attention_impl {impl!r}: one of 'auto', 'sdpa', 'xla'")
    return impl


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Causal GQA attention. q [B, S, H, hd], k/v [B, S, KV, hd] ->
    [B, S, H, hd].

    'sdpa': ``F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)``, the counterpart of the JAX package's splash kernel
    (KV heads are not repeated). 'xla': the JAX package's einsum branch,
    fp32 scores and softmax, which materializes [S, S]."""
    if _resolve_attn_impl(impl, q) == "sdpa":
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True,
        )
        return out.transpose(1, 2)
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


def _qkv_part(cfg: LlamaConfig, x, lp, cos, sin, key: int):
    """Norm + QKV projections + RoPE (JAX :402-427): the norm fused into
    the shared input quantize where ``norm_linear_multi`` fuses."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = norm_linear_multi(x, lp["attn_norm"]["g"], [lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]],
                                cfg.rms_norm_eps, key=fold_in(key, 0))
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, KV, hd), cos, sin)
    return q, k, v.reshape(B, S, KV, hd)


def _post_attn_part(cfg: LlamaConfig, x, ctx, lp, key: int):
    """O-projection + MLP with residuals (JAX :430-472, without grouped
    RoPE and bitnet): ``qlinear`` for o, ``mlp_linear`` for the MLP."""
    x = x + qlinear(ctx, lp["o"]["w"], key=fold_in(key, 3))
    return x + mlp_linear(x, lp["mlp_norm"]["g"], lp["gate"]["w"], lp["up"]["w"], lp["down"]["w"],
                          cfg.rms_norm_eps, key=fold_in(key, 4))


def _decoder_layer(cfg: LlamaConfig, x, lp, cos, sin, key: int):
    B, S, _ = x.shape
    q, k, v = _qkv_part(cfg, x, lp, cos, sin, key)
    ctx = attention(q, k, v, cfg.attention_impl).reshape(B, S, cfg.num_attention_heads * cfg.head_dim)
    return _post_attn_part(cfg, x, ctx, lp, key)


def _unstack_layers(layers: dict, L: int) -> list[dict]:
    """The stacked [L, ...] layer tree as L per-layer trees of views, cut
    with one ``unbind`` per leaf: its backward stacks the L per-layer grads
    once, where indexing layer by layer would add a full-size [L, ...]
    zero-padded grad per layer."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, MixedPrecisionWeight):
            return [MixedPrecisionWeight(d, t.config) for d in t.data.unbind(0)]
        return t.unbind(0)

    def pick(t, l):
        return {k: pick(v, l) for k, v in t.items()} if isinstance(t, dict) else t[l]

    cut_layers = cut(layers)
    return [pick(cut_layers, l) for l in range(L)]


def backbone(params, tokens: torch.Tensor, cfg: LlamaConfig, key: int | None = None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D] (JAX :505-565).
    ``key`` (an int, 0 when None as the JAX package's ``PRNGKey(0)``) seeds
    stochastic rounding inside the quantized linears; layer l takes
    ``fold_in(key, l)`` (JAX :560).

    With ``cfg.remat`` every decoder layer is one ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward, only
    the layer input is kept, and the layer's key is one of its arguments.
    The JAX policy also keeps splash attention's (out, lse) residuals, which
    its non-TPU path does not have either."""
    _require_no_bitnet(cfg)
    key = 0 if key is None else key
    B, S = tokens.shape
    # F.embedding, not indexing: the CPU backward of an index accumulates the
    # rows of repeated tokens with atomic adds in whatever order the threads
    # run, so the embedding's grad would change bits from run to run
    x = F.embedding(tokens.long(), params["embed"]["embedding"])
    cos, sin = rope_tables(cfg, S, device=tokens.device)
    layer = partial(_decoder_layer, cfg)
    for l, lp in enumerate(_unstack_layers(params["layers"], cfg.num_hidden_layers)):
        lkey = fold_in(key, l)
        if cfg.remat:
            x = checkpoint(layer, x, lp, cos, sin, lkey, use_reentrant=False)
        else:
            x = layer(x, lp, cos, sin, lkey)
    return rms_norm(x, params["final_norm"]["g"], cfg.rms_norm_eps)


def forward(params, tokens: torch.Tensor, cfg: LlamaConfig, key: int | None = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (model dtype); the lm_head takes
    ``fold_in(key, 0x7FFFFFFF)`` (JAX :582)."""
    key = 0 if key is None else key
    x = backbone(params, tokens, cfg, key)
    return qlinear(x, lm_head_weight(params, cfg), key=fold_in(key, 0x7FFFFFFF))


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor, cfg: LlamaConfig,
            key: int | None = None) -> torch.Tensor:
    """fp32 token-mean cross entropy; labels == -100 are ignored (JAX
    :585-618). A plain lm_head takes the chunked fused loss, which never
    materializes the logits; a quantized one the explicit logits."""
    lm_w = lm_head_weight(params, cfg)
    labels = labels.reshape(-1)
    if isinstance(lm_w, torch.Tensor):
        x = backbone(params, tokens, cfg, key)
        nll_sum, n_valid = fused_linear_cross_entropy(x.reshape(-1, x.shape[-1]), lm_w, labels)
        return nll_sum / n_valid.clamp(min=1)
    logits = forward(params, tokens, cfg, key).float()
    logits = logits.reshape(-1, logits.shape[-1])
    valid = labels != IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
