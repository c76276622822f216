"""Llama model for training, and its pieces for serving.

Counterpart of ``quantized_training_tpu/models/llama.py`` (:63-618):
``LlamaConfig`` and its presets, ``init_params`` (same names, shapes and
stacked ``[L, out, in]`` layout, drawn from an explicit ``torch.Generator``),
``rms_norm``, ``rope_tables``, ``apply_rope``, causal GQA ``attention``, and
the decoder layer with ``backbone``, ``forward`` and ``loss_fn``.

The decoder layer is the JAX package's (:356-502): ``norm_linear_multi``
for the norm and q/k/v, then, where ``_use_grouped_rope`` holds (by default
wherever attention resolves to SDPA, the counterpart of the JAX package's
splash; ``QT_FUSED_ROPE=0`` turns it off, ``=force`` on, with the einsum
attention on the CPU), the grouped pipeline: RoPE in fp32 fused with the
head grouping, q's 1/sqrt(hd) folded into its tables (``ops/rope.py``, B13),
attention on [B, KV, G, S, hd] operands, and ``attn_out_linear`` for the
o-projection (the ungrouping inside its int8 quantize, B14); otherwise rope
on [B, S, H, hd] in the model dtype, attention and ``qlinear`` for o. The
MLP is ``mlp_linear``. For all-int8 ``mixed_precision`` weights on the card
those run RMSNorm, silu(gate) * up, its backward and the ungrouping inside
the int8 quantizes (``quant/fused.py``); on the CPU, for other weights, or
under ``quant.set_impl('off')`` / ``QT_FUSED=0`` they take the unfused
composite, ``rms_norm`` -> ``qlinear_multi``, ``silu(gate) * up`` ->
``qlinear`` and ``ungroup_heads`` -> ``qlinear``. On the TPU the JAX package
ran JAX's splash attention; its counterpart here is
``F.scaled_dot_product_attention``.
``bitnet=True`` is the JAX package's RMSNorm-into-linear surgery (:159-161,
:454-465): an ``o_norm`` [L, H] before the o-projection and a ``down_norm``
[L, F] before down, the MLP as ``norm_linear_multi`` for gate/up, ``silu *
up``, the norm and ``qlinear`` (``fold_in(., 6)`` for down); on the grouped
pipeline such a layer ungroups the attention output (``ungroup_heads``,
B13) rather than take ``attn_out_linear``. ``LlamaConfig.from_hf_json``
reads an HF-format ``config.json`` (JAX :92-114).

The remat policy (JAX :530-554, ``save_only_these_names``; ``ops/remat.py``):
each checkpointed layer keeps its input and the values JAX's policy names,
the fused producers' column maxima (B7's, B9-row's, B14's; JAX's
``QUANT_AMAX_RESIDUAL``), SDPA's out and log-sum-exp (splash's residuals;
the CPU's einsum attention keeps nothing, as JAX's does), under
``QT_SAVE_POSTATTN=1`` the residual sum after ``attn_out_linear`` and under
``save_qkv_residuals`` the post-rope q, k, v; its replay then runs only
what a backward reads, as XLA's does: never B9-row, down's product or its
weight's quantize (the layer's output is read by no backward), nor the
attention forward where SDPA ran, nor what makes a kept value.

Stochastic rounding draws from an int key (``ops/random.py``) folded as the
JAX package folds it: ``fold_in(key, l)`` for layer l, then ``fold_in(.,
0)`` for the q/k/v projections and ``fold_in(., 3)`` / ``fold_in(., 4)``
for the o-projection and the MLP (gate/up ``fold_in(., 0)``, down
``fold_in(., 1)``; BitNet's down ``fold_in(., 6)``), and ``fold_in(key,
0x7FFFFFFF)`` for the lm_head. The key enters each checkpointed layer as
an argument, so the replay in the backward rounds exactly as the forward
did.

``backbone`` runs ``prequantize_step`` on the stacked layers before the
layer loop (JAX :517-527), with ``fold_in(key, 0x5EED)``: under
``QT_PREQUANT`` (default '0', off) each int8 mixed-precision weight's int8
views are made once a step and enter each checkpointed layer inside its
parameters, so the remat replay takes them as they are.

``mesh`` (a ``parallel.Mesh`` with fsdp > 1) and ``specs`` (the
:class:`parallel.Shard` layout that ``shard_state`` returned with them):
the parameters are this rank's FSDP shards. ``backbone``
gathers the embedding, the final norm and the stacked leaves split on
their layer dim once a step, and every other split leaf of a layer inside
that layer's function, which ``torch.utils.checkpoint`` replays (so the
backward gathers again, FSDP2's reshard-after-forward); the loss gathers
the lm_head. ``parallel/fsdp.py`` holds the gather, whose backward
reduce-scatters. BitNet weights routed through the 2-bit all-gather stay
split. ``QT_PREQUANT`` is refused there: its column views need every row
of a weight.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cross_entropy import IGNORE_INDEX, fused_linear_cross_entropy
from ..ops.fused_producers import rms_norm_ref as rms_norm
from ..ops.fused_producers import silu_mul_ref
from ..ops import remat
from ..ops.random import fold_in
from ..ops.rope import group_heads, rope_group, ungroup_heads
from ..ops.sdpa import sdpa
from ..parallel import fsdp as _fsdp
from ..parallel.mesh import Shard, param_specs
from ..quant import attn_out_linear, mlp_linear, norm_linear_multi, prequantize_step, qlinear
from ..quant.node import WeightNode
from ..utils.tree import map_tensors, tree_leaves


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
    bitnet: bool = False  # RMSNorm-into-linear surgery: the o and down norms
    remat: bool = False  # activation checkpointing per decoder layer
    # 'auto' = F.scaled_dot_product_attention on the card, the fp32-softmax
    # einsum elsewhere; 'sdpa' and 'xla' (the einsum) force one
    attention_impl: str = "auto"
    # the remat policy also keeps the post-rope q, k, v across the layer
    # checkpoint, so that its replay runs neither the q/k/v projections nor
    # the rope (JAX :79-85)
    save_qkv_residuals: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_json(cls, path_or_dict, **overrides) -> "LlamaConfig":
        """From an HF-format ``config.json`` (a file, a directory holding
        one, or its dict): the architecture keys it names, then
        ``overrides``."""
        if isinstance(path_or_dict, (str, Path)):
            path = Path(path_or_dict)
            with open(path / "config.json" if path.is_dir() else path) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        kwargs = {k: v for k, v in d.items() if k in _HF_KEYS}
        kwargs.update(overrides)
        return cls(**kwargs)


_HF_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings", "rms_norm_eps", "rope_theta", "tie_word_embeddings")

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


def init_params(generator: torch.Generator, cfg: LlamaConfig, dtype=torch.bfloat16):
    """HF-style init: normal(0.02) for weights, ones for norms, on the
    generator's device. The numbers differ from the JAX package's (another
    RNG); the names, shapes and layout are the same. ``cfg.bitnet`` adds the
    ``o_norm`` [L, H] and ``down_norm`` [L, F] gains."""
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
    if cfg.bitnet:
        layers["o_norm"] = {"g": ones(L, H)}
        layers["down_norm"] = {"g": ones(L, F)}
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
    enable_gqa=True)``'s kernels through ``ops/sdpa.py`` (whose out and
    log-sum-exp a remat replay is given), the counterpart of the JAX
    package's splash kernel (KV heads are not repeated). 'xla': the JAX
    package's einsum branch, fp32 scores and softmax, which materializes [S,
    S]."""
    if _resolve_attn_impl(impl, q) == "sdpa":
        out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)
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


def _use_grouped_rope(cfg: LlamaConfig, x: torch.Tensor) -> bool:
    """The grouped pipeline (JAX :210-227): on where attention resolves to
    SDPA, whose operands it feeds without a copy; ``QT_FUSED_ROPE=0`` turns
    it off, ``QT_FUSED_ROPE=force`` on (the einsum fallback, for the CPU
    tests); never for hd % 64 or hd > 256."""
    flag = os.environ.get("QT_FUSED_ROPE", "1")
    if flag == "0" or cfg.head_dim % 64 or cfg.head_dim > 256:
        return False
    return flag == "force" or _resolve_attn_impl(cfg.attention_impl, x) == "sdpa"


def _save_post_attn() -> bool:
    """``QT_SAVE_POSTATTN=1`` (JAX :53-60): the remat policy also keeps the
    post-attention residual sum, so that the replay runs neither the
    o-projection nor its input's quantizes. Read at each layer call."""
    return os.environ.get("QT_SAVE_POSTATTN", "0") == "1"


def _unread_if(cond: bool):
    """``remat.unread()`` where ``cond``: the ops within make only a value
    that the remat policy gives the replay."""
    return remat.unread() if cond else contextlib.nullcontext()


def _qkv_part_grouped(cfg: LlamaConfig, x, lp, cos, sin, key: int):
    """Norm + QKV projections + rope fused with the head grouping (JAX
    :356-379): q comes out [B, KV, G, S, hd] with 1/sqrt(hd) folded into its
    tables, k and v [B, KV, S, hd]. Under ``save_qkv_residuals`` the three
    are the policy's (``remat.given``)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    with _unread_if(cfg.save_qkv_residuals):
        q, k, v = norm_linear_multi(x, lp["attn_norm"]["g"], [lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]],
                                    cfg.rms_norm_eps, key=fold_in(key, 0))
        scale = hd**-0.5
        qg = rope_group(q.reshape(B, S, H, hd), cos * scale, sin * scale, KV)
        # squeeze, not [:, :, 0]: its backward is a view, where indexing's writes
        # the gradient into a zero-filled copy
        kg = rope_group(k.reshape(B, S, KV, hd), cos, sin, KV).squeeze(2)
        vg = group_heads(v.reshape(B, S, KV, hd), KV).squeeze(2)
    if cfg.save_qkv_residuals:
        qg, kg, vg = (remat.given("qkv", t) for t in (qg, kg, vg))
    return qg, kg, vg


def _attention_grouped(qg, kg, vg, impl: str):
    """Causal GQA attention on grouped operands (JAX :382-399): qg [B, KV, G,
    S, hd] (already 1/sqrt(hd)-scaled), kg/vg [B, KV, S, hd] -> [B, KV, G, S,
    hd]. 'sdpa': ``F.scaled_dot_product_attention``'s kernels
    (``ops/sdpa.py``) with ``scale=1.0`` on the [B, H, S, hd] view of qg;
    'xla': the grouped fp32-softmax einsum."""
    B, KV, G, S, hd = qg.shape
    if _resolve_attn_impl(impl, qg) == "sdpa":
        out = sdpa(qg.reshape(B, KV * G, S, hd), kg, vg, is_causal=True, scale=1.0, enable_gqa=True)
        return out.reshape(B, KV, G, S, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(), kg.float())
    mask = torch.ones(S, S, dtype=torch.bool, device=qg.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1).to(qg.dtype)
    return torch.einsum("bkgst,bktd->bkgsd", probs, vg)


def _qkv_part(cfg: LlamaConfig, x, lp, cos, sin, key: int):
    """Norm + QKV projections + RoPE (JAX :402-427): the norm fused into
    the shared input quantize where ``norm_linear_multi`` fuses. Under
    ``save_qkv_residuals`` the post-rope q, k and v are the policy's."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    with _unread_if(cfg.save_qkv_residuals):
        q, k, v = norm_linear_multi(x, lp["attn_norm"]["g"], [lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]],
                                    cfg.rms_norm_eps, key=fold_in(key, 0))
    # the rope is plain torch: in a replay of given q and k it runs on the
    # projections' unread outputs, and only its graph is kept
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, KV, hd), cos, sin)
    v = v.reshape(B, S, KV, hd)
    if cfg.save_qkv_residuals:
        q, k, v = (remat.given("qkv", t) for t in (q, k, v))
    return q, k, v


def _post_attn_part(cfg: LlamaConfig, x, ctx, lp, key: int, *, ctx_grouped=None):
    """O-projection + MLP with residuals (JAX :430-472):
    ``attn_out_linear`` for o on the grouped attention output
    ``ctx_grouped`` [B, KV, G, S, hd], else ``qlinear`` on ``ctx``;
    ``mlp_linear`` for the MLP. BitNet's layer normalizes o's and down's
    inputs first and runs its MLP unfused. Under ``QT_SAVE_POSTATTN=1`` the
    residual sum after the o-projection of ``attn_out_linear`` is the
    policy's (JAX :445-453); the MLP's output is read by no backward."""
    if ctx_grouped is not None:
        post = _save_post_attn()
        with _unread_if(post):
            o = attn_out_linear(ctx_grouped, lp["o"]["w"], cfg.num_key_value_heads, key=fold_in(key, 3))
        x = remat.given("post_attn", x, o) if post else x + o
    else:
        if cfg.bitnet:
            ctx = rms_norm(ctx, lp["o_norm"]["g"], cfg.rms_norm_eps)
        x = x + qlinear(ctx, lp["o"]["w"], key=fold_in(key, 3))
    if cfg.bitnet:
        gate, up = norm_linear_multi(x, lp["mlp_norm"]["g"], [lp["gate"]["w"], lp["up"]["w"]],
                                     cfg.rms_norm_eps, key=fold_in(key, 4))
        act = rms_norm(silu_mul_ref(gate, up), lp["down_norm"]["g"], cfg.rms_norm_eps)
        with remat.unread():  # the layer's output: no backward reads it
            return x + qlinear(act, lp["down"]["w"], key=fold_in(key, 6))
    with remat.unread():
        return x + mlp_linear(x, lp["mlp_norm"]["g"], lp["gate"]["w"], lp["up"]["w"], lp["down"]["w"],
                              cfg.rms_norm_eps, key=fold_in(key, 4))


def _decoder_layer(cfg: LlamaConfig, x, lp, cos, sin, key: int):
    B, S, _ = x.shape
    if _use_grouped_rope(cfg, x):
        qg, kg, vg = _qkv_part_grouped(cfg, x, lp, cos, sin, key)
        out = _attention_grouped(qg, kg, vg, cfg.attention_impl)
        if not cfg.bitnet:
            return _post_attn_part(cfg, x, None, lp, key, ctx_grouped=out)
        ctx = ungroup_heads(out, cfg.num_key_value_heads).reshape(B, S, cfg.num_attention_heads * cfg.head_dim)
        return _post_attn_part(cfg, x, ctx, lp, key)
    q, k, v = _qkv_part(cfg, x, lp, cos, sin, key)
    ctx = attention(q, k, v, cfg.attention_impl).reshape(B, S, cfg.num_attention_heads * cfg.head_dim)
    return _post_attn_part(cfg, x, ctx, lp, key)


def _unstack_layers(layers: dict, L: int) -> list[dict]:
    """The stacked [L, ...] layer tree as L per-layer trees of views, cut
    with one ``unbind`` per leaf: its backward stacks the L per-layer grads
    once, where indexing layer by layer would add a full-size [L, ...]
    zero-padded grad per layer. A weight wrapper is cut field by field, its
    master too, so that the per-layer grads stack onto the [L, O, I]
    master."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, WeightNode):
            return t.unbind_layers()
        return t.unbind(0)

    def pick(t, l):
        return {k: pick(v, l) for k, v in t.items()} if isinstance(t, dict) else t[l]

    cut_layers = cut(layers)
    return [pick(cut_layers, l) for l in range(L)]


def _fsdp_specs(mesh, specs):
    """The parameters' layout where ``mesh`` splits them over fsdp, else
    None."""
    if mesh is None or mesh.shape["fsdp"] == 1:
        return None
    if specs is None:
        raise ValueError("an fsdp mesh needs the layout that shard_state returned with the state")
    return param_specs(specs)


def _fsdp_layer(cfg: LlamaConfig, specs, mesh, x, lp, cos, sin, key: int):
    """A decoder layer on its leaves gathered over fsdp: those split on a
    dim of the [out, in] matrix (``specs`` in the stacked layout)."""
    lp = _fsdp.gather(lp, specs, mesh, pick=lambda dim: dim - 1 if dim >= 1 else None)
    return _decoder_layer(cfg, x, lp, cos, sin, key)


def lm_head_gathered(params, cfg: LlamaConfig, mesh=None, specs=None):
    """``lm_head_weight``, gathered over fsdp where ``mesh`` splits it."""
    w = lm_head_weight(params, cfg)
    specs = _fsdp_specs(mesh, specs)
    if specs is None:
        return w
    return _fsdp.gather(w, specs["embed"]["embedding"] if cfg.tie_word_embeddings else specs["lm_head"]["w"], mesh)


def backbone(params, tokens: torch.Tensor, cfg: LlamaConfig, key: int | None = None, mesh=None,
             specs=None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D] (JAX :505-565).
    ``key`` (an int, 0 when None as the JAX package's ``PRNGKey(0)``) seeds
    stochastic rounding inside the quantized linears; layer l takes
    ``fold_in(key, l)`` (JAX :560).

    With ``cfg.remat`` every decoder layer is one ``torch.utils.checkpoint``
    (non-reentrant) under the remat policy (JAX :530-554; the module's
    docstring, ``ops/remat.py``): it keeps the layer input and the values
    JAX's ``save_only_these_names`` keeps, and its replay in the backward
    recomputes only what a backward reads, with the layer's key as one of
    its arguments, as are the weights' views under ``QT_PREQUANT``."""
    key = 0 if key is None else key
    B, S = tokens.shape
    layer = partial(_decoder_layer, cfg)
    specs = _fsdp_specs(mesh, specs)
    layer_specs = None
    if specs is not None:
        params = {k: v if k in ("layers", "lm_head") else _fsdp.gather(v, specs[k], mesh) for k, v in params.items()}
        layer_dim = lambda dim: 0 if dim == 0 else None  # split on the layer dim: gathered whole, once
        params["layers"] = _fsdp.gather(params["layers"], specs["layers"], mesh, pick=layer_dim)
        # the leaves still split: those split on a dim of the [out, in] matrix
        layer_specs = map_tensors(lambda s: Shard(None, s.index, s.count) if s.dim == 0 else s, specs["layers"],
                                  is_leaf=lambda s: isinstance(s, Shard))
    # F.embedding, not indexing: the CPU backward of an index accumulates the
    # rows of repeated tokens with atomic adds in whatever order the threads
    # run, so the embedding's grad would change bits from run to run
    x = F.embedding(tokens.long(), params["embed"]["embedding"])
    cos, sin = rope_tables(cfg, S, device=tokens.device)
    # QT_PREQUANT: the weights' int8 views once a step, outside the layers;
    # under fsdp each rank makes its shards of them, gathered in each layer
    layers = prequantize_step(params["layers"], key=fold_in(key, 0x5EED), mesh=mesh, specs=layer_specs)
    if specs is not None:
        layer = partial(_fsdp_layer, cfg, _fsdp.prequant_specs(layers, specs["layers"]), mesh)
    for l, lp in enumerate(_unstack_layers(layers, cfg.num_hidden_layers)):
        lkey = fold_in(key, l)
        if cfg.remat:
            x = checkpoint(remat.checkpointed(layer), x, lp, cos, sin, lkey, use_reentrant=False)
        else:
            x = layer(x, lp, cos, sin, lkey)
    return rms_norm(x, params["final_norm"]["g"], cfg.rms_norm_eps)


def forward(params, tokens: torch.Tensor, cfg: LlamaConfig, key: int | None = None, mesh=None,
            specs=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (model dtype); the lm_head takes
    ``fold_in(key, 0x7FFFFFFF)`` (JAX :582)."""
    key = 0 if key is None else key
    x = backbone(params, tokens, cfg, key, mesh, specs)
    return qlinear(x, lm_head_gathered(params, cfg, mesh, specs), key=fold_in(key, 0x7FFFFFFF))


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor, cfg: LlamaConfig,
            key: int | None = None, mesh=None, specs=None) -> torch.Tensor:
    """fp32 token-mean cross entropy over this process's tokens; labels ==
    -100 are ignored (JAX :585-618). A plain lm_head takes the chunked
    fused loss, which never materializes the logits; a quantized one the
    explicit logits."""
    lm_w = lm_head_weight(params, cfg)
    labels = labels.reshape(-1)
    if isinstance(lm_w, torch.Tensor):
        x = backbone(params, tokens, cfg, key, mesh, specs)
        nll_sum, n_valid = fused_linear_cross_entropy(x.reshape(-1, x.shape[-1]),
                                                      lm_head_gathered(params, cfg, mesh, specs), labels)
        return nll_sum / n_valid.clamp(min=1)
    logits = forward(params, tokens, cfg, key, mesh, specs).float()
    logits = logits.reshape(-1, logits.shape[-1])
    valid = labels != IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def num_params(params) -> int:
    """The number of elements of the tree's leaves (JAX :621-625)."""
    return sum(l.numel() for l in tree_leaves(params))
