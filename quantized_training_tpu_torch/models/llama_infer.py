"""Llama inference: int8 KV-cache prefill/decode and the generation loop.

Counterpart of ``quantized_training_tpu/models/llama_infer.py``: ``KVCache``
(int8 ``[L, B, S, KV, hd]`` + per-token per-head scales), ``_quant_kv`` (K1
on rows of hd = 64), ``_attention_over_cache``, ``forward_with_cache`` and
``generate``. The JAX package threads the cache through a layer scan and
returns a new one; here the layer loop is a Python loop and the cache is
written in place. Attention is plain torch (the JAX package's einsum paths).

Tensor parallelism (``mesh`` with a ``model`` axis above 1, JAX :207-239;
the parameters and their layout ``specs`` as ``parallel.shard_params_tp``
returns them): each rank runs its heads (from its q/k/v rows) and
its slice of the MLP, o's and down's linears sum their partial products
over ``model`` (one all-reduce each a layer), the cache holds the rank's KV
heads (``parallel.shard_kv_cache``), and the vocab-split logits are
all-gathered. The fresh-prefill fast path is off under TP, as JAX's flash
prefill is (:136-140): prefill attends over the cache.

JAX's TP forward is one global program: XLA takes each maximum and each
sum over the whole of a split axis. Here o's and down's linears run inside
``collectives.spanning(mesh, features="model")``, so the quantizes of their
inputs (K1 of int8 storage and BitNet, both operands of the
``mixed_precision`` forward) take the maxima of the global row, and the
linear sums its partials before it rounds, as JAX's program does: the int8
paths' int32 sums before the scales, the bf16, int8 weight-only and int4
products in fp32 (``quant/core.py::scaled_mm_over``, ``::matmul_over``).
Every layer runs inside ``spanning(mesh, weights="model")``, so that an
unpacked ``BitNetWeight``'s abs-mean is the whole matrix's, column- and
row-parallel alike. BitNet's ``o_norm`` and ``down_norm``, whose mean of
squares runs over the features that TP splits, sum the squares over
``model`` and scale with the rank's slice of their weight.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from ..parallel import collectives as C
from ..parallel.mesh import leaf_shard
from ..parallel.tp import shard_kv_cache
from ..quant import qlinear
from ..quant.core import quantize_int8
from . import llama


@dataclass
class KVCache:
    """INT8 KV cache: [L, B, S_max, KV_heads, head_dim] int8 + per-token
    per-head scales [L, B, S_max, KV_heads, 1]."""

    k: torch.Tensor
    k_scale: torch.Tensor
    v: torch.Tensor
    v_scale: torch.Tensor

    @classmethod
    def zeros(cls, cfg: llama.LlamaConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device=None):
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        sshape = shape[:-1] + (1,)
        return cls(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=dtype, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def rows(self, b: int) -> "KVCache":
        """Batch row ``b`` as a one-row cache of views: writes land here."""
        return KVCache(*(t[:, b:b + 1] for t in (self.k, self.k_scale, self.v, self.v_scale)))


def _quant_kv(x: torch.Tensor):
    """[B, T, KV, hd] -> int8 + per-(token, head) scale."""
    return quantize_int8(x, axis=-1)


def _positions(pos, T: int, device) -> torch.Tensor:
    """Absolute positions [1, T] for an int ``pos``, or [B, T] for a [B]
    tensor of per-sequence positions."""
    if isinstance(pos, int):
        return torch.arange(pos, pos + T, device=device).view(1, T)
    return pos.view(-1, 1) + torch.arange(T, device=device)


def _attention_over_cache(q, k_c, ks_c, v_c, vs_c, pos):
    """q [B, T, H, hd] against the (already updated) per-layer cache slices
    k/v [B, S, KV, hd] int8 + scales; ``pos`` is an int or a [B] tensor.
    Position pos + t attends to cache rows <= pos + t. Returns [B, T, H, hd]."""
    B, T, H, hd = q.shape
    S, KV = k_c.shape[1], k_c.shape[2]
    # dequantized in fp32, where int8 x scale is exact: XLA keeps this
    # product unrounded inside its fused attention too (excess precision)
    k_deq = k_c.float() * ks_c.float()  # [B, S, KV, hd]
    v_deq = v_c.float() * vs_c.float()
    # GQA without materializing the head repeat: q heads grouped per KV head
    qg = q.reshape(B, T, KV, H // KV, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k_deq) * (hd**-0.5)
    t_ids = _positions(pos, T, q.device)  # [B|1, T]
    s_ids = torch.arange(S, device=q.device)
    mask = s_ids.view(1, 1, S) <= t_ids.unsqueeze(-1)  # [B|1, T, S]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgts,bskd->btkgd", probs, v_deq.to(probs.dtype))
    return ctx.reshape(B, T, H, hd)


def _tp(mesh, specs=None) -> bool:
    if mesh is None or mesh.shape["model"] == 1:
        return False
    if specs is None:
        raise ValueError("tensor parallelism needs the layout that shard_params_tp returned with the parameters")
    return True


def _split(specs, *path) -> bool:
    for k in path:
        specs = specs[k]
    return leaf_shard(specs).dim is not None


def _row_parallel(mesh, split: bool):
    """The span of a row-parallel linear's contraction axis, where ``split``."""
    return C.spanning(mesh, features="model") if split else contextlib.nullcontext()


def _features_rms_norm(x, g, eps: float, mesh, split: bool):
    """``llama.rms_norm`` of x over its features; where ``split`` the rank
    holds 1 / n of them, so the sum of squares is all-reduced over
    ``model``, divided by every feature, and ``g`` is cut to the rank's
    slice."""
    if not split:
        return llama.rms_norm(x, g, eps)
    n = mesh.shape["model"]
    xf = x.float()
    mean = C.all_reduce((xf * xf).sum(dim=-1, keepdim=True), mesh, "model") / (x.shape[-1] * n)
    return (xf * torch.rsqrt(mean + eps)).to(x.dtype) * g.chunk(n, -1)[mesh.coords["model"]]


def forward_with_cache(params, tokens: torch.Tensor, cache: KVCache, pos,
                       cfg: llama.LlamaConfig, window: int | None = None, mesh=None, specs=None):
    """tokens [B, T] at absolute positions pos..pos+T -> logits [B, T, V].

    Used for prefill (T > 1) and decode (T = 1). ``pos`` is an int shared
    by the batch, or a [B] tensor with each sequence's own position (the
    server's decode step). The fresh K/V rows are quantized and written
    into ``cache`` IN PLACE. ``window`` limits attention to the first
    ``window`` cache rows.

    A prefill at ``pos == 0`` attends over the fresh dequantized K/V with
    the causal einsum (nothing before it exists), as the JAX package's
    device path does (flash prefill, JAX :104-145; under TP it attends over
    the cache, as JAX's does); dequantizing with the scales rounded to the cache's
    dtype, as :func:`_attention_over_cache` does, keeps the two equal.
    BitNet's layers (``cfg.bitnet``) normalize o's and down's inputs first
    (JAX :178-186). ``mesh`` and ``specs``: tensor parallelism (the
    module's docstring); ``cache`` then holds this rank's KV heads.
    """
    B, T = tokens.shape
    device = tokens.device
    if isinstance(pos, int) and pos + T > cache.max_len:
        raise ValueError(f"positions {pos}..{pos + T} exceed the cache ({cache.max_len} rows)")
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    tp = _tp(mesh, specs)
    if tp:  # this rank's heads
        H, KV = (n // mesh.shape["model"] if _split(specs, "layers", k, "w") else n for k, n in (("q", H), ("k", KV)))
        if H % KV or cache.k.shape[3] != KV:
            raise ValueError(f"tensor parallelism over {mesh.shape['model']}: {KV} KV heads a rank, cache "
                             f"{cache.k.shape[3]}, {H} query heads")
        reduce_o, reduce_down = _split(specs, "layers", "o", "w"), _split(specs, "layers", "down", "w")
    else:
        reduce_o = reduce_down = False
    positions = _positions(pos, T, device)
    x = params["embed"]["embedding"][tokens.long()]
    cos_full, sin_full = llama.rope_tables(cfg, cache.max_len, device=device)
    cos, sin = cos_full[positions], sin_full[positions]  # [B|1, T, hd]
    rows = torch.arange(B, device=device).view(B, 1)
    fresh = isinstance(pos, int) and pos == 0 and T > 1 and not tp
    W = cache.max_len if window is None else min(window, cache.max_len)
    # an unpacked BitNet weight's abs-mean spans the matrix TP split
    with C.spanning(mesh, weights="model") if tp else contextlib.nullcontext():
        for l in range(cfg.num_hidden_layers):
            lp = llama.layer_params(params["layers"], l)
            h = llama.rms_norm(x, lp["attn_norm"]["g"], cfg.rms_norm_eps)
            q = qlinear(h, lp["q"]["w"]).reshape(B, T, H, hd)
            k = qlinear(h, lp["k"]["w"]).reshape(B, T, KV, hd)
            v = qlinear(h, lp["v"]["w"]).reshape(B, T, KV, hd)
            q = llama.apply_rope(q, cos, sin)
            k = llama.apply_rope(k, cos, sin)

            k_q, k_s = _quant_kv(k)
            v_q, v_s = _quant_kv(v)
            kc, ksc, vc, vsc = cache.k[l], cache.k_scale[l], cache.v[l], cache.v_scale[l]
            kc[rows, positions] = k_q
            ksc[rows, positions] = k_s.to(ksc.dtype)
            vc[rows, positions] = v_q
            vsc[rows, positions] = v_s.to(vsc.dtype)

            if fresh:
                k_deq = k_q.float() * k_s.to(ksc.dtype).float()
                v_deq = (v_q.float() * v_s.to(vsc.dtype).float()).to(q.dtype)
                ctx = llama.attention(q, k_deq, v_deq, "xla")
            else:
                ctx = _attention_over_cache(q, kc[:, :W], ksc[:, :W], vc[:, :W], vsc[:, :W], pos)
            ctx = ctx.reshape(B, T, H * hd)
            if cfg.bitnet:
                ctx = _features_rms_norm(ctx, lp["o_norm"]["g"], cfg.rms_norm_eps, mesh, reduce_o)
            with _row_parallel(mesh, reduce_o):
                x = x + qlinear(ctx, lp["o"]["w"])

            h = llama.rms_norm(x, lp["mlp_norm"]["g"], cfg.rms_norm_eps)
            act = torch.nn.functional.silu(qlinear(h, lp["gate"]["w"])) * qlinear(h, lp["up"]["w"])
            if cfg.bitnet:
                act = _features_rms_norm(act, lp["down_norm"]["g"], cfg.rms_norm_eps, mesh, reduce_down)
            with _row_parallel(mesh, reduce_down):
                x = x + qlinear(act, lp["down"]["w"])

    x = llama.rms_norm(x, params["final_norm"]["g"], cfg.rms_norm_eps)
    logits = qlinear(x, llama.lm_head_weight(params, cfg))
    if tp and not cfg.tie_word_embeddings and _split(specs, "lm_head", "w"):
        logits = C.all_gather(logits, logits.ndim - 1, mesh, "model")
    return logits


def generate(params, prompt: torch.Tensor, cfg: llama.LlamaConfig, max_new_tokens: int,
             *, temperature: float = 0.0, generator: torch.Generator | None = None,
             max_len: int | None = None, mesh=None, specs=None) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation.

    prompt [B, T_prompt] -> [B, T_prompt + max_new_tokens]: one prefill pass,
    then one decode pass per token. Sampling draws from ``generator``.
    ``mesh`` and ``specs``: tensor-parallel serving (the module's
    docstring), every rank with the same prompt; the cache is made split
    over ``model`` (JAX :225-233) and every rank samples from the gathered
    logits."""
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    B, T0 = prompt.shape
    max_len = max_len or (T0 + max_new_tokens)
    cache = KVCache.zeros(cfg, B, max_len, device=prompt.device)
    if _tp(mesh, specs):
        cache = shard_kv_cache(cache, mesh)
    last = forward_with_cache(params, prompt, cache, 0, cfg, mesh=mesh, specs=specs)[:, -1].float()

    def sample(logits):
        if temperature == 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    toks = [prompt.long()]
    for i in range(max_new_tokens):
        tok = sample(last)[:, None]
        toks.append(tok)
        if i + 1 < max_new_tokens:
            last = forward_with_cache(params, tok, cache, T0 + i, cfg, mesh=mesh, specs=specs)[:, -1].float()
    return torch.cat(toks, dim=1)
