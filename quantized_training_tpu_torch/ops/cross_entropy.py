"""Fused (chunked) linear + cross-entropy: the LM-head loss.

Counterpart of ``quantized_training_tpu/ops/cross_entropy.py`` (:38-139), as
a ``torch.autograd.Function`` in plain torch: the JAX package wrote no Pallas
kernel here (XLA ran large matmuls and row reductions), and the lm_head stays
bf16, so ``torch.matmul`` is right.

Per chunk of tokens the logits tile [C, V] is computed with fp32
accumulation and reduced at once to (logsumexp, label logit); only a
per-token fp32 ``lse`` [T] is kept for the backward, which recomputes each
tile, forms the softmax gradient and contracts it into dx and dw. At most one
[C, V] tile (and its softmax) is alive at a time, instead of the [T, V]
logits and their fp32 log-softmax.

Returns (nll_sum, valid_count) so the caller owns the mean; labels equal to
``ignore_index`` contribute no loss and no gradient.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def _pick_chunk(T: int, target: int = 4096) -> int:
    """Largest divisor of T that is <= target and a multiple of 128; 0 when
    none exists (the caller then takes one chunk)."""
    best = 0
    for c in range(128, min(T, target) + 1, 128):
        if T % c == 0:
            best = c
    return best


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result (the JAX package's
    ``preferred_element_type=float32``). bf16 inputs go to cuBLAS's bf16
    GEMM with an fp32 output on the card; elsewhere (the CPU, where that
    overload does not exist) they are widened first, which is exact.

    The split is for time: widening runs the four [8192, 32000, 2048]
    GEMMs of a Llama2-1B step's loss in fp32 without tensor cores. Forward
    and backward of the loss at that shape took 12.3-12.5 ms this way and
    93.3-93.5 ms widened, at the same peak memory (H100 80GB HBM3, 700 W),
    against an int8 train step of about 0.8 s."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(T: int, chunk_target: int):
    C = _pick_chunk(T, chunk_target) or T
    return [slice(i, i + C) for i in range(0, T, C)]


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, ignore_index, chunk_target):
        T = x.shape[0]
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_valid = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty(T, dtype=torch.float32, device=x.device)
        for sl in _chunks(T, chunk_target):
            logits = _mm_f32(x[sl], w.T)  # [C, V] f32
            m = logits.amax(dim=-1)
            lse_c = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            safe = labels[sl].clamp(0, w.shape[0] - 1)
            label_logit = logits.gather(1, safe[:, None])[:, 0]
            valid = (labels[sl] != ignore_index).float()
            nll_sum = nll_sum + ((lse_c - label_logit) * valid).sum()
            n_valid = n_valid + valid.sum()
            lse[sl] = lse_c
        ctx.save_for_backward(x, w, labels, lse)
        ctx.ignore_index, ctx.chunk_target = ignore_index, chunk_target
        ctx.mark_non_differentiable(n_valid)
        return nll_sum, n_valid

    @staticmethod
    def backward(ctx, g_nll, _g_valid):
        x, w, labels, lse = ctx.saved_tensors
        T, V = x.shape[0], w.shape[0]
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for sl in _chunks(T, ctx.chunk_target):
            x_c, l_c = x[sl], labels[sl]
            p = torch.exp(_mm_f32(x_c, w.T) - lse[sl, None])  # softmax [C, V]
            valid = (l_c != ctx.ignore_index).float()
            safe = l_c.clamp(0, V - 1)
            # (p - onehot) * (valid * g), with the one-hot subtracted in place
            p[torch.arange(p.shape[0], device=p.device), safe] -= 1.0
            dl = (p * (valid * g_nll)[:, None]).to(x.dtype)
            dx[sl] = _mm_f32(dl, w).to(x.dtype)
            dw += _mm_f32(dl.T, x_c)  # contract over the tokens
        return dx, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(x, w, labels, ignore_index: int = IGNORE_INDEX,
                               chunk_target: int = 4096):
    """Sum of the per-token NLL of ``softmax(x @ w.T)`` and the count of
    valid tokens. x: [T, D] activations, w: [V, D] LM head, labels: [T]
    integers. Returns (nll_sum f32 scalar, n_valid f32 scalar)."""
    return _FusedLinearCrossEntropy.apply(x, w, labels, ignore_index, chunk_target)
