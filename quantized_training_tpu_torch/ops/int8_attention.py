"""INT8 flash attention, forward: kernel B19, its plain version, its input
quantize and its oracle.

Counterpart of ``quantized_training_tpu/ops/int8_attention.py``:

- :func:`int8_flash_fwd` ports ``int8_flash_fwd`` (:117), which B19
  replaces: a causal flash-attention forward whose two products run on int8
  operands. q and k carry per-token scales off the contraction; v's per-row
  scales are folded into p, which is re-quantized per q row inside the
  kernel over each kv block of ``block_kv`` columns; the softmax statistics
  (m, l) stay fp32 and l sums the unquantized p. Returns (out bf16, lse
  fp32);
- :func:`quantize_qkv` (:171) and :func:`attention_ref` (:197), plain jnp
  there, plain torch here.

As in the JAX package, nothing wires it into the model (the JAX module
measured it and kept it as an op, :28-34). Layout is grouped GQA: per
instance q [G, S, hd] and shared k, v [S, hd]. Any leading dimensions are
instances (one per batch element and kv head), so that one launch covers a
layer: the written-out counterpart of a ``jax.vmap`` over instances.

``block_kv`` is part of the numerics (p's row absmax runs over one kv block);
``block_q`` changes no number, and B19 takes its own q tile. B19 is
``csrc/int8_attention.cu``; its header says what bounds it on the H100 and how
its two designs answer that. :func:`int8_flash_sm90_route` picks the design:
the sm90 one (TMA, a producer warpgroup, wgmma for both products) where it
tiles the shape, else the first (wmma, scores in shared memory).
"""

from __future__ import annotations

import torch

from . import _build
from .fused_producers import _sm_count
from .int8_quant import _count_route

NEG_INF = -1e30
# the sm90 design's geometry (csrc/int8_attention.cu: kFlashRows,
# kFlashChunk, kFlashMaxBkv): q rows a work item (wgmma's M), kv columns a
# chunk (its N and K), the largest block_kv (two chunks for each of the two
# consumer warpgroups); one CTA an SM (__launch_bounds__(384, 1))
FLASH_ROWS, FLASH_CHUNK, FLASH_MAX_BKV = 64, 128, 512
FLASH_CTAS_PER_SM = 1


def _blocks(S: int, block_q: int, block_kv: int) -> tuple[int, int]:
    bq, bkv = min(block_q, S), min(block_kv, S)
    if S % bq or S % bkv:
        raise ValueError(f"int8_flash_fwd: S = {S} must be a multiple of block_q {bq} and block_kv {bkv}")
    return bq, bkv


def _check_shapes(q_i8, q_s, k_i8, k_s, v_i8, v_s):
    *lead, G, S, hd = q_i8.shape
    lead = tuple(lead)
    want = {"q_s": (q_s, (*lead, G, S, 1)), "k_i8": (k_i8, (*lead, S, hd)), "k_s": (k_s, (*lead, S)),
            "v_i8": (v_i8, (*lead, S, hd)), "v_s": (v_s, (*lead, S))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"int8_flash_fwd: {name} {tuple(t.shape)}, expected {shape} for q {tuple(q_i8.shape)}")
    return lead, G, S, hd


def int8_flash_fwd_plain(q_i8, q_s, k_i8, k_s, v_i8, v_s, *, causal: bool = True, block_q: int = 512,
                         block_kv: int = 512):
    """Plain version of B19, all q rows at once, kv block after kv block, in
    the JAX kernel's fp32 operations and order (:62-114). The integer
    products go through float64 (exact at these depths); a kv block wholly in
    a row's future is an exact no-op for that row (alpha 1, p 0, p_i8 0), so
    the q block changes no number."""
    _, _, S, _ = _check_shapes(q_i8, q_s, k_i8, k_s, v_i8, v_s)
    _, bkv = _blocks(S, block_q, block_kv)
    qs = q_s.float()                                                       # [..., G, S, 1]
    ks, vs = (t.float()[..., None, None, :] for t in (k_s, v_s))            # [..., 1, 1, S]
    qd = q_i8.double()
    kd, vd = k_i8.double().unsqueeze(-3), v_i8.double().unsqueeze(-3)  # [..., 1, S, hd]
    shape = q_i8.shape[:-1] + (1,)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q_i8.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q_i8.device)
    acc = torch.zeros(q_i8.shape, dtype=torch.float32, device=q_i8.device)
    rows = torch.arange(S, device=q_i8.device).reshape(S, 1)
    tiny = torch.full((), 1e-30, dtype=torch.float32, device=q_i8.device)
    for j in range(S // bkv):
        c = slice(j * bkv, (j + 1) * bkv)
        s32 = (qd @ kd[..., c, :].transpose(-1, -2)).float()  # [..., G, S, bkv], exact
        s = s32 * qs * ks[..., c]
        if causal:
            cols = torch.arange(j * bkv, (j + 1) * bkv, device=q_i8.device).reshape(1, bkv)
            s = torch.where(cols <= rows, s, torch.full((), NEG_INF, device=q_i8.device))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        ps = p * vs[..., c]
        pscale = ps.amax(-1, keepdim=True) * (1.0 / 127.0)
        p_i8 = torch.round(ps * (1.0 / torch.maximum(pscale, tiny)))
        pv = (p_i8.double() @ vd[..., c, :]).float()  # exact
        acc = acc * alpha + pv * pscale
    l = torch.maximum(l, torch.full((), 1e-20, dtype=torch.float32, device=q_i8.device))
    return (acc / l).to(torch.bfloat16), m + torch.log(l)


def agreement(out, lse, ref_out, ref_lse, v_s) -> tuple[bool, float, float]:
    """(within the bound, max |out - ref_out|, share of out's elements that
    differ) of two results of B19's arithmetic on the same inputs, as the
    kernel, its plain version and the JAX kernel give them. They differ in
    the order of the row sums of p, which moves l, so lse by at most
    S * 2**-24 + 2**-23 |lse| and out by about as much plus one bf16 step;
    and an exponential rounded otherwise can flip one p_i8 at a round-half
    point, which moves out by at most pscale * 127 / l <= max(v_s). The
    bound: |out - ref_out| <= max(v_s) + 2**-7 |ref_out| everywhere, on at
    most 1% of the elements, and lse as above."""
    S = out.shape[-2]
    d = (out.double() - ref_out.double()).abs()
    ok_out = bool((d <= v_s.double().max() + 2.0**-7 * ref_out.double().abs()).all())
    share = (d > 0).double().mean().item()
    dl = (lse.double() - ref_lse.double()).abs()
    ok_lse = bool((dl <= S * 2.0**-24 + 2.0**-23 * ref_lse.double().abs()).all())
    return ok_out and ok_lse and share <= 1e-2, d.max().item(), share


def int8_flash_sm90_route(S: int, hd: int, bkv: int, causal: bool) -> int:
    """CTAs an SM of B19's sm90 design at sequence length S, head dim hd and
    kv block bkv (causal or not: the design takes both), or 0 for the first
    design: hd 64 or 128, bkv a multiple of ``FLASH_CHUNK`` up to
    ``FLASH_MAX_BKV`` that divides S. bkv 64, and any other head dim, keep
    the first design."""
    del causal
    tiles = hd in (64, 128) and 0 < bkv <= FLASH_MAX_BKV and bkv % FLASH_CHUNK == 0 and S % bkv == 0
    return FLASH_CTAS_PER_SM if tiles else 0


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is off a 16-byte boundary (the sm90
    design copies the scales with bulk copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q_i8, q_s, k_i8, k_s, v_i8, v_s, causal, bkv):
    tensors = (q_i8, q_s, k_i8, k_s, v_i8, v_s)
    if not all(t.is_cuda and t.device == q_i8.device for t in tensors):
        raise ValueError("int8_flash_fwd: all inputs must be on one CUDA device")
    if not all(t.dtype == torch.int8 for t in (q_i8, k_i8, v_i8)):
        raise TypeError(f"int8_flash_fwd: int8 q, k, v, got {q_i8.dtype}, {k_i8.dtype}, {v_i8.dtype}")
    lead, G, S, hd = _check_shapes(*tensors)
    if hd not in (64, 128) or S % 64 or bkv % 64 or bkv > 512:
        raise ValueError(f"int8_flash_fwd: B19 takes hd 64 or 128 (got {hd}), S % 64 == 0 (S = {S}) and a block_kv "
                         f"that is a multiple of 64 up to 512 (got {bkv})")
    q, k, v = (t.contiguous() for t in (q_i8, k_i8, v_i8))
    qs, ks, vs = (t.float().contiguous() for t in (q_s, k_s, v_s))
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("int8_flash_fwd: q, k and v must be 16-byte aligned")
    n_inst = 1
    for d in lead:
        n_inst *= d
    route = int8_flash_sm90_route(S, hd, bkv, causal)
    ctas = min(n_inst * G * (S // FLASH_ROWS), route * _sm_count(q.device)) if route else 0
    if route:
        ks, vs = _aligned16(ks), _aligned16(vs)
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((*lead, G, S, 1), dtype=torch.float32, device=q.device)
    err = _build.library().qt_int8_flash_fwd(
        q.data_ptr(), qs.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(), out.data_ptr(),
        lse.data_ptr(), n_inst, G, S, hd, bkv, int(causal), ctas, _build.stream(),
    )
    _build.check(err, "int8_flash_fwd")
    _count_route(int8_flash_fwd, False, bool(route))
    return out, lse


def int8_flash_fwd(q_i8: torch.Tensor, q_s: torch.Tensor, k_i8: torch.Tensor, k_s: torch.Tensor,
                   v_i8: torch.Tensor, v_s: torch.Tensor, *, causal: bool = True, block_q: int = 512,
                   block_kv: int = 512):
    """``(out bf16 [..., G, S, hd], lse fp32 [..., G, S, 1])`` of int8 flash
    attention: q_i8 [..., G, S, hd] int8 with q_s [..., G, S, 1], k_i8 and
    v_i8 [..., S, hd] int8 with k_s and v_s [..., S] (the scales are taken in
    fp32), the leading dimensions instances. S must be a multiple of
    ``min(block_q, S)`` and ``min(block_kv, S)``. A CPU tensor takes
    :func:`int8_flash_fwd_plain`; CUDA tensors launch B19 on the current
    stream (hd 64 or 128, S % 64 == 0, block_kv a multiple of 64 up to
    512), on its sm90 design where :func:`int8_flash_sm90_route` takes the
    shape (counted in ``sm90_launches`` too)."""
    S = q_i8.shape[-2]
    _, bkv = _blocks(S, block_q, block_kv)
    if q_i8.device.type == "cpu":
        return int8_flash_fwd_plain(q_i8, q_s, k_i8, k_s, v_i8, v_s, causal=causal, block_q=block_q,
                                    block_kv=block_kv)
    return _launch(q_i8, q_s, k_i8, k_s, v_i8, v_s, causal, bkv)


int8_flash_fwd.launches = 0
int8_flash_fwd.sm90_launches = 0


def quantize_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_kv: int | None = None):
    """Quantize grouped attention inputs for :func:`int8_flash_fwd` (JAX
    :171-194): q [..., G, S, hd], k and v [..., S, hd] -> (q_i8, q_s
    [..., G, S, 1], k_i8, k_s [..., S], v_i8, v_s [..., S]), row-wise absmax
    in fp32, round half to even, a true division; the softmax temperature
    hd**-0.5 is folded into q_s. ``block_kv`` is unused, as in JAX."""
    def row_q(x):
        x = x.float()
        s = x.abs().amax(-1, keepdim=True) / torch.full((), 127.0, device=x.device)
        return torch.round(x / s.clamp(min=1e-12)).to(torch.int8), s

    q_i8, q_s = row_q(q)
    k_i8, k_s = row_q(k)
    v_i8, v_s = row_q(v)
    q_s = q_s * (q.shape[-1] ** -0.5)
    return q_i8, q_s, k_i8, k_s[..., 0], v_i8, v_s[..., 0]


def attention_ref(q, k, v, causal: bool = True):
    """The bf16 / fp32 oracle (JAX :197-209): fp32 scores with the hd**-0.5
    temperature, -inf above the diagonal, softmax, p cast to q's dtype, then
    p . v in q's dtype. q [..., G, S, hd], k and v [..., S, hd]."""
    S, hd = q.shape[-2:]
    scores = (q.float() @ k.float().unsqueeze(-3).transpose(-1, -2)) * (hd ** -0.5)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return p.to(q.dtype) @ v.unsqueeze(-3)
