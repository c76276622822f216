"""Producer -> quantize chains of the port: each fused kernel against the
unfused composite it replaces.

Counterpart of the JAX repository's ``benchmark_fused.py`` (:75-284), with
its flags, chains and traffic models, at the all-int8 step's shapes of
Llama2-1B at batch 8 x 2048 (M = 16,384 tokens, K = 2,048, F = 5,632):

- ``norm+row`` RMSNorm then the row quantize: the plain producer then K1,
  against B7; ``norm+col`` the same along columns: B4 against B8 in its
  two-pass form (no given scales); ``silu+row`` / ``silu+col`` silu(a) * b:
  K1 against B9-row, B4 against B9-col in its two-pass form;
- round 4 (:187-265): ``silu-bwd both-q`` (dgate, dup) quantized along both
  axes, ``silu_mul_bwd_f32`` and two B5 against B11 and B12 given B11's
  column scales; ``rope+group (q)`` and ``ungroup+rope (dq)``, B13 against
  its plain version; ``attn-out -> int8 row``, the plain ungrouping and K1
  against B14's absmax and row quantize.

Each side is one call's device time (``utils/timing.py::time_ms``: a CUDA
graph of back-to-back calls over copies of the inputs, CUDA events), where
JAX timed a differential device-side loop. The GB/s column is JAX's
minimum traffic of the fused chain over its time, and its share of the
H100's 3.35 TB/s (the TPU's ~819 GB/s of JAX's docstring is no figure of
this card). :func:`gaps` gives each chain's fused output against the
unfused one: int8 steps apart (the fused kernel quantizes the unrounded
fp32 producer, the composite its bf16 rounding: ``STEP_BOUND`` steps at
most), and B13's exact agreement.

``--cpu`` runs the plain versions with the host clock: it exists to drive
the entry point in tests, and its numbers are no device metric.

  python -m quantized_training_tpu_torch.benchmark_fused [--M 16384] [--K 2048] [--F 5632] [--cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple

import torch

from . import ops
from .bench import device_name, log
from .llm_pretrain import device_of
from .ops import fused_producers as fp
from .ops import rope
from .quant.core import quantize_int8_both
from .utils.timing import copies, host_ms, time_ms

EPS = 1e-5  # RMSNorm's
# the int8 steps a fused output may lie from the unfused composite's: the
# composite rounds the producer to bf16 (twice for RMSNorm and silu, once for
# the silu backward), which moves each value and its scale's absmax by up to
# 2^-8 of itself a rounding, so y / scale at most 127 * 2 * 2^-7 < 2 steps
STEP_BOUND = 2
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's (NVIDIA's data sheet)


class Chain(NamedTuple):
    name: str
    unfused: Callable
    fused: Callable
    args: tuple
    gbytes: float  # JAX's minimum traffic of the fused chain, GB
    pairs: Callable  # (fused out, unfused out) -> [(what, fused tensor, unfused tensor)]


def chain_gbytes(M: int, n_inputs: int, width: int, passes: int) -> float:
    """JAX's traffic model of the first table (:123-126): each input read
    once a pass (bf16), the int8 written once."""
    return (n_inputs * passes * 2 + 1) * M * width / 1e9


def _q(f, u):
    return [("q", f[0], u[0])]


def chains(M: int, K: int, F: int, device) -> list[Chain]:
    """The first table's four chains on inputs from seeds 0-3 (JAX :93-141)."""
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    x = torch.randn(M, K, generator=gen(0), device=device).to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(1, K, generator=gen(1), device=device)).to(torch.bfloat16)
    a = torch.randn(M, F, generator=gen(2), device=device).to(torch.bfloat16)
    b = torch.randn(M, F, generator=gen(3), device=device).to(torch.bfloat16)
    row, col = ops.quantize_int8_rowwise, ops.quantize_int8_colwise
    return [
        Chain("norm+row", lambda x, g: row(fp.rms_norm_ref(x, g[0], EPS)),
              lambda x, g: fp.rmsnorm_quant_rowwise(x, g, norm_eps=EPS), (x, g), chain_gbytes(M, 1, K, 1), _q),
        Chain("norm+col", lambda x, g: col(fp.rms_norm_ref(x, g[0], EPS)),
              lambda x, g: fp.rmsnorm_quant_colwise(x, g, norm_eps=EPS), (x, g), chain_gbytes(M, 1, K, 2), _q),
        Chain("silu+row", lambda a, b: row(fp.silu_mul_ref(a, b)), fp.silu_mul_quant_rowwise, (a, b),
              chain_gbytes(M, 2, F, 1), _q),
        Chain("silu+col", lambda a, b: col(fp.silu_mul_ref(a, b)), fp.silu_mul_quant_colwise, (a, b),
              chain_gbytes(M, 2, F, 2), _q),
    ]


def rope_tables(S: int, hd: int, device):
    """cos, sin [S, hd] of rotate-half rope at base 10,000 (JAX :201-206)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    emb = torch.cat([torch.outer(torch.arange(S, dtype=torch.float32, device=device), inv)] * 2, -1)
    return emb.cos(), emb.sin()


def round4_chains(M: int, K: int, F: int, device) -> list[Chain]:
    """The second table's four chains (JAX :187-265): B = 8, S = M / 8, 32
    heads of 64 in 4 groups; inputs from seeds 2-6."""
    B, S, H, KV, hd = 8, M // 8, 32, 4, 64
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    bf = lambda s, *shape: torch.randn(*shape, generator=gen(s), device=device).to(torch.bfloat16)
    a, b, dy = bf(2, M, F), bf(3, M, F), bf(4, M, F)
    xq, yg = bf(5, B, S, H, hd), bf(6, B, KV, H // KV, S, hd)
    cos, sin = rope_tables(S, hd, device)
    c2, s2 = rope.pair_tables(cos, sin)

    def unfused_silu_bwd(a, b, dy):
        da, db = fp.silu_mul_bwd_f32(a, b, dy)
        return quantize_int8_both(da.to(a.dtype)) + quantize_int8_both(db.to(a.dtype))

    def fused_silu_bwd(a, b, dy):
        row = fp.silu_mul_bwd_quant_rowwise(a, b, dy)
        return row + fp.silu_mul_bwd_quant_colwise(a, b, dy, row[4] * (1 / 127.0), row[5] * (1 / 127.0))

    def unfused_out_quant(y):
        x2d = rope.rope_ungroup_ref(y, None, None).reshape(B * S, H * hd)
        return ops.quantize_int8_rowwise(x2d)

    def fused_out_quant(y):
        rows, cols = rope.ungroup_amax(y)
        return rope.ungroup_quant(y, rows * (1 / 127.0), axis=1), rows, cols

    gb_silu = 3 * M * F * 2 / 1e9  # one read of (a, b, dy)
    gb_rope = 2 * B * S * H * hd * 2 / 1e9  # read + write bf16
    return [
        Chain("silu-bwd both-q", unfused_silu_bwd, fused_silu_bwd, (a, b, dy), 2 * gb_silu + 4 * M * F / 1e9,
              lambda f, u: [("da row", f[0], u[0]), ("db row", f[2], u[4]), ("da col", f[6], u[2]),
                            ("db col", f[7], u[6])]),
        Chain("rope+group (q)", lambda x: rope.rope_group_ref(x, cos, sin, KV),
              lambda x: rope.rope_group_kernel(x, c2, s2, kv=KV), (xq,), gb_rope, lambda f, u: [("out", f, u)]),
        Chain("ungroup+rope (dq)", lambda y: rope.rope_ungroup_ref(y, cos, sin, inverse=True),
              lambda y: rope.rope_ungroup_kernel(y, c2, s2, inverse=True), (yg,), gb_rope,
              lambda f, u: [("out", f, u)]),
        Chain("attn-out -> int8 row", unfused_out_quant, fused_out_quant, (yg,), gb_rope + B * S * H * hd / 1e9,
              lambda f, u: [("q", f[0].reshape(u[0].shape), u[0])]),
    ]


def gaps(chain: Chain) -> list[tuple[str, float]]:
    """Each output of the fused side against the unfused one's: the largest
    gap in int8 steps, or in value for a float output."""
    with torch.no_grad():
        pairs = chain.pairs(chain.fused(*chain.args), chain.unfused(*chain.args))
        return [(what, (f.int() - u.int()).abs().max().item() if f.dtype == torch.int8
                 else (f.float() - u.float()).abs().max().item()) for what, f, u in pairs]


def table(title: str, rows: list) -> None:
    print(f"| {title} | unfused ms | fused ms | speedup | fused GB/s | of 3.35 TB/s |")
    print("|---|---|---|---|---|---|")
    for name, ms_u, ms_f, gbs in rows:
        print(f"| {name} | {ms_u:.3f} | {ms_f:.3f} | {ms_u / ms_f:.2f}x | {gbs:.0f} | "
              f"{gbs * 1e9 / HBM_BYTES_PER_S:.3f} |", flush=True)


def main(argv: list[str] | None = None) -> dict:
    """Prints both tables; returns {chain: (unfused ms, fused ms, fused GB/s)}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--M", type=int, default=16384)
    p.add_argument("--K", type=int, default=2048)
    p.add_argument("--F", type=int, default=5632)
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "benchmark_fused")
    timer = host_ms if device == "cpu" else time_ms
    log(f"device: {device_name(device)}" + ("" if device == "cuda" else " (plain versions; host-clock times)"))
    out = {}
    for title, cases in (("chain", chains(args.M, args.K, args.F, device)),
                         ("round-4 chain", round4_chains(args.M, args.K, args.F, device))):
        rows = []
        for c in cases:
            ms_u, ms_f = timer(c.unfused, copies(*c.args)), timer(c.fused, copies(*c.args))
            gbs = c.gbytes / (ms_f * 1e-3)
            log(f"{c.name}: unfused {ms_u:.3f} ms, fused {ms_f:.3f} ms ({ms_u / ms_f:.2f}x), fused {gbs:.0f} GB/s")
            rows.append((c.name, ms_u, ms_f, gbs))
            out[c.name] = (ms_u, ms_f, gbs)
        table(title, rows)
    return out


if __name__ == "__main__":
    main()
