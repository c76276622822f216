"""fp8 (e4m3) mixed precision on the CPU: the port's fp8 quantizes
(ops/fp8.py), B15's plain version (ops/tile_scaled_mm.py), the row- and
tile-scaled fp8 linear with both gradients and a 2-layer Llama's loss and
gradients, against the JAX package on the same numpy inputs; and the
per-step launch counts of the two fp8 configurations that chip_smoke.py
holds the card to.

Tolerances: none for the quantizes (the same fp32 divisions and casts).
B15's plain version sums each K block's partial exactly (float64) and folds
it into its fp32 accumulator as ``acc + (part * sa) * sb``; the JAX kernel
and the JAX default path fold in another association (XLA contracts the
multiply-add, and its fp8 partial is an fp32 dot of bf16 values), so each
is held to the fp32 rounding that folding can differ by, stated at the
test. The linear and the model carry framework rounding differences through
e4m3 rounding; their bounds sit above the floor of the JAX function against
itself with one input moved by one ulp.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import fp8 as jfp8
from quantized_training_tpu.ops import pallas_mm
from quantized_training_tpu_torch import ops, quant, train
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import fp8
from test_torch_int4 import B, KW, S, _np, _pair, count_gemms, loss_and_grads_vs_jax, per_step, _linear_vs_jax

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

jsm = importlib.import_module("quantized_training_tpu.ops.scaled_mm")
tsm = importlib.import_module("quantized_training_tpu_torch.ops.tile_scaled_mm")


def _t(x):
    """A JAX array (int8, fp32, bf16 or e4m3) as a torch tensor of its type."""
    if x.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(np.asarray(x).view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["row", "col", "tile", "block"])
def test_quantize_fp8_same_bits_as_jax(kind, dtn):
    """The e4m3 bits (compared as uint8) and the scales equal the JAX
    package's, with an all-zero row, tile and block, and one value far
    above the rest of its group."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((256, 384)) * np.exp(rng.uniform(-4, 4, (256, 1)))
    x[0] = 0
    x[5, 3] = 1e3
    jx, tx = _pair(x, dtn)
    jf, tf, kw = {"row": (jfp8.quantize_fp8, fp8.quantize_fp8, {}),
                  "col": (jfp8.quantize_fp8, fp8.quantize_fp8, {"axis": 0}),
                  "tile": (jfp8.quantize_fp8_tile, fp8.quantize_fp8_tile, {}),
                  "block": (jfp8.quantize_fp8_block, fp8.quantize_fp8_block, {})}[kind]
    jq, js = jf(jx, **kw)
    tq, ts = tf(tx, **kw)
    assert tq.dtype == torch.float8_e4m3fn and ts.dtype == tx.dtype and tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(_np(ts), _np(js))


# (M, K, N, QM, QN): n_qk 4 (JAX's tests/test_pallas.py:51), 8 with the
# model's QM = 1, and 40 > 32, the JAX kernel's other scale layout (:62)
TILE_CASES = [(256, 512, 256, 128, 128), (64, 1024, 256, 1, 128), (64, 5120, 128, 64, 128)]


@pytest.mark.parametrize("M,K,N,qm,qn", TILE_CASES)
def test_tile_scaled_mm_plain_int8_vs_jax(M, K, N, qm, qn):
    """int8 operands: B15's plain version against the Pallas kernel in
    interpret mode and the JAX package's XLA path, within one fp32 rounding
    per K block of the folded magnitudes (fold_bound: the partials are
    exact, only the folds round), and against the
    fp32 oracle scaled_mm_ref within 1e-3, as JAX's own tests hold it."""
    rng = np.random.default_rng(M + K)
    a = jnp.asarray(rng.integers(-127, 128, (M, K)), jnp.int8)
    b = jnp.asarray(rng.integers(-127, 128, (K, N)), jnp.int8)
    sa = jnp.asarray(rng.uniform(0, 0.1, (M // qm, K // 128)), jnp.float32)
    sb = jnp.asarray(rng.uniform(0, 0.1, (K // 128, N // qn)), jnp.float32)
    got = tsm.tile_scaled_mm_plain(_t(a), _t(b), _t(sa), _t(sb), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    bound = tsm.fold_bound(_t(a), _t(b), _t(sa), _t(sb), K // 128).numpy()
    pal = pallas_mm.tile_scaled_mm(a, b, sa, sb, out_dtype=jnp.float32, interpret=True, block_m=128, block_n=128)
    xla = jsm.scaled_mm(a, b, sa, sb, out_dtype=jnp.float32)
    for ref in (pal, xla):
        assert (np.abs(got.double().numpy() - np.asarray(ref, np.float64)) <= bound).all()
    oracle = np.asarray(jsm.scaled_mm_ref(a, b, sa, sb))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,qm,qn", TILE_CASES)
def test_tile_scaled_mm_plain_e4m3_vs_jax(M, K, N, qm, qn, out):
    """e4m3 operands from quantize_fp8_tile / quantize_fp8_block (QM = 1)
    or with free tile scales: B15's plain version against the JAX package,
    which upcasts them to bf16 (exactly) before its kernel (interpret mode)
    and its XLA path. Each JAX partial is an fp32 sum of exact products,
    so the bound adds one fp32 rounding per summed product of a block:
    (n_qk + 128) * 2**-23 of the folded magnitudes; bf16 outputs within one
    bf16 ulp (2**-7 relative) more. Against the fp32 oracle within 1e-3 of
    max|out| (1e-2 for a bf16 output)."""
    rng = np.random.default_rng(M * N)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    if qm == 1:
        aq, sa = jfp8.quantize_fp8_tile(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16))
        bq, sb = jfp8.quantize_fp8_block(jnp.asarray(rng.standard_normal((K, N)) * 0.02, jnp.bfloat16))
    else:
        aq = jnp.asarray(rng.standard_normal((M, K)) * 50, jnp.float32).astype(jnp.float8_e4m3fn)
        bq = jnp.asarray(rng.standard_normal((K, N)) * 50, jnp.float32).astype(jnp.float8_e4m3fn)
        sa = jnp.asarray(rng.uniform(0, 0.1, (M // qm, K // 128)), jnp.float32)
        sb = jnp.asarray(rng.uniform(0, 0.1, (K // 128, N // qn)), jnp.float32)
    ta, tb, tsa, tsb = (_t(v) for v in (aq, bq, sa, sb))
    got = tsm.tile_scaled_mm_plain(ta, tb, tsa, tsb, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    fold = tsm.fold_bound(ta, tb, tsa, tsb, K // 128 + 128)
    exact = tsm.tile_scaled_mm_plain(ta, tb, tsa, tsb, out_dtype=torch.float64).abs()
    bound = (fold + (2.0**-7 * (exact + fold) if out == "bf16" else 0)).numpy()
    pal = pallas_mm.tile_scaled_mm(aq.astype(jnp.bfloat16), bq.astype(jnp.bfloat16), sa, sb, out_dtype=jdt,
                                   interpret=True, block_m=128, block_n=128)
    xla = jsm.scaled_mm(aq, bq, sa, sb, out_dtype=jdt)
    for ref in (pal, xla):
        assert (np.abs(got.double().numpy() - _np(ref).astype(np.float64)) <= bound).all()
    oracle = np.asarray(jsm.scaled_mm_ref(aq, bq, sa, sb))
    assert np.abs(got.double().numpy() - oracle).max() <= (1e-3 if out == "f32" else 1e-2) * np.abs(oracle).max()
    # the port's dispatcher takes the tile branch for 2-D scale grids
    assert torch.equal(ops.scaled_mm(ta, tb, tsa, tsb, out_dtype=tdt), got)


def test_scaled_fp8_mm_row_vs_jax():
    """Row-scaled fp8 (no kernel): the port's fp32 product and epilogue
    against the JAX package's scaled_fp8_mm and scaled_mm_general in every
    contraction form, within 1e-6 of max|out| (fp32 sum order only)."""
    rng = np.random.default_rng(1)
    a, sa = jfp8.quantize_fp8(jnp.asarray(rng.standard_normal((96, 256)), jnp.bfloat16))
    b, sb = jfp8.quantize_fp8(jnp.asarray(rng.standard_normal((256, 160)), jnp.bfloat16), axis=0)
    for dims, (x, y, s1, s2) in (((1, 0), (a, b, sa, sb)), ((1, 1), (a, b.T, sa, sb.T)),
                                 ((0, 0), (a.T, b, sa.T, sb))):
        ref = np.asarray(jsm.scaled_mm_general(x, y, s1, s2, dims=dims, out_dtype=jnp.float32))
        got = ops.scaled_mm_general(_t(x), _t(y), _t(s1), _t(s2), dims=dims, out_dtype=torch.float32)
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    ref = np.asarray(jfp8.scaled_fp8_mm(a, b, sa, sb.reshape(1, -1), out_dtype=jnp.float32))
    got = fp8.scaled_fp8_mm(_t(a), _t(b), _t(sa), _t(sb).reshape(1, -1), out_dtype=torch.float32)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


# relative bound of (out, grad_input, grad_weight) over the shapes below.
# The port against JAX, worst of the three: row 1.1e-8 (fp32) and 0 (bf16),
# tile 3.8e-8 and 6.9e-8 (fp32 sum order, an output's bf16 rounding). For
# scale, the floor of JAX against itself with x moved by one ulp: 1.1e-7 in
# fp32, 2.4e-2 in bf16 (an e4m3 flip is an eighth of a value's size).
LINEAR_BOUNDS = {"f32": 1e-6, "bf16": 1e-5}


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("scale", ["row", "tile"])
@pytest.mark.parametrize("shape", [(2, 48, 128), (256, 256)])
def test_fp8_linear_vs_jax(shape, scale, dtn):
    """The fp8 linear (all three matmuls e4m3) against JAX's qlinear and
    jax.grad. At 96 tokens the tile config's grad_weight (K = the tokens)
    falls back to row scales, as in JAX; at 256 every matmul is tiled."""
    _linear_vs_jax(shape, dtn, dict(dtype="fp8_e4m3", scale=scale), LINEAR_BOUNDS[dtn])


@pytest.mark.parametrize("scale", ["row", "tile"])
def test_llama_loss_and_grads_fp8_vs_jax(scale):
    """fp32. The floor (JAX against itself with the embedding moved by one
    ulp, two draws): row loss 1.4e-6, worst leaf 4.5e-2; tile 1.8e-5 and
    5.2e-2. The port against JAX: row 1.1e-6 and 4.8e-2, tile 0 and
    8.1e-3. Bounds 1e-4 on the loss and 1e-1 on a leaf."""
    loss_and_grads_vs_jax(dict(dtype="fp8_e4m3", scale=scale), (1e-4, 1e-1))


@pytest.mark.parametrize("scale", ["row", "tile"])
def test_kernel_calls_per_step_fp8(monkeypatch, scale):
    """One remat train step of the fp8-tile config launches B15's e4m3 form
    27 L times (7 weights: forward, grad_input, grad_weight, and 6 in the
    replay, not down's: every
    dim of the model and the 128 tokens are multiples of 128, so nothing
    falls back to row scales); the fp8-row config launches no kernel of
    these, and neither launches an int8 quantize or GEMM."""
    counts = count_gemms(monkeypatch)
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision",
                                   dtype="fp8_e4m3", scale=scale)
    rng = np.random.default_rng(2)
    tok, lab = (torch.from_numpy(rng.integers(0, KW["vocab_size"], (B, S))) for _ in range(2))
    loss, _ = train.loss_and_grads(cfg, params, tok, lab)
    assert np.isfinite(loss.item())
    assert counts == per_step(KW["num_hidden_layers"], "tile_scaled_mm" if scale == "tile" else None)


def test_device_tensor_takes_the_kernel(monkeypatch):
    """A non-CPU tensor (meta here) takes B15's launch path, never its plain
    version: the fp8-tile linear's forward reaches B15's wrapper, which
    refuses a non-CUDA device."""
    monkeypatch.setattr(tsm, "tile_scaled_mm_plain", lambda *a, **k: pytest.fail("the plain version ran"))
    x = torch.empty(128, 256, device="meta")
    w = quant.MixedPrecisionWeight(torch.empty(128, 256, device="meta"),
                                   quant.MixedPrecisionConfig(dtype="fp8_e4m3", scale="tile"))
    with pytest.raises(ValueError, match="^tile_scaled_mm: all operands must be on one CUDA device"):
        quant.qlinear(x, w)
