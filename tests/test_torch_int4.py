"""int4 mixed precision on the CPU: the port's int4 quantize and unpack
(quant/core.py), B16's plain version (ops/int4_mm.py), the int4 linear with
both gradients and a 2-layer Llama's loss and gradients, against the JAX
package on the same numpy inputs; and the per-step launch counts of the
int4 configuration that chip_smoke.py holds the card to.

Tolerances: none for the quantize, the unpack and B16's plain version (the
same fp32 operations in the same order, and exact integer sums). The
linear and the model go through attention, norms and casts that round
differently in the two frameworks, and int4 rounding carries any such
difference; their bounds sit above the floor of the JAX function against
itself with one input moved by one ulp (each test names its numbers).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.ops import pallas_mm
from quantized_training_tpu.quant import core as jcore
from quantized_training_tpu_torch import ops, quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.quant import core, mixed_precision
from quantized_training_tpu_torch.utils.tree import tree_leaves

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

# both ops packages export a function of the module's name
jint4 = importlib.import_module("quantized_training_tpu.ops.int4_mm")
int4_mm = importlib.import_module("quantized_training_tpu_torch.ops.int4_mm")

# every linear of the body >= 128 and a multiple of 32: all seven quantized
KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 64
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtn):
    """The same values as a JAX array and a torch tensor of the dtype."""
    jdt, tdt = _DT[dtn]
    jx = jnp.asarray(x, jdt)
    return jx, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 64), (40, 256), (128, 512)])
def test_quantize_int4_same_bits_as_jax(shape, dtn):
    """The packed bytes and the scales equal the JAX package's, with an
    all-zero row, a row of one sign and the extremes of the range; the
    unpack equals JAX's unpack_int4_rowwise and ops/int4_mm.unpack_int4."""
    x = np.random.default_rng(shape[0]).standard_normal(shape)
    x[0] = 0
    x[1] = np.abs(x[1])
    x[2, :4] = [7.0, -8.0, 3.5, -0.5]
    jx, tx = _pair(x, dtn)
    jp, js = jcore.quantize_int4_rowwise_absmax(jx)
    tp, ts = core.quantize_int4_rowwise_absmax(tx)
    assert tp.dtype == torch.int8 and tp.shape == (shape[0], shape[1] // 2) and ts.dtype == tx.dtype
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(core.unpack_int4_rowwise(tp).numpy(), np.asarray(jcore.unpack_int4_rowwise(jp)))
    np.testing.assert_array_equal(ops.unpack_int4(tp).numpy(), np.asarray(jint4.unpack_int4(jp)))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", [(64, 128, 256), (40, 96, 512), (256, 128, 1024)])
def test_scaled_int4_mm_plain_equals_jax(M, N, K, out):
    """B16's plain version equals the Pallas kernel (interpret mode, the
    in-kernel hi . hi + lo . lo split) and the JAX package's default path
    (unpack, int32 dot, fp32 epilogue), bit for bit; int4_mm is the exact
    int32 product."""
    rng = np.random.default_rng(M + N + K)
    jx, tx = _pair(rng.standard_normal((M, K)), "bf16")
    jw, tw = _pair(rng.standard_normal((N, K)) * 0.5, "bf16")
    jap, jrs = jcore.quantize_int4_rowwise_absmax(jx)
    jbp, jcs = jcore.quantize_int4_rowwise_absmax(jw)
    tap, trs = core.quantize_int4_rowwise_absmax(tx)
    tbp, tcs = core.quantize_int4_rowwise_absmax(tw)
    jdt, tdt = _DT[out]
    got = int4_mm.scaled_int4_mm(tap, tbp, trs, tcs, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    ref = jint4.scaled_int4_mm(jap, jbp, jrs, jcs, out_dtype=jdt)
    pal = pallas_mm.scaled_int4_mm(jap, jbp, jrs, jcs, out_dtype=jdt, interpret=True,
                                   block_m=128, block_n=128, block_k=128)
    np.testing.assert_array_equal(_np(got), _np(ref))
    np.testing.assert_array_equal(_np(got), _np(pal))
    np.testing.assert_array_equal(int4_mm.int4_mm(tap, tbp).numpy(), np.asarray(jint4.int4_mm(jap, jbp)))


def _linear_vs_jax(shape, dtn, qkw, bound):
    """y = qlinear(x, w), then (dx, dw) of sum(y * r) in both packages,
    each within ``bound`` of JAX's relative to its norm (0: equal)."""
    rng = np.random.default_rng(shape[0])
    jx, tx = _pair(rng.standard_normal(shape), dtn)
    jw, tw = _pair(rng.standard_normal((192, shape[-1])) * 0.05, dtn)
    jr, tr = _pair(rng.standard_normal((*shape[:-1], 192)), dtn)
    jcfg = jquant.MixedPrecisionConfig(**qkw)

    def jfn(x, w):
        return jnp.sum((jquant.qlinear(x, jquant.MixedPrecisionWeight(w, jcfg)) * jr).astype(jnp.float32))

    jy = jquant.qlinear(jx, jquant.MixedPrecisionWeight(jw, jcfg))
    jdx, jdw = jax.grad(jfn, argnums=(0, 1))(jx, jw)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    y = quant.qlinear(x, mixed_precision.MixedPrecisionWeight(w, quant.MixedPrecisionConfig(**qkw)))
    dx, dw = torch.autograd.grad((y * tr).float().sum(), (x, w))
    assert y.dtype == tx.dtype and dx.dtype == tx.dtype and dw.dtype == tw.dtype
    for got, ref in ((y, jy), (dx, jdx), (dw, jdw)):
        ref = _np(ref).astype(np.float64)
        assert got.shape == ref.shape
        assert np.linalg.norm(got.detach().double().numpy() - ref) <= bound * np.linalg.norm(ref)


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 48, 128), (256, 256)])
def test_int4_linear_vs_jax(shape, dtn):
    """The int4 linear (forward, grad_input and grad_weight int4, each
    operand quantized in the standard [M, K] . [K, N] form) against JAX's
    qlinear and jax.grad, at 96 tokens and at 256: equal, bit for bit (the
    quantizes are, the sums are exact, and the epilogue and transposes
    round alike; for scale, JAX against itself with x moved by one ulp
    differs by 1.1e-7 in fp32 and 4.6e-2 in bf16)."""
    _linear_vs_jax(shape, dtn, dict(dtype="int4"), 0.0)


def test_int4_ignores_stochastic_rounding():
    """int4 ignores stochastic_rounding, as the JAX package does: the same
    numbers with SR on (given a key) as off."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((128, 128)).astype(np.float32))
    on = quant.qlinear(x, mixed_precision.MixedPrecisionWeight(
        w, quant.MixedPrecisionConfig(dtype="int4", stochastic_rounding=True)), key=3)
    off = quant.qlinear(x, mixed_precision.MixedPrecisionWeight(w, quant.MixedPrecisionConfig(dtype="int4")))
    assert torch.equal(on, off)


def loss_and_grads_vs_jax(qkw, bounds, dtn="f32"):
    """A 2-layer Llama (remat, the einsum attention), the JAX package's
    quantize_params with ``qkw`` carried across by params_from_jax (the
    wrappers with their config): the loss and every gradient leaf of one
    batch against jax.value_and_grad of JAX's loss_fn, within ``bounds``
    (loss, worst leaf's relative norm)."""
    jdt, _ = _DT[dtn]
    jcfg = jllama.LlamaConfig(**KW, attention_impl="xla", remat=True)
    cfg = llama.LlamaConfig(**KW, attention_impl="xla", remat=True)
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jdt), "mixed_precision", **qkw)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert tp["layers"]["k"]["w"].config == quant.MixedPrecisionConfig(**qkw)
    rng = np.random.default_rng(3)
    tok, lab = rng.integers(0, KW["vocab_size"], (B, S)), rng.integers(0, KW["vocab_size"], (B, S))
    jl, jg = jax.value_and_grad(lambda p: jllama.loss_fn(p, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                                                          key=jax.random.PRNGKey(1)))(jp)
    tl, tg = train.loss_and_grads(cfg, tp, torch.from_numpy(tok), torch.from_numpy(lab), 1)
    b_loss, b_leaf = bounds
    assert abs(tl.item() - float(jl)) <= b_loss * abs(float(jl))
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tree_leaves(tg))
    for a, b in zip(tree_leaves(tg), jleaves):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.double().numpy() - b) <= b_leaf * np.linalg.norm(b)


def test_llama_loss_and_grads_int4_vs_jax():
    """fp32. The floor (JAX against itself with the embedding moved by one
    ulp, two draws): loss 7.6e-8, worst leaf 2.7e-7; the port against JAX
    7.6e-8 and 3.7e-7. Bounds 1e-6 and 2e-6: int4's coarse grid flips
    rarely, so a wiring fault moves a leaf by far more."""
    loss_and_grads_vs_jax(dict(dtype="int4"), (1e-6, 2e-6))


def count_gemms(monkeypatch):
    """Count the calls of B16's and B15's wrappers (on the card, each call
    is one launch) and of the int8 GEMMs and quantizes, by wrapping the
    names their callers look up."""
    counts = dict.fromkeys(ops.KERNELS, 0)
    mm = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")

    def wrap(mod, attr, name_of):
        fn = getattr(mod, attr)

        def counted(*args, **kwargs):
            counts[name_of(*args)] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, attr, counted)

    wrap(mixed_precision, "scaled_int4_mm", lambda *a: "scaled_int4_mm")
    wrap(mm, "tile_scaled_mm", lambda a, *_: "tile_scaled_mm_s8" if a.dtype == torch.int8 else "tile_scaled_mm")
    for attr, name in (("quantize_int8_rowwise", "quantize_int8_rowwise"),
                       ("quantize_int8_colwise", "quantize_int8_colwise"), ("_quantize_both_kernel", "quantize_int8_both")):
        wrap(core, attr, lambda *a, _n=name: _n)
    monkeypatch.setattr(mm, "_BY_DIMS", {d: (lambda *a, _f=f, **k: counts.__setitem__(
        _f.__name__, counts[_f.__name__] + 1) or _f(*a, **k)) for d, f in mm._BY_DIMS.items()})
    return counts


def per_step(L: int, gemm: str | None, remat: bool = True) -> dict:
    """The launches of one int4 or fp8-tile train step of L layers, which
    chip_smoke.py holds the card to: 7 quantized weights a layer, each with
    one GEMM in the forward and two in the backward, and with remat 6 more
    in the replay (not down's: no backward reads the layer's output); no
    int8 kernel. fp8-row (``gemm`` None) launches no kernel of these."""
    counts = dict.fromkeys(ops.KERNELS, 0)
    if gemm is not None:
        counts[gemm] = (7 * 3 + (6 if remat else 0)) * L
    return counts


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_calls_per_step_int4(monkeypatch, remat):
    """One int4 train step launches B16 27 L times with remat (7 weights:
    forward, grad_input, grad_weight; 6 in the replay), 21 L without, and
    no int8 quantize or GEMM."""
    counts = count_gemms(monkeypatch)
    cfg = llama.LlamaConfig(**KW, remat=remat, attention_impl="xla")
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision",
                                   dtype="int4")
    rng = np.random.default_rng(2)
    tok, lab = (torch.from_numpy(rng.integers(0, KW["vocab_size"], (B, S))) for _ in range(2))
    loss, _ = train.loss_and_grads(cfg, params, tok, lab)
    assert np.isfinite(loss.item())
    assert counts == per_step(KW["num_hidden_layers"], "scaled_int4_mm", remat)


def test_device_tensor_takes_the_kernel(monkeypatch):
    """A non-CPU tensor (meta here) takes B16's launch path, never its plain
    version: the int4 linear's forward reaches B16's wrapper, which refuses
    a non-CUDA device."""
    monkeypatch.setattr(int4_mm, "scaled_int4_mm_plain", lambda *a, **k: pytest.fail("the plain version ran"))
    x = torch.empty(64, 128, device="meta")
    w = mixed_precision.MixedPrecisionWeight(torch.empty(128, 128, device="meta"),
                                             quant.MixedPrecisionConfig(dtype="int4"))
    with pytest.raises(ValueError, match="^scaled_int4_mm: all operands must be on one CUDA device"):
        quant.qlinear(x, w)
