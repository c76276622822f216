"""The port's mixed-precision linear and quantize_params against the JAX
package's (quant/api.py, quant/mixed_precision.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.quant.mixed_precision import MixedPrecisionWeight as JMPW
from quantized_training_tpu_torch import parallel, quant
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

# q/o [128, 128] and the MLP [256, 128] pass the default filter; k/v
# [64, 128] (2 KV heads of 32) fall below 128 and the lm_head is excluded
KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)


def _jax_wrapped_paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JMPW))
    return {tuple(p.key for p in path) for path, leaf in leaves if isinstance(leaf, JMPW)}


def _port_wrapped_paths(tree, path=()):
    if isinstance(tree, dict):
        return set().union(*(_port_wrapped_paths(v, path + (k,)) for k, v in tree.items()))
    return {path} if isinstance(tree, MixedPrecisionWeight) else set()


def test_quantize_params_wraps_the_same_leaves():
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**KW))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jwrapped = _jax_wrapped_paths(jquant.quantize_params(jparams, "mixed_precision"))
    twrapped = _port_wrapped_paths(quant.quantize_params(tparams, "mixed_precision"))
    assert twrapped == jwrapped
    # the config exercises both sides of the filter
    assert ("layers", "q", "w") in twrapped and ("layers", "k", "w") not in twrapped
    assert ("lm_head", "w") not in twrapped and ("layers", "down", "w") in twrapped


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 128), (8, 256), (4, 275, 128)])
def test_qlinear_bit_exact_vs_jax(shape, dtype):
    """Tolerance: none. Both sides quantize x and w row-wise with the same
    numerics and run the exact int8 product with the same fp32 epilogue
    (at 1,100 tokens both pad to 1,280 and cut the output back)."""
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal(shape), jdt)
    w = jnp.asarray(rng.standard_normal((160, shape[-1])) * 0.02, jdt)
    cfg = jquant.MixedPrecisionConfig()
    ref = jquant.qlinear(x, JMPW(w, cfg))
    t = lambda a: params_from_jax(np.asarray(a))
    got = quant.qlinear(t(x), MixedPrecisionWeight(t(w), quant.MixedPrecisionConfig()))
    assert got.shape == tuple(ref.shape) and got.dtype == t(ref).dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    # a plain weight is a plain matmul; output=False keeps the matmul in float
    plain = quant.qlinear(t(x), t(w))
    off = quant.qlinear(t(x), MixedPrecisionWeight(t(w), quant.MixedPrecisionConfig(output=False)))
    assert torch.equal(plain, off)


def test_unported_schemes_raise():
    """Every scheme of the JAX package is ported: the storage schemes wrap
    the weight, and their unknown kwargs raise. A BitNet weight whose mesh
    has no fsdp split takes the one-device linear, bit for bit (the 2-bit
    all-gather runs on gloo ranks in tests/test_torch_parallel_ranks.py).
    An unknown mixed-precision dtype or scheme raises as in the JAX package
    (int4 and fp8 are ported)."""
    w = MixedPrecisionWeight(torch.zeros(128, 128), quant.MixedPrecisionConfig(dtype="int2"))
    with pytest.raises(ValueError, match="int2"):
        quant.qlinear(torch.zeros(2, 128), w)
    wrappers = {"int8_quantized_training": quant.Int8Weight, "int4_weight_only": quant.Int4Weight,
                "bitnet": quant.BitNetWeight}
    for scheme, wrapper in wrappers.items():
        assert isinstance(quant.quantize_params({"w": torch.zeros(128, 128)}, scheme)["w"], wrapper)
        with pytest.raises(TypeError):
            quant.quantize_params({"w": torch.zeros(128, 128)}, scheme, nope=1)
    x, w = torch.randn(2, 128, generator=torch.Generator().manual_seed(0)), torch.randn(128, 128) * 0.02
    one_rank = parallel.make_mesh({"fsdp": 1})
    assert torch.equal(quant.qlinear(x, quant.BitNetWeight(w, mesh=one_rank)), quant.qlinear(x, quant.BitNetWeight(w)))
    with pytest.raises(ValueError, match="unknown"):
        quant.quantize_params({"w": torch.zeros(128, 128)}, "nope")
    assert quant.quantize_params({"a": 1}, None) == {"a": 1}


def test_stacked_weight_indexing():
    """Indexing a stacked [L, out, in] wrapper gives the wrapped layer."""
    w = MixedPrecisionWeight(torch.arange(24.0).reshape(2, 3, 4), quant.MixedPrecisionConfig())
    lp = llama.layer_params({"q": {"w": w}, "n": {"g": torch.ones(2, 4)}}, 1)
    assert isinstance(lp["q"]["w"], MixedPrecisionWeight)
    assert torch.equal(lp["q"]["w"].data, w.data[1]) and lp["q"]["w"].config == w.config
    assert lp["n"]["g"].shape == (4,)


def test_linear_shared_fallback_shares_the_key(monkeypatch):
    """linear_shared on a config that is not all-int8 (here int8 with a
    bf16 grad_weight, under SR) takes one linear per weight, each with the
    caller's key, as the JAX package does (mixed_precision.py:293-296): the
    shared input's int8 operand is the same for q, k and v, and so is its
    draw."""
    from quantized_training_tpu_torch.quant import mixed_precision

    seen = []
    quantize = mixed_precision.quantize_int8

    def record(x, **kw):
        out = quantize(x, **kw)
        seen.append((x.shape, out[0]))
        return out

    monkeypatch.setattr(mixed_precision, "quantize_int8", record)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    cfg = quant.MixedPrecisionConfig(grad_weight=False, stochastic_rounding=True)
    ws = [MixedPrecisionWeight(torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)), cfg)
          for _ in range(3)]
    outs = quant.qlinear_multi(x, ws, key=5)
    assert len(outs) == 3 and len(seen) == 6  # per weight: x's row quantize, then w's
    xs = [q for shape, q in seen[0::2]]
    assert all(shape == x.shape for shape, q in seen[0::2])
    assert all(torch.equal(q, xs[0]) for q in xs[1:])
    # SR moves some of x's values off round-to-nearest, the same ones for all
    assert not torch.equal(xs[0], quantize(x, axis=1)[0])
    # each output is the plain linear of its weight under that key
    for w, out in zip(ws, outs):
        assert torch.equal(out, quant.qlinear(x, w, key=5))


def test_linear_pads_tokens_as_jax(monkeypatch):
    """From 1024 tokens on, linear and linear_shared hand their autograd
    Function the tokens padded with zero rows to a multiple of 256, as the
    JAX package does (its grad_weight GEMM on the card contracts over the
    tokens and needs a multiple of 16: ViT-Giant's 6,168 are not); the
    output and the gradients equal the unpadded computation's bit for bit,
    since a zero row changes no scale and no sum. Below 1024 tokens nothing
    is padded."""
    from quantized_training_tpu_torch.quant import mixed_precision as mp

    rows = []
    for cls in (mp._MPLinear, mp._MPLinearShared):
        def counted(*args, _apply=cls.apply):
            rows.append(next(a.shape[0] for a in args if isinstance(a, torch.Tensor)))
            return _apply(*args)
        monkeypatch.setattr(cls, "apply", counted)
    rng = np.random.default_rng(1)
    cfg = quant.MixedPrecisionConfig()
    w = torch.from_numpy((rng.standard_normal((160, 128)) * 0.05).astype(np.float32)).requires_grad_(True)
    for M, padded in ((1100, 1280), (1000, 1000)):
        x = torch.from_numpy(rng.standard_normal((M, 128)).astype(np.float32)).requires_grad_(True)
        out = quant.qlinear(x, MixedPrecisionWeight(w, cfg), key=3)
        gx, gw = torch.autograd.grad((out ** 2).sum(), (x, w))
        ref = mp._MPLinear.apply(x, w, cfg, 3)  # unpadded
        rx, rw = torch.autograd.grad((ref ** 2).sum(), (x, w))
        assert rows[-2:] == [padded, M] and out.shape == (M, 160)
        assert torch.equal(out, ref) and torch.equal(gx, rx) and torch.equal(gw, rw)
        shared = quant.qlinear_multi(x, [MixedPrecisionWeight(w, cfg)] * 2, key=3)
        assert rows[-1] == padded and shared[0].shape == (M, 160)
        assert torch.equal(shared[0], mp._MPLinearShared.apply(cfg, 3, x, w, w)[0])
