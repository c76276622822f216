"""BitNet 1.58b in the port against the JAX package on the CPU: the linear
(quant/bitnet.py) forward and backward, the packed weight and its linear,
and the Llama with ``bitnet=True`` (its o and down norms), on the
ungrouped and the grouped pipeline, its loss and gradients.

Tolerances. The ternary weights are computed from a scale, the mean of |w|,
whose fp32 sum runs in another order in each framework (a few ulps apart,
tests/test_torch_storage_schemes.py::test_bitnet_core_vs_jax holds it and
the ternary weights given one scale). The linear's products are exact
integer sums times the same scales, so its forward is within 1e-5 of the
largest output in fp32 (the scale's ulps) and 2e-2 in bf16 (one or two
bf16 roundings of the output); its gradients likewise. The model's loss
and gradients go through norms, attention and casts that round
differently in the two frameworks, and BitNet re-ternarizes and
re-quantizes at every linear. The JAX loss and gradients against
themselves with the embedding moved one ulp (random sign, two draws) give
the floor: loss 2.1e-6 and worst leaf 5.4e-4 in fp32, 1.4e-4 and 3.9e-2 in
bf16; the bounds sit above it (loss 1e-3; leaf 1e-2 fp32, 1e-1 bf16).
Serving is held as tests/test_torch_serving.py holds bf16 (3e-2 of
max|logit|, argmax agreement 0.9), in fp32 too: a ternary product is a
small-integer multiple of one scale, so the int8 KV cache's quantize meets
exact ties, which a last-bit difference of its input decides either way
(each package against itself is deterministic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.models import llama_infer as jinfer
from quantized_training_tpu.quant import bitnet as jbitnet
from quantized_training_tpu_torch import quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama, llama_infer
from quantized_training_tpu_torch.quant import core
from quantized_training_tpu_torch.utils.tree import tree_leaves

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}
KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def _pair(x, dtn):
    jdt, tdt = _DT[dtn]
    jx = jnp.asarray(x, jdt)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


def _close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max() / np.abs(ref).max()


def _xw(seed, dtn, n=8, out=32, k=128):
    rng = np.random.default_rng(seed)
    return (*_pair(rng.standard_normal((n, k)), dtn), *_pair(rng.standard_normal((out, k)) * 0.05, dtn))


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_forward_matches_jax_and_the_formula(dtn):
    """TestBitNet.test_forward_matches_manual: the forward against JAX's and
    against ((x_i8 @ w_i8^T) * row_scale) * scale, the scale the fp32 mean
    of |w| (K1 at eps 1e-5, K2 with a scalar column scale)."""
    jx, tx, jw, tw = _xw(4, dtn)
    out = quant.qlinear(tx, quant.BitNetWeight(tw))
    assert out.dtype == tx.dtype and out.shape == (8, 32)
    _close(out, jquant.qlinear(jx, jquant.BitNetWeight(jw)), TOL[dtn])
    x_i8, row_scale = core.quantize_int8(tx, eps=1e-5)
    ts = core.get_bitnet_scale(tw)
    w_i8 = core.quantize_bitnet_weight(tw, ts)
    ref = (x_i8.float() @ w_i8.float().T) * row_scale.float() * ts.to(tw.dtype).float()
    _close(out, ref, TOL[dtn])


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_grads_match_jax_and_the_reference_formulas(dtn):
    """TestBitNet.test_grads_match_reference_formulas: grad_input (g @ w_i8)
    * scale and the weight's gradient g^T @ (x_i8 * row_scale), from the
    quantized activation, against jax.grad's and the formulas."""
    jx, tx, jw, tw = _xw(5, dtn)

    def jloss(x, bw):
        return (jquant.qlinear(x, bw).astype(jnp.float32) ** 2).sum()

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jx, jquant.BitNetWeight(jw))
    x, w = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    out = quant.qlinear(x, quant.BitNetWeight(w))
    gx, gw = torch.autograd.grad((out.float() ** 2).sum(), (x, w))
    assert gw.dtype == tw.dtype
    _close(gx, jgx, TOL[dtn])
    _close(gw, jgw.data, TOL[dtn])
    x_i8, row_scale = core.quantize_int8(tx, eps=1e-5)
    ts = core.get_bitnet_scale(tw)
    w_i8 = core.quantize_bitnet_weight(tw, ts)
    g = 2 * out.detach().float()
    _close(gx, (g @ w_i8.float()) * ts.to(tw.dtype).float(), TOL[dtn])
    _close(gw, g.T @ (x_i8.float() * row_scale.float()), TOL[dtn])


@pytest.mark.parametrize("shape", [(16, 64), (3, 32, 128)])
def test_packed_weight_roundtrip(shape):
    """TestBitNet.test_packed_weight_roundtrip: from_weight's packed bits
    equal JAX's, its scale (one a matrix, a layer's when stacked) within
    1e-6 of JAX's, and dequantize unpacks the ternary weights times it; a
    layer's slice is that layer's packed weight."""
    jw, tw = _pair(np.random.default_rng(6).standard_normal(shape) * 0.05, "f32")
    jp, tp = jbitnet.BitNetPackedWeight.from_weight(jw), quant.BitNetPackedWeight.from_weight(tw)
    assert tp.packed.shape == shape[:-1] + (shape[-1] // 4,) and tp.shape == shape
    np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))
    np.testing.assert_allclose(_np(tp.scale), _np(jp.scale), rtol=1e-6)
    ts = tw.abs().mean(dim=(-2, -1))
    ref = core.quantize_bitnet_weight(tw, ts[..., None, None]).float() * ts[..., None, None]
    torch.testing.assert_close(tp.dequantize(), ref, rtol=1e-6, atol=0)
    if len(shape) == 3:
        assert torch.equal(tp[1].dequantize(), tp.dequantize()[1])


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_packed_linear_matches_unpacked_and_jax(dtn):
    """TestBitNet.test_packed_linear_matches_unpacked: the packed linear
    gives the training linear's output bit for bit (same ternary weights,
    same scale in the weight's dtype), and JAX's packed linear within TOL;
    its grad_input as the training linear's."""
    jx, tx, jw, tw = _xw(7, dtn)
    x = tx.clone().requires_grad_(True)
    out_train = quant.qlinear(x, quant.BitNetWeight(tw))
    packed = quant.BitNetPackedWeight.from_weight(tw)
    x2 = tx.clone().requires_grad_(True)
    out_packed = quant.qlinear(x2, packed)
    assert torch.equal(out_train, out_packed)
    _close(out_packed, jquant.qlinear(jx, jbitnet.BitNetPackedWeight.from_weight(jw)), TOL[dtn])
    g = torch.randn(out_train.shape, generator=torch.Generator().manual_seed(0)).to(tx.dtype)
    assert torch.equal(torch.autograd.grad(out_train, x, g)[0], torch.autograd.grad(out_packed, x2, g)[0])


def _model(dtn):
    jcfg = jllama.LlamaConfig(**KW, bitnet=True, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, bitnet=True, attention_impl="xla")
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=_DT[dtn][0]), "bitnet")
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_bitnet_surgery_params():
    """test_model_train.py::test_bitnet_surgery_params: bitnet=True adds the
    o_norm [L, H] and down_norm [L, F] gains (ones), quantize_params wraps
    every linear of the body, and the forward is finite; the names and
    shapes are JAX's."""
    cfg = llama.LlamaConfig(**KW, bitnet=True)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    layers = params["layers"]
    assert layers["o_norm"]["g"].shape == (2, 256) and layers["down_norm"]["g"].shape == (2, 512)
    assert torch.equal(layers["o_norm"]["g"], torch.ones(2, 256, dtype=torch.bfloat16))
    qp = quant.quantize_params(params, "bitnet")
    assert all(isinstance(qp["layers"][k]["w"], quant.BitNetWeight) for k in ("q", "k", "v", "o", "gate", "up", "down"))
    tok = torch.randint(0, 512, (2, 32), generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(llama.forward(qp, tok, cfg).float()).all()
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**KW, bitnet=True))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in t.items()}
    assert shapes(params) == shapes(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("dtn,bounds", [("f32", (1e-3, 1e-2)), ("bf16", (1e-3, 1e-1))])
def test_bitnet_loss_and_grads_vs_jax(monkeypatch, grouped, dtn, bounds):
    """The loss and every gradient leaf (the BitNetWeights' data, the norms,
    the o and down norms included) of a 2-layer BitNet Llama with remat,
    against jax.value_and_grad of the JAX loss on the same weights and
    batch: the loss within bounds[0], each leaf's relative RMS within
    bounds[1]. ``grouped``: the port on the grouped pipeline
    (``QT_FUSED_ROPE=force``: RoPE with the head grouping, B13, and the
    attention output ungrouped before o_norm), the JAX model on its
    ungrouped one."""
    jcfg, cfg, jp, tp = _model(dtn)
    jcfg, cfg = dataclasses.replace(jcfg, remat=True), dataclasses.replace(cfg, remat=True)
    monkeypatch.setenv("QT_FUSED_ROPE", "force" if grouped else "0")
    rng = np.random.default_rng(3)
    tok, lab = rng.integers(0, 512, (2, 128)), rng.integers(0, 512, (2, 128))
    jl, jg = jax.value_and_grad(jllama.loss_fn)(jp, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), jcfg)
    tl, tg = train.loss_and_grads(cfg, tp, torch.from_numpy(tok), torch.from_numpy(lab))
    assert abs(tl.item() - float(jl)) <= bounds[0] * abs(float(jl))
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        assert np.linalg.norm(a - b) <= bounds[1] * np.linalg.norm(b)
    assert isinstance(tg["layers"]["down"]["w"], quant.BitNetWeight)


def test_generate_with_packed_bitnet_vs_jax():
    """test_inference.py::test_generate_with_bitnet_packed: every BitNetWeight
    packed for inference; the port's prefill logits (forward_with_cache
    with the o and down norms) within 3e-2 of JAX's max|logit| (fp32) with
    argmax agreement of 0.9 or more (KV ties, module docstring), and
    generate() extends the prompt with tokens of the vocabulary."""
    jcfg, cfg, jp, tp = _model("f32")

    def pack(leaf, Packed, Weight):
        return Packed.from_weight(leaf.data) if isinstance(leaf, Weight) else leaf

    jpacked = jax.tree.map(lambda l: pack(l, jbitnet.BitNetPackedWeight, jquant.BitNetWeight), jp,
                           is_leaf=jquant.is_quant_weight)
    tpacked = params_from_jax(jax.tree.map(np.asarray, jpacked))
    assert isinstance(tpacked["layers"]["q"]["w"], quant.BitNetPackedWeight)
    prompt = np.random.default_rng(4).integers(1, 512, (1, 12))
    ref, _ = jinfer.forward_with_cache(jpacked, jnp.asarray(prompt, jnp.int32), jinfer.KVCache.zeros(jcfg, 1, 16),
                                       0, jcfg)
    got = llama_infer.forward_with_cache(tpacked, torch.from_numpy(prompt), llama_infer.KVCache.zeros(cfg, 1, 16),
                                         0, cfg)
    _close(got, ref, 3e-2)
    assert (_np(got).argmax(-1) == _np(ref).argmax(-1)).mean() >= 0.9
    out = llama_infer.generate(tpacked, torch.from_numpy(prompt), cfg, 4)
    assert out.shape == (1, 16) and torch.equal(out[:, :12], torch.from_numpy(prompt))
    assert ((out >= 0) & (out < 512)).all()
