"""The storage-quantized schemes of the port against the JAX package's on
the CPU: int8 weight storage (quant/int8.py), int4 weight-only
(quant/int4.py) and their numerics in quant/core.py, the training contract
of quant/api.py with its stochastic-rounding commit, the tree order of the
wrappers (utils/tree.py) and params_from_jax. BitNet is
tests/test_torch_bitnet.py, the train step and serving
tests/test_torch_storage_train.py.

Tolerances: none for int8 and int4 storage (values, scales, zero points)
and int4's dequantization, in fp32 and bf16 (the same IEEE operations in
the same order; int4's bf16 dequantization rounds after each operation in
both frameworks). The forwards and the gradients go through matmuls whose
sums run in another order in each framework: fp32 within 1e-5 of the
largest magnitude (sum order only), bf16 within 2e-2 (one or two bf16
roundings of the output); an int8 activation quantize turns a sum-order
difference of its input into a rounding flip only where a value sits at a
tie, which fp32 inputs from a seed do not hit. The commit draws from
another generator than JAX's (Philox, ``ops/random.py``, where JAX draws
Threefry), so it is held statistically: each stored value is one of the two
grid points around master / scale, and over 64 keys the mean of the
dequantized values is within 6 standard errors of the master at each
element, and their mean error within 4 (``_unbiased``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.quant import core as jcore
from quantized_training_tpu_torch import quant
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.ops import random
from quantized_training_tpu_torch.quant import api, core
from quantized_training_tpu_torch.quant import int8 as int8_mod
from quantized_training_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# relative to the output's largest magnitude: sum order only (fp32), one or
# two bf16 roundings (bf16)
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _pair(x, dtn):
    """The same values as a JAX array and a torch tensor of the dtype."""
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


def _loss(out):
    return (out.astype(jnp.float32) ** 2).sum() if hasattr(out, "astype") else (out.float() ** 2).sum()


def _unbiased(draws, exact, step):
    """SR draws [n, ...] of ``exact`` on a grid of ``step`` (broadcast):
    each element's mean within 6 standard errors (a draw's deviation is at
    most step / 2), and the mean error over all elements, in steps, within
    4 of its standard errors."""
    n = draws.shape[0]
    err = (draws.mean(0) - exact) / step
    assert (err.abs() <= 6 * 0.5 / n**0.5 + 1e-4).all(), err.abs().max()
    assert err.mean().abs() <= 4 * 0.5 / (n * err.numel()) ** 0.5, err.mean()


# ---- quant/core.py -------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 64), (4, 16, 64), (256, 512)])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_int4_groupwise_same_bits_as_jax(shape, dtn):
    """quantize_int4_groupwise's packed values, scales and zero points, and
    dequantize_int4_groupwise's values, bit for bit (TestInt4Groupwise's
    shapes and a stacked one)."""
    jx, tx = _pair(np.random.default_rng(0).standard_normal(shape) * 0.1, dtn)
    jout = jcore.quantize_int4_groupwise(jx, 32)
    tout = core.quantize_int4_groupwise(tx, 32)
    assert tout[0].dtype == torch.uint8 and tout[0].shape == (np.prod(shape) // 32, 16)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(_np(a), _np(b))
    jd = jcore.dequantize_int4_groupwise(*jout, shape)
    td = core.dequantize_int4_groupwise(*tout, shape)
    assert td.dtype == tx.dtype
    np.testing.assert_array_equal(_np(td), _np(jd))
    # TestInt4Groupwise.test_roundtrip: within half a step of each group
    err = (td.float() - tx.float()).abs().reshape(-1, 32)
    assert (err <= tout[1].float()[:, None] / 2 + 1e-2 * (dtn == "bf16") + 1e-6).all()


def test_int4_extremes_hit_grid_ends():
    """TestInt4Groupwise.test_extremes_hit_grid_ends: 0..31 spans the grid."""
    packed, scale, zp = core.quantize_int4_groupwise(torch.arange(32.0)[None], group_size=32)
    u4 = torch.stack([packed >> 4, packed & 0xF], -1).reshape(-1)
    assert u4.min() == 0 and u4.max() == 15
    assert zp.item() == 0.0 and scale.item() == np.float32(31.0) / np.float32(15.0)


def test_int4_sr_neighbours_and_mean():
    """The SR quantize: every value on one of the two grid points around
    (x - zp) / scale, the same bits from one key, and unbiased over 64
    keys (``_unbiased``). A missing key raises."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32))
    packed, scale, zp = core.quantize_int4_groupwise(x, 32)
    q_exact = (x.reshape(-1, 32) - zp[:, None]) / scale[:, None]
    deqs = []
    for k in range(64):
        p, s, z = core.quantize_int4_groupwise(x, 32, stochastic_rounding=True, key=k)
        assert torch.equal(s, scale) and torch.equal(z, zp)
        u4 = torch.stack([p >> 4, p & 0xF], -1).reshape(-1, 32).float()
        assert ((u4 == q_exact.floor()) | (u4 == q_exact.ceil())).all()
        deqs.append(core.dequantize_int4_groupwise(p, s, z, x.shape))
    again = core.quantize_int4_groupwise(x, 32, stochastic_rounding=True, key=63)[0]
    assert torch.equal(again, p)
    _unbiased(torch.stack(deqs), x, scale.repeat_interleave(32).reshape(x.shape))
    with pytest.raises(ValueError, match="key"):
        core.quantize_int4_groupwise(x, 32, stochastic_rounding=True)


@pytest.mark.parametrize("shape", [(16, 64), (256, 512), (3, 128, 256)])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_bitnet_core_vs_jax(shape, dtn):
    """get_bitnet_scale within 1e-6 relative of JAX's (its sum runs in
    another order: a few fp32 ulps), and quantize_bitnet_weight given JAX's
    scale equal to JAX's ternary weights; the 2-bit pack of those weights
    bit for bit, and the unpack its inverse."""
    jw, tw = _pair(np.random.default_rng(2).standard_normal(shape) * 0.05, dtn)
    js, ts = jcore.get_bitnet_scale(jw), core.get_bitnet_scale(tw)
    assert ts.dtype == torch.float32 and abs(ts.item() - float(js)) <= 1e-6 * float(js)
    jq = jcore.quantize_bitnet_weight(jw, js)
    tq = core.quantize_bitnet_weight(tw, torch.tensor(float(js)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    tp = core.pack_i2_in_i8(tq)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jcore.pack_i2_in_i8(jq)))
    assert torch.equal(core.unpack_i2_in_i8(tp), tq)


def test_bitnet_ternary_and_pack_examples():
    """TestBitNet's known answers (tests/test_quant_core.py:95-114)."""
    w = torch.tensor([[0.5, -0.5, 0.05, 2.0]])
    scale = core.get_bitnet_scale(w)
    assert abs(scale.item() - (0.5 + 0.5 + 0.05 + 2.0) / 4) < 1e-7
    assert core.quantize_bitnet_weight(w, scale).tolist() == [[1, -1, 0, 1]]
    x = torch.tensor([[-1, 0, 1, -1, 1, 1, 0, 0]], dtype=torch.int8)
    assert core.pack_i2_in_i8(x).shape == (1, 2)
    assert torch.equal(core.unpack_i2_in_i8(core.pack_i2_in_i8(x)), x)


# ---- Int8Weight -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 64), (3, 128, 256)])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_int8_weight_storage_same_bits_as_jax(shape, dtn):
    """Int8Weight.from_float: int_data and the row scale bit for bit, a
    stacked weight too; the dequantized weight equal."""
    jw, tw = _pair(np.random.default_rng(3).standard_normal(shape) * 0.1, dtn)
    jq, tq = jquant.Int8Weight.from_float(jw), quant.Int8Weight.from_float(tw)
    np.testing.assert_array_equal(tq.int_data.numpy(), np.asarray(jq.int_data))
    np.testing.assert_array_equal(_np(tq.scale), _np(jq.scale))
    assert tq.scale.dtype == tw.dtype and tq.master is None and tq.shape == shape
    np.testing.assert_array_equal(_np(tq.dequantize()), _np(jq.dequantize()))


def _int8_setup(activation, dtn):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((16, 128)), dtn)
    jw, tw = _pair(rng.standard_normal((64, 128)) * 0.1, dtn)
    jq = jquant.Int8Weight.from_float(jw, jquant.Int8QTConfig(activation))
    return jx, tx, jq, quant.Int8Weight.from_float(tw, quant.Int8QTConfig(activation))


@pytest.mark.parametrize("activation", ["none", "int8"])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_int8_linear_forward_vs_jax(activation, dtn):
    """The weight-only ('none') and dynamic int8 ('int8') forwards against
    JAX's on the same storage, within TOL; the int8 form also within 2e-2
    of the dequantized weight's product (TestInt8QT)."""
    jx, tx, jq, tq = _int8_setup(activation, dtn)
    out = quant.qlinear(tx, tq)
    assert out.dtype == tx.dtype and out.shape == (16, 64)
    _close(out, jquant.qlinear(jx, jq), TOL[dtn])
    ref = tx.float() @ tq.dequantize().float().T
    rel = (out.float() - ref).abs().mean() / ref.abs().mean()
    assert rel < (2e-2 if activation == "int8" else TOL[dtn])


@pytest.mark.parametrize("activation", ["none", "int8"])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_int8_grads_route_to_master(activation, dtn):
    """The gradients of x and of the attached master against jax.grad's
    (TestInt8QT.test_grads_route_to_master): grad_input (g * scale^T) @
    int_data, grad_master g^T @ x; the storage gets none."""
    jx, tx, jq, tq = _int8_setup(activation, dtn)
    jmaster = jq.dequantize()

    def jloss(x, master):
        return _loss(jquant.qlinear(x, dataclasses.replace(jq, master=master)))

    jgx, jgm = jax.grad(jloss, argnums=(0, 1))(jx, jmaster)
    x = tx.clone().requires_grad_(True)
    master = tq.dequantize().requires_grad_(True)
    gx, gm = torch.autograd.grad(_loss(quant.qlinear(x, dataclasses.replace(tq, master=master))), (x, master))
    assert gm.dtype == master.dtype
    _close(gx, jgx, TOL[dtn])
    _close(gm, jgm, TOL[dtn])


def test_int8_sr_activation_needs_a_key():
    """activation='int8_sr' without a key raises (int8.py:108-112); with one
    the forward is a pure function of it."""
    _, tx, _, tq = _int8_setup("int8_sr", "f32")
    with pytest.raises(ValueError, match="int8_sr"):
        quant.qlinear(tx, tq)
    assert torch.equal(quant.qlinear(tx, tq, key=3), quant.qlinear(tx, tq, key=3))


@pytest.mark.parametrize("activation", ["none", "int8"])
def test_forward_without_master_dequantizes_nothing(monkeypatch, activation):
    """A forward of an Int8Weight with no master attached, or under
    torch.no_grad(), runs no dequantize (in eager serving one a call would
    widen every weight at every decode step); the master gets its gradient
    where one is attached."""
    _, tx, _, tq = _int8_setup(activation, "bf16")

    def refuse(*a, **k):
        raise AssertionError("dequantize ran")

    monkeypatch.setattr(quant.Int8Weight, "dequantize", refuse)
    monkeypatch.setattr(int8_mod, "dequantize_int8", refuse)
    monkeypatch.setattr(core, "dequantize_int8", refuse)
    with torch.no_grad():
        quant.qlinear(tx, tq)
    x = tx.clone().requires_grad_(True)
    quant.qlinear(x, tq).float().sum().backward()
    assert x.grad is not None


# ---- Int4Weight -----------------------------------------------------------


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_int4_forward_and_grads_vs_jax(dtn):
    """TestInt4WO.test_forward_and_grads: the dequantized weight's product
    forward, grad_input g @ w and grad_master g^T @ x, against JAX's."""
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.standard_normal((8, 128)), dtn)
    jw, tw = _pair(rng.standard_normal((32, 128)), dtn)
    jq, tq = jquant.Int4Weight.from_float(jw, group_size=32), quant.Int4Weight.from_float(tw, group_size=32)
    assert tq.shape == (32, 128) and tq.mat_shape == (32, 128)
    for a, b in zip((tq.packed, tq.scale, tq.zero_point), (jq.packed, jq.scale, jq.zero_point)):
        np.testing.assert_array_equal(_np(a), _np(b))
    _close(quant.qlinear(tx, tq), jquant.qlinear(jx, jq), TOL[dtn])

    def jloss(x, master):
        return _loss(jquant.qlinear(x, dataclasses.replace(jq, master=master)))

    jgx, jgm = jax.grad(jloss, argnums=(0, 1))(jx, jq.dequantize())
    x = tx.clone().requires_grad_(True)
    master = tq.dequantize().requires_grad_(True)
    gx, gm = torch.autograd.grad(_loss(quant.qlinear(x, dataclasses.replace(tq, master=master))), (x, master))
    _close(gx, jgx, TOL[dtn])
    _close(gm, jgm, TOL[dtn])


def test_int4_stacked_layer_dims():
    """TestInt4WO.test_stacked_layer_dims: the storage keeps the leading
    layer axis, a layer's slice is that layer's weight, and the round trip
    stays within half a step."""
    w = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 16, 64)).astype(np.float32))
    qw = quant.Int4Weight.from_float(w, group_size=32)
    assert qw.packed.shape == (4, 32, 16) and qw.scale.shape == (4, 32)
    deq = qw.dequantize()
    assert deq.shape == (4, 16, 64)
    assert (deq - w).abs().max() < qw.scale.max() / 2 + 1e-6
    assert torch.equal(qw[2].dequantize(), deq[2])
    layers = qw.unbind_layers()
    assert len(layers) == 4 and torch.equal(layers[1].dequantize(), deq[1]) and layers[1].mat_shape == (16, 64)


# ---- quantize_params and the training contract -------------------------------


def _params(lib=torch):
    """TestParamsAPI's tree: linear dims >= 128 (the default filter skips
    smaller ones), a stacked q, a norm and an embedding."""
    rng = np.random.default_rng(8)
    p = {"embed": {"embedding": rng.standard_normal((100, 128))},
         "layers": {"q": {"w": rng.standard_normal((2, 128, 128)) * 0.1}, "norm": {"g": np.ones((2, 128))},
                    "up": {"w": rng.standard_normal((2, 256, 128)) * 0.1}}}
    to = (lambda a: torch.from_numpy(a.astype(np.float32))) if lib is torch else (lambda a: jnp.asarray(a, jnp.float32))
    return jax.tree.map(to, p)


@pytest.mark.parametrize("scheme,wrapper", [
    ("mixed_precision", quant.MixedPrecisionWeight), ("int8_quantized_training", quant.Int8Weight),
    ("int4_weight_only", quant.Int4Weight), ("bitnet", quant.BitNetWeight)])
def test_quantize_params_wraps_only_linear_w(scheme, wrapper):
    """TestParamsAPI.test_quantize_params_wraps_only_linear_w, and the
    lm_head stays plain under the default filter."""
    p = _params()
    p["lm_head"] = {"w": torch.zeros(256, 128)}
    qp = quant.quantize_params(p, scheme)
    assert isinstance(qp["layers"]["q"]["w"], wrapper)
    for leaf in (qp["embed"]["embedding"], qp["layers"]["norm"]["g"], qp["lm_head"]["w"]):
        assert not quant.is_quant_weight(leaf)


@pytest.mark.parametrize("scheme", ["int8_quantized_training", "int4_weight_only"])
def test_master_cycle(scheme):
    """TestParamsAPI.test_master_cycle_int8, for both storage schemes:
    virtual_params dequantizes (the masters are the weights' dtype, plain
    tensors), merge_masters attaches them, commit_params re-quantizes with
    SR within one grid step of the master and leaves plain leaves as they
    are; a missing key raises."""
    qp = quant.quantize_params(_params(), scheme)
    vp = quant.virtual_params(qp)
    master = vp["layers"]["q"]["w"]
    assert isinstance(master, torch.Tensor) and master.dtype == torch.float32
    assert torch.equal(master, qp["layers"]["q"]["w"].dequantize())
    merged = quant.merge_masters(vp, qp)
    assert merged["layers"]["q"]["w"].master is master and merged["embed"]["embedding"] is vp["embed"]["embedding"]
    new_qp = quant.commit_params(vp, qp, 0)
    assert type(new_qp["layers"]["q"]["w"]) is type(qp["layers"]["q"]["w"])
    assert new_qp["layers"]["q"]["w"].master is None
    assert new_qp["embed"]["embedding"] is vp["embed"]["embedding"]
    step = qp["layers"]["q"]["w"].scale.max()
    assert (quant.virtual_params(new_qp)["layers"]["q"]["w"] - master).abs().max() <= step + 1e-6
    with pytest.raises(ValueError, match="key"):
        quant.commit_params(vp, qp)


def test_master_cycle_preserves_plain_leaves_and_bitnet():
    """Mixed precision and BitNet pass through the contract: the wrappers
    stay, their tensors are the same objects."""
    for scheme in ("mixed_precision", "bitnet"):
        qp = quant.quantize_params(_params(), scheme)
        vp = quant.virtual_params(qp)
        new_qp = quant.commit_params(quant.merge_masters(vp, qp), qp, 0)
        assert new_qp["layers"]["q"]["w"] is qp["layers"]["q"]["w"]
        assert new_qp["embed"]["embedding"] is qp["embed"]["embedding"]


def test_commit_keys_follow_the_jax_leaf_order():
    """commit_params re-quantizes leaf i with fold_in(key, i), i its index in
    JAX's flatten with each wrapper one leaf (dict keys sorted): embed 0,
    layers/norm 1, layers/q 2, layers/up 3."""
    qp = quant.quantize_params(_params(), "int8_quantized_training")
    jp = jquant.quantize_params(_params(jnp), "int8_quantized_training")
    paths = [tuple(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(
        jp, is_leaf=jquant.is_quant_weight)[0]]
    assert paths == list(api._leaf_paths(qp))
    vp = quant.virtual_params(qp)
    new = quant.commit_params(vp, qp, 7)
    for i, name in ((2, "q"), (3, "up")):
        q, s = core.quantize_int8(vp["layers"][name]["w"], stochastic_rounding=True, key=random.fold_in(7, i))
        assert torch.equal(new["layers"][name]["w"].int_data, q) and torch.equal(new["layers"][name]["w"].scale, s)


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_sr_commit_neighbours_and_mean(dtn):
    """The int8 commit of a stacked [L, O, I] master: every stored value one
    of the two grid points around master / scale (the scale the row absmax
    / 127 in fp32, as RN's, stored in the master's dtype), the same bits for
    one key, and over 64 keys the values times the fp32 scale unbiased
    (``_unbiased``)."""
    _, master = _pair(np.random.default_rng(9).standard_normal((2, 128, 256)) * 0.05, dtn)
    qp = {"w": quant.Int8Weight.from_float(master)}
    scale = master.abs().amax(-1, keepdim=True).float() / torch.tensor(127.0)
    exact = master.float() / scale
    deqs = []
    for k in range(64):
        w = quant.commit_params({"w": master}, qp, k)["w"]
        assert w.int_data.dtype == torch.int8 and torch.equal(w.scale, qp["w"].scale)
        v = w.int_data.float()
        assert ((v == exact.floor()) | (v == exact.ceil())).all()
        deqs.append(w.int_data.float() * scale)
    assert torch.equal(quant.commit_params({"w": master}, qp, 63)["w"].int_data, w.int_data)
    _unbiased(torch.stack(deqs), master.float(), scale)


# ---- utils/tree.py and convert.py -------------------------------------------


def _jax_storage_tree():
    rng = np.random.default_rng(10)
    w = lambda *s: jnp.asarray(rng.standard_normal(s) * 0.05, jnp.bfloat16)
    return {
        "b": {"w": jquant.Int8Weight.from_float(w(2, 128, 128), jquant.Int8QTConfig("int8"))},
        "a": {"w": jquant.Int4Weight.from_float(w(2, 128, 128))},
        "c": {"w": jquant.BitNetWeight(w(128, 128))},
        "d": {"w": jquant.BitNetPackedWeight.from_weight(w(2, 128, 128))},
        "e": {"w": jquant.MixedPrecisionWeight(w(128, 128), jquant.MixedPrecisionConfig(dtype="int4"))},
        "n": {"g": w(128)},
        "m": {"w": dataclasses.replace(jquant.Int8Weight.from_float(w(128, 128)), master=w(128, 128))},
    }


def test_params_from_jax_carries_every_wrapper():
    """A JAX tree of every wrapper (an Int8Weight with a master too) through
    params_from_jax: the same wrapper types, configs and meta fields, every
    tensor field for field, bit for bit, in its dtype."""
    jt = _jax_storage_tree()
    tt = params_from_jax(jax.tree.map(np.asarray, jt))
    for name, jw in jt.items():
        tw = tt[name]["w" if "w" in tt[name] else "g"]
        jw = jw["w" if "w" in jw else "g"]
        if not jquant.is_quant_weight(jw):
            np.testing.assert_array_equal(_np(tw), _np(jw))
            continue
        assert type(tw).__name__ == type(jw).__name__
        jfields = {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)}
        for f in dataclasses.fields(tw):
            a, b = getattr(tw, f.name), jfields[f.name]
            if isinstance(a, torch.Tensor):
                assert a.dtype == {"bfloat16": torch.bfloat16}.get(str(b.dtype), a.dtype)
                np.testing.assert_array_equal(_np(a), _np(b))
            elif dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b or (a is None and b is None), f.name


def test_tree_flatten_visits_leaves_in_jax_order():
    """tree_flatten of the converted tree visits the same leaves as
    jax.tree.leaves of the JAX tree, in the same order (dict keys sorted,
    each wrapper's data_fields, a master of None no leaf), and
    tree_unflatten rebuilds it."""
    jt = _jax_storage_tree()
    tt = params_from_jax(jax.tree.map(np.asarray, jt))
    tleaves, treedef = tree_flatten(tt)
    jleaves = jax.tree.leaves(jt)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(_np(a), _np(b))
    back = tree_unflatten(treedef, tleaves)
    assert back["b"]["w"].master is None and back["m"]["w"].master is tt["m"]["w"].master
    assert back["a"]["w"].mat_shape == (128, 128) and back["b"]["w"].config == tt["b"]["w"].config
    assert len(tree_leaves(quant.virtual_params(tt))) == len(jax.tree.leaves(jquant.virtual_params(jt)))
