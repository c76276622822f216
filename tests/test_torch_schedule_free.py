"""Schedule-free AdamW and the 8-bit optimizer state of the port against the
JAX package's on the CPU, from the same parameters and gradients (numpy
seeds). Mirrors the schedule-free and state8bit cases of
``tests/test_model_train.py::TestOptim``.

- ``OptimState8bit``: the codebooks, the codes and scales of a requantize
  and the dequantized values are the JAX package's bit for bit, ties
  between two codebook entries included.
- ``schedule_free_adamw``, fp32 and 8-bit, five steps: the count is equal,
  ``lr_max`` and ``weight_sum`` within one fp32 ulp a step (measured: equal),
  the 8-bit codes and scales equal, and every parameter and ``z`` within
  one fp32 ulp a step of its leaf's scale (its largest magnitude before or
  after the step).
- One step from the JAX package's state (carried across before each step),
  element by element: within two ulps of the element's own scale (the
  largest of its parameter, z and their changes, before and after). XLA's
  vectorized CPU square root is not correctly rounded (40 of 8,192 random
  fp32 values differ from the IEEE square root by one ulp), and a single ulp
  of ``sqrt(exp_avg_sq)`` moves the product ``eff_lr * g / denom`` by up to
  two. Measured over these cases: 2. Carried over five steps the element
  bound does not hold as a sum (an element that has shrunk keeps the error
  of its larger past: 8 ulps of its new scale at the third step of
  ``r_power``); the leaf bound does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu.optim import state8bit as jstate8bit
from quantized_training_tpu.quant.configs import MixedPrecisionConfig as JMPConfig
from quantized_training_tpu.quant.mixed_precision import MixedPrecisionWeight as JMPWeight
from quantized_training_tpu_torch import optim
from quantized_training_tpu_torch.convert import params_from_jax, schedule_free_state_from_jax
from quantized_training_tpu_torch.optim import state8bit
from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight
from quantized_training_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

SHAPES = {"w": (64, 128), "b": (16,), "u": (32, 256), "odd": (4097,)}


def _params(seed=0):
    """fp32 numpy parameters; 'm' a mixed-precision wrapper (a node whose
    8-bit state sits inside it)."""
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    p["m"] = rng.standard_normal((128, 64)).astype(np.float32)
    return p


def _jax_tree(p):
    t = {k: jnp.asarray(v) for k, v in p.items() if k != "m"}
    t["m"] = JMPWeight(jnp.asarray(p["m"]), JMPConfig())
    return t


def _grads(rng, p):
    return {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32) for k, v in p.items()}


def _ulps(got, ref, scale):
    return float(np.max(np.abs(got - ref) / np.spacing(scale)))


def _np(tree):
    """The leaves by name: numpy arrays of a JAX or port tree."""
    out = {}
    for k, v in tree.items():
        v = v.data if isinstance(v, (JMPWeight, MixedPrecisionWeight)) else v
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _prev(jp, js):
    """Each leaf's parameter and z before a step, by name."""
    p, z = _np(jp), _np(js.z)
    return {n: (p[n], z[n]) for n in p}


def _compare(jp, js, tp, ts, prev, k, carried=False):
    """k steps taken (one from the JAX state where ``carried``): the bounds
    of the module docstring."""
    assert int(np.asarray(js.count)) == ts.count.item() and ts.count.dtype == torch.int32
    for name in ("lr_max", "weight_sum"):
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert _ulps(b, a, np.abs(a)) <= k, name
    jpn, tpn, jzn, tzn = _np(jp), _np(tp), _np(js.z), _np(ts.z)
    worst = 0.0
    for name in jpn:
        pp, zz = prev[name]
        leaf_scale = max(np.abs(x).max() for x in (jpn[name], jzn[name], pp, zz))
        elem_scale = np.maximum.reduce([np.abs(jpn[name]), np.abs(jzn[name]), np.abs(pp), np.abs(zz),
                                        np.abs(jpn[name] - pp), np.abs(jzn[name] - zz)])
        for got, ref in ((tpn[name], jpn[name]), (tzn[name], jzn[name])):
            assert _ulps(got, ref, np.float32(leaf_scale)) <= k, name
            worst = max(worst, _ulps(got, ref, elem_scale))
    assert worst <= 2 or not carried
    # exp_avg_sq takes no square root: fp32 values, 8-bit codes and scales
    # are the JAX package's bit for bit
    jl, tl = jax.tree.leaves(js.exp_avg_sq), tree_leaves(ts.exp_avg_sq)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())


CASES = [dict(), dict(warmup_steps=3, weight_decay=0.01), dict(r=0.5, weight_lr_power=1.0, betas=(0.95, 0.99))]


@pytest.mark.parametrize("kw", CASES, ids=["default", "warmup_wd", "r_power"])
@pytest.mark.parametrize("state_8bit", [False, True])
def test_schedule_free_steps_vs_jax(state_8bit, kw):
    """Five steps from the same parameters and gradients, the first at lr 0
    (a warmup's step 0), within the bounds of the module docstring: the
    port's own chain, and each step again from the JAX state."""
    p0 = _params()
    jopt = joptim.schedule_free_adamw(state_8bit=state_8bit, **kw)
    topt = optim.schedule_free_adamw(state_8bit=state_8bit, **kw)
    jp, tp = _jax_tree(p0), params_from_jax(_jax_tree(p0))
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(1)
    for k in range(1, 6):
        prev = _prev(jp, js)
        g = _grads(rng, p0)
        lr = 0.0 if k == 1 else 1e-2
        carried = (params_from_jax(jax.tree.map(np.asarray, jp)),
                   schedule_free_state_from_jax(jax.tree.map(np.asarray, js)))
        cp, cs = topt.step(params_from_jax(_jax_tree(g)), carried[1], carried[0], lr)
        jp, js = jopt.step(_jax_tree(g), js, jp, lr)
        tp, ts = topt.step(params_from_jax(_jax_tree(g)), ts, tp, lr)
        _compare(jp, js, tp, ts, prev, k)
        _compare(jp, js, cp, cs, prev, 1, carried=True)
    assert isinstance(tp["m"], MixedPrecisionWeight)


@pytest.mark.parametrize("state_8bit", [False, True])
def test_schedule_free_continues_from_a_jax_state(state_8bit):
    """The JAX state after three steps, carried across
    (``schedule_free_state_from_jax``), steps on as the JAX package does."""
    p0 = _params(2)
    jopt = joptim.schedule_free_adamw(state_8bit=state_8bit, warmup_steps=2)
    topt = optim.schedule_free_adamw(state_8bit=state_8bit, warmup_steps=2)
    jp = _jax_tree(p0)
    js = jopt.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        jp, js = jopt.step(_jax_tree(_grads(rng, p0)), js, jp, 5e-3)
    ts = schedule_free_state_from_jax(jax.tree.map(np.asarray, js))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    if state_8bit:
        assert isinstance(ts.exp_avg_sq["w"], optim.OptimState8bit)
        assert isinstance(ts.exp_avg_sq["m"].data, optim.OptimState8bit)
    for k in range(1, 3):
        prev = _prev(jp, js)
        g = _grads(rng, p0)
        jp, js = jopt.step(_jax_tree(g), js, jp, 5e-3)
        tp, ts = topt.step(params_from_jax(_jax_tree(g)), ts, tp, 5e-3)
        _compare(jp, js, tp, ts, prev, k, carried=k == 1)


def test_codebooks_match_jax():
    for signed in (False, True):
        ours = state8bit.codebook(signed, "cpu").numpy()
        theirs = np.asarray(jstate8bit._CODEBOOK_SIGNED if signed else jstate8bit._CODEBOOK_UNSIGNED)
        assert ours.dtype == np.float32 and np.array_equal(ours, theirs)
        assert np.all(np.diff(ours) > 0)


def _requantize_inputs(signed: bool):
    """Blocks of 256: random magnitudes, an all-zero block, a block of
    exact midpoints between neighbouring codebook entries (ties), and a
    block of the entries themselves."""
    rng = np.random.default_rng(4)
    cb = state8bit.codebook(signed, "cpu").numpy().astype(np.float64)
    mids = ((cb[:-1] + cb[1:]) / 2).astype(np.float32)
    blocks = [np.abs(rng.standard_normal(256)) * 1e-3, np.zeros(256),
              np.concatenate([mids, [1.0]])[:256], cb.astype(np.float32),
              rng.standard_normal(256) * (1.0 if signed else 0.0) + (0.0 if signed else rng.random(256))]
    if signed:
        blocks.append(-np.abs(rng.standard_normal(256)) * 5.0)
    return np.concatenate(blocks).astype(np.float32)


@pytest.mark.parametrize("signed", [False, True])
def test_requantize_bit_exact_with_jax(signed):
    x = _requantize_inputs(signed)
    ours = optim.OptimState8bit.zeros(x.shape, signed=signed).requantize(torch.from_numpy(x))
    theirs = joptim.OptimState8bit.zeros(x.shape, signed=signed).requantize(jnp.asarray(x))
    assert ours.codes.dtype == torch.uint8 and ours.scale.dtype == torch.float32
    assert np.array_equal(ours.codes.numpy(), np.asarray(theirs.codes))
    assert np.array_equal(ours.scale.numpy(), np.asarray(theirs.scale))
    assert np.array_equal(ours.dequantize().numpy(), np.asarray(theirs.dequantize()))
    rel = np.abs(ours.dequantize().numpy() - x).mean() / np.abs(x).mean()
    assert rel < 0.05


def test_8bit_threshold_and_tree_order():
    """``state_8bit`` keeps leaves of >= 4096 elements with a size that is
    a multiple of 256 in 8 bits, the rest in fp32; the 8-bit state is a
    tree node whose leaves are (codes, scale), in JAX's leaf order."""
    shapes = {"a": (64, 64), "b": (4097,), "c": (17, 256), "d": (4095,), "e": (16,)}
    p0 = {k: np.ones(s, np.float32) for k, s in shapes.items()}
    ts = optim.schedule_free_adamw(state_8bit=True).init({k: torch.from_numpy(v) for k, v in p0.items()})
    js = joptim.schedule_free_adamw(state_8bit=True).init({k: jnp.asarray(v) for k, v in p0.items()})
    assert {k for k, v in ts.exp_avg_sq.items() if isinstance(v, optim.OptimState8bit)} == {"a", "c"}
    ours = [(tuple(l.shape), str(l.dtype)[6:]) for l in tree_leaves(ts.exp_avg_sq)]
    theirs = [(tuple(l.shape), str(l.dtype)) for l in jax.tree.leaves(js.exp_avg_sq)]
    assert ours == theirs
    assert ts.exp_avg_sq["a"].data_fields == ("codes", "scale") and ts.exp_avg_sq["a"].shape == (64, 64)
    with pytest.raises(ValueError, match="multiple of 256"):
        optim.OptimState8bit.zeros((100,))


def test_eval_train_flip_round_trip_and_vs_jax():
    p0 = {"w": np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32)}
    jopt, topt = joptim.schedule_free_adamw(warmup_steps=2), optim.schedule_free_adamw(warmup_steps=2)
    jp, tp = {"w": jnp.asarray(p0["w"])}, {"w": torch.from_numpy(p0["w"].copy())}
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(10)
    for _ in range(5):
        g = rng.standard_normal((16, 16)).astype(np.float32)
        jp, js = jopt.step({"w": jnp.asarray(g)}, js, jp, 1e-2)
        tp, ts = topt.step({"w": torch.from_numpy(g)}, ts, tp, 1e-2)
    pe = optim.eval_params(tp, ts)
    np.testing.assert_allclose(optim.train_params(pe, ts)["w"].numpy(), tp["w"].numpy(), rtol=1e-4, atol=1e-5)
    # the flips on the same state are the JAX package's, within one ulp of the leaf
    jpe = joptim.eval_params(jp, js)
    carried = schedule_free_state_from_jax(jax.tree.map(np.asarray, js))
    tpe = optim.eval_params({"w": torch.from_numpy(np.asarray(jp["w"]).copy())}, carried)
    assert _ulps(tpe["w"].numpy(), np.asarray(jpe["w"]), np.abs(np.asarray(jpe["w"])).max()) <= 1
    bf = optim.eval_params({"w": tp["w"].to(torch.bfloat16)}, ts)["w"]
    assert bf.dtype == torch.bfloat16


def test_lr0_first_step_stays_finite():
    """An lr-0 first step leaves weight_sum 0: ckp1 is 0, not 0/0."""
    p = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32))}
    g = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32))}
    opt = optim.schedule_free_adamw()
    s = opt.init(p)
    p, s = opt.step(g, s, p, 0.0)
    assert torch.isfinite(p["w"]).all() and s.weight_sum.item() == 0.0
    p, s = opt.step(g, s, p, 1e-2)
    assert torch.isfinite(p["w"]).all() and s.weight_sum.item() > 0.0


def test_schedule_free_decreases_loss():
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((128, 16)).astype(np.float32))
    y = X @ w_true
    p = {"w": torch.zeros(16)}
    opt = optim.schedule_free_adamw(warmup_steps=5)
    s = opt.init(p)
    loss = lambda p: torch.mean((X @ p["w"] - y) ** 2)
    l0 = loss(p).item()
    for _ in range(50):
        w = p["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        p, s = opt.step({"w": g}, s, p, 0.05)
    assert loss(optim.eval_params(p, s)).item() < l0 * 0.1


def test_registry_matches_jax():
    from quantized_training_tpu.optim import _REGISTRY as JREGISTRY
    from quantized_training_tpu_torch.optim import _REGISTRY

    assert set(_REGISTRY) == set(JREGISTRY)
    for name in _REGISTRY:
        assert isinstance(optim.get_optimizer(name, weight_decay=0.0), optim.Optimizer)
    s = optim.get_optimizer("schedule_free_adamw_8bit").init({"w": torch.zeros(64, 64)})
    assert isinstance(s.exp_avg_sq["w"], optim.OptimState8bit)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.get_optimizer("sgd")
