"""The port's bf16-state AdamW (optim/adamw.py::adamw_bf16_sr) and its update
kernel's plain version (ops/fused_adamw.py, B6) against the JAX package on
the CPU: ``fused_adamw_update`` run in interpret mode, and
``adamw_bf16_sr(backend="xla")``. Inputs come from numpy seeds.

Tolerances are in units in the last place of each output's dtype (bf16 for
the moments and bf16 params, fp32 for fp32 params), taken at the magnitude
of the terms that make the value (``_scales``): a sum that cancels to near
zero keeps the rounding error of its terms.

- Against the Pallas kernel in interpret mode: the same fp32 operations in
  the same order, but XLA compiles the kernel body on the CPU and may fuse
  an add and a multiply, so an element may land one ulp away. Measured on
  the CPU: at most 1 ulp, on at most 0.15% of the elements of any output.
  Bound: 1 ulp on under 0.5%.
- Against the XLA path: it forms 1 - b1 and 1 - b2 from Python doubles (0.1
  and 0.001), where the kernel, and the port, form them in fp32 from fp32
  scalars (0.100000024 and 0.0009999871, 2.2e-7 and 1.3e-5 apart,
  relative). The moments then round to the other bf16 neighbour now and
  then, and the update of p (at most about lr) moves through sqrt(eas) by
  about 6.5e-6 of itself. Measured on the CPU: the moments at most 1 bf16
  ulp on 1.7% of the elements; fp32 params up to 1.6e-5 of lr apart (42
  fp32 ulps at lr = 3e-4) on 1.5%; bf16 params equal. Bounds: the moments
  1 ulp on under 3%; params 2e-5 of lr plus 1 ulp.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu.ops.pallas_optim import fused_adamw_update as jfused_adamw
from quantized_training_tpu.quant import MixedPrecisionConfig as JCfg
from quantized_training_tpu.quant import mixed_precision as jmp
from quantized_training_tpu_torch import ops, optim
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.ops import fused_adamw
from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight
from quantized_training_tpu_torch.utils.tree import tree_leaves

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

# optim exports a function of the module's name
adamw_mod = importlib.import_module("quantized_training_tpu_torch.optim.adamw")

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
B1, B2, WD, EPS = 0.9, 0.999, 1e-2, 1e-8


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ulp(scale, dtype: str) -> np.ndarray:
    """One ulp of ``dtype`` ('bf16' or 'f32') at the magnitude ``scale``."""
    return np.spacing(np.abs(_f32(scale))).astype(np.float64) * (2.0**16 if dtype == "bf16" else 1.0)


def _ulps(a, b, dtype: str, scale) -> np.ndarray:
    """|a - b| in ulps of ``dtype`` at the magnitude ``scale`` of the terms
    that made the value (elementwise)."""
    return np.abs(_f32(a).astype(np.float64) - _f32(b)) / _ulp(scale, dtype)


def _scales(p, g, ea, eas, lr):
    """The magnitude of the terms of p', ea' and eas' (the update of p is
    at most about lr)."""
    p, g, ea, eas = (_f32(x) for x in (p, g, ea, eas))
    return np.maximum(np.abs(p), lr), np.maximum(np.abs(ea), np.abs(g)), np.maximum(np.abs(eas), g * g)


def _scalars(lr, t):
    tt = jnp.float32(t)
    return jnp.stack([jnp.float32(lr), jnp.float32(B1), jnp.float32(B2), jnp.float32(WD), jnp.float32(EPS),
                      1.0 - B1**tt, 1.0 - B2**tt])


def _leaf(shape, dtn, seed):
    rng = np.random.default_rng(seed)
    p = jnp.asarray(rng.standard_normal(shape) * 0.02, _JDT[dtn])
    g = jnp.asarray(rng.standard_normal(shape) * 1e-3, _JDT[dtn])
    ea = jnp.asarray(rng.standard_normal(shape) * 1e-4, jnp.bfloat16)
    eas = jnp.asarray(rng.random(shape) * 1e-6, jnp.bfloat16)
    return p, g, ea, eas


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("shape", [(96, 160), (3, 64, 96)])
@pytest.mark.parametrize("dtn", ["bf16", "f32"])
def test_fused_adamw_plain_vs_pallas_and_xla(dtn, shape, t):
    """B6's plain version, SR off, against the Pallas kernel (interpret
    mode) and against the XLA path of adamw_bf16_sr, at step t, bf16 and
    fp32 params, a 2-D and a 3-D leaf; bounds in the module docstring."""
    p, g, ea, eas = _leaf(shape, dtn, seed=t)
    sc = _scalars(3e-4, t)
    jp, jea, jeas = jfused_adamw(p, g, ea, eas, sc, jnp.zeros((1,), jnp.int32), bf16_sr=False, interpret=True)
    tp, tea, teas = ops.fused_adamw_plain(_t(p), _t(g), _t(ea), _t(eas), _t(sc), None, bf16_sr=False)
    assert tp.dtype == _t(p).dtype and tea.dtype == teas.dtype == torch.bfloat16
    assert tp.shape == tea.shape == teas.shape == shape
    sp, sea, seas = _scales(p, g, ea, eas, 3e-4)
    for got, want, dt, scale in ((tp, jp, dtn, sp), (tea, jea, "bf16", sea), (teas, jeas, "bf16", seas)):
        u = _ulps(got, want, dt, scale)
        assert u.max() <= 1 and (u > 0).mean() < 0.005
    xopt = joptim.adamw_bf16_sr(backend="xla", bf16_stochastic_rounding=False, weight_decay=WD)
    xp, xst = xopt.step({"w": g}, joptim.AdamWState(jnp.int32(t - 1), {"w": ea}, {"w": eas}), {"w": p}, 3e-4)
    for got, want, scale in ((tea, xst.exp_avg["w"], sea), (teas, xst.exp_avg_sq["w"], seas)):
        u = _ulps(got, want, "bf16", scale)
        assert u.max() <= 1 and (u > 0).mean() < 0.03
    assert _near_update(tp, xp["w"], dtn, sp, 3e-4)


def _near_update(got, want, dtn, scale, lr) -> bool:
    """Params within 2e-5 of lr plus one ulp (the XLA path's bound)."""
    return bool((np.abs(_f32(got).astype(np.float64) - _f32(want)) <= 2e-5 * lr + _ulp(scale, dtn)).all())


def test_one_minus_beta_hazard():
    """The constant the kernel forms, fp32(1 - fp32(b)), against the XLA
    path's Python double rounded to fp32: apart by the relative amounts the
    module docstring states, which is why the two paths differ."""
    for b, rel in ((B1, 2.2e-7), (B2, 1.3e-5)):
        kernel = np.float32(1.0) - np.float32(b)
        xla = np.float32(1.0 - b)
        assert abs(float(kernel) - float(xla)) / float(xla) == pytest.approx(rel, rel=0.1)


def _tree(rng, dt, scale):
    mk = lambda *s: jnp.asarray(rng.standard_normal(s) * scale, dt)
    return {"a": {"w": jmp.MixedPrecisionWeight(mk(128, 64), JCfg())}, "b": {"g": mk(64)}, "c": {"w": mk(2, 32, 48)}}


@pytest.mark.parametrize("dtn", ["bf16", "f32"])
def test_adamw_bf16_sr_two_steps_vs_jax(dtn):
    """Two steps of adamw_bf16_sr (SR writeback off, as bench.py runs it)
    from one bf16 state carried over by adamw_state_from_jax, over a tree
    with a MixedPrecisionWeight and a 3-D leaf, against the JAX optimizer's
    XLA path; the state stays bf16 and the count matches. After the first
    step a moment may sit one bf16 ulp (2**-8 of itself) away from JAX's,
    which moves the second update by up to 2**-8 of lr. Measured on the
    CPU: moments at most 0.25 ulp at the magnitude of the grads' terms;
    fp32 params at most 3.0e-3 of lr apart, bf16 params equal. Bounds: 1
    ulp; 2 * 2**-8 of lr plus one ulp."""
    rng = np.random.default_rng(7)
    dt = _JDT[dtn]
    jparams = _tree(rng, dt, 0.05)
    jgrads = [_tree(rng, dt, 1e-3) for _ in range(2)]
    jopt = joptim.adamw_bf16_sr(backend="xla", bf16_stochastic_rounding=False)
    jstate = jopt.init(jparams)
    conv = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    tparams, tstate = conv(jparams), adamw_state_from_jax(jax.tree.map(np.asarray, jstate))
    topt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    for jg in jgrads:
        jparams, jstate = jopt.step(jg, jstate, jparams, 3e-4)
        tparams, tstate = topt.step(conv(jg), tstate, tparams, 3e-4)
    assert tstate.count == int(jstate.count) == 2
    assert isinstance(tparams["a"]["w"], MixedPrecisionWeight)
    for tp, jp in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        assert tp.dtype == params_from_jax(np.asarray(jp)).dtype
        d = np.abs(_f32(tp).astype(np.float64) - _f32(jp))
        assert (d <= 2 * 2.0**-8 * 3e-4 + _ulp(np.maximum(np.abs(_f32(jp)), 3e-4), dtn)).all()
    gmax = [np.maximum(np.abs(_f32(a)), np.abs(_f32(b)))
            for a, b in zip(*(jax.tree.leaves(jg) for jg in jgrads))]
    for tt, jt, square in ((tstate.exp_avg, jstate.exp_avg, False), (tstate.exp_avg_sq, jstate.exp_avg_sq, True)):
        for a, b, gm in zip(tree_leaves(tt), jax.tree.leaves(jt), gmax):
            assert a.dtype == torch.bfloat16
            scale = np.maximum(np.maximum(np.abs(_f32(a)), np.abs(_f32(b))), gm * gm if square else gm)
            assert _ulps(a, b, "bf16", scale).max() <= 1


def test_adamw_bf16_sr_writeback_rounds_to_a_neighbour():
    """With the SR writeback each bf16 param is one of the two bf16
    neighbours of its fp32 update (the update of the same step with fp32
    params, which holds every bf16 input exactly), the same key repeats,
    and over 64 keys the mean lands within 4 standard errors of the fp32
    update (the bf16 gap is 2**-8 of the value: std <= gap / 2)."""
    rng = np.random.default_rng(9)
    p = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 0.02).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e-3).to(torch.bfloat16)
    ea = torch.zeros(4096, dtype=torch.bfloat16)
    sc = torch.tensor([1e-3, B1, B2, WD, EPS, 1 - B1, 1 - B2], dtype=torch.float32)
    exact, _, _ = ops.fused_adamw_plain(p.float(), g.float(), ea, ea, sc, None, bf16_sr=False)
    lo = (exact.view(torch.int32) & -65536).view(torch.float32)
    hi = lo + (lo.abs() * 2.0**-7).where(lo != 0, torch.tensor(0.0))  # one bf16 step away from zero
    draws = []
    for key in range(64):
        new_p, _, _ = ops.fused_adamw_plain(p, g, ea, ea, sc, key, bf16_sr=True)
        v = new_p.float()
        assert (((v == lo) | ((v - lo).abs() <= (hi - lo).abs() * 1.001)) & ((v - exact).abs() <= (hi - lo).abs())).all()
        draws.append(v)
    again, _, _ = ops.fused_adamw_plain(p, g, ea, ea, sc, 63, bf16_sr=True)
    assert torch.equal(again.float(), draws[-1])
    mean = torch.stack(draws).mean(0)
    gap = (hi - lo).abs()
    se = gap / 2 / 8  # sqrt(64) draws
    assert ((mean - exact).abs() <= 4 * se + 1e-12).float().mean() > 0.999


def test_optimizer_registry():
    assert isinstance(optim.get_optimizer("adamw"), optim.Optimizer)
    opt = optim.get_optimizer("adamw_bf16_sr", weight_decay=0.0)
    assert opt.init({"w": torch.zeros(3)}).exp_avg["w"].dtype == torch.bfloat16
    for name in ("schedule_free_adamw", "schedule_free_adamw_8bit"):
        assert isinstance(optim.get_optimizer(name), optim.Optimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.get_optimizer("sgd")


def test_adamw_ignores_key_and_sr_needs_one():
    """adamw accepts a key and ignores it (JAX :164-165); the SR writeback
    of adamw_bf16_sr refuses to run without one."""
    p = {"w": torch.full((8,), 0.5, dtype=torch.bfloat16)}
    g = {"w": torch.full((8,), 1e-2, dtype=torch.bfloat16)}
    opt = optim.adamw()
    a, _ = opt.step(g, opt.init(p), p, 1e-3)
    b, _ = opt.step(g, opt.init(p), p, 1e-3, 123)
    assert torch.equal(a["w"], b["w"])
    sr = optim.adamw_bf16_sr()
    with pytest.raises(ValueError, match="requires a key"):
        sr.step(g, sr.init(p), p, 1e-3)


def test_adamw_state_from_jax_carries_bf16_state():
    """A JAX adamw_bf16_sr state after one step comes over as a bf16
    AdamWState with the same values, shapes, wrappers and count."""
    rng = np.random.default_rng(11)
    jparams = _tree(rng, jnp.bfloat16, 0.05)
    jopt = joptim.adamw_bf16_sr(backend="xla", bf16_stochastic_rounding=False)
    _, jstate = jopt.step(_tree(rng, jnp.bfloat16, 1e-3), jopt.init(jparams), jparams, 3e-4)
    tstate = adamw_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert isinstance(tstate, optim.AdamWState) and tstate.count == 1
    assert isinstance(tstate.exp_avg["a"]["w"], MixedPrecisionWeight)
    for tt, jt in ((tstate.exp_avg, jstate.exp_avg), (tstate.exp_avg_sq, jstate.exp_avg_sq)):
        for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_device_path_takes_the_kernel(monkeypatch):
    """A meta tensor takes B6's device path without a card: the wrapper
    refuses a non-CUDA device, and the plain version never runs; the
    optimizer hands each leaf to the wrapper."""
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a device tensor")

    monkeypatch.setattr(fused_adamw, "fused_adamw_plain", no_plain)
    p = torch.empty(64, dtype=torch.bfloat16, device="meta")
    sc = torch.empty(7, device="meta")
    with pytest.raises(ValueError, match="^fused_adamw_update: needs CPU or CUDA"):
        ops.fused_adamw_update(p, p, p, p, sc, 1, bf16_sr=True)
    seen = []
    monkeypatch.setattr(adamw_mod, "fused_adamw_update",
                        lambda *args, bf16_sr, in_place: seen.append((args[5], bf16_sr, in_place)) or args[:3])
    opt = optim.adamw_bf16_sr()
    params = {"a": torch.empty(4, dtype=torch.bfloat16, device="meta"), "b": torch.empty(4, device="meta")}
    opt.step(params, opt.init(params), params, 1e-3, 42)
    # leaf 0 (bf16) rounds from fold_in(fold_in(key, 0), count); leaf 1 (fp32) to nearest
    assert seen == [(ops.random.fold_in(ops.random.fold_in(42, 0), 1), True, False), (None, False, False)]
