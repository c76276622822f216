"""The ViT's fused linears on the CPU: the plain versions of B18
(``ops/fused_producers.py``: ``layernorm_quant``, ``gelu_quant``) against the
JAX package's Pallas kernels in interpret mode, and the port's
``layernorm_linear`` / ``gelu_linear`` (``quant/fused.py``) against JAX's,
both packages under ``set_impl('interpret')`` (the Pallas kernels in
interpret mode, the port's plain versions) and under ``'off'``, on the same
numpy inputs; with the hazards of the slice: LayerNorm of a padded zero row
is b, the shape gates agree, two LayerNorms, GELU's tanh default.

Bounds, each above the floor it is stated with:

- kernels: int8 within one step on at most 1e-3 of the elements, scales and
  column maxima within 1e-5 relative (B7's bars in tests/test_torch_fused.py:
  the row sums run in another order, tanh is another implementation);
  measured at most one step on 6e-5 of the elements, scales 2.4e-7;
- the fused ops against JAX's: loss within 1e-3, outputs and every gradient
  within 3e-2 of their max (tests/test_torch_fused.py's bounds, whose floor,
  JAX against itself with the input moved by one ulp, reached 2.2e-2 in
  bf16; measured here in the test's docstring);
- fused against the unfused composite in the port: loss within 2e-2,
  gradients within 6e-2 of their max (tests/test_fused.py's bounds).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.ops import pallas_fused as pf
from quantized_training_tpu.quant import fused as jfused
from quantized_training_tpu.quant.mixed_precision import _pad_tokens as jpad
from quantized_training_tpu_torch import quant
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.ops import fused_producers as fp
from quantized_training_tpu_torch.quant import fused
from quantized_training_tpu_torch.quant.mixed_precision import _pad_tokens

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

LNEPS = 1e-6
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
SHAPES = [(64, 256), (256, 640)]


@pytest.fixture
def interpret():
    """Both packages' fused ops in interpret mode for one test."""
    jfused.set_impl("interpret")
    fused.set_impl("interpret")
    yield
    jfused.set_impl("auto")
    fused.set_impl("auto")


def _count_applies(monkeypatch) -> dict:
    """Count the applications of the port's two ViT autograd Functions."""
    counts = {"ln": 0, "gelu": 0}
    for name, cls in (("ln", fused._LNMM), ("gelu", fused._GeluMM)):
        def counted(*args, _apply=cls.apply, _name=name):
            counts[_name] += 1
            return _apply(*args)

        monkeypatch.setattr(cls, "apply", counted)
    return counts


def _arr(shape, seed, dtn, scale=1.0, offset=0.0):
    """One numpy draw, as a JAX array of the dtype and the same values in torch."""
    v = (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)
    j = jnp.asarray(v, _JDT[dtn])
    return j, params_from_jax(np.asarray(j))


def _q_close(got, want, what):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (what, d.max(), (d > 0).mean())


def _rel_close(got, want, tol, what):
    got, want = got.float().numpy().ravel(), np.asarray(want, np.float32).ravel()
    assert got.shape == want.shape and (np.abs(got - want) <= tol * np.abs(want)).all(), what


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / np.abs(np.asarray(b)).max()


# ---- B18's plain versions against the Pallas kernels ---------------------------------


def _ln_inputs(M, K, dtn, seed):
    xj, xt = _arr((M, K), seed, dtn, 2.0, 0.5)
    gj, gt = _arr((K,), seed + 1, dtn, 0.1, 1.0)
    bj, bt = _arr((K,), seed + 2, dtn, 0.3)
    return (xj, gj.reshape(1, -1), bj.reshape(1, -1)), (xt, gt, bt)


@pytest.mark.parametrize("M,K", SHAPES)
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("producer", ["layernorm", "gelu"])
def test_b18_plain_vs_pallas(producer, dtn, M, K):
    """B18's row form (with and without the column absmax) and column form
    (given the forward's scales, and in two passes), the port's plain
    versions against ``layernorm_quant`` / ``gelu_quant`` in interpret mode;
    each returns what JAX returns, in fp32."""
    if producer == "layernorm":
        js, ts = _ln_inputs(M, K, dtn, 0)
        jfn, tfn = pf.layernorm_quant, fp.layernorm_quant
        jkw, tkw = dict(norm_eps=LNEPS), dict(norm_eps=LNEPS)
    else:
        aj, at = _arr((M, K), 3, dtn, 3.0)
        js, ts, jfn, tfn, jkw, tkw = (aj,), (at,), pf.gelu_quant, fp.gelu_quant, {}, {}
    qj, sj, aj_ = jfn(*js, axis=1, interpret=True, with_col_amax=True, **jkw)
    q, s, a = tfn(*ts, axis=1, with_col_amax=True, **tkw)
    _q_close(q, qj, "row q")
    _rel_close(s, sj, 1e-5, "row scale")
    _rel_close(a, aj_, 1e-5, "column absmax")
    assert q.dtype == torch.int8 and s.dtype == a.dtype == torch.float32 and s.shape == (M, 1) and a.shape == (1, K)
    q0, s0 = tfn(*ts, **tkw)
    assert torch.equal(q0, q) and torch.equal(s0, s)
    for given in (True, False):
        qcj, scj = jfn(*js, axis=0, interpret=True, scale=aj_ * (1.0 / 127.0) if given else None, **jkw)
        qc, sc = tfn(*ts, axis=0, scale=a * (1.0 / 127.0) if given else None, **tkw)
        _q_close(qc, qcj, f"column q, given scales {given}")
        _rel_close(sc, scj, 1e-5, f"column scale, given {given}")
        assert sc.shape == (1, K)
    with pytest.raises(ValueError, match="axis"):
        tfn(*ts, axis=2)


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_two_layernorms_each_against_its_oracle(dtn):
    """Hazard 3: the unfused composite rounds xhat to x's dtype before the
    affine (``layer_norm_ref``), the fused kernels do not
    (``layer_norm_f32``); each equals JAX's own oracle (fp32 to 1e-6 of the
    max, the composite in bf16 to one bf16 step), and in bf16 they differ."""
    (xj, gj, bj), (xt, gt, bt) = _ln_inputs(96, 384, dtn, 10)
    f32 = fp.layer_norm_f32(xt, gt, bt, LNEPS)
    assert f32.dtype == torch.float32
    assert _max_rel(f32.numpy(), pf.layer_norm_f32(xj, gj, bj, LNEPS)) <= 1e-6
    ref = fp.layer_norm_ref(xt, gt, bt, LNEPS)
    assert ref.dtype == xt.dtype
    tol = 2.0**-7 if dtn == "bf16" else 1e-6
    assert _max_rel(ref.float().numpy(), np.asarray(pf.layer_norm_ref(xj, gj, bj, LNEPS), np.float32)) <= tol
    if dtn == "bf16":
        assert not torch.equal(ref.float(), f32)


def test_gelu_default_is_the_tanh_form():
    """Hazard 4: ``jax.nn.gelu`` defaults to the tanh form, ``F.gelu`` to
    erf; ``gelu_f32`` is the tanh form (JAX's, to 1e-6 of the max), and the
    fallback of ``gelu_linear`` is ``F.gelu(approximate="tanh")`` then
    qlinear, which erf's GELU is not."""
    aj, at = _arr((4, 32, 256), 20, "f32", 3.0)
    assert np.array_equal(np.asarray(jax.nn.gelu(aj)), np.asarray(jax.nn.gelu(aj, approximate=True)))
    assert _max_rel(fp.gelu_f32(at).numpy(), pf.gelu_f32(aj)) <= 1e-6
    assert torch.allclose(fp.gelu_f32(at), F.gelu(at, approximate="tanh"), rtol=0, atol=1e-6)
    _, w = _arr((128, 256), 21, "f32", 0.05)
    out = quant.gelu_linear(at, w)
    assert torch.equal(out, quant.qlinear(F.gelu(at, approximate="tanh"), w))
    assert not torch.equal(out, quant.qlinear(F.gelu(at), w))


N_KEYS = 200


@pytest.mark.parametrize("form", ["layernorm_row", "layernorm_col", "gelu_row", "gelu_col"])
def test_b18_sr_forms_deterministic_and_unbiased(form):
    """The SR forms of B18: a key repeats its draw and another key draws
    another; every q is floor(r) or floor(r) + 1 for r = y * (1 / scale),
    and the mean over 200 keys is within 0.2 of r everywhere and within 4e-3
    on average (the bars of tests/test_torch_fused.py). The Pallas SR
    bodies draw from the TPU's generator, which interpret mode does not
    run, so the port is held to its own producer values."""
    _, (x, g, b) = _ln_inputs(64, 256, "f32", 30)
    _, a = _arr((64, 256), 33, "f32", 3.0)
    if form.startswith("layernorm"):
        y, inputs, fn = fp.layer_norm_f32(x, g, b, LNEPS), (x, g, b), fp.layernorm_quant
    else:
        y, inputs, fn = fp.gelu_f32(a), (a,), fp.gelu_quant
    if form.endswith("row"):
        draw = lambda k: fn(*inputs, sr=True, key=k)
        scale = fn(*inputs)[1]
    else:
        scale = y.abs().amax(0, keepdim=True) * (1.0 / 127.0)
        draw = lambda k: fn(*inputs, axis=0, sr=True, key=k, scale=scale)
    s = scale.clamp(min=1e-12)
    r = (y * (torch.ones_like(s) / s)).double().numpy()
    qs = np.stack([draw(1000 + k)[0].numpy() for k in range(N_KEYS)]).astype(np.float64)
    lo = np.clip(np.floor(r), -128, 127)
    assert ((qs == lo) | (qs == np.clip(lo + 1, -128, 127))).all()
    dev = qs.mean(0) - r
    assert np.abs(dev).max() < 0.2 and abs(dev.mean()) < 4e-3, (np.abs(dev).max(), dev.mean())
    assert np.array_equal(draw(1000)[0].numpy(), qs[0]) and not np.array_equal(qs[0], qs[1])
    with pytest.raises(ValueError, match="requires a key"):
        fn(*inputs, sr=True)


# ---- layernorm_linear and gelu_linear against JAX's ---------------------------------


def _op_inputs(which, dtn, seed, tokens=(2, 96)):
    """(x, g, b, w, bias) of layernorm_linear or (a, w, bias) of
    gelu_linear, as JAX arrays and torch tensors."""
    D, N = (256, 384) if which == "ln" else (384, 256)
    specs = [((*tokens, D), 2.0, 0.5)]
    if which == "ln":
        specs += [((D,), 0.1, 1.0), ((D,), 0.3, 0.0)]
    specs += [((N, D), 0.05, 0.0), ((N,), 0.1, 0.0)]
    arrs = [_arr(shape, seed + i, dtn, sc, off) for i, (shape, sc, off) in enumerate(specs)]
    return [j for j, _ in arrs], [t for _, t in arrs]


def _jax_op(which, cfg, key):
    def run(*a):
        if which == "ln":
            out = jquant.layernorm_linear(a[0], a[1], a[2], jquant.MixedPrecisionWeight(a[3], cfg), LNEPS,
                                          bias=a[4], key=key)
        else:
            out = jquant.gelu_linear(a[0], jquant.MixedPrecisionWeight(a[1], cfg), bias=a[2], key=key)
        return jnp.sum(out.astype(jnp.float32) ** 2), out
    return run


def _torch_op(which, cfg, key, ts):
    ts = [t.clone().requires_grad_(True) for t in ts]
    if which == "ln":
        out = quant.layernorm_linear(ts[0], ts[1], ts[2], quant.MixedPrecisionWeight(ts[3], cfg), LNEPS, bias=ts[4],
                                     key=key)
    else:
        out = quant.gelu_linear(ts[0], quant.MixedPrecisionWeight(ts[1], cfg), bias=ts[2], key=key)
    loss = (out.float() ** 2).sum()
    return loss.item(), out.detach().float().numpy(), [g.float().numpy() for g in torch.autograd.grad(loss, ts)]


@pytest.mark.parametrize("gw", [True, False], ids=["all_int8", "gi_only"])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["ln", "gelu"])
def test_fused_op_vs_jax(which, dtn, gw, interpret, monkeypatch):
    """layernorm_linear / gelu_linear with a bias, fused in both packages
    (192 tokens): the loss, the output and every gradient (x, g, b, w,
    bias) against JAX's, for (grad_input, grad_weight) = (True, True) and
    (True, False); then both packages' unfused composites
    (``set_impl('off')``) against each other, and the port's fused op
    against its composite. Measured against JAX, fused: loss 1.5e-7 / 3.8e-6
    relative, worst output or gradient 2.3e-6 (fp32) / 7.3e-3 (bf16) of its
    max; unfused 1.5e-7 / 7.0e-5 and 2.3e-6 / 1.2e-2."""
    counts = _count_applies(monkeypatch)
    js, ts = _op_inputs(which, dtn, 40)
    jcfg, tcfg = jquant.MixedPrecisionConfig(grad_weight=gw), quant.MixedPrecisionConfig(grad_weight=gw)
    argnums = tuple(range(len(js)))
    (jl, jout), jg = jax.value_and_grad(_jax_op(which, jcfg, jax.random.PRNGKey(3)), argnums, has_aux=True)(*js)
    tl, tout, tg = _torch_op(which, tcfg, 3, ts)
    assert counts[which] == 1
    assert abs(tl - float(jl)) <= 1e-3 * abs(float(jl))
    for got, want in [(tout, jout), *zip(tg, jg)]:
        assert got.shape == np.shape(want) and _max_rel(got, want) <= 3e-2, _max_rel(got, want)
    fused.set_impl("off")
    jfused.set_impl("off")
    (ujl, _), ujg = jax.value_and_grad(_jax_op(which, jcfg, jax.random.PRNGKey(3)), argnums, has_aux=True)(*js)
    ul, _, ug = _torch_op(which, tcfg, 3, ts)
    assert counts[which] == 1  # the composites ran
    assert abs(ul - float(ujl)) <= 1e-3 * abs(float(ujl))
    for got, want in zip(ug, ujg):
        assert _max_rel(got, want) <= 3e-2, _max_rel(got, want)
    assert abs(tl - ul) <= 2e-2 * abs(ul)
    for got, want in zip(tg, ug):
        assert _max_rel(got, want) <= 6e-2


def test_padded_rows_are_b_after_layernorm(interpret, monkeypatch):
    """Hazard 1: from 1024 tokens on, both packages pad x with zero rows to a
    multiple of 256 before the fused LayerNorm, and LayerNorm of a zero row
    is b. At 64 images of 17 tokens (M = 1088, padded to 1280) with a
    column whose normalized values all take the sign opposite to b's
    (x[:, 0] = -2, g = 1, b[0] = 3), the forward's column absmax of column 0
    is |b[0]| = 3 in both (below 2 unpadded), and the port's grad_weight, whose column scale that
    absmax sets, is JAX's to 3e-2 of its max."""
    K, N = 256, 128
    x = np.random.default_rng(50).standard_normal((64, 17, K)).astype(np.float32)
    x[..., 0] = -2.0
    b = np.zeros(K, np.float32)
    b[0] = 3.0
    w = (np.random.default_rng(51).standard_normal((N, K)) * 0.05).astype(np.float32)
    seen = []
    rows = fp.layernorm_quant_rowwise
    monkeypatch.setattr(fp, "layernorm_quant_rowwise", lambda *a, **kw: seen.append(rows(*a, **kw)) or seen[-1])
    cfg = quant.MixedPrecisionConfig()
    xt, gt, bt, wt = (torch.from_numpy(v).requires_grad_(True) for v in (x, np.ones(K, np.float32), b, w))
    out = quant.layernorm_linear(xt, gt, bt, quant.MixedPrecisionWeight(wt, cfg), LNEPS)
    (out.float() ** 2).sum().backward()
    assert seen[0][0].shape == (1280, K) and seen[0][2][0, 0].item() == 3.0
    xp = jpad(jnp.asarray(x.reshape(-1, K)))[0]
    amax = pf.layernorm_quant(xp, jnp.ones((1, K)), jnp.asarray(b).reshape(1, -1), axis=1, norm_eps=LNEPS,
                              interpret=True, with_col_amax=True)[2]
    assert xp.shape == (1280, K) and float(amax[0, 0]) == 3.0
    unpadded = fp.layernorm_quant(xt.detach().reshape(-1, K), gt.detach(), bt.detach(), with_col_amax=True)[2]
    assert unpadded[0, 0].item() < 2.0

    def jloss(w):
        o = jquant.layernorm_linear(jnp.asarray(x), jnp.ones(K), jnp.asarray(b),
                                    jquant.MixedPrecisionWeight(w, jquant.MixedPrecisionConfig()), LNEPS)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    jgw = jax.grad(jloss)(jnp.asarray(w))
    assert _max_rel(wt.grad.numpy(), jgw) <= 3e-2, _max_rel(wt.grad.numpy(), jgw)


@pytest.mark.parametrize("K", [128, 192, 256])
@pytest.mark.parametrize("M", [64, 96, 788, 800, 1000, 1024, 1088, 1500])
def test_gates_agree_with_jax(M, K):
    """Hazard 2: at the tested shapes (4 x 197 = 788 tokens among them, and
    ViT-Tiny's 192 wide rows) both packages pad the same rows (JAX
    ``_pad_tokens``) and fuse the same shapes (JAX ``_fused_ok`` over its
    ``_pick_block``, the port's over ``supported``); below 1024 tokens a
    count that is no multiple of 32 falls back in both."""
    jfused.set_impl("interpret")
    fused.set_impl("interpret")
    try:
        jx, jM = jpad(jnp.zeros((M, K), jnp.bfloat16))
        tx = _pad_tokens(torch.zeros(M, K, dtype=torch.bfloat16))
        assert tx.shape == jx.shape and jM == M
        assert fused._fused_ok(*tx.shape, tx) == jfused._fused_ok(*jx.shape, jnp.bfloat16)
    finally:
        jfused.set_impl("auto")
        fused.set_impl("auto")


def test_other_configs_and_shapes_take_the_composite(monkeypatch):
    """Plain weights, forward-only configs, unsupported shapes, the CPU under
    'auto', set_impl('off') and QT_FUSED=0 take the unfused composite:
    layer_norm_ref -> qlinear and F.gelu(tanh) -> qlinear, exactly."""
    counts = _count_applies(monkeypatch)
    _, (x, g, b) = _ln_inputs(64, 256, "bf16", 60)
    x = x.reshape(2, 32, 256)
    _, w = _arr((128, 256), 63, "bf16", 0.05)
    _, bias = _arr((128,), 64, "bf16", 0.1)
    assert torch.equal(quant.layernorm_linear(x, g, b, w, LNEPS, bias=bias),
                       fp.layer_norm_ref(x, g, b, LNEPS) @ w.T + bias)
    int8 = quant.MixedPrecisionWeight(w, quant.MixedPrecisionConfig())
    fwd_only = quant.MixedPrecisionWeight(w, quant.MixedPrecisionConfig(grad_input=False, grad_weight=False))
    assert torch.equal(quant.layernorm_linear(x, g, b, int8, LNEPS, bias=bias, key=3),  # 'auto' on the CPU
                       quant.qlinear(fp.layer_norm_ref(x, g, b, LNEPS), int8, bias, key=3))
    fused.set_impl("interpret")
    try:
        quant.layernorm_linear(x, g, b, fwd_only, LNEPS)
        quant.gelu_linear(x, fwd_only)
        quant.layernorm_linear(x[:, :10], g, b, int8, LNEPS)  # M = 20: no multiple of 32
        monkeypatch.setitem(os.environ, "QT_FUSED", "0")
        quant.gelu_linear(x, int8)
        monkeypatch.delitem(os.environ, "QT_FUSED")
        assert counts == {"ln": 0, "gelu": 0}
        quant.layernorm_linear(x, g, b, int8, LNEPS)
        quant.gelu_linear(x, int8)
        assert counts == {"ln": 1, "gelu": 1}
        fused.set_impl("off")
        quant.gelu_linear(x, int8)
        assert counts == {"ln": 1, "gelu": 1}
    finally:
        fused.set_impl("auto")
