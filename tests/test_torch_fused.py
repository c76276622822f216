"""The producer-fused layer on the CPU: the port's ``quant/fused.py`` and the
plain versions of B7-B10 (``ops/fused_producers.py``) against the JAX
package's ``quant/fused.py`` and ``ops/pallas_fused.py``, both in interpret
mode (``set_impl('interpret')``: the Pallas kernels in interpret mode, the
port's plain versions), on the same numpy inputs. Mirrors
tests/test_fused.py at small shapes (M 64-256, K and F multiples of 128, so
that ``supported`` admits them).

Bounds, each above the floor it is stated with:

- kernels: int8 within one step on at most 1e-3 of the elements (the fused
  quantize multiplies by a reciprocal in both packages, but the row sums of
  RMSNorm run in another order), scales and column maxima within 1e-5
  relative. B10's dx within 2**-8 of max|dx| in bf16 (one bf16 step at the
  largest value) and 1e-5 in fp32, dgamma within 1e-5 of max|dgamma|: the
  Pallas kernel against JAX's own jnp oracle, the floor, differs by up to
  one bf16 step in dx and 2e-7 in dgamma (measured);
- the fused ops against JAX's: loss within 1e-3, outputs and every gradient
  within 3e-2 of their max. Measured: the port at most 4.8e-7 (fp32) and
  2.7e-5 (bf16) away; JAX against itself with the input moved by one ulp
  (random sign) up to 2.2e-2 (bf16);
- fused against the unfused composite in the port: loss within 2e-2,
  gradients within 6e-2 of their max (tests/test_fused.py's bounds);
- the whole train step against JAX's, (loss, grad norm, worst parameter
  leaf's relative RMS) within (1e-3, 5e-3, 1e-2), the bounds of
  tests/test_torch_train.py, with the grouped pipeline and the one-op MLP in
  both packages. Measured over two steps, floor (JAX against itself with
  the embedding moved by one ulp) then the port: fp32 6.6e-5, 5.7e-4,
  2.4e-3 / 5.9e-5, 4.7e-4, 1.9e-3; bf16 9.8e-5, 1.6e-3, 5.9e-3 / 5.6e-5,
  1.3e-3, 3.1e-3.

Every test that claims the fused path ran counts the applications of the
fused autograd Functions (CPU calls count no kernel launches).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.ops import pallas_fused as pf
from quantized_training_tpu.quant import fused as jfused
from quantized_training_tpu_torch import ops, optim, quant, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import fused_producers as fp
from quantized_training_tpu_torch.quant import fused
from quantized_training_tpu_torch.utils.tree import tree_leaves
from test_torch_train import _counting

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

EPS = 1e-5
KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 64
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
    """Count the applications of the port's four fused autograd Functions."""
    counts = {"norm": 0, "silu": 0, "mlp": 0, "attn_out": 0}
    for name, cls in (("norm", fused._NormMM), ("silu", fused._SiluMM), ("mlp", fused._MLPMM),
                      ("attn_out", fused._AttnOutMM)):
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


# ---- the kernels' plain versions against the Pallas kernels ------------------------


@pytest.mark.parametrize("M,K", SHAPES)
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_rmsnorm_quant_vs_pallas(dtn, M, K):
    """B7 (with and without the column absmax) and B8 (given the forward's
    scales, and in two passes), the port's plain versions against the
    Pallas kernels in interpret mode; an all-zero row quantizes to 0."""
    xj, xt = _arr((M, K), 0, dtn)
    xj, xt = xj.at[1].set(0), xt.clone()
    xt[1] = 0
    gj, gt = _arr((K,), 1, dtn, 0.1, 1.0)
    qj, sj, aj = pf.rmsnorm_quant_rowwise(xj, gj.reshape(1, -1), norm_eps=EPS, interpret=True, with_col_amax=True)
    q, s, a = fp.rmsnorm_quant_rowwise(xt, gt, norm_eps=EPS, with_col_amax=True)
    _q_close(q, qj, "B7 q")
    _rel_close(s, sj, 1e-5, "B7 scale")
    _rel_close(a, aj, 1e-5, "B7 column absmax")
    assert s.dtype == a.dtype == torch.float32 and s.shape == (M, 1) and a.shape == (1, K)
    assert not q[1].any()
    q0, s0 = fp.rmsnorm_quant_rowwise(xt, gt, norm_eps=EPS)
    assert torch.equal(q0, q) and torch.equal(s0, s)
    for given in (True, False):
        qcj, scj = pf.rmsnorm_quant_colwise(xj, gj.reshape(1, -1), norm_eps=EPS, interpret=True,
                                            scale=aj * (1.0 / 127.0) if given else None)
        qc, sc = fp.rmsnorm_quant_colwise(xt, gt, norm_eps=EPS, scale=a * (1.0 / 127.0) if given else None)
        _q_close(qc, qcj, f"B8 q, given scales {given}")
        _rel_close(sc, scj, 1e-5, f"B8 scale, given {given}")


@pytest.mark.parametrize("M,K", SHAPES)
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_silu_mul_quant_vs_pallas(dtn, M, K):
    """B9, row form (with and without the column absmax) and column form
    (given scales, and two passes), against the Pallas kernels."""
    aj, at = _arr((M, K), 2, dtn, 2.0)
    bj, bt = _arr((M, K), 3, dtn)
    qj, sj, amj = pf.silu_mul_quant_rowwise(aj, bj, interpret=True, with_col_amax=True)
    q, s, am = fp.silu_mul_quant_rowwise(at, bt, with_col_amax=True)
    _q_close(q, qj, "B9 row q")
    _rel_close(s, sj, 1e-5, "B9 row scale")
    _rel_close(am, amj, 1e-5, "B9 column absmax")
    q0, s0 = fp.silu_mul_quant_rowwise(at, bt)
    assert torch.equal(q0, q) and torch.equal(s0, s)
    for given in (True, False):
        qcj, scj = pf.silu_mul_quant_colwise(aj, bj, interpret=True, scale=amj * (1.0 / 127.0) if given else None)
        qc, sc = fp.silu_mul_quant_colwise(at, bt, scale=am * (1.0 / 127.0) if given else None)
        _q_close(qc, qcj, f"B9 column q, given {given}")
        _rel_close(sc, scj, 1e-5, f"B9 column scale, given {given}")


@pytest.mark.parametrize("M,K", SHAPES)
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_rmsnorm_bwd_vs_pallas(dtn, M, K):
    """B10's plain version against the Pallas kernel in interpret mode and
    against JAX's closed form (``_rmsnorm_bwd_math``)."""
    xj, xt = _arr((M, K), 4, dtn)
    gj, gt = _arr((K,), 5, dtn, 0.1, 1.0)
    dyj, dyt = _arr((M, K), 6, dtn)
    dx, dg = fp.rmsnorm_bwd(xt, gt, dyt, norm_eps=EPS)
    assert dx.dtype == xt.dtype and dg.dtype == torch.float32 and dg.shape == (K,)
    tol = 2.0**-8 if dtn == "bf16" else 1e-5
    for dxj, dgj in (pf.rmsnorm_bwd(xj, gj.reshape(1, -1), dyj, norm_eps=EPS, interpret=True),
                     jfused._rmsnorm_bwd_math(xj, gj.astype(jnp.float32), dyj, EPS)):
        dxj, dgj = np.asarray(dxj, np.float32), np.asarray(dgj, np.float32).ravel()
        assert np.abs(dx.float().numpy() - dxj).max() <= tol * np.abs(dxj).max()
        assert np.abs(dg.numpy() - dgj).max() <= 1e-5 * np.abs(dgj).max()


def test_col_amax_forwarding_exact():
    """The column absmax the row kernels forward gives the column kernels
    the two-pass form's scales: the one-pass column quantize equals the
    two-pass one bit for bit, at both sites (test_fused.py's counterpart)."""
    _, x = _arr((256, 384), 16, "bf16")
    _, g = _arr((384,), 17, "bf16", 0.1, 1.0)
    _, a = _arr((256, 512), 14, "bf16")
    _, b = _arr((256, 512), 15, "bf16")
    for row, col, inputs in ((fp.rmsnorm_quant_rowwise, fp.rmsnorm_quant_colwise, (x, g)),
                             (fp.silu_mul_quant_rowwise, fp.silu_mul_quant_colwise, (a, b))):
        amax = row(*inputs, with_col_amax=True)[2]
        q1, s1 = col(*inputs, scale=amax * (1.0 / 127.0))
        q2, s2 = col(*inputs)
        assert torch.equal(q1, q2) and torch.equal(s1, s2)


# ---- stochastic rounding ---------------------------------------------------------

N_KEYS = 200


@pytest.mark.parametrize("form", ["rmsnorm_row", "rmsnorm_col", "silu_row", "silu_col"])
def test_sr_forms_deterministic_and_unbiased(form):
    """The SR forms of B7, B8 and B9: a key repeats its draw and another
    key draws another; every q is floor(r) or floor(r) + 1 for r = y *
    (1 / scale), and the mean over 200 keys is within 0.2 of r everywhere
    and within 4e-3 on average (5.6 and 6 standard errors). The Pallas SR
    bodies draw from the TPU's generator, which interpret mode does not
    run (tests/test_fused.py skips them off the TPU), so the port is held
    to its own producer values."""
    _, x = _arr((64, 256), 8, "f32")
    _, g = _arr((256,), 9, "f32", 0.1, 1.0)
    _, a = _arr((64, 256), 10, "f32", 2.0)
    if form.startswith("rmsnorm"):
        y, inputs, row, col = fp.rms_norm_f32(x, g, EPS), (x, g), fp.rmsnorm_quant_rowwise, fp.rmsnorm_quant_colwise
    else:
        y, inputs, row, col = fp.silu_mul_f32(a, x), (a, x), fp.silu_mul_quant_rowwise, fp.silu_mul_quant_colwise
    if form.endswith("row"):
        draw = lambda k: row(*inputs, sr=True, key=k)
        scale = row(*inputs)[1]
    else:
        scale = y.abs().amax(0, keepdim=True) * (1.0 / 127.0)
        draw = lambda k: col(*inputs, sr=True, key=k, scale=scale)
    s = scale.clamp(min=1e-12)
    r = (y * (torch.ones_like(s) / s)).double().numpy()
    qs = np.stack([draw(1000 + k)[0].numpy() for k in range(N_KEYS)]).astype(np.float64)
    lo = np.clip(np.floor(r), -128, 127)
    assert ((qs == lo) | (qs == np.clip(lo + 1, -128, 127))).all()
    dev = qs.mean(0) - r
    assert np.abs(dev).max() < 0.2 and abs(dev.mean()) < 4e-3, (np.abs(dev).max(), dev.mean())
    assert np.array_equal(draw(1000)[0].numpy(), qs[0]) and not np.array_equal(qs[0], qs[1])
    with pytest.raises(ValueError, match="requires a key"):
        row(*inputs, sr=True)


# ---- the two fused ops against JAX's ---------------------------------------------


def _mp_inputs(which, dtn, gw, seed):
    """Inputs of norm_linear_multi (x, gamma, q/k/v-like weights) or of
    silu_mul_linear (gate, up, down weight), as JAX arrays and torch
    tensors, and each package's config."""
    if which == "norm":
        specs = [((2, 64, 256), 1.0, 0.0), ((256,), 0.1, 1.0), ((256, 256), 0.05, 0.0), ((128, 256), 0.05, 0.0),
                 ((128, 256), 0.05, 0.0)]
    else:
        specs = [((2, 64, 512), 1.0, 0.0), ((2, 64, 512), 1.0, 0.0), ((256, 512), 0.05, 0.0)]
    arrs = [_arr(shape, seed + i, dtn, sc, off) for i, (shape, sc, off) in enumerate(specs)]
    return ([j for j, _ in arrs], [t for _, t in arrs], jquant.MixedPrecisionConfig(grad_weight=gw),
            quant.MixedPrecisionConfig(grad_weight=gw))


def _jax_op(which, cfg, key):
    def run(*a):
        if which == "norm":
            outs = jquant.norm_linear_multi(a[0], a[1], [jquant.MixedPrecisionWeight(w, cfg) for w in a[2:]], EPS,
                                            key=key)
        else:
            outs = [jquant.silu_mul_linear(a[0], a[1], jquant.MixedPrecisionWeight(a[2], cfg), key=key)]
        return sum(jnp.sum(o.astype(jnp.float32) ** 2) for o in outs), outs
    return run


def _torch_op(which, cfg, key, ts):
    ts = [t.clone().requires_grad_(True) for t in ts]
    if which == "norm":
        outs = quant.norm_linear_multi(ts[0], ts[1], [quant.MixedPrecisionWeight(w, cfg) for w in ts[2:]], EPS,
                                       key=key)
    else:
        outs = [quant.silu_mul_linear(ts[0], ts[1], quant.MixedPrecisionWeight(ts[2], cfg), key=key)]
    loss = sum((o.float() ** 2).sum() for o in outs)
    return loss.item(), [o.detach().float().numpy() for o in outs], [
        g.float().numpy() for g in torch.autograd.grad(loss, ts)]


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("gw", [True, False], ids=["all_int8", "gi_only"])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["norm", "silu"])
def test_fused_op_vs_jax(which, dtn, gw, interpret, monkeypatch):
    """norm_linear_multi / silu_mul_linear, fused in both packages: the
    loss, every output and every gradient against JAX's, for (grad_input,
    grad_weight) = (True, True) and (True, False); then the port's fused op
    against its unfused composite (set_impl('off'))."""
    counts = _count_applies(monkeypatch)
    js, ts, jcfg, tcfg = _mp_inputs(which, dtn, gw, 20)
    (jl, jouts), jg = jax.value_and_grad(_jax_op(which, jcfg, jax.random.PRNGKey(3)), argnums=tuple(range(len(js))),
                                         has_aux=True)(*js)
    tl, touts, tg = _torch_op(which, tcfg, 3, ts)
    assert counts[which] == 1
    assert abs(tl - float(jl)) <= 1e-3 * abs(float(jl))
    for got, want in [*zip(touts, jouts), *zip(tg, jg)]:
        assert got.shape == np.shape(want) and _max_rel(got, want) <= 3e-2, _max_rel(got, want)
    fused.set_impl("off")
    ul, _, ug = _torch_op(which, tcfg, 3, ts)
    assert counts[which] == 1  # the composite ran
    assert abs(tl - ul) <= 2e-2 * abs(ul)
    for got, want in zip(tg, ug):
        assert _max_rel(got, want) <= 6e-2


def test_mlp_linear_is_the_two_op_composite(interpret, monkeypatch):
    """mlp_linear's fallback branch: weights of two configs (down's
    grad_weight bf16) are no one-op MLP in either package, so mlp_linear is
    norm_linear_multi with fold_in(key, 0) then silu_mul_linear with
    fold_in(key, 1), bit for bit, and JAX's two-op branch within the fused
    ops' bounds."""
    counts = _count_applies(monkeypatch)
    js, ts, jcfg, tcfg = _mp_inputs("norm", "bf16", True, 30)
    jd, td = _arr((256, 128), 40, "bf16", 0.05)
    wg, wu = (quant.MixedPrecisionWeight(w, tcfg) for w in ts[3:5])
    wd = quant.MixedPrecisionWeight(td, quant.MixedPrecisionConfig(grad_weight=False))
    out = quant.mlp_linear(ts[0], ts[1], wg, wu, wd, EPS, key=7)
    gate, up = quant.norm_linear_multi(ts[0], ts[1], [wg, wu], EPS, key=ops.random.fold_in(7, 0))
    assert torch.equal(out, quant.silu_mul_linear(gate, up, wd, key=ops.random.fold_in(7, 1)))
    assert counts == {"norm": 2, "silu": 2, "mlp": 0, "attn_out": 0}
    jw = [jquant.MixedPrecisionWeight(w, jcfg) for w in js[3:5]]
    jw.append(jquant.MixedPrecisionWeight(jd, jquant.MixedPrecisionConfig(grad_weight=False)))
    jout = jquant.mlp_linear(js[0], js[1], *jw, EPS, key=jax.random.PRNGKey(7))
    assert _max_rel(out.float().numpy(), np.asarray(jout, np.float32)) <= 3e-2


def test_other_schemes_and_shapes_take_the_composite(monkeypatch):
    """Plain weights, forward-only configs, unsupported shapes, the CPU
    under 'auto', set_impl('off') and QT_FUSED=0 all take the unfused
    composite: rms_norm -> qlinear_multi, silu * mul -> qlinear, exactly."""
    counts = _count_applies(monkeypatch)
    _, x = _arr((2, 16, 256), 50, "bf16")
    _, gamma = _arr((256,), 51, "bf16", 0.1, 1.0)
    _, w = _arr((256, 256), 52, "bf16", 0.05)
    ref = fp.rms_norm_ref(x, gamma, EPS) @ w.T
    assert torch.equal(quant.norm_linear_multi(x, gamma, [w], EPS)[0], ref)
    assert torch.equal(quant.silu_mul_linear(x, x, w), fp.silu_mul_ref(x, x) @ w.T)
    int8 = quant.MixedPrecisionWeight(w, quant.MixedPrecisionConfig())
    fwd_only = quant.MixedPrecisionWeight(w, quant.MixedPrecisionConfig(grad_input=False, grad_weight=False))
    assert torch.equal(quant.norm_linear_multi(x, gamma, [int8], EPS, key=3)[0],  # 'auto' on the CPU
                       quant.qlinear_multi(fp.rms_norm_ref(x, gamma, EPS), [int8], key=3)[0])
    fused.set_impl("interpret")
    try:
        quant.norm_linear_multi(x, gamma, [fwd_only], EPS)
        quant.silu_mul_linear(x, x, fwd_only)
        quant.norm_linear_multi(x[:, :10], gamma, [int8], EPS)  # M = 20: no multiple of 32
        quant.norm_linear_multi(x, gamma, [int8, w], EPS)  # a mix of weight types
        monkeypatch.setitem(os.environ, "QT_FUSED", "0")
        quant.silu_mul_linear(x, x, int8)
        monkeypatch.delitem(os.environ, "QT_FUSED")
        assert counts == {"norm": 0, "silu": 0, "mlp": 0, "attn_out": 0}
        quant.silu_mul_linear(x, x, int8)
        assert counts == {"norm": 0, "silu": 1, "mlp": 0, "attn_out": 0}
        fused.set_impl("off")
        quant.silu_mul_linear(x, x, int8)
        assert counts == {"norm": 0, "silu": 1, "mlp": 0, "attn_out": 0}
    finally:
        fused.set_impl("auto")
    with pytest.raises(ValueError, match="set_impl"):
        fused.set_impl("tpu")
    assert [fp.supported(M, K, torch.bfloat16) for M, K in ((32, 128), (16, 128), (48, 128), (64, 200))] == [
        True, False, False, False]
    assert fused._padded_rows(1000) == 1000 and fused._padded_rows(1100) == 1280


# ---- the whole step ------------------------------------------------------------------


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_train_step_fused_vs_jax(dtn, interpret, monkeypatch):
    """Two steps of make_train_step (remat, adamw) on the fused layer in
    both packages, from one state, with the grouped pipeline
    (QT_FUSED_ROPE=force: rope fused with the head grouping, the grouped
    einsum attention) and the one-op MLP in both: losses, grad norms and
    every parameter within (1e-3, 5e-3, 1e-2). At B * S = 128 the
    o-projection is no fused op in either package (its gate needs (B * S) %
    256 == 0; tests/test_torch_rope.py runs it)."""
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    counts = _count_applies(monkeypatch)
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=_JDT[dtn]), "mixed_precision")
    jopt = joptim.adamw(weight_decay=1e-2)
    jstate = jtrain.init_train_state(jp, jopt)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    jstep = jtrain.make_train_step(jcfg, jopt, donate=False)
    tstep = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2))
    rng = np.random.default_rng(0)
    tok, lab = rng.integers(0, KW["vocab_size"], (B, S)), rng.integers(0, KW["vocab_size"], (B, S))
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), 3e-4,
                           jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, torch.from_numpy(tok), torch.from_numpy(lab), 3e-4, 1)
        jl, tl, jg, tg = float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])
        assert np.isfinite(tl) and abs(tl - jl) <= 1e-3 * abs(jl), (tl, jl)
        assert abs(tg - jg) <= 5e-3 * jg, (tg, jg)
        for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
            b = np.asarray(b, np.float64)
            assert np.linalg.norm(a.double().numpy() - b) <= 1e-2 * np.linalg.norm(b)
    # per step and layer: q/k/v (norm) and the MLP; remat replays each forward
    n = 2 * 2 * KW["num_hidden_layers"]
    assert counts == {"norm": n, "silu": 0, "mlp": n, "attn_out": 0}


def test_sr_remat_on_off_bit_identical_fused(interpret, monkeypatch):
    """With SR on the fused layer (the grouped pipeline forced, at B * S =
    256 so that the o-projection is a fused op too), a key fixes every draw:
    the same key gives the same loss and grads bit for bit, with per-layer
    remat (the forward's B7 and B14 replayed in the backward with the
    layer's key, B9-row's column maxima kept from the forward under the
    policy) and without it; another key gives other grads."""
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    counts = _count_applies(monkeypatch)
    rng = np.random.default_rng(5)
    tok, lab = (torch.from_numpy(rng.integers(0, KW["vocab_size"], (B, 2 * S))) for _ in range(2))
    runs = []
    for remat, key in ((True, 11), (True, 11), (True, 12), (False, 11)):
        cfg = llama.LlamaConfig(**KW, remat=remat, attention_impl="xla")
        raw = llama.init_params(torch.Generator().manual_seed(4), cfg, dtype=torch.float32)
        params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
        loss, grads = train.loss_and_grads(cfg, params, tok, lab, key)
        runs.append((loss, tree_leaves(grads)))
    # one apply of each op per layer, the three remat runs replaying each forward
    n = (3 * 2 + 1) * KW["num_hidden_layers"]
    assert counts == {"norm": n, "silu": 0, "mlp": n, "attn_out": n}
    for i in (1, 3):
        assert torch.equal(runs[i][0], runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[i][1], runs[0][1]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[2][1], runs[0][1]))


@pytest.mark.parametrize("sr", [False, True])
def test_kernel_calls_per_step_fused(interpret, monkeypatch, sr):
    """The launch counts chip_smoke.py holds the card to on the fused
    layer, per layer of one remat train step, with the grouped pipeline
    (forced here, the default on the card) at B * S = 256: forward K1 7
    (the weights), K2 7, B7 2, B9-row 1, rope_group 3 (q, k, v),
    ungroup_amax 1 and ungroup_quant 1 (o's input), and the remat replay
    all of it but down's K1 and K2 and B9-row (the policy keeps B9-row's
    column maxima; no backward reads the layer's output); backward B5 5 (the
    output grads of q, k, v, o and down), B4 7 (the weights), B1 and B2 7
    each, B8 2, B9-col 1, B10 2, B11 1 and B12 1 ((dgate, dup)),
    ungroup_quant 1 (o's input along columns), rope_group 1 (o's input
    grad) and rope_ungroup 3 (the grads of q, k, v). Under SR every
    quantize takes its SR form; B10 and B13 have none."""
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    counts = _counting(monkeypatch)
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision",
                                   stochastic_rounding=sr)
    opt = optim.adamw()
    rng = np.random.default_rng(2)
    tok, lab = (torch.from_numpy(rng.integers(0, KW["vocab_size"], (B, 2 * S))) for _ in range(2))
    train.make_train_step(cfg, opt)(train.init_train_state(params, opt), tok, lab, 3e-4, 0)
    L, t = KW["num_hidden_layers"], "_sr" if sr else ""
    expect = dict.fromkeys(ops.KERNELS, 0)
    expect.update({f"quantize_int8_rowwise{t}": 13 * L, f"quantize_int8_colwise{t}": 7 * L,
                   f"quantize_int8_both{t}": 5 * L, "scaled_mm_rhs_t": 13 * L, "scaled_mm": 7 * L,
                   "scaled_mm_lhs_t": 7 * L, f"rmsnorm_quant_rowwise{t}": 4 * L, f"silu_mul_quant_rowwise{t}": L,
                   f"rmsnorm_quant_colwise{t}": 2 * L, f"silu_mul_quant_colwise{t}": L, "rmsnorm_bwd": 2 * L,
                   f"silu_mul_bwd_quant_rowwise{t}": L, f"silu_mul_bwd_quant_colwise{t}": L, "rope_group": 7 * L,
                   "rope_ungroup": 3 * L, "ungroup_amax": 2 * L, f"ungroup_quant{t}": 3 * L})
    assert counts == expect
