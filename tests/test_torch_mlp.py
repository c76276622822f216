"""The one-op MLP on the CPU: the plain versions of B11/B12
(``ops/fused_producers.py``) and ``quant.mlp_linear``'s one-op path
(``quant/fused.py::_MLPMM``) against the JAX package's Pallas kernels in
interpret mode and its ``_mlp_mm`` (both packages under
``set_impl('interpret')``), on the same numpy inputs. Mirrors
tests/test_fused.py:478-560 at M 128-256.

Bounds, each above the floor it is stated with:

- B11/B12: int8 within one step on at most 1e-3 of the elements, scales and
  column maxima within 1e-5 relative, the copies of (da, db) within one ulp
  of their dtype at the largest value (2**-8 in bf16, 1e-6 in fp32).
  Measured: the int8 equal, scales and maxima within 1.8e-7 relative, the
  copies equal in bf16 and 1.1e-7 of the largest apart in fp32 (JAX's
  sigmoid against 1 / (1 + exp(-a)));
- the SR forms in distribution: every q is floor(r) or floor(r) + 1 and the
  mean over 100 keys is within 0.3 of r everywhere, 6e-3 on average (about
  6 standard errors); the Pallas SR bodies draw from the TPU's generator,
  which interpret mode does not run;
- ``mlp_linear`` against JAX's: loss within 1e-3, output and every gradient
  within 3e-2 of their max (the fused ops' bounds of tests/test_torch_fused.py,
  whose floor, JAX against itself with the input moved by one ulp, is
  2.2e-2 in bf16). Measured: loss 3.0e-6, output and gradients 7.4e-4 at
  worst;
- against the port's own two-op composite (``norm_linear_multi`` +
  ``silu_mul_linear``, which round (dgate, dup) to bf16 before quantizing
  them): loss within 2e-2, gradients within 6e-2 of their max
  (tests/test_fused.py's bounds). Measured: the loss equal (one forward
  computation), gradients 1.1e-2 apart in bf16, 1.7e-7 in fp32.
"""

import jax
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.ops import pallas_fused as pf
from quantized_training_tpu_torch import ops, quant
from quantized_training_tpu_torch.ops import fused_producers as fp
from test_torch_fused import EPS, _arr, _count_applies, _max_rel, _q_close, _rel_close, interpret  # noqa: F401

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)


def _copy_close(got, want, dtn, what):
    """Within one ulp of the dtype at the largest value: where 1 + a * (1 -
    s) cancels, da's relative difference grows, not its absolute one."""
    d = _max_rel(got.float().numpy(), np.asarray(want, np.float32))
    assert d <= (2.0**-8 if dtn == "bf16" else 1e-6), (what, d)


@pytest.mark.parametrize("M,K", [(128, 256), (256, 640)])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_silu_bwd_quant_vs_pallas(dtn, M, K):
    """B11 with the column absmax and with the (da, db) copies, and B12
    given B11's column scales, the plain versions against the Pallas kernels
    in interpret mode; an all-zero column of dy quantizes to 0."""
    aj, at = _arr((M, K), 30, dtn, 2.0)
    bj, bt = _arr((M, K), 31, dtn)
    dyj, dyt = _arr((M, K), 32, dtn)
    dyj, dyt = dyj.at[:, 3].set(0), dyt.clone()
    dyt[:, 3] = 0
    want = pf.silu_mul_bwd_quant_rowwise(aj, bj, dyj, interpret=True)
    got = fp.silu_mul_bwd_quant_rowwise(at, bt, dyt)
    assert [tuple(t.shape) for t in got] == [(M, K), (M, 1), (M, K), (M, 1), (1, K), (1, K)]
    assert all(t.dtype == torch.float32 for t in got[1::2])
    for i, name in enumerate(("da q", "da scale", "db q", "db scale", "da column absmax", "db column absmax")):
        if i in (0, 2):
            _q_close(got[i], want[i], f"B11 {name}")
        else:
            _rel_close(got[i], want[i], 1e-5, f"B11 {name}")
    assert not got[0][:, 3].any() and not got[2][:, 3].any()
    copies = fp.silu_mul_bwd_quant_rowwise(at, bt, dyt, with_amax=False, with_bf16=True)
    copies_j = pf.silu_mul_bwd_quant_rowwise(aj, bj, dyj, interpret=True, with_amax=False, with_bf16=True)
    for i in range(4):
        assert torch.equal(copies[i], got[i])
    for t, j, name in zip(copies[4:], copies_j[4:], ("da", "db")):
        assert t.dtype == at.dtype
        _copy_close(t, j, dtn, f"B11 {name} copy")
    cols = fp.silu_mul_bwd_quant_colwise(at, bt, dyt, got[4] * (1.0 / 127.0), got[5] * (1.0 / 127.0))
    cols_j = pf.silu_mul_bwd_quant_colwise(aj, bj, dyj, want[4] * (1.0 / 127.0), want[5] * (1.0 / 127.0),
                                           interpret=True)
    for t, j, name in zip(cols, cols_j, ("da", "db")):
        _q_close(t, j, f"B12 {name} q")


def test_silu_bwd_column_scales_are_the_two_pass_scales():
    """B11's column maxima give B12 the scales of a two-pass column
    quantize of the same fp32 (da, db): B12 equals quantize along columns
    of silu_mul_bwd_f32 bit for bit."""
    _, a = _arr((256, 384), 33, "bf16", 2.0)
    _, b = _arr((256, 384), 34, "bf16")
    _, dy = _arr((256, 384), 35, "bf16")
    amax = fp.silu_mul_bwd_quant_rowwise(a, b, dy)[4:]
    cols = fp.silu_mul_bwd_quant_colwise(a, b, dy, *(m * (1.0 / 127.0) for m in amax))
    for q, v in zip(cols, fp.silu_mul_bwd_f32(a, b, dy)):
        assert torch.equal(q, fp._quant_cols(v, None, fp.EPS, False, None)[0])


N_KEYS = 100


@pytest.mark.parametrize("form", ["row", "col"])
def test_silu_bwd_sr_deterministic_and_unbiased(form):
    """The SR forms of B11 and B12: a key repeats its draw and another key
    draws another; every q is floor(r) or floor(r) + 1 for r = v * (1 /
    scale), and the mean over 100 keys is close to r; db's noise is the
    words after da's (M * K on)."""
    _, a = _arr((64, 256), 36, "f32", 2.0)
    _, b = _arr((64, 256), 37, "f32")
    _, dy = _arr((64, 256), 38, "f32")
    das, dbs = fp.silu_mul_bwd_f32(a, b, dy)
    if form == "row":
        rn = fp.silu_mul_bwd_quant_rowwise(a, b, dy)
        scales = (rn[1], rn[3])
        draw = lambda k: [fp.silu_mul_bwd_quant_rowwise(a, b, dy, sr=True, key=k)[i] for i in (0, 2)]
    else:
        scales = tuple(v.abs().amax(0, keepdim=True) * (1.0 / 127.0) for v in (das, dbs))
        draw = lambda k: list(fp.silu_mul_bwd_quant_colwise(a, b, dy, *scales, sr=True, key=k))
    draws = [draw(1000 + k) for k in range(N_KEYS)]
    for i, (v, scale) in enumerate(zip((das, dbs), scales)):
        s = scale.clamp(min=1e-12)
        r = (v * (torch.ones_like(s) / s)).double().numpy()
        qs = np.stack([d[i].numpy() for d in draws]).astype(np.float64)
        lo = np.clip(np.floor(r), -128, 127)
        assert ((qs == lo) | (qs == np.clip(lo + 1, -128, 127))).all()
        dev = qs.mean(0) - r
        assert np.abs(dev).max() < 0.3 and abs(dev.mean()) < 6e-3, (np.abs(dev).max(), dev.mean())
    assert all(torch.equal(x, y) for x, y in zip(draw(1000), draws[0]))
    assert not torch.equal(draws[0][0], draws[1][0])
    u = ops.random.uniform(1000, (2, 64, 256))
    for q, v, scale, noise in zip(draws[0], (das, dbs), scales, u):
        assert torch.equal(q, torch.floor(v * (1 / scale.clamp(min=1e-12)) + noise).clamp(-128, 127).to(torch.int8))
    with pytest.raises(ValueError, match="requires a key"):
        fp.silu_mul_bwd_quant_rowwise(a, b, dy, sr=True)


def test_supported_bounds_three_inputs():
    """supported() with three inputs holds B11's four fp32 rows of K in 227
    KB of shared memory: K <= 14528."""
    assert fp.supported(256, 5632, torch.bfloat16, n_inputs=3)
    assert fp.supported(256, fp.MAX_K_BWD - fp.MAX_K_BWD % 128, torch.bfloat16, n_inputs=3)
    assert not fp.supported(256, 14592, torch.bfloat16, n_inputs=3)
    assert fp.supported(256, 14592, torch.bfloat16, n_inputs=2)


# ---- mlp_linear's one-op path against JAX's _mlp_mm --------------------------------------------


def _mlp_inputs(dtn, gw, seed):
    specs = [((2, 64, 256), 1.0, 0.0), ((256,), 0.1, 1.0), ((384, 256), 0.05, 0.0), ((384, 256), 0.05, 0.0),
             ((256, 384), 0.05, 0.0)]
    arrs = [_arr(shape, seed + i, dtn, sc, off) for i, (shape, sc, off) in enumerate(specs)]
    return ([j for j, _ in arrs], [t for _, t in arrs], jquant.MixedPrecisionConfig(grad_weight=gw),
            quant.MixedPrecisionConfig(grad_weight=gw))


def _torch_mlp(ts, cfg, key, two_op=False):
    ts = [t.clone().requires_grad_(True) for t in ts]
    ws = [quant.MixedPrecisionWeight(w, cfg) for w in ts[2:]]
    if two_op:
        gate, up = quant.norm_linear_multi(ts[0], ts[1], ws[:2], EPS, key=ops.random.fold_in(key, 0))
        out = quant.silu_mul_linear(gate, up, ws[2], key=ops.random.fold_in(key, 1))
    else:
        out = quant.mlp_linear(ts[0], ts[1], *ws, EPS, key=key)
    loss = (out.float() ** 2).sum()
    return loss.item(), out.detach().float().numpy(), [g.float().numpy() for g in torch.autograd.grad(loss, ts)]


@pytest.mark.parametrize("dtn,gw", [("bf16", True), ("bf16", False), ("f32", True)],
                         ids=["bf16-all_int8", "bf16-gi_only", "f32-all_int8"])
def test_mlp_linear_vs_jax(dtn, gw, interpret, monkeypatch):
    """mlp_linear on its one-op path in both packages (the port's _MLPMM,
    JAX's _mlp_mm): the loss, the output and the gradients of x, gamma and
    the three weights, for an int8 grad_weight (B11 with the column absmax,
    B12) and a bf16 one (B11's copies); then the port's one-op path against
    its two-op composite."""
    counts = _count_applies(monkeypatch)
    js, ts, jcfg, tcfg = _mlp_inputs(dtn, gw, 60)

    def jrun(*a):
        ws = [jquant.MixedPrecisionWeight(w, jcfg) for w in a[2:]]
        out = jquant.mlp_linear(a[0], a[1], *ws, EPS, key=jax.random.PRNGKey(7))
        return (out.astype(np.float32) ** 2).sum(), out

    (jl, jout), jg = jax.value_and_grad(jrun, argnums=tuple(range(5)), has_aux=True)(*js)
    tl, tout, tg = _torch_mlp(ts, tcfg, 7)
    assert counts == {"norm": 0, "silu": 0, "mlp": 1, "attn_out": 0}
    assert abs(tl - float(jl)) <= 1e-3 * abs(float(jl))
    for got, want in [(tout, jout), *zip(tg, jg)]:
        assert got.shape == np.shape(want) and _max_rel(got, want) <= 3e-2, _max_rel(got, want)
    ul, _, ug = _torch_mlp(ts, tcfg, 7, two_op=True)
    assert counts == {"norm": 1, "silu": 1, "mlp": 1, "attn_out": 0}
    assert abs(tl - ul) <= 2e-2 * abs(ul)
    for got, want in zip(tg, ug):
        assert _max_rel(got, want) <= 6e-2, _max_rel(got, want)


def test_mlp_linear_sr_repeats_per_key(interpret, monkeypatch):
    """With SR the one-op MLP draws every noise from the key: the same key
    gives the same output and gradients bit for bit, another key others."""
    counts = _count_applies(monkeypatch)
    _, ts, _, _ = _mlp_inputs("f32", True, 70)
    cfg = quant.MixedPrecisionConfig(stochastic_rounding=True)
    runs = [_torch_mlp(ts, cfg, k) for k in (3, 3, 4)]
    assert counts["mlp"] == 3
    assert runs[0][0] == runs[1][0] and all(np.array_equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
    assert not all(np.array_equal(a, b) for a, b in zip(runs[0][2], runs[2][2]))
    with pytest.raises(ValueError, match="requires a key"):
        quant.mlp_linear(ts[0], ts[1], *(quant.MixedPrecisionWeight(w, cfg) for w in ts[2:]), EPS)
