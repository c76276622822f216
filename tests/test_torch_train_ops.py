"""The training slice's ops against the JAX package on the CPU: the column
and both-axes quantize (B4, B5), the grad_input and grad_weight GEMM forms
(B1, B2), the mixed-precision linears' backward, the chunked cross-entropy,
AdamW and the training utilities. Inputs come from numpy seeds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu.ops import cross_entropy as jce
from quantized_training_tpu.ops import pallas_mm, pallas_quant
from quantized_training_tpu.quant import MixedPrecisionConfig as JCfg
from quantized_training_tpu.quant import core as jcore
from quantized_training_tpu.quant import qlinear as jqlinear
from quantized_training_tpu.quant import qlinear_multi as jqlinear_multi
from quantized_training_tpu.quant import mixed_precision as jmp
from quantized_training_tpu.utils import train as jutils
from quantized_training_tpu_torch import optim, quant
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.ops import cross_entropy, int8_quant
from quantized_training_tpu_torch.ops import random as ops_random
from quantized_training_tpu_torch.quant import core
from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight
from quantized_training_tpu_torch.utils import train as tutils

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

# both ops packages export a function of the module's name
jmm = importlib.import_module("quantized_training_tpu.ops.scaled_mm")
scaled_mm = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _input(shape, dtn, seed=0, scale=3.0):
    """Random values with an all-zero row and an all-zero column."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    x[1] = 0.0
    x[:, 2] = 0.0
    xj = jnp.asarray(x, _JDT[dtn])
    return xj, _t(xj)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in fp32 ulps between two arrays of finite floats."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


# ---- B4 / B5: the column and both-axes quantize ----------------------------


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 128), (96, 256), (40, 200), (128, 512)])
def test_colwise_and_both_plain_bit_exact_vs_jax_core(shape, dtn):
    """Tolerance: none. B4's and B5's plain versions against
    core.quantize_int8(axis=0) and core.quantize_int8_both: absmax/127 in
    fp32, IEEE division, round-half-even, scale cast to x's dtype."""
    xj, xt = _input(shape, dtn)
    qj, sj = jcore.quantize_int8(xj, axis=0)
    qt, st = int8_quant.quantize_int8_colwise(xt)
    assert qt.dtype == torch.int8 and st.dtype == xt.dtype and st.shape == (1, shape[1])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))
    assert (qt[:, 2] == 0).all() and (qt[1] == 0).all()

    ref = jcore.quantize_int8_both(xj)
    for via in (int8_quant.quantize_int8_both(xt), core.quantize_int8_both(xt)):
        assert [tuple(v.shape) for v in via] == [tuple(r.shape) for r in ref]
        for got, want in zip(via, ref):
            np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 128), (256, 384)])
def test_colwise_and_both_within_one_lsb_of_pallas(shape, dtn):
    """Against the Pallas kernels in interpret mode (run as
    tests/test_pallas_quant.py runs them). They multiply by a reciprocal of
    127 where the port divides, so a scale may differ by 1 fp32 ulp (1 ulp
    of x's dtype once cast) and q by 1 LSB, on under 2% of elements."""
    xj, xt = _input(shape, dtn, seed=1, scale=2.0)
    pallas = {
        "colwise": (pallas_quant.quantize_int8_colwise(xj, interpret=True),
                    int8_quant.quantize_int8_colwise(xt)),
    }
    qr, sr, qc, sc = pallas_quant.quantize_int8_both(xj, interpret=True)
    tqr, tsr, tqc, tsc = int8_quant.quantize_int8_both(xt)
    pallas["both/rows"] = ((qr, sr), (tqr, tsr))
    pallas["both/cols"] = ((qc, sc), (tqc, tsc))
    for (qp, sp), (qt, st) in pallas.values():
        diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qp, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02
        sp_cast = _np(jnp.asarray(sp).astype(_JDT[dtn])).ravel()
        if dtn == "f32":
            assert _ulps(_np(st).ravel(), sp_cast) <= 1
        else:  # one bf16 ulp is 2**16 fp32 ulps
            assert _ulps(_np(st).ravel(), sp_cast) <= 1 << 16


# ---- B1 / B2: the grad_input (1,0) and grad_weight (0,0) GEMM forms ---------


def _int8_operands(dims, M, N, K, seed):
    rng = np.random.default_rng(seed)
    ash = (M, K) if dims[0] == 1 else (K, M)
    bsh = (K, N) if dims[1] == 0 else (N, K)
    a = rng.integers(-128, 128, ash).astype(np.int8)
    b = rng.integers(-128, 128, bsh).astype(np.int8)
    sa = (rng.random((M, 1)) * 0.01 + 1e-3).astype(np.float32)
    sb = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    return a, b, sa, sb


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("scales", ["f32", "bf16"])
@pytest.mark.parametrize("dims,M,N,K", [((1, 0), 40, 128, 256), ((1, 0), 128, 256, 64),
                                        ((0, 0), 128, 256, 128), ((0, 0), 96, 160, 192)])
def test_backward_forms_plain_bit_exact_vs_jax(dims, M, N, K, scales, out):
    """Tolerance: none. The plain (1,0) and (0,0) forms against JAX's
    scaled_mm_general on the CPU: the integer sum is exact on both sides and
    the epilogue (acc * sa) * sb runs in fp32 in the same order."""
    a, b, sa, sb = _int8_operands(dims, M, N, K, seed=M + N)
    sdt = _JDT[scales]
    ref = jmm.scaled_mm_general(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa, sdt), jnp.asarray(sb, sdt),
                                dims=dims, out_dtype=_JDT[out])
    args = (torch.from_numpy(a), torch.from_numpy(b), _t(jnp.asarray(sa, sdt)), _t(jnp.asarray(sb, sdt)))
    plain = scaled_mm.scaled_mm_plain if dims == (1, 0) else scaled_mm.scaled_mm_lhs_t_plain
    got = plain(*args, out_dtype=_TDT[out])
    assert got.shape == (M, N) and got.dtype == _TDT[out]
    np.testing.assert_array_equal(_np(got), _np(ref))
    via = scaled_mm.scaled_mm_general(*args, dims=dims, out_dtype=_TDT[out])
    assert torch.equal(via, got)


@pytest.mark.parametrize("dims", [(1, 0), (0, 0)])
def test_backward_forms_vs_pallas_interpret(dims):
    """Against pallas_mm.scaled_mm / scaled_mm_dims(dims=(0,0)) in interpret
    mode (as tests/test_pallas.py runs them), fp32 out. Both sum exactly in
    int32 and apply the same fp32 epilogue, so the bound is the epilogue's
    rounding: 1 ulp."""
    M, N, K = (200, 160, 384) if dims == (1, 0) else (160, 224, 320)
    a, b, sa, sb = _int8_operands(dims, M, N, K, seed=3)
    kw = dict(out_dtype=jnp.float32, block_m=128, block_n=128, block_k=128, interpret=True)
    if dims == (1, 0):
        pal = pallas_mm.scaled_mm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb), **kw)
        got = scaled_mm.scaled_mm(*map(torch.from_numpy, (a, b, sa, sb)), out_dtype=torch.float32)
    else:
        pal = pallas_mm.scaled_mm_dims(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa[:, 0]),
                                       jnp.asarray(sb[0]), dims=(0, 0), **kw)
        got = scaled_mm.scaled_mm_lhs_t(*map(torch.from_numpy, (a, b, sa, sb)), out_dtype=torch.float32)
    assert _ulps(got.numpy(), np.asarray(pal)) <= 1


def test_scaled_mm_modes():
    """Scalar and 1-D scales broadcast like [M, 1] / [1, N] ones; tile
    scales (the DeepSeek mode) take B15's path: with unit scales and one K
    block it is the row-scaled product, a K block under 128 is refused, and
    a device tensor reaches B15's wrapper, which refuses a non-CUDA one."""
    a, b, sa, sb = map(torch.from_numpy, _int8_operands((1, 0), 32, 64, 128, seed=4))
    full = scaled_mm.scaled_mm(a, b, torch.full((32, 1), 0.5), torch.full((1, 64), 0.25), out_dtype=torch.float32)
    assert torch.equal(scaled_mm.scaled_mm(a, b, torch.tensor(0.5), torch.tensor(0.25), out_dtype=torch.float32),
                       full)
    assert torch.equal(scaled_mm.scaled_mm(a, b, sa[:, 0], sb[0]), scaled_mm.scaled_mm(a, b, sa, sb))
    tile = scaled_mm.scaled_mm(a, b, torch.ones(2, 1), torch.ones(1, 1), out_dtype=torch.float32)  # [M/16, K/128]
    assert torch.equal(tile, scaled_mm.scaled_mm(a, b, torch.ones(32, 1), torch.ones(1, 64), out_dtype=torch.float32))
    with pytest.raises(ValueError, match="K quant block"):
        scaled_mm.scaled_mm(a, b, torch.ones(2, 2), torch.ones(2, 1))
    meta = [t.to("meta") for t in (a, b, torch.ones(2, 1), torch.ones(1, 1))]
    with pytest.raises(ValueError, match="^tile_scaled_mm: all operands must be on one CUDA device"):
        scaled_mm.scaled_mm(*meta)


def test_device_path_takes_the_kernels(monkeypatch):
    """A meta tensor takes the device path without a card: dims (1,0) and
    (0,0), the column quantize and the both-axes quantize, SR or not, reach
    their kernels' wrappers (B1, B2, B4, B5), which refuse a non-CUDA
    device; the plain versions, and the plain noise, are never called."""
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a device tensor")

    for mod, name in ((scaled_mm, "_plain"), (int8_quant, "quantize_int8_plain"),
                      (int8_quant, "quantize_int8_both_plain"), (core, "quantize_int8_plain"),
                      (ops_random, "uniform")):
        monkeypatch.setattr(mod, name, no_plain)
    a = torch.empty(32, 64, dtype=torch.int8, device="meta")
    s = torch.empty(64, 1, device="meta")
    with pytest.raises(ValueError, match="^scaled_mm: all operands must be on one CUDA device"):
        scaled_mm.scaled_mm_general(a, a.T.contiguous(), s[:32], s[:32].T, dims=(1, 0))
    with pytest.raises(ValueError, match="^scaled_mm_lhs_t: all operands"):
        scaled_mm.scaled_mm_general(a, a, s, s.T, dims=(0, 0))
    x = torch.empty(32, 64, device="meta")
    with pytest.raises(ValueError, match="^quantize_int8_colwise: needs a CPU or CUDA"):
        core.quantize_int8(x, axis=0)
    with pytest.raises(ValueError, match="^quantize_int8_both: needs a CPU or CUDA"):
        core.quantize_int8_both(x)
    seen = []
    kernel = core._quantize_both_kernel

    def recorded(x, **kw):
        seen.append(kw)
        return kernel(x, **kw)

    monkeypatch.setattr(core, "_quantize_both_kernel", recorded)
    with pytest.raises(ValueError, match="^quantize_int8_both: needs a CPU or CUDA"):
        core.quantize_int8_both(x, stochastic_rounding=True, key=5)
    assert seen == [dict(eps=int8_quant.EPS, sr=True, key=5)]
    with pytest.raises(ValueError, match="^quantize_int8_colwise: needs a CPU or CUDA"):
        core.quantize_int8(x, axis=0, stochastic_rounding=True, key=5)


# ---- the mixed-precision linears' backward ----------------------------------


def _linear_inputs(dtn, n_w, seed=0, tokens=64, d_in=256, outs=(128, 256, 384)):
    rng = np.random.default_rng(seed)
    dt = _JDT[dtn]
    x = jnp.asarray(rng.standard_normal((2, tokens // 2, d_in)), dt)
    ws = [jnp.asarray(rng.standard_normal((o, d_in)) * 0.02, dt) for o in outs[:n_w]]
    gs = [jnp.asarray(rng.standard_normal((2, tokens // 2, o)), dt) for o in outs[:n_w]]
    return x, ws, gs


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_mp_linear_backward_bit_exact_vs_jax_vjp(dtn):
    """Tolerance: none. _MPLinear against jax.vjp of the JAX _mp_linear
    (through qlinear): the int8 operands and scales of g, w and x are the
    same bits (B4/B5 plain versions above), the integer sums are exact and
    the epilogues run in the same order, so grad_input and grad_weight are
    equal bit for bit, as is the output."""
    x, (w,), (g,) = _linear_inputs(dtn, 1)
    out, vjp = jax.vjp(lambda xx, ww: jqlinear(xx, jmp.MixedPrecisionWeight(ww, JCfg())), x, w)
    gx, gw = vjp(g)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    yt = quant.qlinear(xt, MixedPrecisionWeight(wt, quant.MixedPrecisionConfig()))
    yt.backward(_t(g))
    np.testing.assert_array_equal(_np(yt.detach()), _np(out))
    np.testing.assert_array_equal(_np(xt.grad), _np(gx))
    np.testing.assert_array_equal(_np(wt.grad), _np(gw))


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("n_w", [2, 3])
def test_mp_linear_shared_backward_bit_exact_vs_jax_vjp(n_w, dtn):
    """Tolerance: none. qlinear_multi (one row quantize of the shared input
    forward, one column quantize backward, grad_input summed head by head in
    w.dtype in the JAX order) against jax.vjp of the JAX qlinear_multi."""
    x, ws, gs = _linear_inputs(dtn, n_w, seed=n_w)
    f = lambda xx, *wws: tuple(jqlinear_multi(xx, [jmp.MixedPrecisionWeight(w, JCfg()) for w in wws]))
    outs, vjp = jax.vjp(f, x, *ws)
    grads = vjp(tuple(gs))
    xt = _t(x).requires_grad_(True)
    wts = [_t(w).requires_grad_(True) for w in ws]
    cfg = quant.MixedPrecisionConfig()
    youts = quant.qlinear_multi(xt, [MixedPrecisionWeight(w, cfg) for w in wts])
    torch.autograd.backward(youts, [_t(g) for g in gs])
    for yo, o in zip(youts, outs):
        np.testing.assert_array_equal(_np(yo.detach()), _np(o))
    np.testing.assert_array_equal(_np(xt.grad), _np(grads[0]))
    for wt, gw in zip(wts, grads[1:]):
        np.testing.assert_array_equal(_np(wt.grad), _np(gw))


@pytest.mark.parametrize("toggles", [(True, False, True), (True, True, False), (False, True, True)])
def test_mp_linear_partial_configs_vs_jax(toggles):
    """Configs with one matmul in float take the JAX package's per-matmul
    branches (:201-215): each int8 matmul quantizes both operands along its
    contraction axis, the float one is a plain matmul. fp32, so the float
    matmuls differ only by the sum order: bound 1e-5 of the largest grad."""
    names = ("output", "grad_input", "grad_weight")
    x, (w,), (g,) = _linear_inputs("f32", 1, seed=7)
    jc = JCfg(**dict(zip(names, toggles)))
    _, vjp = jax.vjp(lambda xx, ww: jqlinear(xx, jmp.MixedPrecisionWeight(ww, jc)), x, w)
    gx, gw = vjp(g)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    quant.qlinear(xt, MixedPrecisionWeight(wt, quant.MixedPrecisionConfig(**dict(zip(names, toggles))))).backward(_t(g))
    for got, want in ((xt.grad, gx), (wt.grad, gw)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5 * np.abs(_np(want)).max())


# ---- the chunked cross-entropy ----------------------------------------------


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
@pytest.mark.parametrize("T,chunk", [(256, 128), (200, 4096)])
def test_fused_linear_cross_entropy_vs_jax(T, chunk, dtn):
    """nll_sum, n_valid, dx and dw against the JAX custom_vjp, with two
    chunks (T=256) and the single-chunk fallback (T=200, no divisor that is
    a multiple of 128), labels partly ignore_index. The logits are fp32 on
    both sides and differ only by sum order: nll_sum within 1e-5 relative;
    dx (rounded to x's dtype) and dw within 1e-5 of their largest value in
    fp32, one ulp of x's dtype in bf16."""
    rng = np.random.default_rng(T)
    dt = _JDT[dtn]
    x = jnp.asarray(rng.standard_normal((T, 64)), dt)
    w = jnp.asarray(rng.standard_normal((96, 64)) * 0.1, dt)
    labels = rng.integers(0, 96, T).astype(np.int32)
    labels[::7] = -100
    (nll, n), vjp = jax.vjp(lambda xx, ww: jce.fused_linear_cross_entropy(xx, ww, jnp.asarray(labels), -100, chunk),
                            x, w)
    dx, dw = vjp((jnp.float32(1.5), jnp.float32(0.0)))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    nt, vt = cross_entropy.fused_linear_cross_entropy(xt, wt, torch.from_numpy(labels).long(), -100, chunk)
    (nt * 1.5).backward()
    assert float(vt) == float(n) == float((labels != -100).sum())
    np.testing.assert_allclose(nt.item(), float(nll), rtol=1e-5)
    tol = 1e-5 if dtn == "f32" else 2 ** -7
    for got, want in ((xt.grad, dx), (wt.grad, dw)):
        assert got.dtype == _TDT[dtn]
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * np.abs(_np(want)).max())


def test_pick_chunk_matches_jax():
    for T in (1, 127, 128, 200, 256, 384, 8192, 8448, 24576):
        assert cross_entropy._pick_chunk(T) == jce._pick_chunk(T)


# ---- AdamW and the training utilities ----------------------------------------


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_adamw_two_steps_vs_jax(dtn):
    """Two steps of adamw() from a state carried over by
    adamw_state_from_jax, over a tree with a MixedPrecisionWeight. The fp32
    operations and their order are JAX's, but XLA rewrites some of them
    (a division by sqrt(bc2) into a multiply by its rsqrt) and its pow may
    round differently: exp_avg and exp_avg_sq agree within 4 ulps, and
    each param's change within 1e-4 of the learning rate (the size of an
    Adam update), plus one ulp of a bf16 param; the count matches."""
    rng = np.random.default_rng(5)
    dt = _JDT[dtn]
    mk = lambda *s: jnp.asarray(rng.standard_normal(s) * 0.05, dt)
    jparams = {"a": {"w": jmp.MixedPrecisionWeight(mk(128, 64), JCfg())}, "b": {"g": mk(64)}}
    jgrads = [{"a": {"w": jmp.MixedPrecisionWeight(mk(128, 64), JCfg())}, "b": {"g": mk(64)}} for _ in range(2)]
    jopt = joptim.adamw(weight_decay=1e-2)
    jstate = jopt.init(jparams)
    conv = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    tparams = conv(jparams)
    tstate = adamw_state_from_jax(jax.tree.map(np.asarray, jstate))
    topt = optim.adamw(weight_decay=1e-2)
    lr = 3e-3
    for jg in jgrads:
        jparams, jstate = jopt.step(jg, jstate, jparams, lr)
        tparams, tstate = topt.step(conv(jg), tstate, tparams, lr)
    assert tstate.count == int(jstate.count) == 2
    assert isinstance(tparams["a"]["w"], MixedPrecisionWeight)
    bf16_ulp = 0.0 if dtn == "f32" else 2.0 ** -7
    for tp, jp in ((tparams["a"]["w"].data, jparams["a"]["w"].data), (tparams["b"]["g"], jparams["b"]["g"])):
        assert tp.dtype == _TDT[dtn]
        want = _np(jp)
        assert (np.abs(_np(tp) - want) <= 1e-4 * lr + bf16_ulp * np.abs(want)).all()
    for tt, jt in ((tstate.exp_avg, jstate.exp_avg), (tstate.exp_avg_sq, jstate.exp_avg_sq)):
        assert tt["a"]["w"].data.dtype == torch.float32
        assert _ulps(tt["a"]["w"].data.numpy(), np.asarray(jt["a"]["w"].data)) <= 4
        assert _ulps(tt["b"]["g"].numpy(), np.asarray(jt["b"]["g"])) <= 4


def test_lr_schedule_and_global_norm_vs_jax():
    """LRSchedule equal at every step. global_norm and clip_by_global_norm
    sum each leaf in another order than XLA (about sqrt(n) ulps apart for n
    terms): within 2e-6 relative; bf16 leaves are clipped through fp32 as
    JAX promotes them, so the clipped values agree to one bf16 ulp."""
    for kw in (dict(warmup=0.1, decay=0.5), dict(warmup=0.0, decay=0.3, decay_type="cosine"), {}):
        js, ts = jutils.LRSchedule(1e-3, 100, **kw), tutils.LRSchedule(1e-3, 100, **kw)
        assert [js.get_lr(s) for s in range(105)] == [ts.get_lr(s) for s in range(105)]
    rng = np.random.default_rng(6)
    jt = {"b": jnp.asarray(rng.standard_normal((64, 32)), jnp.bfloat16),
          "a": {"x": jnp.asarray(rng.standard_normal(100), jnp.float32)}}
    tt = params_from_jax(jax.tree.map(np.asarray, jt))
    np.testing.assert_allclose(tutils.global_norm(tt).numpy(), np.asarray(jutils.global_norm(jt)), rtol=2e-6)
    jc, jn = jutils.clip_by_global_norm(jt, 1.0)
    tc, tn = tutils.clip_by_global_norm(tt, 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=2e-6)
    assert tc["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tc["b"]), _np(jc["b"]), rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(tc["a"]["x"].numpy(), np.asarray(jc["a"]["x"]), rtol=4e-6)
    same, n2 = tutils.clip_by_global_norm(tt, 1e6)  # under the bound: unchanged
    assert torch.equal(same["a"]["x"], tt["a"]["x"]) and torch.equal(n2, tn)
