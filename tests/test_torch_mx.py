"""The port's MX / NVFP4 numerics (``ops/mx.py``) against the JAX package's
``ops/mx.py`` on the CPU, on the same seeded numpy inputs: every quantize,
scale and packing bit for bit (fp8 and E8M0 compared as their raw bytes),
including values at and beyond each format's maximum and at the E2M1
rounding ties; the dequantizes exactly; ``mxfp4_mm`` / ``nvfp4_mm`` within
the bound of an fp32 sum in any order (``ops/matmul.py::fp32_sum_bound``,
in float64, of the dequantized operands), since the port's product is B17's
plain version (a float64 sum rounded once) where JAX sums in fp32. Then
tests/test_mx.py mirrored on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import mx as jmx
from quantized_training_tpu_torch.ops import mx
from quantized_training_tpu_torch.ops.matmul import fp32_sum_bound

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

_JDT = {"fp4": "fp4", "e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2}
_TDT = {"fp4": "fp4", "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# the E2M1 ties and thresholds, the grid, each format's maximum and beyond
SPECIAL = [0.0, -0.0, 0.25, 0.2500001, 0.75, 0.7499999, 1.25, 1.75, 2.5, 3.5, 5.0, 5.0000005, 6.0, 7.0, 448.0,
           464.0, 500.0, 57344.0, 61440.0, 1e5, 1e-30, 1e-40, -6.0, -448.0, -57344.0]


def _inputs(shape, seed, special=True):
    """Seeded normals at three magnitudes, the special values sprinkled in."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, (shape[0], 1))).astype(np.float32)
    if special:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, len(SPECIAL), replace=False)
        flat[idx] = SPECIAL
        x[0, :32] = SPECIAL[: len(SPECIAL)] + [0.0] * (32 - len(SPECIAL))  # one block of them alone
    return x


def _raw(a) -> np.ndarray:
    """An array's bytes: fp8 and E8M0 as uint8, fp32 as int32 bits."""
    a = np.asarray(a)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _traw(t: torch.Tensor) -> np.ndarray:
    if t.element_size() == 1:
        return t.view(torch.uint8).numpy()
    return t.view(torch.int32).numpy() if t.dtype == torch.float32 else t.numpy()


def test_scale_functions_and_codes_bit_exact():
    x = _inputs((16, 128), 0)
    amax = np.abs(x).reshape(16, -1, 32).max(-1)
    for dt in ("fp4", "e4m3", "e5m2"):
        for jf, tf in ((jmx.absmax_to_mx_scales_ocp, mx.absmax_to_mx_scales_ocp),
                       (jmx.absmax_to_mx_scales_nv, mx.absmax_to_mx_scales_nv)):
            assert np.array_equal(np.asarray(jf(jnp.asarray(amax), _JDT[dt])),
                                  tf(torch.from_numpy(amax), _TDT[dt]).numpy()), (dt, jf.__name__)
    for v in (x, np.asarray(SPECIAL, np.float32)):
        assert np.array_equal(np.asarray(jmx.fp32_to_fp4e2m1(jnp.asarray(v))),
                              mx.fp32_to_fp4e2m1(torch.from_numpy(v)).numpy())
    codes = np.random.default_rng(1).integers(0, 16, (4, 64)).astype(np.int32)
    packed = mx.pack_fp4(torch.from_numpy(codes))
    assert np.array_equal(np.asarray(jmx.pack_fp4(jnp.asarray(codes))), packed.numpy())
    assert packed[0, 0].item() == (codes[0, 0] | (codes[0, 1] << 4))  # the even element low
    assert np.array_equal(mx.unpack_fp4(packed).numpy(), codes)


@pytest.mark.parametrize("method", ["ocp", "nv"])
@pytest.mark.parametrize("dt", ["fp4", "e4m3", "e5m2"])
def test_quantize_mx_bit_exact(dt, method):
    x = _inputs((32, 256), 2)
    jq, js = jmx.quantize_mx(jnp.asarray(x), _JDT[dt], method)
    tq, ts = mx.quantize_mx(torch.from_numpy(x), _TDT[dt], method)
    assert ts.dtype == torch.float8_e8m0fnu and tuple(ts.shape) == (32, 8)
    assert np.array_equal(_raw(js), _traw(ts))
    assert np.array_equal(_raw(jq), _traw(tq))
    if dt == "fp4":
        assert np.array_equal(np.asarray(jmx.dequantize_mxfp4(jq, js)).view(np.int32),
                              mx.dequantize_mxfp4(tq, ts).view(torch.int32).numpy())


@pytest.mark.parametrize("given", [False, True])
def test_quantize_nvfp4_bit_exact(given):
    x = _inputs((32, 256), 3)
    x[5] *= 1e4  # a row far above the rest: its block scales meet e4m3's maximum
    ts_in = np.float32(0.37) if given else None
    jq, js, jts = jmx.quantize_nvfp4(jnp.asarray(x), None if ts_in is None else jnp.float32(ts_in))
    tq, ts, tts = mx.quantize_nvfp4(torch.from_numpy(x), ts_in)
    assert ts.dtype == torch.float8_e4m3fn
    assert np.array_equal(_raw(jts), tts.view(torch.int32).numpy())
    assert np.array_equal(_raw(js), _traw(ts)) and np.array_equal(_raw(jq), _traw(tq))
    assert np.array_equal(np.asarray(jmx.dequantize_nvfp4(jq, js, jts)).view(np.int32),
                          mx.dequantize_nvfp4(tq, ts, tts).view(torch.int32).numpy())


@pytest.mark.parametrize("dt", ["e4m3", "e8m0", "f32"])
def test_pack_block_scales_nv_bit_exact(dt):
    s = np.random.default_rng(4).uniform(2**-10, 400.0, (256, 8)).astype(np.float32)
    if dt == "e4m3":
        j, t = jnp.asarray(s, jnp.float8_e4m3fn), torch.from_numpy(s).to(torch.float8_e4m3fn)
    elif dt == "e8m0":
        bits = np.random.default_rng(5).integers(100, 150, (256, 8)).astype(np.uint8)
        j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.float8_e8m0fnu)
        t = torch.from_numpy(bits).view(torch.float8_e8m0fnu)
    else:
        j, t = jnp.asarray(s), torch.from_numpy(s)
    got = mx.pack_block_scales_nv(t)
    assert got.dtype == t.dtype and np.array_equal(_raw(jmx.pack_block_scales_nv(j)), _traw(got))


def _product_close(got, want, af, bf, scale=1.0):
    want = np.asarray(want, np.float64)
    bound = fp32_sum_bound(af, bf.T).numpy() * abs(scale) + 2.0**-23 * np.abs(want)
    assert (np.abs(got.double().numpy() - want) <= bound).all()


@pytest.mark.parametrize("bias", [False, True])
def test_fp4_products_vs_jax(bias):
    """mxfp4_mm and nvfp4_mm, fp32 out, with and without a bias: within
    the fp32-sum bound of JAX's (plus one fp32 rounding of the epilogue)."""
    rng = np.random.default_rng(6)
    a, b_t = rng.standard_normal((48, 256)).astype(np.float32), rng.standard_normal((40, 256)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32) if bias else None
    jb, tb = (None, None) if b is None else (jnp.asarray(b), torch.from_numpy(b))
    aq, sa = mx.quantize_mx(torch.from_numpy(a), "fp4")
    bq, sb = mx.quantize_mx(torch.from_numpy(b_t), "fp4")
    jaq, jsa = jmx.quantize_mx(jnp.asarray(a), "fp4")
    jbq, jsb = jmx.quantize_mx(jnp.asarray(b_t), "fp4")
    got = mx.mxfp4_mm(aq, bq, sa, sb, tb, out_dtype=torch.float32)
    want = jmx.mxfp4_mm(jaq, jbq, jsa, jsb, jb, out_dtype=jnp.float32)
    _product_close(got, want, mx.dequantize_mxfp4(aq, sa), mx.dequantize_mxfp4(bq, sb))
    aq, sa, tsa = mx.quantize_nvfp4(torch.from_numpy(a))
    bq, sb, tsb = mx.quantize_nvfp4(torch.from_numpy(b_t))
    jaq, jsa, jtsa = jmx.quantize_nvfp4(jnp.asarray(a))
    jbq, jsb, jtsb = jmx.quantize_nvfp4(jnp.asarray(b_t))
    got = mx.nvfp4_mm(aq, bq, sa, sb, tsa * tsb, tb, out_dtype=torch.float32)
    want = jmx.nvfp4_mm(jaq, jbq, jsa, jsb, jtsa * jtsb, jb, out_dtype=jnp.float32)
    unit = lambda q, s: mx.dequantize_nvfp4(q, s, 1.0)  # the codes times the block scales
    _product_close(got, want, unit(aq, sa), unit(bq, sb), (tsa * tsb).item())
    (aq, sa), (bq, sb) = mx.quantize_mx(torch.from_numpy(a), "fp4"), mx.quantize_mx(torch.from_numpy(b_t), "fp4")
    bf16 = mx.mxfp4_mm(aq, bq, sa, sb)
    assert bf16.dtype == torch.bfloat16 and tuple(bf16.shape) == (48, 40)


def test_unsupported_arguments_raise():
    x = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="element type"):
        mx.quantize_mx(x, torch.int8)
    with pytest.raises(ValueError, match="compute_scale_method"):
        mx.quantize_mx(x, "fp4", "floor")
    with pytest.raises(TypeError, match="fp32"):
        mx.absmax_to_mx_scales_ocp(x.to(torch.bfloat16), "fp4")
    with pytest.raises(ValueError, match="M % 128"):
        mx.pack_block_scales_nv(torch.zeros(64, 8))


# ---- tests/test_mx.py on the port -------------------------------------------


def _f32_of(bits: torch.Tensor) -> torch.Tensor:
    return (bits << 23).to(torch.int32).view(torch.float32)


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale)


def test_fp4_exact_grid_values_and_thresholds():
    vals = torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.5, -6.0])
    assert torch.equal(mx.FP4E2M1_LUT[mx.fp32_to_fp4e2m1(vals).long()], vals)
    vals = torch.tensor([0.25, 0.26, 1.25, 1.26, 5.0, 5.01])
    assert mx.FP4E2M1_LUT[mx.fp32_to_fp4e2m1(vals).long()].tolist() == [0.0, 0.5, 1.0, 1.5, 4.0, 6.0]


def test_mx_scales_ocp_floor_and_nv_round_up():
    assert _f32_of(mx.absmax_to_mx_scales_ocp(torch.tensor([4.0, 6.0, 8.0, 2.0]), "fp4")).tolist() == [
        1.0, 1.0, 2.0, 0.5]
    assert _f32_of(mx.absmax_to_mx_scales_nv(torch.tensor([6.0, 12.0, 5.9, 3.0]), "fp4")).tolist() == [
        1.0, 2.0, 1.0, 0.5]


@pytest.mark.parametrize("method,bound", [("ocp", 0.15), ("nv", 0.2)])
def test_mxfp4_roundtrip(method, bound):
    x = _normal((8, 128), 0)
    xq, scales = mx.quantize_mx(x, "fp4", method)
    assert tuple(xq.shape) == (8, 64) and tuple(scales.shape) == (8, 4) and scales.dtype == torch.float8_e8m0fnu
    deq = mx.dequantize_mxfp4(xq, scales)
    assert ((deq - x).abs().mean() / x.abs().mean()).item() < bound


def test_mxfp8_roundtrip():
    x = _normal((8, 128), 1, 10.0)
    xq, scales = mx.quantize_mx(x, torch.float8_e4m3fn, "ocp")
    assert xq.dtype == torch.float8_e4m3fn and xq.shape == x.shape
    deq = xq.float().reshape(8, -1, 32) * _f32_of(scales.view(torch.uint8).to(torch.int32))[..., None]
    assert ((deq.reshape(x.shape) - x).abs().mean() / x.abs().mean()).item() < 0.05


def test_nvfp4_roundtrip_and_given_scale():
    x = _normal((16, 128), 3, 3.0)
    xq, scales, ts = mx.quantize_nvfp4(x)
    assert tuple(xq.shape) == (16, 64) and tuple(scales.shape) == (16, 8) and scales.dtype == torch.float8_e4m3fn
    assert ((mx.dequantize_nvfp4(xq, scales, ts) - x).abs().mean() / x.abs().mean()).item() < 0.12
    x = torch.ones(2, 32)
    xq, scales, ts = mx.quantize_nvfp4(x, torch.tensor(1.0 / 6.0))
    assert ts.item() == torch.tensor(1.0 / 6.0).item()
    torch.testing.assert_close(mx.dequantize_nvfp4(xq, scales, ts), x, rtol=0.2, atol=0)


def test_pack_block_scales_nv_shape():
    s = torch.arange(128 * 8, dtype=torch.float32).reshape(128, 8)
    packed = mx.pack_block_scales_nv(s)
    assert tuple(packed.shape) == (128 * 8,) and torch.equal(packed[:4], s[0, :4])


def test_fp4_products_match_the_dequant_oracle():
    a, b_t = _normal((16, 64), 10), _normal((8, 64), 11)
    aq, sa = mx.quantize_mx(a, "fp4")
    bq, sb = mx.quantize_mx(b_t, "fp4")
    ref = mx.dequantize_mxfp4(aq, sa) @ mx.dequantize_mxfp4(bq, sb).T
    torch.testing.assert_close(mx.mxfp4_mm(aq, bq, sa, sb, out_dtype=torch.float32), ref, rtol=2e-2, atol=1e-2)
    (oa, sa1), (ob, sb1) = mx.quantize_mx(torch.ones(4, 32), "fp4"), mx.quantize_mx(torch.ones(6, 32), "fp4")
    bias = torch.arange(6, dtype=torch.float32)
    diff = (mx.mxfp4_mm(oa, ob, sa1, sb1, bias, out_dtype=torch.float32)
            - mx.mxfp4_mm(oa, ob, sa1, sb1, out_dtype=torch.float32))
    torch.testing.assert_close(diff, bias.expand(4, 6), rtol=0, atol=1e-4)
    aq, sa, tsa = mx.quantize_nvfp4(a)
    bq, sb, tsb = mx.quantize_nvfp4(b_t)
    ref = mx.dequantize_nvfp4(aq, sa, tsa) @ mx.dequantize_nvfp4(bq, sb, tsb).T
    torch.testing.assert_close(mx.nvfp4_mm(aq, bq, sa, sb, tsa * tsb, out_dtype=torch.float32), ref, rtol=2e-2,
                               atol=1e-2)
