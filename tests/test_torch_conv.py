"""The port's convolutions (``ops/conv.py``) against the JAX package's
``ops/conv.py`` on the CPU, on the same seeded numpy inputs (NHWC / HWIO):
``int8_conv2d`` equals JAX's int32 output exactly over strides 1 and 2,
padding 0 and 1, kernels 1 and 3 and C = 3 (a contraction of 27, zero-padded
to 32) or 8; ``scaled_int8_conv2d`` equals JAX's bit for bit (the same fp32
product of the exact sum and the channel scale, one rounding to the output
dtype); the float ``conv2d`` within 1e-5 of JAX's largest output in fp32,
and, in bf16, within one bf16 rounding of it (2**-8 relative: both sum in
fp32, in other orders, and round once). Then tests/test_vit_conv.py's conv
cases mirrored on the port, the im2col layout, and the
``benchmark_conv2d`` entry point's ``--quick`` run at batch 1 on the CPU."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import conv as jconv
from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.ops import conv

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("C", [3, 8])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_convs_equal_jax(stride, padding, k, C):
    x, w = _int8((2, 9, 10, C), 1), _int8((k, k, C, 24), 2)
    want = np.asarray(jconv.int8_conv2d(jnp.asarray(x), jnp.asarray(w), stride, padding))
    got = conv.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), stride, padding)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    cs = np.random.default_rng(3).uniform(1e-3, 1e-1, 24).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32), (jnp.float16, torch.float16)):
        want = np.asarray(jconv.scaled_int8_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(cs), stride, padding,
                                                   out_dtype=jdt).astype(jnp.float32))
        got = conv.scaled_int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(cs), stride,
                                      padding, out_dtype=tdt)
        assert got.dtype == tdt and np.array_equal(got.float().numpy(), want), tdt


def test_int8_conv_sums_past_fp32():
    """C = 512 at 3 x 3: 4,608 products of -128 * -128 sum to 75,497,472,
    past fp32's exact integers; the port's sum is exact."""
    x = np.full((1, 3, 3, 512), -128, np.int8)
    w = np.full((3, 3, 512, 16), -128, np.int8)
    w[0, 0, 0, 0] = 127
    got = conv.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jconv.int8_conv2d(jnp.asarray(x), jnp.asarray(w)))
    assert got[0, 0, 0, 1].item() == 4608 * 128 * 128 and np.array_equal(got.numpy(), want)
    assert got[0, 0, 0, 0].item() == 4607 * 128 * 128 - 128 * 127


@pytest.mark.parametrize("dtn,tol", [("f32", 1e-5), ("bf16", 2.0**-8)])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_float_conv_vs_jax(dtn, tol, stride, padding):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 11, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtn]
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jconv.conv2d(jx, jw, stride, padding).astype(jnp.float32))
    got = conv.conv2d(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt),
                      torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt), stride, padding)
    assert got.dtype == tdt and got.shape == want.shape and got.is_contiguous()
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_conv2d_on_int8_is_the_int8_conv():
    x, w = _int8((1, 6, 6, 4), 5), _int8((3, 3, 4, 8), 6)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), padding=1)))


def test_im2col_order_and_padding():
    """The patches in (kh, kw, C) order, a patch's row of the padded
    input's window; the contraction padded with zero columns to 16."""
    x = torch.arange(2 * 5 * 4 * 3, dtype=torch.int32).reshape(2, 5, 4, 3).to(torch.int8)
    cols = conv.im2col(x, 3, 3, 2, 1, conv.K_ALIGN)
    assert tuple(cols.shape) == (2 * 3 * 2, 32) and cols.is_contiguous()
    assert not cols[:, 27:].any()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    b, i, j = 1, 2, 1  # output (i, j) of image b
    assert torch.equal(cols[b * 6 + i * 2 + j, :27], xp[b, 2 * i:2 * i + 3, 2 * j:2 * j + 3].reshape(-1))
    assert conv.im2col(x, 1, 1, 1, 0).data_ptr() != 0 and conv.out_hw(5, 4, 3, 3, 2, 1) == (3, 2)
    with pytest.raises(TypeError, match="int8"):
        conv.int8_conv2d(x.float(), x.float())


# ---- tests/test_vit_conv.py's conv cases on the port -------------------------


def test_int8_conv_exact_vs_numpy():
    x, w = _int8((2, 8, 8, 4), 7), _int8((3, 3, 4, 8), 8)
    out = ops.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=1, padding=1)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 8, 8, 8)
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros((2, 8, 8, 8), np.int64)
    for i in range(8):
        for j in range(8):
            ref[:, i, j, :] = np.einsum("bhwc,hwco->bo", xp[:, i:i + 3, j:j + 3, :], w.astype(np.int64))
    assert np.array_equal(out.numpy().astype(np.int64), ref)


def test_scaled_int8_conv():
    x, w = _int8((2, 8, 8, 4), 9), _int8((3, 3, 4, 8), 10)
    cs = torch.from_numpy(np.random.default_rng(11).uniform(0, 0.01, 8).astype(np.float32))
    out = ops.scaled_int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), cs, padding=1, out_dtype=torch.float32)
    ref = ops.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1).float() * cs.reshape(1, 1, 1, -1)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)


def test_strided():
    out = ops.int8_conv2d(torch.from_numpy(_int8((1, 16, 16, 3), 12)), torch.from_numpy(_int8((2, 2, 3, 5), 13)),
                          stride=2)
    assert tuple(out.shape) == (1, 8, 8, 5)


def test_benchmark_entry_point_quick_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "quantized_training_tpu_torch.benchmark_conv2d", "--cpu", "--quick",
                           "--batch", "1"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    first = lines.index("| B,H,W,Cin->Cout k s | bf16 ms | int8 ms | speedup |")
    assert [l.split(" | ")[0][2:] for l in lines[first + 2:first + 5]] == [
        "1,56,56,64->64 3 1", "1,56,56,64->128 3 2", "1,28,28,128->256 3 2"]
