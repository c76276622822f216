"""B19, the causal int8 flash-attention forward, on the CPU: the port's
``quantize_qkv``, ``attention_ref`` and B19's plain version
(ops/int8_attention.py) against the JAX package's (ops/int8_attention.py,
its Pallas kernel in interpret mode) on the same numpy inputs, and the
oracle checks of tests/test_int8_attention.py.

Tolerances, and why:
- ``quantize_qkv``: none (the same fp32 absmax, true division and
  round-half-even).
- B19's plain version against the JAX kernel: they run the same fp32
  operations in the same order except the row sum of p (XLA's order and
  torch's), and exponentials that may round differently. The row sum of at
  most S terms moves l by at most S * 2**-24 relative, so lse by at most
  S * 2**-24 + 2**-23 |lse|, and out by about that plus one bf16 step
  (2**-8 of the value); an exponential that rounds differently can flip one
  p_i8 at a round-half point, which moves out by at most pscale * 127 / l <=
  max(v_s) (pscale * 127 is the row's max of p * v_s, l >= 1). So: |out
  difference| <= max(v_s) + 2**-7 |ref|, on at most 1% of the elements.
- ``attention_ref``: fp32 scores and softmax in either framework, p and the
  output in bf16: within two bf16 steps (2**-7 of max |ref|).
- The oracle checks keep the JAX test's bounds: mean relative error below
  0.05 against the bf16 oracle, lse within 1e-4 of the explicit logsumexp.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.ops import int8_attention as jattn
from quantized_training_tpu_torch import ops

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

ATTN = importlib.import_module("quantized_training_tpu_torch.ops.int8_attention")
CASES = [(4, 256, 64, 128, 128), (2, 256, 64, 256, 128), (1, 128, 128, 128, 128)]  # G, S, hd, bq, bkv


def _qkv(G, S, hd, seed, lead=()):
    """bf16 q [*lead, G, S, hd], k and v [*lead, S, hd] as JAX arrays and
    torch tensors with the same values (q and k at 0.5 scale, as the JAX
    test)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((*lead, G, S, hd)) * 0.5, rng.standard_normal((*lead, S, hd)) * 0.5,
              rng.standard_normal((*lead, S, hd)))
    js = [jnp.asarray(x, jnp.bfloat16) for x in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16) for j in js]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


@pytest.mark.parametrize("G,S,hd", [(4, 256, 64), (1, 128, 128), (3, 64, 32)])
def test_quantize_qkv_same_bits_as_jax(G, S, hd):
    (jq, jk, jv), (tq, tk, tv) = _qkv(G, S, hd, seed=G + S)
    got, ref = ops.quantize_qkv(tq, tk, tv), jattn.quantize_qkv(jq, jk, jv)
    assert [tuple(t.shape) for t in got] == [(G, S, hd), (G, S, 1), (S, hd), (S,), (S, hd), (S,)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), _np(r))
        assert g.dtype == (torch.int8 if r.dtype == jnp.int8 else torch.float32)


def _hold(out, lse, jout, jlse, v_s):
    """The plain version against the JAX kernel, by the module's bounds
    (``ops/int8_attention.py::agreement``)."""
    ok, err, share = ATTN.agreement(out, lse, torch.from_numpy(_np(jout)), torch.from_numpy(_np(jlse)), v_s)
    assert ok, (err, share)


@pytest.mark.parametrize("G,S,hd,bq,bkv", CASES)
def test_plain_matches_jax_kernel(G, S, hd, bq, bkv):
    """The cases of tests/test_int8_attention.py::test_fwd_matches_oracle."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(G, S, hd, seed=0)
    jin, tin = jattn.quantize_qkv(jq, jk, jv), ops.quantize_qkv(tq, tk, tv)
    jout, jlse = jattn.int8_flash_fwd(*jin, block_q=bq, block_kv=bkv, interpret=True)
    out, lse = ops.int8_flash_fwd(*tin, block_q=bq, block_kv=bkv)
    assert out.dtype == torch.bfloat16 and out.shape == (G, S, hd)
    assert lse.dtype == torch.float32 and lse.shape == (G, S, 1)
    _hold(out, lse, jout, jlse, tin[5])


@pytest.mark.parametrize("G,S,hd,bq,bkv", CASES)
def test_oracle_checks(G, S, hd, bq, bkv):
    """The JAX test's checks on the port: mean relative error below 0.05
    against the bf16 oracle, lse against the explicit logsumexp of the
    quantized scores."""
    _, (q, k, v) = _qkv(G, S, hd, seed=0)
    qi, qs, ki, ks, vi, vs = ops.quantize_qkv(q, k, v)
    out, lse = ops.int8_flash_fwd(qi, qs, ki, ks, vi, vs, block_q=bq, block_kv=bkv)
    ref = ops.attention_ref(q, k, v).float()
    rel = (out.float() - ref).abs().mean() / ref.abs().mean()
    assert rel < 0.05, rel
    s = (qi.float() * qs) @ (ki.float() * ks[:, None]).T
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse[..., 0], torch.logsumexp(s, dim=-1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("G,S,hd", [(4, 256, 64), (1, 128, 128)])
def test_attention_ref_matches_jax(G, S, hd):
    (jq, jk, jv), (tq, tk, tv) = _qkv(G, S, hd, seed=3)
    ref = _np(jattn.attention_ref(jq, jk, jv))
    got = ops.attention_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2.0**-7 * np.abs(ref).max())


def test_causality():
    """Changing future tokens' k and v leaves earlier outputs bit-identical
    (tests/test_int8_attention.py::test_causality)."""
    G, S, hd = 2, 256, 64
    _, (q, k, v) = _qkv(G, S, hd, seed=1)

    def run(k, v):
        out, lse = ops.int8_flash_fwd(*ops.quantize_qkv(q, k, v), block_q=128, block_kv=128)
        return out, lse

    base = run(k, v)
    rng = np.random.default_rng(9)
    k2, v2 = k.clone(), v.clone()
    k2[200:] = torch.from_numpy(rng.standard_normal((56, hd))).to(torch.bfloat16)
    v2[200:] = torch.from_numpy(rng.standard_normal((56, hd))).to(torch.bfloat16)
    pert = run(k2, v2)
    assert torch.equal(base[0][:, :200], pert[0][:, :200]) and torch.equal(base[1][:, :200], pert[1][:, :200])
    assert not torch.equal(base[0][:, 200:], pert[0][:, 200:])


def test_block_kv_is_part_of_the_numerics():
    """p's row absmax runs over one kv block: the same inputs at block_kv 128
    and 256 give different outputs, and each matches JAX's kernel at the
    same block_kv; block_q changes no number."""
    G, S, hd = 2, 256, 64
    (jq, jk, jv), (tq, tk, tv) = _qkv(G, S, hd, seed=5)
    jin, tin = jattn.quantize_qkv(jq, jk, jv), ops.quantize_qkv(tq, tk, tv)
    outs = {}
    for bkv in (128, 256):
        jout, jlse = jattn.int8_flash_fwd(*jin, block_q=128, block_kv=bkv, interpret=True)
        outs[bkv] = ops.int8_flash_fwd(*tin, block_q=128, block_kv=bkv)
        _hold(*outs[bkv], jout, jlse, tin[5])
    assert not torch.equal(outs[128][0], outs[256][0])
    for bq in (64, 256):
        other = ops.int8_flash_fwd(*tin, block_q=bq, block_kv=128)
        assert torch.equal(other[0], outs[128][0]) and torch.equal(other[1], outs[128][1])


def test_leading_instance_dims_equal_a_loop():
    """Leading dims are instances (batch x kv heads): one call equals the
    calls of each instance, exactly."""
    G, S, hd = 2, 128, 64
    _, (q, k, v) = _qkv(G, S, hd, seed=7, lead=(2, 3))
    qkv = ops.quantize_qkv(q, k, v)
    out, lse = ops.int8_flash_fwd(*qkv, block_kv=64)
    assert out.shape == (2, 3, G, S, hd) and lse.shape == (2, 3, G, S, 1)
    for b in range(2):
        for h in range(3):
            o1, l1 = ops.int8_flash_fwd(*(t[b, h] for t in qkv), block_kv=64)
            assert torch.equal(out[b, h], o1) and torch.equal(lse[b, h], l1)


def test_non_causal_matches_jax_kernel():
    G, S, hd = 2, 128, 64
    (jq, jk, jv), (tq, tk, tv) = _qkv(G, S, hd, seed=11)
    jin, tin = jattn.quantize_qkv(jq, jk, jv), ops.quantize_qkv(tq, tk, tv)
    jout, jlse = jattn.int8_flash_fwd(*jin, causal=False, block_q=64, block_kv=64, interpret=True)
    _hold(*ops.int8_flash_fwd(*tin, causal=False, block_q=64, block_kv=64), jout, jlse, tin[5])


def test_shapes_and_blocks_are_checked():
    _, (q, k, v) = _qkv(2, 128, 64, seed=0)
    qkv = ops.quantize_qkv(q, k, v)
    with pytest.raises(ValueError, match="multiple of block_q"):
        ops.int8_flash_fwd(*qkv, block_q=96)
    with pytest.raises(ValueError, match="k_s"):
        ops.int8_flash_fwd(qkv[0], qkv[1], qkv[2], qkv[3][:64], qkv[4], qkv[5])


def test_cpu_path_counts_no_launch_and_other_devices_take_the_kernel():
    _, (q, k, v) = _qkv(1, 64, 64, seed=0)
    ops.reset_launch_counts()
    ops.int8_flash_fwd(*ops.quantize_qkv(q, k, v))
    assert ops.launch_counts()["int8_flash_fwd"] == 0
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ops.quantize_qkv(q, k, v)]
    with pytest.raises(ValueError, match="CUDA device"):
        ATTN.int8_flash_fwd(*meta)
