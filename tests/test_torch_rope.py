"""The grouped-RoPE pipeline on the CPU: the plain versions of B13/B14
(``ops/rope.py``), the three differentiable wrappers, ``quant.
attn_out_linear`` and the grouped decoder layer, against the JAX package's
``ops/pallas_rope.py`` (its Pallas kernels in interpret mode),
``quant/fused.py::attn_out_linear`` and ``models/llama.py``'s grouped
layer (both packages under ``set_impl('interpret')`` and
``QT_FUSED_ROPE=force``), on the same numpy inputs. Mirrors
tests/test_rope.py and tests/test_llama_grouped.py.

Bounds, each above the floor it is stated with:

- B13 against the Pallas kernels: 1e-6 absolute in fp32 (values below 2 in
  magnitude), in bf16 one bf16 ulp or 1e-6. Measured: 1.2e-7 (one fp32
  ulp, on a quarter of the elements: the fp32 sum of the two products is
  contracted or not) and one bf16 ulp on 1.5e-5 of the elements, more
  ulps only where the sum cancels to below 1e-5.
  B14 exact: the absmax and the int8 of equal inputs are equal;
- the wrappers' gradients against autograd through the plain composite:
  1e-6 (the backward is the exact transpose of the rotation);
- ``attn_out_linear`` against JAX's: loss within 1e-3, output and gradients
  within 3e-2 of their max (the fused ops' bounds of
  tests/test_torch_fused.py); against the port's unfused composite: 2e-2 /
  6e-2 (tests/test_fused.py's). Measured: loss 3.3e-6 apart, output and
  gradients equal, against JAX; loss 1.2e-5, gradients 5.8e-3 against the
  composite;
- the grouped layer (loss and every gradient of a 2-layer model) against
  JAX's grouped layer: loss within 1e-3, every gradient leaf within 3e-2
  (fp32) and 6e-2 (bf16) relative RMS. The floor, JAX against itself with
  the embedding moved by one ulp (random sign): loss 3.9e-5 / 7.0e-5, leaves
  7.0e-3 to 2.2e-2 (fp32) and 2.3e-2 to 3.9e-2 (bf16), int8 rounding flips
  that every matmul carries on. Measured, the port against JAX: loss 3.8e-7
  / 8.1e-6, leaves at most 1.2e-2 / 3.0e-2, each below its leaf's floor;
- the grouped pipeline against the default one, unquantized fp32: loss
  1e-5 relative, gradients 2e-4 absolute (tests/test_llama_grouped.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.ops import pallas_rope as pr
from quantized_training_tpu.quant import fused as jfused
from quantized_training_tpu_torch import quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import rope
from quantized_training_tpu_torch.quant import fused
from quantized_training_tpu_torch.utils.tree import tree_leaves
from test_torch_fused import KW, _arr, _count_applies, _max_rel, _q_close, interpret  # noqa: F401

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

B, S, H, KV, HD = 2, 128, 8, 2, 64
G = H // KV


def _tables(scale=1.0):
    """fp32 rope tables [S, hd] as numpy, JAX and torch."""
    inv = 1.0 / (10000.0 ** (np.arange(0, HD, 2, dtype=np.float32) / HD))
    emb = np.outer(np.arange(S, dtype=np.float32), inv)
    emb = np.concatenate([emb, emb], -1)
    c, s = (np.cos(emb) * scale).astype(np.float32), (np.sin(emb) * scale).astype(np.float32)
    return (jnp.asarray(c), jnp.asarray(s)), (torch.from_numpy(c), torch.from_numpy(s))


def _bf16_ulps(a, b):
    """Distance of bf16 values in units in the last place."""
    def order(t):
        bits = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def _close(got, want, dtn):
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(jnp.float32)))
    assert got.shape == want.shape
    near = (got.float() - want).abs() <= 1e-6
    assert (near | (_bf16_ulps(got, want) <= 1) if dtn == "bf16" else near).all()


@pytest.mark.parametrize("kv", [KV, H])  # G = 4 and G = 1
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_group_and_ungroup_vs_pallas(dtn, kv):
    """B13's plain versions against rope_group_kernel / rope_ungroup_kernel
    in interpret mode, on the same pair-tiled tables (q's pre-scale folded
    in): the grouping, the ungrouping with rot^T and with rot, and the
    identity tables against no rotation; ungroup(group(x)) is x."""
    xj, xt = _arr((B, S, H, HD), 80, dtn)
    (cj, sj), (ct, st) = _tables(scale=0.5)
    c2j, s2j = pr.pair_tables(cj, sj)
    c2t, s2t = rope.pair_tables(ct, st)
    assert np.array_equal(c2t.numpy(), np.asarray(c2j)) and c2t.shape == (S, 2 * HD)
    gj = pr.rope_group_kernel(xj, c2j, s2j, kv=kv, interpret=True)
    gt = rope.rope_group_kernel(xt, c2t, s2t, kv=kv)
    assert gt.shape == (B, kv, H // kv, S, HD) and gt.dtype == xt.dtype
    _close(gt, gj, dtn)
    assert torch.equal(gt, rope.rope_group_ref(xt, ct, st, kv))  # pair-tiled or [S, hd] tables alike
    for inverse in (True, False):
        uj = pr.rope_ungroup_kernel(gj, c2j, s2j, inverse=inverse, interpret=True)
        ut = rope.rope_ungroup_kernel(gt, c2t, s2t, inverse=inverse)
        assert ut.shape == (B, S, H, HD) and ut.is_contiguous()
        _close(ut, uj, dtn)
    one, zero = torch.ones(S, HD), torch.zeros(S, HD)
    plain = rope.rope_group_kernel(xt, kv=kv)
    assert torch.equal(plain, rope.rope_group_kernel(xt, one, zero, kv=kv))
    assert torch.equal(rope.rope_ungroup_kernel(plain), xt)
    if dtn == "f32":  # rot^T undoes rot for unscaled tables
        c1, s1 = _tables()[1]
        back = rope.rope_ungroup_kernel(rope.rope_group_kernel(xt, c1, s1, kv=kv), c1, s1)
        assert (back - xt).abs().max() <= 1e-5


@pytest.mark.parametrize("kv", [KV, H])
def test_ungroup_amax_and_quant_vs_pallas(kv):
    """B14's plain versions against ungroup_amax / ungroup_quant in
    interpret mode: the row and column absmax and the int8 along both axes
    equal; a grouped input in [B, H, S, hd] memory and one in [B, S, H, hd]
    memory give the same results; the quantizes are quantize_int8 of the
    ungrouped view within one step on 1e-3 of the elements (a reciprocal
    multiply here, a division there)."""
    yj, yt = _arr((B, kv, H // kv, S, HD), 81, "bf16")
    rj, cj = pr.ungroup_amax(yj, interpret=True)
    bshd = rope.rope_group_kernel(rope.rope_ungroup_kernel(yt), kv=kv)  # the same values, other memory
    assert not bshd.is_contiguous()
    for y in (yt, bshd):
        r, c = rope.ungroup_amax(y)
        assert r.shape == (B, S, 1) and c.shape == (1, H * HD) and r.dtype == c.dtype == torch.float32
        assert np.array_equal(r.numpy(), np.asarray(rj)) and np.array_equal(c.numpy(), np.asarray(cj))
        for axis, sj, st in ((1, rj * (1.0 / 127.0), r * (1.0 / 127.0)), (0, cj * (1.0 / 127.0), c * (1.0 / 127.0))):
            qj = pr.ungroup_quant(yj, sj, axis=axis, interpret=True)
            q = rope.ungroup_quant(y, st, axis=axis)
            assert q.shape == (B, S, H * HD) and q.dtype == torch.int8
            assert np.array_equal(q.numpy(), np.asarray(qj))
    x2d = rope.rope_ungroup_kernel(yt).reshape(B * S, H * HD).float()
    r, c = rope.ungroup_amax(yt.float())
    for axis, scale in ((1, r), (0, c)):
        _q_close(rope.ungroup_quant(yt.float(), scale * (1.0 / 127.0), axis=axis).reshape(B * S, -1),
                 quant.quantize_int8(x2d, axis=axis)[0].numpy(), f"axis {axis}")


def test_ungroup_quant_sr_in_distribution():
    """The SR form of B14's quantize: a key repeats its draw; every q is
    floor(r) or floor(r) + 1 and the mean over 100 keys is within 0.3 of r
    everywhere and 6e-3 on average."""
    _, y = _arr((1, 2, 2, 16, HD), 82, "f32")
    r, _ = rope.ungroup_amax(y)
    s = r * (1.0 / 127.0)
    x2d = rope.rope_ungroup_kernel(y).reshape(16, -1)
    ratio = (x2d * (1 / s.reshape(16, 1))).double().numpy()
    qs = np.stack([rope.ungroup_quant(y, s, axis=1, sr=True, key=50 + k).reshape(16, -1).numpy()
                   for k in range(100)]).astype(np.float64)
    lo = np.floor(ratio)
    assert ((qs == lo) | (qs == np.clip(lo + 1, -128, 127))).all()
    dev = qs.mean(0) - ratio
    assert np.abs(dev).max() < 0.3 and abs(dev.mean()) < 6e-3
    assert torch.equal(rope.ungroup_quant(y, s, axis=1, sr=True, key=50).reshape(16, -1),
                       torch.from_numpy(qs[0]).to(torch.int8))
    with pytest.raises(ValueError, match="requires a key"):
        rope.ungroup_quant(y, s, axis=1, sr=True)


def test_wrappers_vjp_vs_autograd_and_jax():
    """rope_group, group_heads and ungroup_heads: outputs and gradients
    against autograd through the plain composites, and against JAX's
    custom_vjp wrappers."""
    xj, xt = _arr((B, S, H, HD), 83, "f32")
    wj, wt = _arr((B, KV, G, S, HD), 84, "f32")
    uj, ut = _arr((B, S, H, HD), 85, "f32")
    (cj, sj), (ct, st) = _tables(scale=HD**-0.5)
    cases = [
        (lambda x: rope.rope_group(x, ct, st, KV), lambda x: rope.rope_group_ref(x, ct, st, KV),
         lambda x: pr.rope_group(x, cj, sj, KV), xt, xj, wt, wj),
        (lambda x: rope.group_heads(x, KV), lambda x: x.permute(0, 2, 1, 3).reshape(B, KV, G, S, HD),
         lambda x: pr.group_heads(x, KV), xt, xj, wt, wj),
        (lambda y: rope.ungroup_heads(y, KV), lambda y: y.reshape(B, H, S, HD).permute(0, 2, 1, 3),
         lambda y: pr.ungroup_heads(y, KV), wt, wj, ut, uj),
    ]
    for fn, ref, jfn, x, xj_, w, wj_ in cases:
        grads = []
        for f in (fn, ref):
            xg = x.clone().requires_grad_(True)
            out = f(xg)
            (out * w).sum().backward()
            grads.append((out.detach(), xg.grad))
        assert torch.allclose(grads[0][0], grads[1][0], atol=1e-6)
        assert torch.allclose(grads[0][1], grads[1][1], atol=1e-6)
        jg = jax.grad(lambda v: jnp.sum(jfn(v) * wj_))(xj_)
        assert np.abs(grads[0][1].numpy() - np.asarray(jg)).max() <= 1e-6


def test_supported_heads_gates():
    assert rope._supported_heads(32, 8, 64, 2048) and rope._supported_heads(4, 1, 64, 8)
    assert not rope._supported_heads(32, 8, 64, 100)  # S % 8
    assert not rope._supported_heads(32, 8, 48, 2048)  # hd % 64
    assert not rope._supported_heads(6, 3, 64, 2048)  # G odd


# ---- attn_out_linear --------------------------------------------------------------------------


def _attn_out(out_g, w, cfg, key):
    out_g, w = out_g.clone().requires_grad_(True), w.clone().requires_grad_(True)
    o = quant.attn_out_linear(out_g, quant.MixedPrecisionWeight(w, cfg), KV, key=key)
    loss = (o.float() ** 2).sum()
    return loss.item(), o.detach().float().numpy(), [g.float().numpy() for g in torch.autograd.grad(loss, (out_g, w))]


@pytest.mark.parametrize("gw", [True, False], ids=["all_int8", "gi_only"])
def test_attn_out_linear_vs_jax(gw, interpret, monkeypatch):
    """attn_out_linear fused in both packages (B * S = 256): the loss, the
    output and the gradients of the grouped input and the weight against
    JAX's, for an int8 and a bf16 grad_weight; then against the port's
    unfused composite (ungroup_heads -> qlinear)."""
    counts = _count_applies(monkeypatch)
    jcalls = []
    monkeypatch.setattr(jfused, "_attn_out_mm", lambda *a, _f=jfused._attn_out_mm: jcalls.append(1) or _f(*a))
    gj, gt = _arr((B, KV, G, S, HD), 86, "bf16")
    wj, wt = _arr((256, H * HD), 87, "bf16", 0.05)
    jcfg, tcfg = jquant.MixedPrecisionConfig(grad_weight=gw), quant.MixedPrecisionConfig(grad_weight=gw)

    def jrun(g, w):
        o = jquant.attn_out_linear(g, jquant.MixedPrecisionWeight(w, jcfg), KV, key=jax.random.PRNGKey(9))
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (jl, jo), jgrads = jax.value_and_grad(jrun, argnums=(0, 1), has_aux=True)(gj, wj)
    tl, to, tgrads = _attn_out(gt, wt, tcfg, 9)
    assert counts["attn_out"] == 1 and len(jcalls) == 1
    assert abs(tl - float(jl)) <= 1e-3 * abs(float(jl))
    for got, want in [(to, jo), *zip(tgrads, jgrads)]:
        assert got.shape == np.shape(want) and _max_rel(got, want) <= 3e-2, _max_rel(got, want)
    fused.set_impl("off")
    ul, _, ugrads = _attn_out(gt, wt, tcfg, 9)
    assert counts["attn_out"] == 1
    assert abs(tl - ul) <= 2e-2 * abs(ul)
    for got, want in zip(tgrads, ugrads):
        assert _max_rel(got, want) <= 6e-2


def test_attn_out_linear_gates_and_sr(interpret, monkeypatch):
    """(B * S) % 256 (here 128) and plain weights take ungroup_heads ->
    qlinear, exactly; with SR the fused op repeats per key and its gradients
    are finite."""
    counts = _count_applies(monkeypatch)
    _, g = _arr((1, KV, G, S, HD), 88, "f32")
    _, w = _arr((128, H * HD), 89, "f32", 0.05)
    mp = quant.MixedPrecisionWeight(w, quant.MixedPrecisionConfig())
    ctx = rope.ungroup_heads(g, KV).reshape(1, S, H * HD)
    assert torch.equal(quant.attn_out_linear(g, mp, KV, key=3), quant.qlinear(ctx, mp, key=3))
    assert torch.equal(quant.attn_out_linear(g, w, KV), ctx @ w.T)
    assert counts["attn_out"] == 0
    sr = quant.MixedPrecisionWeight(w, quant.MixedPrecisionConfig(stochastic_rounding=True))
    g2 = torch.cat([g, g * 0.5]).requires_grad_(True)
    outs = [quant.attn_out_linear(g2, sr, KV, key=k) for k in (4, 4, 5)]
    assert counts["attn_out"] == 3
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    (grad,) = torch.autograd.grad((outs[0] ** 2).sum(), g2)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0


# ---- the grouped decoder layer ---------------------------------------------------------------


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_grouped_layer_vs_jax(dtn, interpret, monkeypatch):
    """The loss and every gradient of a 2-layer model (KW's widths, B = 2,
    S = 128) with the grouped pipeline forced in both packages: rope_group
    and group_heads, the grouped einsum attention, attn_out_linear and the
    one-op MLP on the fused path, each applied once per layer in both."""
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    counts = _count_applies(monkeypatch)
    jcalls = {"attn_out": 0, "mlp": 0}
    for name in jcalls:
        monkeypatch.setattr(jfused, f"_{name}_mm",
                            lambda *a, _f=getattr(jfused, f"_{name}_mm"), _n=name: jcalls.__setitem__(
                                _n, jcalls[_n] + 1) or _f(*a))
    jcfg = jllama.LlamaConfig(**KW, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, attention_impl="xla")
    assert jllama._use_grouped_rope(jcfg, S) and llama._use_grouped_rope(cfg, torch.zeros(1))
    jdt = jnp.float32 if dtn == "f32" else jnp.bfloat16
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jdt), "mixed_precision")
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    tok, lab = rng.integers(0, KW["vocab_size"], (B, S)), rng.integers(0, KW["vocab_size"], (B, S))
    jl, jg = jax.value_and_grad(lambda p: jllama.loss_fn(p, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                                                          key=jax.random.PRNGKey(1)))(jp)
    tl, tg = train.loss_and_grads(cfg, tp, torch.from_numpy(tok), torch.from_numpy(lab), 1)
    L = KW["num_hidden_layers"]
    # JAX's scan traces its layer once
    assert counts == {"norm": L, "silu": 0, "mlp": L, "attn_out": L} and jcalls == {"attn_out": 1, "mlp": 1}
    assert abs(tl.item() - float(jl)) <= 1e-3 * abs(float(jl))
    bound = 3e-2 if dtn == "f32" else 6e-2
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.double().numpy() - b) <= bound * np.linalg.norm(b)


def test_grouped_pipeline_matches_default(monkeypatch):
    """Unquantized fp32: the grouped pipeline (fp32 rotation folded with the
    pre-scale, grouped attention, ungroup_heads) gives the default
    pipeline's loss and gradients; _use_grouped_rope's gates."""
    cfg = dataclasses.replace(llama.LlamaConfig(**KW, attention_impl="xla"), remat=True)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    runs = []
    for flag in ("0", "force"):
        monkeypatch.setenv("QT_FUSED_ROPE", flag)
        loss, grads = train.loss_and_grads(cfg, params, tok, torch.roll(tok, -1, -1))
        runs.append((loss.item(), tree_leaves(grads)))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[0][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a - b).abs().max() <= 2e-4
    x = torch.zeros(1)
    monkeypatch.setenv("QT_FUSED_ROPE", "1")
    assert not llama._use_grouped_rope(cfg, x)  # the CPU resolves 'auto' and 'xla' to the einsum
    assert llama._use_grouped_rope(dataclasses.replace(cfg, attention_impl="sdpa"), x)
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    assert not llama._use_grouped_rope(dataclasses.replace(cfg, hidden_size=192, num_attention_heads=4), x)
    monkeypatch.setenv("QT_FUSED_ROPE", "0")
    assert not llama._use_grouped_rope(dataclasses.replace(cfg, attention_impl="sdpa"), x)
