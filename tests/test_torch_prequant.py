"""Per-step weight pre-quantization in the port (``QT_PREQUANT``,
``quant/mixed_precision.py::PreQuantMPWeight``, ``quant/api.py::
prequantize_step``) against the JAX package's on the CPU, on the same numpy
inputs, and against the port's own dynamic path:

- the views of ``prequantize_weight`` (2-D and stacked [L, O, I]; 'both',
  'row', 'col'; round to nearest) equal JAX's bit for bit, and
  ``params_from_jax`` carries a JAX ``PreQuantMPWeight`` field for field;
- the pre-quantized linear and shared linear, output and both grads, equal
  JAX's bit for bit (the int8 sums are exact and the epilogues the same),
  and equal the port's dynamic linears bit for bit (JAX's
  tests/test_schemes.py::TestPreQuantizedWeights);
- the fused ops (one-op MLP, o-projection) on PreQuantMPWeights, in
  interpret mode in both packages: the port's equal its dynamic fused ops
  bit for bit and JAX's pre-quantized ones within tests/test_torch_fused.py's
  bounds (loss 1e-3, every output and grad 3e-2 of its max), JAX's
  tests/test_fused.py:664-720 case;
- the small Llama (2 layers, hidden 256, 128 tokens, remat) under
  ``QT_PREQUANT`` in {both, row, col} with the fused layer (interpret, the
  grouped pipeline forced) and without (``QT_FUSED=0``): the loss and every
  grad equal the default path's bit for bit, and one train step tracks
  JAX's step under the same knobs within tests/test_torch_train.py's bounds
  (loss 1e-3, grad norm 5e-3, worst parameter leaf 1e-2);
- the launches of a remat step, pinned by formula; stochastic rounding's
  keys (leaf i of the layers ``fold_in(key, i)``, layer l ``fold_in(.,
  l)``) and its views unbiased over keys; tests/test_env_knobs.py's cases,
  ``QT_SAVE_POSTATTN``'s too, on the port with remat; the configs that stay
  dynamic; the package exports against the JAX package's ``__all__``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.quant import fused as jfused
from quantized_training_tpu.quant import mixed_precision as jmp
from quantized_training_tpu_torch import ops, optim, quant, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import random
from quantized_training_tpu_torch.quant import fused
from quantized_training_tpu_torch.quant import mixed_precision as mp
from quantized_training_tpu_torch.utils.tree import tree_leaves
from test_torch_train import _counting

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EPS = 1e-5
KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 64
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
MODES = ("both", "row", "col")
FIELDS = mp.PreQuantMPWeight.data_fields


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """Each test starts with the knobs unset and both packages on 'auto'."""
    for k in ("QT_PREQUANT", "QT_FUSED", "QT_FUSED_ROPE", "QT_SAVE_POSTATTN"):
        monkeypatch.delenv(k, raising=False)
    yield
    jfused.set_impl("auto")
    fused.set_impl("auto")


def _arr(shape, seed, dtn="bf16", scale=1.0, offset=0.0):
    """One numpy draw as a JAX array of the dtype and the same values in torch."""
    v = (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)
    j = jnp.asarray(v, _JDT[dtn])
    return j, params_from_jax(np.asarray(j))


def _same(t: torch.Tensor, j) -> bool:
    j = np.asarray(j)
    if j.dtype.name == "bfloat16":
        j = j.astype(np.float32)
        t = t.float()
    return tuple(t.shape) == j.shape and np.array_equal(t.detach().numpy(), j)


# ---- the views ----------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_views_equal_jax(dtn, mode, stacked):
    shape = (3, 192, 256) if stacked else (192, 256)
    jw, tw = _arr(shape, 1, dtn, 0.05)
    jw = jw.at[..., 0, :].set(0)  # an all-zero row and column
    jw = jw.at[..., :, 1].set(0)
    tw = params_from_jax(np.asarray(jw))
    jpq = jmp.prequantize_weight(jmp.MixedPrecisionWeight(jw, jquant.MixedPrecisionConfig()), mode=mode)
    tpq = mp.prequantize_weight(mp.MixedPrecisionWeight(tw, quant.MixedPrecisionConfig()), mode=mode)
    assert isinstance(tpq, mp.PreQuantMPWeight) and tpq.orig is tw and tpq.shape == tw.shape
    for f in FIELDS:
        assert _same(getattr(tpq, f), getattr(jpq, f)), f
        assert not getattr(tpq, f).requires_grad
    lead = shape[:-2]
    if mode == "row":
        assert tuple(tpq.col_q.shape) == lead + (0, 0) and tuple(tpq.row_s.shape) == lead + (192, 1)
    if mode == "col":
        assert tuple(tpq.row_q.shape) == lead + (0, 0) and tuple(tpq.col_s.shape) == lead + (1, 256)
    carried = params_from_jax(jax.tree.map(np.asarray, jpq))
    assert isinstance(carried, mp.PreQuantMPWeight) and carried.config == tpq.config
    assert all(torch.equal(getattr(carried, f), getattr(tpq, f)) for f in FIELDS)
    if stacked:  # the backbone's cut: one layer's slices of each field
        layer = tpq.unbind_layers()[1]
        assert all(torch.equal(getattr(layer, f), getattr(tpq, f)[1]) for f in FIELDS)


def test_configs_that_stay_dynamic(monkeypatch):
    """A non-int8 config, or one with neither the forward nor grad_input
    quantized, returns the weight itself, as does a mode that asks for the
    view of an unquantized matmul; QT_PREQUANT '0' returns the tree itself,
    an unknown value raises."""
    w = torch.zeros(128, 128)
    for cfg, mode in ((quant.MixedPrecisionConfig(dtype="int4"), "both"),
                      (quant.MixedPrecisionConfig(dtype="fp8_e4m3"), "both"),
                      (quant.MixedPrecisionConfig(output=False, grad_input=False), "both"),
                      (quant.MixedPrecisionConfig(output=False), "row"),
                      (quant.MixedPrecisionConfig(grad_input=False), "col")):
        mw = mp.MixedPrecisionWeight(w, cfg)
        assert mp.prequantize_weight(mw, mode=mode) is mw
        monkeypatch.setenv("QT_PREQUANT", mode)
        assert quant.prequantize_step({"a": {"w": mw}})["a"]["w"] is mw
    params = {"a": {"w": mp.MixedPrecisionWeight(w, quant.MixedPrecisionConfig())}, "b": {"g": w}}
    monkeypatch.setenv("QT_PREQUANT", "0")
    assert quant.prequantize_step(params) is params
    monkeypatch.setenv("QT_PREQUANT", "1")
    out = quant.prequantize_step(params)
    assert isinstance(out["a"]["w"], quant.PreQuantMPWeight) and out["b"]["g"] is w
    assert out["a"]["w"].row_q.numel() and out["a"]["w"].col_q.numel()
    assert quant.is_quant_weight(out["a"]["w"]) and quant.PreQuantMPWeight in quant.api.QUANT_TYPES
    monkeypatch.setenv("QT_PREQUANT", "rows")
    with pytest.raises(ValueError, match="QT_PREQUANT"):
        quant.prequantize_step(params)
    sr = mp.MixedPrecisionWeight(w, quant.MixedPrecisionConfig(stochastic_rounding=True))
    with pytest.raises(ValueError, match="stochastic_rounding requires a key"):
        mp.prequantize_weight(sr)


def test_exports_match_jax():
    """quant exports every name of the JAX package's quant, ops every name
    of its ops but the TPU backend switches."""
    def names(path):
        return set(re.findall(r'"(\w+)"', (REPO / path).read_text().split("__all__")[1]))

    assert names("quantized_training_tpu/quant/__init__.py") <= set(quant.__all__)
    assert {"prequantize_step", "PreQuantMPWeight"} <= set(quant.__all__)
    missing = names("quantized_training_tpu/ops/__init__.py") - set(ops.__all__)
    assert missing == {"set_backend", "use_backend"}
    assert all(hasattr(ops, n) for n in ops.__all__) and all(hasattr(quant, n) for n in quant.__all__)


# ---- the linears ----------------------------------------------------------------

TOGGLES = [(True, True, True), (True, True, False), (True, False, True), (False, True, True), (True, False, False)]


def _vjp_jax(fn, ct, *args):
    """fn's output and its grads at the cotangent ``ct`` (numpy)."""
    out, vjp = jax.vjp(fn, *args)
    return (out, *vjp(jnp.asarray(ct, out.dtype)))


def _vjp_torch(fn, ct, *args):
    args = [a.clone().requires_grad_(True) for a in args]
    out = fn(*args)
    return (out, *torch.autograd.grad(out, args, torch.from_numpy(ct).to(out.dtype)))


@pytest.mark.parametrize("toggles", TOGGLES)
@pytest.mark.parametrize("mode", MODES)
def test_pq_linear_equals_jax_and_dynamic(mode, toggles):
    """linear on a PreQuantMPWeight: the output and both grads (at one
    cotangent) equal JAX's bit for bit, and the port's dynamic linear's."""
    jcfg = jquant.MixedPrecisionConfig(output=toggles[0], grad_input=toggles[1], grad_weight=toggles[2])
    tcfg = quant.MixedPrecisionConfig(output=toggles[0], grad_input=toggles[1], grad_weight=toggles[2])
    jx, tx = _arr((64, 128), 2, "f32")
    jw, tw = _arr((256, 128), 3, "f32", 0.05)
    ct = np.random.default_rng(4).standard_normal((64, 256)).astype(np.float32)
    want = _vjp_jax(lambda x, w: jmp.linear(x, jmp.prequantize_weight(jmp.MixedPrecisionWeight(w, jcfg), mode=mode)),
                    ct, jx, jw)
    pq = _vjp_torch(lambda x, w: quant.qlinear(x, mp.prequantize_weight(mp.MixedPrecisionWeight(w, tcfg), mode=mode)),
                    ct, tx, tw)
    dyn = _vjp_torch(lambda x, w: quant.qlinear(x, mp.MixedPrecisionWeight(w, tcfg)), ct, tx, tw)
    for a, b, c in zip(pq, dyn, want):
        assert torch.equal(a, b) and _same(a, c)


@pytest.mark.parametrize("mode", MODES)
def test_pq_shared_linear_equals_jax_and_dynamic(mode):
    """linear_shared (qlinear_multi) on three PreQuantMPWeights: outputs and
    grads (at one cotangent each) equal JAX's and the dynamic shared
    linear's bit for bit; a mix of pre-quantized and dynamic weights takes
    one linear per weight."""
    jx, tx = _arr((64, 128), 4, "f32")
    jws, tws = zip(*(_arr((256 - 64 * i, 128), 5 + i, "f32", 0.05) for i in range(3)))
    jcfg, tcfg = jquant.MixedPrecisionConfig(), quant.MixedPrecisionConfig()
    cts = [np.random.default_rng(10 + i).standard_normal((64, 256 - 64 * i)).astype(np.float32) for i in range(3)]

    def jrun(x, *ws):
        return tuple(jmp.linear_shared(x, [jmp.prequantize_weight(jmp.MixedPrecisionWeight(w, jcfg), mode=mode)
                                           for w in ws]))

    outs, vjp = jax.vjp(jrun, jx, *jws)
    want = (*outs, *vjp(tuple(jnp.asarray(c) for c in cts)))

    def trun(pre):
        ts = [t.clone().requires_grad_(True) for t in (tx, *tws)]
        ws = [mp.MixedPrecisionWeight(w, tcfg) for w in ts[1:]]
        if pre:
            ws = [mp.prequantize_weight(w, mode=mode) for w in ws]
        outs = quant.qlinear_multi(ts[0], ws)
        return (*outs, *torch.autograd.grad(outs, ts, [torch.from_numpy(c) for c in cts]))

    pq, dyn = trun(True), trun(False)
    for a, b, c in zip(pq, dyn, want):
        assert torch.equal(a, b) and _same(a, c)
    mixed = [mp.prequantize_weight(mp.MixedPrecisionWeight(tws[0], tcfg), mode=mode),
             mp.MixedPrecisionWeight(tws[1], tcfg)]
    outs = quant.qlinear_multi(tx, mixed, key=3)
    assert torch.equal(outs[0], quant.qlinear(tx, mixed[0], key=3))
    assert torch.equal(outs[1], quant.qlinear(tx, mixed[1], key=3))


# ---- the fused ops ----------------------------------------------------------------


def test_fused_ops_with_prequantized_weights(monkeypatch):
    """tests/test_fused.py:664-720 in both packages, interpret mode: the
    one-op MLP and the fused o-projection on PreQuantMPWeights equal the
    port's dynamic fused ops bit for bit, and JAX's pre-quantized ones
    within the fused ops' bounds; each ran its fused Function."""
    jfused.set_impl("interpret")
    fused.set_impl("interpret")
    applies = {"mlp": 0, "attn_out": 0}
    for name, cls in (("mlp", fused._MLPMM), ("attn_out", fused._AttnOutMM)):
        def counted(*args, _apply=cls.apply, _name=name):
            applies[_name] += 1
            return _apply(*args)

        monkeypatch.setattr(cls, "apply", counted)
    jx, tx = _arr((4, 64, 256), 80)
    jgam, tgam = _arr((256,), 81, scale=0.1, offset=1.0)
    (jg_, tg_), (ju, tu), (jd, td) = _arr((384, 256), 82, scale=0.05), _arr((384, 256), 83, scale=0.05), _arr(
        (256, 384), 84, scale=0.05)
    jcfg, tcfg = jquant.MixedPrecisionConfig(), quant.MixedPrecisionConfig()

    def jrun(x, gamma, g_d, u_d, d_d):
        ws = [jmp.prequantize_weight(jmp.MixedPrecisionWeight(d, jcfg)) for d in (g_d, u_d, d_d)]
        return jnp.sum(jquant.mlp_linear(x, gamma, *ws, EPS, key=jax.random.PRNGKey(9)).astype(jnp.float32) ** 2)

    def trun(pre, *ts):
        ts = [t.clone().requires_grad_(True) for t in ts]
        ws = [mp.MixedPrecisionWeight(d, tcfg) for d in ts[2:]]
        if pre:
            ws = [mp.prequantize_weight(w) for w in ws]
            assert all(isinstance(w, mp.PreQuantMPWeight) for w in ws)
        loss = (quant.mlp_linear(ts[0], ts[1], *ws, EPS, key=9).float() ** 2).sum()
        return (loss, *torch.autograd.grad(loss, ts))

    jl, jg = jax.value_and_grad(jrun, argnums=(0, 1, 2, 3, 4))(jx, jgam, jg_, ju, jd)
    args = (tx, tgam, tg_, tu, td)
    pq, dyn = trun(True, *args), trun(False, *args)
    assert applies["mlp"] == 2
    assert all(torch.equal(a, b) for a, b in zip(pq, dyn))
    assert abs(pq[0].item() - float(jl)) <= 1e-3 * abs(float(jl))
    for got, want in zip(pq[1:], jg):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 3e-2 * np.abs(want).max()

    KV, G, Sa, hd = 2, 2, 64, 64
    jy, ty = _arr((4, KV, G, Sa, hd), 85)  # B * S = 256: the fused o-projection's gate
    jw, tw = _arr((256, KV * G * hd), 86, scale=0.05)
    jl, jg = jax.value_and_grad(lambda y, w: jnp.sum(jquant.attn_out_linear(
        y, jmp.prequantize_weight(jmp.MixedPrecisionWeight(w, jcfg)), KV,
        key=jax.random.PRNGKey(9)).astype(jnp.float32) ** 2), argnums=(0, 1))(jy, jw)

    def trun_attn(pre):
        y, w = ty.clone().requires_grad_(True), tw.clone().requires_grad_(True)
        wq = mp.MixedPrecisionWeight(w, tcfg)
        loss = (quant.attn_out_linear(y, mp.prequantize_weight(wq) if pre else wq, KV, key=9).float() ** 2).sum()
        return (loss, *torch.autograd.grad(loss, (y, w)))

    pq, dyn = trun_attn(True), trun_attn(False)
    assert applies["attn_out"] == 2
    assert all(torch.equal(a, b) for a, b in zip(pq, dyn))
    assert abs(pq[0].item() - float(jl)) <= 1e-3 * abs(float(jl))
    for got, want in zip(pq[1:], jg):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 3e-2 * np.abs(want).max()


# ---- the model ----------------------------------------------------------------


def _set_layer(monkeypatch, fused_layer: bool):
    """Both packages on the fused layer (interpret, the grouped pipeline
    forced) or the unfused one (QT_FUSED=0)."""
    if fused_layer:
        monkeypatch.setenv("QT_FUSED_ROPE", "force")
        jfused.set_impl("interpret")
        fused.set_impl("interpret")
    else:
        monkeypatch.setenv("QT_FUSED", "0")
        jfused.set_impl("off")
        fused.set_impl("off")


def _batch(seed, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, KW["vocab_size"], shape), rng.integers(0, KW["vocab_size"], shape)


@pytest.mark.parametrize("fused_layer", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", MODES)
def test_llama_step_under_prequant(monkeypatch, mode, fused_layer):
    """The small Llama (remat): the loss and every grad under QT_PREQUANT
    equal the default path's bit for bit; one train step from
    params_from_jax of JAX's state tracks JAX's step under the same knobs
    within (1e-3, 5e-3, 1e-2)."""
    _set_layer(monkeypatch, fused_layer)
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32), "mixed_precision")
    jopt = joptim.adamw(weight_decay=1e-2)
    jstate = jtrain.init_train_state(jp, jopt)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    tok, lab = (torch.from_numpy(a) for a in _batch(0))
    default = train.loss_and_grads(cfg, tstate.params, tok, lab, 1)
    monkeypatch.setenv("QT_PREQUANT", mode)
    pre = train.loss_and_grads(cfg, tstate.params, tok, lab, 1)
    assert torch.equal(pre[0], default[0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pre[1]), tree_leaves(default[1])))
    jstate, jm = jtrain.make_train_step(jcfg, jopt, donate=False)(
        jstate, jnp.asarray(tok.numpy(), jnp.int32), jnp.asarray(lab.numpy(), jnp.int32), 3e-4, jax.random.PRNGKey(1))
    tstate, tm = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2))(tstate, tok, lab, 3e-4, 1)
    jl, tl, jg, tg = float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-3 * abs(jl), (tl, jl)
    assert abs(tg - jg) <= 5e-3 * jg, (tg, jg)
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.double().numpy() - b) <= 1e-2 * np.linalg.norm(b)


def prequant_per_step(L: int, mode: str, layer: str, sr: bool = False) -> dict:
    """The launches of one remat train step of L layers under QT_PREQUANT
    ``mode`` ('0' the default), from the code. Default, per layer: 'fused'
    (the grouped pipeline at B * S = 256) K1 13 (the 7 weights in the
    forward, 6 in the remat replay, which runs no down product), B4 7 (the
    weights), B5 5; 'unfused' K1 20 (7 weights and 4 inputs, then 6 and 3),
    B4 11, B5 7. 'both' makes each weight's views with one B5 and drops its
    K1 and B4 launches; 'row' makes the row view with one K1 and drops the
    forward's and the replay's; 'col' makes the column view with one B4,
    which the backward no longer launches. K2 (13), B1, B2 and the fused
    layer's producers (B9-row once: not in the replay) as without the
    knob."""
    t, n = "_sr" if sr else "", L
    counts = dict.fromkeys(ops.KERNELS, 0)
    k1, b4, b5 = (13, 7, 5) if layer == "fused" else (20, 11, 7)
    k1 -= {"both": 13, "row": 6}.get(mode, 0)
    b4 -= 7 * (mode == "both")
    b5 += 7 * (mode == "both")
    counts.update({f"quantize_int8_rowwise{t}": k1 * n, f"quantize_int8_colwise{t}": b4 * n,
                   f"quantize_int8_both{t}": b5 * n, "scaled_mm_rhs_t": 13 * n, "scaled_mm": 7 * n,
                   "scaled_mm_lhs_t": 7 * n})
    if layer == "fused":
        counts.update({f"rmsnorm_quant_rowwise{t}": 4 * n, f"silu_mul_quant_rowwise{t}": n,
                       f"rmsnorm_quant_colwise{t}": 2 * n, f"silu_mul_quant_colwise{t}": n, "rmsnorm_bwd": 2 * n,
                       f"silu_mul_bwd_quant_rowwise{t}": n, f"silu_mul_bwd_quant_colwise{t}": n,
                       "rope_group": 7 * n, "rope_ungroup": 3 * n, "ungroup_amax": 2 * n,
                       f"ungroup_quant{t}": 3 * n})
    return counts


@pytest.mark.parametrize("sr", [False, True], ids=["rn", "sr"])
@pytest.mark.parametrize("layer", ["fused", "unfused"])
@pytest.mark.parametrize("mode", ["0", *MODES])
def test_kernel_calls_per_step_prequant(monkeypatch, mode, layer, sr):
    """One remat train step's launches under each QT_PREQUANT mode, fused
    (the grouped pipeline forced, B * S = 256) and unfused, RN and SR:
    exactly ``prequant_per_step``. The remat replay takes the views as they
    are: under 'both' no K1 launches at all."""
    _set_layer(monkeypatch, layer == "fused")
    if layer == "unfused":
        monkeypatch.delenv("QT_FUSED_ROPE", raising=False)
    monkeypatch.setenv("QT_PREQUANT", mode)
    counts = _counting(monkeypatch)
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision",
                                   stochastic_rounding=sr)
    tok, lab = (torch.from_numpy(a) for a in _batch(2, (B, 2 * S)))
    train.loss_and_grads(cfg, params, tok, lab, 7)
    assert counts == prequant_per_step(KW["num_hidden_layers"], mode, layer, sr)


def test_sr_keys_and_unbiased_views(monkeypatch):
    """Under SR, leaf i of the layers (the JAX package's flatten order) and
    layer l draw from fold_in(fold_in(key, i), l): each stacked weight's
    views are B5's plain version at that key; a 2-D weight's at the key
    itself. Over 64 keys the mean of the dequantized views is unbiased: one
    SR draw's error has a standard deviation of at most half a step, so the
    mean of 64 is within 6 of its standard errors (step / 16) of the weight
    at every element, and the mean of those errors over the n elements, in
    steps, within 4 / (16 sqrt(n))."""
    cfg = quant.MixedPrecisionConfig(stochastic_rounding=True)
    layers = {"q": {"w": mp.MixedPrecisionWeight(_arr((2, 128, 256), 20, "f32", 0.05)[1], cfg)},
              "attn_norm": {"g": torch.ones(2, 256)},
              "down": {"w": mp.MixedPrecisionWeight(_arr((2, 256, 128), 21, "f32", 0.05)[1], cfg)}}
    monkeypatch.setenv("QT_PREQUANT", "both")
    out = quant.prequantize_step(layers, key=11)
    for i, name in ((1, "down"), (2, "q")):  # sorted: attn_norm, down, q
        w = layers[name]["w"].data
        for l in range(2):
            want = ops.quantize_int8_both_plain(w[l], sr=True, key=random.fold_in(random.fold_in(11, i), l))
            got = [getattr(out[name]["w"], f)[l] for f in FIELDS[1:]]
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, l)
    w2 = layers["q"]["w"].data[0]
    flat = mp.prequantize_weight(mp.MixedPrecisionWeight(w2, cfg), key=5)
    assert all(torch.equal(getattr(flat, f), b)
               for f, b in zip(FIELDS[1:], ops.quantize_int8_both_plain(w2, sr=True, key=5)))
    draws = [mp.prequantize_weight(mp.MixedPrecisionWeight(w2, cfg), key=k) for k in range(64)]
    for q, s in (("row_q", "row_s"), ("col_q", "col_s")):
        mean = torch.stack([getattr(d, q).float() * getattr(d, s) for d in draws]).mean(0)
        step = getattr(draws[0], s).expand_as(w2)
        err = (mean - w2) / step
        assert (err.abs() <= 6 / 16).all() and err.mean().abs() <= 4 / (16 * err.numel() ** 0.5)


# tests/test_env_knobs.py's configuration and its cases, QT_SAVE_POSTATTN's
# too, with remat on so that the knob reaches the remat policy
TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=64)
KNOB_CASES = [{}, {"QT_PREQUANT": "both"}, {"QT_PREQUANT": "row", "QT_FUSED": "0"},
              {"QT_PREQUANT": "col", "QT_SAVE_POSTATTN": "1"}, {"QT_SAVE_POSTATTN": "1", "QT_FUSED": "0"},
              {"QT_FUSED": "0", "QT_FUSED_ROPE": "force"},
              {"QT_PREQUANT": "both", "QT_FUSED_ROPE": "force", "QT_SAVE_POSTATTN": "1"}]


def _knob_losses(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fused.set_impl("off" if env.get("QT_FUSED") == "0" else "interpret")
    try:
        cfg = llama.LlamaConfig(**TINY, remat=True)
        qp = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(1), cfg), "mixed_precision")
        opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
        state, step = train.init_train_state(qp, opt), train.make_train_step(cfg, opt)
        tok = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 64)))
        lab = torch.roll(tok, -1, dims=-1)
        out = []
        for i in range(3):
            state, m = step(state, tok, lab, 1e-3, i)
            out.append(float(m["loss"]))
        return out
    finally:
        fused.set_impl("auto")
        for k in env:
            monkeypatch.delenv(k)


def test_knob_matrix_tracks_default(monkeypatch):
    """Each case's three losses finite and within 2e-2 of the default's."""
    default = _knob_losses(monkeypatch, KNOB_CASES[0])
    for env in KNOB_CASES[1:]:
        got = _knob_losses(monkeypatch, env)
        assert all(np.isfinite(got)), (env, got)
        np.testing.assert_allclose(got, default, rtol=2e-2)
