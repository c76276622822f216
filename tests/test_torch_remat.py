"""The remat policy (``ops/remat.py``) of the port's Llama layer and ViT
block on the CPU, against the JAX package's ``save_only_these_names`` policy
and plain ``jax.checkpoint``, at ROADMAP A0's small Llama (2 layers, hidden
256, [2, 128] tokens, so that the o-projection is a fused op too) and a
2-block ViT at hidden 128 (32 images of 17 tokens, the fused width).

- The oracle: the ``pallas_call`` and integer ``dot_general`` equations of
  the replay in JAX's ``make_jaxpr(grad(loss_fn))``: the prefix of the
  transposed layer's ``remat2`` body that does not read the layer's
  cotangent (its last input; JAX transposes a remat by replaying every
  primal equation first). A rope call is a ``custom_vjp_call`` with a
  grouped [B, KV, G, S, hd] output (JAX's CPU rope is no Pallas kernel).
  Both packages' fused ops run under ``set_impl('interpret')`` with
  ``QT_FUSED_ROPE=force``; the unfused layer under ``set_impl('off')``. The
  port's replay launches (``_counting``'s counts with remat, less those
  without) are held equal to the oracle's kernels, integer products (K2)
  and ropes, and, for what JAX's CPU program runs without a Pallas kernel
  (K1 on the weights and inputs, the unfused ungrouping), to the counts
  the same rule gives (``REPLAY``);
- bits: losses and grads under the policy equal remat off bit for bit,
  round-to-nearest and SR, at each knob (``QT_SAVE_POSTATTN=1``,
  ``save_qkv_residuals``, both), fused and unfused, and on every scheme
  whose linear has a replay form;
- against JAX (tests/test_torch_remat_vs_jax.py): a train step under each
  knob;
- SDPA (``attention_impl='sdpa'``, the CPU's flash kernel): its forward
  runs once a layer under the policy, none in the replay.
"""

import collections
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.models import vit as jvit
from quantized_training_tpu.quant import fused as jfused
from quantized_training_tpu_torch import quant, train
from quantized_training_tpu_torch.models import llama, vit
from quantized_training_tpu_torch.ops import remat
from quantized_training_tpu_torch.quant import fused
from quantized_training_tpu_torch.utils.tree import tree_leaves
from test_torch_train import _counting

torch.set_num_threads(1)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=128)
B, S = 2, 128
VIT_KW = dict(image_size=32, patch_size=8, hidden_size=128, num_layers=2, num_heads=2, num_classes=10)
VIT_B = 32
# knob -> (QT_SAVE_POSTATTN, LlamaConfig.save_qkv_residuals)
KNOBS = {"default": ("0", False), "postattn": ("1", False), "qkv": ("0", True), "both": ("1", True)}

# The replay's launches a layer (a block), by the rule that XLA's remat
# follows: the replay runs what a backward reads. Fused: B7 and q/k/v (K1 on
# each weight, K2), the rope, B14 and o, B7 and gate/up; never B9-row and
# down. QT_SAVE_POSTATTN drops B14 and o, save_qkv_residuals the first B7,
# q/k/v and the rope. Unfused: K1 on the inputs too (q/k/v share one,
# gate/up one), and o's input ungrouped (rope_ungroup) for o's saved input.
REPLAY = {
    ("fused", "default"): {"rmsnorm_quant_rowwise": 2, "scaled_mm_rhs_t": 6, "quantize_int8_rowwise": 6,
                           "ungroup_amax": 1, "ungroup_quant": 1, "rope_group": 3},
    ("fused", "postattn"): {"rmsnorm_quant_rowwise": 2, "scaled_mm_rhs_t": 5, "quantize_int8_rowwise": 5,
                            "rope_group": 3},
    ("fused", "qkv"): {"rmsnorm_quant_rowwise": 1, "scaled_mm_rhs_t": 3, "quantize_int8_rowwise": 3,
                       "ungroup_amax": 1, "ungroup_quant": 1},
    ("fused", "both"): {"rmsnorm_quant_rowwise": 1, "scaled_mm_rhs_t": 2, "quantize_int8_rowwise": 2},
    ("unfused", "default"): {"scaled_mm_rhs_t": 6, "quantize_int8_rowwise": 9, "rope_group": 3, "rope_ungroup": 1},
    ("unfused", "postattn"): {"scaled_mm_rhs_t": 5, "quantize_int8_rowwise": 7, "rope_group": 3, "rope_ungroup": 1},
    ("unfused", "qkv"): {"scaled_mm_rhs_t": 3, "quantize_int8_rowwise": 5, "rope_ungroup": 1},
    ("unfused", "both"): {"scaled_mm_rhs_t": 2, "quantize_int8_rowwise": 3, "rope_ungroup": 1},
}
VIT_REPLAY = {"fused": {"layernorm_quant_rowwise": 2, "gelu_quant_rowwise": 1, "scaled_mm_rhs_t": 3,
                        "quantize_int8_rowwise": 4},
              "unfused": {"scaled_mm_rhs_t": 3, "quantize_int8_rowwise": 6}}
# the JAX replay's equations and the port's counters they stand for
JAX_NAMES = {"rmsnorm_quant_rowwise": "rmsnorm_quant_rowwise", "silu_mul_quant_rowwise": "silu_mul_quant_rowwise",
             "ungroup_amax": "ungroup_amax", "ungroup_quant": "ungroup_quant", "int_dot": "scaled_mm_rhs_t",
             "rope": "rope_group", "layernorm_quant": "layernorm_quant_rowwise", "gelu_quant": "gelu_quant_rowwise"}


@pytest.fixture
def knob(request, monkeypatch):
    """QT_FUSED_ROPE=force and the case's QT_SAVE_POSTATTN; both packages'
    fused ops at the case's impl."""
    layer, name = request.param
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    monkeypatch.setenv("QT_SAVE_POSTATTN", KNOBS[name][0])
    impl = "interpret" if layer == "fused" else "off"
    jfused.set_impl(impl)
    fused.set_impl(impl)
    yield layer, name
    jfused.set_impl("auto")
    fused.set_impl("auto")


CASES = [(layer, name) for layer in ("fused", "unfused") for name in KNOBS]
_ids = lambda c: "-".join(c)  # noqa: E731


# ---- the oracle ----------------------------------------------------------------------


def _subjaxprs(eqn):
    for p in eqn.params.values():
        for q in p if isinstance(p, (tuple, list)) else (p,):
            if isinstance(q, jcore.ClosedJaxpr):
                yield q.jaxpr
            elif isinstance(q, jcore.Jaxpr):
                yield q


def _count(eqns, acc, name=None):
    """Pallas calls by the name of their enclosing jit, integer dots, and
    rope calls, in ``eqns`` and every jaxpr inside them."""
    for e in eqns:
        prim = e.primitive.name
        if prim == "pallas_call":
            acc[name] += 1
        elif prim == "dot_general" and jnp.issubdtype(e.invars[0].aval.dtype, jnp.integer):
            acc["int_dot"] += 1
        elif prim == "custom_vjp_call" and len(e.outvars) == 1 and e.outvars[0].aval.ndim == 5:
            acc["rope"] += 1
            continue
        for sub in _subjaxprs(e):
            _count(sub.eqns, acc, e.params.get("name", name) if prim in ("pjit", "jit") else name)


def _find_remat(jaxpr):
    for e in jaxpr.eqns:
        if e.primitive.name == "remat2":
            return e
        for sub in _subjaxprs(e):
            found = _find_remat(sub)
            if found is not None:
                return found
    return None


def _replay_eqns(body):
    """The equations of a transposed remat body before the first that reads
    the cotangent of the layer's output (its last input)."""
    ct = body.invars[-1]
    for i, e in enumerate(body.eqns):
        if any(isinstance(v, jcore.Var) and v == ct for v in e.invars):
            return body.eqns[:i]
    return body.eqns


def _jax_replay(loss_of, params) -> dict:
    """The oracle's counts of one layer's (block's) replay, as port counters."""
    body = _find_remat(jax.make_jaxpr(jax.grad(loss_of))(params).jaxpr).params["jaxpr"]
    acc = collections.Counter()
    _count(_replay_eqns(body), acc)
    return {JAX_NAMES[k]: v for k, v in acc.items()}


def _batch():
    rng = np.random.default_rng(5)
    return [rng.integers(0, KW["vocab_size"], (B, S)) for _ in range(2)]


def _port_llama(cfg, scheme="mixed_precision", sr=False, key=11, param_dtype=torch.bfloat16, **kw):
    raw = llama.init_params(torch.Generator().manual_seed(4), cfg, dtype=param_dtype)
    params = quant.quantize_params(raw, scheme, **({"stochastic_rounding": sr} if sr else {}), **kw)
    tok, lab = (torch.from_numpy(a) for a in _batch())
    return train.loss_and_grads(cfg, params, tok, lab, key)


def _replay(counts: dict, run, L: int) -> tuple:
    """(the launches of ``run(True)`` less those of ``run(False)``, a layer,
    zeros dropped; both runs' results)."""
    before = dict(counts)
    on = run(True)
    mid = dict(counts)
    off = run(False)
    diff = {k: (mid[k] - before[k]) - (counts[k] - mid[k]) for k in counts}
    assert all(v % L == 0 for v in diff.values()), diff
    return {k: v // L for k, v in diff.items() if v}, on, off


def _same(a, b) -> bool:
    """Two (loss, grads) the same bit for bit."""
    return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))


@pytest.mark.parametrize("knob", CASES, ids=_ids, indirect=True)
def test_replay_launches_equal_jax_oracle(knob, monkeypatch):
    """The port's replay launches a layer equal ``REPLAY``, whose kernels,
    integer products and ropes equal those of JAX's replay; the policy's
    loss and grads equal remat off's bit for bit."""
    layer, name = knob
    save_qkv = KNOBS[name][1]
    jcfg = jllama.LlamaConfig(**{**KW, "num_hidden_layers": 1}, remat=True, attention_impl="xla",
                              save_qkv_residuals=save_qkv)
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg), "mixed_precision")
    tok = jnp.zeros((B, S), jnp.int32)
    oracle = _jax_replay(lambda p: jllama.loss_fn(p, tok, tok, jcfg), jp)
    counts = _counting(monkeypatch)
    got, on, off = _replay(counts, lambda r: _port_llama(llama.LlamaConfig(
        **KW, remat=r, attention_impl="xla", save_qkv_residuals=save_qkv)), KW["num_hidden_layers"])
    assert got == REPLAY[knob]
    assert oracle == {k: v for k, v in got.items() if k in JAX_NAMES.values()}, (oracle, got)
    assert _same(on, off)


@pytest.mark.parametrize("layer", ["fused", "unfused"])
def test_vit_replay_launches_equal_jax_oracle(layer, monkeypatch):
    """A 2-block ViT at hidden 128 (plain ``jax.checkpoint``): the replay
    drops fc2's product and its weight's quantize, and on the fused path
    keeps fc2's GELU row kernel, for the column maxima its node keeps, as
    JAX's does; the loss and grads equal remat off's bit for bit."""
    impl = "interpret" if layer == "fused" else "off"
    jfused.set_impl(impl)
    fused.set_impl(impl)
    try:
        jcfg = jvit.ViTConfig(**{**VIT_KW, "num_layers": 1}, remat=True)
        jp = jquant.quantize_params(jvit.init_params(jax.random.PRNGKey(0), jcfg), "mixed_precision")
        imgs, lab = jnp.zeros((VIT_B, 32, 32, 3), jnp.float32), jnp.zeros((VIT_B,), jnp.int32)
        oracle = _jax_replay(lambda p: jvit.loss_fn(p, imgs, lab, jcfg), jp)
        counts = _counting(monkeypatch)
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.standard_normal((VIT_B, 32, 32, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, VIT_B))

        def run(r):
            cfg = vit.ViTConfig(**VIT_KW, remat=r)
            p = quant.quantize_params(vit.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision")
            return train.value_and_grad(lambda q: vit.loss_fn(q, images, labels, cfg, key=3), p)

        got, on, off = _replay(counts, run, VIT_KW["num_layers"])
        assert got == VIT_REPLAY[layer]
        assert oracle == {k: v for k, v in got.items() if k in JAX_NAMES.values()}, (oracle, got)
        assert _same(on, off)
    finally:
        jfused.set_impl("auto")
        fused.set_impl("auto")


# ---- bits ------------------------------------------------------------------------------


@pytest.mark.parametrize("knob", CASES, ids=_ids, indirect=True)
def test_sr_policy_bit_identical_to_remat_off(knob):
    """Under SR every draw is a function of the layer's key: the policy's
    loss and grads equal remat off's bit for bit at each knob, and another
    key gives other grads."""
    save_qkv = KNOBS[knob[1]][1]
    cfg = lambda r: llama.LlamaConfig(**KW, remat=r, attention_impl="xla", save_qkv_residuals=save_qkv)  # noqa: E731
    on, off = (_port_llama(cfg(r), sr=True) for r in (True, False))
    assert _same(on, off)
    assert not _same(on, _port_llama(cfg(True), sr=True, key=12))


SCHEMES = [("bf16", None, {}), ("int8_storage", "int8_quantized_training", {"activation": "int8"}),
           ("int8_weight_only", "int8_quantized_training", {}), ("int4_weight_only", "int4_weight_only", {}),
           ("bitnet", "bitnet", {}), ("fp8_tile", "mixed_precision", {"dtype": "fp8_e4m3", "scale": "tile"}),
           ("prequant", "mixed_precision", {})]


@pytest.mark.parametrize("name,scheme,kw", SCHEMES, ids=[s[0] for s in SCHEMES])
@pytest.mark.parametrize("knob", [("fused", "default"), ("fused", "both")], ids=_ids, indirect=True)
def test_schemes_policy_bit_identical(knob, name, scheme, kw, monkeypatch):
    """Every scheme's linear skips its unread product in the replay and
    saves what its node saves: the policy's loss and grads equal remat
    off's bit for bit (BitNet with its o and down norms; ``QT_PREQUANT=both``
    on mixed precision)."""
    if name == "prequant":
        monkeypatch.setenv("QT_PREQUANT", "both")
    save_qkv = KNOBS[knob[1]][1]
    cfg = lambda r: llama.LlamaConfig(**KW, remat=r, attention_impl="xla", save_qkv_residuals=save_qkv,  # noqa: E731
                                      bitnet=name == "bitnet")
    on, off = (_port_llama(cfg(r), scheme=scheme, **kw) for r in (True, False))
    assert _same(on, off)


def test_sdpa_forward_runs_once_a_layer(monkeypatch):
    """attention_impl='sdpa' (the CPU's flash kernel through ``ops/sdpa.py``):
    under the policy its forward runs once a layer, the replay takes its out
    and log-sum-exp; loss and grads equal remat off's bit for bit, and (an
    fp32 model) the einsum attention's within 1e-4 of the loss and 1e-3 of
    each leaf's norm."""
    sdpa_mod = importlib.import_module("quantized_training_tpu_torch.ops.sdpa")

    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    calls = [0]
    forward = sdpa_mod._forward

    def counted(*a, **k):
        calls[0] += 1
        return forward(*a, **k)

    monkeypatch.setattr(sdpa_mod, "_forward", counted)
    runs = {}
    for remat_on, impl in ((True, "sdpa"), (False, "sdpa"), (False, "xla")):
        calls[0] = 0
        runs[remat_on, impl] = _port_llama(llama.LlamaConfig(**KW, remat=remat_on, attention_impl=impl),
                                           scheme=None, param_dtype=torch.float32)
        assert calls[0] == (KW["num_hidden_layers"] if impl == "sdpa" else 0)
    assert _same(runs[True, "sdpa"], runs[False, "sdpa"])
    ref = runs[False, "xla"]
    assert abs(float(runs[True, "sdpa"][0]) - float(ref[0])) <= 1e-4 * abs(float(ref[0]))
    for a, b in zip(tree_leaves(runs[True, "sdpa"][1]), tree_leaves(ref[1])):
        assert (a - b).norm() <= 1e-3 * b.norm()


def test_replay_without_a_saved_value_raises():
    """No fallback: a replay that reaches a value its forward did not save
    raises, and outside a replay nothing is skipped or loaded."""
    frame = remat.checkpointed(
        lambda: remat.load("attention") if remat.replaying() else remat.save("other", torch.ones(1)))
    frame()  # the forward: saves "other" only
    with pytest.raises(RuntimeError, match="did not save"):
        frame()  # its replay
    with pytest.raises(RuntimeError, match="did not save"):
        remat.load("attention")
    with remat.unread():
        assert not remat.skips()


@pytest.mark.parametrize("knob", CASES, ids=_ids, indirect=True)
def test_chip_smoke_formula_matches_the_counts(knob, monkeypatch):
    """chip_smoke.py's ``per_step_launches`` at each knob (the card's
    phase 8 and 19 expectations) equals the port's launches of a remat
    loss and grads, fused and unfused, on the grouped pipeline; the routes'
    ``_sm90`` counters, which the CPU does not count, aside."""
    import chip_smoke

    layer, name = knob
    post_attn, save_qkv = KNOBS[name][0] == "1", KNOBS[name][1]
    counts = _counting(monkeypatch)
    _port_llama(llama.LlamaConfig(**KW, remat=True, attention_impl="xla", save_qkv_residuals=save_qkv))
    expect = chip_smoke.per_step_launches(KW["num_hidden_layers"], layer=layer, post_attn=post_attn,
                                          save_qkv=save_qkv)
    assert {k: v for k, v in counts.items() if "_sm90" not in k} == \
        {k: v for k, v in expect.items() if "_sm90" not in k}


@pytest.mark.parametrize("scheme", ["mixed_precision", None], ids=["int8", "bf16"])
def test_ungrouped_layer_policy(scheme, monkeypatch):
    """The ungrouped layer (``QT_FUSED_ROPE=0``: rope in the model dtype,
    the einsum attention) under both knobs: the post-rope q, k and v kept,
    so the replay runs o's, gate's and up's products (``QT_SAVE_POSTATTN``
    keeps nothing off ``attn_out_linear``'s path, as in JAX), and the loss
    and grads equal remat off's bit for bit (the rope's graph is rebuilt on
    the projections' unread outputs)."""
    monkeypatch.setenv("QT_FUSED_ROPE", "0")
    monkeypatch.setenv("QT_SAVE_POSTATTN", "1")
    counts = _counting(monkeypatch)
    got, on, off = _replay(counts, lambda r: _port_llama(llama.LlamaConfig(
        **KW, remat=r, attention_impl="xla", save_qkv_residuals=True), scheme=scheme), KW["num_hidden_layers"])
    assert got == ({"scaled_mm_rhs_t": 3, "quantize_int8_rowwise": 5} if scheme else {})
    assert _same(on, off)
