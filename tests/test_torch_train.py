"""The port's training step against the JAX package's on the CPU
(train.make_train_step with adamw, models/llama.py's loss with per-layer
remat), at a small Llama: 2 layers, hidden 256, FFN 512, 4/2 heads, seq 64,
batch 2. Every linear of the body is >= 128 and a multiple of 32, so the
default filter quantizes all of them. Inputs come from numpy seeds.

The bounds of the whole-step comparison come from the JAX step against
itself with every element of its embedding moved by one ulp (random sign),
measured on the CPU, the worst of two draws and both steps. Relative
(loss, grad norm, worst parameter leaf's RMS), floor and then the port
against the JAX step:

- fp32:       floor 7.6e-8, 8.3e-8, 2.8e-6; port 7.6e-8, 0,      2.3e-6
- fp32 int8:  floor 1.4e-4, 1.8e-4, 1.7e-3; port 1.3e-4, 8.6e-4, 2.3e-3
- bf16:       floor 8.5e-5, 5.3e-4, 5.8e-3; port 1.6e-5, 4.8e-4, 1.7e-3
- bf16 int8:  floor 1.6e-4, 1.7e-3, 5.9e-3; port 3.8e-5, 5.3e-4, 3.2e-3

- fp32 int8 storage:  port 2.9e-6, 4.1e-5, 1.1e-3 (masters before the commit)
- bf16 int8 storage:  port 2.9e-5, 9.0e-4, 3.9e-3
- fp32 int4 storage:  port 7.6e-8, 8.3e-8, 3.1e-6
- bf16 int4 storage:  port 1.4e-5, 2.2e-4, 1.6e-3
- fp32 BitNet:        floor 2.2e-5, 2.6e-3, -;   port 1.9e-5, 1.2e-4, 1.8e-4
- bf16 BitNet:        floor 4.9e-4, 4.6e-3, -;   port 2.8e-4, 5.1e-3, 3.6e-3

(BitNet's floor: the loss and the grad norm only.) BitNet ternarizes every
weight and quantizes every activation at each forward, so one ulp anywhere
moves its grad norm by up to 4.6e-3 in bf16; its grad-norm bound there is
1.5e-2, the rest are mixed precision's.

Under int8, rounding flips carry any rounding difference, so the floor is
the int8 noise; in bf16 the worst leaf is the moved embedding itself (one
bf16 ulp is 2**-8 relative). Each bound sits above its floor (BOUNDS);
a wiring fault (a transposed operand, a scale on the wrong axis) moves
the second step's loss by percents.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import ops, optim, quant, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import fused_producers
from quantized_training_tpu_torch.quant import core, mixed_precision
from quantized_training_tpu_torch.utils.tree import tree_leaves

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 64
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}

# (loss, grad norm, worst leaf's param relative RMS): above the floors above,
# by 2.9x or more on loss and grad norm and 1.7x or more on the worst leaf
BOUNDS = {
    ("f32", None): (1e-6, 1e-6, 1e-5),
    ("f32", "mixed_precision"): (1e-3, 5e-3, 1e-2),
    ("bf16", None): (1e-3, 5e-3, 1e-2),
    ("bf16", "mixed_precision"): (1e-3, 5e-3, 1e-2),
}
# the storage schemes are held to mixed precision's bounds, but for bf16
# BitNet's grad norm, whose floor is higher; int8 storage runs its kernels'
# activations (Int8QTConfig's default is weight-only)
for _d in ("f32", "bf16"):
    for _s in ("int8_quantized_training", "int4_weight_only", "bitnet"):
        BOUNDS[(_d, _s)] = BOUNDS[(_d, "mixed_precision")]
BOUNDS[("bf16", "bitnet")] = (1e-3, 1.5e-2, 1e-2)
SCHEME_KW = {"int8_quantized_training": {"activation": "int8"}}
STORAGE = ("int8_quantized_training", "int4_weight_only")


def _batch(seed, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, KW["vocab_size"], shape), rng.integers(0, KW["vocab_size"], shape)


def _setup(dtn, scheme, **cfg_kw):
    """One set of weights and one AdamW state for both packages."""
    cfg_kw.setdefault("bitnet", scheme == "bitnet")
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla", **cfg_kw)
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla", **cfg_kw)
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=_JDT[dtn]), scheme,
                                **SCHEME_KW.get(scheme, {}))
    jopt = joptim.adamw(weight_decay=1e-2)
    jstate = jtrain.init_train_state(jp, jopt)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    return jcfg, cfg, jopt, jstate, tstate


def _compare(jstate, jm, tstate, tm, bounds):
    b_loss, b_gn, b_param = bounds
    jl, tl = float(jm["loss"]), float(tm["loss"])
    jg, tg = float(jm["grad_norm"]), float(tm["grad_norm"])
    assert np.isfinite(tl) and abs(tl - jl) <= b_loss * abs(jl), (tl, jl)
    assert abs(tg - jg) <= b_gn * jg, (tg, jg)
    jleaves = [np.asarray(x, np.float64) for x in jax.tree.leaves(jstate.params)]
    tleaves = [x.double().numpy() for x in tree_leaves(tstate.params)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= b_param * np.linalg.norm(b)


@pytest.mark.parametrize("scheme", ["mixed_precision", None, *STORAGE, "bitnet"])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_train_steps_vs_jax(monkeypatch, dtn, scheme):
    """Two steps of make_train_step(cfg, adamw()) with remat, from
    params_from_jax + adamw_state_from_jax, against the JAX step on the
    same batch: losses, grad norms and every parameter within BOUNDS; the
    wrapped weights keep their wrapper and config. The storage schemes
    (int8 with int8 activations, int4 weight-only) are compared on the
    updated masters before the commit, whose stochastic rounding draws from
    another generator in each package: both steps' commits are cut out,
    and between the steps the JAX commit's storage is carried into both
    (params_from_jax). BitNet (cfg.bitnet, the o and down norms) has no
    storage apart from its weights."""
    jcfg, cfg, jopt, jstate, tstate = _setup(dtn, scheme)
    storage = scheme in STORAGE
    if storage:  # the steps return the updated masters
        monkeypatch.setattr(jtrain, "commit_params", lambda new_v, q, key: new_v)
        monkeypatch.setattr(train, "commit_params", lambda new_v, q, key: new_v)
    jstep = jtrain.make_train_step(jcfg, jopt, donate=False)
    tstep = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2))
    tok, lab = _batch(0)
    for i in range(2):
        jq = jstate.params
        jstate, jm = jstep(jstate, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), 3e-4,
                           jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, torch.from_numpy(tok), torch.from_numpy(lab), 3e-4, 1)
        _compare(jstate, jm, tstate, tm, BOUNDS[(dtn, scheme)])
        if storage:  # the JAX commit, carried into both
            jstate = jstate._replace(params=jquant.commit_params(jstate.params, jq, jax.random.PRNGKey(2 + i)))
            tstate = tstate._replace(params=params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    assert tstate.step == 2 and tstate.opt_state.count == 2
    q = tstate.params["layers"]["q"]["w"]
    wrapper = {None: torch.Tensor, "mixed_precision": mixed_precision.MixedPrecisionWeight,
               "int8_quantized_training": quant.Int8Weight, "int4_weight_only": quant.Int4Weight,
               "bitnet": quant.BitNetWeight}[scheme]
    assert isinstance(q, wrapper) and (scheme is None or not isinstance(q, torch.Tensor))


def test_grad_accumulation_and_clipping_vs_jax():
    """An [accum=2, B, S] batch with clip_grad_norm=0.5 (below the norm, so
    the clip acts), int8, fp32: the grads are summed over the micro-steps in
    the grad dtype and averaged, the loss averaged, then clipped; within
    the int8 bounds of the single-batch test."""
    jcfg, cfg, jopt, jstate, tstate = _setup("f32", "mixed_precision")
    jstep = jtrain.make_train_step(jcfg, jopt, clip_grad_norm=0.5, donate=False)
    tstep = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2), clip_grad_norm=0.5)
    tok, lab = _batch(1, (2, B, S))
    jstate, jm = jstep(jstate, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), 3e-4,
                       jax.random.PRNGKey(1))
    tstate, tm = tstep(tstate, torch.from_numpy(tok), torch.from_numpy(lab), 3e-4, 1)
    assert float(tm["grad_norm"]) > 0.5
    _compare(jstate, jm, tstate, tm, BOUNDS[("f32", "mixed_precision")])


@pytest.mark.parametrize("dtn,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_sdpa_branch_vs_einsum_branch(dtn, tol):
    """attention(impl='sdpa') (F.scaled_dot_product_attention with
    enable_gqa, the card's branch under 'auto') against the einsum branch
    (the JAX package's), outputs and q/k/v grads, GQA with 4/2 heads. Both
    softmax in fp32 in fp32; in bf16 SDPA keeps its own intermediate
    precision, so the bound is a few bf16 ulps of the largest value."""
    rng = np.random.default_rng(3)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtn]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt).requires_grad_(True)
               for s in ((2, 48, 4, 64), (2, 48, 2, 64), (2, 48, 2, 64)))
    g = torch.from_numpy(rng.standard_normal((2, 48, 4, 64)).astype(np.float32)).to(dt)
    outs = {}
    for impl in ("sdpa", "xla"):
        out = llama.attention(q, k, v, impl)
        grads = torch.autograd.grad(out, (q, k, v), g)
        outs[impl] = [out.detach().float(), *(x.float() for x in grads)]
    for a, b in zip(outs["sdpa"], outs["xla"]):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= tol * b.abs().max()
    assert llama._resolve_attn_impl("auto", q) == "xla"  # a CPU tensor takes the einsum
    with pytest.raises(ValueError, match="attention_impl"):
        llama.attention(q, k, v, "splash")


def _counting(monkeypatch):
    """Count calls of each kernel wrapper (on the card, each call is one
    launch), an SR form under its own name, by wrapping the names its
    callers look up."""
    counts = dict.fromkeys(ops.KERNELS, 0)

    def wrap(mod, attr, name, sr_kw):
        fn = getattr(mod, attr)

        def counted(*args, **kwargs):
            counts[name + ("_sr" if kwargs.get(sr_kw) else "")] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, attr, counted)

    wrap(core, "quantize_int8_rowwise", "quantize_int8_rowwise", "sr")
    wrap(core, "quantize_int8_colwise", "quantize_int8_colwise", "sr")
    wrap(core, "_quantize_both_kernel", "quantize_int8_both", "sr")
    for name in ("rmsnorm_quant_rowwise", "rmsnorm_quant_colwise", "silu_mul_quant_rowwise",
                 "silu_mul_quant_colwise", "rmsnorm_bwd", "silu_mul_bwd_quant_rowwise",
                 "silu_mul_bwd_quant_colwise", "layernorm_quant_rowwise", "layernorm_quant_colwise",
                 "gelu_quant_rowwise", "gelu_quant_colwise"):  # the fused layers' kernels
        wrap(fused_producers, name, name, "sr")
    rope = importlib.import_module("quantized_training_tpu_torch.ops.rope")
    for attr, name in (("rope_group_kernel", "rope_group"), ("rope_ungroup_kernel", "rope_ungroup"),
                       ("ungroup_amax", "ungroup_amax"), ("ungroup_quant", "ungroup_quant")):
        wrap(rope, attr, name, "sr")
    # optim exports a function of the module's name
    wrap(importlib.import_module("quantized_training_tpu_torch.optim.adamw"), "fused_adamw_update",
         "fused_adamw_update", "bf16_sr")

    mm = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")
    monkeypatch.setattr(mm, "_BY_DIMS", dict(mm._BY_DIMS))
    for dims, fn in list(mm._BY_DIMS.items()):
        def counted(*args, _fn=fn, _name=fn.__name__, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        mm._BY_DIMS[dims] = counted
    return counts


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_calls_per_step(monkeypatch, remat):
    """The launch counts chip_smoke.py holds the card to, per train step of
    L layers: the backward runs B5, B1 and B2 once per quantized weight
    (q, k, v, o, gate, up, down: 7 L) and B4 11 L times (the 7 weights, the
    shared input of q/k/v and of gate/up once each, the inputs of o and
    down); the forward runs K1 11 L times (7 weights, 4 inputs) and K2 7 L
    times, and with remat its replay under the policy all of it but down's
    (K1 9 L, K2 6 L: no backward reads the layer's output)."""
    counts = _counting(monkeypatch)
    cfg = llama.LlamaConfig(**KW, remat=remat, attention_impl="xla")
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision")
    opt = optim.adamw()
    tok, lab = _batch(2)
    train.make_train_step(cfg, opt)(train.init_train_state(params, opt), torch.from_numpy(tok),
                                    torch.from_numpy(lab), 3e-4, 0)
    assert counts == _per_step(KW["num_hidden_layers"], remat=remat)


def _per_step(L, remat=True, micro=1, sr=False, b6=0, b6_sr=0):
    """The launch counts of one train step of L layers: ``micro``
    micro-batches of the int8 forward (with remat, and its replay: all of
    it but down's K1 on its input and on its weight and its K2) and
    backward, each quantize in its SR form when ``sr``; and the optimizer's
    B6 launches (the SR writeback apart)."""
    tag = "_sr" if sr else ""
    k1, k2 = (11 + 9, 7 + 6) if remat else (11, 7)
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts.update({
        "quantize_int8_rowwise" + tag: k1 * L * micro, "quantize_int8_colwise" + tag: 11 * L * micro,
        "quantize_int8_both" + tag: 7 * L * micro, "scaled_mm_rhs_t": k2 * L * micro,
        "scaled_mm": 7 * L * micro, "scaled_mm_lhs_t": 7 * L * micro,
        "fused_adamw_update": b6, "fused_adamw_update_sr": b6_sr,
    })
    return counts


@pytest.mark.parametrize("config", ["bench", "sr"])
def test_kernel_calls_per_step_sr_slice(monkeypatch, config):
    """The launch counts of the SR slice's two configurations, which
    chip_smoke.py phases 8 and 9 hold the card to. 'bench' (bench.py's
    step): [4, B, S] accumulation, remat, adamw_bf16_sr without the SR
    writeback, int8 without SR: four micro-batches' quantizes and GEMMs and
    one B6 launch per parameter leaf (12). 'sr' (llm_pretrain.py with
    stochastic_rounding and adamw_bf16_sr): only the SR forms of K1, B4
    and B5, and B6's SR form once per bf16 leaf."""
    counts = _counting(monkeypatch)
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    bench = config == "bench"
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), "mixed_precision",
                                   stochastic_rounding=not bench)
    opt = optim.get_optimizer("adamw_bf16_sr", bf16_stochastic_rounding=not bench)
    tok, lab = _batch(2, (4, B, S) if bench else (B, S))
    train.make_train_step(cfg, opt)(train.init_train_state(params, opt), torch.from_numpy(tok),
                                    torch.from_numpy(lab), 1e-4, 5)
    n_leaves = len(tree_leaves(params))
    assert n_leaves == 12
    L = KW["num_hidden_layers"]
    expect = (_per_step(L, micro=4, b6=n_leaves) if bench else _per_step(L, sr=True, b6_sr=n_leaves))
    assert counts == expect


def storage_per_step(scheme: str, L: int, n_leaves: int, sr: bool = False) -> dict:
    """The launch counts of one remat train step of L layers on the grouped
    pipeline for a storage scheme, which chip_smoke.py holds the card to:
    per layer the forward quantizes each of the 7 linears' inputs with K1
    (q/k/v apart: qlinear_multi's fallback) and runs K2 7 times (int8
    storage with int8 or int8_sr activations, BitNet), and its remat replay
    6 (not down's: no backward reads the layer's output) with K1 on 6
    inputs (int8 storage) or all 7 (BitNet, whose down node keeps its int8
    input); no int8 backward kernel; B13 as the unfused grouped layer (rope_group 7,
    rope_ungroup 5: BitNet ungroups the attention output before o_norm);
    the commit re-quantizes each of the 7 stacked int8 weights once with
    K1-SR; the optimizer runs B6 once a master leaf. int4 weight-only runs
    neither K1 nor K2."""
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts.update({"rope_group": 7 * L, "rope_ungroup": 5 * L, "fused_adamw_update": n_leaves})
    if scheme != "int4_weight_only":
        counts["quantize_int8_rowwise" + ("_sr" if sr else "")] += (7 + (7 if scheme == "bitnet" else 6)) * L
        counts["scaled_mm_rhs_t"] = (7 + 6) * L
    if scheme == "int8_quantized_training":
        counts["quantize_int8_rowwise_sr"] += 7
    return counts


@pytest.mark.parametrize("scheme,kw", [("int8_quantized_training", {"activation": "int8"}),
                                       ("int8_quantized_training", {"activation": "int8_sr"}),
                                       ("bitnet", {}), ("int4_weight_only", {})])
def test_kernel_calls_per_step_storage(monkeypatch, scheme, kw):
    """The storage schemes' launch counts per step (``storage_per_step``) on
    the grouped pipeline (``QT_FUSED_ROPE=force``, as the card runs it),
    with remat and adamw_bf16_sr without the SR writeback; the storage
    after the commit stays int8 with its config."""
    monkeypatch.setenv("QT_FUSED_ROPE", "force")
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla", bitnet=scheme == "bitnet")
    params = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), scheme, **kw)
    counts = _counting(monkeypatch)
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    tok, lab = _batch(2)
    state, _ = train.make_train_step(cfg, opt)(train.init_train_state(params, opt), torch.from_numpy(tok),
                                               torch.from_numpy(lab), 1e-4, 5)
    n_leaves = len(tree_leaves(quant.virtual_params(params)))
    assert n_leaves == 12 + 2 * (scheme == "bitnet")
    sr = kw.get("activation") == "int8_sr"
    assert counts == storage_per_step(scheme, KW["num_hidden_layers"], n_leaves, sr)
    q = state.params["layers"]["q"]["w"]
    assert type(q) is type(params["layers"]["q"]["w"])
    if scheme == "int8_quantized_training":
        assert q.int_data.dtype == torch.int8 and q.config == params["layers"]["q"]["w"].config


def test_loss_fn_fused_equals_explicit_logits():
    """loss_fn's chunked fused loss (plain lm_head) against its explicit
    logits branch (taken for a quantized lm_head; here the same plain head
    through forward + log_softmax), fp32 with ignored labels: within 1e-6
    relative, sum order only."""
    cfg = llama.LlamaConfig(**KW, attention_impl="xla")
    params = llama.init_params(torch.Generator().manual_seed(1), cfg, dtype=torch.float32)
    tok, lab = _batch(3)
    lab[:, ::5] = -100
    tok, lab = torch.from_numpy(tok), torch.from_numpy(lab)
    fused = llama.loss_fn(params, tok, lab, cfg)
    logits = llama.forward(params, tok, cfg).reshape(-1, KW["vocab_size"])
    valid = lab.reshape(-1) != -100
    nll = torch.nn.functional.cross_entropy(logits[valid], lab.reshape(-1)[valid])
    assert abs(fused.item() - nll.item()) <= 1e-6 * nll.item()
    qhead = dict(params, lm_head={"w": mixed_precision.MixedPrecisionWeight(
        params["lm_head"]["w"], quant.MixedPrecisionConfig())})
    explicit = llama.loss_fn(qhead, tok, lab, cfg)  # the logits branch, int8 head
    assert abs(explicit.item() - nll.item()) <= 1e-2 * nll.item()


def test_unstack_layers_grads_match_indexing():
    """backbone cuts the stacked [L, ...] weights with one unbind per leaf:
    the grads equal those of indexing layer by layer, exactly."""
    cfg = llama.LlamaConfig(**KW, attention_impl="xla", remat=True)
    base = llama.init_params(torch.Generator().manual_seed(2), cfg, dtype=torch.float32)
    tok, lab = map(torch.from_numpy, _batch(4))
    grads = []
    for use_unbind in (True, False):
        leaves = {k: v.clone().requires_grad_(True) for k, v in base["layers"].items() for v in v.values()}
        layers = {k: {n: leaves[k] for n in base["layers"][k]} for k in base["layers"]}
        params = dict(base, layers=layers)
        if use_unbind:
            loss = llama.loss_fn(params, tok, lab, cfg)
        else:
            cut = lambda l: {k: {n: t[l] for n, t in v.items()} for k, v in layers.items()}
            orig = llama._unstack_layers
            llama._unstack_layers = lambda lay, L: [cut(l) for l in range(L)]
            try:
                loss = llama.loss_fn(params, tok, lab, cfg)
            finally:
                llama._unstack_layers = orig
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_config_fields_match_jax():
    """LlamaConfig carries the JAX config's training fields with the same
    defaults (remat off, attention 'auto', no q/k/v residuals kept)."""
    jf = {f.name: f.default for f in dataclasses.fields(jllama.LlamaConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(llama.LlamaConfig)}
    for name in ("remat", "attention_impl", "save_qkv_residuals"):
        assert tf[name] == jf[name]
    assert set(tf) <= set(jf)
