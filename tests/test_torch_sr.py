"""The SR slice on the CPU: the port's random stream (ops/random.py), its
stochastic rounding (the plain versions of the SR forms of K1, B4 and B5,
``bf16_stochastic_round``) against the JAX package's, and the training step
of the slice's two configurations against the JAX step, at the small Llama
of tests/test_torch_train.py (2 layers, hidden 256, FFN 512, 4/2 heads,
seq 64, batch 2). Inputs come from numpy seeds.

The two packages draw their noise from different generators (Philox here,
threefry in JAX), so SR is held to statistics, not bits: scales equal, every
q one of the two integers around x / scale, and the mean over many keys
within a stated number of standard errors of x / scale on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.quant import core as jcore
from quantized_training_tpu_torch import optim, quant, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import random
from quantized_training_tpu_torch.quant import core
from quantized_training_tpu_torch.utils.tree import tree_leaves

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 64
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

# ---- the stream ----------------------------------------------------------------

# Random123's known-answer vectors for Philox4x32-10: (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    """On Python ints and on int64 tensors (the plain version's arithmetic,
    where a product of two words wraps): the published words."""
    assert random.philox4x32(*counter, *key) == want
    tensors = [torch.tensor([c], dtype=torch.int64) for c in counter]
    assert tuple(int(w[0]) for w in random.philox4x32(*tensors, *key)) == want


def test_fold_in_and_split_are_pure_and_distinct():
    """fold_in and split are functions of their arguments: the same inputs
    give the same key, other data, another key or another index another
    key; they differ from one another and from the stream's own words."""
    k = 0x0123456789ABCDEF
    assert random.fold_in(k, 5) == random.fold_in(k, 5)
    keys = {random.fold_in(k, d) for d in range(64)} | {random.fold_in(k + 1, 0)} | set(random.split(k, 8))
    assert len(keys) == 64 + 1 + 8
    assert all(0 <= x < 2**64 for x in keys)
    assert random.split(k, 3)[:2] == random.split(k)
    w = random.random_bits(k, (8,)).tolist()
    assert random.fold_in(k, 0) != w[0] | (w[1] << 32)
    for bad in (-1, 2**64, 1.5):
        with pytest.raises(ValueError, match="key"):
            random.fold_in(bad, 0)
    gen_key = random.key_from_generator(torch.Generator().manual_seed(3))
    assert gen_key == random.key_from_generator(torch.Generator().manual_seed(3)) and 0 <= gen_key < 2**63


def test_stream_layout_and_uniform():
    """Element i is word i % 4 of the block at counter (i // 4, 0, 0, 0),
    row-major over the shape; U = (word >> 8) * 2**-24 lies in [0, 1)."""
    k = 2**63 + 99
    bits = random.random_bits(k, (3, 7))
    flat = bits.reshape(-1).tolist()
    for i in (0, 3, 4, 13, 20):
        assert flat[i] == random.philox4x32(i // 4, 0, 0, 0, k & 0xFFFFFFFF, k >> 32)[i % 4]
    u = random.uniform(k, (3, 7))
    assert u.dtype == torch.float32 and torch.equal(u, (bits >> 8).double().mul(2.0**-24).float())
    big = random.uniform(1, (100_000,))
    assert big.min() >= 0 and big.max() < 1 and abs(big.mean().item() - 0.5) < 0.005


# ---- stochastic rounding against the JAX package --------------------------------

N_KEYS = 200


def _x(dtn, shape=(32, 96), seed=0):
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
    x[1] = 0.0
    x[:, 2] = 0.0
    xj = jnp.asarray(x, _JDT[dtn])
    return xj, params_from_jax(np.asarray(xj))


def _ratio(x32: np.ndarray, axis: int) -> np.ndarray:
    """x / max(absmax / 127, eps) in fp32, as both packages compute it."""
    scale = np.abs(x32).max(axis=axis, keepdims=True) / np.float32(127)
    return x32 / np.maximum(scale, np.float32(1e-12))


def _check_sr_draws(qs: np.ndarray, r: np.ndarray, what: str) -> None:
    """qs [keys, ...] int: each q is floor(r) or floor(r) + 1 (clipped); the
    mean over the keys within 0.2 of r at every element (5.6 standard
    errors of 200 draws of a step of at most 1: std <= 0.5 / sqrt(200) =
    0.035) and within 4e-3 on average (6 standard errors of all draws)."""
    lo = np.clip(np.floor(r), -128, 127)
    assert (((qs == lo) | (qs == np.clip(lo + 1, -128, 127))).all()), what
    dev = qs.mean(0) - r
    assert np.abs(dev).max() < 0.2, (what, np.abs(dev).max())
    assert abs(dev.mean()) < 4e-3, (what, dev.mean())


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_sr_quantize_vs_jax(dtn, axis):
    """quantize_int8 with SR, row (K1's form) and column (B4's form): the
    scales equal JAX's bit for bit; both packages' q are the two integers
    around x / scale, unbiased over 200 keys; the port repeats a key and
    differs across keys."""
    xj, xt = _x(dtn)
    x32 = np.asarray(xj, np.float32)
    r = _ratio(x32, axis)
    tq, jq = [], []
    for k in range(N_KEYS):
        q, s = core.quantize_int8(xt, axis=axis, stochastic_rounding=True, key=1000 + k)
        qj, sj = jcore.quantize_int8(xj, axis=axis, stochastic_rounding=True, key=jax.random.PRNGKey(k))
        tq.append(q.numpy())
        jq.append(np.asarray(qj))
    assert np.array_equal(s.float().numpy(), np.asarray(sj, np.float32)) and s.dtype == _TDT[dtn]
    _check_sr_draws(np.stack(tq).astype(np.float64), r, "port")
    _check_sr_draws(np.stack(jq).astype(np.float64), r, "jax")
    again = core.quantize_int8(xt, axis=axis, stochastic_rounding=True, key=1000 + N_KEYS - 1)[0]
    assert np.array_equal(again.numpy(), tq[-1]) and not np.array_equal(tq[0], tq[1])


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_sr_quantize_both_vs_jax(dtn):
    """quantize_int8_both with SR (B5's form): each half as the single-axis
    test holds it, against JAX's; the row and the column half draw from
    different keys (random.split), so they are not the same draw."""
    xj, xt = _x(dtn, seed=1)
    x32 = np.asarray(xj, np.float32)
    draws = {"port": ([], []), "jax": ([], [])}
    for k in range(N_KEYS):
        tr, tsr, tc, tsc = core.quantize_int8_both(xt, stochastic_rounding=True, key=k)
        jr, jsr, jc, jsc = jcore.quantize_int8_both(xj, stochastic_rounding=True, key=jax.random.PRNGKey(k))
        for name, (a, b) in (("port", (tr.numpy(), tc.numpy())), ("jax", (np.asarray(jr), np.asarray(jc)))):
            draws[name][0].append(a)
            draws[name][1].append(b)
    for got, want in ((tsr, jsr), (tsc, jsc)):
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    for name, (rows, cols) in draws.items():
        _check_sr_draws(np.stack(rows).astype(np.float64), _ratio(x32, 1), f"{name} rows")
        _check_sr_draws(np.stack(cols).astype(np.float64), _ratio(x32, 0), f"{name} cols")
    kr, kc = random.split(5)
    assert np.array_equal(draws["port"][0][5], core.quantize_int8(xt, axis=1, stochastic_rounding=True, key=kr)[0])
    assert np.array_equal(draws["port"][1][5], core.quantize_int8(xt, axis=0, stochastic_rounding=True, key=kc)[0])


def test_bf16_stochastic_round_vs_jax():
    """fp32 -> bf16 with SR: every output of both packages is one of the
    two bf16 neighbours of x (the truncation and one bf16 step above it in
    magnitude); the mean over 256 keys is within 5 standard errors of x
    (step gap: std <= gap / 2), elementwise for all but 0.1% and on average
    within 5e-3 of the gap; the same key repeats."""
    x = (np.random.default_rng(2).standard_normal(2048) * 0.05).astype(np.float32)
    trunc = (x.view(np.int32) & np.int32(-65536)).view(np.float32)
    up = ((x.view(np.int32) & np.int32(-65536)) + np.int32(1 << 16)).view(np.float32)
    gap = np.abs(up - trunc).astype(np.float64)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for name, draw in (("port", lambda k: core.bf16_stochastic_round(xt, k).float().numpy()),
                       ("jax", lambda k: np.asarray(jcore.bf16_stochastic_round(xj, jax.random.PRNGKey(k)),
                                                    np.float32))):
        outs = np.stack([draw(k) for k in range(256)])
        assert ((outs == trunc) | (outs == up)).all(), name
        dev = (outs.mean(0) - x) / gap
        assert (np.abs(dev) <= 5 * 0.5 / 16).mean() > 0.999, name
        assert abs(dev.mean()) < 5e-3, name
    assert torch.equal(core.bf16_stochastic_round(xt, 7), core.bf16_stochastic_round(xt, 7))
    with pytest.raises(TypeError, match="fp32"):
        core.bf16_stochastic_round(xt.to(torch.bfloat16), 7)


def test_stochastic_round_to_int():
    """floor(x + U): the integer below or above, unbiased over 200 keys."""
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(4096) * 10).astype(np.float32))
    outs = torch.stack([core.stochastic_round_to_int(x, k) for k in range(N_KEYS)])
    assert ((outs == torch.floor(x)) | (outs == torch.floor(x) + 1)).all()
    assert abs((outs.double().mean(0) - x.double()).mean().item()) < 4e-3


# ---- the slice's training step ------------------------------------------------

def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, KW["vocab_size"], shape), rng.integers(0, KW["vocab_size"], shape)


# bench.py's step at a small width: [4, B, S] accumulation, remat,
# adamw_bf16_sr without the SR writeback, lr 1e-4. Bounds of (loss, grad
# norm, worst leaf's relative RMS) over two steps, each above the floor of
# the JAX step against itself with its embedding moved by one ulp (random
# sign), measured on the CPU in one draw, worst of the two steps; then the
# port against the JAX step:
#   bf16 int8: floor 5.7e-5, 7.2e-4, 5.9e-3; port 2.5e-5, 3.0e-4, 1.3e-3
#   fp32 int8: floor 1.3e-5, 5.3e-4, 7.7e-4; port 8.7e-6, 2.8e-4, 6.5e-4
#   bf16:      floor 4.5e-5, 2.2e-4, 5.8e-3; port 2.2e-5, 8.6e-5, 6.9e-4
STEP_BOUNDS = {
    ("bf16", "mixed_precision"): (1e-3, 5e-3, 1e-2),
    ("f32", "mixed_precision"): (1e-3, 5e-3, 5e-3),
    ("bf16", None): (1e-3, 5e-3, 1e-2),
}


@pytest.mark.parametrize("dtn,scheme", list(STEP_BOUNDS))
def test_bench_step_vs_jax(dtn, scheme):
    """Two steps of make_train_step with adamw_bf16_sr(bf16_stochastic_
    rounding=False) on a [4, B, S] batch, from the JAX state converted by
    params_from_jax / adamw_state_from_jax, against JAX's make_train_step:
    losses, grad norms and every parameter within STEP_BOUNDS; the state
    stays bf16."""
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=_JDT[dtn]), scheme)
    jopt = joptim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    jstate = jtrain.init_train_state(jp, jopt)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    jstep = jtrain.make_train_step(jcfg, jopt, donate=False)
    tstep = train.make_train_step(cfg, optim.adamw_bf16_sr(bf16_stochastic_rounding=False))
    tok, lab = _batch(1, (4, B, S))
    b_loss, b_gn, b_param = STEP_BOUNDS[(dtn, scheme)]
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), 1e-4,
                           jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, torch.from_numpy(tok), torch.from_numpy(lab), 1e-4, 1)
        jl, tl, jg, tg = float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])
        assert np.isfinite(tl) and abs(tl - jl) <= b_loss * abs(jl), (tl, jl)
        assert abs(tg - jg) <= b_gn * jg, (tg, jg)
        for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
            b = np.asarray(b, np.float64)
            assert np.linalg.norm(a.double().numpy() - b) <= b_param * np.linalg.norm(b)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tstate.opt_state.exp_avg))


def _sr_setup(remat=True, sr=True, dtype=torch.float32):
    cfg = llama.LlamaConfig(**KW, remat=remat, attention_impl="xla")
    raw = llama.init_params(torch.Generator().manual_seed(4), cfg, dtype=dtype)
    return cfg, quant.quantize_params(raw, "mixed_precision", stochastic_rounding=sr)


def test_sr_loss_and_grads_repeat_and_remat_is_bit_identical():
    """With SR on, a key fixes every draw: the same key gives the same loss
    and grads, bit for bit; per-layer remat (the forward replayed in the
    backward, with the layer's key as an argument) gives the same loss and
    grads as no remat, bit for bit; another key gives other grads."""
    tok, lab = (torch.from_numpy(a) for a in _batch(5, (B, S)))
    cfg, params = _sr_setup(remat=True)
    runs = [train.loss_and_grads(cfg, params, tok, lab, key) for key in (11, 11, 12)]
    cfg_off, params_off = _sr_setup(remat=False)
    runs.append(train.loss_and_grads(cfg_off, params_off, tok, lab, 11))
    leaves = [(loss, tree_leaves(grads)) for loss, grads in runs]
    for i in (1, 3):  # same key: again, and without remat
        assert torch.equal(leaves[i][0], leaves[0][0])
        assert all(torch.equal(a, b) for a, b in zip(leaves[i][1], leaves[0][1]))
    assert not all(torch.equal(a, b) for a, b in zip(leaves[2][1], leaves[0][1]))


def test_sr_loss_near_the_round_to_nearest_loss():
    """SR and round-to-nearest int8 give first-step losses within 1e-2 of
    each other on the same weights and batch (the bound chip_smoke.py phase
    9 holds the card to). Measured on the CPU over 8 keys: at most 1.3e-4
    relative, against a loss near ln(512) = 6.24."""
    tok, lab = (torch.from_numpy(a) for a in _batch(6, (B, S)))
    cfg, sr_params = _sr_setup(dtype=torch.bfloat16)
    rn_params = _sr_setup(sr=False, dtype=torch.bfloat16)[1]
    rn = train.loss_and_grads(cfg, rn_params, tok, lab, 0)[0].item()
    for key in range(8):
        sr = train.loss_and_grads(cfg, sr_params, tok, lab, key)[0].item()
        assert abs(sr - rn) <= 1e-2 * abs(rn)


def test_sr_configuration_step():
    """The SR configuration (llm_pretrain.py's stochastic_rounding with
    adamw_bf16_sr): a whole step is a function of its key, with every
    kernel form a plain version on the CPU; the loss falls over three steps
    on one batch; params and state stay bf16 and change."""
    cfg, params = _sr_setup(dtype=torch.bfloat16)
    opt = optim.get_optimizer("adamw_bf16_sr", weight_decay=1e-2)
    step = train.make_train_step(cfg, opt)
    tok, lab = (torch.from_numpy(a) for a in _batch(7, (B, S)))
    state0 = train.init_train_state(params, opt)
    a, ma = step(state0, tok, lab, 3e-3, 21)
    b, mb = step(state0, tok, lab, 3e-3, 21)
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    losses = [ma["loss"].item()]
    state = a
    for i in range(2):
        state, m = step(state, tok, lab, 3e-3, 22 + i)
        losses.append(m["loss"].item())
    assert losses[2] < losses[0], losses
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params))
    q0 = params["layers"]["q"]["w"].data
    assert not torch.equal(state.params["layers"]["q"]["w"].data, q0)
    assert dataclasses.asdict(state.params["layers"]["q"]["w"].config)["stochastic_rounding"]
