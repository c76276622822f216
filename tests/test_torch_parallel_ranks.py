"""The port's ``parallel/`` on gloo ranks on the CPU, against the JAX
package's sharded functions on JAX's 8 virtual CPU devices
(tests/conftest.py), on the same numpy inputs.

One spawn of 4 ranks (``tests/torch_rank_worker.py``) runs every part
(TINY Llama of tests/test_parallel.py: 2 layers, hidden 128, batch 8 x
32, lr 1e-3): 3 ``mixed_precision`` steps with ``adamw_bf16_sr(
bf16_stochastic_rounding=False)`` under ``{"data": 4}``, ``{"fsdp": 4}``
and ``{"data": 2, "fsdp": 2}``, held to JAX's sharded step by loss and by
pre-clip grad norm, which sees a gradient's scale where AdamW does not
(MP_LOSS_BOUND, MP_NORM_RTOL, FIRST_NORM_RTOL: every quantization maximum
now spans the mesh's axes, as in JAX's partitioned program; JAX's own
bound for sharded against one device is |dloss| < 0.05,
tests/test_parallel.py:70-86); the same at 2 x 2 with a clip that clips,
and 2 BitNet FSDP steps; the bf16 step against the port's one-process step
(loss, grad norm and the final state's shards); ``bitnet_fsdp_linear``
against JAX's (forward 1e-3, grads rtol 1e-4 / atol 1e-5,
tests/test_parallel.py:91-128); TP prefill logits at ``{"model": 4}``
against JAX's TP (rtol = atol = 0.05, :159-186, :279-323, and each
scheme's TP_LOGIT_GAP) on bf16, int8 storage (weight-only and with int8
activations), packed BitNet (with and without its o and down norms), int4
weight-only and ``mixed_precision``; the sharded resume bit for bit per
rank (tests/test_multiprocess.py's contract); ``benchmark_collectives``;
the C5 pins (B5's, B4's and K1's mesh forms and the fused ops' column
forms give a rank its rows of the one-process quantize of the global
tensor, bit for bit); schedule-free with the 8-bit state under fsdp
against the port's one process and JAX's sharded step; ``QT_PREQUANT``
under fsdp equal to the default mesh step bit for bit. A second spawn of
one rank holds the world-1 mesh step to the no-mesh step bit for bit.
Each spawn has its own timeout, so a hang fails the test.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.models import llama_infer as jinfer
from quantized_training_tpu.parallel import (bitnet_fsdp_linear, bitnet_fsdp_params, make_mesh, shard_batch,
                                             shard_kv_cache, shard_params_tp, shard_state)
from quantized_training_tpu.train import init_train_state, make_train_step
from quantized_training_tpu_torch import optim, quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.models import llama_infer
from quantized_training_tpu_torch.utils.tree import map_tensors, tree_leaves

torch.set_num_threads(1)

WORKER = Path(__file__).parent / "torch_rank_worker.py"
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=64)
TP_CFG = {**TINY, "max_position_embeddings": 48}
MESHES = {"data": {"data": 4}, "fsdp": {"fsdp": 4}, "2x2": {"data": 2, "fsdp": 2}}
LR = 1e-3
CLIP = 0.1  # the clipped run's clip_grad_norm, below every step's norm
# Bounds of the grad-norm and state checks. A gradient counted twice, not
# divided by data x fsdp, or a replicated leaf's square summed once a rank
# moves the pre-clip norm by sqrt(2) or more; AdamW's update does not see
# such a scale, so the loss bounds cannot.
NORM_RTOL = 1e-2  # BitNet's FSDP step against JAX's sharded step (3.9e-3 measured)
# The mixed-precision steps against JAX's sharded step, now that every
# quantization maximum spans the mesh (C5): loss 5.8e-5-7.1e-4 and grad norm
# 2.9e-5-8.6e-4 measured over 3 steps (before: 5.8e-5-4.8e-4, 3.0e-4-1.1e-3;
# the loss from the second step on is AdamW moving weights near a zero
# gradient apart, which C5 does not touch); the first step's grad norm,
# before AdamW moves anything, 7.8e-5-8.8e-5 (before: 3.6e-4-3.7e-4, the
# ranks' own column maxima), left to the port's one-process gap to JAX
MP_LOSS_BOUND = 2e-3
MP_NORM_RTOL = 2e-3
FIRST_NORM_RTOL = 1.5e-4
BF16_NORM_RTOL = 1e-3  # bf16 mesh step against the port's one-process step
# AdamW's bf16 moments there: sum |gap| over sum |moment| a leaf (1.2e-2
# measured, a few bf16 ulps of 2^-8; a shard built from the wrong gradient
# is off by its whole size)
MOMENT_RTOL = 5e-2
# an AdamW update moves a weight by about LR, and a gradient near 0 can flip
# its sign between the two runs: 2 LR a step, over 3 steps
PARAM_ATOL = 2 * 3 * LR
SPAWN_TIMEOUT = 120  # seconds a spawn may take before it fails
# each scheme's largest TP logit gap to JAX's TP at {"model": 4}, now that
# every row-parallel linear sums its partial products before it rounds (C8:
# int32 sums for int8 activations, mixed_precision and BitNet, fp32 partials
# for the rest): measured 5.86e-3, 5.86e-3, 9.77e-3, 7.08e-3, 5.37e-3,
# 9.77e-3, 1.758e-2, 7.08e-3 (before, with bf16 partial sums: 6.8e-3,
# 6.3e-3, 1.17e-2, 7.8e-3, 7.6e-3, 1.17e-2, 1.76e-2); bf16 logits near 1,
# whose steps are 1.95e-3-3.9e-3, so each bound sits below the next step
# above what was measured. BitNet's norms meet int8 KV ties.
TP_LOGIT_GAP = {"bf16": 7e-3, "int8_storage": 7e-3, "int8_activations": 1.1e-2, "bitnet_packed": 8e-3,
                "int4_weight_only": 7e-3, "mixed_precision": 1.1e-2, "bitnet_norms": 2e-2, "bitnet_unpacked": 8e-3}
# the 8-bit state after a step against the port's one-process run's
# (measured: 0.75-0.99 of the codes agree, 5 steps at most) and after three
# against JAX's (dequantized L1 gap 0.018-0.028, as one process's to JAX's)
SF8_AGREE = 0.6
SF8_STEPS = 8
SF8_L1_JAX = 0.05


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(workdir: Path, world: int) -> list:
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(port), str(r), str(world), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a world-{world} spawn of gloo ranks hung past {SPAWN_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
    outs = []
    for r in range(world):
        with open(workdir / f"out_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n: int = 5):
    rng = np.random.default_rng(100)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (8, 33)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _packed(params):
    return jax.tree.map(lambda x: jquant.BitNetPackedWeight.from_weight(x.data)
                        if isinstance(x, jquant.BitNetWeight) else x,
                        jquant.quantize_params(params, "bitnet"), is_leaf=jquant.is_quant_weight)


TP_BITNET = ("bitnet_norms",)  # the schemes whose model has BitNet's o_norm and down_norm
TP_SCHEMES = ["bf16", "int8_storage", "int8_activations", "bitnet_packed", "int4_weight_only", "mixed_precision",
              "bitnet_norms", "bitnet_unpacked"]


def _tp_params(cfg):
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    bitnet = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**{**TP_CFG, "bitnet": True}))
    return {"bf16": params, "int8_storage": jquant.quantize_params(params, "int8_quantized_training"),
            "int8_activations": jquant.quantize_params(params, "int8_quantized_training", activation="int8"),
            "bitnet_packed": _packed(params), "int4_weight_only": jquant.quantize_params(params, "int4_weight_only"),
            "mixed_precision": jquant.quantize_params(params, "mixed_precision"), "bitnet_norms": _packed(bitnet),
            "bitnet_unpacked": jquant.quantize_params(params, "bitnet")}


def _fused_inputs() -> dict:
    """The fused ops' inputs at the small Llama's width (hidden 128): 1,024
    tokens, so that each of 4 ranks holds 256 (B14 needs a multiple of 256),
    and the grouped attention output [8, 1, 2, 128, 64]."""
    rng = np.random.default_rng(26)
    f = {k: rng.standard_normal((1024, 128)).astype(np.float32) for k in ("x", "gate", "up", "cot")}
    f.update({k: (rng.standard_normal((128, 128)) * 0.05).astype(np.float32) for k in ("wq", "wk", "wv", "wd")})
    f["gamma"] = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    f["out_g"] = rng.standard_normal((8, 1, 2, 128, 64)).astype(np.float32)
    return f


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs, both spawns' outputs."""
    cfg = jllama.LlamaConfig(**TINY)
    kx, kw = jax.random.split(jax.random.PRNGKey(0))
    inp = dict(cfg=TINY, tp_cfg=TP_CFG, meshes=MESHES, lr=LR, clip=CLIP, batches=_batches(),
               params=_np(jllama.init_params(jax.random.PRNGKey(0), cfg)),
               bitnet_params=_np(jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**TINY, bitnet=True))),
               bitnet_x=np.asarray(jax.random.normal(kx, (16, 64), jnp.float32)),
               bitnet_w=np.asarray(jax.random.normal(kw, (32, 64), jnp.float32) * 0.05),
               prompt=np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 256, jnp.int32)),
               tp_params={k: _np(v) for k, v in _tp_params(jllama.LlamaConfig(**TP_CFG)).items()},
               tp_bitnet=TP_BITNET, fused=_fused_inputs(),
               pin_x=np.random.default_rng(5).standard_normal((64, 256)).astype(np.float32),
               c8_x=np.random.default_rng(8).standard_normal((64, 256)).astype(np.float32),
               c8_w=(np.random.default_rng(9).standard_normal((128, 256)) * 0.05).astype(np.float32),
               state8_x=[np.random.default_rng(s).random((2, 8, 96)).astype(np.float32) * 1e-3 for s in (6, 7)])
    out = {}
    for world in (4, 1):
        workdir = tmp_path_factory.mktemp(f"world{world}")
        with open(workdir / "inputs.pkl", "wb") as f:
            pickle.dump(inp, f)
        out[world] = _spawn(workdir, world)
    return inp, out


def _jax_sharded_run(inp, axes, scheme="mixed_precision", n=3, clip=None, bitnet=False, opt=None,
                     with_state=False):
    """JAX's sharded step on JAX's virtual devices: {"losses", "grad_norms"}
    (and the final state, with ``with_state``); ``opt`` AdamW with bf16
    moments, no SR, by default."""
    cfg = jllama.LlamaConfig(**TINY, bitnet=bitnet)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    opt = opt or joptim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    mesh = make_mesh(axes)
    qparams = jquant.quantize_params(params, scheme)
    if bitnet:
        qparams = bitnet_fsdp_params(qparams, mesh)
    state = shard_state(init_train_state(qparams, opt), mesh)
    step = make_train_step(cfg, opt, clip_grad_norm=clip, donate=False)
    out = dict(losses=[], grad_norms=[])
    for i in range(n):
        tok, lab = shard_batch(tuple(jnp.asarray(x) for x in inp["batches"][i]), mesh)
        state, m = step(state, tok, lab, LR, jax.random.PRNGKey(i))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    return (out, state) if with_state else out


def _rel_gap(got, ref) -> list:
    return [abs(a - b) / b for a, b in zip(got, ref)]


def _same_on_every_rank(runs) -> dict:
    """One rank's {"losses", "grad_norms"}, after checking that every rank
    reports the same global values."""
    for key in ("losses", "grad_norms"):
        assert all(r[key] == runs[0][key] for r in runs), (key, [r[key] for r in runs])
    return {key: runs[0][key] for key in ("losses", "grad_norms")}


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_steps_vs_jax(ranks, name):
    """DP, FSDP and 2 x 2: every rank reports the same global loss and grad
    norm; the loss within MP_LOSS_BOUND of JAX's sharded step at each of 3
    steps (JAX's own bound is 0.05), the pre-clip grad norm within rtol
    MP_NORM_RTOL of JAX's (the norm sees a gradient counted twice, or not
    divided by data x fsdp, which AdamW's update and so the loss do not),
    and the first step's within FIRST_NORM_RTOL (the column maxima over
    the global batch, C5); gaps printed."""
    inp, out = ranks
    got = _same_on_every_rank([o[f"train/{name}"] for o in out[4]])
    ref = _jax_sharded_run(inp, MESHES[name])
    gap, norm_gap = [abs(a - b) for a, b in zip(got["losses"], ref["losses"])], _rel_gap(got["grad_norms"],
                                                                                           ref["grad_norms"])
    print(f"{name}: port {got} JAX {ref} loss gap {gap} grad-norm relative gap {norm_gap}")
    assert max(gap) < MP_LOSS_BOUND, (got, ref)
    assert max(norm_gap) < MP_NORM_RTOL and norm_gap[0] < FIRST_NORM_RTOL, (got, ref)
    assert got["losses"][2] < got["losses"][0]


def test_clipped_sharded_step_vs_jax(ranks):
    """data 2 x fsdp 2 with clip_grad_norm CLIP below every step's norm:
    the pre-clip norm and the loss held to JAX's clipped sharded step as
    above (MP_LOSS_BOUND, MP_NORM_RTOL, FIRST_NORM_RTOL)."""
    inp, out = ranks
    got = _same_on_every_rank([o["train/clip"] for o in out[4]])
    ref = _jax_sharded_run(inp, MESHES["2x2"], clip=CLIP)
    norm_gap = _rel_gap(got["grad_norms"], ref["grad_norms"])
    print(f"clip {CLIP}: port {got} JAX {ref} grad-norm relative gap {norm_gap}")
    assert min(got["grad_norms"]) > CLIP
    assert max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])) < MP_LOSS_BOUND, (got, ref)
    assert max(norm_gap) < MP_NORM_RTOL and norm_gap[0] < FIRST_NORM_RTOL, (got, ref)


def test_replicated_state_is_identical_across_ranks(ranks):
    """After 3 steps every replicated leaf (and every split leaf between
    the data ranks that hold the same shard) is bit-identical."""
    _, out = ranks
    for name in MESHES:
        runs = [o[f"train/{name}"] for o in out[4]]
        split = runs[0]["split"]
        assert len(split) == len(runs[0]["leaves"])
        for a in runs[1:]:
            same_shard = a["coords"]["fsdp"] == runs[0]["coords"]["fsdp"]
            for s, x, y in zip(split, runs[0]["leaves"], a["leaves"]):
                if not s or same_shard:
                    assert np.array_equal(x, y), name
        if name != "data":
            assert any(split), name


def _leaves(state) -> list:
    out = []
    map_tensors(lambda t: out.append(t.detach().float().numpy()), state)
    return out


def _port_one_process(inp, opt, scheme=None, n=3):
    """The port's one-process step on the global batches: (state, {"losses",
    "grad_norms"})."""
    cfg = llama.LlamaConfig(**TINY)
    state = train.init_train_state(quant.quantize_params(params_from_jax(inp["params"]), scheme), opt)
    step = train.make_train_step(cfg, opt)
    ref = dict(losses=[], grad_norms=[])
    for i in range(n):
        tok, lab = (torch.from_numpy(x) for x in inp["batches"][i])
        state, m = step(state, tok, lab, LR, 1000 + i)
        ref["losses"].append(float(m["loss"]))
        ref["grad_norms"].append(float(m["grad_norm"]))
    return state, ref


def test_bf16_step_vs_one_process(ranks):
    """The bf16 step at data 2 x fsdp 2 against the port's one-process step
    on the global batch (the same numerics, summed in another order):
    losses within 2e-3, grad norms within rtol BF16_NORM_RTOL, and every
    rank's shard of the final state against the one-process state's: each
    AdamW moment leaf within MOMENT_RTOL of its magnitude, each parameter
    within PARAM_ATOL."""
    inp, out = ranks
    state, ref = _port_one_process(inp, optim.adamw_bf16_sr(bf16_stochastic_rounding=False))
    got = _same_on_every_rank([o["train/bf16"] for o in out[4]])
    norm_gap = _rel_gap(got["grad_norms"], ref["grad_norms"])
    param_gap, moment_gap = [], []
    for o in out[4]:
        run, specs = o["train/bf16"], o["train/bf16"]["specs"]
        mine = _leaves(map_tensors(lambda t, s: s.take(t), state.params, specs.params))
        assert [a.shape for a in mine] == [a.shape for a in run["params"]]
        param_gap.append(max(float(np.abs(a - b).max()) for a, b in zip(mine, run["params"])))
        mine = _leaves(map_tensors(lambda t, s: s.take(t), state.opt_state, specs.opt_state))
        assert [a.shape for a in mine] == [a.shape for a in run["moments"]]
        moment_gap.append(max(float(np.abs(a - b).sum() / max(np.abs(a).sum(), 1e-30))
                              for a, b in zip(mine, run["moments"])))
    print(f"bf16: port 2x2 {got['losses']} one process {ref['losses']}; grad-norm relative gap {norm_gap}; "
          f"largest parameter gap a rank {param_gap}; largest moment gap a rank (of its leaf's magnitude) "
          f"{moment_gap}")
    assert max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])) < 2e-3, (got, ref)
    assert max(norm_gap) < BF16_NORM_RTOL, (got, ref)
    assert max(moment_gap) < MOMENT_RTOL, moment_gap
    assert max(param_gap) <= PARAM_ATOL, param_gap


def test_world_one_is_the_no_mesh_step(ranks):
    """Under a world-1 process group the {"fsdp": 1} step gives the no-mesh
    step's losses, grad norms and state bit for bit."""
    _, out = ranks
    w1 = out[1][0]
    assert w1["mesh_run"] == w1["plain_run"]
    assert len(w1["mesh"]) == len(w1["plain"])
    assert all(np.array_equal(a, b) for a, b in zip(w1["mesh"], w1["plain"]))


def test_bitnet_fsdp_steps_vs_jax(ranks):
    """2 BitNet train steps at data 2 x fsdp 2 through the 2-bit all-gather
    (whose gradient the linear reduces itself, so the step must not reduce
    it again): losses within 0.05 of JAX's BitNet FSDP step, grad norms
    within rtol NORM_RTOL."""
    inp, out = ranks
    got = _same_on_every_rank([o["bitnet/train"] for o in out[4]])
    ref = _jax_sharded_run(inp, MESHES["2x2"], scheme="bitnet", n=2, bitnet=True)
    norm_gap = _rel_gap(got["grad_norms"], ref["grad_norms"])
    print(f"bitnet fsdp: port {got} JAX {ref} grad-norm relative gap {norm_gap}")
    assert all(np.isfinite(got["losses"]))
    assert max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])) < 0.05, (got, ref)
    assert max(norm_gap) < NORM_RTOL, (got, ref)


def test_bitnet_fsdp_linear_vs_jax(ranks):
    """The 2-bit all-gather linear at data 2 x fsdp 2: forward within 1e-3
    of JAX's ``bitnet_fsdp_linear``, grads within rtol 1e-4 / atol 1e-5."""
    inp, out = ranks
    mesh = make_mesh({"data": 2, "fsdp": 2})
    x, w = jnp.asarray(inp["bitnet_x"]), jnp.asarray(inp["bitnet_w"])
    y_ref = np.asarray(bitnet_fsdp_linear(x, w, mesh))
    gx_ref, gw_ref = (np.asarray(g) for g in jax.grad(
        lambda x, w: (bitnet_fsdp_linear(x, w, mesh).astype(jnp.float32) ** 2).sum(), argnums=(0, 1))(x, w))
    ranked = sorted(out[4], key=lambda o: o["bitnet"]["dp_index"])
    y = np.concatenate([o["bitnet"]["y"] for o in ranked])
    gx = np.concatenate([o["bitnet"]["gx"] for o in ranked])
    np.testing.assert_allclose(y, y_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gx, gx_ref, rtol=1e-4, atol=1e-5)
    for o in out[4]:
        f = o["bitnet"]["coords"]["fsdp"]
        np.testing.assert_allclose(o["bitnet"]["gw"], np.split(gw_ref, 2)[f], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scheme", TP_SCHEMES)
def test_tp_prefill_vs_jax(ranks, scheme):
    """TP prefill logits at {"model": 4} within rtol = atol = 0.05 of JAX's
    TP, the same on every rank, and their largest gap within
    ``TP_LOGIT_GAP`` (the quantizes of o's and down's inputs take the global
    row's maxima; BitNet's norms sum their squares over ``model``); greedy
    tokens agree with JAX's TP decode at 90% or more, or else each sequence
    that parts from JAX's parts at a tie (``_first_parting_gaps``: JAX's
    logit of the port's token within the scheme's TP_LOGIT_GAP of JAX's
    largest) and the tokens agree at least as well as the port's
    one-process decode's do (bf16 at this prompt: 0.875, one sequence
    parting at a near-tie, as the port's one process does); with BitNet's
    norms at least as well as the port's one-process decode does (ternary
    products meet int8 KV ties there: the port and JAX part at near-ties
    whatever the mesh)."""
    inp, out = ranks
    cfg = jllama.LlamaConfig(**TP_CFG, bitnet=scheme in TP_BITNET)
    params = _tp_params(cfg)[scheme]
    mesh = make_mesh({"model": 4})
    p_tp = shard_params_tp(params, mesh)
    prompt = jnp.asarray(inp["prompt"])
    cache = jinfer.KVCache.zeros(cfg, 2, 32)
    ref = np.asarray(jinfer.forward_with_cache(p_tp, prompt, cache, 0, cfg)[0].astype(jnp.float32))
    toks = np.asarray(jinfer.generate(p_tp, prompt, cfg, 8, mesh=mesh))
    for o in out[4]:
        np.testing.assert_allclose(o[f"tp/{scheme}"]["logits"], ref, rtol=0.05, atol=0.05)
        assert np.array_equal(o[f"tp/{scheme}"]["toks"], out[4][0][f"tp/{scheme}"]["toks"])
    gap = float(np.abs(out[4][0][f"tp/{scheme}"]["logits"] - ref).max())
    print(f"tp {scheme}: largest logit gap to JAX's TP {gap:.3e} (of max |logit| {np.abs(ref).max():.3e})")
    assert gap < TP_LOGIT_GAP[scheme], gap
    ours = out[4][0][f"tp/{scheme}"]["toks"]
    agree = (ours == toks).mean()
    one = llama_infer.generate(params_from_jax(_np(params)), torch.from_numpy(inp["prompt"]),
                               llama.LlamaConfig(**TP_CFG, bitnet=scheme in TP_BITNET), 8).numpy()
    if scheme in TP_BITNET:
        assert agree >= (one == toks).mean(), (agree, (one == toks).mean())
    elif agree <= 0.9:
        ties = _first_parting_gaps(p_tp, toks, ours, prompt.shape[1], cfg, mesh)
        print(f"tp {scheme}: greedy agreement {agree:.3f}, JAX's logit gaps where a sequence parts {ties}")
        assert ties and max(ties) < TP_LOGIT_GAP[scheme], (agree, ties)
        assert agree >= (one == toks).mean(), (agree, (one == toks).mean())


def _first_parting_gaps(p_tp, toks, ours, t0, cfg, mesh) -> list:
    """For each sequence where the port's greedy tokens part from JAX's TP
    decode ``toks``, JAX's largest logit less its logit of the port's token
    at the first position they part: JAX's decode replayed on its own
    tokens (the prefill, then one cached step a token), so the logits are
    the ones its argmax read."""
    cache = shard_kv_cache(jinfer.KVCache.zeros(cfg, toks.shape[0], toks.shape[1]), mesh)
    logits, cache = jinfer.forward_with_cache(p_tp, jnp.asarray(toks[:, :t0]), cache, 0, cfg, flash_prefill=False)
    steps = [np.asarray(logits[:, -1].astype(jnp.float32))]
    for i in range(toks.shape[1] - t0 - 1):
        logits, cache = jinfer.forward_with_cache(p_tp, jnp.asarray(toks[:, t0 + i:t0 + i + 1]), cache, t0 + i, cfg)
        steps.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    gaps = []
    for b in range(toks.shape[0]):
        parted = np.flatnonzero(ours[b, t0:] != toks[b, t0:])
        if parted.size:
            row = steps[parted[0]][b]
            gaps.append(float(row.max() - row[ours[b, t0 + parted[0]]]))
    return gaps


def test_sharded_resume_bit_for_bit(ranks):
    """5 steps == 3 steps, a ``last_{rank}.pkl`` each, restore_sharded on a
    fresh state, 2 more steps: bit for bit on every rank's shards, and the
    same losses."""
    _, out = ranks
    for r, o in enumerate(out[4]):
        res = o["resume"]
        assert Path(res["path"]).name == f"last_{r}.pkl"
        assert res["restored_same"] and res["fresh_differs"]
        assert res["resumed_losses"] == res["full_losses"][3:]
        assert all(np.array_equal(a, b) for a, b in zip(res["full"], res["resumed"]))


def test_materialize_from_full_coverage(ranks, tmp_path):
    """Every rank's pieces of a split leaf together materialize the full
    tensor; one rank's alone raise JAX's error."""
    from quantized_training_tpu_torch.utils import checkpoint

    _, out = ranks
    loaded = [checkpoint.load_checkpoint(o["resume"]["path"])["state"] for o in out[4]]
    emb = [s.params["embed"]["embedding"] for s in loaded]
    assert isinstance(emb[0], checkpoint.ShardedLeaf) and len({tuple(e.shards[0][0]) for e in emb}) == 4
    merged = checkpoint.ShardedLeaf(emb[0].global_shape, emb[0].dtype, [p for e in emb for p in e.shards])
    full = checkpoint.materialize({"x": merged})["x"]
    assert tuple(full.shape) == emb[0].global_shape
    for e in emb:
        (region, data), = e.shards
        assert torch.equal(full[tuple(slice(a, b) for a, b in region)], data)
    with pytest.raises(ValueError, match="do not cover"):
        checkpoint.materialize({"x": emb[0]})


def test_benchmark_collectives_runs(ranks):
    """Three positive GiB/s figures on 4 gloo ranks."""
    _, out = ranks
    for o in out[4]:
        assert set(o["collectives"]) == {"psum_GiBps", "all_gather_GiBps", "psum_scatter_GiBps"}
        assert all(v > 0 for v in o["collectives"].values())


# ---- C5: the maxima over the axes the mesh splits ---------------------------


def _rows(ref: np.ndarray, index: int, count: int = 4) -> np.ndarray:
    """Block ``index`` of ``count`` of ``ref``'s rows, or ``ref`` itself for
    a scale row [1, K]."""
    ref = ref.reshape(-1, ref.shape[-1])
    return ref if ref.shape[0] == 1 else np.split(ref, count)[index]


@pytest.mark.parametrize("name", ["data", "fsdp"])
@pytest.mark.parametrize("form", ["both", "cols"])
def test_c5_pin_b5_b4_mesh_forms(ranks, name, form):
    """Under {"data": 4} / {"fsdp": 4}, inside the train step's token span:
    each rank's int8 values and scales from B5's (``quantize_int8_both``
    with ``cols_over="tokens"``) and B4's (``quantize_int8(axis=0,
    over="tokens")``) mesh forms are its rows of the one-process quantize
    of the global tensor, and its column scales the global ones, bit for bit
    at round-to-nearest. The rank's own maxima would differ: the pin bites."""
    inp, out = ranks
    x = torch.from_numpy(inp["pin_x"]).to(torch.bfloat16)
    ref = quant.core.quantize_int8_both(x) if form == "both" else quant.core.quantize_int8(x, axis=0)
    ref = [a.float().numpy() for a in ref]
    for o in out[4]:
        pin = o[f"pin/{name}"]
        for got, r in zip(pin[form], ref):
            assert np.array_equal(got.reshape(-1, r.shape[-1]), _rows(r, pin["dp_index"]))
        local = quant.core.quantize_int8(x.chunk(4)[pin["dp_index"]], axis=0)[1].float().numpy()
        assert not np.array_equal(local, ref[-1])


@pytest.fixture(scope="module")
def fused_ref(ranks):
    """The fused ops' column forms on the global inputs, in one process."""
    import torch_rank_worker

    return torch_rank_worker.fused_columns(ranks[0]["fused"])


@pytest.mark.parametrize("name", ["data", "fsdp"])
@pytest.mark.parametrize("op", ["norm_linear_multi", "silu_mul_linear", "mlp_linear", "attn_out_linear"])
def test_c5_pin_fused_column_forms(ranks, fused_ref, name, op):
    """The fused ops of the small Llama's width forward and backward on a
    rank's 256 of 1,024 tokens ('interpret', inside the token span): every
    column form their backward reaches (B5's column half, B8, B9-col, B12
    with its given scales, B14 along columns with its given scales) gives
    the rank's rows of the one-process run's int8 and the global column
    scales, bit for bit."""
    _, out = ranks
    ref = fused_ref[op]
    assert ref, op
    for o in out[4]:
        pin = o[f"pin/{name}"]
        got = pin["fused"][op]
        assert [n for n, _ in got] == [n for n, _ in ref]
        for (form, g), (_, r) in zip(got, ref):
            for a, b in zip(g, r):
                assert np.array_equal(a.reshape(-1, b.shape[-1]), _rows(b, pin["dp_index"])), (op, form)


def test_c5_pin_tp_row_scales(ranks):
    """At {"model": 4}, inside a row-parallel linear's span: K1's mesh forms
    on a rank's 64 of 256 columns give the one-process row scales and the
    rank's columns of its int8, bit for bit."""
    inp, out = ranks
    q, s = quant.core.quantize_int8(torch.from_numpy(inp["pin_x"]).to(torch.bfloat16), axis=-1)
    for o in out[4]:
        pin = o["pin/model"]
        assert np.array_equal(pin["s"], s.float().numpy())
        assert np.array_equal(pin["q"], q.chunk(4, 1)[pin["coord"]].numpy())


# ---- C8 and C9: the sums over the axis that TP splits --------------------------


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (2**-133 at 0, the least subnormal)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return np.exp2(e - 7)


C8_SCHEMES = ["bf16", "int8_storage", "int8_activations", "mixed_precision", "bitnet_packed", "bitnet_unpacked",
              "int4_weight_only"]


@pytest.mark.parametrize("scheme", C8_SCHEMES)
def test_c8_pin_row_parallel_sums(ranks, scheme):
    """At {"model": 4}: a row-parallel linear on a rank's 64 of 256
    features, summed over ``model`` inside the linear (the int8 paths' int32
    sums before the scales, the others' fp32 partials), is the one-process
    linear within one bf16 ulp on every element, on every rank."""
    import importlib

    worker = importlib.import_module("torch_rank_worker")
    inp, out = ranks
    x = torch.from_numpy(inp["c8_x"]).to(torch.bfloat16)
    tree = worker.c8_weights(torch.from_numpy(inp["c8_w"]).to(torch.bfloat16)[None])[scheme]
    ref = quant.qlinear(x, llama.layer_params(tree["layers"], 0)["down"]["w"]).float().numpy()
    for o in out[4]:
        got = o[f"c8/{scheme}"]
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), np.abs(got - ref).max()
    if scheme in ("int8_activations", "mixed_precision", "bitnet_packed", "bitnet_unpacked"):
        assert np.array_equal(out[4][0][f"c8/{scheme}"], ref)  # the int32 sums: the same bits


def test_c9_pin_bitnet_scale_spans_the_matrix(ranks):
    """At {"model": 4}, inside the weights span: ``get_bitnet_scale`` of
    a rank's rows and of its columns of a [128, 256] weight is the whole
    matrix's abs-mean within one fp32 ulp, on every rank."""
    inp, out = ranks
    whole = float(quant.core.get_bitnet_scale(torch.from_numpy(inp["c8_w"]).to(torch.bfloat16)))
    ulp = float(np.spacing(np.float32(whole)))
    for o in out[4]:
        assert abs(o["c9"]["rows"] - whole) <= ulp and abs(o["c9"]["cols"] - whole) <= ulp, (o["c9"], whole)


# ---- the configurations the port refused under a mesh ------------------------


def _merged(states: list):
    """The global tree from every rank's checkpointed pieces."""
    from quantized_training_tpu_torch.utils import checkpoint

    def merge(first, *rest):
        if not isinstance(first, checkpoint.ShardedLeaf):
            return first
        return checkpoint.ShardedLeaf(first.global_shape, first.dtype, [p for l in (first, *rest) for p in l.shards])

    return checkpoint.materialize(map_tensors(merge, states[0], *states[1:],
                                              is_leaf=lambda t: isinstance(t, (checkpoint.ShardedLeaf, torch.Tensor))))


def _codes_gap(mine, theirs) -> tuple[list, list, list]:
    """Leaf by leaf: the share of codes that agree, the largest difference
    in codebook steps, and sum |a - b| / sum |b| of the dequantized states."""
    agree, steps, l1 = [], [], []
    for a, b in zip(mine, theirs):
        codes, other = a.codes.numpy().astype(np.int32), np.asarray(b.codes).astype(np.int32)
        da, db = a.dequantize().numpy(), np.asarray(b.dequantize())
        agree.append(float((codes == other).mean()))
        steps.append(int(np.abs(codes - other).max()))
        l1.append(float(np.abs(da - db).sum() / np.abs(db).sum()))
    return agree, steps, l1


@pytest.mark.parametrize("name", ["fsdp", "2x2"])
def test_schedule_free_8bit_state_sharded_vs_jax(ranks, name):
    """Schedule-free with the 8-bit ``exp_avg_sq`` under {"fsdp": 4} and
    data 2 x fsdp 2 (JAX refuses nothing there; the port used to): losses
    within MP_LOSS_BOUND of JAX's sharded step, grad norms within
    MP_NORM_RTOL (the first step's within FIRST_NORM_RTOL); the
    global state that ``materialize`` assembles from every rank's
    checkpoint, in JAX's flat order and shapes: after the first step
    against the port's one-process run's (codes that agree at SF8_AGREE or
    more, within SF8_STEPS codebook steps: only the rounding of the
    gradients' sums over the ranks differs; later steps also move weights
    near a zero gradient apart), after the third against JAX's sharded
    step's (the dequantized states within SF8_L1_JAX, as the port's
    one-process run is of JAX's one device: JAX's elementwise gradients
    round differently)."""
    from quantized_training_tpu.optim.state8bit import OptimState8bit as JState8bit
    from quantized_training_tpu_torch.optim import OptimState8bit
    from quantized_training_tpu_torch.utils import checkpoint

    inp, out = ranks
    got = _same_on_every_rank([o[f"sf8/{name}"] for o in out[4]])
    ref, jstate = _jax_sharded_run(inp, MESHES[name], opt=joptim.get_optimizer("schedule_free_adamw_8bit"),
                                   with_state=True)
    one, one_run = _port_one_process(inp, optim.get_optimizer("schedule_free_adamw_8bit"), "mixed_precision", n=1)
    norm_gap = _rel_gap(got["grad_norms"], ref["grad_norms"])
    first, last = (_merged([checkpoint.load_checkpoint(o[f"sf8/{name}"]["paths"][w])["state"] for o in out[4]])
                   for w in ("first", "last"))
    is8 = lambda t: isinstance(t, (OptimState8bit, JState8bit))  # noqa: E731
    first, single, last, theirs = ([l for l in leaves if is8(l)] for leaves in (
        tree_leaves(first.opt_state.exp_avg_sq, is_leaf=is8), tree_leaves(one.opt_state.exp_avg_sq, is_leaf=is8),
        tree_leaves(last.opt_state.exp_avg_sq, is_leaf=is8), jax.tree.leaves(jstate.opt_state.exp_avg_sq, is_leaf=is8)))
    assert last and len(first) == len(single) == len(last) == len(theirs)
    for a, b in zip(last, theirs):
        assert a.shard is None and tuple(a.shape) == tuple(b.shape) and a.codes.shape == b.codes.shape
    agree, steps, _ = _codes_gap(first, single)
    _, _, l1 = _codes_gap(last, theirs)
    print(f"sf8 {name}: port {got} JAX {ref} grad-norm gap to JAX {norm_gap}; after a step against one process "
          f"(loss {one_run['losses']}): codes agreeing a leaf {agree}, largest step {steps}; after three, the "
          f"dequantized L1 gap to JAX {l1}")
    assert max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])) < MP_LOSS_BOUND, (got, ref)
    assert max(norm_gap) < MP_NORM_RTOL and norm_gap[0] < FIRST_NORM_RTOL, (got, ref)
    assert min(agree) >= SF8_AGREE and max(steps) <= SF8_STEPS, (agree, steps)
    assert max(l1) <= SF8_L1_JAX, l1


def test_8bit_state_blocks_across_ranks(ranks):
    """An 8-bit state [2, 8, 96] under {"fsdp": 4}, whose ranks' runs of
    192 elements end inside the blocks of 256: each rank's requantize
    (each block's maximum over its elements, all-reduced over fsdp) gives
    the global requantize's scales and its elements' codes, bit for bit."""
    from quantized_training_tpu_torch.optim import OptimState8bit

    inp, out = ranks
    x = [torch.from_numpy(a) for a in inp["state8_x"]]
    ref = OptimState8bit.zeros(x[0].shape).requantize(x[1])
    codes = ref.codes.reshape(x[0].shape)
    for o in out[4]:
        got = o["state8/straddling"]
        assert np.array_equal(got["scale"], ref.scale.numpy())
        assert np.array_equal(got["codes"], codes.chunk(4, 1)[got["fsdp"]].reshape(-1).numpy())


@pytest.mark.parametrize("mode", ["both", "row", "col"])
def test_prequant_under_fsdp_is_the_default_step(ranks, mode):
    """QT_PREQUANT under {"fsdp": 4} (each rank's views of its shards, the
    maxima that cross ranks all-reduced, gathered in each layer): losses and
    grad norms equal to the QT_PREQUANT=0 mesh step's, bit for bit, on every
    rank."""
    _, out = ranks
    for o in out[4]:
        got, ref = o[f"prequant/{mode}"], o["train/fsdp"]
        assert got["losses"] == ref["losses"] and got["grad_norms"] == ref["grad_norms"], (mode, got, ref)
