"""The port's ``parallel/`` on gloo ranks on the CPU, against the JAX
package's sharded functions on JAX's 8 virtual CPU devices
(tests/conftest.py), on the same numpy inputs.

One spawn of 4 ranks (``tests/torch_rank_worker.py``) runs every part
(TINY Llama of tests/test_parallel.py: 2 layers, hidden 128, batch 8 x
32, lr 1e-3): 3 ``mixed_precision`` steps with ``adamw_bf16_sr(
bf16_stochastic_rounding=False)`` under ``{"data": 4}``, ``{"fsdp": 4}``
and ``{"data": 2, "fsdp": 2}``, held to JAX's sharded step by JAX's own
bound for sharded against one device (|dloss| < 0.05,
tests/test_parallel.py:70-86), and by their pre-clip grad norms, which see
a gradient's scale where AdamW does not; the same at 2 x 2 with a clip that
clips, and 2 BitNet FSDP steps; the bf16 step against the port's
one-process step (loss, grad norm and the final state's shards);
``bitnet_fsdp_linear`` against JAX's (forward 1e-3, grads rtol 1e-4 /
atol 1e-5, tests/test_parallel.py:91-128); TP prefill logits at
``{"model": 4}`` against JAX's TP (rtol = atol = 0.05, :159-186, :279-323)
on bf16, int8 storage and packed BitNet; the sharded resume bit for bit per
rank (tests/test_multiprocess.py's contract); ``benchmark_collectives``. A
second spawn of one rank holds the world-1 mesh step to the no-mesh step
bit for bit. Each spawn has its own timeout, so a hang fails the test.

A port rank quantizes over its own tokens (the reference's DDP and FSDP2
do too), where JAX's partitioned program takes column maxima over the
global batch: the mixed-precision losses differ from JAX's by that
departure (printed; ROADMAP C), inside JAX's bound.
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
                                             shard_params_tp, shard_state)
from quantized_training_tpu.train import init_train_state, make_train_step
from quantized_training_tpu_torch import optim, quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.utils.tree import map_tensors

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
NORM_RTOL = 1e-2  # against JAX's sharded step (the ranks' own quantization maxima: ROADMAP C5)
BF16_NORM_RTOL = 1e-3  # bf16 mesh step against the port's one-process step
# AdamW's bf16 moments there: sum |gap| over sum |moment| a leaf (1.2e-2
# measured, a few bf16 ulps of 2^-8; a shard built from the wrong gradient
# is off by its whole size)
MOMENT_RTOL = 5e-2
# an AdamW update moves a weight by about LR, and a gradient near 0 can flip
# its sign between the two runs: 2 LR a step, over 3 steps
PARAM_ATOL = 2 * 3 * LR
SPAWN_TIMEOUT = 120  # seconds a spawn may take before it fails


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


def _tp_params(cfg):
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    packed = jax.tree.map(lambda x: jquant.BitNetPackedWeight.from_weight(x.data)
                          if isinstance(x, jquant.BitNetWeight) else x,
                          jquant.quantize_params(params, "bitnet"), is_leaf=jquant.is_quant_weight)
    return {"bf16": params, "int8_storage": jquant.quantize_params(params, "int8_quantized_training"),
            "bitnet_packed": packed}


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
               tp_params={k: _np(v) for k, v in _tp_params(jllama.LlamaConfig(**TP_CFG)).items()})
    out = {}
    for world in (4, 1):
        workdir = tmp_path_factory.mktemp(f"world{world}")
        with open(workdir / "inputs.pkl", "wb") as f:
            pickle.dump(inp, f)
        out[world] = _spawn(workdir, world)
    return inp, out


def _jax_sharded_run(inp, axes, scheme="mixed_precision", n=3, clip=None, bitnet=False):
    """JAX's sharded step on JAX's virtual devices: {"losses", "grad_norms"}."""
    cfg = jllama.LlamaConfig(**TINY, bitnet=bitnet)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    opt = joptim.adamw_bf16_sr(bf16_stochastic_rounding=False)
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
    return out


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
    norm; the loss within 0.05 of JAX's sharded step at each of 3 steps
    (JAX's bound), the pre-clip grad norm within rtol NORM_RTOL of JAX's
    (the norm sees a gradient counted twice, or not divided by data x
    fsdp, which AdamW's update and so the loss do not); gaps printed."""
    inp, out = ranks
    got = _same_on_every_rank([o[f"train/{name}"] for o in out[4]])
    ref = _jax_sharded_run(inp, MESHES[name])
    gap, norm_gap = [abs(a - b) for a, b in zip(got["losses"], ref["losses"])], _rel_gap(got["grad_norms"],
                                                                                           ref["grad_norms"])
    print(f"{name}: port {got} JAX {ref} loss gap {gap} grad-norm relative gap {norm_gap}")
    assert max(gap) < 0.05, (got, ref)
    assert max(norm_gap) < NORM_RTOL, (got, ref)
    assert got["losses"][2] < got["losses"][0]


def test_clipped_sharded_step_vs_jax(ranks):
    """data 2 x fsdp 2 with clip_grad_norm CLIP below every step's norm:
    the pre-clip norm and the loss held to JAX's clipped sharded step as
    above."""
    inp, out = ranks
    got = _same_on_every_rank([o["train/clip"] for o in out[4]])
    ref = _jax_sharded_run(inp, MESHES["2x2"], clip=CLIP)
    norm_gap = _rel_gap(got["grad_norms"], ref["grad_norms"])
    print(f"clip {CLIP}: port {got} JAX {ref} grad-norm relative gap {norm_gap}")
    assert min(got["grad_norms"]) > CLIP
    assert max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])) < 0.05, (got, ref)
    assert max(norm_gap) < NORM_RTOL, (got, ref)


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


def test_bf16_step_vs_one_process(ranks):
    """The bf16 step at data 2 x fsdp 2 against the port's one-process step
    on the global batch (the same numerics, summed in another order):
    losses within 2e-3, grad norms within rtol BF16_NORM_RTOL, and every
    rank's shard of the final state against the one-process state's: each
    AdamW moment leaf within MOMENT_RTOL of its magnitude, each parameter
    within PARAM_ATOL."""
    inp, out = ranks
    cfg = llama.LlamaConfig(**TINY)
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = train.init_train_state(params_from_jax(inp["params"]), opt)
    step = train.make_train_step(cfg, opt)
    ref = dict(losses=[], grad_norms=[])
    for i in range(3):
        tok, lab = (torch.from_numpy(x) for x in inp["batches"][i])
        state, m = step(state, tok, lab, LR, 1000 + i)
        ref["losses"].append(float(m["loss"]))
        ref["grad_norms"].append(float(m["grad_norm"]))
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


@pytest.mark.parametrize("scheme", ["bf16", "int8_storage", "bitnet_packed"])
def test_tp_prefill_vs_jax(ranks, scheme):
    """TP prefill logits at {"model": 4} within rtol = atol = 0.05 of JAX's
    TP, the same on every rank; greedy tokens agree with JAX's TP decode
    at 90% or more (argmax ties aside)."""
    inp, out = ranks
    cfg = jllama.LlamaConfig(**TP_CFG)
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
    agree = (out[4][0][f"tp/{scheme}"]["toks"] == toks).mean()
    assert agree > 0.9, agree


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
