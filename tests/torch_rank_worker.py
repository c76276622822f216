"""One gloo rank of the port's parallel tests on the CPU
(tests/test_torch_parallel_ranks.py starts the ranks). Run as:

  python torch_rank_worker.py <port> <rank> <world> <workdir>

It reads ``<workdir>/inputs.pkl`` (numpy trees the test made from the JAX
package's init and seeds), runs every part that the world's size allows
and writes ``<workdir>/out_<rank>.pkl``:

- world 4: 3 ``mixed_precision`` steps under ``{"data": 4}``, ``{"fsdp":
  4}`` and ``{"data": 2, "fsdp": 2}`` (``adamw_bf16_sr`` without SR), 3
  more at ``{"data": 2, "fsdp": 2}`` with ``clip_grad_norm`` low enough to
  clip, and 3 bf16 steps there, each rank's losses, grad norms and (but
  the clipped run's) final state's leaves with their layout;
  ``bitnet_fsdp_linear`` at ``{"data": 2, "fsdp": 2}``, its output and
  gradients, and 2 BitNet train steps (losses, grad norms); TP prefill
  logits and greedy tokens at ``{"model": 4}`` on bf16, int8 storage and
  packed BitNet weights; the sharded resume at ``{"fsdp": 4}`` (5 steps
  against 3, a ``last_{rank}.pkl`` each, ``restore_sharded`` on a fresh
  state and 2 more); ``benchmark_collectives``;
- world 1: the ``{"fsdp": 1}`` mesh step under a world-1 process group and
  the no-mesh step, 3 ``mixed_precision`` steps each.
"""

import os
import pickle
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from quantized_training_tpu_torch import optim, parallel, quant, train  # noqa: E402
from quantized_training_tpu_torch.convert import params_from_jax  # noqa: E402
from quantized_training_tpu_torch.models import llama, llama_infer  # noqa: E402
from quantized_training_tpu_torch.parallel import collectives  # noqa: E402
from quantized_training_tpu_torch.utils import checkpoint  # noqa: E402
from quantized_training_tpu_torch.utils.tree import map_tensors  # noqa: E402


def leaves(state) -> list:
    """Every tensor of a state as numpy (fp32 for bf16), in a fixed order."""
    out = []
    map_tensors(lambda t: out.append(t.detach().float().numpy() if t.dtype == torch.bfloat16
                                     else t.detach().numpy()), state)
    return out


def run_steps(cfg, params, mesh, batches, lr, n, state=None, specs=None, scheme="mixed_precision", start=0,
              clip=None):
    """n steps from ``params`` (split on ``mesh``) or from ``state`` and its
    layout ``specs``: (state, specs, {"losses", "grad_norms"})."""
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    if state is None:
        state = train.init_train_state(quant.quantize_params(params, scheme), opt)
        if mesh is not None:
            state, specs = parallel.shard_state(state, mesh)
    step = train.make_train_step(cfg, opt, clip_grad_norm=clip, mesh=mesh, specs=specs)
    metrics = dict(losses=[], grad_norms=[])
    for i in range(start, start + n):
        tok, lab = batches[i]
        tok, lab = parallel.shard_batch((tok, lab), mesh) if mesh is not None else (torch.as_tensor(tok),
                                                                                      torch.as_tensor(lab))
        state, m = step(state, tok, lab, lr, 1000 + i)
        metrics["losses"].append(float(m["loss"]))
        metrics["grad_norms"].append(float(m["grad_norm"]))
    return state, specs, metrics


def world4(inp: dict, rank: int, workdir: str) -> dict:
    out = {}
    cfg = llama.LlamaConfig(**inp["cfg"])
    params = params_from_jax(inp["params"])
    for name, axes in inp["meshes"].items():
        mesh = parallel.make_mesh(axes, "cpu")
        state, specs, metrics = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 3)
        split = []
        map_tensors(lambda t, s: split.append(s.dim is not None), state, specs)
        out[f"train/{name}"] = dict(**metrics, leaves=leaves(state), coords=mesh.coords, split=split)
    mesh = parallel.make_mesh(inp["meshes"]["2x2"], "cpu")
    _, _, out["train/clip"] = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 3, clip=inp["clip"])
    state, specs, metrics = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 3, scheme=None)
    out["train/bf16"] = dict(**metrics, params=leaves(state.params), moments=leaves(state.opt_state), specs=specs)

    # BitNet's 2-bit all-gather: this rank's rows of x and of w
    x, w = torch.from_numpy(inp["bitnet_x"]), torch.from_numpy(inp["bitnet_w"])
    x_rows = x.chunk(mesh.dp_size)[mesh.dp_index].clone().requires_grad_(True)
    w_rows = w.chunk(mesh.shape["fsdp"])[mesh.coords["fsdp"]].clone().requires_grad_(True)
    y = parallel.bitnet_fsdp_linear(x_rows, w_rows, mesh)
    gx, gw = torch.autograd.grad((y.float() ** 2).sum(), (x_rows, w_rows))
    out["bitnet"] = dict(y=y.detach().numpy(), gx=gx.numpy(), gw=gw.numpy(), coords=mesh.coords,
                         dp_index=mesh.dp_index)
    bcfg = llama.LlamaConfig(**{**inp["cfg"], "bitnet": True})
    bparams = params_from_jax(inp["bitnet_params"])
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = train.init_train_state(parallel.bitnet_fsdp_params(quant.quantize_params(bparams, "bitnet"), mesh), opt)
    state, specs = parallel.shard_state(state, mesh)
    _, _, out["bitnet/train"] = run_steps(bcfg, None, mesh, inp["batches"], inp["lr"], 2, state=state, specs=specs)

    # tensor-parallel prefill and greedy decode
    tp = parallel.make_mesh({"model": 4}, "cpu")
    tcfg = llama.LlamaConfig(**inp["tp_cfg"])
    prompt = torch.from_numpy(inp["prompt"])
    for scheme, tree in inp["tp_params"].items():
        p_tp, specs = parallel.shard_params_tp(params_from_jax(tree), tp)
        cache = parallel.shard_kv_cache(llama_infer.KVCache.zeros(tcfg, prompt.shape[0], 32), tp)
        logits = llama_infer.forward_with_cache(p_tp, prompt, cache, 0, tcfg, mesh=tp, specs=specs).float()
        toks = llama_infer.generate(p_tp, prompt, tcfg, 8, mesh=tp, specs=specs)
        out[f"tp/{scheme}"] = dict(logits=logits.numpy(), toks=toks.numpy())

    # the sharded resume: 5 steps == 3, a file a rank, a fresh state restored, 2 more
    mesh = parallel.make_mesh({"fsdp": 4}, "cpu")
    full, _, full_run = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 5)
    part, specs, _ = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 3)
    path = checkpoint.checkpoint_name(workdir)
    checkpoint.save_checkpoint(path, {"state": part, "meta": {"step": 3}}, shard_arrays=specs)
    dist.barrier()
    fresh, specs = parallel.shard_state(train.init_train_state(
        quant.quantize_params(params, "mixed_precision"), optim.adamw_bf16_sr(bf16_stochastic_rounding=False)), mesh)
    restored = checkpoint.restore_sharded(checkpoint.load_checkpoint(path)["state"], specs)
    restored_same = all(np.array_equal(a, b) for a, b in zip(leaves(restored), leaves(part)))
    resumed, _, resumed_run = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 2, state=restored,
                                        specs=specs, start=3)
    out["resume"] = dict(full=leaves(full), resumed=leaves(resumed), full_losses=full_run["losses"],
                         resumed_losses=resumed_run["losses"], restored_same=restored_same, path=str(path),
                         fresh_differs=not all(np.array_equal(a, b) for a, b in zip(leaves(fresh), leaves(part))))

    bench = parallel.make_mesh({"data": 4}, "cpu")
    out["collectives"] = parallel.benchmark_collectives(bench, axis="data", size_mb=4, n_iters=3)
    return out


def world1(inp: dict) -> dict:
    cfg = llama.LlamaConfig(**inp["cfg"])
    params = params_from_jax(inp["params"])
    mesh = parallel.make_mesh({"fsdp": 1}, "cpu")
    meshed, _, mesh_run = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 3)
    plain, _, plain_run = run_steps(cfg, params, None, inp["batches"], inp["lr"], 3)
    return dict(mesh_run=mesh_run, plain_run=plain_run, mesh=leaves(meshed), plain=leaves(plain))


def main():
    port, rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=100))
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = world4(inp, rank, workdir) if world == 4 else world1(inp)
    out["staged"] = collectives.staged_collectives()
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
