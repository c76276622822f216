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
  state and 2 more); ``benchmark_collectives``; the C5 pins under
  ``{"data": 4}`` and ``{"fsdp": 4}`` (B5's and B4's mesh forms on the
  rank's rows of a global tensor, and the column forms the fused ops reach
  in their backward, :func:`fused_columns`) and at ``{"model": 4}`` (K1's
  mesh forms on the rank's columns); schedule-free with the 8-bit state
  under ``{"fsdp": 4}`` and ``{"data": 2, "fsdp": 2}`` (losses, grad
  norms, a checkpoint a rank after the first step and after the third);
  an 8-bit state whose blocks cross the ranks requantized under the span
  ``"blocks"``; ``QT_PREQUANT`` both, row and col under
  ``{"fsdp": 4}``; TP prefill on int4 weight-only, ``mixed_precision``,
  packed BitNet with its norms and unpacked BitNet too; the C8 pin (each
  scheme's row-parallel linear on the rank's slices, summed inside the
  linear) and the C9 pin (BitNet's abs-mean of a rank's rows and columns
  of a weight, over the whole matrix);
- world 1: the ``{"fsdp": 1}`` mesh step under a world-1 process group and
  the no-mesh step, 3 ``mixed_precision`` steps each.
"""

import contextlib
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
from quantized_training_tpu_torch.quant import core  # noqa: E402
from quantized_training_tpu_torch.utils import checkpoint  # noqa: E402
from quantized_training_tpu_torch.utils.tree import map_tensors  # noqa: E402


def leaves(state) -> list:
    """Every tensor of a state as numpy (fp32 for bf16), in a fixed order."""
    out = []
    map_tensors(lambda t: out.append(t.detach().float().numpy() if t.dtype == torch.bfloat16
                                     else t.detach().numpy()), state)
    return out


def run_steps(cfg, params, mesh, batches, lr, n, state=None, specs=None, scheme="mixed_precision", start=0,
              clip=None, opt=None):
    """n steps from ``params`` (split on ``mesh``) or from ``state`` and its
    layout ``specs``: (state, specs, {"losses", "grad_norms"}); ``opt``
    AdamW with bf16 moments, no SR, by default."""
    opt = opt or optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
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


@contextlib.contextmanager
def spied(log: list):
    """Within it, each call of a column form that the fused ops reach in
    their backward appends (its name, its int8 outputs and column scales)
    to ``log``: B5's column half, B8, B9-col, B12 (with its given scales)
    and B14 along columns (with its given scales)."""
    from quantized_training_tpu_torch.ops import fused_producers as fp
    from quantized_training_tpu_torch.ops import rope
    from quantized_training_tpu_torch.quant import fused

    picks = [(fused, "quantize_int8_both", lambda o, a, k: o[2:]),
             (fp, "rmsnorm_quant_colwise", lambda o, a, k: o),
             (fp, "silu_mul_quant_colwise", lambda o, a, k: o),
             (fp, "silu_mul_bwd_quant_colwise", lambda o, a, k: (*o, a[3], a[4])),
             (rope, "ungroup_quant", lambda o, a, k: (o, a[1]) if k.get("axis") == 0 else None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in picks]

    def spy(name, fn, pick):
        def call(*a, **k):
            out = fn(*a, **k)
            rec = pick(out, a, k)
            if rec is not None:
                log.append((name, [t.detach().clone() for t in rec]))
            return out
        return call

    for (mod, name, pick), (_, _, fn) in zip(picks, saved):
        setattr(mod, name, spy(name, fn, pick))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


FUSED_OPS = ("norm_linear_multi", "silu_mul_linear", "mlp_linear", "attn_out_linear")


def fused_columns(f: dict, index: int = 0, count: int = 1) -> dict:
    """Each fused op of the small Llama's width run forward and backward in
    'interpret' on block ``index`` of ``count`` of the rows of the numpy
    inputs ``f`` (tests/test_torch_parallel_ranks.py::_fused_inputs) and of
    its cotangents: {op: [(column form, its outputs)] in call order}."""
    from quantized_training_tpu_torch.quant import fused
    from quantized_training_tpu_torch.quant.configs import MixedPrecisionConfig
    from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight

    def t(name, dim=0):
        return torch.from_numpy(f[name]).to(torch.bfloat16).chunk(count, dim)[index].clone()

    cfg = MixedPrecisionConfig()
    ws = {k: torch.from_numpy(f[k]).to(torch.bfloat16).requires_grad_(True) for k in ("wq", "wk", "wv", "wd")}
    mp = {k: MixedPrecisionWeight(v, cfg) for k, v in ws.items()}
    x, gate, up, out_g = (t(k).requires_grad_(True) for k in ("x", "gate", "up", "out_g"))
    gamma = torch.from_numpy(f["gamma"]).to(torch.bfloat16)
    cot = t("cot")
    runs = {
        "norm_linear_multi": lambda: fused.norm_linear_multi(x, gamma, [mp["wq"], mp["wk"], mp["wv"]], 1e-5),
        "silu_mul_linear": lambda: [fused.silu_mul_linear(gate, up, mp["wd"])],
        "mlp_linear": lambda: [fused.mlp_linear(x, gamma, mp["wq"], mp["wk"], mp["wd"], 1e-5)],
        "attn_out_linear": lambda: [fused.attn_out_linear(out_g, mp["wd"], 1).reshape(-1, cot.shape[-1])],
    }
    out = {}
    fused.set_impl("interpret")
    try:
        for op, run in runs.items():
            log = []
            with spied(log):
                outs = run()
                loss = sum((o.float() * cot.float()).sum() for o in outs)
                torch.autograd.grad(loss, [x, gate, up, out_g, *ws.values()], allow_unused=True)
            out[op] = [(name, [a.numpy() if a.dtype != torch.bfloat16 else a.float().numpy() for a in ts])
                       for name, ts in log]
    finally:
        fused.set_impl("auto")
    return out


def mesh_pins(inp: dict) -> dict:
    """The C5 pins: under data 4 and fsdp 4, inside the train step's token
    span, B5's and B4's mesh forms on the rank's rows of ``pin_x`` and the
    fused ops' column forms on its rows of their inputs; at model 4 K1's
    mesh forms on the rank's columns of ``pin_x``."""
    out = {}
    x = torch.from_numpy(inp["pin_x"]).to(torch.bfloat16)
    for name in ("data", "fsdp"):
        mesh = parallel.make_mesh(inp["meshes"][name], "cpu")
        rows = x.chunk(mesh.dp_size)[mesh.dp_index].clone()
        with collectives.spanning(mesh, tokens="dp"):
            both = core.quantize_int8_both(rows, cols_over="tokens")
            cols = core.quantize_int8(rows, axis=0, over="tokens")
            fused = fused_columns(inp["fused"], mesh.dp_index, mesh.dp_size)
        out[f"pin/{name}"] = dict(both=[a.float().numpy() for a in both], cols=[a.float().numpy() for a in cols],
                                  fused=fused, dp_index=mesh.dp_index)
    tp = parallel.make_mesh({"model": 4}, "cpu")
    with collectives.spanning(tp, features="model"):
        q, s = core.quantize_int8(x.chunk(4, 1)[tp.coords["model"]].contiguous(), axis=-1, over="features")
    out["pin/model"] = dict(q=q.numpy(), s=s.float().numpy(), coord=tp.coords["model"])
    out.update(tp_pins(inp, tp))
    return out


def c8_weights(w: torch.Tensor) -> dict:
    """Each scheme's down weight [1, N, K] (a stacked layer, so that
    ``shard_params_tp`` splits it row-parallel), as a one-layer tree."""
    tree = lambda leaf: {"layers": {"down": {"w": leaf}}}  # noqa: E731
    return {"bf16": tree(w), "int8_storage": quant.quantize_params(tree(w), "int8_quantized_training"),
            "int8_activations": quant.quantize_params(tree(w), "int8_quantized_training", activation="int8"),
            "mixed_precision": quant.quantize_params(tree(w), "mixed_precision"),
            "bitnet_packed": tree(quant.BitNetPackedWeight.from_weight(w)),
            "bitnet_unpacked": quant.quantize_params(tree(w), "bitnet"),
            "int4_weight_only": quant.quantize_params(tree(w), "int4_weight_only")}


def tp_pins(inp: dict, tp) -> dict:
    """The C8 pin: each scheme's row-parallel linear on the rank's columns
    of ``c8_x`` and its slice of the weight, inside the features span (and
    BitNet's weights span): the whole product, summed over ``model`` inside
    the linear. The C9 pin: ``get_bitnet_scale`` of the rank's rows and of
    its columns of ``c8_w`` inside the weights span."""
    x = torch.from_numpy(inp["c8_x"]).to(torch.bfloat16)
    w = torch.from_numpy(inp["c8_w"]).to(torch.bfloat16)
    xs = x.chunk(4, 1)[tp.coords["model"]].contiguous()
    out = {}
    for scheme, tree in c8_weights(w[None]).items():
        local, _ = parallel.shard_params_tp(tree, tp)
        with collectives.spanning(tp, features="model", weights="model"):
            out[f"c8/{scheme}"] = quant.qlinear(xs, llama.layer_params(local["layers"], 0)["down"]["w"]).float().numpy()
    with collectives.spanning(tp, weights="model"):
        out["c9"] = dict(rows=float(core.get_bitnet_scale(w.chunk(4, 0)[tp.coords["model"]], over="weights")),
                         cols=float(core.get_bitnet_scale(w.chunk(4, 1)[tp.coords["model"]], over="weights")))
    return out


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
    prompt = torch.from_numpy(inp["prompt"])
    for scheme, tree in inp["tp_params"].items():
        tcfg = llama.LlamaConfig(**inp["tp_cfg"], bitnet=scheme in inp["tp_bitnet"])
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

    out.update(mesh_pins(inp))
    # schedule-free with the 8-bit state: each rank's pieces in a checkpoint
    for name in ("fsdp", "2x2"):
        mesh = parallel.make_mesh(inp["meshes"][name], "cpu")
        opt, paths = optim.get_optimizer("schedule_free_adamw_8bit"), {}
        state, specs, first = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 1, opt=opt)
        for when, n in (("first", 0), ("last", 2)):
            if n:
                state, specs, more = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], n, state=state,
                                               specs=specs, start=1, opt=opt)
            paths[when] = os.path.join(workdir, f"sf8_{name}_{when}_{rank}.pkl")
            checkpoint.save_checkpoint(paths[when], {"state": state}, shard_arrays=specs)
        out[f"sf8/{name}"] = dict(losses=first["losses"] + more["losses"],
                                  grad_norms=first["grad_norms"] + more["grad_norms"], paths=paths)
    # an 8-bit state whose blocks cross ranks: [2, 8, 96] over fsdp 4
    from quantized_training_tpu_torch.optim import OptimState8bit
    mesh = parallel.make_mesh(inp["meshes"]["fsdp"], "cpu")
    x = [torch.from_numpy(a) for a in inp["state8_x"]]
    (piece,), _ = parallel.shard_state([OptimState8bit.zeros(x[0].shape).requantize(x[0])], mesh)
    with collectives.spanning(mesh, blocks="fsdp"):
        piece = piece.requantize(x[1].chunk(4, 1)[mesh.coords["fsdp"]])
    out["state8/straddling"] = dict(codes=piece.codes.numpy(), scale=piece.scale.numpy(),
                                    fsdp=mesh.coords["fsdp"])
    # QT_PREQUANT's views on each rank's shards, gathered in each layer
    mesh = parallel.make_mesh(inp["meshes"]["fsdp"], "cpu")
    for mode in ("both", "row", "col"):
        os.environ["QT_PREQUANT"] = mode
        try:
            _, _, out[f"prequant/{mode}"] = run_steps(cfg, params, mesh, inp["batches"], inp["lr"], 3)
        finally:
            os.environ.pop("QT_PREQUANT")
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
