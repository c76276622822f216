"""LLM pretraining driver of the port.

Counterpart of the JAX package's ``llm_pretrain.py``, with its flags but
``--cache_dir`` (XLA's compilation cache): ``--quantize`` /
``--quantize_kwargs`` (``--quantize_lm_head`` quantizes the lm_head too), a
``--train_ds`` JSON (``token``, ``synthetic``, ``markov`` or ``hf_text``,
shuffled through a 1000-sample buffer; ``--native_loader`` reads ``token``
shards with the C++ loader instead), gradient accumulation, an LR schedule
(``--lr_schedule_kwargs``), grad clipping, any optimizer of
``optim.get_optimizer``, and checkpoint/resume: ``last.pkl`` every
``--ckpt_interval`` steps holds the train state, the loader's state and the
step, and ``--resume`` restores all three. Every ``--log_interval`` steps
(and at the last) it logs the loss, the grad norm, the lr, tokens/s (after
the step has finished) and the peak device memory to stdout and to
``<save_dir>/<time>_<run_name>/metrics.jsonl``, beside ``args.json``.
``--profile`` runs at most 5 steps under ``torch.profiler`` and writes a
Chrome trace into the run directory. ``--hellaswag`` scores HellaSwag every
``--hellaswag_interval`` steps on the merged masters
(``hellaswag.evaluate_hellaswag`` on the hub's validation split, tokenized
by ``--hellaswag_tokenizer``), logs ``hellaswag_acc`` and prints it.

Parameters come from ``torch.Generator(device).manual_seed(seed)``, and step
i takes the key ``fold_in(seed, 1_000_000 + i)`` (an int key,
``ops/random.py``). It runs on the CUDA card unless ``--cpu`` is given, and
raises without a card.

``--mesh '{"data": N}'`` / ``'{"fsdp": N}'`` (JAX :170-228): data
parallelism and FSDP over processes, one a device, started by ``torchrun``
(its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; rank 0 of a world of 1 where they are unset). The backend
is NCCL on the card (device ``cuda:LOCAL_RANK``) and gloo under ``--cpu``.
In JAX's order: BitNet's weights take the 2-bit all-gather
(``parallel.bitnet_fsdp_params``) before the state is made, the state is
split (``parallel.shard_state``), ``--resume`` restores each rank's pieces
(``restore_sharded``), and every rank reads the same global batch of
``--batch_size`` rows and keeps its own (``parallel.shard_batch``). Every
rank saves its own ``last_{rank}.pkl``; ``--resume`` names one of them (or
their directory) and each rank reads its own. Only rank 0 logs.

  torchrun --nproc_per_node 2 -m quantized_training_tpu_torch.llm_pretrain --mesh '{"fsdp": 2}' ...

  python -m quantized_training_tpu_torch.llm_pretrain --model mini_llamas/Llama-2-470m \\
      --quantize mixed_precision --activation_checkpointing \\
      --train_ds '{"type": "markov"}' --batch_size 4 --seq_len 2048 --n_steps 20
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import hellaswag, optim, parallel, quant, train
from .data import BatchLoader, ShuffleDataset, get_dataset
from .models import llama
from .ops.random import fold_in
from .parallel.fsdp import gather
from .parallel.mesh import param_specs
from .quant.api import _is_linear_weight_path
from .utils import (LRSchedule, MetricLogger, checkpoint_name, load_checkpoint, print_model_stats, restore_sharded,
                    save_checkpoint)

MODELS = {"llama2-470m": llama.LLAMA2_470M, "llama2-1b": llama.LLAMA2_1B}


def model_config(name: str, **overrides) -> llama.LlamaConfig:
    """A preset by name, else the HF-format config at the path ``name``,
    with ``overrides``."""
    cfg = MODELS[name] if name in MODELS else llama.LlamaConfig.from_hf_json(name)
    return dataclasses.replace(cfg, **overrides)


def device_of(cpu: bool, driver: str) -> str:
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(f"{driver}: no CUDA card; pass --cpu to run on the CPU")
    return "cpu" if cpu else "cuda"


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Pretrain a Llama with the PyTorch port.")
    parser.add_argument("--model", default="llama2-470m",
                        help="llama2-470m | llama2-1b | path to an HF-format config.json dir")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize_lm_head", action="store_true")
    parser.add_argument("--activation_checkpointing", action="store_true")

    parser.add_argument("--train_ds", type=json.loads, required=True)
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--seq_len", type=int, default=2048)
    parser.add_argument("--gradient_accumulation", type=int, default=1)

    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-2)
    parser.add_argument("--optim_kwargs", type=json.loads, default=dict())
    parser.add_argument("--lr_schedule_kwargs", type=json.loads)
    parser.add_argument("--clip_grad_norm", type=float)

    parser.add_argument("--mesh", type=json.loads,
                        help='data/fsdp mesh over torchrun processes, e.g. \'{"fsdp": 2}\'')

    parser.add_argument("--hellaswag", action="store_true")
    parser.add_argument("--hellaswag_tokenizer", default="llama3")
    parser.add_argument("--hellaswag_interval", type=int, default=1000)

    parser.add_argument("--resume")
    parser.add_argument("--ckpt_interval", type=int, default=1000)
    parser.add_argument("--run_name", default="run")
    parser.add_argument("--save_dir", default="runs/llm_pretrain", help="base directory for run artifacts")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--native_loader", action="store_true",
                        help="read token shards with the C++ prefetching loader (built at first use)")
    return parser


def make_loader(args, cfg: llama.LlamaConfig, micro_bs: int):
    """The training batches: the native loader over ``token`` shards, or
    the dataset shuffled through ``max(4 * micro_bs, 1000)`` samples and
    batched with prefetch."""
    if args.train_ds.get("type") == "synthetic":
        args.train_ds.setdefault("vocab_size", cfg.vocab_size)
    if args.native_loader:
        from .data.native_loader import NativeTokenLoader

        if args.train_ds.get("type") != "token":
            raise ValueError("--native_loader needs a token dataset")
        return NativeTokenLoader(args.train_ds["dataset_dir"], args.seq_len, micro_bs, seed=args.seed)
    ds = get_dataset(seq_len=args.seq_len, eval=False, seed=args.seed, **args.train_ds)
    return BatchLoader(ShuffleDataset(ds, buffer_size=max(micro_bs * 4, 1000), seed=args.seed), batch_size=micro_bs)


def init_distributed(cpu: bool) -> str:
    """The process group from ``torchrun``'s environment (gloo under
    ``--cpu``, NCCL on the card; rank 0 of 1 where it is unset); returns
    this rank's device."""
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ.setdefault("MASTER_PORT", "29500")
    device = "cpu" if cpu else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if not cpu:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl", rank=rank, world_size=world)
    return device


def main(argv: list[str] | None = None) -> dict:
    """Runs the driver; returns the run directory, the final state and the
    seconds the first batch took (``{"save_dir", "state", "first_batch_s"}``)
    for a caller in the same process."""
    args = _parser().parse_args(argv)
    device = device_of(args.cpu, "llm_pretrain")
    mesh = None
    if args.mesh:
        device = init_distributed(args.cpu)
        mesh = parallel.make_mesh(args.mesh, "cpu" if args.cpu else "cuda")
    lead = mesh is None or dist.get_rank() == 0  # the rank that logs
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()  # peak_memory_gb is this run's
    if args.profile:
        args.n_steps = min(args.n_steps, 5)

    cfg = model_config(args.model, max_position_embeddings=args.seq_len, remat=args.activation_checkpointing,
                       bitnet=args.quantize == "bitnet", **args.model_kwargs)
    key = args.seed  # an int key (ops/random.py)
    params = llama.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)

    def not_lm_head(path, leaf):
        return _is_linear_weight_path(path) and (args.quantize_lm_head or "lm_head" not in path)

    qparams = quant.quantize_params(params, args.quantize, filter_fn=not_lm_head, **args.quantize_kwargs)
    if lead:
        print_model_stats(params)
    del params
    if mesh is not None and args.quantize == "bitnet":
        qparams = parallel.bitnet_fsdp_params(qparams, mesh)  # before the state mirrors the wrappers

    optimizer = optim.get_optimizer(args.optim, weight_decay=args.weight_decay, **args.optim_kwargs)
    lr_schedule = (LRSchedule(args.lr, args.n_steps, **args.lr_schedule_kwargs)
                   if args.lr_schedule_kwargs is not None else None)

    micro_bs = args.batch_size // args.gradient_accumulation
    if micro_bs * args.gradient_accumulation != args.batch_size:
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple of --gradient_accumulation "
                         f"{args.gradient_accumulation}")
    dloader = make_loader(args, cfg, micro_bs)

    run_dir = [f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{args.run_name}"]
    if mesh is not None:
        dist.broadcast_object_list(run_dir, src=0)  # one run directory for every rank
    save_dir = Path(args.save_dir) / run_dir[0]
    logger = MetricLogger(save_dir, enabled=lead)
    if lead:
        with open(save_dir / "args.json", "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

    step, specs = 0, None  # specs: the state's layout under a mesh
    if mesh is not None:  # the state is made, split, then replaced by the checkpoint's pieces
        state, specs = parallel.shard_state(train.init_train_state(qparams, optimizer), mesh)
        del qparams
        if args.resume is not None:
            resume = Path(args.resume)
            ckpt = load_checkpoint(checkpoint_name(resume if resume.is_dir() else resume.parent))
            state = restore_sharded(ckpt["state"], specs, device)
            if args.quantize == "bitnet":
                state = parallel.bitnet_fsdp_params(state, mesh)  # a saved weight has no mesh
            step = ckpt["meta"]["step"]
            dloader.load_state_dict(ckpt["dloader"])
            del ckpt
    elif args.resume is None:
        state = train.init_train_state(qparams, optimizer)
        del qparams
    else:  # the checkpoint's state replaces the new one, which is not built
        del qparams
        ckpt = load_checkpoint(args.resume, device)
        state, step = ckpt["state"], ckpt["meta"]["step"]
        dloader.load_state_dict(ckpt["dloader"])
        del ckpt  # else the loaded state outlives its first step on the device
    if args.resume is not None and lead:
        print(f"Resumed from {args.resume} at step {step}")
    # a CUDA graph a step (train.py) unless the step is one that refuses it: a mesh or SR in the model
    graphed = train.capture_refusal(state.params, mesh) is None
    step_fn = train.make_train_step(cfg, optimizer, clip_grad_norm=args.clip_grad_norm, mesh=mesh, specs=specs,
                                    jit_compile=graphed)

    dloader_iter = iter(dloader)

    def next_batch():
        if args.gradient_accumulation > 1:
            toks, labs = zip(*[next(dloader_iter) for _ in range(args.gradient_accumulation)])
            tokens, labels = np.stack(toks), np.stack(labs)
        else:
            tokens, labels = next(dloader_iter)
        if mesh is not None:
            tokens, labels = parallel.shard_batch((tokens, labels), mesh)
            return tokens.to(device), labels.to(device)
        return torch.from_numpy(tokens).to(device), torch.from_numpy(labels).to(device)

    profiler = None
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    time0 = time.time()
    first_batch_s = None
    tokens_per_batch = args.batch_size * args.seq_len
    while step < args.n_steps:
        tokens, labels = next_batch()
        if first_batch_s is None:
            first_batch_s = time.time() - time0
            if lead:
                print(f"first batch after {first_batch_s:.2f} s")
        lr = lr_schedule.get_lr(step) if lr_schedule else args.lr
        state, metrics = step_fn(state, tokens, labels, lr, fold_in(key, 1_000_000 + step))
        step += 1

        if step % args.log_interval == 0 or step == args.n_steps:
            loss = metrics["loss"].item()  # waits for the step
            time1 = time.time()
            log = dict(loss=loss, grad_norm=metrics["grad_norm"].item(), lr=lr,
                       tokens_per_second=tokens_per_batch * min(args.log_interval, step) / (time1 - time0),
                       num_tokens_seen_millions=tokens_per_batch * step / 1e6,
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if device != "cpu" else 0.0)
            time0 = time1
            logger.log(log, step)
            if lead:
                print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in log.items()), flush=True)

        if args.ckpt_interval > 0 and step % args.ckpt_interval == 0:
            payload = {"state": state, "dloader": dloader.state_dict(), "meta": {"step": step, "args": vars(args)}}
            if mesh is None:
                save_checkpoint(save_dir / "last.pkl", payload)
            else:
                save_checkpoint(checkpoint_name(save_dir), payload, shard_arrays=specs)

        if args.hellaswag and step % args.hellaswag_interval == 0:
            merged = quant.merge_masters(quant.virtual_params(state.params), state.params)
            if mesh is not None and mesh.shape["fsdp"] > 1:  # every rank scores on the gathered weights
                with torch.no_grad():
                    merged = gather(merged, param_specs(specs), mesh)
            acc = hellaswag.evaluate_hellaswag(merged, cfg, args.hellaswag_tokenizer)
            logger.log(dict(hellaswag_acc=acc), step)
            if lead:
                print(f"step {step}: hellaswag_acc={acc:.4f}", flush=True)

    if profiler is not None:
        profiler.stop()
        (save_dir / "trace").mkdir(exist_ok=True)
        profiler.export_chrome_trace(str(save_dir / "trace" / "trace.json"))
        print(f"profile trace written to {save_dir / 'trace'}")
    dloader_iter.close()  # stops the prefetch thread
    if hasattr(dloader, "close"):
        dloader.close()
    logger.finish()
    if lead:
        print(f"done; artifacts in {save_dir}")
    return {"save_dir": save_dir, "state": state, "first_batch_s": first_batch_s}


if __name__ == "__main__":
    main()
