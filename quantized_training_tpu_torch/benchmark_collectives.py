"""Collective bandwidth micro-benchmark of the port (the original repository's
``benchmark_nccl.py`` analog).

Counterpart of the JAX repository's ``benchmark_collectives.py`` (:23-57),
with its flags: a command line over ``parallel/collectives.py::
benchmark_collectives``, the GiB/s of all-reduce, all-gather and
reduce-scatter over one mesh axis spanning every rank of the world.

On the card the world is ``torchrun``'s (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``; NCCL, one process a card),
or the process group its caller has already made. ``--cpu N`` spawns N gloo
ranks on the CPU instead: its numbers are host-memcpy bandwidth, a check of
the harness, not a measurement of any device (as JAX's docstring says of its
virtual CPU mesh). Below 2 ranks it exits with JAX's message. Rank 0 prints
the ``devices:`` line and the JSON of the three figures, rounded to 2
decimals.

  torchrun --nproc_per_node 4 -m quantized_training_tpu_torch.benchmark_collectives [--axis data] [--size_mb 64] [--n_iters 20]
  python -m quantized_training_tpu_torch.benchmark_collectives --cpu 4
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .llm_pretrain import device_of, init_distributed
from .parallel import benchmark_collectives, make_mesh

SPAWN_TIMEOUT_S = 300


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--axis", default="data")
    p.add_argument("--size_mb", type=float, default=64.0)
    p.add_argument("--n_iters", type=int, default=20)
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="spawn N gloo ranks on the CPU (harness validation only)")
    return p


def _too_few(n: int) -> SystemExit:
    return SystemExit(f"only {n} device(s); collective benchmarks need >= 2 "
                      "(use --cpu 8 to validate the harness on a virtual mesh)")


def run(args, device: str) -> tuple[str, dict]:
    """On every rank of the process group: (the ``devices:`` line, the three
    GiB/s rounded)."""
    n = dist.get_world_size()
    mesh = make_mesh({args.axis: n}, "cpu" if device == "cpu" else "cuda")
    kind = "cpu" if device == "cpu" else torch.cuda.get_device_name(torch.cuda.current_device())
    results = benchmark_collectives(mesh, axis=args.axis, size_mb=args.size_mb, n_iters=args.n_iters,
                                    device=device if device == "cpu" else torch.cuda.current_device())
    return f"devices: {n} x {kind}, axis={args.axis!r}", {k: round(v, 2) for k, v in results.items()}


def _cpu_rank(rank: int, world: int, port: int, argv: list, out) -> None:
    """One spawned gloo rank; rank 0 puts its line and results on ``out``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        got = run(_parser().parse_args(argv), "cpu")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out.put(got)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv: list, world: int) -> tuple[str, dict]:
    """Rank 0's (line, results) of ``world`` spawned gloo ranks; raises if a
    rank fails or none answers within ``SPAWN_TIMEOUT_S``."""
    ctx = mp.get_context("spawn")
    out, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=_cpu_rank, args=(r, world, port, argv, out)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for _ in range(SPAWN_TIMEOUT_S):
            try:
                got = out.get(timeout=1)  # drained before the join
                break
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in procs]}") from None
        else:
            raise TimeoutError(f"no result from {world} ranks in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return got


def main(argv: list[str] | None = None) -> dict:
    """Prints rank 0's lines; returns the three GiB/s (rounded) there, an
    empty dict on the other ranks."""
    args = _parser().parse_args(argv)
    if args.cpu:
        if args.cpu < 2:
            raise _too_few(args.cpu)
        line, results = _spawn(sys.argv[1:] if argv is None else list(argv), args.cpu)
        rank = 0
    else:
        device_of(False, "benchmark_collectives")
        world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
        if world < 2:
            raise _too_few(world)
        init_distributed(cpu=False)  # a group its caller made is kept
        line, results = run(args, "cuda")
        rank = dist.get_rank()
    if rank != 0:
        return {}
    print(line)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
