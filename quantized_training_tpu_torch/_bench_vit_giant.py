"""ViT-Giant bf16 against int8 mixed-precision training throughput on the
port, with the data on the card.

Counterpart of the JAX repository's ``_bench_vit_giant.py`` (:19-100): ViT-
Giant (K = 1536 / 6144, the original repository's timm finetune-scale
target) with remat at 224 px, 1000 classes, weights from seed 0, one batch
of normal images (seed 1) and labels (seed 2); ``adamw_bf16_sr`` without SR
(bf16 state), lr 1e-4. The step is ``vit_train.make_train_step``'s, the JAX
script's own: ``virtual_params``, the loss of ``merge_masters`` and its
grads, the optimizer with ``fold_in(skey, 1)``, ``commit_params`` with
``fold_in(skey, 2)``. Three configurations: bf16, int8-MP, and int8-MP on
the linears whose in_features is at least 1536 (``min_k``: the default
filter and ``shape[-1] >= 1536``; at ViT-Giant every linear the default
filter takes). One warm step, then ``N_STEPS`` synced and as many chained,
every wall ending in ``torch.cuda.synchronize()``; images/s at the faster.

JAX's batch ladder (24, 12, 8, 4, for its 16 GB chip) steps down only on
``torch.OutOfMemoryError``, any other error propagating, and every later
configuration takes the batch that ran. ``--cpu`` runs the plain versions
with the host clock: it exists to drive the entry point in tests, and its
numbers are no device metric.

  python -m quantized_training_tpu_torch._bench_vit_giant [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from . import optim, quant, vit_train
from .bench import device_name, log, release_memory
from .llm_pretrain import device_of
from .models import vit
from .ops.random import fold_in
from .utils.timing import sync

N_STEPS = 6
BATCHES = (24, 12, 8, 4)
LR = 1e-4
KEY = 3
CONFIGS = [("bf16", None, 0), ("int8-MP", "mixed_precision", 0), ("int8-MP min_k=1536", "mixed_precision", 1536)]


def model_config() -> vit.ViTConfig:
    return dataclasses.replace(vit.VIT_GIANT, remat=True)


def batch(cfg: vit.ViTConfig, bs: int, device) -> tuple:
    """Normal bf16 images [bs, H, W, 3] from seed 1, labels from seed 2."""
    images = torch.randn(bs, cfg.image_size, cfg.image_size, 3, generator=torch.Generator(device=device).manual_seed(1),
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (bs,), generator=torch.Generator(device=device).manual_seed(2),
                           device=device)
    return images, labels


def measure(scheme: str | None, min_k: int, bs: int = 24, n: int | None = None, device: str = "cuda",
            lr: float = LR) -> float:
    """Images/s of the step (JAX :19-79)."""
    n = N_STEPS if n is None else n
    cfg = model_config()
    params = vit.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    qparams = quant.quantize_params(params, scheme, filter_fn=vit_train.min_k_filter(min_k))  # JAX :26-30
    del params
    # bf16 optimizer states: fp32 AdamW m and v are ~9 GB at Giant's 1.13B
    # parameters; the original repository's answer at this scale
    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    opt_state = optimizer.init(quant.virtual_params(qparams))
    images, labels = batch(cfg, bs, device)
    step = vit_train.make_train_step(cfg, optimizer)

    t0 = time.perf_counter()
    qparams, opt_state, loss = step(qparams, opt_state, images, labels, lr, KEY)
    loss = loss.item()
    sync(device)
    log(f"  build+warm {time.perf_counter() - t0:.0f}s loss={loss:.3f}")
    t0 = time.perf_counter()
    for i in range(n):
        qparams, opt_state, loss = step(qparams, opt_state, images, labels, lr, fold_in(KEY, i))
        loss.item()
        sync(device)
    dt_s = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for i in range(n):
        qparams, opt_state, loss = step(qparams, opt_state, images, labels, lr, fold_in(KEY, 100 + i))
    loss.item()
    sync(device)
    dt_c = (time.perf_counter() - t0) / n
    log(f"  synced {dt_s * 1e3:.1f} ms, chained {dt_c * 1e3:.1f} ms")
    return bs / min(dt_s, dt_c)


def main(argv: list[str] | None = None) -> dict:
    """Prints one line a configuration; returns {name: (batch, images/s)}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="plain versions and the host clock (to drive the entry point)")
    args = p.parse_args(argv)
    device = device_of(args.cpu, "_bench_vit_giant")
    log(f"device: {device_name(device)}")
    out, chosen_bs = {}, None
    for name, scheme, min_k in CONFIGS:
        for bs in [chosen_bs] if chosen_bs else BATCHES:
            log(f"measuring vit_giant {name} bs{bs} ...")
            try:
                r = measure(scheme, min_k, bs=bs, device=device)
            except torch.OutOfMemoryError as e:
                print(f"vit_giant bs{bs} {name}: FAIL {type(e).__name__}: {str(e)[:140]}", flush=True)
                r = None
            if r is None:
                release_memory()
                continue
            print(f"vit_giant bs{bs} {name}: {r:.1f} img/s", flush=True)
            out[name] = (bs, r)
            chosen_bs = bs
            break
    return out


if __name__ == "__main__":
    main()
