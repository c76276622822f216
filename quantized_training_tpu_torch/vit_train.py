"""ViT training driver of the port.

Counterpart of the JAX package's ``vit_train.py``, with its flags (but
``--cache_dir``, XLA's compilation cache): ``--quantize`` /
``--quantize_kwargs`` / ``--quantize_min_k``, a warmup + cosine LR
(``--cosine_lr_scheduler``), validation accuracy every ``--eval_interval``
steps, images/s logged every ``--log_interval`` steps to stdout and to
``runs/vit_train/<time>_<run_name>/metrics.jsonl``. ``--train_ds``
takes any image set of ``data.get_dataset``; ``hf_image`` and ``wds`` fail
at the first batch as they do in the JAX driver (the batcher asks them for
a ``state_dict()``, which they have not: ROADMAP C), so a caller of the
library batches them itself, with a ``transform``.

It runs on the CUDA card unless ``--cpu`` is given, and raises without a
card. Every model takes ``remat=True``, ``--num_classes`` and
``--image_size``. For all-int8 ``mixed_precision`` weights at widths that
are multiples of 128 (ViT-Base and up; ViT-Tiny's 192 is not) the blocks run
LayerNorm and GELU inside the int8 quantizes (B18).

  python -m quantized_training_tpu_torch.vit_train --model vit_giant \\
      --train_ds '{"type": "synthetic_image"}' --quantize mixed_precision \\
      --optim adamw_bf16_sr --optim_kwargs '{"bf16_stochastic_rounding": false}' \\
      --batch_size 24 --n_steps 20 --log_interval 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from datetime import datetime
from pathlib import Path

import torch

from . import optim, quant
from .data import BatchLoader, get_dataset
from .models import vit
from .ops.random import fold_in
from .quant.api import _default_filter
from .train import value_and_grad
from .utils import MetricLogger, print_model_stats

MODELS = {"vit_tiny": vit.VIT_TINY, "vit_small": vit.VIT_SMALL, "vit_base": vit.VIT_BASE,
          "vit_large": vit.VIT_LARGE, "vit_huge": vit.VIT_HUGE, "vit_giant": vit.VIT_GIANT}


class CosineSchedule:
    """Warmup, then cosine decay to 0 (the JAX driver's, :27-44)."""

    def __init__(self, lr: float, total_steps: int, warmup: float = 0.05) -> None:
        self.lr = lr
        self.final_lr = 0.0
        self.total_steps = total_steps
        self.warmup_steps = round(total_steps * warmup)

    def get_lr(self, step: int) -> float:
        if step < self.warmup_steps:
            return self.lr * step / self.warmup_steps
        if step < self.total_steps:
            progress = (step - self.warmup_steps) / (self.total_steps - self.warmup_steps)
            return self.final_lr + 0.5 * (self.lr - self.final_lr) * (1 + math.cos(progress * math.pi))
        return self.final_lr


def model_config(name: str, num_classes: int, image_size: int, **model_kwargs) -> vit.ViTConfig:
    """A preset with the driver's overrides: remat, ``num_classes``,
    ``image_size``, then ``model_kwargs``."""
    return dataclasses.replace(MODELS[name], **dict(num_classes=num_classes, image_size=image_size, remat=True,
                                                    **model_kwargs))


def make_train_step(cfg: vit.ViTConfig, optimizer: optim.Optimizer):
    """``step(qparams, opt_state, images, labels, lr, skey) -> (qparams,
    opt_state, loss)``, the JAX driver's step (:145-156): the loss and its
    grads with ``skey`` seeding the model, the optimizer with
    ``fold_in(skey, 1)``, ``commit_params`` with ``fold_in(skey, 2)``."""

    def train_step(qparams, opt_state, images, labels, lr, skey: int):
        v = quant.virtual_params(qparams)
        loss, grads = value_and_grad(lambda p: vit.loss_fn(p, images, labels, cfg, key=skey), qparams)
        v2, opt_state2 = optimizer.step(grads, opt_state, v, lr, fold_in(skey, 1))
        return quant.commit_params(v2, qparams, fold_in(skey, 2)), opt_state2, loss

    return train_step


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a ViT with the PyTorch port.")
    parser.add_argument("--model", default="vit_tiny", help="|".join(MODELS))
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())
    parser.add_argument("--num_classes", type=int, default=45)  # RESISC45
    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize_min_k", type=int, default=0,
                        help="quantize only the linears whose in_features is at least this")
    parser.add_argument("--train_ds", type=json.loads, required=True)
    parser.add_argument("--val_ds", type=json.loads)
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--eval_interval", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--optim_kwargs", type=json.loads, default=dict())
    parser.add_argument("--cosine_lr_scheduler", action="store_true")
    parser.add_argument("--run_name", default="run")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--log_interval", type=int, default=10)
    parser.add_argument("--cpu", action="store_true")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("vit_train: no CUDA card; pass --cpu to train on the CPU")
    device = "cpu" if args.cpu else "cuda"
    cfg = model_config(args.model, args.num_classes, args.image_size, **args.model_kwargs)
    key = args.seed  # an int key (ops/random.py)
    params = vit.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)
    filter_fn = None
    if args.quantize_min_k:
        def filter_fn(path, leaf):
            return _default_filter(path, leaf) and leaf.shape[-1] >= args.quantize_min_k
    qparams = quant.quantize_params(params, args.quantize, filter_fn=filter_fn, **args.quantize_kwargs)
    print_model_stats(params)

    optimizer = optim.get_optimizer(args.optim, weight_decay=args.weight_decay, **args.optim_kwargs)
    lr_schedule = CosineSchedule(args.lr, args.n_steps) if args.cosine_lr_scheduler else None
    if args.train_ds.get("type") == "synthetic_image":
        args.train_ds.setdefault("num_classes", cfg.num_classes)
        args.train_ds.setdefault("size", cfg.image_size)
    dloader = BatchLoader(get_dataset(eval=False, **args.train_ds), batch_size=args.batch_size)
    opt_state = optimizer.init(quant.virtual_params(qparams))
    train_step = make_train_step(cfg, optimizer)

    def evaluate():
        if args.val_ds is None:
            return None
        correct = total = 0
        with torch.no_grad():
            for images, labels in BatchLoader(get_dataset(eval=True, **args.val_ds), batch_size=args.batch_size):
                preds = vit.forward(qparams, torch.from_numpy(images).to(device), cfg).argmax(-1)
                correct += int((preds.cpu().numpy() == labels).sum())
                total += len(labels)
        return correct / max(total, 1)

    save_dir = Path("runs/vit_train") / f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{args.run_name}"
    logger = MetricLogger(save_dir)
    step = 0
    time0 = time.time()
    dloader_iter = iter(dloader)
    while step < args.n_steps:
        images, labels = next(dloader_iter)
        lr = lr_schedule.get_lr(step) if lr_schedule else args.lr
        qparams, opt_state, loss = train_step(qparams, opt_state, torch.from_numpy(images).to(device),
                                              torch.from_numpy(labels).to(device), lr, fold_in(key, 1_000_000 + step))
        step += 1
        if step % args.log_interval == 0 or step == args.n_steps:
            log = dict(loss=loss.item())  # waits for the step
            time1 = time.time()
            log.update(lr=lr, images_per_second=args.batch_size * min(args.log_interval, step) / (time1 - time0))
            time0 = time1
            logger.log(log, step)
            print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in log.items()), flush=True)
        if args.eval_interval and step % args.eval_interval == 0:
            acc = evaluate()
            if acc is not None:
                logger.log(dict(val_acc=acc), step)
                print(f"step {step}: val_acc={acc:.4f}")
    acc = evaluate()
    if acc is not None:
        print(f"final val_acc={acc:.4f}")
        logger.log(dict(val_acc=acc), step)
    logger.finish()
    print(f"done; artifacts in {save_dir}")


if __name__ == "__main__":
    main()
