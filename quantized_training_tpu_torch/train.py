"""The training step.

Counterpart of ``quantized_training_tpu/train.py`` (:35-148):
``TrainState``, ``init_train_state``, ``make_train_step`` and
``make_eval_step``. One step runs

  virtual_params -> loss and grads (merge_masters -> loss_fn)
  -> [grad accumulation over micro-batches] -> clip -> optimizer.step
  -> commit_params

eagerly: there is no jit and no mesh, and ``make_train_step`` returns a
plain function. Grads come from ``torch.autograd.grad`` on detached copies
of the parameter leaves, so the state's tensors stay plain values, as the
JAX package's arrays are. The step's key (an int, ``ops/random.py``) is
folded as the JAX step folds it: ``fold_in(key, i)`` for micro-step i
(``fold_in(key, 0)`` without accumulation), ``fold_in(key, 1)`` for the
optimizer and ``fold_in(key, 2)`` for ``commit_params``. The JAX step
donates its state; this one leaves the old state intact (the optimizer
writes new buffers), so a caller may reuse it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .models import llama
from .ops.random import fold_in
from .optim.adamw import Optimizer
from .quant import commit_params, merge_masters, virtual_params
from .utils.train import clip_by_global_norm, global_norm
from .utils.tree import tree_flatten, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any  # storage tree (may hold quantized wrappers)
    opt_state: Any
    step: int


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params, optimizer.init(virtual_params(params)), 0)


def value_and_grad(loss_of, qparams, vparams=None):
    """``jax.value_and_grad`` over the parameter tree: ``loss_of`` applied to
    the masters (``vparams``, ``virtual_params(qparams)`` when not given)
    merged back with their storage; returns (loss, grads with the masters'
    structure, each in its leaf's dtype)."""
    vleaves, treedef = tree_flatten(virtual_params(qparams) if vparams is None else vparams)
    leaves = [l.detach().requires_grad_(True) for l in vleaves]
    loss = loss_of(merge_masters(tree_unflatten(treedef, leaves), qparams))
    return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))


def loss_and_grads(cfg: llama.LlamaConfig, qparams, tokens, labels, key: int | None = None, vparams=None):
    """:func:`value_and_grad` of the Llama loss; ``key`` seeds stochastic
    rounding in the model."""
    return value_and_grad(lambda params: llama.loss_fn(params, tokens, labels, cfg, key), qparams, vparams)


def make_train_step(cfg: llama.LlamaConfig, optimizer: Optimizer,
                    clip_grad_norm: float | None = None):
    """Returns ``step(state, tokens, labels, lr, key) -> (state, metrics)``.

    tokens/labels: [B, S], or [accum, B, S] for gradient accumulation: the
    micro-steps' grads are summed in the grad dtype (the parameters' dtype,
    as PyTorch's ``.backward()`` accumulates into ``param.grad``) and
    averaged, and so is the loss. ``metrics``: ``loss`` and ``grad_norm``
    (pre-clip), fp32 scalars on the parameters' device."""

    def train_step(state: TrainState, tokens, labels, lr, key: int):
        qparams = state.params
        vparams = virtual_params(qparams)
        if tokens.ndim == 3:  # [accum, B, S] micro-batches
            grads = tree_map(torch.zeros_like, vparams)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i, (tok, lab) in enumerate(zip(tokens, labels)):
                l, g = loss_and_grads(cfg, qparams, tok, lab, fold_in(key, i), vparams)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / tokens.shape[0], grads)
            loss = loss / tokens.shape[0]
        else:
            loss, grads = loss_and_grads(cfg, qparams, tokens, labels, fold_in(key, 0), vparams)

        if clip_grad_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_grad_norm)
        else:
            grad_norm = global_norm(grads)

        new_v, new_opt = optimizer.step(grads, state.opt_state, vparams, lr, fold_in(key, 1))
        new_params = commit_params(new_v, qparams, fold_in(key, 2))
        metrics = {"loss": loss, "grad_norm": grad_norm}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: llama.LlamaConfig):
    """Returns ``eval_step(params, tokens, labels) -> loss``: the Llama loss
    under ``torch.no_grad()``, with no key (JAX :141-148), for validation
    perplexity."""

    def eval_step(params, tokens, labels):
        with torch.no_grad():
            return llama.loss_fn(params, tokens, labels, cfg)

    return eval_step
