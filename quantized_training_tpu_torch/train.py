"""The training step.

Counterpart of ``quantized_training_tpu/train.py`` (:35-148):
``TrainState``, ``init_train_state``, ``make_train_step`` and
``make_eval_step``. One step runs

  virtual_params -> loss and grads (merge_masters -> loss_fn)
  -> [grad accumulation over micro-batches] -> clip -> optimizer.step
  -> commit_params

Grads come from ``torch.autograd.grad`` on detached copies of the
parameter leaves, so the state's tensors stay plain values, as the JAX
package's arrays are. The step's key (an int, ``ops/random.py``) is folded
as the JAX step folds it: ``fold_in(key, i)`` for micro-step i
(``fold_in(key, 0)`` without accumulation), ``fold_in(key, 1)`` for the
optimizer and ``fold_in(key, 2)`` for ``commit_params``.

``jit_compile`` and ``donate`` (JAX :45-52, :135-138, with JAX's defaults)
on a CUDA state: the first call for a token shape and dtype captures the
step from the micro-steps through the clip (every micro-batch's forward,
backward under the remat policy, the accumulation, the loss mean, the
global norm and the clip) as one CUDA graph (``utils/graphs.py``), as JAX
traces once per shape; each call copies the tokens and labels into the
graph's buffers and replays it. The optimizer and ``commit_params`` run
eagerly after the replay: their keys (and the plain optimizers' lr) are
host values that change every step. The graph reads the parameters at
fixed addresses, which the graph owns; a call whose state holds other
tensors copies its leaves in (the first call, a state from elsewhere), and
leaves that state intact. With ``donate`` the state the step returns holds
the graph's buffers, and a call given that state donates it: the optimizer
writes the new parameters and moments into its buffers (B6 in place, the
plain optimizers with in-place copies) and what it cannot write there (a
storage scheme's new storage) is copied in, so the caller must not read a
state again once it has passed it back, as under JAX's donation, and runs
one chain of states through one step function. Without ``donate`` every
call copies the state's leaves in and returns new tensors. ``metrics`` are
copies: the graph's own outputs are refilled by the next replay. A CPU state, or
``jit_compile=False``, runs the step eagerly and leaves the old state
intact whatever ``donate`` says. A capture the step cannot make is refused
with a ValueError at its first call (:func:`capture_refusal`): a mesh,
whose collectives go through the host, and stochastic rounding in the
model, whose kernels take their key as a host integer that a graph would
repeat at every replay. Settings read while the step is traced
(``quant.set_impl``, ``QT_PREQUANT``, ``QT_FUSED_ROPE``) are those of the
capture, as JAX's are those of the trace.

``mesh`` (a ``parallel.Mesh``; JAX :46-67, :127-131): data parallelism and
FSDP over processes, one a device. Every rank runs the step on its rows of
the batch (``parallel.shard_batch``) and on its shards of the state
(``parallel.shard_state``, whose layout ``specs`` is). The model
gathers the fsdp-split leaves (``models/llama.py``), whose gradients come
back reduce-scattered over fsdp; they are then summed over data, the
replicated leaves' over data x fsdp, and BitNet's 2-bit route reduces its
own. Every gradient is divided by data x fsdp, and the loss is averaged
over it, so both are the global batch's mean, as JAX's are. The global norm
sums the split leaves' squares over fsdp and counts each replicated leaf
once. The optimizer then updates this rank's shards, and the state keeps
the layout it came in with. Each rank folds its batch index into the
micro-steps' keys, so that ranks draw their own rounding noise on their
rows; the optimizer's and the commit's keys are shared, so that replicated
state stays bit-identical across ranks. At one rank every collective is an
identity and the step gives the no-mesh step's bits.

XLA partitions JAX's sharded step as one global program, so a quantize
that takes maxima over tokens (the column scales of the gradients' B5 / B4
operands, B7's, B9-row's, B11's and B14's column maxima) sees the global
batch there. The step here runs the forward and the backward (and so every
remat replay) inside ``collectives.spanning(mesh, tokens="dp")``: each such
maximum is all-reduced over data x fsdp before a value is cast with it, so
a rank's int8 operands are its rows of the global batch's. The optimizer
runs inside ``spanning(mesh, blocks="fsdp")``: an 8-bit state whose blocks
cross ranks all-reduces their maxima (``optim/state8bit.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .models import llama
from .ops.random import fold_in
from .optim.adamw import Optimizer
from .parallel import collectives as C
from .parallel.fsdp import is_fsdp_bitnet, zip_params
from .parallel.mesh import param_specs
from .quant import Int8QTConfig, MixedPrecisionConfig, commit_params, is_quant_weight, merge_masters, virtual_params
from .utils.graphs import Captured, same_buffers
from .utils.train import clip_by_global_norm, global_norm
from .utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


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


def loss_and_grads(cfg: llama.LlamaConfig, qparams, tokens, labels, key: int | None = None, vparams=None,
                   mesh=None, specs=None):
    """:func:`value_and_grad` of the Llama loss; ``key`` seeds stochastic
    rounding in the model."""
    return value_and_grad(lambda params: llama.loss_fn(params, tokens, labels, cfg, key, mesh, specs), qparams,
                          vparams)


def _leaf_layout(vparams, specs) -> list:
    """(split over fsdp, reduced inside its linear) of every leaf of the
    masters' tree, in its flatten order."""
    tagged = zip_params(lambda t, s, node: (s.dim is not None, is_fsdp_bitnet(node)), vparams, param_specs(specs))
    return tree_leaves(tagged, is_leaf=lambda x: isinstance(x, tuple))


def reduce_grads(grads, layout: list, mesh):
    """Each rank's gradients -> the global batch's: split leaves summed
    over data (the fsdp sum came with their reduce-scatter), replicated
    ones over data x fsdp, BitNet's 2-bit route as it is; then every leaf
    divided by data x fsdp."""
    leaves, treedef = tree_flatten(grads)
    out = []
    for g, (split, reduced) in zip(leaves, layout):
        if not reduced:
            g = C.all_reduce(g, mesh, "data" if split else "dp")
        out.append(g / mesh.dp_size)
    return tree_unflatten(treedef, out)


def sharded_global_norm(grads, layout: list, mesh) -> torch.Tensor:
    """The global norm of a sharded tree: the replicated leaves' squares
    once, plus the split leaves' summed over fsdp, in fp32 leaf by leaf
    (``global_norm``'s sum where nothing is split)."""
    squares = [(torch.sum(torch.square(l.float())), split) for l, (split, _) in zip(tree_leaves(grads), layout)]
    total = sum(q for q, split in squares if not split)
    split = [q for q, s in squares if s]
    if split:
        total = total + C.all_reduce(sum(split), mesh, "fsdp")
    return torch.sqrt(total)


def rounds_stochastically(qparams) -> bool:
    """Whether a weight of the tree rounds an operand of its linear
    stochastically: a mixed-precision config with ``stochastic_rounding``,
    or int8 storage with ``activation='int8_sr'``."""
    def sr(node) -> bool:
        config = getattr(node, "config", None)
        if isinstance(config, MixedPrecisionConfig):
            return config.stochastic_rounding
        return isinstance(config, Int8QTConfig) and config.activation == "int8_sr"

    return any(sr(w) for w in tree_leaves(qparams, is_leaf=is_quant_weight) if is_quant_weight(w))


def capture_refusal(qparams, mesh=None) -> str | None:
    """Why the step over ``qparams`` (and ``mesh``) cannot be captured as a
    CUDA graph, or None where it can."""
    if mesh is not None:
        return "a mesh step: its collectives are staged through the host (parallel/collectives.py)"
    if rounds_stochastically(qparams):
        return ("stochastic rounding in the model: its kernels take their Philox key as a host integer, which a "
                "graph would repeat at every replay")
    return None


class _GraphedGrads:
    """The captured part of one step shape: the parameter leaves, the
    tokens and the labels in buffers of its own, and the graph of
    ``grads_of`` over them."""

    def __init__(self, grads_of, state: TrainState, tokens, labels, key: int):
        leaves, treedef = tree_flatten(state.params)
        self.leaves = [l.clone() for l in leaves]
        self.tokens, self.labels = tokens.clone(), labels.clone()
        self.qparams = qparams = tree_unflatten(treedef, self.leaves)
        tokens, labels = self.tokens, self.labels  # the closure holds no self: no cycle keeps the pool alive
        self.graph = Captured(lambda: grads_of(qparams, tokens, labels, key))

    def __call__(self, state: TrainState, tokens, labels):
        """Replays the graph on ``state``'s parameters and the batch:
        (whether the state held the graph's buffers, the storage tree the
        graph read, (vparams, loss, grads, grad_norm))."""
        leaves = tree_leaves(state.params)
        owned = same_buffers(leaves, self.leaves)
        if not owned:
            for mine, theirs in zip(self.leaves, leaves):
                mine.copy_(theirs)
        self.tokens.copy_(tokens)
        self.labels.copy_(labels)
        return owned, self.qparams, self.graph.replay()

    def keep(self, new_params):
        """``new_params`` in the graph's buffers: each leaf the optimizer did
        not write in place copied in."""
        leaves, treedef = tree_flatten(new_params)
        for mine, new in zip(self.leaves, leaves):
            if mine.data_ptr() != new.data_ptr():
                mine.copy_(new)
        return tree_unflatten(treedef, self.leaves)


def make_train_step(cfg: llama.LlamaConfig, optimizer: Optimizer,
                    clip_grad_norm: float | None = None, mesh=None, specs=None, *,
                    donate: bool = True, jit_compile: bool = True):
    """Returns ``step(state, tokens, labels, lr, key) -> (state, metrics)``.

    tokens/labels: [B, S], or [accum, B, S] for gradient accumulation: the
    micro-steps' grads are summed in the grad dtype (the parameters' dtype,
    as PyTorch's ``.backward()`` accumulates into ``param.grad``) and
    averaged, and so is the loss. ``metrics``: ``loss`` and ``grad_norm``
    (pre-clip), fp32 scalars on the parameters' device. ``mesh``: see the
    module's docstring; tokens and labels are then this rank's rows, and
    ``specs`` the layout that ``parallel.shard_state`` returned with the
    state. ``jit_compile`` and ``donate``: the module's docstring; the
    step's ``graphs`` maps each captured token shape to its graph
    (``.graph.replays`` counts its replays)."""
    if mesh is not None and specs is None:
        raise ValueError("a mesh step needs the layout that shard_state returned with the state")

    def micro_key(k: int) -> int:
        return fold_in(k, mesh.dp_index) if mesh is not None and mesh.dp_size > 1 else k

    def micro_steps(qparams, vparams, tokens, labels, key: int):
        """(loss, grads) of this rank's rows, averaged over micro-batches."""
        if tokens.ndim == 3:  # [accum, B, S] micro-batches
            grads = tree_map(torch.zeros_like, vparams)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i, (tok, lab) in enumerate(zip(tokens, labels)):
                l, g = loss_and_grads(cfg, qparams, tok, lab, micro_key(fold_in(key, i)), vparams, mesh, specs)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            return loss / tokens.shape[0], tree_map(lambda g: g / tokens.shape[0], grads)
        return loss_and_grads(cfg, qparams, tokens, labels, micro_key(fold_in(key, 0)), vparams, mesh, specs)

    def grads_of(qparams, tokens, labels, key: int):
        """(vparams, loss, grads, grad_norm): the micro-steps through the
        clip, the part of the step that a graph captures."""
        vparams = virtual_params(qparams)
        with C.spanning(mesh, tokens="dp"):
            loss, grads = micro_steps(qparams, vparams, tokens, labels, key)

        norm = None
        if mesh is not None:
            layout = _leaf_layout(vparams, specs)
            grads = reduce_grads(grads, layout, mesh)
            loss = C.all_reduce(loss, mesh, "dp") / mesh.dp_size
            norm = sharded_global_norm(grads, layout, mesh)
        if clip_grad_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_grad_norm, norm)
        else:
            grad_norm = global_norm(grads) if norm is None else norm
        return vparams, loss, grads, grad_norm

    def update(state: TrainState, qparams, vparams, grads, lr, key: int, in_place: bool):
        """The optimizer and the commit: (new params, new optimizer state)."""
        with C.spanning(mesh, blocks="fsdp"):  # an 8-bit state's blocks that cross ranks
            new_v, new_opt = optimizer.step(grads, state.opt_state, vparams, lr, fold_in(key, 1), donate=in_place)
        return commit_params(new_v, qparams, fold_in(key, 2)), new_opt

    graphs: dict[tuple, _GraphedGrads] = {}

    def graphed(state: TrainState, tokens, labels, lr, key: int):
        sig = (tuple(tokens.shape), tokens.dtype, tuple(labels.shape), labels.dtype)
        captured = graphs.get(sig)
        if captured is None:
            reason = capture_refusal(state.params, mesh)
            if reason is not None:
                raise ValueError(f"make_train_step: cannot capture this step as a CUDA graph ({reason}); "
                                 "build it with jit_compile=False")
            captured = graphs[sig] = _GraphedGrads(grads_of, state, tokens, labels, key)
        owned, qparams, (vparams, loss, grads, grad_norm) = captured(state, tokens, labels)
        new_params, new_opt = update(state, qparams, vparams, grads, lr, key, donate and owned)
        if donate:
            new_params = captured.keep(new_params)
        metrics = {"loss": loss.clone(), "grad_norm": grad_norm.clone()}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    def train_step(state: TrainState, tokens, labels, lr, key: int):
        if jit_compile and tokens.is_cuda:
            return graphed(state, tokens, labels, lr, key)
        vparams, loss, grads, grad_norm = grads_of(state.params, tokens, labels, key)
        new_params, new_opt = update(state, state.params, vparams, grads, lr, key, False)
        return TrainState(new_params, new_opt, state.step + 1), {"loss": loss, "grad_norm": grad_norm}

    train_step.graphs = graphs
    return train_step


def make_eval_step(cfg: llama.LlamaConfig):
    """Returns ``eval_step(params, tokens, labels) -> loss``: the Llama loss
    under ``torch.no_grad()``, with no key (JAX :141-148), for validation
    perplexity."""

    def eval_step(params, tokens, labels):
        with torch.no_grad():
            return llama.loss_fn(params, tokens, labels, cfg)

    return eval_step
