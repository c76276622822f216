"""The remat policy of a checkpointed layer: what its replay is given and
what it does not compute again.

No kernel here. The JAX package checkpoints each Llama layer with
``jax.checkpoint_policies.save_only_these_names(...)``
(``quantized_training_tpu/models/llama.py:530-554``) and each ViT block with
a plain ``jax.checkpoint``; XLA then drops from the replay every value that
no backward reads. The port's kernels launch through ctypes, which torch's
dispatch (and so its selective checkpoint) does not see, and a
non-reentrant ``torch.utils.checkpoint`` runs each ``autograd.Function``'s
forward whole in its replay. So the policy is written by hand, on top of
that checkpoint. Such a checkpoint backs through the graph its forward
built and runs the replay only to give that graph's nodes the tensors they
saved, in the order they saved them: a replayed op must save what its
forward saved, and its output matters only where a later op saves it.

- :func:`checkpointed` wraps the layer's function: its first call (the
  forward) records into a frame of its own, its later ones (the replay,
  which the checkpoint runs in the backward) replay from it;
- :func:`save` keeps a named value the forward made (a detached alias of
  the forward's own tensor, no copy) and :func:`load` gives it back, in
  the order saved, to the replay: a fused producer's column maxima, SDPA's
  out and log-sum-exp;
- :func:`given` marks a value the replay takes as the forward's (JAX's
  ``checkpoint_name`` under a policy that saves it): the post-attention
  residual under ``QT_SAVE_POSTATTN=1``, the post-rope q, k, v under
  ``save_qkv_residuals``. The replay runs the ops that make it without
  their outputs and takes the saved value;
- inside :func:`unread` an op whose output no backward reads (the layer's
  last linear, the ops behind a given value) runs in the replay without
  computing that output: it computes (or loads) what its node saves and
  returns uninitialized memory of the output's shape. An op
  that a composite calls for a value its node reads runs inside
  :func:`read`.

Outside a replay (no checkpoint, the checkpoint's forward, a forward under
``torch.no_grad()``) every function here changes nothing, so the forward,
and every value a backward reads, is the same with the policy and without
it: the replay reads the forward's own tensors and recomputes the rest
with the same keys. A replay that reaches a value the forward did not save
raises; there is no fallback to replaying the whole layer.

The frame is module state, not thread state: autograd runs a CUDA
backward on a thread of its own, and the replay runs there.
"""

from __future__ import annotations

import contextlib

import torch

_FRAME: list = [None]  # the frame of the layer being recorded or replayed
_UNREAD = [False]  # inside unread() (and not inside a read() within it)


class _Frame:
    """The named values of one checkpointed call: each name's tensors in the
    order the forward saved them, and how many of them the current replay
    has taken."""

    def __init__(self):
        self.saved: dict = {}
        self.taken: dict = {}
        self.replaying = False


class checkpointed:
    """``fn`` for ``torch.utils.checkpoint(..., use_reentrant=False)``: the
    first call records into a fresh frame, every later one (the replay of
    each backward through it) replays from it. Without grad the first call
    records nothing (no replay follows)."""

    def __init__(self, fn):
        self.fn, self.frame, self.calls = fn, _Frame(), 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls == 1 and not torch.is_grad_enabled():
            return self.fn(*args, **kwargs)
        self.frame.replaying = self.calls > 1
        self.frame.taken = {}
        outer, outer_unread = _FRAME[0], _UNREAD[0]
        _FRAME[0], _UNREAD[0] = self.frame, False
        try:
            return self.fn(*args, **kwargs)
        finally:
            _FRAME[0], _UNREAD[0] = outer, outer_unread


def recording() -> bool:
    """Whether the current call is a checkpoint's forward that records."""
    return _FRAME[0] is not None and not _FRAME[0].replaying


def replaying() -> bool:
    """Whether the current call is a checkpoint's replay."""
    return _FRAME[0] is not None and _FRAME[0].replaying


def save(name: str, *tensors):
    """In a recording forward keep ``tensors`` under ``name`` (detached
    aliases); elsewhere nothing. Returns ``tensors`` (one, or a tuple)."""
    if recording():
        _FRAME[0].saved.setdefault(name, []).append(tuple(t.detach() if isinstance(t, torch.Tensor) else t
                                                            for t in tensors))
    return tensors[0] if len(tensors) == 1 else tensors


def load(name: str):
    """In a replay, the next tensors the forward saved under ``name`` (one,
    or a tuple), in the order it saved them."""
    frame = _FRAME[0] if replaying() else None
    queue = frame.saved.get(name, []) if frame is not None else []
    i = frame.taken.get(name, 0) if frame is not None else 0
    if i >= len(queue):
        raise RuntimeError(f"the remat replay reached {name!r}, which its forward did not save")
    frame.taken[name] = i + 1
    out = queue[i]
    return out[0] if len(out) == 1 else out


@contextlib.contextmanager
def unread():
    """Within it, in a replay, the op called is one whose output no
    backward reads (:func:`skips`)."""
    outer = _UNREAD[0]
    _UNREAD[0] = replaying()
    try:
        yield
    finally:
        _UNREAD[0] = outer


@contextlib.contextmanager
def read():
    """Within it the ops' outputs are read: a composite's inner op whose
    output its own node saves."""
    outer = _UNREAD[0]
    _UNREAD[0] = False
    try:
        yield
    finally:
        _UNREAD[0] = outer


def skips() -> bool:
    """Whether the op called now builds its node without computing its
    output: in a replay, inside :func:`unread`."""
    return _UNREAD[0]


def unread_like(t: torch.Tensor, shape=None, dtype=None) -> torch.Tensor:
    """Uninitialized memory for an output no backward reads (of ``t``'s
    device, and its shape and dtype unless given)."""
    return t.new_empty(t.shape if shape is None else shape, dtype=dtype or t.dtype)


class _Given(torch.autograd.Function):
    """The forward's value of a sum of ``parts`` in the replay, on the
    parts' graph (so that the ops after it save what they saved in the
    forward), its gradient passed to every part as the sum's."""

    @staticmethod
    def forward(ctx, value, *parts):
        ctx.n = len(parts)
        return value

    @staticmethod
    def backward(ctx, g):
        return (None, *(g,) * ctx.n)


def given(name: str, *parts: torch.Tensor) -> torch.Tensor:
    """The sum of ``parts`` (one part: itself), a value the policy saves:
    the forward computes it and, recording, saves it under ``name``; the
    replay takes the saved value, its gradient reaching each part as the
    sum's. The replay computes the parts within :func:`unread`, so the ops
    that make only them skip their outputs."""
    if replaying():
        return _Given.apply(load(name), *parts)
    value = parts[0]
    for p in parts[1:]:
        value = value + p
    return save(name, value)
