"""Continuous batching for decode serving (slot-based KV cache).

Counterpart of ``quantized_training_tpu/models/serving.py``: ``ServeState``,
``make_prefill``, ``make_decode_step`` and the host-side :class:`Server`,
whose logic (prefill ``BUCKETS``, decode windows, ``_pick_chunk``,
``_finish``, FIFO admission) is carried over as it is.

Device side, the JAX package's jitted functions update the state IN PLACE:
a prefill writes the prompt's K/V straight into its slot's cache rows, and
a decode chunk of ``n_steps`` tokens is a loop over the single-step body
(one batched ``forward_with_cache`` with a position per slot). Inactive
slots compute masked garbage and do not advance. JAX compiles the decode
step once per window and chunk (:140, donating the state); here, on a CUDA
state with ``jit_compile`` (the default), its first call captures the whole
chunk as one CUDA graph (``utils/graphs.py``) and later calls replay it:
the cache, ``pos``, ``active`` and ``last_token`` are updated in place at
fixed addresses, and the parameters do not change while serving. The
prefill stays eager (its slot and length are host integers).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.graphs import Captured, same_buffers
from ..utils.tree import tree_leaves
from . import llama, llama_infer
from .llama_infer import KVCache


@dataclass
class ServeState:
    """Device-side serving state.

    cache: KVCache over the slot dim ([L, n_slots, max_len, KV, hd])
    pos: [n_slots] int64, next write position (= tokens held) per slot
    active: [n_slots] bool, slot currently serving a request
    last_token: [n_slots] int64, last sampled token (decode input)
    """

    cache: KVCache
    pos: torch.Tensor
    active: torch.Tensor
    last_token: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        c = self.cache
        return [c.k, c.k_scale, c.v, c.v_scale, self.pos, self.active, self.last_token]

    @classmethod
    def zeros(cls, cfg: llama.LlamaConfig, n_slots: int, max_len: int, device=None):
        return cls(
            KVCache.zeros(cfg, n_slots, max_len, device=device),
            torch.zeros(n_slots, dtype=torch.long, device=device),
            torch.zeros(n_slots, dtype=torch.bool, device=device),
            torch.zeros(n_slots, dtype=torch.long, device=device),
        )


def make_prefill(cfg: llama.LlamaConfig):
    """(params, state, slot, prompt [1, Tpad], n_valid) -> state.

    Runs the prefill forward on the padded prompt with the slot's cache rows
    as its cache (so the K/V land in the slot), takes the first generated
    token from the last valid position, and arms the slot for decode."""

    def prefill(params, state: ServeState, slot: int, prompt: torch.Tensor, n_valid: int):
        logits = llama_infer.forward_with_cache(params, prompt, state.cache.rows(slot), 0, cfg)
        state.last_token[slot] = logits[0, n_valid - 1].float().argmax()
        state.pos[slot] = n_valid
        state.active[slot] = True
        return state

    return prefill


def make_decode_step(cfg: llama.LlamaConfig, window: int | None = None, n_steps: int = 1, *,
                     jit_compile: bool = True):
    """(params, state) -> (state, tokens).

    One decode token for EVERY slot per step, ``n_steps`` steps per call,
    returned as [n_steps, n_slots] ([n_slots] when n_steps == 1). ``window``
    limits attention to the first ``window`` cache rows (None: all).
    ``jit_compile`` on a CUDA state: the call is a CUDA graph, captured at
    the first call (its warm-up's moves of ``pos`` and ``last_token`` taken
    back; the cache rows it wrote are written again with the same values)
    and again where the call is given other buffers; the tokens returned
    are a copy. The step's ``captured`` holds the graph (``.replays``)."""

    def one(params, state: ServeState) -> torch.Tensor:
        logits = llama_infer.forward_with_cache(
            params, state.last_token[:, None], state.cache, state.pos, cfg, window=window
        )
        tok = logits[:, 0].float().argmax(dim=-1)
        tok = torch.where(state.active, tok, state.last_token)
        state.pos += state.active
        state.last_token.copy_(tok)
        return tok

    def chunk(params, state: ServeState) -> torch.Tensor:
        toks = [one(params, state) for _ in range(n_steps)]
        return toks[0] if n_steps == 1 else torch.stack(toks)

    def step(params, state: ServeState):
        if not (jit_compile and state.pos.is_cuda):
            return state, chunk(params, state)
        buffers = tree_leaves(params) + state.tensors()  # held, so that none is freed under the graph
        if step.captured is None or not same_buffers(buffers, step.buffers):
            pos, last = state.pos.clone(), state.last_token.clone()

            def restore():
                state.pos.copy_(pos)
                state.last_token.copy_(last)

            step.buffers, step.captured = buffers, Captured(lambda: chunk(params, state), restore=restore)
        return state, step.captured.replay().clone()

    step.captured = step.buffers = None
    return step


class Server:
    """Host-side continuous-batching wrapper.

    Usage:
        srv = Server(params, cfg, n_slots=8, max_len=512)
        rid = srv.add_request([tok, tok, ...], max_new_tokens=64)
        while srv.pending():
            for rid, token in srv.step():   # one decode for all active
                ...
        srv.result(rid)  # full generated token list
    """

    # prefill pad buckets; _start caps the chosen bucket at max_len, so
    # prompts up to max_len - 1 are admissible for any max_len <= 8192
    BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(self, params, cfg: llama.LlamaConfig, n_slots: int, max_len: int,
                 eos_token: int | None = None,
                 window_buckets: tuple[int, ...] | None = None,
                 decode_chunk: int = 16, jit_compile: bool = True):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_token
        self.device = params["embed"]["embedding"].device
        # max tokens decoded per step() call; the actual chunk is the largest
        # power of two <= min(decode_chunk, every active slot's remaining
        # budget, remaining cache rows), so chunking never changes results
        self.decode_chunk = max(1, decode_chunk)
        self.jit_compile = jit_compile  # each decode step a CUDA graph on a card (make_decode_step)
        self.state = ServeState.zeros(cfg, n_slots, max_len, device=self.device)
        self._prefill = make_prefill(cfg)
        # decode attention windows: powers of two from 128 up to max_len
        # (slot positions are tracked host-side, so picking the window needs
        # no device sync)
        if window_buckets is None:
            window_buckets, w = [], 128
            while w < max_len:
                window_buckets.append(w)
                w *= 2
            window_buckets.append(max_len)
        self._windows = tuple(sorted(set(min(w, max_len) for w in window_buckets)))
        if self._windows[-1] != max_len:
            raise ValueError(f"window_buckets must reach max_len {max_len}")
        self._decode_fns: dict[tuple[int, int], object] = {}
        self._pos_host: dict[int, int] = {}  # slot -> next write position
        self._free = list(range(n_slots))
        self._slot_req: dict[int, int] = {}
        self._results: dict[int, list[int]] = {}
        self._budget: dict[int, int] = {}
        self._queue: list[tuple[int, list, int]] = []  # (rid, prompt, budget)
        self._pending_emit: list[tuple[int, int]] = []  # prefill tokens
        self._next_rid = 0

    def pending(self) -> bool:
        return bool(self._slot_req or self._queue or self._pending_emit)

    def add_request(self, prompt_tokens, max_new_tokens: int) -> int:
        """Admit a request, or queue it when every slot is busy (queued
        requests are admitted FIFO as slots free up inside step())."""
        n = len(prompt_tokens)
        # max_len - 1: decode writes the slot's next K/V row at pos == n,
        # so a prompt filling the whole cache could never generate
        limit = min(self.BUCKETS[-1], self.max_len - 1)
        if not 0 < n <= limit:
            raise ValueError(
                f"prompt length {n} exceeds limit {limit} "
                f"(min(largest prefill bucket {self.BUCKETS[-1]}, "
                f"max_len {self.max_len} - 1))"
            )
        rid = self._next_rid
        self._next_rid += 1
        # keep FIFO: even if a slot is free (e.g. freed by _finish since
        # the last step), earlier queued requests get it first
        if self._queue or not self._free:
            self._results[rid] = []
            self._queue.append((rid, list(prompt_tokens), max_new_tokens))
            self._admit()
            return rid
        self._start(self._free.pop(), rid, prompt_tokens, max_new_tokens)
        return rid

    def _start(self, slot: int, rid: int, prompt_tokens, max_new_tokens: int):
        n = len(prompt_tokens)
        # cap at max_len: with a non-power-of-two max_len the next bucket
        # can exceed the cache
        bucket = min(next(b for b in self.BUCKETS if b >= n), self.max_len)
        prompt = torch.zeros((1, bucket), dtype=torch.long)
        prompt[0, :n] = torch.as_tensor(list(prompt_tokens), dtype=torch.long)
        self.state = self._prefill(self.params, self.state, slot, prompt.to(self.device), n)
        first = int(self.state.last_token[slot])
        self._slot_req[slot] = rid
        self._pos_host[slot] = n
        self._results[rid] = [first]
        self._pending_emit.append((rid, first))  # stream it from step()
        self._budget[rid] = max_new_tokens - 1
        if max_new_tokens <= 1 or first == self.eos:
            self._finish(slot)

    def _admit(self):
        while self._queue and self._free:
            rid, prompt, budget = self._queue.pop(0)
            self._start(self._free.pop(), rid, prompt, budget)

    def _decode_for(self, needed: int, k: int = 1):
        """Smallest decode step whose window covers ``needed``, decoding
        ``k`` tokens per call (made lazily per (w, k))."""
        w = next(b for b in self._windows if b >= needed)
        fn = self._decode_fns.get((w, k))
        if fn is None:
            fn = self._decode_fns[(w, k)] = make_decode_step(
                self.cfg, None if w == self.max_len else w, n_steps=k, jit_compile=self.jit_compile
            )
        return fn

    def _pick_chunk(self) -> int:
        """Largest power-of-two chunk that (a) no active slot's budget can
        end before, (b) fits the cache for the deepest slot, and (c) is
        <= decode_chunk — so chunked output is identical to single-stepping,
        modulo discarded post-EOS speculation."""
        cap = min(
            self.decode_chunk,
            min(self._budget[rid] for rid in self._slot_req.values()),
            max(1, (self.max_len - 1)
                - max(self._pos_host[s] for s in self._slot_req)),
        )
        k = 1
        while k * 2 <= cap:
            k *= 2
        return k

    def step(self):
        """One decode call for all active slots; returns [(rid, token)],
        including each request's FIRST token (produced by its prefill), so a
        streaming consumer sees all max_new_tokens events. A call decodes up
        to ``decode_chunk`` tokens per slot."""
        self._admit()  # fill any slots freed since the last step
        emitted = self._pending_emit
        self._pending_emit = []
        if not self._slot_req:
            return emitted
        k = self._pick_chunk()
        # this call writes rows [pos, pos + k) and attends <= pos + k - 1
        needed = max(self._pos_host[s] for s in self._slot_req) + k
        self.state, toks = self._decode_for(needed, k)(self.params, self.state)
        toks = toks.cpu().numpy()
        if toks.ndim == 1:
            toks = toks[None]
        done: set[int] = set()
        for j in range(k):
            for slot, rid in list(self._slot_req.items()):
                if slot in done:
                    continue
                self._pos_host[slot] += 1
                t = int(toks[j, slot])
                self._results[rid].append(t)
                self._budget[rid] -= 1
                emitted.append((rid, t))
                if (
                    self._budget[rid] <= 0
                    or t == self.eos
                    or self._pos_host[slot] >= self.max_len - 1
                ):
                    # mid-chunk EOS: later rows for this slot are
                    # speculative garbage — drop them. The device-side pos
                    # advanced k regardless, but _finish frees the slot and
                    # the next prefill restarts its position.
                    done.add(slot)
                    self._finish(slot)
        return emitted

    def result(self, rid: int) -> list[int]:
        return self._results[rid]

    def _finish(self, slot: int):
        rid = self._slot_req.pop(slot)
        self._pos_host.pop(slot, None)
        del self._budget[rid]
        self.state.active[slot] = False
        self._free.append(slot)
