"""JAX's ``jit_compile`` and ``donate`` in the port (``train.make_train_step``,
``utils/graphs.py``, ``models/serving.py``), on the CPU, at a small Llama:
2 layers, hidden 256, FFN 512, 4/2 heads, 128 tokens (batch 2 x 64).

On the CPU a step runs eagerly whatever ``jit_compile`` says, so these tests
hold the flags' meaning there (the same bits, the old state intact), the
port's step against JAX's default step (jitted, donated), the refusals
through the function that decides them, the SR kernels' backstop, and the
launch accounting of a replay on :class:`utils.graphs.Captured` with the
CUDA calls replaced. The capture itself runs only on a card:
``tests/test_torch_cuda.py`` (``-k graph``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import ops, optim, parallel, quant, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.ops import _build, fused_adamw, int8_quant, sdpa
from quantized_training_tpu_torch.optim import OptimState8bit
from quantized_training_tpu_torch.utils import graphs
from quantized_training_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 64
# tests/test_torch_train.py's bounds for fp32 int8 mixed precision against
# the JAX step: (loss, grad norm, worst parameter leaf's relative RMS)
BOUNDS = (1e-3, 5e-3, 1e-2)


def _batch(seed, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, KW["vocab_size"], shape), rng.integers(0, KW["vocab_size"], shape)


def _setup(scheme="mixed_precision", **quant_kw):
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla")
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32), scheme,
                                **quant_kw)
    jopt = joptim.adamw(weight_decay=1e-2)
    jstate = jtrain.init_train_state(jp, jopt)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    return jcfg, cfg, jopt, jstate, tstate


def _state_leaves(state):
    return [*tree_leaves(state.params), *tree_leaves(state.opt_state.exp_avg),
            *tree_leaves(state.opt_state.exp_avg_sq)]


def test_make_train_step_takes_jax_flags():
    """``donate`` and ``jit_compile`` are keyword-only with JAX's defaults
    (both True), as ``jtrain.make_train_step`` has them."""
    import inspect

    for fn in (train.make_train_step, jtrain.make_train_step):
        params = inspect.signature(fn).parameters
        assert params["donate"].default is True and params["jit_compile"].default is True
    tp = inspect.signature(train.make_train_step).parameters
    assert tp["donate"].kind is tp["jit_compile"].kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("donate", [True, False])
def test_jit_compile_gives_the_eager_bits_on_the_cpu(donate):
    """Two steps, accumulation over 2 micro-batches and a clip: the step
    with ``jit_compile`` True and False gives the same losses, grad norms
    and state bit for bit on the CPU, and no step captured a graph."""
    _, cfg, _, _, tstate = _setup()
    tok, lab = (torch.from_numpy(a) for a in _batch(0, (2, B, S)))
    runs = {}
    for jit in (True, False):
        step = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2), clip_grad_norm=0.5, donate=donate,
                                     jit_compile=jit)
        state, metrics = tstate, []
        for i in range(2):
            state, m = step(state, tok, lab, 3e-4, 1 + i)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs[jit] = (metrics, _state_leaves(state))
        assert step.graphs == {}
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


def test_eager_step_leaves_a_donated_state_intact():
    """``donate=True`` on the eager step (the CPU) leaves the state passed
    in as it was: parameters and both moments, bit for bit."""
    _, cfg, _, _, tstate = _setup()
    before = [t.clone() for t in _state_leaves(tstate)]
    step = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2), donate=True)
    tok, lab = (torch.from_numpy(a) for a in _batch(1))
    new, _ = step(tstate, tok, lab, 3e-4, 1)
    assert all(torch.equal(a, b) for a, b in zip(before, _state_leaves(tstate)))
    assert not all(torch.equal(a, b) for a, b in zip(before, _state_leaves(new)))


def test_port_step_vs_jax_default_step():
    """The port's default step (``jit_compile`` and ``donate`` True) against
    JAX's default step, jitted and donating, two steps of fp32 int8 mixed
    precision: within tests/test_torch_train.py's bounds. JAX donates its
    state, so each JAX call gets a fresh copy."""
    jcfg, cfg, jopt, jstate, tstate = _setup()
    jstep = jtrain.make_train_step(jcfg, jopt)
    tstep = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2))
    tok, lab = _batch(2)
    b_loss, b_gn, b_param = BOUNDS
    for i in range(2):
        fresh = jax.tree.map(jnp.copy, jstate)
        jstate, jm = jstep(fresh, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), 3e-4,
                           jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, torch.from_numpy(tok), torch.from_numpy(lab), 3e-4, 1)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        jg, tg = float(jm["grad_norm"]), float(tm["grad_norm"])
        assert np.isfinite(tl) and abs(tl - jl) <= b_loss * abs(jl), (i, tl, jl)
        assert abs(tg - jg) <= b_gn * jg, (i, tg, jg)
        for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
            a, b = a.double().numpy(), np.asarray(b, np.float64)
            assert np.linalg.norm(a - b) <= b_param * np.linalg.norm(b)


@pytest.mark.parametrize("scheme,kw,sr", [("mixed_precision", {}, False),
                                          ("mixed_precision", {"stochastic_rounding": True}, True),
                                          ("mixed_precision", {"dtype": "int4"}, False),
                                          ("int8_quantized_training", {"activation": "int8"}, False),
                                          ("int8_quantized_training", {"activation": "int8_sr"}, True),
                                          ("int4_weight_only", {}, False),
                                          ("bitnet", {}, False),
                                          (None, {}, False)])
def test_capture_refusal_decides_from_the_tree(scheme, kw, sr):
    """:func:`train.capture_refusal`: stochastic rounding in the model is
    read from the weights' configs, every scheme without it is capturable,
    and a mesh is refused whatever the tree."""
    raw = llama.init_params(torch.Generator().manual_seed(0), llama.LlamaConfig(**KW))
    qparams = quant.quantize_params(raw, scheme, **kw)
    assert train.rounds_stochastically(qparams) is sr
    reason = train.capture_refusal(qparams)
    assert (reason is not None and "stochastic rounding" in reason) if sr else reason is None
    mesh = parallel.make_mesh({"data": 1}, "cpu")
    assert "mesh" in train.capture_refusal(qparams, mesh)


@pytest.mark.parametrize("what", ["sr", "mesh"])
def test_graphed_step_raises_its_refusal(what):
    """On a batch the step would capture (tokens whose ``is_cuda`` says
    True: the step's dispatch reads nothing else), an SR weight or a mesh
    raises a ValueError that names the reason and
    ``jit_compile=False``, before anything is captured."""
    _, cfg, _, _, _ = _setup()
    raw = llama.init_params(torch.Generator().manual_seed(0), cfg)
    qparams = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=what == "sr")
    opt = optim.adamw(weight_decay=1e-2)
    mesh = parallel.make_mesh({"data": 1}, "cpu") if what == "mesh" else None
    state = train.init_train_state(qparams, opt)
    specs = None
    if mesh is not None:
        state, specs = parallel.shard_state(state, mesh)
    step = train.make_train_step(cfg, opt, mesh=mesh, specs=specs)

    class CudaTokens(torch.Tensor):
        is_cuda = True

    tok, lab = (torch.from_numpy(a) for a in _batch(3))
    with pytest.raises(ValueError, match="jit_compile=False") as err:
        step(state, tok.as_subclass(CudaTokens), lab, 3e-4, 1)
    assert ("stochastic rounding" if what == "sr" else "mesh") in str(err.value)
    assert step.graphs == {}


@pytest.mark.parametrize("kernel", ["quantize_int8_rowwise", "quantize_int8_both", "fused_adamw_update"])
def test_sr_kernel_refuses_a_capture(monkeypatch, kernel):
    """An SR kernel's wrapper raises when the current stream is capturing
    (``torch.cuda.is_current_stream_capturing`` patched to True), before
    it checks its input or launches; a round-to-nearest launch does not
    consult it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    x = torch.zeros((8, 256), device="meta")
    if kernel == "fused_adamw_update":
        p = torch.zeros(256, device="meta", dtype=torch.bfloat16)
        monkeypatch.setattr(fused_adamw, "_check", lambda *a: None)
        call = lambda: ops.fused_adamw_update(p, p, p, p, torch.zeros(7, device="meta"), 5, bf16_sr=True)  # noqa: E731
    else:
        call = lambda: getattr(ops, kernel)(x, sr=True, key=5)  # noqa: E731
    with pytest.raises(ValueError, match="jit_compile=False"):
        call()
    with pytest.raises(ValueError, match="needs a CPU or CUDA tensor"):  # past the backstop
        int8_quant.quantize_int8_rowwise(x, sr=False)


def test_refuse_capture_reads_the_stream(monkeypatch):
    """``_build.refuse_capture`` raises only while the stream captures,
    never without CUDA, and not inside ``_build.repeated_keys``."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    _build.refuse_capture("k")  # this build has no CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _build.refuse_capture("k")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(ValueError, match="k: a stochastic-rounding kernel"):
        _build.refuse_capture("k")
    with _build.repeated_keys():  # a timing loop's capture (utils/timing.py::time_ms)
        _build.refuse_capture("k")
    with pytest.raises(ValueError):
        _build.refuse_capture("k")


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` without a card: a replay runs nothing."""

    def replay(self):
        pass


def _no_card(monkeypatch):
    """The CUDA calls of ``graphs.Captured`` as no-ops on the CPU."""
    class Stream:
        def wait_stream(self, other):
            pass

    import contextlib

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())


def test_replay_adds_the_captured_launch_counts(monkeypatch):
    """``graphs.Captured``: the warm-up's and the capture's launches are
    taken back, each replay adds the counts the capture added (kernels and
    SDPA forwards), and ``restore`` runs after the one warm-up call."""
    _no_card(monkeypatch)
    ops.reset_launch_counts()
    int8_quant.quantize_int8_rowwise.launches = 5  # counted before: kept
    restored, calls = [], []

    def fn():
        calls.append(1)
        int8_quant.quantize_int8_rowwise.launches += 2
        int8_quant.quantize_int8_both.sr_launches += 1
        sdpa.sdpa.launches += 3
        return "out"

    captured = graphs.Captured(fn, restore=lambda: restored.append(len(calls)))
    assert len(calls) == 2 and restored == [1]
    assert captured.launches == {"quantize_int8_rowwise": 2, "quantize_int8_both_sr": 1, "sdpa": 3}
    assert ops.launch_totals() == {**dict.fromkeys(ops.launch_totals(), 0), "quantize_int8_rowwise": 5}
    assert captured.replay() == "out" and captured.replay() == "out"
    totals = ops.launch_totals()
    assert (totals["quantize_int8_rowwise"], totals["quantize_int8_both_sr"], totals["sdpa"]) == (9, 2, 6)
    assert captured.replays == 2
    ops.reset_launch_counts()


def test_capture_holds_off_the_garbage_collector(monkeypatch):
    """``graphs.capture`` collects before the capture and keeps the cyclic
    collector off while it captures (a dead cycle holding another graph
    must not be collected there), and turns it back on after, also when
    the capture raises."""
    import contextlib
    import gc

    seen = []

    @contextlib.contextmanager
    def graph(g):
        seen.append(gc.isenabled())
        yield

    collected = []
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or 0)
    assert gc.isenabled()
    with graphs.capture(object()):
        assert not gc.isenabled()
    with pytest.raises(RuntimeError), graphs.capture(object()):
        raise RuntimeError("a failed capture")
    assert seen == [False, False] and collected == [1, 1] and gc.isenabled()


def test_counts_helpers():
    """``graphs.counts_delta`` keeps what moved; ``set_counts`` and
    ``ops.add_launch_counts`` set and add every counter, SDPA's too."""
    ops.reset_launch_counts()
    start = ops.launch_totals()
    ops.add_launch_counts({"scaled_mm_rhs_t": 4, "sdpa": 1})
    assert graphs.counts_delta(ops.launch_totals(), start) == {"scaled_mm_rhs_t": 4, "sdpa": 1}
    graphs.set_counts(start)
    assert ops.launch_totals() == start
    assert graphs.same_buffers([torch.zeros(2)], [torch.zeros(2)]) is False
    t = torch.zeros(2)
    assert graphs.same_buffers([t], [t]) and graphs.same_buffers([t[:1]], [t])


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16_sr", "schedule_free_adamw_8bit"])
def test_donating_optimizer_gives_the_same_bits(name):
    """``optimizer.step(..., donate=True)`` writes the new parameters and
    state into the old buffers, with the out-of-place step's bits."""
    raw = llama.init_params(torch.Generator().manual_seed(0), llama.LlamaConfig(**KW), dtype=torch.bfloat16)
    opt = optim.get_optimizer(name, weight_decay=1e-2, **({"bf16_stochastic_rounding": True}
                                                          if name == "adamw_bf16_sr" else {}))
    g = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g).to(p.dtype), raw)
    params = tree_map(torch.clone, raw)
    state = opt.init(params)
    want_p, want_s = opt.step(grads, state, params, 1e-3, 7)
    state2 = opt.init(params)
    got_p, got_s = opt.step(grads, state2, params, 1e-3, 7, donate=True)
    assert all(a is b for a, b in zip(tree_leaves(got_p), tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)))
    is8 = lambda t: isinstance(t, OptimState8bit)  # noqa: E731
    flat = lambda s: [x for l in tree_leaves(s, is_leaf=is8)  # noqa: E731
                      for x in (tree_leaves(l) if is8(l) else [l]) if isinstance(x, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(flat(got_s), flat(want_s)))
