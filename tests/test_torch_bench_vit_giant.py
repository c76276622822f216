"""The port's ``_bench_vit_giant`` against the JAX repository's: the
``min_k`` filter quantizes exactly the leaves JAX's picks, and the step it
times (``vit_train.make_train_step``) against JAX's step (transcribed from
``_bench_vit_giant.py:45-56``) from JAX's weights carried over, at a 2-block
ViT; the batch ladder steps down only on an out-of-memory error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import vit as jvit
from quantized_training_tpu.quant.api import _default_filter as jdefault_filter
from quantized_training_tpu_torch import _bench_vit_giant as bench_vit
from quantized_training_tpu_torch import optim, quant, vit_train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import vit
from quantized_training_tpu_torch.quant.api import _default_filter

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

KW = dict(image_size=32, patch_size=8, hidden_size=128, num_layers=2, num_heads=4, num_classes=10, remat=True)


def _quantized_paths(tree, is_quantized, path=()):
    if isinstance(tree, dict):
        return sum((_quantized_paths(v, is_quantized, path + (k,)) for k, v in tree.items()), [])
    return [path] if is_quantized(tree) else []


@pytest.mark.parametrize("min_k", [0, 128, 512, 1536])
def test_min_k_picks_the_leaves_jax_picks(min_k):
    """JAX's filter (the default filter and ``shape[-1] >= min_k``, :26-30)
    and the port's quantize the same leaves: at hidden 128 / mlp 512 the four
    block linears and the patch embedding (192 inputs) up to 128, fc2 alone
    at 512, none at 1536."""
    jp = jvit.init_params(jax.random.PRNGKey(0), jvit.ViTConfig(**KW))

    def jfilter(path, leaf):
        return jdefault_filter(path, leaf) and leaf.shape[-1] >= min_k

    jq = jquant.quantize_params(jp, "mixed_precision", filter_fn=jfilter if min_k else None)
    tq = quant.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp)), "mixed_precision",
                               filter_fn=vit_train.min_k_filter(min_k))
    want = _quantized_paths(jq, lambda x: isinstance(x, jquant.MixedPrecisionWeight))
    assert _quantized_paths(tq, lambda x: isinstance(x, quant.MixedPrecisionWeight)) == want
    assert len(want) == {0: 5, 128: 5, 512: 1, 1536: 0}[min_k]


def test_min_k_1536_at_vit_giant_is_every_linear():
    """At ViT-Giant (in_features 1536 or 6144) min_k 1536 keeps every linear
    weight the default filter takes; the config is JAX's (1000 classes,
    remat)."""
    cfg = bench_vit.model_config()
    shapes = {"qkv": (3 * cfg.hidden_size, cfg.hidden_size), "proj": (cfg.hidden_size, cfg.hidden_size),
              "fc1": (cfg.mlp_dim, cfg.hidden_size), "fc2": (cfg.hidden_size, cfg.mlp_dim)}
    keep = vit_train.min_k_filter(1536)
    for name, shape in shapes.items():
        leaf = torch.empty(cfg.num_layers, *shape, device="meta")
        assert keep(("layers", name, "w"), leaf) and _default_filter(("layers", name, "w"), leaf)
    assert {f: getattr(cfg, f) for f in vars(jvit.VIT_GIANT) if f != "remat"} == \
        {f: v for f, v in vars(jvit.VIT_GIANT).items() if f != "remat"} and cfg.remat


@pytest.mark.parametrize("scheme", [None, "mixed_precision"])
def test_step_loss_vs_jax(scheme):
    """Two steps of the step ``measure`` times, from JAX's weights carried
    over, against JAX's step on the same images and labels: the losses
    within 1e-3 of JAX's (tests/test_torch_vit.py's bound for a driver
    step)."""
    cfg, jcfg = vit.ViTConfig(**KW), jvit.ViTConfig(**KW)
    jp = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    jq = jquant.quantize_params(jp, scheme)
    images = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = np.random.default_rng(2).integers(0, 10, 4)
    jimages, jlabels = jnp.asarray(images).astype(jnp.bfloat16), jnp.asarray(labels, jnp.int32)
    joptimizer = joptim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    jopt_state = joptimizer.init(jquant.virtual_params(jq))

    def jstep(qparams, opt_state, skey):  # JAX :45-56
        v = jquant.virtual_params(qparams)

        def loss(v):
            merged = jquant.merge_masters(v, qparams)
            return jvit.loss_fn(merged, jimages, jlabels, jcfg, key=skey)

        lv, g = jax.value_and_grad(loss)(v)
        v2, opt_state2 = joptimizer.step(g, opt_state, v, 1e-4, jax.random.fold_in(skey, 1))
        return jquant.commit_params(v2, qparams, jax.random.fold_in(skey, 2)), opt_state2, lv

    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    tq = quant.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp)), scheme)
    opt_state = optimizer.init(quant.virtual_params(tq))
    step = vit_train.make_train_step(cfg, optimizer)
    timages = torch.from_numpy(images).to(torch.bfloat16)
    for i in range(2):
        jq, jopt_state, jl = jstep(jq, jopt_state, jax.random.PRNGKey(bench_vit.KEY + i))
        tq, opt_state, tl = step(tq, opt_state, timages, torch.from_numpy(labels), bench_vit.LR, bench_vit.KEY + i)
        assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl)), (i, float(tl), float(jl))


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bench_vit, "model_config", lambda: vit.ViTConfig(**KW))
    monkeypatch.setattr(bench_vit, "N_STEPS", 1)


def test_entry_point_prints_jax_lines(small, monkeypatch, capsys):
    monkeypatch.setattr(bench_vit, "BATCHES", (4, 2))
    got = bench_vit.main(["--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == [f"vit_giant bs4 {name}" for name, _, _ in bench_vit.CONFIGS]
    assert list(got) == [name for name, _, _ in bench_vit.CONFIGS] and all(bs == 4 for bs, _ in got.values())


def test_batch_ladder_steps_down_only_on_out_of_memory(small, monkeypatch, capsys):
    calls = []

    def measure(scheme, min_k, bs, device):
        calls.append(bs)
        if bs == 24:
            raise torch.OutOfMemoryError("oom")
        return 10.0

    monkeypatch.setattr(bench_vit, "measure", measure)
    got = bench_vit.main(["--cpu"])
    assert calls == [24, 12, 12, 12] and all(bs == 12 for bs, _ in got.values())
    assert capsys.readouterr().out.splitlines()[0].startswith("vit_giant bs24 bf16: FAIL OutOfMemoryError")

    def broken(*a, **k):
        raise ValueError("a kernel failed")

    monkeypatch.setattr(bench_vit, "measure", broken)
    with pytest.raises(ValueError, match="a kernel failed"):
        bench_vit.main(["--cpu"])
